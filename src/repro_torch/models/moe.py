"""Mixture-of-Experts FFN with capacity-bounded sort dispatch (port of
``repro/models/moe.py``).

The top-k assignments are sorted by expert (stably), ranked within their
expert (iota - cummax, as the HKV merge ranks), and scattered into an
[E, C, d] buffer; assignments past an expert's capacity C are dropped.
The experts run as one batched product over the expert dimension, and the
combine adds each kept assignment's gated output back to its token.

Aux outputs: the load-balance loss (Switch-style), the router z-loss and
the dropped fraction.  The dispatch buffer, the experts' hidden activations
and their outputs are pinned to the mesh's "model" axis (expert
parallelism) by ``distributed.sharding.maybe_constrain`` in the
reference's three places; a torch program has no ambient mesh, so each pin
is the identity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.distributed import sharding
from repro_torch.models.common import activation, dense_init, normal, scalar


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_model: int
    d_ff: int                    # per-expert hidden
    act: str = "silu"
    gated: bool = True
    capacity_factor: float = 1.25


def moe_init(cfg: MoECfg, generator: Optional[torch.Generator] = None, device=None) -> dict:
    wi_out = cfg.d_ff * (2 if cfg.gated else 1)
    return {
        "router": dense_init(generator, cfg.d_model, cfg.num_experts, device=device),
        "wi": normal(generator, (cfg.num_experts, cfg.d_model, wi_out), device)
        * (1.0 / math.sqrt(cfg.d_model)),
        "wo": normal(generator, (cfg.num_experts, cfg.d_ff, cfg.d_model), device)
        * (1.0 / math.sqrt(cfg.d_ff)),
    }


def capacity(cfg: MoECfg, tokens: int) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # a multiple of 8, as the reference rounds it


def moe_apply(cfg: MoECfg, params: dict, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """x: [T, d] flattened tokens -> (y [T, d], aux losses)."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    c = capacity(cfg, t)
    act = activation(cfg.act)
    dev = x.device

    logits = (x @ params["router"].to(x.dtype)).to(torch.float32)  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: descending, a tie to the lower index (a stable sort)
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[:, :k], expert[:, :k]                     # [T, k]
    gate = gate / torch.maximum(gate.sum(-1, keepdim=True), scalar(1e-9, gate))

    # aux losses
    me = probs.mean(dim=0)                                        # mean prob per expert
    ones = torch.ones((t * k,), dtype=torch.float32, device=dev)
    ce = torch.zeros((e,), dtype=torch.float32, device=dev).index_add(
        0, expert.reshape(-1), ones) / (t * k)
    aux = {"load_balance": e * torch.sum(me * ce),
           "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}

    # dispatch: sort the T*k assignments by expert, rank within the expert
    flat_e = expert.reshape(-1)
    flat_g = gate.reshape(-1)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.sort(flat_e, stable=True).indices
    se, sg, stok = flat_e[order], flat_g[order], flat_t[order]
    iota = torch.arange(t * k, device=dev)
    is_new = torch.ones_like(se, dtype=torch.bool)
    is_new[1:] = se[1:] != se[:-1]
    rank = iota - torch.cummax(torch.where(is_new, iota, -1), dim=0).values
    keep = rank < c
    slot = torch.where(keep, se * c + rank, e * c)                # past capacity: dropped
    # the reference's scatter drops slot e*c ("drop" mode): a spare row takes
    # every dropped assignment and is cut off
    buf = torch.zeros((e * c + 1, d), dtype=x.dtype, device=dev).index_put((slot,), x[stok])
    buf = buf[:e * c].reshape(e, c, d)
    # EP: the dispatch buffer on the expert axis, so the expert products run
    # split (dispatch becomes the all-to-all) instead of gathering the weights
    buf = sharding.maybe_constrain(buf, "model", None, None)

    # the experts, batched over the expert dimension
    h = torch.einsum("ecd,edf->ecf", buf, params["wi"].to(x.dtype))
    h = sharding.maybe_constrain(h, "model", None, None)
    if cfg.gated:
        hg, hu = torch.chunk(h, 2, dim=-1)
        h = act(hg) * hu
    else:
        h = act(h)
    out_buf = torch.einsum("ecf,efd->ecd", h, params["wo"].to(x.dtype))
    out_buf = sharding.maybe_constrain(out_buf, "model", None, None).reshape(e * c, d)

    # combine: the kept assignments' gated outputs added to their tokens
    gathered = out_buf[slot.clamp(0, e * c - 1)]
    contrib = torch.where(keep[:, None], gathered * sg[:, None].to(x.dtype), 0)
    y = torch.zeros((t, d), dtype=x.dtype, device=dev).index_add(0, stok, contrib)
    aux["dropped_frac"] = 1.0 - keep.to(torch.float32).mean()
    return y, aux
