"""The attention block of the LM stack, with a dense FFN (port of the `attn`
kind of ``repro/models/blocks.py``): GQA/MQA, an optional SWA band, QKV
bias, RoPE, and a gated or plain FFN (silu or gelu).

A block is a function (cfg, params, x, pos) -> (x, aux) over a plain dict
of tensors.  The other kinds of the reference (``mamba2``, ``mlstm``,
``slstm``), the MoE FFN and M-RoPE wait for ROADMAP item 15b, and decoding
over a KV cache for 15d: those configurations raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models.common import (activation, apply_rope, causal_attention, dense_init,
                                       init_rms, rms_norm)
from repro_torch.models.moe import MoECfg


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    kind: str                       # attn | mamba2 | mlstm | slstm
    d_model: int
    # -- attn --
    heads: int = 0
    kv_heads: int = 0
    head_dim: int = 0               # 0 -> d_model // heads
    qkv_bias: bool = False
    window: Optional[int] = None    # SWA band
    rope: str = "rope"              # rope | mrope | none
    rope_theta: float = 10000.0
    d_ff: int = 0
    act: str = "silu"
    gated: bool = True
    moe: Optional[MoECfg] = None
    # -- ssm family --
    d_state: int = 64               # N
    ssm_heads: int = 8              # H
    expand: int = 2                 # d_inner = expand * d_model
    conv_width: int = 4
    qkv_block: int = 4              # mLSTM block-diagonal q/k/v blocksize
    # --
    norm_eps: float = 1e-6

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.heads, 1))

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_headdim(self) -> int:
        return self.d_inner // self.ssm_heads


class PosCtx(NamedTuple):
    """Positional context threaded through attention blocks."""

    positions: torch.Tensor                        # [B, S]
    mrope_positions: Optional[torch.Tensor] = None  # [3, B, S]
    step: Optional[torch.Tensor] = None             # decode: current length


def _require_ported(cfg: BlockCfg) -> None:
    if cfg.kind != "attn":
        raise NotImplementedError(
            f"block kind {cfg.kind!r} is not ported yet (ROADMAP item 15b); the port has 'attn'")
    if cfg.moe is not None:
        raise NotImplementedError("the MoE FFN is not ported yet (ROADMAP item 15b)")
    if cfg.rope == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet (ROADMAP item 15b)")


def _attn_init(cfg: BlockCfg, generator: Optional[torch.Generator], device) -> dict:
    hd, hq, hkv = cfg.hd, cfg.heads, cfg.kv_heads
    dense = lambda *a, **kw: dense_init(generator, *a, device=device, **kw)  # noqa: E731
    p = {
        "ln1": init_rms(cfg.d_model, device),
        "wq": dense(cfg.d_model, hq * hd),
        "wk": dense(cfg.d_model, hkv * hd),
        "wv": dense(cfg.d_model, hkv * hd),
        "wo": dense(hq * hd, cfg.d_model, scale=1.0 / math.sqrt(hq * hd)),
        "ln2": init_rms(cfg.d_model, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            p[name] = torch.zeros((width,), dtype=torch.float32, device=device)
    p["ffn_wi"] = dense(cfg.d_model, cfg.d_ff * (2 if cfg.gated else 1))
    p["ffn_wo"] = dense(cfg.d_ff, cfg.d_model)
    return p


def _qkv(cfg: BlockCfg, p: dict, x: torch.Tensor, pos: PosCtx):
    b, s, _ = x.shape
    hd, hq, hkv = cfg.hd, cfg.heads, cfg.kv_heads
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = h @ p["wq"].to(h.dtype)
    k = h @ p["wk"].to(h.dtype)
    v = h @ p["wv"].to(h.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(h.dtype)
        k = k + p["bk"].to(h.dtype)
        v = v + p["bv"].to(h.dtype)
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.rope == "rope":
        q = apply_rope(q, pos.positions, cfg.rope_theta)
        k = apply_rope(k, pos.positions, cfg.rope_theta)
    return q, k, v


def _ffn(cfg: BlockCfg, p: dict, x: torch.Tensor):
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    act = activation(cfg.act)
    u = h @ p["ffn_wi"].to(h.dtype)
    if cfg.gated:
        ug, uu = torch.chunk(u, 2, dim=-1)
        u = act(ug) * uu
    else:
        u = act(u)
    return u @ p["ffn_wo"].to(h.dtype), {}


def _attn_train(cfg: BlockCfg, p: dict, x: torch.Tensor, pos: PosCtx,
                attention: Optional[str]):
    q, k, v = _qkv(cfg, p, x, pos)
    o = causal_attention(q, k, v, window=cfg.window, impl=attention)
    b, s = o.shape[:2]
    x = x + (o.reshape(b, s, -1) @ p["wo"].to(x.dtype))
    f, aux = _ffn(cfg, p, x)
    return x + f, aux


def block_init(cfg: BlockCfg, generator: Optional[torch.Generator] = None, device=None) -> dict:
    _require_ported(cfg)
    return _attn_init(cfg, generator, device)


def block_train(cfg: BlockCfg, params: dict, x: torch.Tensor, pos: PosCtx,
                attention: Optional[str] = None):
    """The block over a full sequence; `attention` names the implementation
    (``models.common.causal_attention``; None: the one of `x`'s device)."""
    _require_ported(cfg)
    return _attn_train(cfg, params, x, pos, attention)
