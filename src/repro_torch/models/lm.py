"""CompositeLM: a decoder as a segment/repeat block stack (port of the
training half of ``repro/models/lm.py``).

A model is `prelude + repeats x segments`; each StackSegment is `count`
identical blocks of one BlockCfg, and a `shared` segment's parameters are
stored once and reused every repeat.  The parameter tree is the
reference's, leaf for leaf (``convert.lm_params_from_jax`` carries it
across): a segment's leaves are stacked [count, ...] in the prelude and
[repeats, count, ...] in the repeated part.  The forward unbinds each
stacked leaf once (its backward is one stack), and runs the layers in a
Python loop; `remat` is ``torch.utils.checkpoint`` around every block and
every loss chunk.

The embedding is backend-switchable: 'dense' (the table in
``params["embed"]["table"]``, ``embedding/dense.py``) or 'hkv' (the rows
arrive as `embeds`, found or inserted outside the differentiated function,
and the head is untied).  The loss is computed in chunks of `loss_chunk`
positions, so the [B, S, vocab] logits are never all live.

The inputs take the reference's stub vision frontend (`frontend_embeds`
replace the first positions), M-RoPE positions (`mrope_positions`
[3, B, S]) and sinusoidal positions.  The MoE blocks' aux losses fold
into the loss with `aux_weights`.

Serving: `prefill` runs the prompt and builds the decode state,
`decode_step` takes one token a lane, `init_decode_state` makes an empty
state.  The state is the reference's tree, {"prelude": [...], "repeat":
[...], "pos": 0-dim int32}, each segment's leaves stacked [count, ...] or
[repeats, count, ...] (a shared segment keeps one state a repeat), so it
converts leaf by leaf (``convert.decode_state_from_jax``).  Unlike the
reference, `decode_step` writes each layer's slice of the stacked state in
place and returns the same dict (the caller's state changes), and
`prefill` writes its caches straight into a fresh state: neither copies a
cache.  A step reads nothing back to the host, so its launches queue ahead
of the card.  All three run without autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.core.table import resolve_device
from repro_torch.embedding import dense
from repro_torch.models import ssm
from repro_torch.models import blocks as blocks_mod
from repro_torch.models.blocks import (BlockCfg, PosCtx, block_decode, block_init,
                                       block_state_init, block_train)
from repro_torch.models.common import (causal_attention, cross_entropy_loss, dense_init, init_rms,
                                       rms_norm, sinusoidal_embedding)


@dataclasses.dataclass(frozen=True)
class StackSegment:
    block: BlockCfg
    count: int
    shared: bool = False


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    d_model: int
    vocab: int
    segments: tuple
    repeats: int = 1
    prelude: tuple = ()
    tied_head: bool = True
    pos_embedding: str = "none"          # none | sinusoidal
    embed_scale: bool = False            # gemma: x *= sqrt(d)
    embedding_backend: str = "dense"     # dense | hkv
    frontend: Optional[str] = None       # None | vision
    dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    loss_chunk: int = 512
    aux_weights: tuple = (("load_balance", 0.01), ("router_z", 0.001))
    remat: bool = True                   # activation-checkpoint each block
    # the reference's choice between a scan over layers and an unrolled loop
    # in its train graph; the port always runs a Python loop over layers
    scan_layers: bool = False

    @property
    def num_layers(self) -> int:
        pre = sum(s.count for s in self.prelude)
        rep = sum(s.count for s in self.segments) * self.repeats
        return pre + rep


def _aux_zero(seg: StackSegment, device) -> dict:
    if seg.block.moe is not None:
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return {"load_balance": zero, "router_z": zero, "dropped_frac": zero}
    return {}


def _aux_add(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a} if a else {}


def _unstack(t) -> list:
    """A tree of stacked leaves [n, ...] -> n trees of [...] (one unbind per
    leaf, so the backward stacks the n gradients once)."""
    parts = tree.map(lambda a: a.unbind(0), t)
    n = len(tree.leaves(parts, is_leaf=lambda x: isinstance(x, tuple))[0])
    return [tree.map(lambda u, i=i: u[i], parts, is_leaf=lambda x: isinstance(x, tuple))
            for i in range(n)]


class CompositeLM:
    def __init__(self, cfg: LMConfig, attention: Optional[str] = None):
        """`attention` names the attention implementation of every block
        (``models.common.causal_attention``); None, the default, runs the
        one of the activations' device (``attention_impl``: the library
        call on the card, the blocked form on the CPU).  Decode steps have
        one form on both devices (``models.common.decode_attention``)."""
        self.cfg = cfg
        self.attention = attention
        self.dense = cfg.embedding_backend == "dense"

    # ------------------------------------------------------------------ init

    def init(self, generator: Optional[torch.Generator] = None, device=None) -> dict:
        """The parameter tree on `device` (default: the card; raises
        without one; 'meta' allocates nothing), drawn with `generator`."""
        cfg = self.cfg
        device = torch.device("meta") if str(device) == "meta" else resolve_device(device)
        params: dict = {"final_norm": init_rms(cfg.d_model, device)}
        if self.dense:
            params["embed"] = {"table": dense.init_table(cfg.vocab, cfg.d_model, device=device,
                                                         generator=generator)}
        if not cfg.tied_head or not self.dense:
            params["head"] = dense_init(generator, cfg.d_model, cfg.vocab, device=device)

        def stacked_init(block, *lead):
            n = 1
            for d in lead:
                n *= d
            layers = [block_init(block, generator, device) for _ in range(n)]
            return tree.map(lambda *xs: torch.stack(xs).reshape(lead + xs[0].shape), *layers)

        params["prelude"] = [stacked_init(s.block, s.count) for s in cfg.prelude]
        params["repeat"], params["shared"] = [], []
        for s in cfg.segments:
            if s.shared:
                params["shared"].append(block_init(s.block, generator, device))
                params["repeat"].append(None)
            else:
                params["repeat"].append(stacked_init(s.block, cfg.repeats, s.count))
                params["shared"].append(None)
        return params

    # --------------------------------------------------------------- forward

    def _scaled(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.embed_scale:
            # a fill on the device, not a copy from the host (which would sync)
            d = torch.full((), float(cfg.d_model), dtype=torch.float32, device=x.device)
            x = x * torch.sqrt(d).to(cfg.dtype)
        return x

    def _embed(self, params, tokens, embeds):
        cfg = self.cfg
        if embeds is not None:
            x = embeds.to(cfg.dtype)
        else:
            x = dense.lookup(params["embed"]["table"], tokens).to(cfg.dtype)
        return self._scaled(x)

    def _inputs(self, params, tokens, embeds, frontend_embeds, mrope_positions):
        cfg = self.cfg
        x = self._embed(params, tokens, embeds)
        if frontend_embeds is not None:  # the stub modality frontend (vision)
            sv = frontend_embeds.shape[1]
            x = torch.cat([frontend_embeds.to(cfg.dtype), x[:, sv:]], dim=1)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        if cfg.pos_embedding == "sinusoidal":
            x = x + sinusoidal_embedding(positions, cfg.d_model).to(cfg.dtype)
        return x, PosCtx(positions=positions, mrope_positions=mrope_positions)

    def _block(self, bcfg: BlockCfg, lp: dict, x: torch.Tensor, pos: PosCtx):
        if self.cfg.remat:
            # per-block activation checkpointing: the backward recomputes the
            # block from its input; only layer boundaries are saved
            return checkpoint(block_train, bcfg, lp, x, pos, self.attention,
                              use_reentrant=False)
        return block_train(bcfg, lp, x, pos, self.attention)

    def _apply_stack(self, params, x, pos):
        cfg = self.cfg
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux_total = {"load_balance": zero, "router_z": zero}

        def run(seg: StackSegment, layers: list, x):
            """The segment's layers; its aux losses (a MoE segment's) summed
            from zero in layer order, then folded into the totals."""
            aux = _aux_zero(seg, x.device)
            for lp in layers:
                x, a = self._block(seg.block, lp, x, pos)
                aux = _aux_add(aux, a)
            for k in ("load_balance", "router_z"):
                if k in aux:
                    aux_total[k] = aux_total[k] + aux[k]
            return x

        for seg, sp in zip(cfg.prelude, params["prelude"]):
            x = run(seg, _unstack(sp), x)
        if cfg.segments:
            per_rep = [None if p is None else _unstack(p) for p in params["repeat"]]
            for r in range(cfg.repeats):
                for si, seg in enumerate(cfg.segments):
                    layers = ([params["shared"][si]] if seg.shared
                              else _unstack(per_rep[si][r]))
                    x = run(seg, layers, x)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x, aux_total

    def hidden(self, params, tokens=None, *, embeds=None, frontend_embeds=None,
               mrope_positions=None):
        x, pos = self._inputs(params, tokens, embeds, frontend_embeds, mrope_positions)
        return self._apply_stack(params, x, pos)

    # ------------------------------------------------------------------ loss

    def _head(self, params) -> tuple[torch.Tensor, bool]:
        """(the head's weight, whether it is the tied embedding table)."""
        if self.cfg.tied_head and self.dense and "head" not in params:
            return params["embed"]["table"], True
        return params["head"], False

    @staticmethod
    def _project(w: torch.Tensor, tied: bool, h: torch.Tensor) -> torch.Tensor:
        return dense.attend(w, h) if tied else h @ w.to(h.dtype)

    def logits(self, params, hidden_chunk: torch.Tensor) -> torch.Tensor:
        return self._project(*self._head(params), hidden_chunk)

    @classmethod
    def _chunk_ce(cls, w, tied: bool, hx, lx):
        return cross_entropy_loss(cls._project(w, tied, hx), lx)

    def loss(self, params, tokens=None, labels=None, *, embeds=None, frontend_embeds=None,
             mrope_positions=None):
        """(total loss, {"ce", "load_balance", "router_z"}): the mean of the
        chunks' mean CE, plus the weighted aux losses."""
        cfg = self.cfg
        h, aux = self.hidden(params, tokens, embeds=embeds, frontend_embeds=frontend_embeds,
                             mrope_positions=mrope_positions)
        s = h.shape[1]
        ck = min(cfg.loss_chunk, s)
        if s % ck:
            raise ValueError(f"sequence length {s} is not a multiple of loss_chunk {ck}")
        w, tied = self._head(params)
        ces = []
        for i in range(0, s, ck):
            hx, lx = h[:, i:i + ck], labels[:, i:i + ck]
            if cfg.remat:
                ces.append(checkpoint(self._chunk_ce, w, tied, hx, lx, use_reentrant=False))
            else:
                ces.append(self._chunk_ce(w, tied, hx, lx))
        ce = torch.stack(ces).mean()
        total = ce
        for k, wt in cfg.aux_weights:
            total = total + wt * aux.get(k, 0.0)
        return total, {"ce": ce, **aux}

    # ----------------------------------------------------------------- serve

    def _layers(self, params, state):
        """(block config, layer parameters, layer state view) in stack order;
        a layer's state is a view into the stacked state (written in place)."""
        cfg = self.cfg
        at = lambda t, *i: tree.map(lambda a: a[i], t)  # noqa: E731
        for seg, sp, st in zip(cfg.prelude, params["prelude"], state["prelude"]):
            for i, lp in enumerate(_unstack(sp)):
                yield seg.block, lp, at(st, i)
        if cfg.segments:
            per_rep = [None if p is None else _unstack(p) for p in params["repeat"]]
            for r in range(cfg.repeats):
                for si, seg in enumerate(cfg.segments):
                    st = state["repeat"][si]
                    if seg.shared:
                        yield seg.block, params["shared"][si], at(st, r, 0)
                    else:
                        for i, lp in enumerate(_unstack(per_rep[si][r])):
                            yield seg.block, lp, at(st, r, i)

    @torch.no_grad()
    def init_decode_state(self, batch: int, max_len: int, device=None) -> dict:
        """An empty decode state on `device` (default: the card; raises
        without one)."""
        cfg = self.cfg
        device = resolve_device(device)

        def stacked(seg, *lead):
            one = block_state_init(seg.block, batch, max_len, cfg.dtype, device)
            return tree.map(lambda a: a.expand(lead + a.shape).clone(), one)

        return {"prelude": [stacked(s, s.count) for s in cfg.prelude],
                "repeat": [stacked(s, cfg.repeats, s.count) for s in cfg.segments],
                "pos": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def decode_step(self, params, tokens, state, *, embeds=None):
        """One new token a sequence: tokens [B] int (or embeds [B, 1, d]).
        Returns (logits [B, vocab], state), the state the one passed in,
        written in place.  Decode positions are `state["pos"]` on every
        axis (M-RoPE's three too), as in the reference."""
        cfg = self.cfg
        step = state["pos"]
        x = self._embed(params, None if tokens is None else tokens[:, None], embeds)
        b = x.shape[0]
        positions = step.to(torch.int32).reshape(1, 1).expand(b, 1)
        if cfg.pos_embedding == "sinusoidal":
            x = x + sinusoidal_embedding(positions, cfg.d_model).to(cfg.dtype)
        pos = PosCtx(positions=positions, mrope_positions=positions[None].expand(3, b, 1),
                     step=step)
        for bcfg, lp, ls in self._layers(params, state):
            x, _ = block_decode(bcfg, lp, x, ls, pos)
        state["pos"] = step + 1
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self.logits(params, x)[:, 0], state

    @torch.no_grad()
    def prefill(self, params, tokens, max_len: int, *, embeds=None, frontend_embeds=None,
                mrope_positions=None):
        """Run the prompt [B, S] and build its decode state.  Returns (the
        last position's logits [B, vocab], state): attention layers' K/V in
        their caches (a windowed cache as the ring decode continues), the
        SSM layers' final recurrent states."""
        cfg = self.cfg
        x, pos = self._inputs(params, tokens, embeds, frontend_embeds, mrope_positions)
        b, s = x.shape[:2]
        state = self.init_decode_state(b, max_len, device=x.device)
        state["pos"].fill_(s)
        for bcfg, lp, ls in self._layers(params, state):
            x = _block_prefill(bcfg, lp, x, pos, ls, self.attention)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self.logits(params, x[:, -1:])[:, 0], state


# ---------------------------------------------------------------------------
# per-block prefill (a full-sequence forward that also fills the decode state)
# ---------------------------------------------------------------------------


def _block_prefill(bcfg: BlockCfg, p: dict, x: torch.Tensor, pos: PosCtx, state: dict,
                   attention: Optional[str]) -> torch.Tensor:
    """The block over the prompt; its decode state written into `state`
    (the layer's view of a zeroed state)."""
    b, s, _ = x.shape
    if bcfg.kind == "attn":
        q, k, v = blocks_mod._qkv(bcfg, p, x, pos)
        o = causal_attention(q, k, v, window=bcfg.window, impl=attention)
        x = x + (o.reshape(b, s, -1) @ p["wo"].to(x.dtype))
        f, _ = blocks_mod._ffn(bcfg, p, x)
        x = x + f
        kc, vc = state["k"], state["v"]
        clen = kc.shape[1]
        if bcfg.window and s >= clen:
            # the ring: absolute position t lives in slot t % window
            shift = (s - clen) % clen
            kc.copy_(torch.roll(k[:, -clen:].to(kc.dtype), shift, dims=1))
            vc.copy_(torch.roll(v[:, -clen:].to(vc.dtype), shift, dims=1))
        else:
            kc[:, :s] = k
            vc[:, :s] = v
        return x
    if bcfg.kind == "mamba2":
        z, xs, Bm, Cm, dt = blocks_mod._mamba2_split(bcfg, p, x)
        xs_c = blocks_mod._causal_conv(xs, p["conv_w"], p["conv_b"])
        q, k, v, log_a, xh = blocks_mod._mamba2_gla_inputs(bcfg, p, xs_c, Bm, Cm, dt)
        y, gla = ssm.chunked_gla(q, k, v, log_a)
        state["gla"].copy_(gla)
        w = bcfg.conv_width - 1
        # the last w PRE-conv inputs, zeros before the prompt's start
        state["conv"][:, max(w - s, 0):] = xs[:, -w:]
        return blocks_mod._mamba2_out(bcfg, p, x, y, xh, z)
    if bcfg.kind == "mlstm":
        q, k, v_aug, log_f, zg = blocks_mod._mlstm_qkv(bcfg, p, x)
        y_aug, gla = ssm.chunked_gla(q, k, v_aug, log_f)
        state["gla"].copy_(gla)
        return blocks_mod._mlstm_out(bcfg, p, x, y_aug, zg)
    if bcfg.kind == "slstm":
        xg = rms_norm(x, p["ln"], bcfg.norm_eps) @ p["wx"].to(x.dtype)
        carry = blocks_mod._slstm_carry(bcfg, b, x.dtype, x.device)
        carry, h = blocks_mod._slstm_scan(bcfg, p, xg, carry)
        for name, c in zip(blocks_mod.SLSTM_STATE, carry):
            state[name].copy_(c)
        return x + h.reshape(b, s, -1).to(x.dtype) @ p["out"].to(x.dtype)
    raise ValueError(bcfg.kind)
