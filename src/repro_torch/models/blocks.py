"""The block zoo of the LM stack (port of ``repro/models/blocks.py``):
attention (GQA/MQA, an optional SWA band, QKV bias, RoPE or M-RoPE, a
dense FFN or a MoE), Mamba2 (SSD through the chunked GLA), mLSTM (the
chunked GLA with a normalizer column) and sLSTM (a sequential scan with
the exponential gate's stabilizer).

A block is a function (cfg, params, x, pos) -> (x, aux) over a plain dict
of tensors; aux holds the MoE FFN's losses and is empty otherwise.  Each
kind also has a decode state (`block_state_init`: the reference's leaves,
names and dtypes) and a single-token step over it (`block_decode`).  The
reference returns a new state; here the step writes the state's tensors
in place (a layer's state is a view into the model's stacked state) and
returns the same dict, so a step copies no cache.  A step reads no device
value on the host: the cache's write index, valid length and mask are
tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import ssm
from repro_torch.models.common import (activation, apply_mrope, apply_rope, causal_attention,
                                       decode_attention, dense_init, init_rms, normal, rms_norm,
                                       scalar, softplus)
from repro_torch.models.moe import MoECfg, moe_apply, moe_init


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

    positions: torch.Tensor                        # [B, S] (train/prefill) or [B, 1]
    mrope_positions: Optional[torch.Tensor] = None  # [3, B, S]
    step: Optional[torch.Tensor] = None             # decode: current length


# =============================================================================
# Attention block (+ dense or MoE FFN)
# =============================================================================


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
    if cfg.moe is not None:
        p["moe"] = moe_init(cfg.moe, generator, device)
    else:
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
    elif cfg.rope == "mrope":
        sec = _mrope_sections(hd)
        q = apply_mrope(q, pos.mrope_positions, cfg.rope_theta, sec)
        k = apply_mrope(k, pos.mrope_positions, cfg.rope_theta, sec)
    return q, k, v


def _mrope_sections(hd: int):
    """(t, h, w) frequency split covering head_dim/2 (Qwen2-VL uses 16/24/24
    at hd=128; scaled proportionally elsewhere)."""
    half = hd // 2
    t = half // 4
    hw = (half - t) // 2
    return (t, hw, half - t - hw)


def _ffn(cfg: BlockCfg, p: dict, x: torch.Tensor):
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        b, s, d = h.shape
        y, aux = moe_apply(cfg.moe, p["moe"], h.reshape(b * s, d))
        return y.reshape(b, s, d), aux
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


def _attn_state_init(cfg: BlockCfg, batch: int, max_len: int, dtype, device) -> dict:
    cache_len = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, cache_len, cfg.kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _attn_decode(cfg: BlockCfg, p: dict, x: torch.Tensor, state: dict, pos: PosCtx):
    """x: [B, 1, d]; an SWA cache is a ring of `window` slots (position t in
    slot t % window).  Without a window the write index is clamped to the
    cache, as the reference's dynamic_update_slice clamps it."""
    q, k, v = _qkv(cfg, p, x, pos)
    cache_len = state["k"].shape[1]
    step = pos.step
    widx = torch.remainder(step, cache_len) if cfg.window else torch.clamp(step, max=cache_len - 1)
    widx = widx.reshape(1).long()
    state["k"].index_copy_(1, widx, k.to(state["k"].dtype))
    state["v"].index_copy_(1, widx, v.to(state["v"].dtype))
    cur = torch.clamp(step + 1, max=cache_len)
    o = decode_attention(q, state["k"], state["v"], cur)
    b = x.shape[0]
    x = x + (o.reshape(b, 1, -1) @ p["wo"].to(x.dtype))
    f, _ = _ffn(cfg, p, x)
    return x + f, state


# =============================================================================
# Mamba2 block (SSD via chunked GLA)
# =============================================================================


def _mamba2_init(cfg: BlockCfg, generator: Optional[torch.Generator], device) -> dict:
    din, n, h = cfg.d_inner, cfg.d_state, cfg.ssm_heads
    proj_out = 2 * din + 2 * n + h  # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ln": init_rms(cfg.d_model, device),
        "in_proj": dense_init(generator, cfg.d_model, proj_out, device=device),
        "conv_w": normal(generator, (cfg.conv_width, din), device) * 0.1,
        "conv_b": torch.zeros((din,), **f32),
        "A_log": torch.zeros((h,), **f32),        # a = -exp(A_log)
        "D": torch.ones((h,), **f32),
        "dt_bias": torch.full((h,), -2.0, **f32),
        "out_norm": init_rms(din, device),
        "out_proj": dense_init(generator, din, cfg.d_model, device=device),
    }


def _mamba2_split(cfg: BlockCfg, p: dict, x: torch.Tensor):
    din, n, h = cfg.d_inner, cfg.d_state, cfg.ssm_heads
    u = rms_norm(x, p["ln"], cfg.norm_eps) @ p["in_proj"].to(x.dtype)
    return torch.split(u, [din, din, n, n, h], dim=-1)   # z, xs, B, C, dt


def _mamba2_gla_inputs(cfg: BlockCfg, p: dict, xs, Bm, Cm, dt):
    b, s, _ = xs.shape
    h, pd, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.d_state
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])            # [B, S, H]
    log_a = -torch.exp(p["A_log"]) * dt                            # [B, S, H] <= 0
    xh = xs.reshape(b, s, h, pd)
    v = xh * dt[..., None].to(xh.dtype)                            # dt-scaled input
    k = Bm[:, :, None, :].expand(b, s, h, n)
    q = Cm[:, :, None, :].expand(b, s, h, n)
    return q, k, v, log_a, xh


def _mamba2_out(cfg: BlockCfg, p: dict, x, y, xh, z):
    b, s = x.shape[0], x.shape[1]
    y = y + xh * p["D"][None, None, :, None].to(xh.dtype)
    y = y.reshape(b, s, cfg.d_inner) * F.silu(z)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    return x + y @ p["out_proj"].to(x.dtype)


def _causal_conv(xs: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over [B, S, C] with taps [W, C]; the taps are
    summed from tap 0, in the reference's order."""
    wlen = w.shape[0]
    pad = F.pad(xs, (0, 0, wlen - 1, 0))
    out = sum(pad[:, i:i + xs.shape[1], :] * w[i][None, None, :].to(xs.dtype)
              for i in range(wlen))
    return F.silu(out + b.to(xs.dtype))


def _mamba2_train(cfg: BlockCfg, p: dict, x: torch.Tensor, pos: PosCtx, attention=None):
    z, xs, Bm, Cm, dt = _mamba2_split(cfg, p, x)
    xs = _causal_conv(xs, p["conv_w"], p["conv_b"])
    q, k, v, log_a, xh = _mamba2_gla_inputs(cfg, p, xs, Bm, Cm, dt)
    y, _ = ssm.chunked_gla(q, k, v, log_a)
    return _mamba2_out(cfg, p, x, y, xh, z), {}


def _mamba2_state_init(cfg: BlockCfg, batch: int, max_len: int, dtype, device) -> dict:
    return {"gla": torch.zeros((batch, cfg.ssm_heads, cfg.d_state, cfg.ssm_headdim),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner), dtype=dtype,
                                device=device)}


def _mamba2_decode(cfg: BlockCfg, p: dict, x: torch.Tensor, state: dict, pos: PosCtx):
    """The conv history holds the last conv_width - 1 PRE-conv inputs."""
    z, xs, Bm, Cm, dt = _mamba2_split(cfg, p, x)          # all [B, 1, *]
    hist = torch.cat([state["conv"].to(xs.dtype), xs], dim=1)
    xs_c = _causal_conv(hist, p["conv_w"], p["conv_b"])[:, -1:, :]
    state["conv"].copy_(hist[:, 1:, :])
    q, k, v, log_a, xh = _mamba2_gla_inputs(cfg, p, xs_c, Bm, Cm, dt)
    y, gla = ssm.gla_step(state["gla"], q[:, 0], k[:, 0], v[:, 0], log_a[:, 0])
    state["gla"].copy_(gla)
    return _mamba2_out(cfg, p, x, y[:, None], xh, z), state


# =============================================================================
# mLSTM block (xLSTM matrix memory via chunked GLA with a normalizer column)
# =============================================================================


def _mlstm_init(cfg: BlockCfg, generator: Optional[torch.Generator], device) -> dict:
    din, qb = cfg.d_inner, cfg.qkv_block
    dense = lambda *a: dense_init(generator, *a, device=device)  # noqa: E731

    # q/k/v are BLOCK-DIAGONAL projections (xLSTM's qkv_proj_blocksize):
    # [din/qb, qb, qb] blocks
    def bd():
        return normal(generator, (din // qb, qb, qb), device) / math.sqrt(qb)

    return {
        "ln": init_rms(cfg.d_model, device),
        "up": dense(cfg.d_model, 2 * din),   # u (mixer) + z (gate)
        "wq": bd(),
        "wk": bd(),
        "wv": bd(),
        "wgate": dense(din, 2 * cfg.ssm_heads),  # i, f pre-activations
        "down": dense(din, cfg.d_model),
    }


def _block_diag_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., din] @ block-diag([G, qb, qb]) -> [..., din]."""
    g, qb, _ = w.shape
    xb = x.reshape(x.shape[:-1] + (g, qb))
    return torch.einsum("...gb,gbc->...gc", xb, w.to(x.dtype)).reshape(x.shape)


def _mlstm_qkv(cfg: BlockCfg, p: dict, x: torch.Tensor):
    b, s, _ = x.shape
    din, h = cfg.d_inner, cfg.ssm_heads
    pd = din // h
    u, z = torch.chunk(rms_norm(x, p["ln"], cfg.norm_eps) @ p["up"].to(x.dtype), 2, dim=-1)
    q = _block_diag_proj(u, p["wq"]).reshape(b, s, h, pd) / math.sqrt(pd)
    k = _block_diag_proj(u, p["wk"]).reshape(b, s, h, pd) / math.sqrt(pd)
    v = _block_diag_proj(u, p["wv"]).reshape(b, s, h, pd)
    gates = u @ p["wgate"].to(u.dtype)
    i_pre, f_pre = torch.chunk(gates.to(torch.float32), 2, dim=-1)  # [B, S, H]
    log_f = -softplus(-f_pre)                                        # log sigmoid(f)
    ig = torch.sigmoid(i_pre)  # the sigmoid input gate (the reference's adaptation)
    # normalizer column: v_aug = i * [v, 1]
    ones = torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
    v_aug = torch.cat([v, ones], dim=-1) * ig[..., None].to(v.dtype)
    return q, k, v_aug, log_f, z


def _mlstm_out(cfg: BlockCfg, p: dict, x, y_aug, z):
    y, norm = y_aug[..., :-1], y_aug[..., -1:]
    y = y / torch.maximum(norm.abs(), scalar(1.0, norm))
    b, s = x.shape[0], x.shape[1]
    h = y.reshape(b, s, cfg.d_inner) * F.silu(z)
    return x + h @ p["down"].to(x.dtype)


def _mlstm_train(cfg: BlockCfg, p: dict, x: torch.Tensor, pos: PosCtx, attention=None):
    q, k, v_aug, log_f, z = _mlstm_qkv(cfg, p, x)
    y_aug, _ = ssm.chunked_gla(q, k, v_aug, log_f)
    return _mlstm_out(cfg, p, x, y_aug, z), {}


def _mlstm_state_init(cfg: BlockCfg, batch: int, max_len: int, dtype, device) -> dict:
    pd = cfg.d_inner // cfg.ssm_heads
    return {"gla": torch.zeros((batch, cfg.ssm_heads, pd, pd + 1), dtype=torch.float32,
                               device=device)}


def _mlstm_decode(cfg: BlockCfg, p: dict, x: torch.Tensor, state: dict, pos: PosCtx):
    q, k, v_aug, log_f, z = _mlstm_qkv(cfg, p, x)
    y_aug, gla = ssm.gla_step(state["gla"], q[:, 0], k[:, 0], v_aug[:, 0], log_f[:, 0])
    state["gla"].copy_(gla)
    return _mlstm_out(cfg, p, x, y_aug[:, None], z), state


# =============================================================================
# sLSTM block (scalar memory, exponential gating with stabilizer; sequential)
# =============================================================================


def _slstm_init(cfg: BlockCfg, generator: Optional[torch.Generator], device) -> dict:
    d, h = cfg.d_model, cfg.ssm_heads
    pd = d // h
    return {
        "ln": init_rms(d, device),
        "wx": dense_init(generator, d, 4 * d, device=device),      # z, i, f, o from input
        "r": normal(generator, (h, pd, 4 * pd), device) / math.sqrt(pd),
        "out": dense_init(generator, d, d, device=device),
    }


def _slstm_cell(cfg: BlockCfg, r: torch.Tensor, xg, carry, one: torch.Tensor):
    """One step. r: the recurrent weights [H, pd, 4pd] in the carry's dtype;
    xg: [B, 4d] input gate pre-activations; carry: (c, n, h, m); one: a
    float32 1 on the carry's device."""
    b = xg.shape[0]
    d, hh = cfg.d_model, cfg.ssm_heads
    pd = d // hh
    c, n, hprev, m = carry
    # einsum("bhp,hpq->bhq"): one product a head
    rec = torch.bmm(hprev.transpose(0, 1), r).transpose(0, 1)    # [B, H, 4pd]
    g = xg.reshape(b, hh, 4 * pd) + rec
    zg, ig, fg, og = torch.chunk(g.to(torch.float32), 4, dim=-1)
    log_f = -softplus(-fg)
    fm = log_f + m
    m_new = torch.maximum(fm, ig)                          # stabilizer
    i_s = torch.exp(ig - m_new)
    f_s = torch.exp(fm - m_new)
    c = f_s * c + i_s * torch.tanh(zg)
    n = f_s * n + i_s
    h = torch.sigmoid(og) * c / torch.maximum(n, one)
    return (c, n, h.to(hprev.dtype), m_new), h


def _slstm_carry(cfg: BlockCfg, batch: int, dtype, device):
    """The scan's initial (c, n, h, m): m, the stabilizer, starts at -1e30."""
    shape = (batch, cfg.ssm_heads, cfg.d_model // cfg.ssm_heads)
    f32 = dict(dtype=torch.float32, device=device)
    # four tensors: a decode state writes each in place
    return (torch.zeros(shape, **f32), torch.zeros(shape, **f32),
            torch.zeros(shape, dtype=dtype, device=device), torch.full(shape, -1e30, **f32))


def _slstm_scan(cfg: BlockCfg, p: dict, xg: torch.Tensor, carry):
    """The cell over xg [B, S, 4d] from `carry`: (the last carry, the
    cell's outputs [B, S, H, pd] in float32)."""
    r, one = p["r"].to(carry[2].dtype), scalar(1.0, carry[0])
    hs = []
    for xg_t in xg.unbind(1):   # one unbind: its backward is one stack
        carry, h = _slstm_cell(cfg, r, xg_t, carry, one)
        hs.append(h)
    return carry, torch.stack(hs, dim=1)


def _slstm_train(cfg: BlockCfg, p: dict, x: torch.Tensor, pos: PosCtx, attention=None):
    b, s, d = x.shape
    xg = rms_norm(x, p["ln"], cfg.norm_eps) @ p["wx"].to(x.dtype)  # [B, S, 4d]
    _, h = _slstm_scan(cfg, p, xg, _slstm_carry(cfg, b, x.dtype, x.device))
    h = h.reshape(b, s, d).to(x.dtype)
    return x + h @ p["out"].to(x.dtype), {}


SLSTM_STATE = ("c", "n", "h", "m")


def _slstm_state_init(cfg: BlockCfg, batch: int, max_len: int, dtype, device) -> dict:
    return dict(zip(SLSTM_STATE, _slstm_carry(cfg, batch, dtype, device)))


def _slstm_decode(cfg: BlockCfg, p: dict, x: torch.Tensor, state: dict, pos: PosCtx):
    xg = rms_norm(x, p["ln"], cfg.norm_eps) @ p["wx"].to(x.dtype)
    carry, h = _slstm_scan(cfg, p, xg, tuple(state[k] for k in SLSTM_STATE))
    for k, c in zip(SLSTM_STATE, carry):
        state[k].copy_(c)
    b = x.shape[0]
    out = x + h.reshape(b, 1, -1).to(x.dtype) @ p["out"].to(x.dtype)
    return out, state


# =============================================================================
# dispatch tables
# =============================================================================

_INIT = {"attn": _attn_init, "mamba2": _mamba2_init, "mlstm": _mlstm_init,
         "slstm": _slstm_init}
_TRAIN = {"attn": _attn_train, "mamba2": _mamba2_train, "mlstm": _mlstm_train,
          "slstm": _slstm_train}
_STATE = {"attn": _attn_state_init, "mamba2": _mamba2_state_init,
          "mlstm": _mlstm_state_init, "slstm": _slstm_state_init}
_DECODE = {"attn": _attn_decode, "mamba2": _mamba2_decode,
           "mlstm": _mlstm_decode, "slstm": _slstm_decode}


def block_init(cfg: BlockCfg, generator: Optional[torch.Generator] = None, device=None) -> dict:
    return _INIT[cfg.kind](cfg, generator, device)


def block_train(cfg: BlockCfg, params: dict, x: torch.Tensor, pos: PosCtx,
                attention: Optional[str] = None):
    """The block over a full sequence; `attention` names the attention
    blocks' implementation (``models.common.causal_attention``; None: the
    one of `x`'s device)."""
    return _TRAIN[cfg.kind](cfg, params, x, pos, attention)


def block_state_init(cfg: BlockCfg, batch: int, max_len: int, dtype, device=None) -> dict:
    """One layer's decode state: a KV cache of min(max_len, window) slots,
    or the recurrent state (float32, but mamba2's conv history in `dtype`)."""
    return _STATE[cfg.kind](cfg, batch, max_len, dtype, device)


def block_decode(cfg: BlockCfg, params: dict, x: torch.Tensor, state: dict, pos: PosCtx):
    """One token x [B, 1, d] through the block: (x, state), the state
    written in place; `pos.step` is the 0-dim position of the token."""
    return _DECODE[cfg.kind](cfg, params, x, state, pos)
