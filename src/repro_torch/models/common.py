"""Shared LM machinery: norms, rotary positions, activations, dense init,
the loss, causal attention and single-token attention against a KV cache
(port of ``repro/models/common.py``).

Attention has two implementations behind one entry point,
`causal_attention(..., impl=)`, chosen by the device of the queries
(`attention_impl`) unless the caller names one:

  "blocked"  `blocked_causal_attention`: the reference's flash-style
             two-level blocking in plain torch (an online-softmax forward
             over KV chunks, a backward that recomputes p per chunk pair),
             with grouped GQA (KV heads never expanded) and the SWA band;
  "sdpa"     ``F.scaled_dot_product_attention`` (causal, or the band as a
             mask), the card's library call for the same function.  The
             reference computes attention in plain jnp, outside any Pallas
             kernel, so a library call stands for it here.

`decode_attention` (one new token against a KV cache, masked beyond the
cache's valid length) has one form on both devices: the reference's
grouped form in plain torch (q reshaped to [B, Hkv, rep, Dh], the cache
never repeated to Hq; float32 scores from products that read the bfloat16
cache as it is).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms, positions, activations, init, loss
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.to(torch.float32))).to(dtype)


def init_rms(d: int, device=None) -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=device)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: [B, S, H, Dh], positions: [B, S] int32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs  # [B, S, Dh/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float = 10000.0,
                sections=(16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: positions3 [3, B, S] = (t, h, w) ids; the
    head_dim/2 frequency slots are split into (t, h, w) sections."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # [Dh/2]
    sec = np.cumsum((0,) + tuple(sections))
    if sec[-1] != dh // 2:
        raise ValueError(f"mrope sections {tuple(sections)} must cover head_dim/2 = {dh // 2}")
    ang = torch.cat([positions3[i][..., None].to(torch.float32) * freqs[sec[i]:sec[i + 1]]
                     for i in range(3)], dim=-1)  # [B, S, Dh/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embedding(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """MusicGen-style sinusoidal position embedding. positions: [B, S]."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor of `like`'s dtype and device (a binary operator such
    as ``torch.maximum`` takes no Python number)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the reference's ``jax.nn.softplus`` forms it
    (logaddexp(x, 0)); torch's ``F.softplus`` returns x itself past 20."""
    return torch.logaddexp(x, scalar(0.0, x))


def activation(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def normal(generator: Optional[torch.Generator], shape: tuple, device=None) -> torch.Tensor:
    """float32 N(0, 1) of `shape` drawn with `generator` ('meta' draws nothing)."""
    gen = None if torch.device(device).type == "meta" else generator
    return torch.randn(shape, generator=gen, device=device)


def dense_init(generator: Optional[torch.Generator], d_in: int, d_out: int, scale=None,
               device=None) -> torch.Tensor:
    """[d_in, d_out] float32 from N(0, scale^2), scale 1/sqrt(d_in) by
    default ('meta' draws nothing)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal(generator, (d_in, d_out), device) * scale


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE; labels < 0 are masked out."""
    mask = labels >= 0
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = (lse - ll) * mask
    return nll.sum() / mask.sum().clamp(min=1)


# ---------------------------------------------------------------------------
# Blocked causal attention (flash-style, plain torch)
# ---------------------------------------------------------------------------

def _band_mask(q_pos, kv_pos, window, s_valid):
    mask = q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        mask &= (q_pos[:, None] - kv_pos[None, :]) < window
    mask &= (kv_pos < s_valid)[None, :]
    return mask


def _chunk_live(qi, kj, q_chunk, kv_chunk, window) -> bool:
    """Is any (q, kv) pair of this chunk pair inside the causal band?"""
    last_q = qi * q_chunk + q_chunk - 1
    first_q = qi * q_chunk
    first_kv = kj * kv_chunk
    last_kv = kj * kv_chunk + kv_chunk - 1
    live = last_q >= first_kv
    if window is not None:
        live = live and (first_q - last_kv) < window
    return live


def _ein(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An einsum with float32 products and sums (the reference's
    preferred_element_type=float32 on its bfloat16 operands)."""
    return torch.einsum(spec, a.to(torch.float32), b.to(torch.float32))


def _blocks(q, k, v, q_chunk, kv_chunk):
    b, s, hq, dh = q.shape
    g = k.shape[2]
    r = hq // g
    nq, nkv = s // q_chunk, k.shape[1] // kv_chunk
    qb = q.reshape(b, nq, q_chunk, g, r, dh).permute(1, 0, 3, 4, 2, 5)
    kb = k.reshape(b, nkv, kv_chunk, g, dh).permute(1, 0, 3, 2, 4)
    vb = v.reshape(b, nkv, kv_chunk, g, dh).permute(1, 0, 3, 2, 4)
    return qb, kb, vb


def _unblock_q(x, shape):
    b, s, hq, dh = shape
    # [nq, B, G, R, qc, dh] -> [B, S, Hq, dh]
    return x.permute(1, 0, 4, 2, 3, 5).reshape(b, s, hq, dh)


def _flash_fwd_impl(q, k, v, window, q_chunk, kv_chunk, s_valid):
    """Grouped-GQA flash forward: q [B,S,Hq,Dh], k/v [B,S,Hkv,Dh].  Returns
    (out [B,S,Hq,Dh], lse [nq,B,G,R,qc]): O(S*Dh) residuals."""
    b, s, hq, dh = q.shape
    g = k.shape[2]
    r = hq // g
    nq, nkv = s // q_chunk, k.shape[1] // kv_chunk
    scale = 1.0 / math.sqrt(dh)
    qb, kb, vb = _blocks(q, k, v, q_chunk, kv_chunk)
    q_base = torch.arange(q_chunk, device=q.device)
    kv_base = torch.arange(kv_chunk, device=q.device)
    outs, lses = [], []
    for qi in range(nq):
        qc = qb[qi]
        m = torch.full((b, g, r, q_chunk), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, g, r, q_chunk), dtype=torch.float32, device=q.device)  # noqa: E741
        acc = torch.zeros((b, g, r, q_chunk, dh), dtype=torch.float32, device=q.device)
        for kj in range(nkv):
            if not _chunk_live(qi, kj, q_chunk, kv_chunk, window):
                continue
            sc = _ein("bgrqd,bgkd->bgrqk", qc, kb[kj]) * scale
            mask = _band_mask(qi * q_chunk + q_base, kj * kv_chunk + kv_base, window, s_valid)
            sc = torch.where(mask[None, None, None], sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)  # noqa: E741
            acc = acc * alpha[..., None] + _ein("bgrqk,bgkd->bgrqd", p.to(vb.dtype), vb[kj])
            m = m_new
        outs.append((acc / l.clamp(min=1e-30)[..., None]).to(q.dtype))
        lses.append(m + torch.log(l.clamp(min=1e-30)))
    return _unblock_q(torch.stack(outs), q.shape), torch.stack(lses)


def _flash_bwd(q, k, v, out, lse, dout, window, q_chunk, kv_chunk, s_valid):
    """Flash backward: recompute p per chunk pair; O(S*Dh) live memory.
    dk/dv sum over the rep dim inside the chunk (at Hkv width)."""
    b, s, hq, dh = q.shape
    s_kv, g = k.shape[1], k.shape[2]
    nq, nkv = s // q_chunk, s_kv // kv_chunk
    scale = 1.0 / math.sqrt(dh)
    qb, kb, vb = _blocks(q, k, v, q_chunk, kv_chunk)
    dob = _blocks(dout, k, v, q_chunk, kv_chunk)[0]
    outb = _blocks(out, k, v, q_chunk, kv_chunk)[0]
    delta = torch.sum(dob.to(torch.float32) * outb.to(torch.float32), dim=-1)
    q_base = torch.arange(q_chunk, device=q.device)
    kv_base = torch.arange(kv_chunk, device=q.device)
    dk = torch.zeros((nkv, b, g, kv_chunk, dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    for qi in range(nq):
        qc, doc, lsec, delc = qb[qi], dob[qi], lse[qi], delta[qi]
        dq = torch.zeros(qc.shape, dtype=torch.float32, device=q.device)
        for kj in range(nkv):
            if not _chunk_live(qi, kj, q_chunk, kv_chunk, window):
                continue
            kc, vc = kb[kj], vb[kj]
            sc = _ein("bgrqd,bgkd->bgrqk", qc, kc) * scale
            mask = _band_mask(qi * q_chunk + q_base, kj * kv_chunk + kv_base, window, s_valid)
            p = torch.where(mask[None, None, None], torch.exp(sc - lsec[..., None]), 0.0)
            dv[kj] += _ein("bgrqk,bgrqd->bgkd", p.to(doc.dtype), doc)
            dp = _ein("bgrqd,bgkd->bgrqk", doc, vc)
            ds = p * (dp - delc[..., None]) * scale
            dq += _ein("bgrqk,bgkd->bgrqd", ds.to(kc.dtype), kc)
            dk[kj] += _ein("bgrqk,bgrqd->bgkd", ds.to(qc.dtype), qc)
        dqs.append(dq)
    dq = _unblock_q(torch.stack(dqs), q.shape).to(q.dtype)
    dk = dk.permute(1, 0, 3, 2, 4).reshape(b, s_kv, g, dh).to(k.dtype)
    dv = dv.permute(1, 0, 3, 2, 4).reshape(b, s_kv, g, dh).to(v.dtype)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window, q_chunk, kv_chunk, s_valid):
        out, lse = _flash_fwd_impl(q, k, v, window, q_chunk, kv_chunk, s_valid)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (window, q_chunk, kv_chunk, s_valid)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_bwd(q, k, v, out, lse, dout, *ctx.cfg), None, None, None, None)


def blocked_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             window: Optional[int] = None, q_chunk: int = 512,
                             kv_chunk: int = 1024) -> torch.Tensor:
    """Flash-style causal (optionally banded) attention in plain torch.
    q [B, S, Hq, Dh], k/v [B, S, Hkv, Dh].

    Forward: two-level blocking with an online-softmax carry, never an
    S x S matrix.  Backward (an autograd Function): recomputes p per chunk
    pair, so residuals are O(S x Dh).  SWA skips chunk pairs entirely
    outside the band.  GQA is grouped: KV heads are never expanded to Hq.
    """
    b, s, hq, dh = q.shape
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, s)
    pad_q = -(-s // q_chunk) * q_chunk - s
    pad_kv = -(-s // kv_chunk) * kv_chunk - s
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
    out = _Flash.apply(q, k, v, window, q_chunk, kv_chunk, s)
    return out[:, :s]


def sdpa_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          window: Optional[int] = None) -> torch.Tensor:
    """The same function through ``F.scaled_dot_product_attention``: causal
    with grouped KV heads, or (with a window) the band as a boolean mask
    over KV heads expanded to Hq."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is None:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    else:
        s, rep = q.shape[1], q.shape[2] // k.shape[2]
        pos = torch.arange(s, device=q.device)
        mask = _band_mask(pos, pos, window, s)
        kt, vt = kt.repeat_interleave(rep, dim=1), vt.repeat_interleave(rep, dim=1)
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    return out.transpose(1, 2)


ATTENTION_IMPLS = ("blocked", "sdpa")


def attention_impl(device) -> str:
    """The attention a model on `device` runs: the library call on the card,
    the reference's blocked form on the CPU."""
    return "sdpa" if torch.device(device).type == "cuda" else "blocked"


def causal_attention(q, k, v, *, window: Optional[int] = None, impl: Optional[str] = None):
    """`impl` None: the implementation of `q`'s device (`attention_impl`)."""
    impl = attention_impl(q.device) if impl is None else impl
    if impl == "sdpa":
        return sdpa_causal_attention(q, k, v, window=window)
    if impl != "blocked":
        raise ValueError(f"attention {impl!r}; one of {ATTENTION_IMPLS}")
    return blocked_causal_attention(q, k, v, window=window)


# ---------------------------------------------------------------------------
# Single-token attention against a KV cache
# ---------------------------------------------------------------------------

def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A batched product summed in float32 and returned in float32 (the
    reference's preferred_element_type=float32), without a float32 copy of
    a bfloat16 operand on the card: ``bmm``'s out_dtype form there."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cur_len: torch.Tensor) -> torch.Tensor:
    """Single-step attention against a KV cache, the reference's grouped
    form.  q [B, 1, Hq, Dh]; caches [B, Sc, Hkv, Dh]; cur_len a 0-dim int
    tensor (valid cache positions).  Scores in float32, masked beyond
    cur_len, softmax in float32, P rounded to the cache's dtype for the PV
    product.  The products run one group at a time over whichever of the
    lanes and the KV heads are fewer, so that each reads its operands in
    place through strides (a batched product over both would need a copy of
    the cache)."""
    b, sc, hkv, dh = k_cache.shape
    hq = q.shape[2]
    rep = hq // hkv
    qg = q.reshape(b, hkv, rep, dh)
    scale = 1.0 / math.sqrt(dh)
    mask = torch.arange(sc, device=q.device) < cur_len
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
    if b <= hkv:   # one lane at a time, its KV heads batched: [Hkv, ...]
        groups = [(qg[i], k_cache[i].permute(1, 2, 0), v_cache[i].transpose(0, 1))
                  for i in range(b)]
        dim = 0
    else:          # one KV head at a time, the lanes batched: [B, ...]
        groups = [(qg[:, h], k_cache[:, :, h].transpose(1, 2), v_cache[:, :, h])
                  for h in range(hkv)]
        dim = 1
    outs = []
    for qq, kt, vv in groups:
        s = _bmm_f32(qq, kt) * scale                      # [G, rep, Sc]
        p = torch.softmax(torch.where(mask, s, neg), dim=-1).to(vv.dtype)
        outs.append(torch.bmm(p, vv))                      # [G, rep, Dh]
    out = torch.stack(outs, dim=dim)                       # [B, Hkv, rep, Dh]
    return out.reshape(b, 1, hq, dh).to(q.dtype)
