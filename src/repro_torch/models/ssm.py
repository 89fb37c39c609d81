"""Chunked gated linear attention (GLA) and its recurrent step (port of
``repro/models/ssm.py``).

Mamba2's SSD and xLSTM's mLSTM are both instances of the recurrence

    S_t = a_t * S_{t-1} + k_t ⊗ v_t          (state: [N, P] per head)
    y_t = q_t · S_t

with a per-(head, step) scalar decay a_t ∈ (0, 1].  `chunked_gla` evaluates
it in chunks: a quadratic term inside each chunk and a carried state
between chunks.  The reference scans the chunks (``lax.scan``); here every
term that depends on one chunk alone runs batched over all chunks, and a
Python loop carries the state, with the reference's operations in its
order on each chunk.  Decay arithmetic is in log space with log a ≤ 0, so
every exponential is ≤ 1.

Every product that the reference asks for with
``preferred_element_type=float32`` multiplies and sums in float32 and
returns float32 (``models.common._ein``), on operands rounded to the
dtype the reference rounds them to first.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import _ein


def chunked_gla(q: torch.Tensor,        # [B, S, H, N]
                k: torch.Tensor,        # [B, S, H, N]
                v: torch.Tensor,        # [B, S, H, P]
                log_a: torch.Tensor,    # [B, S, H]  (log decay, <= 0)
                chunk: int = 128,
                initial_state: Optional[torch.Tensor] = None,  # [B, H, N, P]
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, S, H, P] in v's dtype, final_state [B, H, N, P] float32)."""
    b, s, h, n = q.shape
    p = v.shape[-1]
    chunk = min(chunk, s)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        # padded steps must not decay the carried state: log a = 0
        log_a = F.pad(log_a, (0, 0, 0, pad))
    # [B, nc, L, H, *]: the chunks side by side.  Every term but the carried
    # state depends on its chunk alone, so each is one batched operation over
    # all chunks; only the state's recurrence runs chunk after chunk, as the
    # reference's scan carries it
    qc, kc, vc = (x.reshape(b, nc, chunk, h, x.shape[-1]) for x in (q, k, v))
    A = torch.cumsum(log_a.reshape(b, nc, chunk, h), dim=2)   # inclusive cum-log-decay
    # intra-chunk: score_ij = (q_i . k_j) * exp(A_i - A_j), j <= i
    sc = _ein("bcihn,bcjhn->bchij", qc, kc)                   # [B, nc, H, L, L]
    At = A.transpose(2, 3)
    decay = At[..., :, None] - At[..., None, :]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    sc = sc * torch.exp(torch.where(causal, decay, -torch.inf))
    y_intra = _ein("bchij,bcjhp->bcihp", sc.to(v.dtype), vc)
    # the state's update from each chunk: exp(A_L - A_j) k_j (x) v_j summed
    a_last = A[:, :, -1, :]                                   # [B, nc, H]
    kdec = kc * torch.exp(a_last[:, :, None, :] - A)[..., None].to(k.dtype)
    outer = _ein("bcjhn,bcjhp->bchnp", kdec, vc)              # [B, nc, H, N, P]
    # the recurrence S' = exp(A_L) S + outer; each chunk reads the state it
    # is handed (unbind, not per-chunk indexing: the backward of an index
    # would zero-fill a gradient of all chunks for each one)
    state = (initial_state.to(torch.float32) if initial_state is not None
             else torch.zeros((b, h, n, p), dtype=torch.float32, device=q.device))
    handed = []
    for dec, out in zip(torch.exp(a_last)[..., None, None].unbind(1), outer.unbind(1)):
        handed.append(state.to(q.dtype))
        state = state * dec + out
    # inter-chunk: y_i += exp(A_i) * q_i . S_prev
    qdec = qc * torch.exp(A)[..., None].to(q.dtype)
    y_inter = _ein("bcihn,bchnp->bcihp", qdec, torch.stack(handed, dim=1))
    y = (y_intra + y_inter).to(v.dtype).reshape(b, nc * chunk, h, p)
    return y[:, :s], state


def gla_step(state: torch.Tensor,   # [B, H, N, P]
             q: torch.Tensor,       # [B, H, N]
             k: torch.Tensor,       # [B, H, N]
             v: torch.Tensor,       # [B, H, P]
             log_a: torch.Tensor,   # [B, H]
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of the same recurrence.  Returns (y [B, H, P], state)."""
    state = state * torch.exp(log_a)[..., None, None] + _ein("bhn,bhp->bhnp", k, v)
    y = _ein("bhn,bhnp->bhp", q, state.to(q.dtype))
    return y.to(v.dtype), state


def gla_reference(q, k, v, log_a):
    """The sequential oracle for tests: `gla_step` over every position."""
    b, s, h, n = q.shape
    p = v.shape[-1]
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=q.device)
    ys = []
    for t in range(s):
        y, state = gla_step(state, q[:, t], k[:, t], v[:, t], log_a[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), state
