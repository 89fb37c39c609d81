"""Sparse optimizers for HKV-backed embeddings (the updater's gradient step).

As in the reference (``repro/embedding/sparse_opt.py``), optimizer state
lives in each embedding row's aux value columns, ``[emb dim | aux]``, so an
eviction carries it away with the row and an admission starts fresh:

  sgd              0 aux columns
  sgdm             ``dim`` aux columns: the momentum buffer
  rowwise_adagrad  1 aux column: the accumulated mean squared gradient
  adagrad          ``dim`` aux columns: per-coordinate accumulators

``apply`` evaluates the reference's formulas in the reference's order, one
IEEE rounding per operation, so that the CUDA ``update_scan`` kernel
(which writes each operation as an ``__f*_rn`` intrinsic) and this plain
version agree bit for bit on any device.  Two PyTorch traps are avoided on
purpose: a python scalar divided by a tensor (``lr / x``) is computed as
``x.reciprocal() * lr``, and a tensor divided by a python scalar may be
too, so every quotient here is a tensor-by-tensor ``torch.div``; and no
fused op (``addcmul``, ``addcdiv``, ``lerp``, ``sub(..., alpha=)``) is
used, since each rounds a product and a sum once.  And torch's vectorized
float32 ``sqrt`` on the CPU is not correctly rounded for every input (some
results are an ulp off on an AVX-512 build), so the root is taken in
float64 and rounded once to float32, which gives the correctly rounded
root that the kernel's ``__fsqrt_rn`` and XLA compute.

On a bfloat16 or float16 plane every tensor op computes in float32 and
rounds its result to the plane's type once, a Python scalar stays float32
in a product or a sum, and ``_div`` rounds a scalar to the plane's type
where it fills a tensor with it (lr, dim); the kernel rounds at the same
points, so the two still agree bit for bit.  Against the JAX package,
whose XLA ops keep float32 inside a fused op and round Python scalars to
the plane's type, bfloat16 and float16 results agree within a tolerance
only.

The row mean of ``rowwise_adagrad`` is the one reduction.  It is taken in
one fixed order, a halving tree over the ``dim`` columns zero-padded to a
power of two (``x[:, :h] + x[:, h:]``), which is the order of the kernel's
warp butterfly; the reference's XLA reduction sums in its own order, so
against the JAX package this optimizer agrees within a tolerance only.
"""

from __future__ import annotations

import dataclasses

import torch



def tree_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of [N, D] in the kernels' fixed order: zero-pad the columns
    to a power of two, then halve (column i plus column i + h) until one
    is left."""
    n, d = x.shape
    p = 1 << max(d - 1, 0).bit_length()
    if p != d:
        x = torch.cat([x, x.new_zeros((n, p - d))], dim=1)
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x[:, 0]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root (a float64 root of a float32
    value, rounded once, is the correctly rounded float32 root)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _div(a, b: torch.Tensor) -> torch.Tensor:
    """A correctly rounded quotient, for a python scalar or tensor `a`."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    return torch.div(a, b)


@dataclasses.dataclass(frozen=True)
class SparseOptimizer:
    name: str = "rowwise_adagrad"
    lr: float = 0.01
    eps: float = 1e-10
    momentum: float = 0.9

    def __post_init__(self):
        if self.name not in ("sgd", "sgdm", "rowwise_adagrad", "adagrad"):
            raise ValueError(f"unknown sparse optimizer {self.name!r}")

    def aux_dim(self, dim: int) -> int:
        return {"sgd": 0, "sgdm": dim, "rowwise_adagrad": 1, "adagrad": dim}[self.name]

    def apply(self, rows: torch.Tensor, grads: torch.Tensor, dim: int) -> torch.Tensor:
        """rows: [N, dim + aux] gathered table rows; grads: [N, dim].
        Returns the updated rows (embedding and refreshed aux columns)."""
        emb, aux = rows[:, :dim], rows[:, dim:]
        g = grads.to(emb.dtype)
        lr = self.lr
        if self.name == "sgd":
            return emb - lr * g
        if self.name == "sgdm":
            m = self.momentum * aux + g
            return torch.cat([emb - lr * m, m], dim=1)
        if self.name == "rowwise_adagrad":
            mean = _div(tree_row_sum(g * g), torch.full_like(g[:, 0], dim))
            acc = aux[:, 0] + mean
            step = _div(lr, _sqrt(acc) + self.eps)
            return torch.cat([emb - step[:, None] * g, acc[:, None]], dim=1)
        acc = aux + g * g                                   # adagrad
        return torch.cat([emb - _div(lr * g, _sqrt(acc) + self.eps), acc], dim=1)
