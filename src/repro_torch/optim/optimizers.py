"""Dense-parameter optimizers for the backbone's weights (port of
``repro/optim/optimizers.py``).

(init, update) pairs over a parameter tree (``repro_torch.tree``), with
float32 state as in the reference:

  adamw      AdamW with bias correction and decoupled weight decay.
  adamw8bit  AdamW with block-wise int8 moments (absmax over blocks of 256
             of the flattened tensor, re-quantized after every update).
  adafactor  factored second moment (row and column means) for matrices.
  sgdm       momentum SGD.

`update(grads, state, params)` returns (updates, new state) without
touching its inputs; `apply_updates` adds the updates.  The step counter
is an int32 tensor on the parameters' device, so an update needs no host
read.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import tree


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]  # (grads, state, params) -> (updates, state)


def _device(params) -> torch.device:
    return tree.leaves(params)[0].device


def _count0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def _zeros_f32(params):
    return tree.map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA's and the card's.
    torch's vectorized float32 sqrt on the CPU is an ulp off on some
    inputs; the float64 root rounded to float32 is exact (53 >= 2*24 + 2)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def _split(out, n: int) -> list:
    """A tree whose leaves are n-tuples -> n trees."""
    is_leaf = lambda x: isinstance(x, tuple)  # noqa: E731 - parameter trees hold no tuples
    return [tree.map(lambda t, i=i: t[i], out, is_leaf=is_leaf) for i in range(n)]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        return {"mu": _zeros_f32(params), "nu": _zeros_f32(params), "count": _count0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        c = count.to(torch.float32)
        bc1 = 1.0 - b1 ** c
        bc2 = 1.0 - b2 ** c

        def upd(g, mu, nu, p):
            g = g.to(torch.float32)
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * g * g
            step = (mu / bc1) / (_sqrt(nu / bc2) + eps)
            step = step + weight_decay * p.to(torch.float32)
            return (-lr * step).to(p.dtype), mu, nu

        updates, mu, nu = _split(tree.map(upd, grads, state["mu"], state["nu"], params), 3)
        return updates, {"mu": mu, "nu": nu, "count": count}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# AdamW with int8 block-quantized moments
# ---------------------------------------------------------------------------

_QBLOCK = 256


def _quantize_i8(x: torch.Tensor):
    """Block-wise absmax int8 quantization over the flattened tensor."""
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % _QBLOCK))
    blocks = flat.reshape(-1, _QBLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize_i8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def adamw8bit(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        def qz(p):
            q, s = _quantize_i8(torch.zeros_like(p, dtype=torch.float32))
            return {"q": q, "s": s}

        return {"mu": tree.map(qz, params), "nu": tree.map(qz, params),
                "count": _count0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        c = count.to(torch.float32)
        bc1 = 1.0 - b1 ** c
        bc2 = 1.0 - b2 ** c

        def upd(g, mu_q, nu_q, p):
            g = g.to(torch.float32)
            mu = b1 * _dequantize_i8(mu_q["q"], mu_q["s"], p.shape) + (1 - b1) * g
            nu = b2 * _dequantize_i8(nu_q["q"], nu_q["s"], p.shape) + (1 - b2) * g * g
            step = (mu / bc1) / (_sqrt(nu / bc2) + eps)
            step = step + weight_decay * p.to(torch.float32)
            mq, ms = _quantize_i8(mu)
            nq, ns = _quantize_i8(nu)
            return (-lr * step).to(p.dtype), {"q": mq, "s": ms}, {"q": nq, "s": ns}

        updates, mu, nu = _split(tree.map(upd, grads, state["mu"], state["nu"], params), 3)
        return updates, {"mu": mu, "nu": nu, "count": count}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; no momentum)
# ---------------------------------------------------------------------------

def adafactor(lr=1e-3, decay=0.8, eps=1e-30) -> Optimizer:
    def init(params):
        def fz(p):
            if p.ndim >= 2:
                return {"vr": p.new_zeros(p.shape[:-1], dtype=torch.float32),
                        "vc": p.new_zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}

        return {"v": tree.map(fz, params), "count": _count0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        beta = 1.0 - count.to(torch.float32) ** (-decay)

        def upd(g, v, p):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if p.ndim >= 2:
                vr = beta * v["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * v["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = (vr[..., :, None] * vc[..., None, :]
                         / (vr.mean(dim=-1, keepdim=True)[..., None] + eps))
                step = g / (_sqrt(denom) + eps)
                nv = {"vr": vr, "vc": vc}
            else:
                nv = {"v": beta * v["v"] + (1 - beta) * g2}
                step = g / (_sqrt(nv["v"]) + eps)
            return (-lr * step).to(p.dtype), nv

        updates, v = _split(tree.map(upd, grads, state["v"], params), 2)
        return updates, {"v": v, "count": count}

    return Optimizer(init, update)


def sgdm(lr=1e-2, momentum=0.9) -> Optimizer:
    def init(params):
        return {"m": _zeros_f32(params)}

    @torch.no_grad()
    def update(grads, state, params):
        def upd(g, m, p):
            m = momentum * m + g.to(torch.float32)
            return (-lr * m).to(p.dtype), m

        updates, m = _split(tree.map(upd, grads, state["m"], params), 2)
        return updates, {"m": m}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    return tree.map(lambda p, u: p + u.to(p.dtype), params, updates)


OPTIMIZERS = {"adamw": adamw, "adamw8bit": adamw8bit, "adafactor": adafactor, "sgdm": sgdm}
