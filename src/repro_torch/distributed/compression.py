"""Gradient compression for the data-parallel all-reduce, with error
feedback (port of ``repro/distributed/compression.py``).

int8 block-quantized exchange: each position quantizes its local gradient
against a block scale shared through a max over the positions, the wire
carries int8 payloads, and the sum is taken after the gather in int32.
The quantization residual is fed back into the next step's gradient
(error feedback keeps SGD's convergence).  An all-gather moves N x world
x 1 B where a float32 ring all-reduce moves 2 x N x 4 B.

The port's mesh (``launch.mesh``) has one controller and no process group,
so a collective over a mesh axis acts on the list of that axis's
positions: the functions here take one array (or gradient tree) a
position, each on its position's device, and return one a position.  The
max of the scales and the all-gather are a stack on each distinct device
(copies between devices where the positions are on several); positions
that share a device share that device's result tensor, as the replicated
result of a collective.

Arithmetic is the reference's source, in IEEE float32: blocks of 256, the
scale max|x| / 127 + 1e-12, rounding half to even, a clip to +-127, an
int32 sum, and ``ef_compress_grads``' division by the world size.  The
constants are 0-dim tensors on the data's device, so the card divides as
the CPU does (a CPU scalar divisor becomes a multiplication by its
reciprocal on the card).
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import tree

_BLOCK = 256


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _block_view(x: torch.Tensor):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % _BLOCK
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, _BLOCK), flat.shape[0]


def _per_device(devices: list, fn) -> list:
    """[fn(d) for d in devices], computed once per distinct device."""
    memo = {}
    for d in devices:
        if d not in memo:
            memo[d] = fn(d)
    return [memo[d] for d in devices]


def _gather(xs: list, d: torch.device) -> torch.Tensor:
    """The all-gather's result on device `d`: the positions' arrays stacked
    in position order (copied to `d` where they lie elsewhere)."""
    return torch.stack([x.to(d, non_blocking=True) for x in xs])


def _scales(blocks: list, devices: list) -> list:
    """Each position's shared block scale: the max over the positions of
    each block's max |x|, / 127, + 1e-12."""
    local = [b.abs().amax(dim=1) for b in blocks]

    def scale(d):
        m = _gather(local, d).amax(dim=0)
        return m / _const(127.0, m) + _const(1e-12, m)

    return _per_device(devices, scale)


def _quantize(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(torch.int8)


def _exchange(qs: list, devices: list) -> list:
    """The int8 all-gather and its int32 sum, on each position's device."""
    return _per_device(devices, lambda d: _gather(qs, d).to(torch.int32).sum(0, dtype=torch.int32))


def compressed_psum(xs: Sequence[torch.Tensor]) -> list:
    """The int8 substitute for a sum over the positions: `xs[i]` is
    position i's array (one shape), on its device; returns each position's
    sum, on its device.  The scales are shared before quantizing, so every
    position quantizes against the same grid; the int32 sum is exact
    (world x 127 < 2^24)."""
    xs = list(xs)
    devices = [x.device for x in xs]
    views = [_block_view(x) for x in xs]
    n = views[0][1]
    blocks = [b for b, _ in views]
    scales = _scales(blocks, devices)
    qs = [_quantize(b, s) for b, s in zip(blocks, scales)]
    sums = _exchange(qs, devices)
    out = {}
    for d, s, sc in zip(devices, sums, scales):
        if d not in out:
            out[d] = (s.to(torch.float32) * sc[:, None]).reshape(-1)[:n].reshape(xs[0].shape)
    return [out[d] for d in devices]


def ef_compress_grads(grads: Sequence, errors: Sequence) -> tuple[list, list]:
    """Error feedback around the compressed exchange: `grads[i]` and
    `errors[i]` are position i's gradient tree and carried error (float32,
    the same structure).  Each leaf adds its error, is quantized and
    exchanged, and the sum is divided by the world size; the new error is
    the local residual.  Returns (each position's synced gradients in the
    gradients' dtype, each position's new errors)."""
    grads, errors = list(grads), list(errors)
    devices = [tree.leaves(g)[0].device for g in grads]
    world = len(grads)
    leaves_g = [tree.leaves(g) for g in grads]
    leaves_e = [tree.leaves(e) for e in errors]
    synced = [[] for _ in grads]
    new_err = [[] for _ in grads]
    for j in range(len(leaves_g[0])):
        gs = [lg[j] for lg in leaves_g]
        g32 = [g.to(torch.float32) + le[j] for g, le in zip(gs, leaves_e)]
        views = [_block_view(g) for g in g32]
        n = views[0][1]
        blocks = [b for b, _ in views]
        scales = _scales(blocks, devices)
        qs = [_quantize(b, s) for b, s in zip(blocks, scales)]
        for i, (q, s, g, x) in enumerate(zip(qs, scales, gs, g32)):
            deq = (q.to(torch.float32) * s[:, None]).reshape(-1)[:n].reshape(g.shape)
            new_err[i].append(x - deq)
        sums = _exchange(qs, devices)
        out = {}
        for i, (d, s, sc, g) in enumerate(zip(devices, sums, scales, gs)):
            if d not in out:
                mean = (s.to(torch.float32) * sc[:, None]).reshape(-1)[:n].reshape(g.shape)
                out[d] = (mean / _const(float(world), mean)).to(g.dtype)
            synced[i].append(out[d])
    return ([tree.unflatten(g, s) for g, s in zip(grads, synced)],
            [tree.unflatten(g, e) for g, e in zip(grads, new_err)])


def init_error_state(params):
    """Zero carried error, float32, in `params`' structure and devices."""
    return tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
