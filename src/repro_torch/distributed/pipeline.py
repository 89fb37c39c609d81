"""GPipe-style pipeline parallelism over a mesh axis (port of
``repro/distributed/pipeline.py``).

Off by default (the production layout carries data parallelism over
pods), for deployments whose inter-pod link cannot carry a full-gradient
all-reduce: a pipeline across the slow axis moves only activations
(microbatch x d_model a hop).

Schedule: forward fill and drain, M microbatches over K stages (use
M / (M + K - 1)).  At every tick every stage computes on its input buffer,
and keeps the result only where it holds a live microbatch (the masked
work is kept, as in the reference: it is the schedule's cost); the last
stage writes microbatch t - (K - 1) to its output; then the stage buffers
rotate one place along the ring (the reference's ``ppermute``).

The port's mesh has one controller: stage i runs on the device of the
mesh position at index i of the axis (index 0 of every other axis), and
the ring hop copies a buffer to the next stage's device where the two
differ.  On one card the stages take their turns, so a run there measures
the schedule's work, not an overlap of stages.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree
from repro_torch.launch.mesh import Mesh


def _stage_devices(mesh: Mesh, axis: str) -> list:
    k = mesh.shape[axis]
    at = mesh.axis_names.index(axis)
    return [mesh.device_at([i if j == at else 0 for j in range(len(mesh.axis_names))])
            for i in range(k)]


def pipeline_apply(mesh: Mesh, axis: str, stage_fn: Callable, stage_params,
                   x_microbatches: torch.Tensor) -> torch.Tensor:
    """`stage_fn(params_slice, x) -> x` applied across the `axis` stages.

    stage_params: a tree whose leaves have a leading stage axis of
    ``mesh.shape[axis]``.  x_microbatches: [M, mb, ...], given to every
    stage.  Returns the output [M, mb, ...] on ``mesh.home``."""
    devices = _stage_devices(mesh, axis)
    k = len(devices)
    params = [tree.map(lambda a, i=i, d=d: a[i].to(d), stage_params)
              for i, d in enumerate(devices)]
    xs = [x_microbatches.to(d) for d in devices]
    m = x_microbatches.shape[0]
    bufs = [torch.zeros_like(x[0]) for x in xs]
    out = torch.zeros_like(xs[-1])
    for t in range(m + k - 1):
        ys = []
        for i in range(k):
            # stage 0 takes microbatch t; the others their buffer
            x_in = xs[i][min(max(t, 0), m - 1)] if i == 0 else bufs[i]
            active = 0 <= t - i < m
            y = stage_fn(params[i], x_in)
            y = y if active else x_in
            if active and i == k - 1:
                out[min(max(t - (k - 1), 0), m - 1)] = y
            ys.append(y)
        bufs = [ys[(i - 1) % k].to(devices[i]) for i in range(k)]
    # only the last stage holds the outputs; every position gets them (the
    # reference's masked psum), returned from the mesh's home device
    return out.to(mesh.home)
