"""Device meshes for the sharded table (the port of ``repro/launch/mesh.py``).

A `Mesh` is a grid of torch devices with named axes, as a JAX mesh is a
grid of its devices.  A device may repeat: the reference's tests put eight
forced host devices on one CPU, and here eight mesh positions may share
one card.  The sharded table (``repro_torch.distributed``) keeps one shard
at each position, on that position's device; shards that share a device
exchange their keys by a plain stack, and shards on distinct devices by
copies between them.

    mesh = make_dev_mesh(2, 4)                 # ("data", "model"), all on the card
    mesh = make_dev_mesh(2, 4, device="cpu")   # the same on the CPU

`make_production_mesh` (the reference's TPU pod layouts) comes with the LM
train stack.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.table import resolve_device


def _canonical(device) -> torch.device:
    """A device with its index: a card given as "cuda" is the current
    card, so that positions compare equal to the devices of their tensors."""
    d = resolve_device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over a grid of devices (row-major, the first axis
    slowest).  ``devices`` is an object array of ``torch.device`` whose
    shape is the axes' sizes."""

    axis_names: tuple
    devices: np.ndarray

    def __post_init__(self):
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-dimensional device grid")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order (as a JAX mesh's ``shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    def device_at(self, coords: Sequence[int]) -> torch.device:
        return self.devices[tuple(coords)]

    @property
    def home(self) -> torch.device:
        """The first position's device: where a sharded op's global inputs
        and results live."""
        return self.devices.reshape(-1)[0]

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.reshape(-1)})
        return f"Mesh({self.shape}, devices={devs})"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], device=None) -> Mesh:
    """A mesh of `shape` named `axis_names`.  `device` is one device, which
    every position shares, or a sequence of one device a position in
    row-major order; ``None`` means the card (and raises without one)."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    if device is None or isinstance(device, (str, torch.device)):
        devs = [_canonical(device)] * n
    else:
        devs = [_canonical(d) for d in device]
        if len(devs) != n:
            raise ValueError(f"{len(devs)} devices for a mesh of {n} positions")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(axis_names=tuple(axis_names), devices=grid.reshape(shape))


def make_dev_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A ("data", "model") mesh.  `device`: one device for every position
    (default: the card), or one a position."""
    return make_mesh((data, model), ("data", "model"), device)


def data_axes(mesh: Mesh) -> tuple:
    """Axes carrying data parallelism (pod folds into DP when present)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh: Mesh) -> str:
    return "model"

