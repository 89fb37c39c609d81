"""Parameter and activation partition specs: the Megatron mapping, matched
on tree paths (port of ``repro/distributed/sharding.py``).

Column-parallel into the block, row-parallel out (one logical all-reduce
per block):

  embed table [V, d]          -> (model, None)        vocab-parallel
  head        [d, V]          -> (None, model)
  wq/wk/wv    [d, H*hd]       -> (None, model)        heads sharded
  wo          [H*hd, d]       -> (model, None)
  ffn_wi      [d, ff]         -> (None, model)
  ffn_wo      [ff, d]         -> (model, None)
  moe wi/wo   [E, ., .]       -> (model, None, None)  expert-parallel
  ssm in/up   [d, proj]       -> (None, model)
  ssm out/down[proj, d]       -> (model, None)
  norms/bias/vectors          -> replicated

Stacked layer dims (repeats, count) prepend None.  Batch inputs shard over
the data-parallel axes (pod folds into data); vocab, MoE and tensor
parallelism all live on "model".

The rules are data: a spec says which mesh axes split each dim of a leaf.
What placement a spec implies is the caller's: on a mesh whose positions
share one device (``launch.mesh``) every position holds the whole leaf,
so placing by spec is the identity there, and `param_shardings` only pairs
each spec with its mesh.  The dry run (``launch.dryrun``) reads the specs
to count each device's bytes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch import tree
from repro_torch.core.table import HKVState
from repro_torch.launch.mesh import Mesh


class PartitionSpec:
    """The mesh axes that split each dim of an array: per dim an axis name,
    a tuple of axis names (split over their product, the first slowest), or
    ``None`` (not split).  Trailing dims left out are not split.  A tuple of
    one name is that name, as in JAX; iterating gives the entries, so
    ``tuple(spec)`` equals ``tuple(jax_spec)`` for the same layout.  A spec
    is a leaf of a tree (``repro_torch.tree``), not a node."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        norm = []
        for p in parts:
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                p = p[0] if len(p) == 1 else (p or None)
            norm.append(p)
        object.__setattr__(self, "parts", tuple(norm))

    def __setattr__(self, name, value):
        raise AttributeError("a PartitionSpec is immutable")

    def __iter__(self):
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self.parts == other.parts
        return NotImplemented

    def __hash__(self) -> int:
        return hash(("PartitionSpec", self.parts))

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(map(repr, self.parts))})"

    def axes(self) -> tuple:
        """Every mesh axis the spec names, in order."""
        out = []
        for p in self.parts:
            out.extend(p if isinstance(p, tuple) else () if p is None else (p,))
        return tuple(out)


P = PartitionSpec


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``):
    refused, as there, where the spec names an axis the mesh lacks or one
    axis twice."""

    mesh: Mesh
    spec: PartitionSpec

    def __post_init__(self):
        axes = self.spec.axes()
        missing = [a for a in axes if a not in self.mesh.axis_names]
        if missing:
            raise ValueError(f"{self.spec} names axes {missing} that {self.mesh} lacks")
        if len(set(axes)) != len(axes):
            raise ValueError(f"{self.spec} names an axis twice")


_RULES = {
    # leaf name -> base spec (without leading stack dims)
    "table": ("model", None),
    "head": (None, "model"),
    "wq": (None, "model"),
    "wk": (None, "model"),
    "wv": (None, "model"),
    "bq": ("model",),
    "bk": ("model",),
    "bv": ("model",),
    "wo": ("model", None),
    "ffn_wi": (None, "model"),
    "ffn_wo": ("model", None),
    "router": (None, None),
    "wi": ("model", None, None),     # MoE experts
    "in_proj": (None, "model"),
    "out_proj": ("model", None),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "out_norm": ("model",),
    "up": (None, "model"),
    "down": ("model", None),
    "wgate": ("model", None),
    "wx": (None, "model"),
    "out": ("model", None),
    "r": (None, None, None),
}
# MoE wo [E, ff, d] has attention's name "wo"; the "moe" key tells it apart.
_MOE_WO = ("model", None, None)
# The production mesh's |data| = |model| = 16: a named axis on a dim it
# does not divide would be refused, so such a dim stays whole.
_DIVISOR = 16


def _leaf_name(path) -> str:
    """The last dict key on the path (a sequence index is not a name)."""
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def spec_for(path, leaf, fsdp: bool = True) -> PartitionSpec:
    """The spec of the parameter at `path` (a tuple of dict keys and
    sequence indices, ``tree.leaves_with_path``) of `leaf`'s shape."""
    name = _leaf_name(path)
    in_moe = any(e == "moe" for e in path if isinstance(e, str))
    base = _RULES.get(name)
    if name == "wo" and in_moe:
        base = _MOE_WO
    if name == "wi" and not in_moe:
        base = None
    if base is None:
        return P()  # replicated (norms, scalars, A_log, D, ...)
    extra = leaf.ndim - len(base)
    if extra < 0:
        return P()
    base = list(base)
    # divisibility guard: a dim the production mesh's axis does not divide
    # (e.g. mLSTM's block-diagonal [G, 4, 4] projections) stays whole
    for i, b in enumerate(base):
        if b is not None and leaf.shape[extra + i] % _DIVISOR != 0:
            base[i] = None
    # FSDP: one free dim of every >= 2-D weight also splits over "data"
    # (ZeRO-3: parameters gather a layer at a time).  The embedding table and
    # the LM head are exempt: their free dim feeds the vocab-parallel gather
    # and psum, and replicating d there costs only vocab * d / |model|.
    if fsdp and name not in ("table", "head") and leaf.ndim >= 2:
        for i, b in enumerate(base):
            if b is None and leaf.shape[extra + i] % _DIVISOR == 0:
                base[i] = "data"
                break
    return P(*((None,) * extra + tuple(base)))


def param_specs(params, fsdp: bool = True):
    """A tree of specs in `params`' structure (works on 'meta' leaves)."""
    return tree.map_with_path(lambda p, x: spec_for(p, x, fsdp), params)


def param_shardings(mesh: Mesh, params):
    """Each parameter's spec on `mesh`.  The port's mesh runs one controller
    over positions that may share a device; a tensor is placed whole on its
    device, so on one card this placement is the identity."""
    return tree.map(lambda s: NamedSharding(mesh, s), param_specs(params), is_leaf=is_spec)


def batch_spec(mesh: Mesh) -> PartitionSpec:
    """Token batches: split over every data-parallel axis."""
    dp = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    return P(dp, None)


def maybe_constrain(x, *spec):
    """The reference pins an activation's layout under an ambient mesh
    (``with_sharding_constraint``) and passes it through outside one.  A
    torch program has no ambient mesh, so this is the identity."""
    return x


def table_specs(state=None) -> HKVState:
    """HKV table state: buckets split over 'model', clock and epoch
    replicated (the replicated-over-data layout; the all-to-all layout,
    ``ShardedHKVEmbedding.state_specs``, splits over every axis).  The port's
    64-bit key and score planes stand for the reference's hi/lo halves."""
    return HKVState(keys=P("model", None), digests=P("model", None), scores=P("model", None),
                    values=P("model", None), clock=P(), epoch=P())


def decode_state_specs(mesh: Mesh, state_shapes, kv_heads_divisible: bool):
    """KV caches split heads over model where the heads divide, else the
    sequence dim (decode sequence parallelism).  Recurrent states split the
    batch over data and heads or channels over model."""

    def spec(path, leaf):
        name = _leaf_name(path)
        if name in ("k", "v"):      # [stack..., B, S, Hkv, dh] KV cache
            lead = leaf.ndim - 4
            if kv_heads_divisible:
                return P(*((None,) * lead), "data", None, "model", None)
            return P(*((None,) * lead), "data", "model", None, None)
        if name == "gla":           # [stack..., B, H, N, P]: split the state
            # dim N (at least the model axis: 64 for mamba2, 1024 for mLSTM)
            # rather than heads (xLSTM has 4)
            lead = leaf.ndim - 4
            return P(*((None,) * lead), "data", None, "model", None)
        if name == "conv":          # [stack..., B, W, d_inner]
            lead = leaf.ndim - 3
            return P(*((None,) * lead), "data", None, "model")
        if name in ("c", "n", "h", "m"):  # sLSTM [stack..., B, H, pd]
            lead = leaf.ndim - 3
            return P(*((None,) * lead), "data", None, "model")
        if name == "pos":
            return P()
        if leaf.ndim >= 1:
            return P(*((None,) * leaf.ndim))
        return P()

    return tree.map_with_path(spec, state_shapes)


def shard_shape(shape, spec: PartitionSpec, mesh_shape: dict) -> tuple:
    """The shape one position holds: each dim split over the product of
    its axes' sizes, rounded up (a shard is padded to equal size)."""
    out = list(shape)
    for i, p in enumerate(spec):
        names = p if isinstance(p, tuple) else () if p is None else (p,)
        n = math.prod(mesh_shape[a] for a in names)
        out[i] = -(-out[i] // n)
    return tuple(out)


def bytes_per_device(leaves_and_specs, mesh_shape: dict) -> int:
    """The bytes one position holds of (shape, itemsize, spec) leaves."""
    return sum(math.prod(shard_shape(shape, spec, mesh_shape)) * itemsize
               for shape, itemsize, spec in leaves_and_specs)


def leaf_entries(leaves: Any, specs: Any) -> list:
    """(shape, itemsize, spec) of each tensor leaf of `leaves` beside the
    spec tree `specs` of the same structure."""
    xs = tree.leaves(leaves)
    ss = tree.leaves(specs, is_leaf=is_spec)
    if len(xs) != len(ss):
        raise ValueError(f"{len(xs)} leaves against {len(ss)} specs")
    return [(tuple(x.shape), x.element_size(), s) for x, s in zip(xs, ss)]
