"""Train steps: the dense-embedding and the HKV-embedding variants (port of
``repro/train/step.py``).

The HKV step runs the paper's three roles in one step:

  inserter  `table.lookup(tokens, train=True)`: the find_or_insert of the
            token batch through the sharded table (the only structural op);
  readers   the forward pass consumes the rows;
  updater   the rows' gradients go back through `table.apply_grads` (the
            sparse optimizer's fused step, ``update_scan`` on the card).

`prefill_step` and `decode_step` are the model's serving calls (the
decode state changes in place, ``models/lm.py``).

The parameters' gradients are clipped to a global norm and applied by the
dense optimizer; the rows' gradients are not clipped, as in the reference.
A step returns new parameter and optimizer trees; the table changes in
place.  Each step's metrics hold, beside the loss, the time of its parts in
ms (CUDA events on the card, the host clock elsewhere): `lookup_ms`,
`fwd_bwd_ms`, `opt_ms` (clip and optimizer) and `apply_ms`.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import tree
from repro_torch.distributed import sharding as shard_rules
from repro_torch.models.lm import CompositeLM
from repro_torch.optim import Optimizer, apply_updates


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    gs = tree.leaves(grads)
    gn = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in gs))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree.map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), gn


class _Marks:
    """Marks between a step's parts, read once the step has run."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def ms(self, names) -> dict:
        if self.cuda:
            self.marks[-1].synchronize()
            spans = [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        else:
            spans = [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]
        return dict(zip(names, spans))


EXTRAS = ("frontend_embeds", "mrope_positions")


def _extras(batch: dict) -> dict:
    """The batch's model inputs beside tokens and labels (the vision
    frontend's embeddings, M-RoPE positions), as the reference passes them."""
    return {k: batch[k] for k in EXTRAS if k in batch}


def _grad_leaves(params):
    """The parameter tree on fresh leaves that require grad (no copy)."""
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    return tree.unflatten(params, leaves), leaves


@dataclasses.dataclass(frozen=True)
class StepBuilder:
    model: CompositeLM
    optimizer: Optimizer
    grad_clip: float = 1.0

    def _update(self, params, opt_state, grads):
        grads, gnorm = clip_by_global_norm(grads, self.grad_clip)
        updates, opt_state = self.optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, gnorm

    # ------------------------------------------------------------- dense path

    def train_step(self, params, opt_state, batch):
        """batch: {"tokens", "labels"} int [B, S] (+ frontend_embeds,
        mrope_positions)."""
        marks = _Marks(batch["tokens"].device)
        marks.mark()
        p, leaves = _grad_leaves(params)
        loss, aux = self.model.loss(p, batch["tokens"], batch["labels"], **_extras(batch))
        grads = torch.autograd.grad(loss, leaves)
        marks.mark()
        params, opt_state, gnorm = self._update(params, opt_state,
                                                tree.unflatten(params, list(grads)))
        marks.mark()
        metrics = {"loss": loss.detach(), "grad_norm": gnorm,
                   **{k: v.detach() for k, v in aux.items()},
                   **marks.ms(("fwd_bwd_ms", "opt_ms"))}
        return params, opt_state, metrics

    # --------------------------------------------------------------- hkv path

    def train_step_hkv(self, params, opt_state, table, batch):
        """The HKV step over a `ShardedHKVTable` (changed in place)."""
        tokens = batch["tokens"]
        marks = _Marks(tokens.device)
        marks.mark()
        # INSERTER: one structural op per step (admission-controlled)
        table, embeds, overflow = table.lookup(tokens, train=True)
        marks.mark()
        p, leaves = _grad_leaves(params)
        e = embeds.detach().requires_grad_()
        loss, aux = self.model.loss(p, None, batch["labels"], embeds=e, **_extras(batch))
        *grads, egrads = torch.autograd.grad(loss, leaves + [e])
        marks.mark()
        params, opt_state, gnorm = self._update(params, opt_state,
                                                tree.unflatten(params, grads))
        marks.mark()
        # UPDATER: the sparse optimizer's step on the batch's rows
        table = table.apply_grads(tokens, egrads)
        marks.mark()
        metrics = {"loss": loss.detach(), "grad_norm": gnorm, "emb_overflow": overflow,
                   **{k: v.detach() for k, v in aux.items()},
                   **marks.ms(("lookup_ms", "fwd_bwd_ms", "opt_ms", "apply_ms"))}
        return params, opt_state, table, metrics

    # ----------------------------------------------------------------- serve

    def prefill_step(self, params, tokens, max_len: int, **extras):
        return self.model.prefill(params, tokens, max_len, **extras)

    def decode_step(self, params, tokens, state):
        return self.model.decode_step(params, tokens, state)


def make_sharded_train_step(builder: StepBuilder, mesh, params_shape, hkv: bool):
    """The step for `mesh`.  The reference computes the parameters' and the
    batch's specs and jits the step over them; the port computes the same
    specs (so a tree the rules cannot cover raises here as it does there)
    and returns the builder's step: one controller runs it, and on one card
    every position holds its leaves whole (``distributed.sharding``).  With
    `hkv` the step is `train_step_hkv`, whose table is sharded over the
    mesh's axes (``ShardedHKVTable``)."""
    shard_rules.param_shardings(mesh, params_shape)
    shard_rules.NamedSharding(mesh, shard_rules.batch_spec(mesh))
    return builder.train_step_hkv if hkv else builder.train_step
