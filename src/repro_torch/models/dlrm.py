"""The DLRM-style recommender that the reference's continuous-training
example and its train-apply benchmark train (``examples/dlrm_continuous.py``,
``benchmarks/exp9_train_apply.py``; the two define the same model):

  bottom MLP   13 dense features -> 64 -> dim, ReLU between
  interaction  dot products of [z; the field rows], upper triangle (k=1)
  top MLP      dim + F(F+1)/2 -> 64 -> 1, ReLU between
  loss         mean logistic loss, max(l, 0) - l*y + log1p(exp(-|l|))

The embedding rows come from an ``HKVEmbedding``; the model takes them as
an input tensor, and its gradient with respect to them (``rows.grad``)
goes to ``apply_grads``, which updates the table: no backward pass reaches
the table.  The dense products are plain ``torch.matmul``/``einsum``, as
the reference leaves them to XLA.  Parameter names are the reference's
(``bottom1``, ``bottom2``, ``top1``, ``top2``), so its parameters load
through ``convert.dlrm_params_from_jax``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.core.table import resolve_device

HIDDEN = 64


class DLRM(nn.Module):
    def __init__(self, dim: int, num_sparse: int = 26, dense_features: int = 13, *,
                 device=None, generator: Optional[torch.Generator] = None):
        """Weights drawn from N(0, 1/fan_in) with `generator`, on `device`
        (default: the card; raises without one)."""
        super().__init__()
        device = resolve_device(device)
        self.dim, self.num_sparse = dim, num_sparse
        nf = num_sparse
        iu = torch.triu_indices(nf + 1, nf + 1, offset=1, device=device)
        self.register_buffer("iu", iu, persistent=False)

        def init(d_in, d_out):
            w = torch.randn((d_in, d_out), generator=generator, device=device)
            return nn.Parameter(w * (1.0 / math.sqrt(d_in)))

        self.bottom1 = init(dense_features, HIDDEN)
        self.bottom2 = init(HIDDEN, dim)
        self.top1 = init(dim + nf * (nf + 1) // 2, HIDDEN)
        self.top2 = init(HIDDEN, 1)

    def forward(self, emb_rows: torch.Tensor, dense_x: torch.Tensor) -> torch.Tensor:
        """emb_rows [B, F, dim], dense_x [B, 13] -> logits [B]."""
        z = torch.relu(dense_x @ self.bottom1) @ self.bottom2              # [B, dim]
        feats = torch.cat([z[:, None, :], emb_rows], dim=1)               # [B, F+1, dim]
        inter = torch.einsum("bnd,bmd->bnm", feats, feats)
        flat = inter[:, self.iu[0], self.iu[1]]                            # [B, F(F+1)/2]
        h = torch.cat([z, flat], dim=1)
        return (torch.relu(h @ self.top1) @ self.top2)[:, 0]

    def loss(self, emb_rows, dense_x, labels) -> torch.Tensor:
        logits = self(emb_rows, dense_x)
        return torch.mean(torch.clamp(logits, min=0) - logits * labels
                          + torch.log1p(torch.exp(-torch.abs(logits))))

    @torch.no_grad()
    def sgd_(self, lr: float) -> None:
        """p <- p - lr * grad for every parameter (the reference's dense
        update), then clear the gradients."""
        for p in self.parameters():
            p.sub_(lr * p.grad)
            p.grad = None
