"""Dense (static-vocabulary) embedding: an ordinary learnable [vocab, dim]
matrix, the dictionary-semantic baseline (port of
``repro/embedding/dense.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.core.table import resolve_device


class DenseEmbedding(nn.Module):
    def __init__(self, vocab: int, dim: int, dtype: torch.dtype = torch.float32, *,
                 device=None, generator: Optional[torch.Generator] = None):
        """A [vocab, dim] table drawn from N(0, 1/dim) with `generator`, on
        `device` (default: the card; raises without one)."""
        super().__init__()
        device = resolve_device(device)
        self.vocab, self.dim = vocab, dim
        w = torch.randn((vocab, dim), generator=generator, device=device) * (1.0 / math.sqrt(dim))
        self.table = nn.Parameter(w.to(dtype))

    def lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.table[tokens]

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-softmax logits: x @ table.T."""
        return x @ self.table.T.to(x.dtype)
