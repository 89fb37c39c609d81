"""Dense (static-vocabulary) embedding: an ordinary learnable [vocab, dim]
matrix, the dictionary-semantic baseline (port of
``repro/embedding/dense.py``).

The functions take the table as a tensor (the LM keeps it in its parameter
tree as ``params["embed"]["table"]``); ``DenseEmbedding`` is the same
table as an ``nn.Module`` parameter.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.core.table import resolve_device


def init_table(vocab: int, dim: int, dtype: torch.dtype = torch.float32, *, device=None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A [vocab, dim] table drawn from N(0, 1/dim) with `generator`, on
    `device` (default: the card; raises without one; 'meta' draws nothing)."""
    device = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    gen = None if device.type == "meta" else generator
    w = torch.randn((vocab, dim), generator=gen, device=device) * (1.0 / math.sqrt(dim))
    return w.to(dtype)


def lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def attend(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied-softmax logits: x @ table.T."""
    return x @ table.T.to(x.dtype)


class DenseEmbedding(nn.Module):
    def __init__(self, vocab: int, dim: int, dtype: torch.dtype = torch.float32, *,
                 device=None, generator: Optional[torch.Generator] = None):
        """A [vocab, dim] table drawn from N(0, 1/dim) with `generator`, on
        `device` (default: the card; raises without one)."""
        super().__init__()
        self.vocab, self.dim = vocab, dim
        self.table = nn.Parameter(init_table(vocab, dim, dtype, device=device,
                                             generator=generator))

    def lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        return lookup(self.table, tokens)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return attend(self.table, x)
