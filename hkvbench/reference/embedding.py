"""The plain reference of the embedding's training step over `RefTable`.

  keys_of       a token id is its low 32 bits; a negative id is padding;
  default_rows  a key's init row: counter-mode fmix32 bits of its primary
                hash, uniform in ±1/sqrt(dim);
  lookup_train  find_or_insert of the tokens with their init rows (plus a
                zero optimizer column): the stored row of every key present
                after the op, the init row where admission rejected it;
  apply_grads   the gradients summed per distinct token; each resident
                key's row takes one rowwise_adagrad step, its last column
                the running mean of squared gradients.
"""

from __future__ import annotations

import torch

from hkvbench.reference.table import EMPTY, M32, RefTable, fmix32, hash_pair, pad, readback


def keys_of(tokens: torch.Tensor) -> torch.Tensor:
    t = tokens.reshape(-1).to(torch.int64)
    return torch.where(t < 0, EMPTY, t & M32)


def default_rows(keys: torch.Tensor, dim: int) -> torch.Tensor:
    h1, _ = hash_pair(keys)
    cols = torch.arange(dim, dtype=torch.int64, device=keys.device)
    salt = ((cols * 0x9E3779B9) & M32) ^ 0x85EBCA6B
    uniform = fmix32(h1[:, None] ^ salt[None, :]).to(torch.float32) * (1.0 / 4294967296.0)
    return (uniform - 0.5) * float(2.0 / dim ** 0.5)


def ingest(table: RefTable, tokens: torch.Tensor, dim: int):
    keys = keys_of(tokens)
    return table.upsert(keys, pad(default_rows(keys, dim), table.values.shape[1]),
                        write_hits=False)


def lookup_train(table: RefTable, tokens: torch.Tensor, dim: int):
    """(rows [N, dim], the upsert's record)."""
    keys = keys_of(tokens)
    init = default_rows(keys, dim)
    res = table.upsert(keys, pad(init, table.values.shape[1]), write_hits=False)
    return readback(table, res, init, dim), res


def apply_grads(table: RefTable, tokens: torch.Tensor, grads: torch.Tensor, dim: int,
                lr: float, eps: float) -> dict:
    """One rowwise_adagrad step on the rows of the batch's resident keys."""
    keys = keys_of(tokens)
    g = grads.reshape(-1, dim).float()
    uk, inv = torch.unique(keys, return_inverse=True)
    sums = torch.zeros((uk.numel(), dim), dtype=torch.float32, device=g.device)
    sums.index_add_(0, inv, g)
    found, _, bucket, slot = table.locate(uk)
    rows = (bucket * table.slots + slot)[found]
    g = sums[found]
    old = table.values[rows]
    acc = old[:, dim] + (g * g).sum(dim=1) / dim
    step = lr / (torch.sqrt(acc) + eps)
    table.values[rows] = torch.cat([old[:, :dim] - step[:, None] * g, acc[:, None]], dim=1)
    return {"resident": int(found.sum())}
