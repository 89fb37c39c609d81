"""Ingestion of never-seen 64-bit keys (streaming new ids).

Key c of a run is fmix64(c + salt), salt drawn from the seed: fmix64 is a
bijection, so no key repeats within a run.  The prefill takes counters 0
to `prefill_load * capacity` - 1, batch i of the window the next `batch` counters
after the prefill's and the batches before it.  Each key comes with an
N(0, 1) row of the table's dim.
"""

from __future__ import annotations

import torch

from hkvbench import draw


def keys_per_batch(mix: dict, config: dict) -> int:
    return mix["batch"]


def _prefill_keys(mix: dict, config: dict) -> int:
    return int(mix["prefill_load"] * config["capacity"])


def _keys(seed: int, first: int, n: int, device: torch.device) -> torch.Tensor:
    salt = draw.to_signed(draw.seed_of(seed, "salt"))
    return draw.fmix64(torch.arange(first, first + n, device=device) + salt)


def _rows(seed: int, stream: str, index: int, n: int, dim: int, device: torch.device):
    return torch.randn((n, dim), generator=draw.generator(device, seed, stream, index),
                       device=device)


def prefill(mix: dict, config: dict, seed: int, device: torch.device):
    b, n = mix["batch"], _prefill_keys(mix, config)
    for i, start in enumerate(range(0, n, b)):
        m = min(b, n - start)
        yield {"keys": _keys(seed, start, m, device),
               "rows": _rows(seed, "prefill", i, m, config["dim"], device)}


def batch(mix: dict, config: dict, seed: int, index: int, device: torch.device) -> dict:
    b = mix["batch"]
    return {"keys": _keys(seed, _prefill_keys(mix, config) + index * b, b, device),
            "rows": _rows(seed, "batch", index, b, config["dim"], device)}
