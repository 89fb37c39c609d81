"""Lookups of Zipfian 64-bit keys over sparse fields of published sizes.

A batch is `batch` keys; lane i draws an id of field i mod
len(`field_sizes`) from the field's Zipf(`alpha`), as `field_zipf` does,
and its key is fmix64(id), so hot keys spread over the whole 64-bit key
space.  The prefill inserts the keys of the `prefill_load * capacity` ids
of highest probability (`draw.hottest`) in one seeded pseudo-random order
(`draw.shuffled`), with N(0, 1) rows of the table's dim, in batches of
`batch` padded with the all-ones key, which the table ignores.
"""

from __future__ import annotations

import torch

from hkvbench import draw


def keys_per_batch(mix: dict, config: dict) -> int:
    return mix["batch"]


def prefill(mix: dict, config: dict, seed: int, device: torch.device):
    sizes = mix["field_sizes"]
    counts = draw.hottest(sizes, mix["alpha"], int(mix["prefill_load"] * config["capacity"]))
    for i, j in enumerate(draw.shuffled(sum(counts), mix["batch"],
                                        draw.seed_of(seed, "prefill"), device)):
        ids = draw.hottest_ids(sizes, counts, j)
        keys = torch.where(ids < 0, -1, draw.fmix64(ids))
        g = draw.generator(device, seed, "prefill", i)
        yield {"keys": keys, "rows": torch.randn((keys.numel(), config["dim"]), generator=g,
                                                 device=device)}


def batch(mix: dict, config: dict, seed: int, index: int, device: torch.device) -> dict:
    g = draw.generator(device, seed, "batch", index)
    sizes = mix["field_sizes"]
    return {"keys": draw.fmix64(draw.field_ids(g, mix["batch"], sizes, mix["alpha"]))}
