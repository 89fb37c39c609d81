"""Training steps over Zipfian sparse fields (the DLRM input of paper Fig. 1).

A step is `samples` x len(`field_sizes`) ids, one a field a sample.  Field
f holds `field_sizes[f]` ids after the fields before it (`draw.offsets`),
so the fields are disjoint and, for sizes that sum below 2^31, every id is
its own key.  Each draws its ranks from Zipf(`alpha`) over its own size.
Beside the ids a step carries their gradient rows, N(0, 1) * `grad_scale`,
as the model's backward pass would hand them over.

The prefill is the `prefill_load * capacity` ids that a draw gives the
highest probability (`draw.hottest`: each field's hottest ranks, the ideal
cache), in one seeded pseudo-random order (`draw.shuffled`), in batches of
`prefill_batch` padded with -1, the embedding's padding id.
"""

from __future__ import annotations

import torch

from hkvbench import draw


def keys_per_batch(mix: dict, config: dict) -> int:
    return mix["samples"] * len(mix["field_sizes"])


def prefill(mix: dict, config: dict, seed: int, device: torch.device):
    sizes = mix["field_sizes"]
    counts = draw.hottest(sizes, mix["alpha"], int(mix["prefill_load"] * config["capacity"]))
    for j in draw.shuffled(sum(counts), mix["prefill_batch"], draw.seed_of(seed, "prefill"),
                           device):
        yield {"tokens": draw.hottest_ids(sizes, counts, j)}


def batch(mix: dict, config: dict, seed: int, index: int, device: torch.device) -> dict:
    s, sizes = mix["samples"], mix["field_sizes"]
    g = draw.generator(device, seed, "batch", index)
    tokens = draw.field_ids(g, s * len(sizes), sizes, mix["alpha"]).view(s, len(sizes))
    grads = torch.randn((s, len(sizes), config["dim"]), generator=g, device=device) \
        * mix["grad_scale"]
    return {"tokens": tokens, "grads": grads}
