"""The traffic's draws on the CPU: ids stay in their fields, the same
generator draws the same batch, and the prefill's split is the ideal
cache (the hottest ids of all fields together), checked by hand."""

from __future__ import annotations

import pytest
import torch

from hkvbench import draw

SIZES = [900, 3, 40, 2500]


def test_offsets_are_the_sizes_before():
    assert draw.offsets(SIZES) == [0, 900, 903, 943]


def test_field_ids_stay_in_their_field_and_repeat_by_seed():
    fields = torch.arange(19999) % 4
    a = draw.field_ids(draw.generator(torch.device("cpu"), 2**33 + 5, "batch", 3), 19999,
                       SIZES, 1.05)
    b = draw.field_ids(draw.generator(torch.device("cpu"), 2**33 + 5, "batch", 3), 19999,
                       SIZES, 1.05)
    assert torch.equal(a, b)
    lo = torch.tensor(draw.offsets(SIZES))[fields]
    assert bool(((a >= lo) & (a < lo + torch.tensor(SIZES)[fields])).all())
    assert int((a[fields == 1] == 900).sum()) > int((a[fields == 1] == 902).sum())
    # field 3's ranks follow its Zipf: rank 0 takes the inverse CDF's
    # first unit, (2^(1-a) - 1) / (2501^(1-a) - 1) of the draws
    want = (2.0 ** -0.05 - 1) / (2501.0 ** -0.05 - 1)
    assert abs(float((a[fields == 3] == 943).double().mean()) - want) < 0.02


@pytest.mark.parametrize("n", [1, 7, 500, 3443, 10**6])
def test_hottest_takes_the_ids_of_highest_probability(n):
    alpha = 1.05
    h = [((k + 1.0) ** (1 - alpha) - 1) / (1 - alpha) for k in SIZES]
    probs = sorted(((r + 1.0) ** -alpha / h[f] for f, k in enumerate(SIZES) for r in range(k)),
                   reverse=True)
    c = draw.hottest(SIZES, alpha, n)
    assert sum(c) == min(n, sum(SIZES)) and all(0 <= x <= k for x, k in zip(c, SIZES))
    if sum(c) < sum(SIZES):   # nothing left out is hotter than the least taken
        taken = min((c[f] + 0.0) ** -alpha / h[f] for f in range(4) if c[f])
        left = max((c[f] + 1.0) ** -alpha / h[f] for f in range(4) if c[f] < SIZES[f])
        assert left <= taken and taken >= probs[sum(c) - 1] - 1e-15


def test_hottest_ids_walk_the_fields_in_order():
    counts = [2, 3, 0, 1]
    j = torch.tensor([0, 1, 2, 3, 4, 5, -1])
    assert draw.hottest_ids(SIZES, counts, j).tolist() == [0, 1, 900, 901, 902, 943, -1]
