"""The benchmark's reference against the port's plain path on the CPU, at
tiny sizes, for each entry that a cell drives: `HKVTable.find`,
`HKVTable.insert_or_assign`, `HKVEmbedding.lookup_train` and
`HKVEmbedding.apply_grads` (and `ingest`, the training cells' prefill).
Integer planes and copied rows bit for bit; rows that rowwise_adagrad
computes within 1e-6 of their magnitude (the two sum a row's squares in
different orders)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hkvbench.reference import embedding as ref_emb
from hkvbench.reference.table import RefTable, pad
from repro_torch.embedding import HKVEmbedding, SparseOptimizer

CAP, DIM = 8 * 128, 4


def _emb(buckets: int) -> HKVEmbedding:
    return HKVEmbedding(capacity=CAP, dim=DIM, optimizer=SparseOptimizer("rowwise_adagrad", lr=0.01),
                        buckets_per_key=buckets, score_policy="lru")


def _pair(buckets: int):
    emb = _emb(buckets)
    return emb, emb.create(device="cpu"), RefTable(CAP, DIM + 1, buckets, torch.device("cpu"))


def _u64(keys: torch.Tensor) -> torch.Tensor:
    return keys.view(torch.uint64)


def _assert_planes(table, ref: RefTable, rtol: float = 0.0) -> None:
    st = table.state
    assert torch.equal(st.keys, ref.keys)
    assert torch.equal(st.digests, ref.digests)
    assert torch.equal(st.scores, ref.scores)
    if rtol:
        torch.testing.assert_close(st.values, ref.values, rtol=rtol, atol=rtol)
    else:
        assert torch.equal(st.values, ref.values)


@pytest.mark.parametrize("buckets", [1, 2])
def test_insert_or_assign_and_find_match_the_port(buckets):
    """Wide 64-bit keys (half of them above 2^63), duplicates, padding, a
    table driven past λ 1.0 so that lanes evict and are rejected."""
    emb, table, ref = _pair(buckets)
    g = torch.Generator().manual_seed(7)
    pool = torch.randint(-2**63, 2**63 - 1, (6000,), generator=g, dtype=torch.int64)
    statuses = set()
    for step in range(8):
        keys = pool[torch.randint(0, pool.numel(), (1500,), generator=g)]
        keys[::37] = -1                                      # padding lanes
        rows = torch.randn(1500, DIM, generator=g)
        got = table.insert_or_assign(_u64(keys), rows).status
        want = ref.upsert(keys, pad(rows, DIM + 1)).status
        assert torch.equal(got, want), step
        statuses |= set(want.tolist())
        q = pool[torch.randint(0, pool.numel(), (300,), generator=g)]
        out = table.find(_u64(q))
        found, vals, scores, _ = ref.find(q, DIM)
        assert torch.equal(out.found, found) and torch.equal(out.values, vals)
        assert torch.equal(out.scores, scores)
    assert {0, 1, 2, 3, 4} <= statuses
    _assert_planes(table, ref)


@pytest.mark.parametrize("buckets", [1, 2])
def test_training_steps_match_the_port(buckets):
    """ingest (the prefill), then lookup_train and apply_grads steps over
    Zipfian tokens of 2 fields: rows, statuses through the planes, and the
    optimizer column."""
    emb, table, ref = _pair(buckets)
    g = torch.Generator().manual_seed(11)
    pre = torch.randperm(700, generator=g)
    emb.ingest(table, pre)
    ref_emb.ingest(ref, pre, DIM)
    _assert_planes(table, ref)
    for step in range(6):
        ranks = (torch.rand(64, 2, generator=g) ** 3 * 2000).to(torch.int64)
        tokens = ranks + torch.tensor([0, 1 << 24])
        tokens[0, 0] = -1
        grads = torch.randn(64, 2, DIM, generator=g) * 1e-2
        table, rows = emb.lookup_train(table, tokens)
        want, _ = ref_emb.lookup_train(ref, tokens, DIM)
        torch.testing.assert_close(rows.reshape(-1, DIM), want, rtol=1e-6, atol=1e-6)
        table = emb.apply_grads(table, tokens, grads)
        ref_emb.apply_grads(ref, tokens, grads, DIM, lr=0.01, eps=1e-10)
    _assert_planes(table, ref, rtol=1e-6)


def test_default_rows_are_the_ports_bit_for_bit():
    keys = torch.from_numpy(np.arange(0, 2**31, 2**31 // 997, dtype=np.int64))
    assert torch.equal(_emb(2).default_rows(keys), ref_emb.default_rows(keys, DIM))


@pytest.mark.parametrize("kw", [{"score_policy": "lfu"}, {"score_policy": "epoch_lru"},
                                {"value_dtype": "bfloat16"}, {"value_dtype": "float16"}],
                         ids=lambda kw: "-".join(kw.values()))
def test_the_reference_refuses_what_it_does_not_model(kw):
    with pytest.raises(ValueError, match="hkvbench/reference/"):
        RefTable(CAP, DIM + 1, 2, torch.device("cpu"), **kw)
