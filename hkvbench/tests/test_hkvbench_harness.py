"""The harness end to end on the CPU at a tiny size, the chip's look
skipped: each cell's files, shrunk to 8 buckets, run with the port's plain
path.  A sound run comes out correct; the control (bfloat16 value planes)
and each fault that a cell can have, planted in the program under the
harness, come out not correct."""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from hkvbench import harness
from repro_torch.core.api import HKVTable
from repro_torch.embedding import HKVEmbedding

CPU = torch.device("cpu")
TINY = {"capacity": 8 * 128}
MIX = {"samples": 32, "prefill_batch": 256, "batch": 256, "field_sizes": [900, 3, 40, 2500]}
CELLS = ("hkv_b.find_zipf", "hkv_b.ingest_fresh", "hkv_b.train_zipf", "hkv_d.train_zipf")


def tiny(name: str) -> harness.Cell:
    c = harness.load_cell(name)
    return dataclasses.replace(
        c, config=dict(c.config, **TINY),
        mix={**c.mix, **{k: v for k, v in MIX.items() if k in c.mix}},
        work=dict(c.work, trace=dict(c.work["trace"], batches=2)))


def run(name: str, traced: bool = False, **kw) -> dict:
    return harness.run_cell(tiny(name), 2**31 + 12345, 0.15, traced, CPU, time.perf_counter(), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    r = run(name, traced=name.endswith("train_zipf"))
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS[:3])
def test_the_bfloat16_control_is_not_correct(name):
    r = run(name, value_dtype="bfloat16")
    assert not r["correct"]
    assert r["checks"]["plane_values_gap"]["value"] > r["checks"]["plane_values_gap"]["limit"]


def _unchanged(monkeypatch, name):
    """A call that leaves the table as it was."""
    if name.endswith("train_zipf"):
        monkeypatch.setattr(HKVEmbedding, "apply_grads", lambda self, table, tokens, grads: table)
    else:
        real = HKVTable.insert_or_assign
        monkeypatch.setattr(HKVTable, "insert_or_assign",
                            lambda self, keys, values: real(self.snapshot(), keys, values))


def _half(monkeypatch, name):
    """Half of the batch left out."""
    if name.endswith("train_zipf"):
        real = HKVEmbedding.apply_grads

        def apply(self, table, tokens, grads):
            n = tokens.shape[0] // 2
            return real(self, table, tokens[:n], grads[:n])

        monkeypatch.setattr(HKVEmbedding, "apply_grads", apply)
        return
    op = "find" if name.endswith("find_zipf") else "insert_or_assign"
    real = getattr(HKVTable, op)

    def half(self, keys, *rest):
        keys = keys.clone()
        keys[keys.numel() // 2:] = -1
        return real(self, keys, *rest)

    monkeypatch.setattr(HKVTable, op, half)


def _altered(monkeypatch, name):
    """One answer altered where it is produced."""
    if name.endswith("train_zipf"):
        real = HKVEmbedding.lookup_train

        def lookup(self, table, tokens):
            table, rows = real(self, table, tokens)
            rows.view(-1)[3] += 0.25
            return table, rows

        monkeypatch.setattr(HKVEmbedding, "lookup_train", lookup)
    elif name.endswith("find_zipf"):
        real = HKVTable.find

        def find(self, keys):
            out = real(self, keys)
            out.values[out.found.nonzero()[0, 0], 0] += 0.25
            return out

        monkeypatch.setattr(HKVTable, "find", find)
    else:
        real = HKVTable.insert_or_assign

        def upsert(self, keys, values):
            res = real(self, keys, values)
            res.status[5] = 1 + res.status[5] % 4
            return res

        monkeypatch.setattr(HKVTable, "insert_or_assign", upsert)


FAULTS = [(c, f) for c in CELLS[:3] for f in (_unchanged, _half, _altered)
          if not (c.endswith("find_zipf") and f is _unchanged)]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_planted_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch, name)
    assert not run(name)["correct"]


@pytest.mark.parametrize("name,traced,present,absent", [
    ("hkv_b.find_zipf", False, "kv_per_s", "batch_ms_p95"),
    ("hkv_b.find_zipf", True, "find.batch_ms_p95", "batch_ms_p95"),
    ("hkv_b.ingest_fresh", False, "batch_ms_p95", "find.batch_ms_p95"),
])
def test_a_run_reports_the_metrics_its_cell_names(name, traced, present, absent):
    metrics = run(name, traced=traced)["metrics"]
    assert metrics[present]["value"] > 0 and absent not in metrics
