"""The tier hierarchy's reference (`reference/tiered.py`) against the port's
plain path on the CPU, and the cell `tiered.train_zipf` end to end.

At tiny sizes (a hot tier of 2 buckets over a cold tier of 16, dim 4, one
and two buckets a key): the training step's rows, both tiers' four planes
and the promoted / demoted / dropped counts after every step, over seeds
chosen so that every kind of crossing happens.  Then the harness on the
shrunk cell: a sound run is correct, the bfloat16 control and two planted
faults (no demotion; promotion of init rows in place of cold rows) are
not, and the hot-hit share the program's counters give is the
reference's.  The byte count of the step against one worked by hand."""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from hkvbench import harness, roofline
from hkvbench.reference import embedding as ref_emb
from hkvbench.reference import tiered as ref_tiered
from hkvbench.reference.table import pad
from repro_torch.core import ops
from repro_torch.core.tiered import TieredHKVTable
from repro_torch.embedding import HKVEmbedding, SparseOptimizer

CPU = torch.device("cpu")
HOT, COLD, DIM = 2 * 128, 16 * 128, 4
EVENTS = ("promoted", "evicted", "rejected_pairs", "rejected_cold_hits", "cold_evicted",
          "cold_rejected")


def _pair(buckets: int):
    emb = HKVEmbedding(capacity=COLD, dim=DIM, hot_capacity=HOT, buckets_per_key=buckets,
                       optimizer=SparseOptimizer("rowwise_adagrad", lr=0.01), backend="plain")
    ref = ref_tiered.RefHierarchy(HOT, COLD, DIM + 1, buckets, CPU)
    return emb, emb.create(device="cpu"), ref


def _assert_tiers(table, ref, rtol: float = 1e-6) -> None:
    for tier in ("hot", "cold"):
        st, want = getattr(table.state, tier), getattr(ref, tier)
        for name in ("keys", "digests", "scores"):
            assert torch.equal(getattr(st, name), getattr(want, name)), (tier, name)
        torch.testing.assert_close(st.values, want.values, rtol=rtol, atol=rtol)


def _steps(g: torch.Generator):
    """Zipfian steps over two fields, padding in one lane, and one burst of
    never-seen ids that overfills the cold tier's buckets."""
    for step in range(7):
        tokens = (torch.rand(200, 2, generator=g) ** 3 * 3000).to(torch.int64)
        tokens += torch.tensor([0, 1 << 20])
        if step == 3:
            tokens = torch.arange(4000).reshape(2000, 2) + (1 << 24)
        tokens[0, 0] = -1
        yield tokens, torch.randn(tokens.shape + (DIM,), generator=g) * 1e-2


@pytest.mark.parametrize("buckets", [1, 2])
def test_training_steps_match_the_port_tier_by_tier(buckets):
    """ingest (the prefill) past the hot tier, then lookup_train and
    apply_grads: rows, planes and counts after every step."""
    emb, table, ref = _pair(buckets)
    g = torch.Generator().manual_seed(3)
    pre = torch.randperm(2500, generator=g)
    for i in range(0, 2500, 500):
        emb.ingest(table, pre[i:i + 500])
        ref_tiered.ingest(ref, pre[i:i + 500], DIM)
    _assert_tiers(table, ref, rtol=0.0)
    seen = dict.fromkeys(EVENTS, 0)
    for tokens, grads in _steps(g):
        keys = emb.keys_of(tokens)
        res = table.find_or_insert(keys, emb.default_rows(keys))     # lookup_train's op
        rows, c = ref_tiered.lookup_train(ref, tokens, DIM)
        torch.testing.assert_close(res.values, rows, rtol=1e-6, atol=1e-6)
        assert (int(res.promoted), int(res.demoted), int(res.dropped)) == (
            c["promoted"], c["demoted"], c["dropped"])
        table = emb.apply_grads(table, tokens, grads)
        ref_emb.apply_grads(ref.hot, tokens, grads, DIM, lr=0.01, eps=1e-10)
        _assert_tiers(table, ref)
        c["rejected_pairs"] = c["handed"] - c["evicted"]
        for e in EVENTS:
            seen[e] += c[e]
    assert all(seen.values()), seen


@pytest.mark.parametrize("kw", [{"score_policy": "lfu"}, {"cold_score_policy": "lru"},
                                {"value_dtype": "bfloat16"}, {"value_dtype": "float16"}],
                         ids=lambda kw: "-".join(kw.values()))
def test_the_reference_refuses_what_it_does_not_model(kw):
    with pytest.raises(ValueError, match="hkvbench/reference/"):
        ref_tiered.RefHierarchy(HOT, COLD, DIM + 1, 2, CPU, **kw)


def test_a_tier_refuses_other_score_policies():
    with pytest.raises(ValueError, match="hkvbench/reference/"):
        ref_tiered.Tier(HOT, DIM + 1, 2, CPU, "epoch_lru")


# -- the cell end to end, shrunk ---------------------------------------------------

TINY = {"capacity": COLD, "hot_capacity": HOT}
MIX = {"samples": 32, "prefill_batch": 256, "field_sizes": [900, 3, 40, 2500]}


def _tiny(warm: int) -> harness.Cell:
    c = harness.load_cell("tiered.train_zipf")
    return dataclasses.replace(
        c, config=dict(c.config, **TINY), mix={**c.mix, **MIX},
        work=dict(c.work, warmup_batches=warm, trace=dict(c.work["trace"], batches=2)))


def _run(traced: bool = False, warm: int = 2, **kw) -> dict:
    return harness.run_cell(_tiny(warm), 2**31 + 12345, 0.3, traced, CPU, time.perf_counter(),
                            **kw)


def test_a_sound_run_is_correct_and_reads_the_references_hot_hit_share(monkeypatch):
    runs = []

    class Kept(harness.Run):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            runs.append(self)

    monkeypatch.setattr(harness, "Run", Kept)
    r = _run(traced=True)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert {f"{t}_plane_{n}" for t in ("hot", "cold")
            for n in ("keys_mismatch", "digests_mismatch", "scores_mismatch", "values_gap")
            } | {"rows_gap"} == set(r["checks"])
    (run,) = runs
    c = [run.counts[i] for i in run.profiled]
    want = 100.0 * sum(x["hot_hit_lanes"] for x in c) / sum(x["valid_lanes"] for x in c)
    assert r["metrics"]["tier.hot_hit_rate"]["value"] == want
    assert 0 < want < 100


def test_the_bfloat16_control_is_not_correct():
    r = _run(value_dtype="bfloat16")
    assert not r["correct"]
    for tier in ("hot", "cold"):
        got = r["checks"][f"{tier}_plane_values_gap"]
        assert got["value"] > got["limit"]


def _no_demotion(monkeypatch):
    """The cold tier's insert_and_evict of the demotion batch a no-op."""
    real = TieredHKVTable._demote
    monkeypatch.setattr(TieredHKVTable, "_demote", lambda self, keys, values, scores, mask:
                        real(self, keys, values, scores, torch.zeros_like(mask)))


def _init_promotion(monkeypatch):
    """A cold hit promoted with its init row in place of its cold row."""
    real = ops.find_rows

    def find_rows(state, cfg, keys, *rest, **kw):
        r = real(state, cfg, keys, *rest, **kw)
        init = pad(ref_emb.default_rows(keys, cfg.dim), r.rows.shape[1]).to(r.rows.dtype)
        return r._replace(rows=torch.where(r.found[:, None], init, r.rows))

    monkeypatch.setattr(ops, "find_rows", find_rows)


@pytest.mark.parametrize("fault", [_no_demotion, _init_promotion], ids=lambda f: f.__name__[1:])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    """Enough warm-up steps that trained rows go down and come back up
    however short the window is (a promoted prefill row is its init row)."""
    fault(monkeypatch)
    assert not _run(warm=8)["correct"]


# -- the byte count ------------------------------------------------------------------

def test_the_tiered_step_counts_both_tiers_and_the_link():
    c = {"lanes": 10, "distinct": 8, "hits": 3, "hits_primary": 2, "admitted": 4,
         "miss_rows": 7, "resident": 7, "evicted": 2, "cold_probed": 5, "cold_hits": 3,
         "cold_hits_primary": 1, "handed": 4, "demote_hits": 1, "demote_hits_primary": 1,
         "demote_miss_rows": 3, "demote_admitted": 2, "demoted": 3}
    config = {"dim": 4, "width": 5, "buckets_per_key": 2, "value_tier": "hbm"}
    # the hot step (test_hkvbench_roofline's), its rows in HBM: tokens 80, gradient
    # rows 160, locate 14*128 + 24, hit scores 24, victim rows 7*128*16, admitted
    # metadata 4*17, rows out 160, hit rows read 3*20, resident rows written 7*20;
    # the 2 hot victims' rows 2*20; the cold probe of 5 keys: (5 + 4) lines * 128 +
    # 3 key words; the demotion of 4 pairs: (4 + 3) lines * 128 + 1 key word, the
    # hit's score 8, 3 candidate buckets * 128 * 16, 2 admitted * 17.  Over the
    # link: 3 cold rows read, 3 placed rows written.
    hot = 80 + 160 + 14 * 128 + 24 + 24 + 7 * 128 * 16 + 68 + 160 + 60 + 140
    want = hot + 40 + (9 * 128 + 24) + (7 * 128 + 8 + 8 + 3 * 128 * 16 + 34)
    got = roofline.model("tiered_step").least_bytes(c, config)
    assert got == {"hbm": want, "link_read": 60, "link_write": 60}
