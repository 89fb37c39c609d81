"""``tests/test_differential_fuzz.py`` on the port: random op sequences
against the port's sequential oracle (``repro_torch.core.oracle``).

Mixed op sequences (insert_or_assign, find, find_rows, find_or_insert, a
session read mix, assign, update_rows through a session, accum_or_assign,
erase, erase_if, evict_if, clear), with repeated keys, EMPTY padding, wide
keys (the high 32 bits) and the caller key forms (numpy uint64, signed
int64 with negative-as-padding, Python lists), replay against
`OracleTable`.  After every op the drained table (keys, values, scores)
must equal the oracle's entries exactly.  The oracle is the spec.

Drivers: a seeded replay that always runs (on the CPU, and on the card
with backend 'auto' where there is one: marked `cuda`), the hypothesis
state machine where hypothesis is installed, and the replay with a
`TelemetrySink` on one of two twin tables, whose results and states must
stay bit-identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import HKVTable, RowUpdate, SweepPredicate  # noqa: E402
from repro_torch.core.oracle import OracleTable  # noqa: E402
from repro_torch.embedding.sparse_opt import SparseOptimizer  # noqa: E402
from repro_torch.obs import TelemetrySink  # noqa: E402

try:
    from hypothesis import settings
    from hypothesis import strategies as st
    from hypothesis.stateful import RuleBasedStateMachine, invariant, rule

    HAVE_HYPOTHESIS = True
except ImportError:       # pragma: no cover - the card's machine has it
    HAVE_HYPOTHESIS = False

CAP = 2 * 128
DIM = 4
LANES = 16
EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
POLICY = "lru"
DUAL = 2
_OPT = SparseOptimizer("sgd", lr=0.5)   # exact in float32 on the integer pools
EVICT_BUDGET = 8


def _np(x):
    return x.cpu().numpy()


def _u64(x):
    return _np(x).view(np.uint64)


class DifferentialHarness:
    """One table and oracle; each op asserts result parity, `check_state`
    full-contents parity (keys, values, scores)."""

    def __init__(self, device="cpu", backend="auto"):
        self.table = HKVTable.create(capacity=CAP, dim=DIM, buckets_per_key=DUAL,
                                     score_policy=POLICY, device=device, backend=backend)
        self.oracle = OracleTable(CAP, DIM, buckets_per_key=DUAL, policy=POLICY)

    def _rows(self, v):
        return torch.as_tensor(np.asarray(v, np.float32), device=self.table.device)

    def upsert(self, canonical, caller, v):
        status = self.table.insert_or_assign(caller, self._rows(v)).status
        want = self.oracle.insert_or_assign(canonical, v)
        assert np.array_equal(_np(status), np.asarray(want, np.int8))

    def find_or_insert(self, canonical, caller, v):
        r = self.table.find_or_insert(caller, self._rows(v))
        want_st, want_vals = self.oracle.find_or_insert(canonical, v)
        assert np.array_equal(_np(r.status), np.asarray(want_st, np.int8))
        assert np.array_equal(_np(r.found), np.asarray(want_st, np.int8) == 1)
        assert np.array_equal(_np(r.values), want_vals.astype(np.float32))

    def find(self, canonical, caller):
        r = self.table.find(caller)
        want_found, want_vals = self.oracle.find(canonical)
        assert np.array_equal(_np(r.found), want_found)
        assert np.array_equal(_np(r.values), want_vals.astype(np.float32))

    def _lane_scores(self, canonical):
        entries = {k: int(e.score) for k, e in self.oracle.items()}
        return np.array([entries.get(int(k), 0) for k in canonical], np.uint64)

    def find_rows(self, canonical, caller):
        r = self.table.find_rows(caller)
        want_found, want_vals = self.oracle.find(canonical)
        assert np.array_equal(_np(r.found), want_found)
        assert np.array_equal(_np(r.rows)[:, :DIM], want_vals.astype(np.float32))
        assert np.array_equal(_u64(r.scores), self._lane_scores(canonical)), "find_rows scores"

    def session_read(self, canonical, caller, v):
        s = self.table.session()
        f = s.find(caller)
        s.assign(caller, self._rows(v))
        r = s.find_rows(caller)
        c = s.contains(caller)
        s.commit()
        # find -> assign -> find_rows/contains: the first read sees the rows
        # before the assign, the second the assigned ones
        want_found, want_vals = self.oracle.find(canonical)
        assert np.array_equal(_np(f.get().found), want_found)
        assert np.array_equal(_np(f.get().values), want_vals.astype(np.float32))
        self.oracle.assign(canonical, v)
        want_found2, want_vals2 = self.oracle.find(canonical)
        assert np.array_equal(_np(c.get()), want_found2)
        assert np.array_equal(_np(r.get().rows)[:, :DIM], want_vals2.astype(np.float32))
        assert np.array_equal(_u64(r.get().scores), self._lane_scores(canonical))

    def assign(self, canonical, caller, v):
        self.table.assign(caller, self._rows(v))
        self.oracle.assign(canonical, v)

    def update_rows(self, canonical, caller, g):
        """The structured gradient step; live lanes unique (the
        apply_grads precondition)."""
        s = self.table.session()
        r = s.update_rows(caller, RowUpdate(_OPT, self._rows(g)))
        s.commit()
        want_found, want_vals = self.oracle.find(canonical)
        assert np.array_equal(_np(r.get().found), want_found), "update_rows found"
        self.oracle.assign(canonical, want_vals.astype(np.float32)
                           - 0.5 * np.asarray(g, np.float32))

    def accum(self, canonical, caller, v):
        status = self.table.accum_or_assign(caller, self._rows(v)).status
        want = self.oracle.accum_or_assign(canonical, v)
        assert np.array_equal(_np(status), np.asarray(want, np.int8))

    def erase(self, canonical, caller):
        self.table.erase(caller)
        self.oracle.erase(canonical)

    def clear(self):
        self.table.clear()
        self.oracle.clear()

    @staticmethod
    def _pred(kind, a, b):
        if kind == "always":
            return SweepPredicate.always()
        if kind == "score_lt":
            return SweepPredicate.score_below(a)
        if kind == "score_ge":
            return SweepPredicate.score_at_least(a)
        if kind == "epoch_lt":
            return SweepPredicate.expire_before(a >> 32)
        return SweepPredicate.key_in_range(a, b)

    def erase_if(self, kind, a=0, b=0):
        swept = self.table.erase_if(self._pred(kind, a, b)).swept
        assert int(swept) == self.oracle.erase_if(kind, a, b), f"erase_if({kind}) count"

    def evict_if(self, kind, a=0, b=0):
        r = self.table.evict_if(self._pred(kind, a, b), EVICT_BUDGET)
        want = self.oracle.evict_if(kind, EVICT_BUDGET, a, b)
        assert int(r.count) == len(want), f"evict_if({kind}) count"
        mask, keys = _np(r.evicted.mask), _u64(r.evicted.keys)
        scores, vals = _u64(r.evicted.scores), _np(r.evicted.values)
        assert not mask[len(want):].any()
        for lane, (k, s, v) in enumerate(want):
            assert mask[lane] and int(keys[lane]) == k and int(scores[lane]) == s, lane
            assert np.array_equal(vals[lane, :DIM], np.asarray(v, np.float32)[:DIM]), lane

    def check_state(self):
        exp = self.table.export_batch(0, CAP // 128)
        mask, keys, scores, vals = (_np(exp.mask), _u64(exp.keys), _u64(exp.scores),
                                    _np(exp.values))
        got = {int(k): (int(s), vals[i, :DIM])
               for i, (k, s, m) in enumerate(zip(keys, scores, mask)) if m}
        want = {k: (int(e.score), np.asarray(e.value, np.float32)[:DIM])
                for k, e in self.oracle.items()}
        assert set(got) == set(want), (
            f"key sets diverge: extra={sorted(set(got) - set(want))[:8]} "
            f"missing={sorted(set(want) - set(got))[:8]}")
        for k, (s, v) in got.items():
            ws, wv = want[k]
            assert s == ws, f"score diverges at key {k}: {s} != {ws}"
            assert np.array_equal(v, wv.astype(np.float32)), f"value diverges at key {k}"
        assert self.table.size() == self.oracle.size()


def to_caller_form(ids, form: str):
    """ids: Python ints, negative = padding.  (canonical uint64 [LANES],
    the key argument in the caller's form)."""
    ids = list(ids) + [-1] * (LANES - len(ids))
    canonical = np.array([EMPTY if i < 0 else np.uint64(i) for i in ids], np.uint64)
    if form == "uint64":
        return canonical, canonical.copy()
    if form == "signed":
        return canonical, np.array(ids, np.int64)
    return canonical, list(ids)


OPS = ("upsert", "find_or_insert", "find", "find_rows", "session_read", "assign",
       "update_rows", "accum", "erase", "erase_if", "evict_if", "clear")
FORMS = ("uint64", "signed", "list")
PRED_KINDS = ("always", "score_lt", "score_ge", "epoch_lt", "key_range")


def random_pred_args(rng):
    kind = PRED_KINDS[rng.integers(0, len(PRED_KINDS))]
    if kind in ("score_lt", "score_ge"):
        return kind, int(rng.integers(0, 80)), 0
    if kind == "epoch_lt":
        return kind, int(rng.integers(0, 2)) << 32, 0
    if kind == "key_range":
        lo = int(rng.integers(0, 61))
        return kind, lo, lo + int(rng.integers(1, 40))
    return kind, 0, 0


def seeded_replay(h, seed=2026, steps=60):
    rng = np.random.default_rng(seed)
    for step in range(steps):
        op = OPS[rng.integers(0, len(OPS))] if step % 17 == 16 else \
            OPS[rng.integers(0, len(OPS) - 1)]   # clear is rare
        n = int(rng.integers(1, LANES + 1))
        ids = [int(x) for x in rng.integers(-2, 61, size=n)]
        if rng.random() < 0.2:
            ids[0] = int(rng.integers(2**32, 2**32 + 5))
        if op == "update_rows":
            ids = list(dict.fromkeys(ids))
        canonical, caller = to_caller_form(ids, FORMS[rng.integers(0, len(FORMS))])
        v = (rng.integers(0, 6, size=(LANES, 1)).astype(np.float32)
             * np.ones((1, DIM), np.float32))
        if op in ("upsert", "find_or_insert", "session_read", "assign", "update_rows", "accum"):
            getattr(h, op)(canonical, caller, v)
        elif op in ("find", "find_rows", "erase"):
            getattr(h, op)(canonical, caller)
        elif op in ("erase_if", "evict_if"):
            getattr(h, op)(*random_pred_args(rng))
        else:
            h.clear()
        h.check_state()


@pytest.mark.parametrize("backend", ["auto", "plain"])
def test_seeded_differential_replay(backend):
    seeded_replay(DifferentialHarness(backend=backend))


@pytest.mark.cuda
def test_seeded_differential_replay_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seeded_replay(DifferentialHarness(device="cuda", backend="auto"))


def _same(a, b, ctx):
    assert a.dtype == b.dtype and torch.equal(a, b), ctx


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_telemetry_on_replay_is_bit_identical(device):
    """Two twin tables take the same seeded ops, one with a sink: every
    result and the drained state stay equal, and the sink saw the lanes."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(777)
    kw = dict(capacity=CAP, dim=DIM, buckets_per_key=DUAL, score_policy=POLICY, device=device)
    plain, tel = HKVTable.create(**kw), HKVTable.create(**kw)
    sink = TelemetrySink()
    for step in range(24):
        n = int(rng.integers(1, LANES + 1))
        ids = [int(x) for x in rng.integers(-2, 61, size=n)]
        if rng.random() < 0.2:
            ids[0] = int(rng.integers(2**32, 2**32 + 5))
        canonical, _ = to_caller_form(ids, "uint64")
        v = torch.as_tensor(rng.integers(0, 6, size=(LANES, 1)).astype(np.float32)
                            * np.ones((1, DIM), np.float32), device=device)
        op = step % 4
        if op == 0:
            _same(plain.insert_or_assign(canonical, v).status,
                  tel.insert_or_assign(canonical, v, telemetry=sink).status, f"{step}")
        elif op == 1:
            a = plain.find_or_insert(canonical, v)
            b = tel.find_or_insert(canonical, v, telemetry=sink)
            for f in ("values", "found", "status"):
                _same(getattr(a, f), getattr(b, f), f"{step} {f}")
        elif op == 2:
            a, b = plain.find(canonical), tel.find(canonical, telemetry=sink)
            _same(a.values, b.values, f"{step}")
            _same(a.found, b.found, f"{step}")
        else:
            plain.erase(canonical)
            tel.erase(canonical, telemetry=sink)
        for x, y in zip(plain.state.planes, tel.state.planes):
            _same(x, y, f"state at step {step}")
    assert sink.total().to_dict()["lanes"] > 0
    assert set(sink.calls) == {"insert_or_assign", "find_or_insert", "find", "erase"}


if HAVE_HYPOTHESIS:
    _SMALL = st.integers(0, 60)
    _WIDE = st.integers(2**32, 2**32 + 4)
    _PAD = st.just(-1)

    @st.composite
    def key_batch(draw):
        n = draw(st.integers(1, LANES))
        ids = draw(st.lists(st.one_of(_SMALL, _WIDE, _PAD), min_size=n, max_size=n))
        return to_caller_form(ids, draw(st.sampled_from(FORMS)))

    @st.composite
    def unique_key_batch(draw):
        ids = list(dict.fromkeys(draw(st.lists(st.one_of(_SMALL, _WIDE, _PAD),
                                               min_size=1, max_size=LANES))))
        return to_caller_form(ids, draw(st.sampled_from(FORMS)))

    @st.composite
    def value_batch(draw):
        vals = draw(st.lists(st.integers(0, 5), min_size=LANES, max_size=LANES))
        return np.array(vals, np.float32)[:, None] * np.ones((1, DIM), np.float32)

    def _pred_args(kind, a, span, ep):
        if kind == "epoch_lt":
            return kind, ep << 32, 0
        if kind == "key_range":
            return kind, a, a + span
        return kind, a, 0

    class DifferentialMachine(RuleBasedStateMachine):
        def __init__(self):
            super().__init__()
            self.h = DifferentialHarness()

        @rule(kb=key_batch(), v=value_batch())
        def upsert(self, kb, v):
            self.h.upsert(kb[0], kb[1], v)

        @rule(kb=key_batch(), v=value_batch())
        def find_or_insert(self, kb, v):
            self.h.find_or_insert(kb[0], kb[1], v)

        @rule(kb=key_batch())
        def find(self, kb):
            self.h.find(kb[0], kb[1])

        @rule(kb=key_batch())
        def find_rows(self, kb):
            self.h.find_rows(kb[0], kb[1])

        @rule(kb=key_batch(), v=value_batch())
        def session_read(self, kb, v):
            self.h.session_read(kb[0], kb[1], v)

        @rule(kb=key_batch(), v=value_batch())
        def assign(self, kb, v):
            self.h.assign(kb[0], kb[1], v)

        @rule(kb=unique_key_batch(), v=value_batch())
        def update_rows(self, kb, v):
            self.h.update_rows(kb[0], kb[1], v)

        @rule(kb=key_batch(), v=value_batch())
        def accum(self, kb, v):
            self.h.accum(kb[0], kb[1], v)

        @rule(kb=key_batch())
        def erase(self, kb):
            self.h.erase(kb[0], kb[1])

        @rule(kind=st.sampled_from(PRED_KINDS), a=st.integers(0, 80),
              span=st.integers(1, 40), ep=st.integers(0, 2))
        def erase_if(self, kind, a, span, ep):
            self.h.erase_if(*_pred_args(kind, a, span, ep))

        @rule(kind=st.sampled_from(PRED_KINDS), a=st.integers(0, 80),
              span=st.integers(1, 40), ep=st.integers(0, 2))
        def evict_if(self, kind, a, span, ep):
            self.h.evict_if(*_pred_args(kind, a, span, ep))

        @rule()
        def clear(self):
            self.h.clear()

        @invariant()
        def table_matches_oracle(self):
            self.h.check_state()

    TestDifferential = DifferentialMachine.TestCase
    TestDifferential.settings = settings(max_examples=15, stateful_step_count=10,
                                         deadline=None, print_blob=True)
