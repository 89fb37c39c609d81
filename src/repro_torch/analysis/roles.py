"""Checker: the §3.5 role taxonomy (port of ``repro/analysis/roles.py``).

Four layers are checked against each other:

  unannotated-op     every public op entry point in ``repro_torch.core.ops``
                     (a module-level function whose first parameter is
                     ``state``) carries ``@roles.reader``, ``@roles.updater``
                     or ``@roles.inserter``: the session planner would
                     otherwise guess how to fence it.
  role-mismatch      every op ``OpSession`` records is recorded under the
                     role its ``core.ops`` counterpart is annotated with
                     (the session fuses and fences by the recorded role).
  plan-taxonomy      ``OpSession._plan()`` obeys the taxonomy on a probe
                     sequence: commuting readers and updaters on one key
                     batch share one locate; every inserter is a group of
                     its own; a reader after an inserter issues a fresh
                     locate (cached positions died at the fence).
  engine-purity      the serving engine's waves under
                     ``miss_policy='readonly', promote=False`` are pure
                     readers in both admission modes (wave and continuous):
                     no offer to the source, no change to the table, and
                     the engine's ``_mutates`` flag says so; an ``admit``
                     engine flags itself mutating, or its admissions would
                     never be offered.  The port's tables change in place,
                     so purity is checked on the table's planes, not on the
                     handle's identity.

The probes run on small CPU tables.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from repro_torch.analysis.findings import Finding
from repro_torch.core import api as api_mod
from repro_torch.core import ops as ops_mod
from repro_torch.core import roles as roles_mod

CHECKER = "roles"
_OPS_PATH = "src/repro_torch/core/ops.py"
_API_PATH = "src/repro_torch/core/api.py"
_ENGINE_PATH = "src/repro_torch/serving/embedding_engine.py"
_CPU = "cpu"

# session-only composite ops (no core.ops counterpart) and their roles: none
# since update_rows became a core.ops updater; the place to register one
_SESSION_ONLY: dict = {}


def public_ops(module=ops_mod) -> dict:
    """Name -> function for every op entry point of the ops module."""
    out = {}
    for name, fn in vars(module).items():
        if name.startswith("_") or not inspect.isfunction(fn):
            continue
        if getattr(fn, "__module__", None) != module.__name__:
            continue
        params = list(inspect.signature(fn).parameters)
        if params and params[0] == "state":
            out[name] = fn
    return out


def _line(fn):
    try:
        return inspect.getsourcelines(fn)[1]
    except OSError:  # pragma: no cover
        return None


def check_annotations(module=ops_mod, path: str = _OPS_PATH) -> list[Finding]:
    out = []
    for name, fn in sorted(public_ops(module).items()):
        r = roles_mod.role_of(fn)
        if r is None:
            out.append(Finding(
                CHECKER, "unannotated-op", name,
                "public op entry point has no @roles.reader/updater/inserter annotation: "
                "declare its §3.5 commutativity class so the session planner fences it "
                "correctly", path=path, line=_line(fn)))
        elif r not in roles_mod.ROLES:  # pragma: no cover - role() validates
            out.append(Finding(CHECKER, "unknown-role", name,
                               f"annotation {r!r} is not one of {roles_mod.ROLES}",
                               path=path, line=_line(fn)))
    return out


def _table():
    return api_mod.HKVTable.create(capacity=64, dim=4, slots_per_bucket=8, device=_CPU)


def _keys(*ks):
    return np.asarray(ks, dtype=np.uint64)


def _probe_session():
    t = _table()
    s = t.session()
    keys = _keys(1, 2, 3, 4)
    vals = torch.zeros((4, 4), dtype=torch.float32)
    # one of each recordable kind (keeps the recorded-role census complete)
    s.find(keys)
    s.find_rows(keys)
    s.contains(keys)
    s.assign(keys, vals)
    s.assign_add(keys, vals)
    s.assign_scores(keys, _keys(5, 6, 7, 8))
    s.update_rows(keys, lambda rows: rows)
    s.insert_or_assign(keys, vals)
    s.find_or_insert(keys, vals)
    s.insert_and_evict(keys, vals)
    s.erase(keys)
    return s


def check_session_roles() -> list[Finding]:
    out = []
    ops = public_ops()
    for op in _probe_session()._ops:
        if op.kind in _SESSION_ONLY:
            want = _SESSION_ONLY[op.kind]
            if op.role != want:
                out.append(Finding(CHECKER, "role-mismatch", op.kind,
                                   f"session records composite op as {op.role!r}; its "
                                   f"declared class is {want!r}", path=_API_PATH))
            continue
        fn = ops.get(op.kind)
        if fn is None:
            out.append(Finding(CHECKER, "unknown-session-op", op.kind,
                               "session records an op with no core.ops counterpart and no "
                               "session-only registration", path=_API_PATH))
            continue
        want = roles_mod.role_of(fn)
        if want is not None and op.role != want:
            what = ("skip a required fence" if want == roles_mod.INSERTER
                    else "fence needlessly")
            out.append(Finding(CHECKER, "role-mismatch", op.kind,
                               f"session records role {op.role!r} but core.ops.{op.kind} is "
                               f"annotated @roles.{want}: the planner would {what}",
                               path=_API_PATH))
    return out


def check_plan_taxonomy() -> list[Finding]:
    out = []
    k1, k2 = _keys(1, 2, 3, 4), _keys(9, 10, 11, 12)
    vals = torch.zeros((4, 4), dtype=torch.float32)
    s = _table().session()
    s.find(k1)                      # issues locate[k1]
    s.assign(k1, vals)              # must share locate[k1]
    s.find(k2)                      # another batch: its own locate
    s.insert_or_assign(k1, vals)    # serialization point
    s.find(k1)                      # must issue again: the cache died at the fence
    groups = s._plan()

    def finding(rule, msg):
        out.append(Finding(CHECKER, rule, "OpSession._plan", msg, path=_API_PATH))

    if len(groups) != 3:
        finding("plan-shape", "probe sequence should plan 3 groups (commuting run | inserter "
                f"| trailing reader), got {len(groups)}")
        return out
    pre, ins, post = groups
    if [op.kind for op in pre] != ["find", "assign", "find"]:
        finding("plan-shape", f"first commuting group is {[op.kind for op in pre]}, expected "
                "[find, assign, find]")
    if not (len(ins) == 1 and ins[0].role == roles_mod.INSERTER):
        finding("inserter-not-serialized", "inserter did not form a serialization group of "
                "its own")
    if len(pre) == 3:
        if pre[0].shares_locate:
            finding("locate-sharing", "first reader on a key batch must issue (not share) "
                    "its locate")
        if not pre[1].shares_locate:
            finding("locate-sharing", "updater on an already-probed key batch must share the "
                    "reader's locate (§3.5 commuting rule)")
        if pre[2].shares_locate:
            finding("locate-sharing", "reader on a new key batch must issue its own locate")
    if post and post[0].shares_locate:
        finding("stale-locate", "reader after an inserter shares a locate from before the "
                "fence: structural ops invalidate cached positions (§3.5)")
    return out


def _planes(t) -> list:
    return [p.clone() for tier in (t.hot, t.cold) for p in tier.state.planes]


def check_engine_purity() -> list[Finding]:
    """A tiny tiered table whose keys sit in the cold tier (so a forbidden
    promotion would show) served in every admission mode: readonly,
    non-promoting waves leave it as it was and offer nothing; admit waves
    declare themselves mutating."""
    from repro_torch.core.tiered import TieredHKVTable
    from repro_torch.serving.embedding_engine import EmbeddingRequest, OnlineEmbeddingEngine

    out = []
    keys = np.arange(1, 13, dtype=np.uint64)

    def cold_resident():
        t = TieredHKVTable.create(hot_capacity=64, cold_capacity=128, dim=4,
                                  slots_per_bucket=8, device=_CPU)
        t.cold.insert_or_assign(keys, torch.ones((len(keys), 4)),
                                custom_scores=np.arange(1, len(keys) + 1, dtype=np.uint64))
        return t

    def impure(admission, msg):
        out.append(Finding(CHECKER, "engine-impure-reader",
                           f"OnlineEmbeddingEngine[{admission}]", msg, path=_ENGINE_PATH))

    for admission in ("wave", "continuous"):
        t = cold_resident()
        before = _planes(t)
        eng = OnlineEmbeddingEngine(t, wave_size=8, miss_policy="readonly", promote=False,
                                    admission=admission)
        eng.submit(EmbeddingRequest(rid=0, keys=keys))   # spans two waves
        eng.run_until_drained()
        if eng._mutates:
            impure(admission, "readonly+promote=False waves are flagged mutating: the "
                   "pure-reader contract (no offer a wave) is broken")
        if eng.source.offered or eng.source.snapshot()[1] is not t:
            impure(admission, "readonly+promote=False admission offered a table to the "
                   "source: the wave was not a pure reader")
        if any(not torch.equal(a, b) for a, b in zip(before, _planes(t))):
            impure(admission, "readonly+promote=False waves changed the table (structural "
                   "motion on a pure-reader path)")
        if bool(t.hot.contains(keys).any()):
            impure(admission, "readonly+promote=False waves promoted cold hits into the hot "
                   "tier")
    # the census: an admit engine must flag itself mutating, or its
    # admissions would never be offered back to the source
    eng = OnlineEmbeddingEngine(cold_resident(), wave_size=8, miss_policy="admit")
    eng.submit(EmbeddingRequest(rid=0, keys=keys[:8]))
    eng.run_until_drained()
    if not eng._mutates:
        out.append(Finding(CHECKER, "engine-unflagged-mutator", "OnlineEmbeddingEngine",
                           "admit-policy waves are not flagged mutating: admission successors "
                           "would be dropped instead of offered", path=_ENGINE_PATH))
    return out


def check_roles() -> list[Finding]:
    return (check_annotations() + check_session_roles() + check_plan_taxonomy()
            + check_engine_purity())
