"""Train->serve publication: snapshot-consistent table hand-off (the port of
``repro/serving/publisher.py``).

An online trainer (updater and inserter roles, paper §3.5) keeps changing
its working table while the serving engine (reader role,
``repro_torch.serving.embedding_engine``) reads.  Publication swaps a
`(version, table)` tuple, so a reader that snapshots once per wave gets
either the table before a publish or the one after it, whole.

The reference's handles never change, so there publication is trivially
atomic.  The port's tables change in place, which this module handles by
ownership:

  * the trainer's table is never the served object: `OnlineTrainer` takes
    one `snapshot()` of the published table at construction, and
    `publish()` hands its table to the publisher and goes on training on a
    copy of it;
  * that copy is made into the planes of the table served before the
    publish (a double buffer: at most two copies of the table exist), in
    stream order on the card, after the waves still reading it.  That is
    safe only while every reader runs on the publishing thread, where the
    host is between a reader's ops when the trainer publishes; so the
    double buffer is taken only while no other thread has taken a snapshot
    of the publisher.  Otherwise a reader on another thread may be inside
    the old table, and the trainer goes on on a fresh `snapshot()` (a
    third copy for as long as that reader holds the old one);
  * engine waves and scheduler steps change the served table in place,
    serially between waves, and offer that same table back.  An offer that
    loses the compare-and-swap to a publish leaves its changes on the
    object it changed, which is no longer served: they are dropped with
    it, as the reference drops a losing successor.

The one case that differs from the reference: publishing the very object a
losing offer changed publishes those changes too.

Two publication paths:

  handle swap   same-process: `publish(table)` swaps the snapshot tuple;
                the engine's miss-path admissions come back through
                `offer(version, table)`, a compare-and-swap that the
                trainer's publication beats.
  delta export  cross-process: `export_delta(table)` drains the table
                through `export_batch` into a picklable numpy
                `TableDelta`; `ingest_delta(table, delta)` replays it
                through `ingest` (admission-controlled, scores carried as
                custom where the destination policy takes them).

`OnlineTrainer` is the reference updater: a find_or_insert admission (the
step's single structural op) and a read-modify-write session
(`update_rows`, one shared locate) per gradient batch, publishing every
`publish_every` steps.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, NamedTuple, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.api import table_signature
from repro_torch.obs.trace import as_tracer


# =============================================================================
# Table sources: what the engine reads from
# =============================================================================


@runtime_checkable
class TableSource(Protocol):
    """Wave-granular table supply: `snapshot()` returns `(version, table)`
    atomically; `offer(version, table)` hands a read-path result back
    (admission/promotion effects), applied only if `version` is still
    current."""

    def snapshot(self) -> tuple: ...

    def offer(self, version: int, table: Any) -> bool: ...


class StaticSource:
    """Engine-owned source (no trainer) with the SAME compare-and-swap
    offer contract as `TablePublisher`: an offer applies only when the
    offerer's snapshot version is still current, and the new version bumps
    from the CURRENT snapshot, never from the caller's argument.  Two offer
    paths race here (the engine's wave admissions and the maintenance
    scheduler's between-wave steps), and a stale offer must lose."""

    def __init__(self, table: Any):
        self._snap = (0, table)
        self.offered = 0             # offers accepted
        self.rejected_offers = 0     # offers beaten by a newer table

    def snapshot(self) -> tuple:
        return self._snap

    def offer(self, version: int, table: Any) -> bool:
        if self._snap[0] != version:
            self.rejected_offers += 1
            return False
        self._snap = (self._snap[0] + 1, table)
        self.offered += 1
        return True

    @property
    def table(self) -> Any:
        return self._snap[1]


class TablePublisher:
    """The train->serve hand-off point.

    The trainer calls `publish(table)`; the engine calls `snapshot()` once
    per wave and `offer(...)` when its own policy changed the table.  The
    snapshot tuple is swapped under a lock (offers need compare-and-swap);
    readers are lock-free: a tuple read is atomic under the GIL and the
    tuple itself is immutable.  The publisher also records which threads
    have taken a snapshot (a thread's first one takes the lock), which
    `hand_over` needs.
    """

    def __init__(self, table: Any, *, tracer: Optional[Any] = None):
        self._snap = (0, table)
        self._lock = threading.Lock()
        self._readers: set[int] = set()   # threads that have taken a snapshot
        self.published = 0           # trainer publications
        self.offered = 0             # engine offers accepted
        self.rejected_offers = 0     # engine offers beaten by a publish
        # span tracing: publisher.publish / publisher.offer instants
        # (repro_torch.obs.trace; noop when unwired)
        self.tracer = as_tracer(tracer)

    def snapshot(self) -> tuple:
        thread = threading.get_ident()
        if thread not in self._readers:
            with self._lock:
                self._readers.add(thread)
                return self._snap
        return self._snap

    @property
    def version(self) -> int:
        return self._snap[0]

    @property
    def table(self) -> Any:
        return self._snap[1]

    def publish(self, table: Any) -> int:
        """Unconditional swap (the trainer wins races); returns the new
        version."""
        with self._lock:
            v = self._swap(table)
        self.tracer.instant("publisher.publish", version=v)
        return v

    def only_reader(self) -> bool:
        """True when no thread but the caller's has taken a snapshot."""
        with self._lock:
            return self._readers <= {threading.get_ident()}

    def hand_over(self, table: Any, successor: Callable[[Any, Optional[Any]], Any]
                  ) -> tuple[int, Any]:
        """Publish `table` and return `(version, successor(table, prev))`:
        the caller's next private table, built from `table`.  `prev` is the
        table replaced when no thread but the caller's has taken a
        snapshot, so that no reader can be inside it and its planes may be
        reused; the successor is then built under the lock, after the swap,
        and a thread's first snapshot waits for it.  Otherwise `prev` is
        None and the successor is built before the swap, while `table` is
        still the caller's alone."""
        me = threading.get_ident()
        with self._lock:
            only = self._readers <= {me}
            if only:
                prev = self._snap[1]
                v = self._swap(table)
                nxt = successor(table, prev)
        if not only:
            nxt = successor(table, None)
            with self._lock:
                v = self._swap(table)
        self.tracer.instant("publisher.publish", version=v)
        return v, nxt

    def _swap(self, table: Any) -> int:
        v = self._snap[0] + 1
        self._snap = (v, table)
        self.published += 1
        return v

    def offer(self, version: int, table: Any) -> bool:
        """Compare-and-swap from the read path: applies only if the
        reader's snapshot is still current (a concurrent `publish`
        supersedes the offered admission effects; see module doc)."""
        with self._lock:
            if self._snap[0] != version:
                self.rejected_offers += 1
                accepted = False
            else:
                self._snap = (version + 1, table)
                self.offered += 1
                accepted = True
        self.tracer.instant("publisher.offer", version=version, accepted=accepted)
        return accepted


# =============================================================================
# The delta path: export_batch -> ingest, cross-process publishable
# =============================================================================


class TableDelta(NamedTuple):
    """Host-side (numpy, picklable) live-entry dump of a table."""

    keys: np.ndarray     # uint64 [n]
    values: np.ndarray   # float32 [n, total_value_dim]
    scores: np.ndarray   # uint64 [n]

    @property
    def count(self) -> int:
        return int(self.keys.shape[0])


def export_delta(table: Any, *, chunk_buckets: int = 64,
                 tracer: Optional[Any] = None) -> TableDelta:
    """Drain a table's live entries through `export_batch` in
    `chunk_buckets`-bucket chunks (any handle exposing
    `num_buckets`/`export_batch`: flat, or tiered, whose concatenated
    bucket space leaves out stale inclusive copies)."""
    with as_tracer(tracer).span("delta.export"):
        return _export_delta(table, chunk_buckets=chunk_buckets)


def _u64(words: torch.Tensor) -> np.ndarray:
    """int64 words as numpy uint64 (the exact bits)."""
    return words.cpu().numpy().view(np.uint64)


def _export_delta(table: Any, *, chunk_buckets: int) -> TableDelta:
    ks, vs, ss = [], [], []
    nb = table.num_buckets
    for start in range(0, nb, chunk_buckets):
        exp = table.export_batch(start, min(chunk_buckets, nb - start))
        mask = exp.mask.cpu().numpy()
        if not mask.any():
            continue
        ks.append(_u64(exp.keys)[mask])
        ss.append(_u64(exp.scores)[mask])
        vs.append(exp.values.float().cpu().numpy()[mask])
    if not ks:
        width = getattr(table, "dim", 0)
        return TableDelta(keys=np.zeros(0, np.uint64),
                          values=np.zeros((0, width), np.float32),
                          scores=np.zeros(0, np.uint64))
    return TableDelta(keys=np.concatenate(ks),
                      values=np.concatenate(vs).astype(np.float32),
                      scores=np.concatenate(ss))


def ingest_delta(table: Any, delta: TableDelta, *, batch: int = 1024,
                 carry_scores: bool = False, tracer: Optional[Any] = None,
                 telemetry: Optional[Any] = None) -> Any:
    """Replay a delta into any inserter-capable handle through `ingest`
    (admission-controlled: the destination's cache semantics decide what
    sticks).  `carry_scores=True` forwards the exported scores as custom
    scores; only meaningful when the destination runs the 'custom' policy.
    Keys stay numpy uint64 until the handle normalizes them (a key at or
    above 2**63 is a negative int64, which a handle reads as padding).
    The reference pads the last chunk with EMPTY keys for its compiled
    shapes; EMPTY lanes change nothing, so the port does not pad.
    `telemetry=` threads the op counter sink through every replayed
    `ingest` call."""
    kw = {} if telemetry is None else {"telemetry": telemetry}
    with as_tracer(tracer).span("delta.ingest", count=delta.count):
        for start in range(0, delta.count, batch):
            kb = delta.keys[start:start + batch]
            vb = torch.from_numpy(np.ascontiguousarray(delta.values[start:start + batch]))
            cs = delta.scores[start:start + batch] if carry_scores else None
            table = table.ingest(kb, vb, custom_scores=cs, **kw).table
    return table


# =============================================================================
# OnlineTrainer: the reference updater/inserter loop
# =============================================================================


def _tiers(table: Any) -> list:
    """The flat handles a table is made of (a tiered table's two tiers)."""
    hot, cold = getattr(table, "hot", None), getattr(table, "cold", None)
    return [table] if hot is None or cold is None else [hot, cold]


def _can_take_copy(dst: Any, src: Any) -> bool:
    """The planes of `dst` can take a copy of `src`'s: same structure,
    planes of equal shapes, dtypes and devices, and none shared."""
    if type(dst) is not type(src) or table_signature(dst) != table_signature(src):
        return False
    for td, ts in zip(_tiers(dst), _tiers(src)):
        for pd, ps in zip(td.state.planes, ts.state.planes):
            if (pd.shape != ps.shape or pd.dtype != ps.dtype or pd.device != ps.device
                    or pd.data_ptr() == ps.data_ptr()):
                return False
    return True


def copy_table_into(dst: Any, src: Any) -> Any:
    """A copy of `src` made in `dst`'s planes (same layout): a handle with
    `src`'s configuration on `dst`'s state, which now equals `src`'s."""
    for td, ts in zip(_tiers(dst), _tiers(src)):
        td.state.copy_from(ts.state)
    return src.with_state(dst.state)


@dataclasses.dataclass
class OnlineTrainer:
    """Streaming trainer on a table of its own, publishing whole tables.

    One `train_step(keys, grads)`:
      1. `find_or_insert` admits the step's keys (INSERTER: the single
         structural op; on a tiered table this also promotes cold hits);
      2. a session `update_rows` applies `update_fn(rows, grads)` over the
         same key batch (UPDATER: gather and write-back, one locate);
      3. every `publish_every` steps the table is published.

    `update_fn(rows, grads) -> rows` sees full-width rows [n, dim + aux];
    the default is plain SGD on the embedding columns.  Keys are numpy
    uint64 (or any form a handle normalizes); grads [n, dim].

    The trainer snapshots the published table once, at construction, and
    after each publish trains on a copy of what it published, made in the
    planes of the table served before when no reader on another thread
    can hold that table, else in a fresh snapshot (see the module doc).  It
    is constructed before readers on other threads start, or on their
    thread: its snapshot would read a table they may be changing.
    `telemetry=` (a ``repro_torch.obs.TelemetrySink``) accumulates the
    admission op's counters across steps (the update half runs through a
    session, which has no telemetry seam, as in the reference).
    """

    publisher: TablePublisher
    publish_every: int = 1
    lr: float = 0.1
    update_fn: Optional[Callable] = None
    steps: int = 0
    telemetry: Optional[Any] = None

    def __post_init__(self):
        if not self.publisher.only_reader():
            # the served table may be changing in place on that thread
            raise RuntimeError(
                "another thread reads from the publisher and may change its table in "
                "place: construct the OnlineTrainer before such readers start, or on "
                "their thread")
        self._table = self.publisher.table.snapshot()

    @property
    def table(self) -> Any:
        return self._table

    def train_step(self, keys: Any, grads: Any) -> Any:
        t = self._table
        grads = torch.as_tensor(grads, device=t.device)
        dim = grads.shape[1]
        init = torch.zeros((grads.shape[0], dim), dtype=torch.float32, device=t.device)
        kw = {} if self.telemetry is None else {"telemetry": self.telemetry}
        t = t.find_or_insert(keys, init, **kw).table
        lr = self.lr
        fn = self.update_fn or (
            lambda rows, g: torch.cat([rows[:, :dim] + (-lr * g), rows[:, dim:]], dim=1))
        s = t.session()
        s.update_rows(keys, lambda rows: fn(rows, grads))
        t = s.commit()
        self._table = t
        self.steps += 1
        if self.steps % self.publish_every == 0:
            self.publish()
        return t

    def publish(self) -> int:
        """Swap the trainer's table in as the served one, and go on
        training on a copy of it in the planes of the table served before
        (a fresh snapshot when a reader on another thread may hold that
        table, or its planes cannot take the copy)."""

        def successor(table, prev):
            if prev is not None and _can_take_copy(prev, table):
                return copy_table_into(prev, table)
            return table.snapshot()

        version, self._table = self.publisher.hand_over(self._table, successor)
        return version
