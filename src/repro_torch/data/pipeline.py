"""Host-side input pipeline: prefetch and restart-exact cursors (port of
``repro/data/pipeline.py``).

HostPrefetcher overlaps host batch synthesis with device compute through a
bounded background queue (while step N runs on the card, batch N+1 is
being produced).

DataCursor is the checkpointable pipeline position (seed, step).  Every
batch is a pure function of (seed, step, rank, world) (see
``data.synthetic``), so restoring the cursor resumes the exact stream.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator


@dataclasses.dataclass
class DataCursor:
    seed: int
    step: int = 0

    def to_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d: dict) -> "DataCursor":
        return cls(seed=int(d["seed"]), step=int(d["step"]))


class HostPrefetcher:
    """Bounded background prefetch over a step-indexed batch function."""

    def __init__(self, batch_fn: Callable[[int], object], cursor: DataCursor, depth: int = 2):
        self._fn = batch_fn
        self.cursor = cursor
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._next_to_produce = cursor.step
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        while not self._stop.is_set():
            step = self._next_to_produce
            batch = self._fn(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            self._next_to_produce = step + 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        self.cursor.step = step + 1  # checkpoint-after-consume semantics
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
