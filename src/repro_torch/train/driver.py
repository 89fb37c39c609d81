"""Fault-tolerant training driver (port of ``repro/train/driver.py``).

  * checkpoint/restart: async atomic checkpoints every `checkpoint_every`
    steps carry the parameters, the optimizer state, the HKV table AND the
    data cursor; a restart resumes the exact batch stream.
  * failure: an exception inside a step restores the latest checkpoint and
    replays; `max_failures` bounds the retries.
  * straggler: `step_timeout` runs the step on a thread and turns a step
    that outlasts it into a failure (restore and replay) instead of a stall.

The state is a tree (``repro_torch.tree``) of tensors and table handles.
Tables change in place, so the pristine initial state kept for a restart
with no checkpoint is a copy (tensors cloned on their own devices, tables
snapshotted), and each such restart starts from a fresh copy of it.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import tree
from repro_torch.data.pipeline import DataCursor
from repro_torch.train import checkpoint as ckpt


class StepTimeout(Exception):
    pass


def copy_state(state: Any) -> Any:
    """An independent copy of a train state: tensors cloned on their own
    devices, table handles snapshotted."""
    def one(x):
        if ckpt._is_table(x):
            return x.snapshot()
        return x.clone() if isinstance(x, torch.Tensor) else x

    return tree.map(one, state, is_leaf=ckpt._is_table)


@dataclasses.dataclass
class TrainDriver:
    step_fn: Callable               # (state, batch) -> (state, metrics)
    batch_fn: Callable              # (step) -> batch
    state: Any                      # (params, opt_state, [table])
    ckpt_dir: str
    cursor: DataCursor
    checkpoint_every: int = 100
    max_failures: int = 3
    step_timeout: Optional[float] = None
    failure_injector: Optional[Callable] = None   # (step) -> None|raise, for tests
    log: Callable = print

    def _run_step(self, step: int):
        batch = self.batch_fn(step)
        if self.step_timeout is None:
            if self.failure_injector is not None:
                self.failure_injector(step)
            self.state, metrics = self.step_fn(self.state, batch)
            return metrics
        result = {}
        err = []

        def target():
            try:
                # the injector runs INSIDE the timed context (a simulated
                # straggler must stall the step, not the watchdog)
                if self.failure_injector is not None:
                    self.failure_injector(step)
                result["out"] = self.step_fn(self.state, batch)
            except Exception as e:  # noqa: BLE001 - surfaced below
                err.append(e)

        t = threading.Thread(target=target, daemon=True)
        t.start()
        t.join(self.step_timeout)
        if t.is_alive():
            raise StepTimeout(f"step {step} exceeded {self.step_timeout}s (straggler)")
        if err:
            raise err[0]
        self.state, metrics = result["out"]
        return metrics

    def _checkpoint(self, step: int) -> ckpt.PendingSave:
        return ckpt.save_async(self.ckpt_dir, step, self.state, extra=self.cursor.to_dict())

    def _restore_latest(self) -> tuple[int, float]:
        ckpt.wait_async()  # an in-flight async save must land before we look
        t0 = time.perf_counter()
        last = ckpt.latest_step(self.ckpt_dir)
        if last is None:
            # no checkpoint yet: restart from the pristine initial state
            self.state = copy_state(self._initial_state)
            self.cursor = DataCursor(seed=self.cursor.seed, step=0)
            self.log("[driver] no checkpoint found; restarting from step 0")
            return 0, time.perf_counter() - t0
        self.state, extra = ckpt.restore(self.ckpt_dir, last, self.state)
        self.cursor = DataCursor.from_dict(extra)
        self.log(f"[driver] restored step {last} (cursor {self.cursor})")
        return last, time.perf_counter() - t0

    def run(self, num_steps: int) -> dict:
        """Run to `num_steps`.  The history: each step's loss and metrics (as
        floats, replayed steps again after a restore), the restart count,
        each checkpoint (`PendingSave`) and each restore (step, seconds)."""
        self._initial_state = copy_state(self.state)
        failures = 0
        step = self.cursor.step
        history = {"loss": [], "metrics": [], "restarts": 0, "checkpoints": [], "restores": []}
        while step < num_steps:
            try:
                metrics = self._run_step(step)
                step += 1
                self.cursor.step = step
                metrics = {k: float(v) for k, v in metrics.items()}
                if "loss" in metrics:
                    history["loss"].append(metrics["loss"])
                history["metrics"].append(metrics)
                if step % self.checkpoint_every == 0 or step == num_steps:
                    history["checkpoints"].append(self._checkpoint(step))
            except Exception as e:  # noqa: BLE001 - recovery path
                failures += 1
                history["restarts"] += 1
                self.log(f"[driver] step {step} failed ({type(e).__name__}: {e}); "
                         f"recovery {failures}/{self.max_failures}")
                if failures > self.max_failures:
                    raise
                step, seconds = self._restore_latest()
                history["restores"].append((step, seconds))
        ckpt.wait_async()
        return history
