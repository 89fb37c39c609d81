"""Batched LM serving engine: wave admission, early-exit lanes (port of
``repro/serving/engine.py``).

A fixed pool of `max_batch` decode lanes runs one decode step at a time.
Requests are admitted in WAVES of equal prompt length (the queue is
bucketed by length): a wave prefills all its prompts as one batch (lanes
the wave does not fill are copies of lane 0), then decodes; a lane whose
request finishes (EOS or `max_new` tokens) stops emitting but keeps its
slot until the wave drains, and then the next wave is admitted.  Each
prefill and each step reads the lanes' argmax back to the host once.

The model's decode state lives on the parameters' device and each step
writes it in place (``models/lm.py``); the engine keeps the one state of
the live wave.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from repro_torch import tree


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # int32 [prompt_len]
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, model, params, *, max_batch: int, max_len: int,
                 eos_id: Optional[int] = None):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = tree.leaves(params)[0].device
        self._buckets: dict = defaultdict(list)   # prompt_len -> [Request]
        self._wave: list = []
        self.state = None
        self.completed: list = []

    def submit(self, req: Request):
        self._buckets[len(req.prompt)].append(req)

    def _argmax(self, logits: torch.Tensor) -> np.ndarray:
        """The lanes' greedy tokens, read to the host (the step's one read)."""
        return logits.argmax(dim=-1).cpu().numpy()

    # ------------------------------------------------------------------ wave

    def _admit_wave(self) -> bool:
        for plen, reqs in sorted(self._buckets.items()):
            if not reqs:
                continue
            wave = [reqs.pop(0) for _ in range(min(self.max_batch, len(reqs)))]
            prompts = np.stack([r.prompt for r in wave]).astype(np.int32)
            if len(wave) < self.max_batch:  # pad lanes with a copy of lane 0
                pad = np.repeat(prompts[:1], self.max_batch - len(wave), axis=0)
                prompts = np.concatenate([prompts, pad])
            logits, self.state = self.model.prefill(
                self.params, torch.from_numpy(prompts).to(self.device), max_len=self.max_len)
            first = self._argmax(logits)
            for i, r in enumerate(wave):
                r.out.append(int(first[i]))
            self._wave = wave
            return True
        return False

    def step(self) -> int:
        """One decode step over the live wave; admits a wave when idle."""
        live = [r for r in self._wave if not r.done]
        if not live:
            for r in self._wave:
                self.completed.append(r)
            self._wave = []
            if not self._admit_wave():
                return 0
        toks = np.zeros(self.max_batch, np.int32)
        for i, r in enumerate(self._wave):
            toks[i] = r.out[-1]
        logits, self.state = self.model.decode_step(
            self.params, torch.from_numpy(toks).to(self.device), self.state)
        nxt = self._argmax(logits)
        emitted = 0
        for i, r in enumerate(self._wave):
            if r.done:
                continue
            t = int(nxt[i])
            r.out.append(t)
            emitted += 1
            if (self.eos_id is not None and t == self.eos_id) or len(r.out) >= r.max_new:
                r.done = True   # lane masked; the wave drains, then the next admits
        return emitted

    def run_until_drained(self, max_steps: int = 10_000):
        for _ in range(max_steps):
            if self.step() == 0:
                break
        return self.completed
