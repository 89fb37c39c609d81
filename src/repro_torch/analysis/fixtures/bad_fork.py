"""Fixture: forked (inlined) copies of the key-match formula.

``oracle_coupling.scan_source`` over this file must flag, with rule
``match-formula-fork``, the hi/lo mirror compares in ``forked_halves`` and
the key-and-digest conjunction in ``forked_match``: the formula must come
from ``core.find.match_lanes``.  ``not_a_fork`` is the control: its
conjunction compares unrelated planes and must not be flagged.
"""

from __future__ import annotations

import torch


def forked_halves(key_hi, key_lo, q_hi, q_lo):
    """BUG: re-derives the match formula on 32-bit halves."""
    hits = (key_hi == q_hi) & (key_lo == q_lo)
    return torch.where(hits, 1, 0)


def forked_match(keys, digests, q, q_digest):
    """BUG: re-derives the port's formula (keys, digest prefilter) inline."""
    return (keys == q[:, None]) & (digests == q_digest[:, None])


def not_a_fork(scores, epochs, s_min, e_min):
    """A conjunction over unrelated planes: legitimate, not flagged."""
    return (scores == s_min) & (epochs == e_min)
