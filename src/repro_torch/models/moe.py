"""Mixture-of-Experts configuration (the dataclass of ``repro/models/moe.py``).

The MoE FFN itself waits for ROADMAP item 15b; the configuration is here
so that block and arch configurations keep the reference's shape.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_model: int
    d_ff: int                    # per-expert hidden
    act: str = "silu"
    gated: bool = True
    capacity_factor: float = 1.25
