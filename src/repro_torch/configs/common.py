"""Config machinery shared by the LM architectures (port of
``repro/configs/common.py``).

Each arch module exports `arch()` returning an ArchDef: the published
LMConfig, the standard shape grid, and a structurally identical reduced
config for CPU smoke tests.  `ArchDef.param_count` builds the full
parameter tree on the 'meta' device, which allocates nothing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.models.blocks import BlockCfg
from repro_torch.models.lm import CompositeLM, LMConfig, StackSegment
from repro_torch.models.moe import MoECfg


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str            # train | prefill | decode
    seq: int
    global_batch: int
    skip: Optional[str] = None   # reason string if this cell is skipped


def standard_shapes(sub_quadratic: bool) -> tuple:
    """The LM shape grid.  long_500k decodes against a 524288-token context,
    which needs bounded attention state: full-attention archs skip it."""
    return (
        ShapeCfg("train_4k", "train", 4096, 256),
        ShapeCfg("prefill_32k", "prefill", 32768, 32),
        ShapeCfg("decode_32k", "decode", 32768, 128),
        ShapeCfg("long_500k", "decode", 524288, 1,
                 skip=None if sub_quadratic else "full-attn: unbounded 500k KV state"),
    )


@dataclasses.dataclass(frozen=True)
class ArchDef:
    name: str
    family: str                     # dense | moe | hybrid | vlm | audio | ssm
    lm: LMConfig
    smoke: LMConfig
    shapes: tuple
    vision_tokens: int = 0          # stub-frontend patch count (vlm only)
    source: str = ""

    def model(self, smoke: bool = False, attention: Optional[str] = None) -> CompositeLM:
        return CompositeLM(self.smoke if smoke else self.lm, attention)

    def shape(self, name: str) -> ShapeCfg:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(name)

    def param_count(self) -> int:
        """Parameter count from shapes (the tree on 'meta', no allocation)."""
        params = CompositeLM(self.lm).init(device="meta")
        return sum(math.prod(x.shape) for x in tree.leaves(params))


def attn_block(d_model, heads, kv_heads, d_ff, *, head_dim=0, qkv_bias=False, window=None,
               rope="rope", rope_theta=10000.0, act="silu", gated=True, moe=None) -> BlockCfg:
    return BlockCfg(kind="attn", d_model=d_model, heads=heads, kv_heads=kv_heads,
                    head_dim=head_dim, qkv_bias=qkv_bias, window=window, rope=rope,
                    rope_theta=rope_theta, d_ff=d_ff, act=act, gated=gated, moe=moe)


def shrink_lm(cfg: LMConfig, vocab: int = 512) -> LMConfig:
    """Structure-preserving reduction for CPU smoke tests: the same segment
    kinds and order, tiny widths and counts."""

    def shrink_block(b: BlockCfg) -> BlockCfg:
        kw = dataclasses.asdict(b)
        if b.moe is not None:
            kw["moe"] = MoECfg(num_experts=4, top_k=min(b.moe.top_k, 2), d_model=64, d_ff=32,
                               act=b.moe.act, gated=b.moe.gated)
        kw.update(
            d_model=64,
            heads=4 if b.heads else 0,
            kv_heads=max(1, (4 * b.kv_heads) // max(b.heads, 1)) if b.heads else 0,
            head_dim=16 if b.head_dim else 0,
            d_ff=128 if (b.d_ff and b.moe is None) else (0 if b.moe else b.d_ff),
            d_state=16,
            ssm_heads=2,
            window=min(b.window, 32) if b.window else None,
        )
        return BlockCfg(**kw)

    def shrink_seg(s: StackSegment) -> StackSegment:
        return StackSegment(shrink_block(s.block), count=min(s.count, 2), shared=s.shared)

    return dataclasses.replace(
        cfg,
        d_model=64,
        vocab=vocab,
        prelude=tuple(shrink_seg(s) for s in cfg.prelude),
        segments=tuple(shrink_seg(s) for s in cfg.segments),
        repeats=min(cfg.repeats, 2),
        dtype=torch.float32,
        loss_chunk=16,
    )
