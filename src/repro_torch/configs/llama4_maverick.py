"""llama4-maverick-400b-a17b [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 experts top-1, dense/MoE layers interleaved 1:1.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

As in the reference: a softmax top-1 router (upstream routes by sigmoid
and adds a shared expert), and no early-fusion multimodality."""

from repro_torch.configs.common import ArchDef, attn_block, shrink_lm, standard_shapes
from repro_torch.models.lm import LMConfig, StackSegment
from repro_torch.models.moe import MoECfg

D = 5120


def arch() -> ArchDef:
    dense_blk = attn_block(d_model=D, heads=40, kv_heads=8, d_ff=8192, act="silu", gated=True)
    moe_blk = attn_block(d_model=D, heads=40, kv_heads=8, d_ff=0, act="silu", gated=True,
                         moe=MoECfg(num_experts=128, top_k=1, d_model=D, d_ff=8192))
    lm = LMConfig(name="llama4-maverick-400b-a17b", d_model=D, vocab=202048,
                  segments=(StackSegment(dense_blk, 1), StackSegment(moe_blk, 1)), repeats=24,
                  tied_head=False)
    return ArchDef(name="llama4-maverick-400b-a17b", family="moe", lm=lm, smoke=shrink_lm(lm),
                   shapes=standard_shapes(sub_quadratic=False),
                   source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified")
