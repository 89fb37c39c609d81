"""moonshot-v1-16b-a3b [moe]: 48L d=2048 16H (MHA kv=16) d_ff=1408
vocab=163840, MoE 64 experts top-6 (kimi/moonlight lineage).
[hf:moonshotai/Moonlight-16B-A3B; hf]

With the assigned 48 layers (upstream Moonlight has 27) the total
parameter count is ~28 B; activated per token stays ~3 B (top-6 of 64),
matching the a3b label.  The assigned layer count takes precedence."""

from repro_torch.configs.common import ArchDef, attn_block, shrink_lm, standard_shapes
from repro_torch.models.lm import LMConfig, StackSegment
from repro_torch.models.moe import MoECfg

D = 2048


def arch() -> ArchDef:
    blk = attn_block(d_model=D, heads=16, kv_heads=16, d_ff=0, act="silu", gated=True,
                     moe=MoECfg(num_experts=64, top_k=6, d_model=D, d_ff=1408))
    lm = LMConfig(name="moonshot-v1-16b-a3b", d_model=D, vocab=163840,
                  segments=(StackSegment(blk, 48),), tied_head=False)
    return ArchDef(name="moonshot-v1-16b-a3b", family="moe", lm=lm, smoke=shrink_lm(lm),
                   shapes=standard_shapes(sub_quadratic=False),
                   source="hf:moonshotai/Moonlight-16B-A3B; hf")
