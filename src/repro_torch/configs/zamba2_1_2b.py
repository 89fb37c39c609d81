"""zamba2-1.2b [hybrid]: 38 Mamba2 layers d=2048 ssm_state=64 + one SHARED
full-attention block (32H MHA, d_ff=8192) invoked every 6 layers with the
same parameters (Zamba2's weight-shared global block; the per-invocation
LoRA deltas are left out, as in the reference). vocab=32000.
[arXiv:2411.15242; hf]

Structure: prelude (mamba2 x 2) + 6 x [mamba2 x 6, shared attn] = 38 mamba
layers + 6 invocations of the shared block.  Recurrent state is O(1) per
layer, so long_500k runs."""

from repro_torch.configs.common import ArchDef, attn_block, shrink_lm, standard_shapes
from repro_torch.models.blocks import BlockCfg
from repro_torch.models.lm import LMConfig, StackSegment

D = 2048


def arch() -> ArchDef:
    mamba = BlockCfg(kind="mamba2", d_model=D, d_state=64, ssm_heads=64, expand=2, conv_width=4)
    shared_attn = attn_block(d_model=D, heads=32, kv_heads=32, d_ff=8192, act="gelu",
                             gated=False)
    lm = LMConfig(name="zamba2-1.2b", d_model=D, vocab=32000,
                  prelude=(StackSegment(mamba, 2),),
                  segments=(StackSegment(mamba, 6), StackSegment(shared_attn, 1, shared=True)),
                  repeats=6, tied_head=True)
    return ArchDef(name="zamba2-1.2b", family="hybrid", lm=lm, smoke=shrink_lm(lm),
                   shapes=standard_shapes(sub_quadratic=True), source="arXiv:2411.15242; hf")
