"""yi-6b [dense]: 32L d=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-arch GQA, untied head, rope theta 5e6. [arXiv:2403.04652; hf]"""

from repro_torch.configs.common import ArchDef, attn_block, shrink_lm, standard_shapes
from repro_torch.models.lm import LMConfig, StackSegment


def arch() -> ArchDef:
    blk = attn_block(d_model=4096, heads=32, kv_heads=4, d_ff=11008, rope_theta=5e6,
                     act="silu", gated=True)
    lm = LMConfig(name="yi-6b", d_model=4096, vocab=64000,
                  segments=(StackSegment(blk, 32),), tied_head=False)
    return ArchDef(name="yi-6b", family="dense", lm=lm, smoke=shrink_lm(lm),
                   shapes=standard_shapes(sub_quadratic=False), source="arXiv:2403.04652; hf")
