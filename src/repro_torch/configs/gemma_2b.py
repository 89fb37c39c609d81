"""gemma-2b [dense]: 18L d=2048 8H (MQA kv=1) d_ff=16384 vocab=256000,
GeGLU, head_dim=256, tied embeddings, sqrt(d) embed scale.
[arXiv:2403.08295; hf]"""

from repro_torch.configs.common import ArchDef, attn_block, shrink_lm, standard_shapes
from repro_torch.models.lm import LMConfig, StackSegment


def arch() -> ArchDef:
    blk = attn_block(d_model=2048, heads=8, kv_heads=1, head_dim=256, d_ff=16384,
                     act="gelu", gated=True)
    lm = LMConfig(name="gemma-2b", d_model=2048, vocab=256000,
                  segments=(StackSegment(blk, 18),), tied_head=True, embed_scale=True)
    return ArchDef(name="gemma-2b", family="dense", lm=lm, smoke=shrink_lm(lm),
                   shapes=standard_shapes(sub_quadratic=False), source="arXiv:2403.08295; hf")
