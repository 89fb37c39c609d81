"""qwen2-0.5b [dense]: 24L d=896 14H (GQA kv=2) d_ff=4864 vocab=151936,
QKV bias, tied embeddings, rope theta 1e6. [arXiv:2407.10671; hf]"""

from repro_torch.configs.common import ArchDef, attn_block, shrink_lm, standard_shapes
from repro_torch.models.lm import LMConfig, StackSegment


def arch() -> ArchDef:
    blk = attn_block(d_model=896, heads=14, kv_heads=2, d_ff=4864, qkv_bias=True,
                     rope_theta=1e6, act="silu", gated=True)
    lm = LMConfig(name="qwen2-0.5b", d_model=896, vocab=151936,
                  segments=(StackSegment(blk, 24),), tied_head=True)
    return ArchDef(name="qwen2-0.5b", family="dense", lm=lm, smoke=shrink_lm(lm),
                   shapes=standard_shapes(sub_quadratic=False), source="arXiv:2407.10671; hf")
