"""qwen2-vl-2b [vlm]: 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
M-RoPE, QKV bias, tied embeddings. [arXiv:2409.12191; hf]

The vision frontend is a stub, as in the reference: a batch carries
precomputed patch embeddings [B, vision_tokens, d] (`frontend_embeds`)
that replace the first vision_tokens positions, and M-RoPE position ids
[3, B, S] (`mrope_positions`, the t/h/w components)."""

from repro_torch.configs.common import ArchDef, attn_block, shrink_lm, standard_shapes
from repro_torch.models.lm import LMConfig, StackSegment


def arch() -> ArchDef:
    blk = attn_block(d_model=1536, heads=12, kv_heads=2, d_ff=8960, qkv_bias=True,
                     rope="mrope", rope_theta=1e6, act="silu", gated=True)
    lm = LMConfig(name="qwen2-vl-2b", d_model=1536, vocab=151936,
                  segments=(StackSegment(blk, 28),), tied_head=True, frontend="vision")
    return ArchDef(name="qwen2-vl-2b", family="vlm", lm=lm, smoke=shrink_lm(lm),
                   shapes=standard_shapes(sub_quadratic=False), vision_tokens=256,
                   source="arXiv:2409.12191; hf")
