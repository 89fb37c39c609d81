"""musicgen-medium [audio]: 48L d=1536 24H (MHA kv=24) d_ff=6144 vocab=2048,
decoder-only over EnCodec tokens, sinusoidal positions, GELU FFN (ungated),
no RoPE. [arXiv:2306.05284; hf]

The EnCodec tokenizer and delay-pattern frontend are a stub, as in the
reference: the backbone consumes one pre-flattened codebook token stream
(vocab 2048); the text-conditioning cross-attention is left out."""

from repro_torch.configs.common import ArchDef, attn_block, shrink_lm, standard_shapes
from repro_torch.models.lm import LMConfig, StackSegment


def arch() -> ArchDef:
    blk = attn_block(d_model=1536, heads=24, kv_heads=24, d_ff=6144, rope="none", act="gelu",
                     gated=False)
    lm = LMConfig(name="musicgen-medium", d_model=1536, vocab=2048,
                  segments=(StackSegment(blk, 48),), tied_head=False,
                  pos_embedding="sinusoidal")
    return ArchDef(name="musicgen-medium", family="audio", lm=lm, smoke=shrink_lm(lm),
                   shapes=standard_shapes(sub_quadratic=False), source="arXiv:2306.05284; hf")
