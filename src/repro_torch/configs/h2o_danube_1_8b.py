"""h2o-danube-1.8b [dense]: 24L d=2560 32H (GQA kv=8) d_ff=6912 vocab=32000,
llama+mistral mix with sliding-window attention (window 4096).
[arXiv:2401.16818; hf]

SWA bounds the decode KV state to the window, so the long_500k cell runs
(a ring-buffer cache of 4096 a layer)."""

from repro_torch.configs.common import ArchDef, attn_block, shrink_lm, standard_shapes
from repro_torch.models.lm import LMConfig, StackSegment

WINDOW = 4096


def arch() -> ArchDef:
    blk = attn_block(d_model=2560, heads=32, kv_heads=8, d_ff=6912, window=WINDOW,
                     act="silu", gated=True)
    lm = LMConfig(name="h2o-danube-1.8b", d_model=2560, vocab=32000,
                  segments=(StackSegment(blk, 24),), tied_head=False)
    return ArchDef(name="h2o-danube-1.8b", family="dense", lm=lm, smoke=shrink_lm(lm),
                   shapes=standard_shapes(sub_quadratic=True),  # SWA: bounded state
                   source="arXiv:2401.16818; hf")
