"""xlstm-1.3b [ssm]: 48 blocks d=2048, 4 heads, d_ff=0 (mixer-internal
projections), vocab=50304, xLSTM[7:1]: 7 mLSTM blocks per 1 sLSTM block.
[arXiv:2405.04517; unverified]

Recurrent state is O(1) per layer, so long_500k runs.  As in the
reference, the mLSTM input gate is a sigmoid (the paper's exponential gate
with its stabilizer is kept for sLSTM, where it is exact)."""

from repro_torch.configs.common import ArchDef, shrink_lm, standard_shapes
from repro_torch.models.blocks import BlockCfg
from repro_torch.models.lm import LMConfig, StackSegment

D = 2048


def arch() -> ArchDef:
    mlstm = BlockCfg(kind="mlstm", d_model=D, ssm_heads=4, expand=2)
    slstm = BlockCfg(kind="slstm", d_model=D, ssm_heads=4)
    lm = LMConfig(name="xlstm-1.3b", d_model=D, vocab=50304,
                  segments=(StackSegment(mlstm, 7), StackSegment(slstm, 1)), repeats=6,
                  tied_head=True)
    return ArchDef(name="xlstm-1.3b", family="ssm", lm=lm, smoke=shrink_lm(lm),
                   shapes=standard_shapes(sub_quadratic=True),
                   source="arXiv:2405.04517; unverified")
