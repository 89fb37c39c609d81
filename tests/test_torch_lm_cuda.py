"""The port's LM training step on the card against the same step on the CPU.

Marked `cuda`: it needs an NVIDIA GPU with nvcc and skips without one.  It
imports nothing of JAX, so it runs on a machine with a card alone:

    PYTHONPATH=src python -m pytest tests/test_torch_lm_cuda.py -q

Three HKV steps of the qwen2-0.5b smoke config in float32, from the same
parameters (the port's own draws): on the card through the table's
kernels and SDPA, on the CPU through the plain paths and the blocked
attention.  Table keys, digests and scores are held exactly.  The loss
within a relative 2e-5, each table row within 1e-4 of its largest element
and the parameters within an absolute 2e-5: the card's matrix products,
SDPA's float32 kernels and its atomics sum in other orders than the CPU,
and adamw turns a coordinate whose gradient is at that noise into a step
of up to lr = 3e-4 (the largest difference from the JAX package seen on
the CPU, under the same rounding, is 7e-6).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import ShardedHKVTable, convert, make_dev_mesh, tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.embedding import HKVEmbedding, SparseOptimizer  # noqa: E402
from repro_torch.launch.train import hkv_capacity  # noqa: E402
from repro_torch.models.lm import CompositeLM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.step import StepBuilder  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_hkv_steps_on_the_card_equal_the_cpu(card):
    cfg = dataclasses.replace(get_arch("qwen2-0.5b").smoke, embedding_backend="hkv",
                              tied_head=False)
    params0 = CompositeLM(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(40)
    batches = [(rng.integers(0, cfg.vocab, size=(2, 32)), rng.integers(0, cfg.vocab, size=(2, 32)))
               for _ in range(3)]
    runs = []
    for dev in (torch.device("cpu"), card):
        table = ShardedHKVTable.create(
            make_dev_mesh(1, 1, device=dev),
            HKVEmbedding(capacity=hkv_capacity(cfg.vocab), dim=cfg.d_model,
                         optimizer=SparseOptimizer("rowwise_adagrad", lr=0.05)))
        params = tree.map(lambda p: p.to(dev), params0)
        builder, state = StepBuilder(CompositeLM(cfg), adamw()), adamw().init(params)
        losses = []
        for toks, labels in batches:
            params, state, table, met = builder.train_step_hkv(params, state, table, {
                "tokens": torch.from_numpy(toks).to(dev), "labels": torch.from_numpy(labels).to(dev)})
            assert int(met["emb_overflow"]) == 0
            losses.append(float(met["loss"]))
        runs.append((losses, params, convert.sharded_state_to_arrays(table.state)))
    (lc, pc, sc), (lg, pg, sg) = runs
    np.testing.assert_allclose(lg, lc, rtol=2e-5)
    for a, b in zip(tree.leaves(pg), tree.leaves(pc)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=2e-5)
    for f in ("key_hi", "key_lo", "digests", "score_hi", "score_lo"):
        np.testing.assert_array_equal(sg[f], sc[f], err_msg=f)
    scale = np.maximum(np.abs(sc["values"]).max(axis=1), 1e-30)
    assert (np.abs(sg["values"] - sc["values"]).max(axis=1) <= 1e-4 * scale).all()
