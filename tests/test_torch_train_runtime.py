"""The port's training runtime (``repro_torch.data``, ``repro_torch.train``
and ``repro_torch.launch.train``) against the JAX package's.

  * TokenStream bit for bit against the reference's, and mirrors of its
    `TestData` (determinism, rank slicing, the prefetcher's cursor).
  * Checkpoints: mirrors of `TestCheckpoint`; table checkpoints across the
    packages both ways, flat and tiered (the JAX package's ``save_table``
    restored by the port's ``restore_table`` and back), every leaf bit for
    bit, and the structure check; a sharded table's shards behind one
    rename, in the JAX layout.
  * TrainDriver: mirrors of `TestDriver`, and a restart of a state that
    holds a table (restored bit for bit, the pristine copy untouched).
  * The launcher at --smoke on the CPU: both backends, every optimizer, the
    tiered table and an injected failure (the run after a restore equals
    the uninterrupted one: the CPU's arithmetic is deterministic).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.api import HKVTable as JHKVTable  # noqa: E402
from repro.core.tiered import TieredHKVTable as JTiered  # noqa: E402
from repro.data import TokenStream as JTokenStream  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import HKVTable, ShardedHKVTable, TieredHKVTable, convert, make_dev_mesh  # noqa: E402
from repro_torch.data import DataCursor, HostPrefetcher, TokenStream  # noqa: E402
from repro_torch.embedding import HKVEmbedding, SparseOptimizer  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.driver import StepTimeout, TrainDriver  # noqa: E402


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _keys(rng, n):
    return rng.integers(0, 2**50, size=n).astype(np.uint64)


# =============================================================================
# Data
# =============================================================================


@pytest.mark.parametrize("seed,batch,seq,vocab,alpha,rank,world,step", [
    (7, 4, 16, 1000, 1.0, 0, 2, 3), (7, 4, 16, 1000, 1.0, 1, 2, 3), (0, 2, 32, 512, 1.0, 0, 1, 0),
    (3, 8, 4096 // 64, 151936, 1.0, 0, 1, 11), (5, 3, 9, 50, 0.8, 2, 4, 7)])
def test_token_stream_equals_the_reference(seed, batch, seq, vocab, alpha, rank, world, step):
    kw = dict(seed=seed, batch=batch, seq=seq, vocab=vocab, alpha=alpha, rank=rank, world=world)
    got, want = TokenStream(**kw).batch_at(step), JTokenStream(**kw).batch_at(step)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_token_stream_deterministic_and_sharded():
    s0 = TokenStream(seed=7, batch=4, seq=16, vocab=1000, rank=0, world=2)
    s1 = TokenStream(seed=7, batch=4, seq=16, vocab=1000, rank=1, world=2)
    a0, l0 = s0.batch_at(3)
    np.testing.assert_array_equal(a0, s0.batch_at(3)[0])
    assert not np.array_equal(a0, s1.batch_at(3)[0])
    np.testing.assert_array_equal(l0[:, :-1], a0[:, 1:])
    it = iter(s0)
    np.testing.assert_array_equal(next(it)[0], s0.batch_at(0)[0])


def test_prefetcher_resumes_from_cursor():
    pf = HostPrefetcher(lambda step: step * 10, DataCursor(seed=0, step=5), depth=2)
    seen = [next(pf) for _ in range(3)]
    pf.close()
    assert seen == [50, 60, 70]
    assert pf.cursor.step == 8
    assert not pf._thread.is_alive()
    assert DataCursor.from_dict(pf.cursor.to_dict()) == pf.cursor


# =============================================================================
# Checkpoints
# =============================================================================


def test_atomic_roundtrip(tmp_path):
    tree = {"a": torch.arange(10), "b": {"c": torch.ones((3, 4))}, "d": [None, torch.zeros(2)]}
    ckpt.save(str(tmp_path), 7, tree, extra={"seed": 1, "step": 7})
    assert ckpt.latest_step(str(tmp_path)) == 7
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    restored, extra = ckpt.restore(str(tmp_path), 7, tree)
    assert extra == {"seed": 1, "step": 7}
    assert restored["d"][0] is None
    for a, b in ((tree["a"], restored["a"]), (tree["b"]["c"], restored["b"]["c"]),
                 (tree["d"][1], restored["d"][1])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_np(a), _np(b))


def test_plain_tree_crosses_both_ways(tmp_path):
    """A tree of arrays written by either package restores in the other, in
    the same leaf order (dict keys sorted)."""
    jtree = {"z": jnp.arange(6, dtype=jnp.int32), "a": {"c": jnp.ones((3, 4)), "b": jnp.zeros(2)}}
    jckpt.save(str(tmp_path / "j"), 1, jtree)
    ttree = jax.tree.map(lambda x: torch.from_numpy(np.array(x)) * 0, jtree)
    restored, _ = ckpt.restore(str(tmp_path / "j"), 1, ttree)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(jax.tree.map(_np, restored))):
        np.testing.assert_array_equal(np.asarray(a), b)
    ckpt.save(str(tmp_path / "t"), 2, restored)
    back, _ = jckpt.restore(str(tmp_path / "t"), 2, jtree)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_gc_keeps_last_three(tmp_path):
    for s in range(5):
        ckpt.save(str(tmp_path), s, {"x": torch.zeros(2)})
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(steps) == 3
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_async_then_restore(tmp_path):
    tree = {"x": torch.arange(5)}
    pending = ckpt.save_async(str(tmp_path), 3, tree, extra={"seed": 0, "step": 3})
    tree["x"] += 100           # the host copy was taken before save_async returned
    ckpt.wait_async()
    assert pending.nbytes == 5 * 8 and pending.write_s is not None and pending.error is None
    restored, _ = ckpt.restore(str(tmp_path), 3, tree)
    np.testing.assert_array_equal(_np(restored["x"]), np.arange(5))


def test_async_write_error_surfaces(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ckpt.save_async(str(blocker), 1, {"x": torch.zeros(2)})
    with pytest.raises(OSError):
        ckpt.wait_async()


def _jflat(rng):
    t = JHKVTable.create(capacity=2 * 128, dim=4, score_policy="lfu")
    return t.insert_or_assign(_keys(rng, 200), jnp.asarray(rng.normal(size=(200, 4)),
                                                           jnp.float32)).table


def _jtiered(rng):
    t = JTiered.create(hot_capacity=128, cold_capacity=4 * 128, dim=3)
    for _ in range(3):
        t = t.insert_or_assign(_keys(rng, 128),
                               jnp.asarray(rng.normal(size=(128, 3)), jnp.float32)).table
    return t


def _port_twin(jt):
    if isinstance(jt, JTiered):
        return TieredHKVTable.create(hot_capacity=jt.hot.capacity, cold_capacity=jt.cold.capacity,
                                     dim=jt.hot.dim, device="cpu")
    return HKVTable.create(capacity=jt.capacity, dim=jt.dim,
                           score_policy=jt.cfg.score_policy, device="cpu")


def _port_leaves(t):
    if isinstance(t, TieredHKVTable):
        return [a for tier in (t.hot, t.cold) for a in _port_leaves(tier)]
    arrays = convert.state_to_arrays(t.state)
    return [arrays[f] for f in convert.FIELDS]


@pytest.mark.parametrize("make", [_jflat, _jtiered], ids=["flat", "tiered"])
def test_table_checkpoint_crosses_both_ways(tmp_path, make):
    rng = np.random.default_rng(9)
    jt = make(rng)
    jckpt.save_table(str(tmp_path / "j"), 7, jt)
    port = _port_twin(jt)
    restored, extra = ckpt.restore_table(str(tmp_path / "j"), 7, port)
    assert extra["table"] == ckpt._table_manifest(port)
    want = jax.tree.leaves(jt)
    got = _port_leaves(restored)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    # the port's save restores in the JAX package
    ckpt.save_table(str(tmp_path / "t"), 8, restored)
    back, extra = jckpt.restore_table(str(tmp_path / "t"), 8, jt)
    assert extra["table"]["kind"] == type(jt).__name__
    for a, b in zip(want, jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restored_table_serves(tmp_path):
    rng = np.random.default_rng(0)
    keys = _keys(rng, 200)
    t = HKVTable.create(capacity=2 * 128, dim=4, score_policy="lfu", device="cpu")
    t.insert_or_assign(keys, torch.ones((200, 4)))
    ckpt.save_table(str(tmp_path), 1, t)
    restored, _ = ckpt.restore_table(str(tmp_path), 1, t.snapshot().clear())
    for a, b in zip(_port_leaves(t), _port_leaves(restored)):
        np.testing.assert_array_equal(a, b)
    found = restored.find(keys).found
    np.testing.assert_array_equal(found.numpy(), t.find(keys).found.numpy())
    assert restored.state is not t.state


def test_table_structure_mismatch_rejected(tmp_path):
    t = TieredHKVTable.create(hot_capacity=128, cold_capacity=4 * 128, dim=3, device="cpu")
    ckpt.save_table(str(tmp_path), 1, t)
    other = TieredHKVTable.create(hot_capacity=4 * 128, cold_capacity=128, dim=3, device="cpu")
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore_table(str(tmp_path), 1, other)
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore_table(str(tmp_path), 1, HKVTable.create(capacity=128, dim=3, device="cpu"))


@pytest.mark.parametrize("hot", [None, 256], ids=["flat", "tiered"])
def test_sharded_table_checkpoint(tmp_path, hot):
    """8 shards (a (2, 4) CPU mesh) in one step directory: the JAX layout
    of the joined planes, restored shard for shard."""
    emb = HKVEmbedding(capacity=8 * 256, dim=4, hot_capacity=hot,
                       optimizer=SparseOptimizer("rowwise_adagrad", lr=0.05))
    t = ShardedHKVTable.create(make_dev_mesh(2, 4, device="cpu"), emb)
    rng = np.random.default_rng(1)
    t.insert_or_assign(_keys(rng, 512), rng.normal(size=(512, 4)).astype(np.float32))
    ckpt.save_table(str(tmp_path), 3, t)
    d = tmp_path / "step_00000003"
    n = 9 if hot is None else 18
    assert sorted(os.listdir(d)) == [f"leaf_{i:05d}.npy" for i in range(n)] + ["manifest.json"]
    joined = convert.sharded_state_to_arrays(t.state)
    parts = [joined] if hot is None else [joined["hot"], joined["cold"]]
    want = [p[f] for p in parts for f in convert.FIELDS]
    for i, w in enumerate(want):
        np.testing.assert_array_equal(np.load(d / f"leaf_{i:05d}.npy"), w)
    fresh = ShardedHKVTable.create(make_dev_mesh(2, 4, device="cpu"), emb)
    restored, _ = ckpt.restore_table(str(tmp_path), 3, fresh)
    got = convert.sharded_state_to_arrays(restored.state)
    for a, b in zip(want, [p[f] for p in ([got] if hot is None else [got["hot"], got["cold"]])
                           for f in convert.FIELDS]):
        np.testing.assert_array_equal(a, b)
    assert restored.size() == t.size() > 0


# =============================================================================
# Driver
# =============================================================================


def _driver(tmp_path, failure_injector=None, timeout=None):
    def step_fn(state, batch):
        new = state + batch
        return new, {"loss": 100.0 - new}

    return TrainDriver(step_fn=step_fn, batch_fn=lambda step: 1.0, state=torch.zeros(()),
                       ckpt_dir=str(tmp_path), cursor=DataCursor(seed=0, step=0),
                       checkpoint_every=3, failure_injector=failure_injector,
                       step_timeout=timeout, log=lambda *a: None)


def test_driver_runs_to_completion(tmp_path):
    d = _driver(tmp_path)
    hist = d.run(10)
    assert len(hist["loss"]) == 10
    assert float(d.state) == 10.0
    assert [p.step for p in hist["checkpoints"]] == [3, 6, 9, 10]


def test_driver_recovers_from_injected_failure(tmp_path):
    boom = {"armed": True}

    def injector(step):
        if step == 5 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated node failure")

    d = _driver(tmp_path, failure_injector=injector)
    hist = d.run(10)
    assert hist["restarts"] == 1
    assert [s for s, _ in hist["restores"]] == [3]
    assert float(d.state) == 10.0   # exactly as if no failure happened
    assert len(hist["loss"]) == 5 + 7   # steps 0-4, then 3-9 replayed from step 3


def test_driver_gives_up_after_max_failures(tmp_path):
    def injector(step):
        raise RuntimeError("permafail")

    d = _driver(tmp_path, failure_injector=injector)
    d.max_failures = 2
    with pytest.raises(RuntimeError, match="permafail"):
        d.run(10)


def test_driver_straggler_timeout_triggers_recovery(tmp_path):
    import time

    slow = {"armed": True}

    def injector(step):
        if step == 2 and slow["armed"]:
            slow["armed"] = False
            time.sleep(1.0)  # exceeds the 0.3 s budget -> StepTimeout

    d = _driver(tmp_path, failure_injector=injector, timeout=0.3)
    hist = d.run(5)
    assert hist["restarts"] == 1
    assert float(d.state) == 5.0
    assert issubclass(StepTimeout, Exception)


def test_driver_restarts_a_table_state(tmp_path):
    """A state that holds a table, which its steps change in place: a
    failure before the first checkpoint restarts from a fresh copy of the
    pristine state, one after it restores the table bit for bit."""
    rng = np.random.default_rng(3)
    batches = [_keys(rng, 64) for _ in range(6)]

    def run(inject_at):
        t = HKVTable.create(capacity=4 * 128, dim=2, device="cpu")
        armed = {"on": True}

        def injector(step):
            if step == inject_at and armed["on"]:
                armed["on"] = False
                raise RuntimeError("boom")

        def step_fn(state, batch):
            (w, table), keys = state, batch
            table.insert_or_assign(keys, torch.full((64, 2), float(w)))
            return (w + 1, table), {"loss": w}

        d = TrainDriver(step_fn=step_fn, batch_fn=lambda s: batches[s], state=(torch.zeros(()), t),
                        ckpt_dir=str(tmp_path / f"r{inject_at}"),
                        cursor=DataCursor(seed=0, step=0), checkpoint_every=4,
                        failure_injector=injector, log=lambda *a: None)
        hist = d.run(6)
        return d.state[1], hist

    plain, _ = run(None)
    for at in (2, 5):
        table, hist = run(at)
        assert hist["restarts"] == 1 and [s for s, _ in hist["restores"]] == [0 if at < 4 else 4]
        for a, b in zip(_port_leaves(plain), _port_leaves(table)):
            np.testing.assert_array_equal(a, b)


# =============================================================================
# The launcher at --smoke on the CPU
# =============================================================================


def _launch(tmp_path, *extra, injector=None, steps=4):
    argv = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu", "--steps", str(steps),
            "--batch", "2", "--seq", "32", "--checkpoint-every", "2",
            "--ckpt-dir", str(tmp_path), *extra]
    return train_mod.main(argv, failure_injector=injector)


@pytest.mark.parametrize("backend", ["dense", "hkv"])
@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit", "adafactor", "sgdm"])
def test_launcher_smoke(tmp_path, backend, optimizer):
    hist = _launch(tmp_path, "--backend", backend, "--optimizer", optimizer)
    assert len(hist["loss"]) == 4 and all(np.isfinite(hist["loss"]))
    assert hist["restarts"] == 0 and [p.step for p in hist["checkpoints"]] == [2, 4]
    assert abs(hist["loss"][0] - np.log(512)) < 1.0   # ~log(vocab) at init
    m = hist["metrics"][-1]
    keys = {"loss", "grad_norm", "fwd_bwd_ms", "opt_ms"}
    if backend == "hkv":
        keys |= {"lookup_ms", "apply_ms", "emb_overflow"}
        assert m["emb_overflow"] == 0
    assert keys <= set(m)


def test_launcher_hkv_hot_capacity(tmp_path):
    hist = _launch(tmp_path, "--backend", "hkv", "--hkv-hot-capacity", "256", steps=3)
    table = hist["state"][2]
    assert table.local.is_tiered and table.shards[0].hot.capacity == 256
    assert len(hist["loss"]) == 3 and all(np.isfinite(hist["loss"]))
    with pytest.raises(SystemExit):
        train_mod.parse_args(["--hkv-hot-capacity", "256"])


def test_launcher_restart_equals_the_uninterrupted_run(tmp_path):
    plain = _launch(tmp_path / "a", "--backend", "hkv", steps=6)
    armed = {"on": True}

    def injector(step):
        if step == 5 and armed["on"]:
            armed["on"] = False
            raise RuntimeError("simulated node failure")

    hurt = _launch(tmp_path / "b", "--backend", "hkv", injector=injector, steps=6)
    assert hurt["restarts"] == 1 and [s for s, _ in hurt["restores"]] == [4]
    assert hurt["loss"][:5] + hurt["loss"][-2:] == plain["loss"][:5] + plain["loss"][-2:]
    (pa, oa, ta), (pb, ob, tb) = plain["state"], hurt["state"]
    from repro_torch import tree

    for a, b in zip(tree.leaves((pa, oa)), tree.leaves((pb, ob))):
        np.testing.assert_array_equal(_np(a), _np(b))
    for a, b in zip(convert.sharded_state_to_arrays(ta.state).values(),
                    convert.sharded_state_to_arrays(tb.state).values()):
        np.testing.assert_array_equal(a, b)
