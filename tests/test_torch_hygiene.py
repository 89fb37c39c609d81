"""Rules the port keeps: it imports nothing of JAX or of the JAX package,
it runs on the card unless asked for the CPU, and no kernel wrapper falls
back to its plain version for a tensor that is not on the CPU."""

import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import SweepPredicate  # noqa: E402
from repro_torch.kernels import digest_scan, find_scan, gather, scatter  # noqa: E402
from repro_torch.kernels import score_scan, sweep_scan, update_scan, upsert_scan  # noqa: E402
from repro_torch.embedding import DenseEmbedding, HKVEmbedding, SparseOptimizer  # noqa: E402
from repro_torch.models.dlrm import DLRM  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_files_were_found():
    assert len(PORT_FILES) > 10 and (ROOT / "chip_smoke.py").exists()
    port = ROOT / "src" / "repro_torch"
    for path in (port / "distributed" / "__init__.py", port / "distributed" / "table_sharding.py",
                 port / "launch" / "mesh.py"):
        assert path in PORT_FILES, path


def test_sharded_entry_points_raise_without_a_card(monkeypatch):
    """A mesh defaults to the card and raises without one; a mesh of CPU
    devices makes a sharded table on the CPU."""
    from repro_torch import ShardedHKVTable, make_dev_mesh, make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: make_dev_mesh(2, 4), lambda: make_mesh((8,), ("data",)),
                 lambda: make_dev_mesh(1, 2, device=["cpu", "cuda:0"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    t = ShardedHKVTable.create(make_dev_mesh(2, 4, device="cpu"), capacity=8 * 128, dim=4)
    assert t.n_shards == 8 and all(s.device.type == "cpu" for s in t.shards)
    assert t.size() == 0


def test_create_without_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.HKVTable.create(capacity=128, dim=4)
    with pytest.raises(RuntimeError):
        convert.state_from_arrays({})
    assert repro_torch.HKVTable.create(capacity=128, dim=4, device="cpu").size() == 0


def test_training_entry_points_raise_without_a_card(monkeypatch):
    """HKVEmbedding.create, DenseEmbedding and DLRM default to the card and
    raise without one; device='cpu' works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    emb = HKVEmbedding(capacity=256, dim=4)
    for make in (emb.create, lambda: DenseEmbedding(10, 4), lambda: DLRM(4, num_sparse=3)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert emb.create(device="cpu").state.values.shape == (256, 5)
    assert DLRM(4, num_sparse=3, device="cpu").top1.shape == (4 + 6, 64)
    assert DenseEmbedding(10, 4, device="cpu").table.shape == (10, 4)


def test_hmem_tier_is_refused(monkeypatch):
    """The 'hmem' tier was refused until the tier hierarchy was ported; it
    is placed as stated now: on the CPU a plain CPU tensor, as the
    reference's CPU container keeps it (on the card pinned host memory,
    held in tests/test_torch_cuda.py), and like every entry point it
    defaults to the card and raises without one."""
    t = repro_torch.HKVTable.create(capacity=128, dim=4, device="cpu", value_tier="hmem")
    assert t.state.values.device.type == "cpu" and t.state.values.shape == (128, 4)
    assert not t.state.host_values and not t.state.values.any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.HKVTable.create(capacity=128, dim=4, value_tier="hmem")


def test_wrappers_do_not_fall_back_off_the_cpu():
    """A tensor on another device than the CPU goes to the kernel or
    raises; it never takes the plain version."""
    meta = lambda *shape, dt=torch.int64: torch.empty(shape, dtype=dt, device="meta")
    planes = (meta(1, 128, dt=torch.uint8), meta(1, 128), meta(1, 128))
    q = (meta(4), meta(4), meta(4, dt=torch.uint8), meta(4))
    with pytest.raises(ValueError, match="unsupported device"):
        find_scan.find_scan(*planes, meta(128, 4, dt=torch.float32), *q)
    with pytest.raises(ValueError, match="unsupported device"):
        upsert_scan.upsert_probe(*planes, *q)
    with pytest.raises(ValueError, match="unsupported device"):
        upsert_scan.claim_scan(planes[1], planes[2], meta(4), meta(4))
    with pytest.raises(ValueError, match="unsupported device"):
        scatter.scatter_rows(meta(128, 4, dt=torch.float32), meta(4),
                             meta(4, 4, dt=torch.float32), meta(4, dt=torch.bool), False)
    with pytest.raises(ValueError, match="unsupported device"):
        gather.gather_rows(meta(128, 4, dt=torch.float32), meta(4), meta(4, dt=torch.bool))
    with pytest.raises(ValueError, match="unsupported device"):
        digest_scan.digest_scan(planes[0], planes[1], q[0], q[2], q[3])
    with pytest.raises(ValueError, match="unsupported device"):
        sweep_scan.sweep_match(planes[1], planes[2], SweepPredicate.always())
    with pytest.raises(ValueError, match="unsupported device"):
        update_scan.update_scan(planes[0], planes[1], meta(128, 4, dt=torch.float32), q[0],
                                q[1], q[2], q[3], meta(4, dt=torch.bool),
                                meta(4, 4, dt=torch.float32), SparseOptimizer("sgd"), 4)
    with pytest.raises(ValueError, match="unsupported device"):
        score_scan.bucket_stats(planes[1], planes[2])


def test_serving_entry_points_raise_without_a_card(monkeypatch, capsys):
    """The serving path runs on the card: an engine over a table made
    without `device`, and the serve launcher without `--device cpu`, raise
    where there is none; `--device cpu` runs."""
    from repro_torch.launch import serve
    from repro_torch.serving import OnlineEmbeddingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnlineEmbeddingEngine(repro_torch.HKVTable.create(capacity=128, dim=4), wave_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnlineEmbeddingEngine(repro_torch.TieredHKVTable.create(
            hot_capacity=128, cold_capacity=256, dim=4), wave_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke", "--waves", "1"])
    assert serve.main(["--device", "cpu", "--smoke", "--waves", "2", "--wave-size", "8"]) == 0
    assert "[serve] 2 waves" in capsys.readouterr().out


def test_multi_table_find_and_baselines_do_not_fall_back_or_default_to_the_cpu(monkeypatch):
    """find_scan's multi-table entry goes to its kernel or raises off the
    CPU; the dictionary baselines, like every entry point, default to the
    card and raise without one."""
    from repro_torch.baselines import DictKVTable

    meta = lambda *shape, dt=torch.int64: torch.empty(shape, dtype=dt, device="meta")
    planes = [(meta(1, 128, dt=torch.uint8), meta(1, 128), meta(1, 128),
               meta(128, 4, dt=torch.float32))]
    with pytest.raises(ValueError, match="unsupported device"):
        find_scan.find_scan_many(planes, meta(4), meta(4), meta(4, dt=torch.uint8), meta(4), [4])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (DictKVTable.open_addressing, DictKVTable.bucketed_p2c):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(256, 4)
        assert make(256, 4, device="cpu").size() == 0


def test_lm_entry_points_raise_without_a_card(monkeypatch):
    """The LM stack runs on the card: a model's parameters, carried JAX
    parameters and the train launcher default to it and raise where there
    is none; 'cpu' and 'meta' work, and the card's attention is the
    library call."""
    import numpy as np

    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.models.common import attention_impl
    from repro_torch.models.lm import CompositeLM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = CompositeLM(get_arch("qwen2-0.5b").smoke)
    for make in (model.init, lambda: convert.lm_params_from_jax({"w": np.zeros(2, np.float32)}),
                 lambda: train.main(["--smoke", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert model.init(device="cpu")["final_norm"].device.type == "cpu"
    assert model.init(device="meta")["final_norm"].device.type == "meta"
    assert train.parse_args([]).device == "cuda"
    assert (attention_impl("cuda"), attention_impl("cpu")) == ("sdpa", "blocked")
