"""What the benchmark may load and read: no module of the JAX stack or
the JAX package `repro` (top-level names compared whole: the port's name
begins with the JAX package's), nothing of the program in the reference,
nothing of the reference's benchmark folder; and the command exits with
no result where it has no program or no card."""

from __future__ import annotations

import ast
import pathlib
import shutil
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FILES = sorted(BENCH.rglob("*.py"))
JAX_FOLDER = "benchmarks"


def _imported(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not _imported(path) & {"jax", "jaxlib", "flax", "repro", JAX_FOLDER}
    assert JAX_FOLDER + "/" not in path.read_text()


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert _imported(path) <= {"__future__", "torch", "typing", "hkvbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith("hkvbench"):
            assert node.module.startswith("hkvbench.reference")


def _run(cwd: pathlib.Path):
    return subprocess.run([sys.executable, "hkvbench/run.py", "--workload", "hkv_b.find_zipf",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=120)


def test_without_the_program_there_is_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "hkvbench", ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout == ""


def test_without_a_card_there_is_no_result(cuda_absent):
    r = _run(ROOT)
    assert r.returncode == 2 and r.stdout == ""


@pytest.fixture
def cuda_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
