"""Checker: kernel parity, every CUDA kernel entry bound, planned and held.

The reference's ``kernel-contracts`` and its registry trace each Pallas
kernel and walk its jaxpr; a CUDA C++ source has no such graph.  What the
port can check instead is that no kernel goes unheld.  Each ``extern "C"``
entry ``hkv_<name>`` in ``src/repro_torch/csrc/*.cu`` needs:

  unbound-kernel        a wrapper in ``repro_torch/kernels/`` that launches
                        it (``_build.launch(<name>, ...)``, the name given
                        as a string or a module constant);
  no-plain-version      a plain PyTorch version of the same function beside
                        the wrapper, named ``<wrapper>_plain``;
  no-parity-test        a ``cuda``-marked test in ``tests/test_torch_*.py``
                        that calls both the wrapper and its plain version;
  not-in-chip-smoke     a row in ``chip_smoke.py``'s kernel list
                        (``kernel_rows``), which holds the kernel against
                        its plain version on the card.

``EXEMPT`` lists entries that launch no kernel, each with its reason;
``stale-exemption`` flags an exemption whose entry is gone.
"""

from __future__ import annotations

import ast
import pathlib
import re

from repro_torch.analysis.findings import Finding

CHECKER = "kernel-parity"

# entry -> reason: reviewed decisions that an entry has nothing to hold
EXEMPT: dict[str, str] = {
    name: "csrc/host_memory.cu allocates pinned host memory for the 'hmem' tier and reads "
          "device attributes: it launches no kernel and computes no function a plain version "
          "could be held against"
    for name in ("host_alloc", "host_free", "host_device_pointer", "device_attribute")}

_ENTRY = re.compile(r'extern\s+"C"\s+\w+\s+hkv_(\w+)\s*\(')


def repo_root() -> pathlib.Path:
    # .../src/repro_torch/analysis/kernel_parity.py -> the repository
    return pathlib.Path(__file__).resolve().parents[3]


def kernel_entries(csrc: pathlib.Path) -> dict:
    """entry name (without ``hkv_``) -> (repository-relative file, line)."""
    out = {}
    for path in sorted(csrc.glob("*.cu")):
        text = path.read_text()
        for m in _ENTRY.finditer(text):
            out[m.group(1)] = (_rel(path), text.count("\n", 0, m.start()) + 1)
    return out


def _rel(path: pathlib.Path) -> str:
    try:
        return path.resolve().relative_to(repo_root()).as_posix()
    except ValueError:
        return path.as_posix()


def _launch_name(call: ast.Call, consts: dict):
    """The kernel a ``_build.launch(...)`` / ``launch(...)`` call names."""
    f = call.func
    if not ((isinstance(f, ast.Attribute) and f.attr == "launch")
            or (isinstance(f, ast.Name) and f.id == "launch")) or not call.args:
        return None
    a = call.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return a.value
    if isinstance(a, ast.Name):
        return consts.get(a.id)
    return None


def wrappers(kernels: pathlib.Path) -> dict:
    """kernel name -> (wrapper, its module's function names, file, line)."""
    out = {}
    for path in sorted(kernels.glob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        consts = {t.id: n.value.value for n in tree.body if isinstance(n, ast.Assign)
                  and isinstance(n.value, ast.Constant) and isinstance(n.value.value, str)
                  for t in n.targets if isinstance(t, ast.Name)}
        funcs = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
        for fn in tree.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Call):
                    name = _launch_name(sub, consts)
                    if name is not None:
                        out.setdefault(name, (fn.name, funcs, _rel(path), fn.lineno))
    return out


def _is_cuda_mark(node) -> bool:
    """``pytest.mark.cuda`` (or a list holding it)."""
    if isinstance(node, (ast.List, ast.Tuple)):
        return any(_is_cuda_mark(e) for e in node.elts)
    return isinstance(node, ast.Attribute) and node.attr == "cuda"


def cuda_tests(tests: pathlib.Path) -> list:
    """(file, test name, names it references) of every cuda-marked test."""
    out = []
    for path in sorted(tests.glob("test_torch_*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        module_cuda = any(isinstance(n, ast.Assign) and _is_cuda_mark(n.value)
                          and any(isinstance(t, ast.Name) and t.id == "pytestmark"
                                  for t in n.targets) for n in tree.body)
        for fn in tree.body:
            if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test")):
                continue
            if not (module_cuda or any(_is_cuda_mark(d) for d in fn.decorator_list)):
                continue
            names = {s.id for s in ast.walk(fn) if isinstance(s, ast.Name)}
            names |= {s.attr for s in ast.walk(fn) if isinstance(s, ast.Attribute)}
            out.append((_rel(path), fn.name, names))
    return out


def smoke_kernels(chip_smoke: pathlib.Path) -> set:
    """The kernel names of ``chip_smoke.py``'s kernel list: the string keys
    of the dict literals in its ``kernel_rows``."""
    tree = ast.parse(chip_smoke.read_text(), filename=str(chip_smoke))
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "kernel_rows":
            return {k.value for d in ast.walk(node) if isinstance(d, ast.Dict)
                    for k in d.keys if isinstance(k, ast.Constant) and isinstance(k.value, str)}
    return set()


def check_kernel_parity(csrc=None, kernels=None, tests=None, chip_smoke=None,
                        exempt=None) -> list[Finding]:
    root = repo_root()
    csrc = pathlib.Path(csrc or root / "src/repro_torch/csrc")
    kernels = pathlib.Path(kernels or root / "src/repro_torch/kernels")
    tests = pathlib.Path(tests or root / "tests")
    chip_smoke = pathlib.Path(chip_smoke or root / "chip_smoke.py")
    exempt = EXEMPT if exempt is None else exempt
    entries = kernel_entries(csrc)
    wraps = wrappers(kernels)
    held = cuda_tests(tests)
    smoke = smoke_kernels(chip_smoke) if chip_smoke.exists() else set()
    out = []
    for name, (path, line) in sorted(entries.items()):
        if name in exempt:
            continue

        def finding(rule, msg):
            out.append(Finding(CHECKER, rule, f"hkv_{name}", msg, path=path, line=line))

        if name not in wraps:
            finding("unbound-kernel", "no wrapper in repro_torch/kernels launches this entry "
                    "(_build.launch): a kernel nothing calls has no plain version, parity "
                    "test or smoke row either")
            continue
        wrapper, funcs, wpath, _ = wraps[name]
        plain = f"{wrapper}_plain"
        if plain not in funcs:
            finding("no-plain-version", f"{wpath} defines {wrapper} but no {plain}: the plain "
                    "PyTorch version is the CPU path and the parity reference")
        elif not any(wrapper in names and plain in names for _, _, names in held):
            finding("no-parity-test", f"no cuda-marked test in tests/test_torch_*.py calls "
                    f"both {wrapper} and {plain}")
        if name not in smoke:
            finding("not-in-chip-smoke", f"chip_smoke.py's kernel list (kernel_rows) has no "
                    f"row {name!r}")
    for name, why in sorted(exempt.items()):
        if name not in entries:
            out.append(Finding(CHECKER, "stale-exemption", f"hkv_{name}",
                               f"EXEMPT lists an entry no source defines (its reason was "
                               f"{why!r}): prune it",
                               path="src/repro_torch/analysis/kernel_parity.py"))
    return out
