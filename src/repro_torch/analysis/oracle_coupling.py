"""Checker: oracle coupling, one match formula reached from everywhere
(port of ``repro/analysis/oracle_coupling.py``).

The correctness seam of the table is the key-match formula (full 64-bit
key equality, optionally digest-prefiltered) and the EMPTY-key liveness
formula.  Each lives in one place, ``core.find.match_lanes`` and
``core.u64.empty_lanes``, and every plain version routes through them
rather than re-deriving the plane math inline: a fork is how upsert and
find drift apart on, say, digest handling, which no unit test of either
side catches.  The CUDA sources are out of this checker's reach; the
kernel-parity checker and the ``cuda`` tests hold each kernel against its
plain version, which this checker ties to the oracle.

Three AST rules over ``src/repro_torch``:

  oracle-multiplicity   exactly one ``def match_lanes`` and one
                        ``def empty_lanes`` in the tree, at their sites.
  oracle-uncoupled      each module of ``REQUIRED_REFS`` reaches the oracles
                        it needs: it names one, or calls a function of
                        another port module that does, transitively.
  match-formula-fork    an ``&`` conjunction holds two equality compares
                        that re-derive the formula: hi/lo mirror images of
                        each other (the identifiers coincide once hi/lo
                        markers are erased), or a key compare beside a
                        digest compare (the port's 64-bit form).

The fork rule covers ``core/`` and ``kernels/`` but for the oracles' own
sites (``core/find.py``, ``core/u64.py``) and ``core/predicates.py``
(key_range compares against lo/hi bounds on purpose).  ``baselines/`` is
out of scope: the differential baselines stay independent.
"""

from __future__ import annotations

import ast
import pathlib

from repro_torch.analysis.findings import Finding

CHECKER = "oracle-coupling"

ORACLES = ("match_lanes", "empty_lanes")

# module (relative to src/) -> the oracles it must reach: the plain version
# of every kernel that compares keys or tests liveness, and the upsert closure
REQUIRED_REFS = {
    "repro_torch/core/find.py": ("match_lanes",),          # definition and its users
    "repro_torch/core/merge.py": ("match_lanes", "empty_lanes"),
    "repro_torch/kernels/digest_scan.py": ("match_lanes",),
    "repro_torch/kernels/find_scan.py": ("match_lanes",),
    "repro_torch/kernels/update_scan.py": ("match_lanes",),
    "repro_torch/kernels/upsert_scan.py": ("match_lanes", "empty_lanes"),
    "repro_torch/kernels/sweep_scan.py": ("empty_lanes",),
    "repro_torch/kernels/score_scan.py": ("empty_lanes",),
    "repro_torch/kernels/ops.py": ("match_lanes", "empty_lanes"),
}

_DEF_SITES = {"repro_torch/core/find.py": ("match_lanes",),
              "repro_torch/core/u64.py": ("empty_lanes",)}

_FORK_SCOPE = ("repro_torch/kernels", "repro_torch/core")
_FORK_EXEMPT = ("repro_torch/core/find.py", "repro_torch/core/u64.py",
                "repro_torch/core/predicates.py")


def src_root() -> pathlib.Path:
    # .../src/repro_torch/analysis/oracle_coupling.py -> .../src
    return pathlib.Path(__file__).resolve().parents[2]


def _tree_files(root: pathlib.Path):
    for p in sorted(root.glob("repro_torch/**/*.py")):
        rel = p.relative_to(root).as_posix()
        if rel.startswith("repro_torch/analysis/"):
            continue   # the analyzer and its bad fixtures
        yield rel, p


# -- the fork rule -------------------------------------------------------------


def _norm_ident(name: str) -> str:
    """Erase hi/lo markers so mirror compares collapse to one shape."""
    s = name.lower()
    for tok in ("hi", "lo", "h", "l"):
        s = s.replace(tok, "#")
    return s


def _compare_idents(node: ast.Compare):
    """The identifier multiset of a single == compare, else None."""
    if len(node.ops) != 1 or not isinstance(node.ops[0], ast.Eq):
        return None
    names = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            names.append(sub.id)
        elif isinstance(sub, ast.Attribute):
            names.append(sub.attr)
    return tuple(sorted(names)) if names else None


def _and_leaves(node: ast.BinOp):
    """Flatten a chain of ``&`` into its operands."""
    for side in (node.left, node.right):
        if isinstance(side, ast.BinOp) and isinstance(side.op, ast.BitAnd):
            yield from _and_leaves(side)
        else:
            yield side


def _names(idents, part: str) -> bool:
    return any(part in n.lower() for n in idents)


def scan_source(source: str, rel_path: str) -> list[Finding]:
    """The fork rule over one file's source."""
    out = []
    tree = ast.parse(source, filename=rel_path)
    claimed = set()

    def fork(leaf):
        out.append(Finding(
            CHECKER, "match-formula-fork", f"{rel_path}:{leaf.lineno}",
            "equality compares inside an '&' conjunction re-derive the key-match formula: "
            "route through core.find.match_lanes / core.u64.empty_lanes instead",
            path=f"src/{rel_path}", line=leaf.lineno))

    for node in ast.walk(tree):
        if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitAnd)):
            continue
        if id(node) in claimed:
            continue
        for sub in ast.walk(node):
            if sub is not node and isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.BitAnd):
                claimed.add(id(sub))
        shapes, key_cmp, digest_cmp = {}, None, None
        for leaf in _and_leaves(node):
            if not isinstance(leaf, ast.Compare):
                continue
            idents = _compare_idents(leaf)
            if idents is None:
                continue
            if _names(idents, "digest"):
                digest_cmp = digest_cmp or leaf
            elif _names(idents, "key"):
                key_cmp = key_cmp or leaf
            norm = tuple(_norm_ident(n) for n in idents)
            if norm == idents:
                continue   # no hi/lo marker anywhere: not split-plane math
            other = shapes.get(norm)
            if other is not None and other != idents:
                fork(leaf)
            else:
                shapes.setdefault(norm, idents)
        if key_cmp is not None and digest_cmp is not None:
            fork(digest_cmp)
    return out


def check_forks(files) -> list[Finding]:
    out = []
    for rel, path in files:
        if rel.startswith(_FORK_SCOPE) and rel not in _FORK_EXEMPT:
            out.extend(scan_source(path.read_text(), rel))
    return out


# -- multiplicity ----------------------------------------------------------------


def check_multiplicity(files) -> list[Finding]:
    out = []
    defs = {name: [] for name in ORACLES}
    for rel, path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=rel)):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name in defs:
                defs[node.name].append((rel, node.lineno))
    for name, sites in defs.items():
        expect = next(rel for rel, names in _DEF_SITES.items() if name in names)
        if len(sites) != 1:
            where = ", ".join(f"{r}:{ln}" for r, ln in sites) or "nowhere"
            out.append(Finding(CHECKER, "oracle-multiplicity", name,
                               f"expected exactly one definition of {name} (in {expect}), "
                               f"found {len(sites)}: {where}", path=f"src/{expect}"))
        elif sites[0][0] != expect:
            out.append(Finding(CHECKER, "oracle-multiplicity", name,
                               f"{name} is defined in {sites[0][0]}, expected {expect}",
                               path=f"src/{sites[0][0]}", line=sites[0][1]))
    return out


# -- coupling: the oracles each required module reaches --------------------------


class _Module:
    """One port module's top-level functions (the names each references)
    and its imports (local name -> (module, name or None for a module))."""

    def __init__(self, rel: str, source: str):
        tree = ast.parse(source, filename=rel)
        self.refs = _refs(tree)
        self.functions = {n.name: _refs(n) for n in tree.body
                          if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        self.imports: dict = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for a in node.names:
                    self.imports[a.asname or a.name] = (node.module, a.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = (a.name, None)


def _refs(node) -> set:
    """Names and (base, attribute) pairs referenced under `node`."""
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
            if isinstance(sub.value, ast.Name):
                out.add((sub.value.id, sub.attr))
    return out


def _mod_rel(module: str) -> str:
    return module.replace(".", "/") + ".py"


def reached(rel: str, modules: dict, oracle: str) -> bool:
    """Whether module `rel` names `oracle` or calls, through its imports, a
    port function that reaches it."""
    seen = set()
    stack = [(rel, modules[rel].refs)]
    while stack:
        mrel, refs = stack.pop()
        if oracle in refs:
            return True
        mod = modules[mrel]
        for r in refs:
            if isinstance(r, tuple):            # alias.attr of an imported module
                base, attr = r
                target = mod.imports.get(base)
                if target is None:
                    continue
                name, fn = (_mod_rel(target[0]), attr) if target[1] is None else (
                    _mod_rel(f"{target[0]}.{target[1]}"), attr)
            elif r in mod.imports and mod.imports[r][1] is not None:
                name, fn = _mod_rel(mod.imports[r][0]), mod.imports[r][1]
            elif r in mod.functions:
                name, fn = mrel, r
            else:
                continue
            if (name, fn) in seen or name not in modules:
                continue
            seen.add((name, fn))
            body = modules[name].functions.get(fn)
            if body is not None:
                stack.append((name, body))
    return False


def check_required_refs(files) -> list[Finding]:
    out = []
    modules = {rel: _Module(rel, path.read_text()) for rel, path in files}
    for rel, needed in sorted(REQUIRED_REFS.items()):
        if rel not in modules:
            out.append(Finding(CHECKER, "oracle-uncoupled", rel,
                               "required module is missing from the tree", path=f"src/{rel}"))
            continue
        for oracle in needed:
            if not reached(rel, modules, oracle):
                out.append(Finding(
                    CHECKER, "oracle-uncoupled", f"{rel}::{oracle}",
                    f"module must route its plane math through {oracle} but never reaches "
                    "it: an inline re-derivation (or a dead seam) slipped in",
                    path=f"src/{rel}"))
    return out


def check_oracle_coupling() -> list[Finding]:
    files = list(_tree_files(src_root()))
    return check_multiplicity(files) + check_required_refs(files) + check_forks(files)
