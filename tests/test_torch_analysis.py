"""The port's lint (``repro_torch.analysis``): every checker flags its
deliberately bad fixture, the shipped tree is clean, and the finding model
(waivers, formats) and the CLI behave (the classes of
``tests/test_analysis.py`` that carry over to the port, and the kernel
parity checker that stands where its Pallas checks stand).

A checker that never fires cannot be told from a clean tree, so each rule
is shown firing on a broken input before the cleanliness checks count.
"""

import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import findings as findings_mod  # noqa: E402
from repro_torch.analysis import kernel_parity as kp  # noqa: E402
from repro_torch.analysis import oracle_coupling as oc  # noqa: E402
from repro_torch.analysis import roles as roles_checker  # noqa: E402
from repro_torch.analysis import telemetry as tel_checker  # noqa: E402
from repro_torch.analysis.fixtures import bad_ops  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "src/repro_torch/analysis/fixtures"


def rules(fs):
    return sorted({f.rule for f in fs})


# ---------------------------------------------------------------------------
# fixtures: each checker fires
# ---------------------------------------------------------------------------

class TestRolesFixture:
    def test_unannotated_op_flagged(self):
        fs = roles_checker.check_annotations(bad_ops, path="fixture")
        assert [(f.rule, f.subject) for f in fs] == [("unannotated-op", "mystery_op")]

    def test_annotated_and_non_ops_not_flagged(self):
        subjects = {f.subject for f in roles_checker.check_annotations(bad_ops)}
        assert not subjects & {"annotated_op", "free_function", "_private_helper"}

    def test_role_mismatch_flagged(self, monkeypatch):
        """A session that records find as an inserter is caught."""
        from repro_torch.core import api

        real = api.OpSession.find
        monkeypatch.setattr(api.OpSession, "find",
                            lambda self, keys: self._record("find", "inserter", keys))
        fs = roles_checker.check_session_roles()
        assert [(f.rule, f.subject) for f in fs] == [("role-mismatch", "find")]
        monkeypatch.setattr(api.OpSession, "find", real)

    def test_impure_engine_flagged(self, monkeypatch):
        """An engine whose readonly, non-promoting waves promote is caught."""
        from repro_torch.serving import embedding_engine as ee

        real = ee.OnlineEmbeddingEngine.__init__

        def promoting(self, table, **kw):
            kw["promote"] = True
            real(self, table, **kw)

        monkeypatch.setattr(ee.OnlineEmbeddingEngine, "__init__", promoting)
        fs = roles_checker.check_engine_purity()
        assert "engine-impure-reader" in rules(fs)


class TestTelemetryFixture:
    def test_missing_seam_flagged(self):
        fs = tel_checker.check_telemetry(bad_ops, path="fixture", exempt={})
        assert [(f.rule, f.subject) for f in fs] == [("missing-telemetry-seam", "annotated_op")]

    def test_seamed_unannotated_and_exempt_not_flagged(self):
        fs = tel_checker.check_telemetry(bad_ops, path="fixture",
                                         exempt={"annotated_op": "fixture rationale"})
        assert fs == []

    def test_stale_exemptions_flagged(self):
        fs = tel_checker.check_telemetry(
            bad_ops, path="fixture",
            exempt={"annotated_op": "ok", "ghost_op": "no longer exists",
                    "telemetered_op": "grew the seam"})
        assert [(f.rule, f.subject) for f in fs] == [("stale-exemption", "ghost_op"),
                                                     ("stale-exemption", "telemetered_op")]

    def test_reads_the_ports_exemption_list(self):
        from repro_torch.core import ops

        fs = tel_checker.check_telemetry(exempt={})
        assert sorted(f.subject for f in fs) == sorted(ops.TELEMETRY_EXEMPT)


class _FakePath:
    def __init__(self, text):
        self._t = text

    def read_text(self):
        return self._t


class TestForkFixture:
    FIXTURE = FIXTURES / "bad_fork.py"

    def test_inline_match_formulas_flagged(self):
        fs = oc.scan_source(self.FIXTURE.read_text(), "fixtures/bad_fork.py")
        assert rules(fs) == ["match-formula-fork"]
        assert [f.line for f in fs] == [17, 23], "the control conjunction must not be flagged"

    def test_forked_definition_flagged(self):
        src = "def match_lanes(a, b, c, d):\n    return (a == c) & (b == d)\n"
        files = [("repro_torch/core/find.py", _FakePath(src)),
                 ("repro_torch/kernels/evil.py", _FakePath(src))]
        assert "oracle-multiplicity" in rules(oc.check_multiplicity(files))

    def test_uncoupled_module_flagged(self):
        """A plain version that re-derives liveness inline reaches no oracle;
        one that calls a port function reaching it, transitively, does."""
        files = [(rel, p) for rel, p in oc._tree_files(oc.src_root())]
        bad = ("import torch\n\ndef sweep_match_plain(keys, scores, pred):\n"
               "    return pred.matches(keys, scores) & (keys != -1)\n")
        swapped = [(rel, _FakePath(bad) if rel == "repro_torch/kernels/sweep_scan.py" else p)
                   for rel, p in files]
        fs = oc.check_required_refs(swapped)
        assert [(f.rule, f.subject) for f in fs] == [
            ("oracle-uncoupled", "repro_torch/kernels/sweep_scan.py::empty_lanes")]
        modules = {rel: oc._Module(rel, p.read_text()) for rel, p in files}
        assert oc.reached("repro_torch/kernels/find_scan.py", modules, "match_lanes")
        assert not oc.reached("repro_torch/kernels/scatter.py", modules, "match_lanes")


class TestKernelParityFixture:
    def test_unbound_cu_kernel_flagged(self):
        fs = kp.check_kernel_parity(csrc=FIXTURES, exempt={})
        assert [(f.rule, f.subject) for f in fs] == [("unbound-kernel", "hkv_fixture_unbound")]
        assert fs[0].path == "src/repro_torch/analysis/fixtures/unbound_kernel.cu"

    def _tree(self, tmp_path, plain=True, test=True, smoke=True):
        (tmp_path / "csrc").mkdir()
        (tmp_path / "csrc/k.cu").write_text('extern "C" int hkv_thing(void* stream) {}\n')
        (tmp_path / "kernels").mkdir()
        (tmp_path / "kernels/thing.py").write_text(
            'NAME = "thing"\n\n'
            + ("def thing_plain(x):\n    return x\n\n" if plain else "")
            + "def thing(x):\n    _build.launch(NAME, x)\n")
        (tmp_path / "tests").mkdir()
        (tmp_path / "tests/test_torch_thing.py").write_text(
            "import pytest\n\n"
            + ("pytestmark = pytest.mark.cuda\n\n" if test else "")
            + "def test_it():\n    assert thing.thing(1) == thing.thing_plain(1)\n")
        (tmp_path / "chip_smoke.py").write_text(
            "def kernel_rows():\n    meta = {%s}\n" % ('"thing": 1' if smoke else ""))
        return dict(csrc=tmp_path / "csrc", kernels=tmp_path / "kernels",
                    tests=tmp_path / "tests", chip_smoke=tmp_path / "chip_smoke.py", exempt={})

    @pytest.mark.parametrize("missing, rule", [(None, None), ("plain", "no-plain-version"),
                                               ("test", "no-parity-test"),
                                               ("smoke", "not-in-chip-smoke")])
    def test_each_rule(self, tmp_path, missing, rule):
        kw = {k: k != missing for k in ("plain", "test", "smoke")}
        fs = kp.check_kernel_parity(**self._tree(tmp_path, **kw))
        assert rules(fs) == ([rule] if rule else [])

    def test_stale_exemption_flagged(self, tmp_path):
        kw = self._tree(tmp_path)
        kw["exempt"] = {"gone": "was here"}
        assert [(f.rule, f.subject) for f in kp.check_kernel_parity(**kw)] == \
            [("stale-exemption", "hkv_gone")]

    def test_every_shipped_entry_is_bound_or_exempt(self):
        entries = kp.kernel_entries(REPO / "src/repro_torch/csrc")
        wraps = kp.wrappers(REPO / "src/repro_torch/kernels")
        assert len(entries) == 14
        assert set(entries) == set(wraps) | set(kp.EXEMPT)
        assert all(entries[n][0] == "src/repro_torch/csrc/host_memory.cu" for n in kp.EXEMPT)


# ---------------------------------------------------------------------------
# the shipped tree passes every checker
# ---------------------------------------------------------------------------

class TestShippedTreeClean:
    def test_kernel_parity_clean(self):
        assert kp.check_kernel_parity() == []

    def test_roles_clean(self):
        assert roles_checker.check_roles() == []

    def test_oracle_coupling_clean(self):
        assert oc.check_oracle_coupling() == []

    def test_telemetry_clean(self):
        assert tel_checker.check_telemetry() == []

    def test_ops_annotated_count(self):
        from repro_torch.core import roles

        ops = roles_checker.public_ops()
        assert sum(roles.role_of(fn) is not None for fn in ops.values()) == 21


# ---------------------------------------------------------------------------
# the finding model: waivers and output formats
# ---------------------------------------------------------------------------

def _finding(rule="unbound-kernel", subject="k1", sev="error"):
    return findings_mod.Finding("kernel-parity", rule, subject, "msg with % and\nnewline",
                                path="src/x.py", line=3, severity=sev)


class TestFindingsModel:
    def test_waiver_glob_matches_and_annotates(self):
        w = findings_mod.Waiver("kernel-parity", "unbound-kernel", "k*", "known: staged entry")
        out = findings_mod.apply_waivers([_finding()], (w,))
        assert out[0].waived and "staged" in out[0].waiver_reason
        assert findings_mod.unwaived(out) == []

    def test_waiver_requires_all_three_axes(self):
        w = findings_mod.Waiver("roles", "unbound-kernel", "k*", "no")
        out = findings_mod.apply_waivers([_finding()], (w,))
        assert not out[0].waived and findings_mod.unwaived(out) == out

    def test_warning_severity_not_fatal(self):
        assert findings_mod.unwaived(findings_mod.apply_waivers([_finding(sev="warning")], ())) \
            == []

    def test_text_format_summary_line(self):
        txt = findings_mod.format_text([_finding()])
        assert "hkv-lint: 1 finding(s), 1 fatal, 0 waived" in txt and "src/x.py:3" in txt

    def test_github_format_escapes_workflow_commands(self):
        line = findings_mod.format_github([_finding()]).splitlines()[0]
        assert line.startswith("::error file=src/x.py,line=3")
        assert "%25" in line and "%0A" in line

    def test_no_shipped_waivers(self):
        assert findings_mod.WAIVERS == ()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

class TestCli:
    def test_run_all_subset_unknown_checker(self):
        with pytest.raises(SystemExit):
            analysis.run_all(only=["nope"])

    def test_cli_clean_exit_zero(self):
        proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                              capture_output=True, text=True, cwd=REPO,
                              env={"PYTHONPATH": str(REPO / "src"),
                                   "PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": "/tmp"},
                              timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "0 fatal" in proc.stdout

    def test_exit_status_counts_unwaived_findings(self, monkeypatch, capsys):
        from repro_torch.analysis import __main__ as cli

        monkeypatch.setattr(analysis, "run_all",
                            lambda only=None: [_finding(subject=f"k{i}") for i in range(120)]
                            + [_finding(sev="warning")])
        assert cli.main(["--format", "github"]) == 99
        assert capsys.readouterr().out.count("::error") == 120
