"""The port's walkthroughs (``repro_torch.examples``) run end to end on the
CPU, each through its ``main`` with ``--device cpu`` at its smallest
setting, and pass their own checks (each raises AssertionError where the
reference's example would)."""

import pytest

torch = pytest.importorskip("torch")


def test_quickstart(capsys):
    from repro_torch.examples import quickstart

    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "128/128 rejected" in out and "256/256 early keys survived" in out
    assert out.rstrip().endswith("ok.")


def test_dlrm_continuous(capsys):
    from repro_torch.examples import dlrm_continuous

    dlrm_continuous.main(["--device", "cpu"])
    assert "lower in 80 of 80 steps" in capsys.readouterr().out


def test_online_serving(capsys):
    from repro_torch.examples import online_serving

    online_serving.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "delta publish" in out and out.rstrip().endswith("ok.")


def test_train_lm_hkv(tmp_path, capsys):
    from repro_torch.examples import train_lm_hkv

    hist = train_lm_hkv.main(["--device", "cpu", "--steps", "12",
                              "--ckpt-dir", str(tmp_path / "ck")])
    assert hist["restarts"] == 1 and len(hist["loss"]) >= 12
    assert "(1 restarts)" in capsys.readouterr().out


def test_examples_default_to_the_card(monkeypatch):
    """Without --device an example runs on the card and raises without one."""
    from repro_torch.examples import dlrm_continuous, online_serving, quickstart

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for ex in (quickstart, dlrm_continuous, online_serving):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ex.main([])
