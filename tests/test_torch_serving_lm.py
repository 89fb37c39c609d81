"""The port's LM serving engine and launcher (``repro_torch.serving.
ServingEngine``, ``launch/serve.py --mode lm``, ``StepBuilder``'s serve
calls) against the JAX package's, on the CPU at the smoke sizes.

  * The wave engine against the reference's ``ServingEngine`` on the same
    parameters (carried by ``convert.lm_params_from_jax``) and requests:
    the same completed tokens a request, in the same order, with waves by
    prompt length, lanes padded with copies of lane 0, and lanes finishing
    on `max_new` or on EOS; each lane's tokens equal a standalone greedy
    loop at the same batch and padding (the reference's
    tests/test_serving_and_extras.py::TestServingEngine).
  * `decode_step` writes the state it is given in place and returns it
    (the port's difference by design, ROADMAP queue 3).
  * `StepBuilder.prefill_step` / `decode_step` are the model's calls.
  * `--mode lm --device cpu --smoke` runs to its end; without a card and
    without `--device cpu` the serving entry points raise.

Greedy tokens are compared exactly: the float32 logits of the two
packages agree within 2e-5 of their magnitude (tests/test_torch_decode.py),
far inside the gaps between these draws' top two logits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.models.lm import CompositeLM as JLM  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.lm import CompositeLM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.train.step import StepBuilder  # noqa: E402


def _models(name="qwen2-0.5b", seed=0):
    jm = JLM(jget(name).smoke)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, CompositeLM(get_arch(name).smoke), tp


def _requests(vocab, lens, max_new, seed=1):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=n).astype(np.int32), m)
            for i, (n, m) in enumerate(zip(lens, max_new))]


def _serve(engine_cls, request_cls, model, params, reqs, **kw):
    eng = engine_cls(model, params, **kw)
    for rid, prompt, max_new in reqs:
        eng.submit(request_cls(rid=rid, prompt=prompt, max_new=max_new))
    return [(r.rid, list(r.out), r.done) for r in eng.run_until_drained()]


@pytest.mark.parametrize("name, lens, max_new", [
    ("qwen2-0.5b", (8, 8, 8, 8), (4, 6, 8, 10)),        # the reference test's two waves
    ("qwen2-0.5b", (8, 5, 8, 5, 8), (3, 5, 4, 6, 2)),   # waves by length, padded
    ("zamba2-1.2b", (6, 6, 6), (5, 7, 3)),
])
def test_engine_completes_the_references_tokens(name, lens, max_new):
    jm, jp, tm, tp = _models(name)
    reqs = _requests(tm.cfg.vocab, lens, max_new)
    want = _serve(JEngine, JRequest, jm, jp, reqs, max_batch=2, max_len=32)
    got = _serve(ServingEngine, Request, tm, tp, reqs, max_batch=2, max_len=32)
    assert got == want
    limit = {rid: m for rid, _, m in reqs}
    assert len(got) == len(reqs)
    assert all(done and len(out) == limit[rid] for rid, out, done in got)


def test_engine_lanes_finish_on_eos():
    """An EOS token ends its lane early; the wave drains with the others."""
    jm, jp, tm, tp = _models()
    reqs = _requests(tm.cfg.vocab, (8, 8, 8, 8), (10, 10, 10, 10))
    plain = _serve(ServingEngine, Request, tm, tp, reqs, max_batch=2, max_len=32)
    eos = plain[1][1][3]            # request 1's fourth token
    want = _serve(JEngine, JRequest, jm, jp, reqs, max_batch=2, max_len=32, eos_id=eos)
    got = _serve(ServingEngine, Request, tm, tp, reqs, max_batch=2, max_len=32, eos_id=eos)
    assert got == want
    ended = [out for _, out, _ in got if len(out) < 10]
    assert ended and all(out[-1] == eos for out in ended)


def test_engine_lanes_equal_a_standalone_greedy_loop():
    """Each lane of a padded wave emits what a greedy loop over the same
    padded batch does."""
    _, _, tm, tp = _models()
    reqs = _requests(tm.cfg.vocab, (8, 8, 8), (5, 7, 4))
    got = {rid: out for rid, out, _ in
           _serve(ServingEngine, Request, tm, tp, reqs, max_batch=4, max_len=32)}
    prompts = np.stack([p for _, p, _ in reqs] + [reqs[0][1]])   # lane 3: lane 0's copy
    logits, st = tm.prefill(tp, torch.from_numpy(prompts), 32)
    toks = [logits.argmax(-1)]
    for _ in range(6):
        logits, st = tm.decode_step(tp, toks[-1].to(torch.int32), st)
        toks.append(logits.argmax(-1))
    loop = torch.stack(toks, dim=1).numpy()
    for lane, (rid, _, m) in enumerate(reqs):
        assert got[rid] == loop[lane, :m].tolist()


def test_decode_step_writes_the_state_in_place():
    """The reference returns a new state and leaves its input as it was;
    the port writes the caches in place and returns the same dict (no
    caller of the reference reuses a decoded state)."""
    jm, jp, tm, tp = _models()
    toks = np.arange(16, dtype=np.int32).reshape(2, 8) % tm.cfg.vocab
    _, st = tm.prefill(tp, torch.from_numpy(toks), 12)
    k = st["repeat"][0]["k"]
    before = k.clone()
    out_l, out = tm.decode_step(tp, torch.tensor([1, 2], dtype=torch.int32), st)
    assert out is st and out["repeat"][0]["k"] is k
    assert int(st["pos"]) == 9
    changed = (k != before).any(dim=(0, 1, 2, 4, 5))
    assert changed.tolist() == [i == 8 for i in range(12)]     # slot 8 written, only
    # the reference leaves its input state as it was
    _, js = jm.prefill(jp, jnp.asarray(toks), 12)
    jk = np.asarray(js["repeat"][0]["k"])
    want_l, _ = jm.decode_step(jp, jnp.asarray([1, 2], jnp.int32), js)
    np.testing.assert_array_equal(np.asarray(js["repeat"][0]["k"]), jk)
    err = np.abs(out_l.numpy() - np.asarray(want_l)).max()
    assert err <= 2e-5 * np.abs(np.asarray(want_l)).max()


def test_step_builder_serve_calls():
    _, _, tm, tp = _models()
    sb = StepBuilder(tm, adamw())
    toks = torch.from_numpy(np.arange(16, dtype=np.int32).reshape(2, 8))
    l1, s1 = sb.prefill_step(tp, toks, 12)
    l2, s2 = tm.prefill(tp, toks, 12)
    assert torch.equal(l1, l2)
    nxt = torch.tensor([4, 5], dtype=torch.int32)
    d1, s1 = sb.decode_step(tp, nxt, s1)
    d2, s2 = tm.decode_step(tp, nxt, s2)
    assert torch.equal(d1, d2)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(s1), tree.leaves(s2)))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "xlstm-1.3b"])
def test_launcher_lm_mode_runs_on_the_cpu(capsys, arch):
    assert serve.main(["--mode", "lm", "--device", "cpu", "--smoke", "--arch", arch,
                       "--batch", "2", "--prompt-len", "8", "--decode-steps", "4"]) == 0
    out = capsys.readouterr().out
    assert f"[serve] {arch}: generated (2, 4) tokens" in out and "first sequence:" in out
    args = serve.parse_args(["--mode", "lm", "--smoke", "--batch", "2", "--prompt-len", "8",
                             "--decode-steps", "4", "--device", "cpu"])
    gen = serve.lm_main(args)
    assert gen.shape == (2, 4) and gen.dtype == np.int32
    assert ((0 <= gen) & (gen < get_arch("qwen2-0.5b").smoke.vocab)).all()


def test_serving_entry_points_raise_without_a_card(monkeypatch):
    """Without a card: `--mode lm` without `--device cpu` and an empty
    decode state without `device` raise, as every entry point does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--mode", "lm", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CompositeLM(get_arch("qwen2-0.5b").smoke).init_decode_state(1, 4)
