"""The training slice as a whole: the DLRM continuous-training loop of
``examples/dlrm_continuous.py`` run through both packages.

Config B cut to 4 x 128 slots (dim 32, dual bucket, LRU, rowwise_adagrad,
V = 33), 26 Zipfian fields, batch 16, 3 steps, from the same random
initial weights (made by JAX, carried by `convert.dlrm_params_from_jax`):
each step is lookup_train, the forward and backward pass, the dense sgd
update, and apply_grads.  After every step the statuses of the step's
find_or_insert and the key, digest and score planes are exact; the loss
agrees within rtol 1e-5 and the value plane within atol 1e-6 (the matrix
products, XLA's and torch's, sum in different orders, and so do the
rowwise_adagrad row means).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.hkv_dlrm import PAPER_CONFIGS as JAX_CONFIGS  # noqa: E402
from repro.configs.hkv_dlrm import scaled as jax_scaled  # noqa: E402
from repro.data import zipf_keys as jax_zipf_keys  # noqa: E402
from repro.models.common import dense_init  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.hkv_dlrm import PAPER_CONFIGS, scaled  # noqa: E402
from repro_torch.data import zipf_keys  # noqa: E402
from repro_torch.models.dlrm import DLRM  # noqa: E402

STEPS, BATCH, LR = 3, 16, 0.05


def _jax_loss_and_grad(nf):
    """The example's model and loss, as it writes them."""
    def forward(params, emb_rows, dense_x):
        z = jax.nn.relu(dense_x @ params["bottom1"]) @ params["bottom2"]
        feats = jnp.concatenate([z[:, None, :], emb_rows], axis=1)
        inter = jnp.einsum("bnd,bmd->bnm", feats, feats)
        iu = jnp.triu_indices(nf + 1, k=1)
        flat = inter[:, iu[0], iu[1]]
        h = jnp.concatenate([z, flat], axis=1)
        return (jax.nn.relu(h @ params["top1"]) @ params["top2"])[:, 0]

    def loss_fn(params, emb_rows, dense_x, labels):
        logits = forward(params, emb_rows, dense_x)
        return jnp.mean(jnp.maximum(logits, 0) - logits * labels
                        + jnp.log1p(jnp.exp(-jnp.abs(logits))))

    return jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))


def _batch(rng, nf, dense, zipf):
    field_keys = np.stack([zipf(rng, BATCH, 0.99, 10**6) ^ np.uint64(f << 56)
                           for f in range(nf)], axis=1)
    toks = (field_keys & np.uint64(0x7FFFFFFF)).astype(np.int64).astype(np.int32)
    dense_x = rng.normal(size=(BATCH, dense)).astype(np.float32)
    labels = rng.integers(0, 2, size=BATCH).astype(np.float32)
    return toks, dense_x, labels


def test_dlrm_continuous_training_matches_jax():
    jcfg, pcfg = jax_scaled(JAX_CONFIGS["B"], 2**18), scaled(PAPER_CONFIGS["B"], 2**18)
    assert pcfg.capacity == 4 * 128
    jemb, pemb = jcfg.embedding(), pcfg.embedding()
    jt, pt = jemb.create(), pemb.create(device="cpu")
    assert pt.state.values.shape[1] == 33
    d, nf = jcfg.dim, jcfg.num_sparse
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    params = {"bottom1": dense_init(ks[0], jcfg.dense_features, 64),
              "bottom2": dense_init(ks[1], 64, d),
              "top1": dense_init(ks[2], d + nf * (nf + 1) // 2, 64),
              "top2": dense_init(ks[3], 64, 1)}
    model = DLRM(d, nf, pcfg.dense_features, device="cpu")
    model.load_state_dict(convert.dlrm_params_from_jax({k: np.asarray(v)
                                                        for k, v in params.items()}))
    grad_fn = _jax_loss_and_grad(nf)
    jrng, prng = np.random.default_rng(0), np.random.default_rng(0)
    statuses = set()
    for step in range(STEPS):
        toks, dense_x, labels = _batch(jrng, nf, jcfg.dense_features, jax_zipf_keys)
        ptoks, pdense, plabels = _batch(prng, nf, pcfg.dense_features, zipf_keys)
        np.testing.assert_array_equal(ptoks, toks)

        # the step's find_or_insert statuses, on copies of the tables
        jk = jemb.keys_of(jnp.asarray(toks))
        want_status = jt.find_or_insert(jk, jemb.default_rows(jk)).status
        pk = pemb.keys_of(torch.from_numpy(ptoks))
        got_status = pt.snapshot().find_or_insert(pk, pemb.default_rows(pk)).status
        np.testing.assert_array_equal(got_status.numpy(), np.asarray(want_status))
        statuses.update(np.unique(np.asarray(want_status)).tolist())

        jt, jrows = jemb.lookup_train(jt, jnp.asarray(toks))
        jloss, (gp, ge) = grad_fn(params, jrows, jnp.asarray(dense_x), jnp.asarray(labels))
        params = jax.tree.map(lambda p, g: p - LR * g, params, gp)
        jt = jemb.apply_grads(jt, jnp.asarray(toks), ge)

        pt, rows = pemb.lookup_train(pt, torch.from_numpy(ptoks))
        rows = rows.detach().requires_grad_(True)
        loss = model.loss(rows, torch.from_numpy(pdense), torch.from_numpy(plabels))
        loss.backward()
        model.sgd_(LR)
        pemb.apply_grads(pt, torch.from_numpy(ptoks), rows.grad)

        ctx = f"step {step}"
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5, err_msg=ctx)
        got = convert.state_to_arrays(pt.state)
        for f in ("key_hi", "key_lo", "digests", "score_hi", "score_lo", "clock_hi",
                  "clock_lo"):
            np.testing.assert_array_equal(got[f], np.asarray(getattr(jt.state, f)),
                                          err_msg=f"{ctx}: {f}")
        np.testing.assert_allclose(got["values"], np.asarray(jt.state.values), rtol=0,
                                   atol=1e-6, err_msg=f"{ctx}: values")
        assert np.isfinite(float(loss.detach()))
    assert {2, 3} <= statuses   # inserted, and evicted once the table filled
    for name, p in params.items():
        np.testing.assert_allclose(getattr(model, name).detach().numpy(), np.asarray(p),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
