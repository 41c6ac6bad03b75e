"""The port's baselines (``repro_torch.baselines``) and ``prng.randint``
against the JAX package, on the CPU.

Tolerances, stated before the runs:
  * ``prng.randint``: bitwise equal to ``jax.random.randint``;
  * Pegasos' and DCD's w within 1e-5 of max|w| of the reference's (both
    walk the reference's own indices: Pegasos its ``randint`` batches, DCD
    its numpy permutations; what differs is float32 summation order).
    Pegasos at 2,000 steps is held step by step (see
    ``test_pegasos_steps_match_reference``);
  * the paper's parity claim as the reference's test states it: PEMSVM
    LIN-EM-CLS accuracy >= max(Pegasos, DCD) - 0.02.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import DCDSVM as RefDCD
from repro.baselines import PegasosSVM as RefPegasos
from repro_torch.baselines import DCDSVM, PegasosSVM
from repro_torch.baselines.pegasos import batch_indices, pegasos_step
from repro_torch.core import PEMSVM, SVMConfig, prng
from repro_torch.data import make_blobs
from torch_family_util import one_torch_thread  # noqa: F401

REL = 1e-5


def _data(N, K, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, K)).astype(np.float32)
    w = rng.standard_normal(K)
    y = np.where(X @ w + 0.5 * rng.standard_normal(N) > 0, 1, -1)
    return X, y.astype(np.int32)


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["int32", "uint32"])
@pytest.mark.parametrize("lo,hi,n", [(0, 1024, 4096), (0, 1000, 4096),
                                     (0, 1200, 1 << 20), (3, 3, 64),
                                     (0, 2 ** 31 - 1, 4096),
                                     (7, 600_001, 50_000)])
def test_randint_bitwise(dtype, lo, hi, n):
    for seed in (0, 11):
        want = np.asarray(jax.random.randint(
            jax.random.PRNGKey(seed), (n,), lo, hi, getattr(jnp, dtype)))
        got = prng.randint(prng.PRNGKey(seed), (n,), lo, hi,
                           getattr(torch, dtype))
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.to(torch.int64).numpy(),
                                      want.astype(np.int64))


def test_randint_negative_range_and_key_batch():
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (999,),
                                         -2 ** 31, 2 ** 31 - 1))
    got = prng.randint(prng.PRNGKey(5), (999,), -2 ** 31, 2 ** 31 - 1)
    np.testing.assert_array_equal(got.numpy(), want)
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    want = np.stack([np.asarray(jax.random.randint(k, (256,), -5, 17))
                     for k in keys])
    got = prng.randint(prng.split(prng.PRNGKey(3), 6), (256,), -5, 17)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("project", [True, False])
@pytest.mark.parametrize("add_bias", [True, False])
def test_pegasos_matches_reference(project, add_bias):
    N, K, steps = 600, 20, 200
    X, y = _data(N, K)
    ref = RefPegasos(lam=0.01, n_steps=steps, project=project,
                     add_bias=add_bias, seed=4).fit(X, y)
    got = PegasosSVM(lam=0.01, n_steps=steps, project=project,
                     add_bias=add_bias, seed=4, device="cpu").fit(X, y)
    assert _rel(got.w.numpy(), ref.w) <= REL
    assert abs(got.score(X, y) - ref.score(X, y)) <= 1.0 / N


def _reference_steps(X, y, lam, n_steps, batch, project, seed):
    """The reference's Pegasos step (``repro/baselines/pegasos.py``,
    ``fit``'s ``step``, verbatim) run one step at a time: [(w_t, margin
    of step t)] for t = 1 .. n_steps, w_0 = 0."""
    N, K = X.shape
    Xj, yj = jnp.asarray(X), jnp.asarray(y)

    @jax.jit
    def step(w, t, key):
        idx = jax.random.randint(key, (batch,), 0, N)
        xb, yb = Xj[idx], yj[idx]
        margin = yb * (xb @ w)
        g_loss = -(xb * (yb * (margin < 1.0))[:, None]).sum(0) * (
            2.0 / batch)
        eta = 1.0 / (lam * t)
        w = (1.0 - eta * lam) * w - eta * g_loss
        if project:
            norm = jnp.linalg.norm(w)
            w = w * jnp.minimum(1.0, 1.0 / (jnp.sqrt(lam) * norm + 1e-30))
        return w, margin

    keys = jax.random.split(jax.random.PRNGKey(seed), n_steps)
    ts = jnp.arange(1, n_steps + 1, dtype=jnp.float32)
    w = jnp.zeros((K,), jnp.float32)
    out = []
    for t in range(n_steps):
        w, margin = step(w, ts[t], keys[t])
        out.append((np.asarray(w), np.asarray(margin)))
    return out


@pytest.mark.parametrize("project", [True, False])
@pytest.mark.parametrize("add_bias", [True, False])
def test_pegasos_steps_match_reference(project, add_bias):
    """1,200 x 50, 2,000 steps: each port step, started from the
    reference's w_t, lands within REL of the reference's w_{t+1}. The one
    exception is a step whose batch holds a margin within 1e-5 of the
    hinge, where float32 summation order decides the sub-gradient's
    indicator (traced: such a flip, a margin 2.9e-6 from 1, leaves the two
    fits 2e-3 apart after 2,000 steps); those steps are counted and must
    be under 1 %. End to end the two fits score within 1 %."""
    N, K, steps, lam, seed = 1200, 50, 2000, 0.01, 4
    X, y = _data(N, K)
    Xb = np.concatenate([X, np.ones((N, 1), np.float32)], 1) \
        if add_bias else X
    ref = _reference_steps(Xb, y.astype(np.float32), lam, steps, 256,
                           project, seed)
    Xt = torch.from_numpy(Xb)
    yt = torch.from_numpy(y.astype(np.float32))
    idx = batch_indices(seed, steps, 256, N, "cpu")
    ts = torch.arange(1, steps + 1, dtype=torch.float32)
    w = torch.zeros(Xb.shape[1])
    near = 0
    for t, (w_next, margin) in enumerate(ref):
        got = pegasos_step(Xt, yt, w, idx[t], ts[t], lam, project)
        if np.abs(margin - 1.0).min() < 1e-5:
            near += 1
        else:
            assert _rel(got.numpy(), w_next) <= REL, t
        w = torch.from_numpy(w_next.copy())
    assert near <= steps // 100, near
    full = PegasosSVM(lam=lam, n_steps=steps, project=project,
                      add_bias=add_bias, seed=seed, device="cpu").fit(X, y)
    ref_fit = RefPegasos(lam=lam, n_steps=steps, project=project,
                         add_bias=add_bias, seed=seed).fit(X, y)
    assert abs(full.score(X, y) - ref_fit.score(X, y)) <= 0.01


@pytest.mark.parametrize("N,K,epochs", [(600, 20, 1), (1200, 50, 8)])
def test_dcd_matches_reference(N, K, epochs):
    X, y = _data(N, K, seed=1)
    ref = RefDCD(C=3.0, n_epochs=epochs, seed=2).fit(X, y)
    got = DCDSVM(C=3.0, n_epochs=epochs, seed=2, device="cpu").fit(X, y)
    assert _rel(got.w.numpy(), ref.w) <= REL
    assert got.alpha.min() >= 0 and got.alpha.max() <= 3.0


def test_dcd_from_lam_and_no_bias():
    X, y = _data(600, 20, seed=2)
    ref = RefDCD.from_lam(0.05, n_epochs=2, add_bias=False).fit(X, y)
    got = DCDSVM.from_lam(0.05, n_epochs=2, add_bias=False,
                          device="cpu").fit(X, y)
    assert got.C == ref.C == 2.0 / 0.05
    assert got.w.shape == (20,)
    assert _rel(got.w.numpy(), ref.w) <= REL
    np.testing.assert_array_equal(got.predict(X).numpy(), ref.predict(X))


def test_accuracy_parity_with_baselines():
    """The reference's parity test (tests/test_solvers.py) through the
    port: comparable accuracy to state-of-the-art solvers."""
    X, y = make_blobs(1500, 20, seed=0)
    ours = PEMSVM(SVMConfig(lam=0.01, max_iters=60), device="cpu")
    ours.fit(X, y)
    peg = PegasosSVM(lam=0.01, n_steps=2000, device="cpu").fit(X, y)
    dcd = DCDSVM.from_lam(0.01, n_epochs=8, device="cpu").fit(X, y)
    a0, a1, a2 = ours.score(X, y), peg.score(X, y), dcd.score(X, y)
    assert a0 >= max(a1, a2) - 0.02, (a0, a1, a2)
