"""The port's LIN-MC-CLS (the paper's Gibbs sampler) against the JAX
package's, plus the port's own driver and multichain checks.

Two correct float32 Gibbs chains fork: an inverse-Gaussian accept-reject
decision on a row near the hinge flips on a one-ulp margin difference,
and the chains go separate ways from there. So one step is compared
closely and a whole fit as a band:

* one ``cls_step`` from w = 0 with the same key: every residual is +-1,
  mu = 1 and the transform is well conditioned; w_new within 1e-3
  relative;
* a whole fit on the quickstart problem (make_blobs(20000, 100), 16,000
  rows to train, 4,000 held out, seed 0, max_iters=60): both converge,
  iteration counts within 15, held-out accuracy within 0.01, posterior-
  mean weights within 0.15 relative. The reference's own spread on this
  problem is 3.7 % between seeds 0 and 1 (rng='host'), 4.3 % (rng='fused')
  and 5.7 % between 'host' and 'fused' at seed 0; its fits converge in
  29-39 iterations with held-out accuracy 0.9645-0.9668.
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro.core import PEMSVM as JaxSVM
from repro.core import SVMConfig as JaxConfig
from repro.core import linear as jlin
from repro_torch.core import PEMSVM, SVMConfig, lam_from_C
from repro_torch.core import linear as tlin
from repro_torch.core import prng
from repro_torch.data import synthetic as tsyn

ITERS_BAND = 15
ACC_BAND = 0.01
W_BAND = 0.15


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Keep torch to two intra-op threads: the suite runs six workers at
    once, and timing-based tests elsewhere feel the contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _quickstart():
    X, y = tsyn.make_blobs(20_000, 100, seed=0)
    return X[:16_000], y[:16_000], X[16_000:], y[16_000:]


def _cfg(cls, **kw):
    return cls.from_options("LIN-MC-CLS", **{"lam": lam_from_C(1.0),
                                             "max_iters": 60, **kw})


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ------------------------------------------------------------ one step
@pytest.mark.parametrize("rng", ["host", "fused_predraw", "fused"])
def test_one_step_from_zero_matches_reference(rng):
    Xtr, ytr, _, _ = _quickstart()
    Xb = np.concatenate([Xtr, np.ones((len(Xtr), 1), np.float32)], 1)
    mask = np.ones(len(Xtr), np.float32)
    K = Xb.shape[1]
    cfg = dict(mode="MC", lam=lam_from_C(1.0), eps=1e-6, jitter=1e-7,
               rng=rng)
    _, sub_j = jax.random.split(jax.random.PRNGKey(0))
    w_j, aux_j = jlin.cls_step(
        jlin.SVMData(jax.numpy.asarray(Xb), jax.numpy.asarray(ytr),
                     jax.numpy.asarray(mask)),
        jax.numpy.zeros((K,), jax.numpy.float32), sub_j, **cfg)
    sub_t = prng.split(prng.PRNGKey(0))[1]
    w_t, aux_t = tlin.cls_step(
        tlin.SVMData(torch.from_numpy(Xb), torch.from_numpy(ytr),
                     torch.from_numpy(mask)),
        torch.zeros(K), sub_t, **cfg)
    assert _rel(w_t.numpy(), w_j) <= 1e-3, _rel(w_t.numpy(), w_j)
    assert float(aux_t["gamma_mean"]) == pytest.approx(
        float(aux_j["gamma_mean"]), rel=1e-5)


# ------------------------------------------------------- whole-fit band
@pytest.fixture(scope="module")
def fits():
    Xtr, ytr, Xte, yte = _quickstart()
    out = {"Xte": Xte, "yte": yte}
    for name, kw in (("host", dict(rng="host")),
                     ("fused", dict(rng="fused")),
                     ("chains", dict(rng="fused", n_chains=3))):
        ref = JaxSVM(_cfg(JaxConfig, **kw))
        port = PEMSVM(_cfg(SVMConfig, **kw), device="cpu")
        out[name] = dict(ref=ref, r_ref=ref.fit(Xtr, ytr), port=port,
                         r_port=port.fit(Xtr, ytr))
    return out


@pytest.mark.parametrize("name", ["host", "fused", "chains"])
def test_whole_fit_band(fits, name):
    f = fits[name]
    r, p = f["r_ref"], f["r_port"]
    assert r.converged and p.converged
    assert abs(r.n_iters - p.n_iters) <= ITERS_BAND, (r.n_iters, p.n_iters)
    a_ref = f["ref"].score(fits["Xte"], fits["yte"])
    a_port = f["port"].score(fits["Xte"], fits["yte"])
    assert abs(a_ref - a_port) <= ACC_BAND, (a_ref, a_port)
    assert _rel(p.weights, r.weights) <= W_BAND, _rel(p.weights, r.weights)
    assert np.all(np.isfinite(p.weights))


@pytest.mark.parametrize("name", ["host", "fused"])
def test_posterior_mean_is_averaged(fits, name):
    """The weights are the average of the draws after burn-in, not the
    last draw, and the first objective (from w = 0) is the reference's."""
    p, r = fits[name]["r_port"], fits[name]["r_ref"]
    assert not np.array_equal(p.weights, p.last_sample)
    assert p.objective[0] == pytest.approx(r.objective[0], rel=1e-5)


def test_fused_equals_fused_predraw_bitwise():
    """'fused_predraw' materializes the counter stream the 'fused' seed
    derives; on the plain path both fits are the same fit."""
    Xtr, ytr, _, _ = _quickstart()
    a = PEMSVM(_cfg(SVMConfig, rng="fused", max_iters=15), device="cpu"
               ).fit(Xtr, ytr)
    b = PEMSVM(_cfg(SVMConfig, rng="fused_predraw", max_iters=15),
               device="cpu").fit(Xtr, ytr)
    assert a.objective == b.objective
    assert np.array_equal(a.weights, b.weights)


# ---------------------------------------------------- scan vs loop
@pytest.mark.parametrize("kw", [
    dict(rng="host", max_iters=60, scan_chunk=16, tol=1e-3),
    dict(rng="fused", max_iters=30, scan_chunk=7, tol=0.0, min_iters=30),
    dict(rng="fused", n_chains=3, max_iters=20, scan_chunk=6, burnin=8,
         tol=0.0, min_iters=20),
], ids=["host-converges-mid-chunk", "fused-chunk-ends-in-burnin",
        "chains-chunk-ends-in-burnin"])
def test_scan_equals_loop_exactly(kw):
    """Same step and key chain: the traces, the last sample and the stop
    are bitwise equal, and the scan driver syncs once per chunk. The
    posterior means are averaged differently by design (the reference's
    float64 running mean in the loop, float32 chunk sums combined in
    float64 in the scan), so they agree to float32 rounding."""
    Xtr, ytr, _, _ = _quickstart()
    scan = PEMSVM(_cfg(SVMConfig, **kw), device="cpu").fit(Xtr, ytr)
    loop = PEMSVM(_cfg(SVMConfig, driver="loop", **kw),
                  device="cpu").fit(Xtr, ytr)
    assert scan.objective == loop.objective
    assert scan.aux_history == loop.aux_history
    assert np.array_equal(scan.last_sample, loop.last_sample)
    assert (scan.n_iters, scan.converged) == (loop.n_iters, loop.converged)
    assert len(scan.objective) == scan.n_iters
    assert scan.n_host_syncs <= math.ceil(kw["max_iters"] /
                                          kw["scan_chunk"])
    w, wl = scan.weights.astype(np.float64), loop.weights.astype(np.float64)
    assert np.max(np.abs(w - wl)) <= 1e-5 * np.max(np.abs(wl))
    assert not np.array_equal(scan.weights, scan.last_sample)


# ---------------------------------------------------------- multichain
def test_multichain_surface(fits):
    p = fits["chains"]["r_port"]
    K = p.weights.shape[0]
    assert p.chain_weights.shape == (3, K) and p.chain_std.shape == (K,)
    assert np.all(np.isfinite(p.chain_std)) and np.all(p.chain_std > 0)
    cw = p.chain_weights.astype(np.float64)
    assert np.array_equal(p.weights, cw.mean(axis=0).astype(np.float32))
    assert np.array_equal(p.chain_std,
                          cw.std(axis=0, ddof=1).astype(np.float32))
    assert p.last_sample.shape == (3, K)
    single = fits["fused"]["r_port"]
    assert single.chain_weights is None and single.chain_std is None


def test_chain_c_is_the_single_chain_at_chain0_c():
    """Chain c of a C-chain fit walks counter plane chain0 + c and draws
    with fold_in(key, chain0 + c): after one iteration it is the C = 1
    fit with chain0 = c."""
    Xtr, ytr, _, _ = _quickstart()
    kw = dict(rng="fused", max_iters=1, min_iters=1)
    multi = PEMSVM(_cfg(SVMConfig, n_chains=3, **kw), device="cpu"
                   ).fit(Xtr, ytr)
    for c in range(3):
        one = PEMSVM(_cfg(SVMConfig, chain0=c, **kw), device="cpu"
                     ).fit(Xtr, ytr)
        a, b = multi.chain_weights[c], one.weights
        assert np.max(np.abs(a - b)) <= 1e-5 * np.max(np.abs(b)), c


# ------------------------------------------------------- not ported yet
@pytest.mark.parametrize("kw,item", [
    (dict(decay=0.5, driver="loop"), "requires driver='stream'"),
    (dict(fault=object()), "FaultPolicy"),
])
def test_out_of_slice_options_raise(kw, item):
    """``decay`` holds the reference's guard (stream driver only);
    ``fault`` must be a ``runtime.FaultPolicy``."""
    if item != "FaultPolicy":
        with pytest.raises(AssertionError, match=item):
            SVMConfig(**{"algorithm": "MC", **kw})
        return
    with pytest.raises(TypeError, match=item):
        PEMSVM(SVMConfig(**{"algorithm": "MC", **kw}), device="cpu")


def test_mc_mlt_runs():
    """task='MLT', which this file once held as out of slice: the
    Crammer-Singer Gibbs sweep runs, averages its (M, K) draws after
    burn-in, and scores the accuracy of its class ids."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(600, 8)).astype(np.float32)
    y = np.argmax(X[:, :3], axis=1).astype(np.int32)
    svm = PEMSVM(SVMConfig(algorithm="MC", task="MLT", num_classes=3,
                           max_iters=20, burnin=5), device="cpu")
    res = svm.fit(X, y)
    assert res.weights.shape == (3, 9) and set(res.aux_history) == {
        "objective"}
    assert not np.array_equal(res.weights, res.last_sample)
    assert svm.score(X, y) > 0.9


def test_mc_svr_runs():
    """task='SVR', which this file once held as out of slice: the MC
    (Gibbs) SVR fit runs, averages its draws after burn-in, and scores
    the negated RMSE."""
    from repro_torch.data import make_year_like
    X, y = make_year_like(2000, 20, seed=4)
    svm = PEMSVM(SVMConfig(algorithm="MC", task="SVR", lam=2.0,
                           eps_ins=0.3, max_iters=40, burnin=3),
                 device="cpu")
    res = svm.fit(X, y)
    assert res.converged and np.all(np.isfinite(res.weights))
    assert not np.array_equal(res.weights, res.last_sample)
    assert svm.score(X, y) == -svm.rmse(X, y) and svm.rmse(X, y) < 0.5


def test_mesh_and_col_window_raise():
    """The mesh and the column window are ported now: what still raises is
    a mesh that is not a torch DeviceMesh, and a window on a multichain
    statistic (the reference forbids the pair)."""
    from repro_torch.kernels import ops
    with pytest.raises(TypeError, match="DeviceMesh"):
        PEMSVM(_cfg(SVMConfig), device="cpu", mesh=object())
    X, v = torch.zeros(3, 2), torch.zeros(3)
    seed = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="multichain"):
        ops.fused_stats(X, v, v, torch.zeros(2, 2), None,
                        epilogue="mc_hinge", seed=seed, col_window=(0, 1))
    out = ops.fused_stats(X, v, v, torch.zeros(2), None, (v, v),
                          epilogue="mc_hinge", col_window=(0, 1))
    assert out[-1].shape == (2, 1)
