"""The port's plain kernels (``repro_torch.kernels``) against the JAX
package's ``ops`` with ``backend="ref"`` and ``backend="interpret"``.

Inputs come from numpy seeds and reach both packages as numpy arrays.
Shapes are odd and masked: 37 x 29 (as ``test_kshard_fused._problem``),
a ragged N whose last rows are padding (X-row 0, rho = beta = 0), K = 1537
through the fused_estep + syrk_tri route above FUSED_STATS_MAX_K, and
bf16 X.

Two regimes, each with its tolerance and its reason:

* well-conditioned: rho = m64 +- U[0.05, 2], with m64 the float64 margin,
  so gamma >= ~0.05 and 1/gamma does not amplify rounding. Margins and
  gamma agree to |d| <= 1e-5 (1 + |v|); b and Sigma to
  max|d| <= 1e-5 max|ref|: float32 sums in another order.
* hinge (rho = beta = y, random w): rows at the hinge knee have gamma at
  the 1e-6 clamp, and 1/gamma turns a one-ulp margin difference into a
  large Sigma difference between two correct float32 implementations.
  So gamma is held to the margin difference: max and |.| are
  1-Lipschitz, and each side rounds rho - m once (half an ulp), so
  |dgamma| <= |dm| + 2^-24 (gamma_port + gamma_jax) + 1e-7. b and Sigma
  are held to a float64 recomputation from the port's OWN gamma, within
  1e-5 max|ref|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

EPS = 1e-6
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Keep torch to two intra-op threads: the suite runs six workers at
    once, and timing-based tests elsewhere feel the contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# name: (N, K, padded rows, X dtype, use a Sigma weight mask)
CASES = {
    "odd": (37, 29, 0, "f32", True),
    "ragged": (203, 29, 13, "f32", True),
    "odd-bf16": (37, 29, 0, "bf16", False),
    "wide": (40, 1537, 3, "f32", False),
}


def _problem(case, regime, seed=0):
    n, k, n_pad, dtype, masked = CASES[case]
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, k)).astype(np.float32)
    X[n - n_pad:] = 0.0
    if dtype == "bf16":  # round once; both packages get the same values
        X = torch.from_numpy(X).bfloat16().float().numpy()
    w = (rng.normal(size=k) / np.sqrt(k)).astype(np.float32)
    y = rng.choice([-1.0, 1.0], n).astype(np.float32)
    if regime == "well":
        m64 = X.astype(np.float64) @ w.astype(np.float64)
        off = rng.uniform(0.05, 2.0, n) * rng.choice([-1.0, 1.0], n)
        rho = (m64 + off).astype(np.float32)
        beta = rng.normal(size=n).astype(np.float32)
    else:
        rho = beta = y
    rho, beta = rho.copy(), beta.copy()
    rho[n - n_pad:] = 0.0
    beta[n - n_pad:] = 0.0
    wm = ((rng.random(n) > 0.2).astype(np.float32) if masked else None)
    if wm is not None:
        wm[n - n_pad:] = 0.0
    return dict(X=X, rho=rho, beta=beta, w=w, wm=wm, bf16=dtype == "bf16")


def _torch(p):
    X = torch.from_numpy(p["X"])
    return dict(X=X.bfloat16() if p["bf16"] else X,
                rho=torch.from_numpy(p["rho"]),
                beta=torch.from_numpy(p["beta"]),
                w=torch.from_numpy(p["w"]),
                wm=None if p["wm"] is None else torch.from_numpy(p["wm"]))


def _jax(p):
    X = jnp.asarray(p["X"])
    return dict(X=X.astype(jnp.bfloat16) if p["bf16"] else X,
                rho=jnp.asarray(p["rho"]), beta=jnp.asarray(p["beta"]),
                w=jnp.asarray(p["w"]),
                wm=None if p["wm"] is None else jnp.asarray(p["wm"]))


def _np(*ts):
    return [np.asarray(t, np.float64) for t in ts]


def _close_rows(got, want):
    """|d| <= 1e-5 (1 + |v|), elementwise."""
    got, want = _np(got, want)
    bad = np.abs(got - want) > REL * (1.0 + np.abs(want))
    assert not bad.any(), np.max(np.abs(got - want))


def _close_max(got, want):
    """max|d| <= 1e-5 max|ref|."""
    got, want = _np(got, want)
    err, scale = np.max(np.abs(got - want)), np.max(np.abs(want))
    assert err <= REL * scale, (err, scale)


def _hinge_gamma(m_t, g_t, m_j, g_j):
    m_t, g_t, m_j, g_j = _np(m_t, g_t, m_j, g_j)
    bound = np.abs(m_t - m_j) + 2.0 ** -24 * (g_t + g_j) + 1e-7
    assert np.all(np.abs(g_t - g_j) <= bound)


def _stats64(p, gamma):
    """b and Sigma in float64 from a given gamma."""
    X = p["X"].astype(np.float64)
    g = np.asarray(gamma, np.float64)
    wm = 1.0 if p["wm"] is None else p["wm"].astype(np.float64)
    coef = p["rho"].astype(np.float64) / g + p["beta"].astype(np.float64)
    return X.T @ coef, (X * (wm / g)[:, None]).T @ X


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("regime", ["well", "hinge"])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_stats(case, regime, backend):
    p = _problem(case, regime)
    t, j = _torch(p), _jax(p)
    mt, gt, bt, St = tops.fused_stats(t["X"], t["rho"], t["beta"], t["w"],
                                      t["wm"], eps=EPS)
    mj, gj, bj, Sj = jops.fused_stats(j["X"], j["rho"], j["beta"], j["w"],
                                      j["wm"], None, epilogue="em_hinge",
                                      eps=EPS, backend=backend)
    n, k = p["X"].shape
    assert tuple(St.shape) == (k, k) and tuple(bt.shape) == (k,)
    assert St.dtype == torch.float32 and mt.dtype == torch.float32
    _close_rows(mt, mj)
    if regime == "well":
        _close_rows(gt, gj)
        _close_max(bt, bj)
        _close_max(St, Sj)
    else:
        _hinge_gamma(mt, gt, mj, gj)
        b64, S64 = _stats64(p, gt)
        _close_max(bt, b64)
        _close_max(St, S64)


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("regime", ["well", "hinge"])
@pytest.mark.parametrize("case", ["odd", "ragged", "odd-bf16"])
def test_fused_estep(case, regime, backend):
    p = _problem(case, regime)
    t, j = _torch(p), _jax(p)
    mt, gt, bt = tops.fused_estep(t["X"], t["rho"], t["beta"], t["w"],
                                  eps=EPS)
    mj, gj, bj = jops.fused_estep(j["X"], j["rho"], j["beta"], j["w"],
                                  eps=EPS, backend=backend)
    _close_rows(mt, mj)
    if regime == "well":
        _close_rows(gt, gj)
        _close_max(bt, bj)
    else:
        _hinge_gamma(mt, gt, mj, gj)
        p = dict(p, wm=None)
        _close_max(bt, _stats64(p, gt)[0])


def _weights(p, regime):
    """Sigma weights as both packages receive them: well-conditioned
    1/gamma in [0.5, 20], or the heavy-tailed hinge weights 1/gamma at
    the clamp (an input here, so no amplification between packages)."""
    if regime == "well":
        m = p["X"].astype(np.float64) @ p["w"].astype(np.float64)
        g = np.abs(p["rho"] - m).clip(EPS)
    else:
        m = p["X"] @ p["w"]
        g = np.abs(p["rho"] - m).clip(EPS)
    return (1.0 / g).astype(np.float32)


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("regime", ["well", "hinge"])
@pytest.mark.parametrize("case", ["odd", "ragged", "odd-bf16"])
@pytest.mark.parametrize("fn", ["syrk_tri", "weighted_gram"])
def test_sigma(fn, case, regime, backend):
    p = _problem(case, regime)
    t, j = _torch(p), _jax(p)
    wv = _weights(p, regime)
    port = (tops.syrk_tri(t["X"], torch.from_numpy(wv)) if fn == "syrk_tri"
            else tref.weighted_gram(t["X"], torch.from_numpy(wv)))
    want = getattr(jops, fn)(j["X"], jnp.asarray(wv), backend=backend)
    _close_max(port, want)
    S64 = (p["X"].astype(np.float64) * wv[:, None]).T @ p["X"]
    _close_max(port, S64)


def test_padded_rows_are_no_ops():
    """Appending padding rows (X-row 0, rho = beta = 0) gives gamma = eps
    and margin 0 on those rows and leaves b and Sigma unchanged up to the
    summation order of a longer matmul."""
    p = _problem("odd", "hinge")
    t = _torch(p)
    base = tops.fused_stats(t["X"], t["rho"], t["beta"], t["w"], None,
                            eps=EPS)
    z = torch.zeros(5)
    padded = tops.fused_stats(
        torch.cat([t["X"], torch.zeros(5, t["X"].shape[1])]),
        torch.cat([t["rho"], z]), torch.cat([t["beta"], z]), t["w"], None,
        eps=EPS)
    _close_max(padded[2], base[2])
    _close_max(padded[3], base[3])
    assert torch.all(padded[0][-5:] == 0)
    assert torch.all(padded[1][-5:] == torch.tensor(EPS, dtype=torch.float32))


def test_wide_route_matches_one_pass():
    """K > FUSED_STATS_MAX_K goes through fused_estep + syrk_tri; it gives
    the one-pass statistic."""
    p = _problem("wide", "well")
    t = _torch(p)
    routed = tops.fused_stats(t["X"], t["rho"], t["beta"], t["w"], None,
                              eps=EPS)
    one = tref.fused_stats(t["X"], t["rho"], t["beta"], t["w"], None, EPS)
    for a, b in zip(routed, one):
        _close_max(a, b)


@pytest.mark.parametrize("kw,exc", [
    (dict(epilogue="mc_hinge", noise=(torch.zeros(3), torch.zeros(3))),
     NotImplementedError),
    (dict(epilogue="em_svr"), NotImplementedError),
    (dict(col_window=(0, 2)), NotImplementedError),
    (dict(epilogue="em_hinge", noise=(torch.zeros(3),)), ValueError),
    (dict(backend="pallas"), ValueError),
    (dict(backend="cuda"), ValueError),
])
def test_ops_rejects(kw, exc):
    X = torch.zeros(3, 2)
    v = torch.zeros(3)
    with pytest.raises(exc):
        tops.fused_stats(X, v, v, torch.zeros(2), **kw)
