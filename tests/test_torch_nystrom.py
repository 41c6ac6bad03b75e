"""The port's Nystrom kernel SVM (``repro_torch``) against the JAX
package's, on the CPU.

Inputs come from numpy seeds and reach both packages as numpy arrays. The
JAX side runs its plain versions (``backend="ref"``) and its Pallas
kernels in interpret mode; the port runs its plain versions (the CUDA
kernels' CPU path). Tolerances, each with its reason:

* RBF Gram: rtol 1e-5, atol 1e-7. d2 = |x|^2 - 2 x.l + |l|^2 cancels for
  near points: a few ulps of |x|^2 + |l|^2, scaled by 1 / 2 sigma^2.
* phi and scores: |d phi| <= 1e-5 (|k| @ |proj|) elementwise (and through
  |W| for scores): the error of a dot product whose terms have mixed
  signs scales with the sum of their magnitudes, not with the result.
* statistic: margins as phi (through |w|); em_hinge gamma by the hinge
  rule |dg| <= |dm| + 2^-24 (g_a + g_b) + 1e-7 (max and |.| are
  1-Lipschitz, each side rounds rho - m once); mc_hinge gamma against the
  reference's eager epilogue on the port's own margin and noise (>= 99 %
  bitwise, >= 99.95 % within 1e-3, the rule of
  tests/test_torch_kernels_ref.py); b and Sigma within 1e-5 max of a
  float64 recomputation from the port's own phi and gamma, and within
  1e-4 max|ref| of the JAX package's at a w away from the hinge (where
  1/gamma does not amplify a one-ulp margin difference).
* whole fits: the EM bands of test_torch_em_cls.py (iterations within 3,
  objective trace 2e-2 relative, weights 5e-2 relative, accuracy 0.01)
  and the MC bands of test_torch_mc_cls.py
  (weights 0.15 relative, accuracy 0.01: two correct Gibbs chains fork).
  Both packages fit on ONE featurizer, the reference's landmarks and
  projection carried across by ``convert.nystrom_from_reference``: two
  correct float32 landmark Grams can keep different eigenvalues above
  the spectral floor, so two projections are never compared entrywise;
  ``nystrom_projection`` is compared through phi phi^T instead, on a
  landmark set with no eigenvalue near the floor.
"""
import ctypes
import dataclasses
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import NystromSVM as JaxNystrom
from repro.core import SVMConfig as JaxConfig
from repro.core.nystrom import nystrom_projection as jax_projection
from repro.data import synthetic as jsyn
from repro.kernels import epilogues as jepi
from repro.kernels import ops as jops
from repro.kernels import rng as jrng
from repro_torch.core import (NystromSVM, PEMSVM, PhiSpec, SVMConfig,
                              nystrom_projection, prng)
from repro_torch.core.convert import nystrom_from_reference
from repro_torch.core.kernel import gram_matrix
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rng as trng

EPS = 1e-6
REL = 1e-5
KEY_SEED = 11
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Keep torch to two intra-op threads: the suite runs six workers at
    once, and timing-based tests elsewhere feel the contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _f64(*ts):
    return [np.asarray(t, np.float64) for t in ts]


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("n,seed", [(400, 0), (1001, 3), (4000, 2)])
def test_make_circles_bitwise(n, seed):
    Xt, yt = tsyn.make_circles(n, seed=seed)
    Xj, yj = jsyn.make_circles(n, seed=seed)
    assert Xt.dtype == Xj.dtype and yt.dtype == yj.dtype
    assert np.array_equal(Xt, Xj) and np.array_equal(yt, yj)


# -------------------------------------------------------------- rbf_gram
def _gram_inputs(dtype, seed=0):
    """37 x 29 against 45 x 29 (tests/test_kshard_fused.py's odd shape),
    rows scaled so distances are O(1); X2 repeats X1's first rows, so
    near-zero distances exercise the clamp."""
    g = np.random.default_rng(seed)
    X1 = (g.normal(size=(37, 29)) / np.sqrt(29)).astype(np.float32)
    X2 = (g.normal(size=(45, 29)) / np.sqrt(29)).astype(np.float32)
    X2[:5] = X1[:5]
    if dtype == "bf16":  # round once; both packages get the same values
        X1 = torch.from_numpy(X1).bfloat16().float().numpy()
        X2 = torch.from_numpy(X2).bfloat16().float().numpy()
    return X1, X2


def _as(arr, dtype, pkg):
    if pkg == "t":
        t = torch.from_numpy(arr)
        return t.bfloat16() if dtype == "bf16" else t
    a = jnp.asarray(arr)
    return a.astype(jnp.bfloat16) if dtype == "bf16" else a


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("sigma", [0.7, 2.0])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rbf_gram(dtype, sigma, backend):
    X1, X2 = _gram_inputs(dtype)
    got = tops.rbf_gram(_as(X1, dtype, "t"), _as(X2, dtype, "t"),
                        sigma=sigma)
    want = jops.rbf_gram(_as(X1, dtype, "j"), _as(X2, dtype, "j"),
                         sigma=sigma, backend=backend)
    assert got.dtype == torch.float32 and tuple(got.shape) == (37, 45)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("kind", ["rbf", "linear"])
def test_gram_matrix(kind):
    X1, X2 = _gram_inputs("f32", seed=1)
    got = gram_matrix(torch.from_numpy(X1), torch.from_numpy(X2), kind=kind,
                      sigma=0.9)
    from repro.core.kernel import gram_matrix as jgram
    want = jgram(jnp.asarray(X1), jnp.asarray(X2), kind=kind, sigma=0.9,
                 backend="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        gram_matrix(torch.from_numpy(X1), torch.from_numpy(X2), kind="poly")


# ----------------------------------------------------- phi and the score
# name: (N, D, m, padded rows, X dtype)
CASES = {
    "odd": (37, 7, 23, 0, "f32"),
    "ragged": (203, 7, 45, 13, "f32"),
    "odd-bf16": (37, 7, 23, 0, "bf16"),
}
SIGMA = 1.3


def _nys_problem(case, kind, seed=0):
    """X with padded tail rows (X-row 0, mask 0) and some masked rows,
    landmarks drawn from the rows, a mixed-sign projection, and the
    float64 scale |k| @ |proj| of each phi entry."""
    n, d, m, n_pad, dtype = CASES[case]
    g = np.random.default_rng(seed)
    X = g.normal(size=(n, d)).astype(np.float32)
    L = X[g.choice(n - n_pad, size=m, replace=False)].copy()
    X[n - n_pad:] = 0.0
    if dtype == "bf16":
        X = torch.from_numpy(X).bfloat16().float().numpy()
    proj = (0.2 * g.normal(size=(m, m))).astype(np.float32)
    mask = (g.uniform(size=n) > 0.2).astype(np.float32)
    mask[n - n_pad:] = 0.0
    X64, L64, P64 = _f64(X, L, proj)
    if kind == "rbf":
        d2 = ((X64[:, None, :] - L64[None, :, :]) ** 2).sum(-1)
        k64 = np.exp(-d2 / (2.0 * SIGMA ** 2))
    else:
        k64 = X64 @ L64.T
    return dict(X=X, L=L, proj=proj, mask=mask, k64=k64, P64=P64,
                bf16=dtype == "bf16", kind=kind)


def _phi64(p, add_bias):
    """phi in float64 and its error scale, both masked."""
    phi = p["k64"] @ p["P64"]
    scale = np.abs(p["k64"]) @ np.abs(p["P64"])
    if add_bias:
        one = np.ones((phi.shape[0], 1))
        phi, scale = np.hstack([phi, one]), np.hstack([scale, one])
    mk = p["mask"].astype(np.float64)[:, None]
    return phi * mk, scale * mk


def _nys_args(p, pkg):
    X = _as(p["X"], "bf16" if p["bf16"] else "f32", pkg)
    conv = torch.from_numpy if pkg == "t" else jnp.asarray
    return X, conv(p["L"]), conv(p["proj"]), conv(p["mask"])


def _within(got, want, scale):
    got, want = _f64(got, want)
    err = np.abs(got - want)
    assert np.all(err <= REL * scale), np.max(err - REL * scale)


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("add_bias", [False, True])
@pytest.mark.parametrize("kind", ["rbf", "linear"])
@pytest.mark.parametrize("case", list(CASES))
def test_nystrom_phi(case, kind, add_bias, backend):
    p = _nys_problem(case, kind)
    kw = dict(sigma=SIGMA, kind=kind, add_bias=add_bias)
    got = tops.nystrom_phi(*_nys_args(p, "t"), **kw)
    want = jops.nystrom_phi(*_nys_args(p, "j"), backend=backend,
                            **({"block_n": 8} if backend == "interpret"
                               else {}), **kw)
    n, m = p["X"].shape[0], p["L"].shape[0]
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (n, m + int(add_bias))
    _, scale = _phi64(p, add_bias)
    _within(got, want, scale)
    # masked rows are exactly zero: a zero X row is not a zero phi row
    assert not np.any(got.numpy()[p["mask"] == 0])
    if add_bias:  # the bias column is the mask, last
        assert np.array_equal(got.numpy()[:, -1], p["mask"])


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("kind", ["rbf", "linear"])
@pytest.mark.parametrize("case", list(CASES))
def test_nystrom_score(case, kind, C, backend):
    p = _nys_problem(case, kind, seed=1)
    m = p["L"].shape[0]
    W = np.random.default_rng(5).normal(size=(m + 1, C)).astype(np.float32)
    kw = dict(sigma=SIGMA, kind=kind, add_bias=True)
    X, L, P, mk = _nys_args(p, "t")
    got = tops.nystrom_score(X, L, P, torch.from_numpy(W), mk, **kw)
    X, L, P, mk = _nys_args(p, "j")
    want = jops.nystrom_score(X, L, P, jnp.asarray(W), mk, backend=backend,
                              **({"block_n": 8} if backend == "interpret"
                                 else {}), **kw)
    assert tuple(got.shape) == (p["X"].shape[0], C)
    _, scale = _phi64(p, True)
    _within(got, want, scale @ np.abs(W.astype(np.float64)))
    assert not np.any(got.numpy()[p["mask"] == 0])


# ------------------------------------------------------- the statistic
VARIANTS = ["em_hinge", "mc_hinge,noise", "mc_hinge,seed"]


def _stat_inputs(p, regime, variant, seed=2):
    """w, rho, beta for both packages and the MC noise source. well: rho =
    phi64.w +- U[0.05, 2] (gamma >= ~0.05); hinge: rho = beta = y."""
    n, m = p["X"].shape[0], p["L"].shape[0]
    g = np.random.default_rng(seed)
    w = (g.normal(size=m + 1) / np.sqrt(m)).astype(np.float32)
    y = (g.choice([-1.0, 1.0], n) * p["mask"]).astype(np.float32)
    if regime == "well":
        phi64, _ = _phi64(p, True)
        off = g.uniform(0.05, 2.0, n) * g.choice([-1.0, 1.0], n)
        rho = ((phi64 @ w.astype(np.float64)) + off).astype(np.float32)
        beta = g.normal(size=n).astype(np.float32)
    else:
        rho = beta = y
    epi, _, source = variant.partition(",")
    out = dict(w=w, rho=rho, beta=beta, epi=epi, t={}, j={})
    if source == "noise":
        nu = g.normal(size=n).astype(np.float32)
        u = g.random(n).astype(np.float32)
        out["t"]["noise"] = (torch.from_numpy(nu), torch.from_numpy(u))
        out["j"]["noise"] = (jnp.asarray(nu), jnp.asarray(u))
    elif source == "seed":
        key = jax.random.fold_in(jax.random.PRNGKey(KEY_SEED), 3)
        tkey = prng.fold_in(prng.PRNGKey(KEY_SEED), 3)
        out["t"]["seed"] = trng.pack_seed(tkey, 29, 0)
        out["j"]["seed"] = jrng.pack_seed(key, 29, 0)
    return out


def _gamma_band(got, want):
    got, want = _f64(got, want)
    assert np.all(np.isfinite(got)) and np.all(got >= np.float32(EPS))
    assert np.mean(got == want) >= 0.99
    assert np.mean(np.abs(got - want) <= 1e-3 * np.abs(want)) >= 0.9995


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("regime", ["well", "hinge"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", list(CASES))
def test_nystrom_fused_stats(case, variant, regime, backend):
    kind = "linear" if case == "ragged" else "rbf"
    p = _nys_problem(case, kind, seed=3)
    s = _stat_inputs(p, regime, variant)
    kw = dict(sigma=SIGMA, kind=kind, add_bias=True, epilogue=s["epi"],
              eps=EPS)
    X, L, P, mk = _nys_args(p, "t")
    mt, gt, bt, St = tops.nystrom_fused_stats(
        X, L, P, torch.from_numpy(s["rho"]), torch.from_numpy(s["beta"]),
        torch.from_numpy(s["w"]), mk, **s["t"], **kw)
    X, L, P, mk = _nys_args(p, "j")
    mj, gj, bj, Sj = jops.nystrom_fused_stats(
        X, L, P, jnp.asarray(s["rho"]), jnp.asarray(s["beta"]),
        jnp.asarray(s["w"]), mk, backend=backend,
        **({"block_n": 8} if backend == "interpret" else {}), **s["j"],
        **kw)
    M = p["L"].shape[0] + 1
    assert tuple(bt.shape) == (M,) and tuple(St.shape) == (M, M)
    _, scale = _phi64(p, True)
    _within(mt, mj, scale @ np.abs(s["w"].astype(np.float64)))
    if s["epi"] == "em_hinge":
        m_t, g_t, m_j, g_j = _f64(mt, gt, mj, gj)
        assert np.all(np.abs(g_t - g_j)
                      <= np.abs(m_t - m_j) + 2.0 ** -24 * (g_t + g_j) + 1e-7)
    else:
        n = p["X"].shape[0]
        noise = s["t"].get("noise") or tref.seed_noise(s["t"]["seed"], n, 1,
                                                       "mc_hinge")
        (g_ref,), _, _ = jepi.apply_epilogue(
            "mc_hinge", jnp.asarray(mt.numpy()), jnp.asarray(s["rho"]),
            jnp.asarray(s["beta"]),
            tuple(jnp.asarray(z.numpy()) for z in noise), EPS)
        _gamma_band(gt.numpy(), g_ref)
    # b and Sigma against float64 from the port's own phi and gamma
    phi = tref.nystrom_phi(*_nys_args(p, "t"), SIGMA, kind, True).double()
    g64 = gt.double()
    coef = torch.from_numpy(s["rho"]).double() / g64 + torch.from_numpy(
        s["beta"]).double()
    wt = torch.from_numpy(p["mask"]).double() / g64
    for got, want in ((bt, phi.T @ coef), (St, (phi * wt[:, None]).T @ phi)):
        err = (got.double() - want).abs().max()
        assert err <= REL * want.abs().max(), err
    if regime == "well":
        for got, want in ((bt, bj), (St, Sj)):
            got, want = _f64(got, want)
            assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))


def test_nystrom_fused_stats_route_past_max_m():
    """m > NYSTROM_FUSED_MAX_M takes the reference's featurize-then-
    accumulate route (nystrom_phi, then fused_stats, itself routed to
    fused_estep + syrk_tri past FUSED_STATS_MAX_K) and gives the one-pass
    plain statistic."""
    n, d, m = 40, 3, tops.FUSED_STATS_MAX_K + 8
    assert not tops.nystrom_fused_fits(m, d)
    g = np.random.default_rng(4)
    X = torch.from_numpy(g.normal(size=(n, d)).astype(np.float32))
    L = torch.from_numpy(g.normal(size=(m, d)).astype(np.float32))
    P = torch.from_numpy((0.05 * g.normal(size=(m, m))).astype(np.float32))
    mask = torch.from_numpy((g.uniform(size=n) > 0.2).astype(np.float32))
    y = torch.from_numpy(g.choice([-1.0, 1.0], n).astype(np.float32)) * mask
    w = torch.from_numpy((g.normal(size=m + 1) / m).astype(np.float32))
    kw = dict(sigma=1.0, kind="rbf", add_bias=True)
    routed = tops.nystrom_fused_stats(X, L, P, y, y, w, mask, **kw)
    one = tref.nystrom_fused_stats(X, L, P, y, y, w, mask, 1.0, "rbf", True,
                                   EPS)
    for a, b in zip(routed, one):
        err = (a.double() - b.double()).abs().max()
        assert err <= REL * b.double().abs().max(), err


@pytest.mark.parametrize("m,d,add_bias,epilogue,rng", [
    (1000, 2, True, "em_hinge", False), (1024, 2, True, "mc_hinge", False),
    (1024, 2, True, "mc_hinge", True), (1025, 2, True, "em_hinge", False),
    (900, 500, True, "em_hinge", False), (600, 1500, False, "mc_hinge", True),
    (700, 900, True, "mc_hinge", False), (700, 900, True, "mc_hinge", True),
    (64, 7, True, "em_svr", False),
])
def test_nystrom_fused_fits_matches_reference(m, d, add_bias, epilogue, rng):
    """The route rule and its byte formula are the reference's."""
    assert (tops.nystrom_fused_fits(m, d, add_bias, 256, epilogue, None, rng)
            == jops.nystrom_fused_fits(m, d, add_bias, 256, epilogue, None,
                                       rng))


def test_nystrom_ops_reject():
    X, v = torch.zeros(3, 2), torch.zeros(3)
    L, P, w = torch.zeros(2, 2), torch.zeros(2, 2), torch.zeros(3)
    with pytest.raises(ValueError, match="column"):
        tops.nystrom_fused_stats(X, L, P, v, v, w, add_bias=True,
                                 col_window=(2, 2))
    with pytest.raises(ValueError, match="column"):
        tref.nystrom_fused_stats(X, L, P, v, v, w, None, 1.0, "rbf", True,
                                 EPS, col_window=(2, 2))
    assert tops.nystrom_fused_stats(X, L, P, v, v, w, add_bias=True,
                                    col_window=(1, 2))[-1].shape == (3, 2)
    out = tops.nystrom_fused_stats(X, L, P, v, v, w, add_bias=True,
                                   epilogue="em_svr", eps_ins=0.25)
    assert len(out) == 5 and torch.all(out[2] == 0.25)
    with pytest.raises(ValueError, match="noise"):
        tops.nystrom_fused_stats(X, L, P, v, v, w, epilogue="mc_hinge")
    with pytest.raises(ValueError, match="kind"):
        tops.nystrom_phi(X, L, P, kind="poly")


# ------------------------------------------------------------ projection
def test_nystrom_projection_through_phi_phi_t():
    """Port and reference projections of one well-conditioned landmark set
    (a 5 x 4 grid, spacing 1, sigma 0.7: no eigenvalue within 10x of the
    floor) give the same phi phi^T on held-out rows. Bound: a relative
    perturbation e of K_mm moves K_mm^{-1/2} by about kappa e / 2, so
    |d(phi phi^T)| <= 4 kappa 2^-23 max|phi phi^T| with room for the
    float32 Gram of each package."""
    gx, gy = np.meshgrid(np.arange(5.0), np.arange(4.0))
    L = np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float32)
    Xh = (np.random.default_rng(6).uniform(-0.5, 4.5, size=(57, 2))
          ).astype(np.float32)
    P_t = nystrom_projection(L, sigma=0.7, device="cpu")
    P_j = np.asarray(jax_projection(L, sigma=0.7, backend="ref"))
    L64 = L.astype(np.float64)
    K = np.exp(-((L64[:, None] - L64[None]) ** 2).sum(-1) / (2 * 0.49))
    lam = np.linalg.eigvalsh(K)
    assert lam.min() > 10 * 1e-6 * lam.max()
    kappa = lam.max() / lam.min()
    k = np.exp(-((Xh.astype(np.float64)[:, None] - L64[None]) ** 2).sum(-1)
               / (2 * 0.49))
    G_t, G_j = (k @ P_t) @ (k @ P_t).T, (k @ P_j) @ (k @ P_j).T
    err = np.max(np.abs(G_t - G_j))
    assert err <= 4 * kappa * 2.0 ** -23 * np.max(np.abs(G_j)), (err, kappa)
    # and phi phi^T approximates the exact kernel on held-out rows
    Kx = np.exp(-((Xh.astype(np.float64)[:, None] - Xh[None]) ** 2).sum(-1)
                / (2 * 0.49))
    assert np.mean(np.abs(G_t - Kx)) < 0.05


# ------------------------------------------------------------ whole fits
OPTS = {
    "em": ("KRN-EM-CLS", {}),
    "mc-host": ("KRN-MC-CLS", dict(rng="host")),
    "mc-fused": ("KRN-MC-CLS", dict(rng="fused")),
}
M_LANDMARKS = 64


def _circles():
    X, y = tsyn.make_circles(4000, seed=0)
    Xh, yh = tsyn.make_circles(1000, seed=1)
    return X, y, Xh, yh


def _kcfg(cls, name, **kw):
    options, extra = OPTS[name]
    return cls.from_options(options, **{"lam": 0.1, "sigma": 0.7,
                                        "max_iters": 60, **extra, **kw})


@pytest.fixture(scope="module")
def fits():
    X, y, Xh, yh = _circles()
    out = {}
    for name in OPTS:
        jcfg = _kcfg(JaxConfig, name)
        ref = JaxNystrom(jcfg, n_landmarks=M_LANDMARKS)
        r_ref = ref.fit(X, y)
        port = nystrom_from_reference(
            dataclasses.asdict(jcfg), ref._landmarks, ref._proj,
            r_ref.weights, device="cpu")
        d_conv = port.decision_function(Xh)
        r_port = port.fit_featurized(X, y, ref._landmarks, ref._proj)
        out[name] = dict(ref=ref, r_ref=r_ref, port=port, r_port=r_port,
                         d_conv=d_conv)
    return dict(out, Xh=Xh, yh=yh, X=X, y=y)


def _rel(a, b):
    a, b = _f64(a, b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("name", list(OPTS))
def test_fit_bands(fits, name):
    f = fits[name]
    r, p = f["r_ref"], f["r_port"]
    assert r.converged and p.converged
    acc_r = f["ref"].score(fits["Xh"], fits["yh"])
    acc_p = f["port"].score(fits["Xh"], fits["yh"])
    assert abs(acc_r - acc_p) <= 0.01, (acc_r, acc_p)
    assert acc_p >= 0.99
    if name == "em":
        assert abs(r.n_iters - p.n_iters) <= 3, (r.n_iters, p.n_iters)
        o_r, o_p = _f64(r.objective, p.objective)
        n = min(len(o_r), len(o_p))
        assert np.max(np.abs(o_p[:n] - o_r[:n]) / np.abs(o_r[:n])) <= 2e-2
        assert _rel(p.weights, r.weights) <= 5e-2
    else:
        assert _rel(p.weights, r.weights) <= 0.15


@pytest.mark.parametrize("name", list(OPTS))
def test_converted_model_scores_like_reference(fits, name):
    """nystrom_from_reference carries the reference's featurizer and
    weights: decision values within 1e-5 (|phi| @ |w|) of the
    reference's, on held-out rows."""
    f = fits[name]
    Xh = fits["Xh"]
    want = f["ref"].decision_function(Xh)
    L64, P64 = _f64(f["ref"]._landmarks, f["ref"]._proj)
    k = np.exp(-((Xh.astype(np.float64)[:, None] - L64[None]) ** 2).sum(-1)
               / (2 * 0.49))
    scale = np.hstack([np.abs(k) @ np.abs(P64), np.ones((len(Xh), 1))])
    _within(f["d_conv"], want, scale @ np.abs(f["r_ref"].weights))
    assert f["port"].svm._n_features == 2


def test_landmarks_bitwise(fits):
    """The port draws the reference's landmark rows for the same seed,
    with m = ceil(sqrt(N)) by default."""
    X, y = fits["X"], fits["y"]
    for n_landmarks in (M_LANDMARKS, None):
        port = NystromSVM(_kcfg(SVMConfig, "em", max_iters=1, min_iters=1),
                          n_landmarks=n_landmarks, device="cpu")
        port.fit(X, y)
        ref = JaxNystrom(_kcfg(JaxConfig, "em", max_iters=1, min_iters=1),
                         n_landmarks=n_landmarks)
        ref.fit(X, y)
        assert port._landmarks.shape[0] == math.ceil(math.sqrt(len(X)))
        assert np.array_equal(port._landmarks, ref._landmarks)


@pytest.mark.parametrize("name", ["em", "mc-fused", "mc-host"])
def test_scan_equals_loop_exactly(fits, name):
    """Same step, key chain and featurizer: traces, the last sample and
    the stop are bitwise equal, and the scan driver syncs once a chunk."""
    X, y = fits["X"], fits["y"]
    ref = fits[name]["ref"]
    out = {}
    for driver in ("scan", "loop"):
        ny = NystromSVM(_kcfg(SVMConfig, name, driver=driver, scan_chunk=8),
                        device="cpu")
        out[driver] = ny.fit_featurized(X, y, ref._landmarks, ref._proj)
    s, lo = out["scan"], out["loop"]
    assert s.objective == lo.objective and s.aux_history == lo.aux_history
    assert np.array_equal(s.last_sample, lo.last_sample)
    assert (s.n_iters, s.converged) == (lo.n_iters, lo.converged)
    assert s.n_host_syncs <= math.ceil(60 / 8)
    w, wl = _f64(s.weights, lo.weights)
    assert np.max(np.abs(w - wl)) <= 1e-5 * np.max(np.abs(wl))


# ------------------------------------------------ config and the surface
def test_phi_spec_and_delegate_config():
    """PhiSpec and the delegate config stay hashable; every field carries
    over to the LIN delegate except formulation, add_bias and phi_spec."""
    cfg = SVMConfig(formulation="KRN", algorithm="MC", lam=0.37, eps=1e-3,
                    sigma=0.9, max_iters=77, min_iters=7, patience=3,
                    tol=2e-3, driver="loop", scan_chunk=11, burnin=4,
                    jitter=3e-5, backend="ref", seed=42, rng="fused")
    ny = NystromSVM(cfg, device="cpu")
    d = ny.svm.config
    assert hash(PhiSpec()) == hash(PhiSpec()) and hash(d) is not None
    assert d.phi_spec == PhiSpec(sigma=0.9, kind="rbf", add_bias=True)
    for f in dataclasses.fields(SVMConfig):
        want = {"formulation": "LIN", "add_bias": False,
                "phi_spec": d.phi_spec}.get(f.name, getattr(cfg, f.name))
        assert getattr(d, f.name) == want, f.name
    assert SVMConfig(formulation="KRN").jitter == 1e-4
    assert NystromSVM(SVMConfig(formulation="KRN"),
                      device="cpu").svm.config.jitter == 1e-4


def test_out_of_slice_raises():
    with pytest.raises(AssertionError, match="single-chain"):
        NystromSVM(SVMConfig(formulation="KRN", algorithm="MC", rng="fused",
                             n_chains=2), device="cpu")
    with pytest.raises(ValueError, match="KRN"):
        NystromSVM(SVMConfig(), device="cpu")
    with pytest.raises(AssertionError, match="pick one"):
        NystromSVM(SVMConfig(formulation="KRN", window=2, decay=0.5,
                             driver="stream"), device="cpu")
    # KRN-SVR is in the slice now: the delegate carries the task
    svr = NystromSVM(SVMConfig(formulation="KRN", task="SVR"), device="cpu")
    assert svr.svm.config.task == "SVR" and svr.svm.config.phi_spec
    ny = NystromSVM(SVMConfig(formulation="KRN"), device="cpu")
    X, y = tsyn.make_circles(64)
    with pytest.raises(NotImplementedError, match="item 11"):
        ny.fit(X, y, resume_from=object())
    # warm_start, fit_libsvm and serving are ported: a donor of another
    # width, a missing file and an unfitted model are refused
    donor = dataclasses.replace(ny.fit(X, y), last_sample=np.ones(
        3, np.float32))
    with pytest.raises(ValueError, match="warm_start weights have"):
        ny.fit(X, y, warm_start=donor)
    with pytest.raises(FileNotFoundError):
        ny.fit_libsvm("/nonexistent/data.libsvm", 2)
    fresh = NystromSVM(SVMConfig(formulation="KRN"), device="cpu")
    with pytest.raises(RuntimeError, match="fit first"):
        fresh.export_servable()
    with pytest.raises(RuntimeError, match="fit first"):
        fresh.scorer()
    with pytest.raises(RuntimeError, match="fit first"):
        fresh._phi(X)


def test_exact_krn_and_nystrom_mlt_fit():
    """What this file once held as not ported fits now: PEMSVM with
    formulation='KRN' (the exact-Gram solver) and NystromSVM with
    task='MLT' (the delegate's class sweep in phi-space)."""
    X, y = tsyn.make_circles(200)
    krn = PEMSVM(SVMConfig(formulation="KRN", lam=0.1, sigma=0.7,
                           max_iters=20), device="cpu")
    krn.fit(X, y)
    assert krn.score(X, y) > 0.95
    rng = np.random.default_rng(2)
    Xm = rng.normal(size=(400, 4)).astype(np.float32)
    lm = np.argmax(np.abs(Xm[:, :3]), axis=1).astype(np.int32)
    ny = NystromSVM(SVMConfig(formulation="KRN", task="MLT", num_classes=3,
                              sigma=2.0, max_iters=10), n_landmarks=30,
                    device="cpu")
    res = ny.fit(Xm, lm)
    assert ny.svm.config.task == "MLT" and res.weights.shape == (3, 31)
    assert ny.decision_function(Xm).shape == (400, 3)
    assert ny.score(Xm, lm) > 0.7


def test_host_phi_oracle_matches_device_path(fits):
    """``_phi`` (float64 projection on the host) against the plain device
    featurizer, with the bias column last."""
    port = fits["em"]["port"]
    Xh = fits["Xh"][:50]
    host = port._phi(Xh, add_bias=True)
    dev = tops.nystrom_phi(torch.from_numpy(Xh),
                           torch.from_numpy(port._landmarks),
                           torch.from_numpy(port._proj), sigma=0.7,
                           add_bias=True).numpy()
    L64, P64 = _f64(port._landmarks, port._proj)
    k = np.exp(-((Xh.astype(np.float64)[:, None] - L64[None]) ** 2).sum(-1)
               / (2 * 0.49))
    scale = np.hstack([np.abs(k) @ np.abs(P64), np.ones((50, 1))])
    _within(dev, host, scale)
    assert np.array_equal(host[:, -1], np.ones(50, np.float32))


def test_no_card_raises_instead_of_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is cuda:0")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NystromSVM(SVMConfig(formulation="KRN"))


_C_TYPES = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
            "float": ctypes.c_float, "void*": ctypes.c_void_p}


def _c_signatures():
    out = {}
    for src in sorted((ROOT / "src" / "repro_torch" / "csrc").glob("*.cu")):
        text = src.read_text()
        for name, args in re.findall(
                r'extern "C" int (rt_\w+)\(\s*(.*?)\)\s*\{', text, re.S):
            types = []
            for a in args.split(","):
                a = a.replace("const ", "").replace("*", "* ").split()
                types.append(_C_TYPES["void*" if a[0].endswith("*")
                                      else a[0]])
            out[name] = types
    return out


def test_ctypes_signatures_match_the_c_launchers():
    """Every launcher's argument types, read from its C source, are the
    ones ``_build`` declares to ctypes (a mismatch would cut a pointer
    or an int64 to 32 bits at the call)."""
    c = _c_signatures()
    assert set(c) == set(_build._SIGNATURES)
    for name, types in c.items():
        assert types == _build._SIGNATURES[name], name
