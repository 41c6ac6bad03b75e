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

mc_hinge (the Gibbs draw): the IG transform cancels at large mu, so its
rounding matters. Gamma is held to the reference's epilogue evaluated on
the port's own margin and noise (identical residuals and noise): at least
99 % of rows bitwise equal, at least 99.95 % within 1e-3 relative, every
row finite and >= eps. (PyTorch's float32 ``sqrt`` on the CPU is not
correctly rounded; the port rounds a float64 sqrt once, as IEEE and XLA's
eager ``sqrt`` do.) Margins are held to 1e-5 max|ref| and b, Sigma to a float64
recomputation from the port's own gamma, as in the hinge regime. The
counter seed's noise itself is held by tests/test_torch_rng.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import epilogues as jepi
from repro.kernels import ops as jops
from repro.kernels import rng as jrng
from repro_torch.core import prng
from repro_torch.kernels import epilogues as tepi
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rng as trng

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
    (dict(epilogue="mc_svr", noise=(torch.zeros(3),) * 2), ValueError),
    (dict(epilogue="em_svr", noise=(torch.zeros(3),) * 4), ValueError),
    (dict(col_window=(0, 3)), ValueError),
    (dict(epilogue="em_hinge", noise=(torch.zeros(3),)), ValueError),
    (dict(backend="pallas"), ValueError),
    (dict(backend="cuda"), ValueError),
])
def test_ops_rejects(kw, exc):
    X = torch.zeros(3, 2)
    v = torch.zeros(3)
    with pytest.raises(exc):
        tops.fused_stats(X, v, v, torch.zeros(2), **kw)


@pytest.mark.parametrize("kw", [
    dict(epilogue="mc_svr", noise=(torch.zeros(3),) * 4),
    dict(epilogue="em_svr"),
])
def test_ops_svr_epilogues_run(kw):
    """The two SVR calls test_ops_rejects once held as not ported: the
    statistic runs and returns (margin, gamma, omega, b, S); at y = 0,
    w = 0 every row sits at res = 0, so em_svr gives gamma = omega =
    eps_ins."""
    X = torch.ones(3, 2)
    v = torch.zeros(3)
    out = tops.fused_stats(X, v, v, torch.zeros(2), eps_ins=0.25, **kw)
    assert len(out) == 5
    assert [tuple(t.shape) for t in out] == [(3,), (3,), (3,), (2,), (2, 2)]
    assert all(bool(torch.all(torch.isfinite(t))) for t in out)
    if kw["epilogue"] == "em_svr":
        assert torch.all(out[1] == 0.25) and torch.all(out[2] == 0.25)
        assert torch.allclose(out[4], torch.full((2, 2), 3 * 2 / 0.25))


# ----------------------------------------------------------------- mc_hinge
def _gamma_band(got, want, eps=EPS):
    """>= 99 % of rows bitwise equal, >= 99.95 % within 1e-3 relative,
    every row finite and >= eps."""
    got = np.asarray(got, np.float32).ravel()
    want = np.asarray(want, np.float32).ravel()
    assert np.all(np.isfinite(got)) and np.all(got >= np.float32(eps))
    rel = np.abs(got.astype(np.float64) - want) / np.abs(want)
    assert np.mean(got == want) >= 0.99, np.mean(got == want)
    assert np.mean(rel <= 1e-3) >= 0.9995, np.sort(rel)[-5:]


def test_ig_gamma_from_noise_matches_reference():
    """200,000 rows, residual 0.5 N(0, 1), the same (nu, u) both sides."""
    g = np.random.default_rng(0)
    n = 200_000
    res = (0.5 * g.normal(size=n)).astype(np.float32)
    nu = g.normal(size=n).astype(np.float32)
    u = g.random(n).astype(np.float32)
    got = tepi.ig_gamma_from_noise(torch.from_numpy(res),
                                   torch.from_numpy(nu),
                                   torch.from_numpy(u), EPS)
    assert got.dtype == torch.float32
    want = jepi.ig_gamma_from_noise(jnp.asarray(res), jnp.asarray(nu),
                                    jnp.asarray(u), EPS)
    _gamma_band(got.numpy(), want)


@pytest.mark.parametrize("regime", ["well", "hinge"])
def test_mc_hinge_epilogue_matches_reference(regime):
    p = _problem("ragged", regime)
    g = np.random.default_rng(1)
    n = p["X"].shape[0]
    nu = g.normal(size=n).astype(np.float32)
    u = g.random(n).astype(np.float32)
    m = (p["X"] @ p["w"]).astype(np.float32)
    T = torch.from_numpy
    (gt,), wt, ct = tepi.apply_epilogue(
        "mc_hinge", T(m), T(p["rho"]), T(p["beta"]), (T(nu), T(u)), EPS)
    (gj,), wj, cj = jepi.apply_epilogue(
        "mc_hinge", jnp.asarray(m), jnp.asarray(p["rho"]),
        jnp.asarray(p["beta"]), (jnp.asarray(nu), jnp.asarray(u)), EPS)
    _gamma_band(gt.numpy(), gj)
    same = gt.numpy() == np.asarray(gj)
    assert np.array_equal(wt.numpy()[same], np.asarray(wj)[same])
    assert np.array_equal(ct.numpy()[same], np.asarray(cj)[same])


KEY_SEED = 17


def _mc_inputs(p, source, n_chains=1, row0=0, chain0=0):
    """Noise operands (identical numpy draws for both packages) or the
    same counter seed words, and a (K, C) wvec for C chains."""
    n, k = p["X"].shape
    g = np.random.default_rng(2)
    out = {}
    if source == "noise":
        nu = g.normal(size=n).astype(np.float32)
        u = g.random(n).astype(np.float32)
        out["t"] = dict(noise=(torch.from_numpy(nu), torch.from_numpy(u)))
        out["j"] = dict(noise=(jnp.asarray(nu), jnp.asarray(u)))
    else:
        key = jax.random.fold_in(jax.random.PRNGKey(KEY_SEED), 3)
        tkey = prng.fold_in(prng.PRNGKey(KEY_SEED), 3)
        out["t"] = dict(seed=trng.pack_seed(tkey, row0, chain0))
        out["j"] = dict(seed=jrng.pack_seed(key, row0, chain0))
    if n_chains > 1:
        W = np.stack([p["w"] * (1.0 + 0.5 * c) for c in range(n_chains)],
                     axis=1).astype(np.float32)
        out["tw"], out["jw"] = torch.from_numpy(W), jnp.asarray(W)
    else:
        out["tw"] = torch.from_numpy(p["w"])
        out["jw"] = jnp.asarray(p["w"])
    return out


def _port_noise(inp, n, n_chains):
    if "noise" in inp["t"]:
        return inp["t"]["noise"]
    return tref.seed_noise(inp["t"]["seed"], n, n_chains, "mc_hinge")


def _check_mc(p, inp, port, n_chains):
    """Port outputs against the reference's epilogue on the port's own
    margin and noise, and b, Sigma against a float64 recomputation."""
    mt, gt, bt, St = port
    n, k = p["X"].shape
    nu, u = (z.numpy() for z in _port_noise(inp, n, n_chains))
    rho, beta = p["rho"], p["beta"]
    if n_chains > 1:
        rho, beta = rho[:, None], beta[:, None]
    (gj,), _, _ = jepi.apply_epilogue(
        "mc_hinge", jnp.asarray(mt.numpy()), jnp.asarray(rho),
        jnp.asarray(beta), (jnp.asarray(nu), jnp.asarray(u)), EPS)
    _gamma_band(gt.numpy(), gj)
    if n_chains == 1:
        b64, S64 = _stats64(p, gt.numpy())
        _close_max(bt, b64)
        _close_max(St, S64)
        return
    assert tuple(bt.shape) == (k, n_chains)
    assert tuple(St.shape) == (n_chains, k, k)
    for c in range(n_chains):
        b64, S64 = _stats64(p, gt.numpy()[:, c])
        _close_max(bt[:, c], b64)
        _close_max(St[c], S64)


@pytest.mark.parametrize("source,n_chains", [("noise", 1), ("seed", 1),
                                             ("seed", 3)])
@pytest.mark.parametrize("regime", ["well", "hinge"])
@pytest.mark.parametrize("case", ["odd", "ragged", "odd-bf16"])
def test_fused_stats_mc_hinge(case, regime, source, n_chains):
    p = _problem(case, regime)
    t, j = _torch(p), _jax(p)
    inp = _mc_inputs(p, source, n_chains)
    port = tops.fused_stats(t["X"], t["rho"], t["beta"], inp["tw"], t["wm"],
                            epilogue="mc_hinge", eps=EPS, **inp["t"])
    want = jops.fused_stats(j["X"], j["rho"], j["beta"], inp["jw"], j["wm"],
                            epilogue="mc_hinge", eps=EPS, backend="ref",
                            **inp["j"])
    n = p["X"].shape[0]
    shape = (n, n_chains) if n_chains > 1 else (n,)
    assert tuple(port[0].shape) == tuple(port[1].shape) == shape
    _close_max(port[0], want[0])
    _check_mc(p, inp, port, n_chains)


@pytest.mark.parametrize("n_chains", [1, 3])
def test_fused_stats_mc_seed_vs_interpret(n_chains):
    """The reference's Pallas body in interpret mode, several row tiles
    (block_n=8) at a shifted row0 and chain0: its in-body noise uses the
    tile-row offset. The well regime keeps 1/gamma tame, so the interpret
    gammas (another evaluation context of the reference) are held within
    1e-3 relative on every row."""
    p = _problem("odd", "well")
    t, j = _torch(p), _jax(p)
    inp = _mc_inputs(p, "seed", n_chains, row0=29, chain0=2)
    port = tops.fused_stats(t["X"], t["rho"], t["beta"], inp["tw"], t["wm"],
                            epilogue="mc_hinge", eps=EPS, **inp["t"])
    want = jops.fused_stats(j["X"], j["rho"], j["beta"], inp["jw"], j["wm"],
                            epilogue="mc_hinge", eps=EPS,
                            backend="interpret", block_n=8, **inp["j"])
    _close_max(port[0], want[0])
    g_t = port[1].numpy().astype(np.float64)
    g_j = np.asarray(want[1], np.float64)
    assert np.all(np.abs(g_t - g_j) <= 1e-3 * g_j), np.max(
        np.abs(g_t - g_j) / g_j)
    _check_mc(p, inp, port, n_chains)


@pytest.mark.parametrize("source", ["noise", "seed"])
def test_wide_mc_route_matches_one_pass(source):
    """K > FUSED_STATS_MAX_K with mc_hinge takes the generalised split
    fallback (plain E-step, then syrk_tri); it gives the one-pass
    statistic."""
    p = _problem("wide", "well")
    t = _torch(p)
    inp = _mc_inputs(p, source)
    routed = tops.fused_stats(t["X"], t["rho"], t["beta"], inp["tw"], None,
                              epilogue="mc_hinge", eps=EPS, **inp["t"])
    one = tref.fused_stats(t["X"], t["rho"], t["beta"], inp["tw"], None,
                           EPS, "mc_hinge", **inp["t"])
    _close_max(routed[0], one[0])
    _gamma_band(routed[1].numpy(), one[1].numpy())
    _close_max(routed[2], one[2])
    _close_max(routed[3], one[3])


@pytest.mark.parametrize("kw", [
    dict(epilogue="mc_hinge"),
    dict(epilogue="mc_hinge", noise=(torch.zeros(3),)),
    dict(epilogue="mc_hinge", noise=(torch.zeros(3),) * 2,
         seed=torch.zeros(4, dtype=torch.int64)),
    dict(epilogue="mc_hinge", wvec=torch.zeros(2, 3),
         noise=(torch.zeros(3),) * 2),
])
def test_ops_rejects_bad_mc_noise(kw):
    X = torch.zeros(3, 2)
    v = torch.zeros(3)
    wvec = kw.pop("wvec", torch.zeros(2))
    with pytest.raises(ValueError):
        tops.fused_stats(X, v, v, wvec, **kw)
