"""The port's SVR (LIN- and KRN-{EM,MC}-SVR, the paper's Table 6) against
the JAX package's, on the CPU.

Inputs come from numpy seeds and reach both packages as numpy arrays.
Tolerances, each with its reason:

* data, counter words, split keys and uniforms: exact (integer work, or
  one float conversion of the same integer). Normals within 4 ulp, the
  bound of tests/test_torch_prng.py and tests/test_torch_rng.py (the two
  libraries' log, log1p and cos differ by an ulp).
* em_svr: every output bitwise equal to the reference's eager epilogue on
  the same margin (res = y - m, res -+ eps_ins, |.|, max, reciprocals:
  single IEEE operations on both sides).
* mc_svr: gamma and omega against the reference's eager epilogue on the
  same margin and noise: bitwise on every row whose residual for that
  mixture, |res -+ eps_ins|, is at least 0.15 (mu <= ~7, the regime of
  tests/test_mc_fused.py); elsewhere the band of tests/test_torch_
  kernels_ref.py (>= 99 % of rows bitwise, >= 99.95 % within 1e-3
  relative): at a knee mu reaches 1e8 and the transform cancels.
* the statistic: margins |d| <= 1e-5 (1 + |v|) of the reference's; b and
  Sigma within 1e-5 max of a float64 recomputation from the port's own
  gamma and omega, and, in the well regime (every |res -+ eps_ins| >=
  0.05, so 1/gamma amplifies no rounding), within 1e-5 max|ref| of the
  reference's (1e-4 max|ref| in phi-space, the bound of
  tests/test_torch_nystrom.py: the two packages' phi differ by up to
  1e-5 (|k| @ |proj|), which the mixed-sign projection makes a larger
  share of phi). Against the reference's Pallas body in interpret mode
  (jitted, another evaluation context) the well-regime gamma and omega
  are held within 1e-5 (1 + |v|) for em_svr and 1e-3 relative for
  mc_svr.
* whole fits, at the CPU anchor sizes (LIN: make_year_like(60,000,
  90), 50,000 rows to train; KRN: make_year_like(30,000, 90), 25,000 to
  train, m = ceil(sqrt(N)) = 159): the EM bands of
  tests/test_torch_em_cls.py (iterations within 3, weights within 5e-2
  relative) and the MC bands of tests/test_torch_mc_cls.py (both
  converged, iterations within 15, weights within 0.15 relative), and
  held-out RMSE within 0.01 of the reference's. EM-SVR's objective trace
  is held within 5e-2 relative, not em_cls's 2e-2: the EM-SVR iteration
  is sensitive at the two knees (rows with |res -+ eps_ins| below eps
  take the weight 1/eps), so that a float64 EM whose targets move by
  1e-15 relative drifts about as far as two float32 fits, and a float32
  E-step with float64 Sigma and Cholesky stays as far from float64 as a
  float32 fit (ROADMAP section 3). Here the port's trace reads 2.3e-2 (LIN)
  and 3.4e-2 (KRN) from the reference's, so 2e-2 would fail two correct
  fits; 5e-2 is 1.5-2.2x those readings. The port's EM traces are also
  held within 5e-2 of a float64 EM of the same rows, where they read
  1.1e-2 (LIN) and 2.4e-2 (KRN) at these sizes; at the card's 463,715
  rows the spread is larger, and ``chip_smoke.py`` phase 9 prints it
  without a gate. KRN fits share the reference's featurizer
  (``convert.nystrom_from_reference``).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import NystromSVM as JaxNystrom
from repro.core import PEMSVM as JaxSVM
from repro.core import SVMConfig as JaxConfig
from repro.core import augment as jaug
from repro.core import objective as jobj
from repro.data import synthetic as jsyn
from repro.kernels import epilogues as jepi
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import rng as jrng
from repro_torch.core import (NystromSVM, PEMSVM, SVMConfig, lam_from_C,
                              prng)
from repro_torch.core import augment as taug
from repro_torch.core import objective as tobj
from repro_torch.core.convert import (config_from_reference,
                                      nystrom_from_reference,
                                      svm_from_reference)
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import epilogues as tepi
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rng as trng

EPS = 1e-6
EPS_INS = 0.3
REL = 1e-5
ULP = 4
KEY_SEED = 23


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


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _close_rows(got, want):
    got, want = _f64(got, want)
    assert np.all(np.abs(got - want) <= REL * (1.0 + np.abs(want))), (
        np.max(np.abs(got - want)))


def _close_max(got, want):
    got, want = _f64(got, want)
    err, scale = np.max(np.abs(got - want)), np.max(np.abs(want))
    assert err <= REL * scale, (err, scale)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("kw", [dict(n=301, k=17, seed=3),
                                dict(n=2000, k=90),
                                dict(n=1001, k=90, seed=5, noise=0.1)])
def test_make_year_like_bitwise(kw):
    Xt, yt = tsyn.make_year_like(**kw)
    Xj, yj = jsyn.make_year_like(**kw)
    assert Xt.dtype == Xj.dtype and yt.dtype == yj.dtype
    assert np.array_equal(Xt, Xj) and np.array_equal(yt, yj)


# ------------------------------------------------------------ the noise
@pytest.mark.parametrize("chain", [0, 1, 2 ** 29 + 3])
def test_mixture_one_counter_words_exact(chain):
    """SVR's omega mixture uses counter words c1 = chain*4 + 2 (the
    normal's two words) and chain*4 + 3 (the uniform's)."""
    g = np.random.default_rng(chain % 97)
    rows = g.integers(0, 2 ** 32, 2000).astype(np.uint32)
    k0, k1 = np.uint32(0x9E3779B9), np.uint32(0x7F4A7C15)
    for word in (2, 3):
        c1 = np.uint32((chain * 4 + word) % 2 ** 32)
        want = jrng.threefry2x32(k0, k1, jnp.asarray(rows), c1)
        got = trng.threefry2x32(int(k0), int(k1),
                                torch.from_numpy(rows.astype(np.int64)),
                                int(c1))
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int64))
    # and counter_noise's second pair is built on exactly those words
    key = jax.random.fold_in(jax.random.PRNGKey(KEY_SEED), chain % 7)
    tkey = prng.fold_in(prng.PRNGKey(KEY_SEED), chain % 7)
    kw_j, kw_t = jrng.key_words(key), trng.key_words(tkey)
    want = jrng.counter_noise(kw_j[0], kw_j[1], jnp.asarray(rows), chain, 4)
    got = trng.counter_noise(kw_t[0], kw_t[1],
                             torch.from_numpy(rows.astype(np.int64)), chain,
                             4)
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    assert _ulps(got[2].numpy(), want[2]).max() <= ULP
    n0, n1 = trng.threefry2x32(kw_t[0], kw_t[1],
                               torch.from_numpy(rows.astype(np.int64)),
                               (chain * 4 + 2) % 2 ** 32)
    assert torch.equal(got[2], trng.normal_from_bits(n0, n1))


@pytest.mark.parametrize("n_chains", [1, 3])
def test_seed_noise_mc_svr(n_chains):
    """ref.seed_noise under mc_svr: four planes, (nu_g, u_g, nu_o, u_o),
    the reference's layout."""
    jseed = jrng.pack_seed(jax.random.PRNGKey(8), 21, 2)
    tseed = trng.pack_seed(prng.PRNGKey(8), 21, 2)
    want = jref.seed_noise(jseed, 301, n_chains, "mc_svr")
    got = tref.seed_noise(tseed, 301, n_chains, "mc_svr")
    assert len(got) == len(want) == 4
    shape = (301, n_chains) if n_chains > 1 else (301,)
    for m in range(2):
        assert tuple(got[2 * m].shape) == shape
        assert _ulps(got[2 * m].numpy(), want[2 * m]).max() <= ULP
        assert np.array_equal(got[2 * m + 1].numpy(),
                              np.asarray(want[2 * m + 1]))


@pytest.mark.parametrize("row0", [0, 37])
def test_host_svr_noise_matches_split_key_draws(row0):
    """rng='host' SVR noise: gamma's pair from k_lo, omega's from k_hi
    of one split; the port's own draw_ig_noise on the split keys
    bitwise, and the reference's within the stated ulps."""
    n = 3000
    kj = jax.random.fold_in(jax.random.PRNGKey(KEY_SEED), 4)
    kt = prng.fold_in(prng.PRNGKey(KEY_SEED), 4)
    got = taug.draw_svr_noise(kt, n, row0)
    lo, hi = prng.split(kt)
    own = taug.draw_ig_noise(lo, n, row0) + taug.draw_ig_noise(hi, n, row0)
    assert all(torch.equal(a, b) for a, b in zip(got, own))
    k_lo, k_hi = jax.random.split(kj)
    want = jaug.draw_ig_noise(k_lo, n, row0) + jaug.draw_ig_noise(k_hi, n,
                                                                   row0)
    for m in range(2):
        assert _ulps(got[2 * m].numpy(), want[2 * m]).max() <= ULP
        assert np.array_equal(got[2 * m + 1].numpy(),
                              np.asarray(want[2 * m + 1]))
    # swapped mixtures would be a silent fault: the planes differ
    assert not torch.equal(got[1], got[3])


# -------------------------------------------------------- the epilogues
def _epi_inputs(n=20_000, seed=0):
    g = np.random.default_rng(seed)
    m = g.normal(size=n).astype(np.float32)
    y = (m + 0.8 * g.normal(size=n)).astype(np.float32)
    y[:50] = m[:50] + np.float32(EPS_INS)   # rows on the knees
    y[50:100] = m[50:100] - np.float32(EPS_INS)
    noise = tuple(a.astype(np.float32) for a in (
        g.normal(size=n), g.random(n), g.normal(size=n), g.random(n)))
    return m, y, noise


def test_em_svr_epilogue_bitwise():
    m, y, _ = _epi_inputs()
    T = torch.from_numpy
    (gt, ot), wt, ct = tepi.apply_epilogue(
        "em_svr", T(m), T(y), torch.zeros(len(m)), None, EPS, EPS_INS)
    (gj, oj), wj, cj = jepi.apply_epilogue(
        "em_svr", jnp.asarray(m), jnp.asarray(y), jnp.zeros(len(m)), None,
        EPS, EPS_INS)
    for a, b in ((gt, gj), (ot, oj), (wt, wj), (ct, cj)):
        assert a.dtype == torch.float32
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert float(gt.min()) == np.float32(EPS)  # the knee rows clamp


def _mc_draw_bands(got, want, residual):
    """Bitwise where |residual| >= 0.15; the band elsewhere."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.all(np.isfinite(got)) and np.all(got >= np.float32(EPS))
    far = np.abs(residual) >= 0.15
    assert far.mean() > 0.5
    assert np.array_equal(got[far], want[far])
    rel = np.abs(got.astype(np.float64) - want) / np.abs(want)
    assert np.mean(got == want) >= 0.99
    assert np.mean(rel <= 1e-3) >= 0.9995


def test_mc_svr_epilogue_matches_reference():
    m, y, noise = _epi_inputs(seed=1)
    T = torch.from_numpy
    (gt, ot), wt, ct = tepi.apply_epilogue(
        "mc_svr", T(m), T(y), torch.zeros(len(m)),
        tuple(T(z) for z in noise), EPS, EPS_INS)
    (gj, oj), wj, cj = jepi.apply_epilogue(
        "mc_svr", jnp.asarray(m), jnp.asarray(y), jnp.zeros(len(m)),
        tuple(jnp.asarray(z) for z in noise), EPS, EPS_INS)
    res = (y - m).astype(np.float32)
    _mc_draw_bands(gt.numpy(), gj, res - np.float32(EPS_INS))
    _mc_draw_bands(ot.numpy(), oj, res + np.float32(EPS_INS))
    same = (gt.numpy() == np.asarray(gj)) & (ot.numpy() == np.asarray(oj))
    assert np.array_equal(wt.numpy()[same], np.asarray(wj)[same])
    assert np.array_equal(ct.numpy()[same], np.asarray(cj)[same])


# ------------------------------------------------------- the statistic
# name: (N, K, padded rows, X dtype, use a Sigma weight mask)
CASES = {
    "odd": (37, 29, 0, "f32", True),
    "ragged": (203, 29, 13, "f32", True),
    "odd-bf16": (37, 29, 0, "bf16", False),
    "wide": (40, 2048, 3, "f32", False),
}


def _problem(case, regime, seed=0):
    """X, y, w; well: y = m64 +- U[0.35, 2.3], so every |res -+ eps_ins|
    >= 0.05; knee: y normal at a random w (rows reach both knees)."""
    n, k, n_pad, dtype, masked = CASES[case]
    g = np.random.default_rng(seed)
    X = g.normal(size=(n, k)).astype(np.float32)
    X[n - n_pad:] = 0.0
    if dtype == "bf16":
        X = torch.from_numpy(X).bfloat16().float().numpy()
    w = (g.normal(size=k) / np.sqrt(k)).astype(np.float32)
    m64 = X.astype(np.float64) @ w.astype(np.float64)
    if regime == "well":
        off = g.uniform(0.35, 2.3, n) * g.choice([-1.0, 1.0], n)
        y = (m64 + off).astype(np.float32)
    else:
        y = (m64 + 0.5 * g.normal(size=n)).astype(np.float32)
        y[:6] = (m64[:6] + EPS_INS).astype(np.float32)
    y[n - n_pad:] = 0.0
    wm = (g.random(n) > 0.2).astype(np.float32) if masked else None
    if wm is not None:
        wm[n - n_pad:] = 0.0
    return dict(X=X, y=y, w=w, wm=wm, bf16=dtype == "bf16", n_pad=n_pad)


def _tx(p):
    X = torch.from_numpy(p["X"])
    return X.bfloat16() if p["bf16"] else X


def _jx(p):
    X = jnp.asarray(p["X"])
    return X.astype(jnp.bfloat16) if p["bf16"] else X


def _noise_kw(epi, source, n, n_chains=1):
    """noise= (identical numpy draws) or seed= (the same counter words)
    for both packages."""
    if epi == "em_svr":
        return {}, {}
    if source == "noise":
        g = np.random.default_rng(2)
        z = tuple(a.astype(np.float32) for a in (
            g.normal(size=n), g.random(n), g.normal(size=n), g.random(n)))
        return (dict(noise=tuple(torch.from_numpy(a) for a in z)),
                dict(noise=tuple(jnp.asarray(a) for a in z)))
    key = jax.random.fold_in(jax.random.PRNGKey(KEY_SEED), 3)
    tkey = prng.fold_in(prng.PRNGKey(KEY_SEED), 3)
    return (dict(seed=trng.pack_seed(tkey, 29, 1)),
            dict(seed=jrng.pack_seed(key, 29, 1)))


def _port_noise(tkw, n, n_chains):
    if "noise" in tkw:
        return tkw["noise"]
    return tref.seed_noise(tkw["seed"], n, n_chains, "mc_svr")


def _stats64(X, y, wm, g, o):
    """b and Sigma in float64 from given gamma and omega."""
    X, y, g, o = _f64(X, y, g, o)
    wm = 1.0 if wm is None else np.asarray(wm, np.float64)
    coef = (y - EPS_INS) / g + (y + EPS_INS) / o
    return X.T @ coef, (X * (wm * (1.0 / g + 1.0 / o))[:, None]).T @ X


def _check_aug(epi, m, g, o, y, noise):
    """gamma and omega against the reference's eager epilogue on the
    port's own margin (and noise)."""
    (gj, oj), _, _ = jepi.apply_epilogue(
        epi, jnp.asarray(m), jnp.asarray(y), jnp.zeros_like(jnp.asarray(y)),
        None if noise is None else tuple(jnp.asarray(z.numpy())
                                         for z in noise), EPS, EPS_INS)
    if epi == "em_svr":
        assert np.array_equal(g, np.asarray(gj))
        assert np.array_equal(o, np.asarray(oj))
        return
    res = (y - m).astype(np.float32)
    _mc_draw_bands(g, gj, res - np.float32(EPS_INS))
    _mc_draw_bands(o, oj, res + np.float32(EPS_INS))


SVR_VARIANTS = ["em_svr", "mc_svr,noise", "mc_svr,seed"]


@pytest.mark.parametrize("regime", ["well", "knee"])
@pytest.mark.parametrize("variant", SVR_VARIANTS)
@pytest.mark.parametrize("case", list(CASES))
def test_fused_stats_svr(case, variant, regime):
    p = _problem(case, regime)
    epi, _, source = variant.partition(",")
    n = p["X"].shape[0]
    tkw, jkw = _noise_kw(epi, source, n)
    T = torch.from_numpy
    wm_t = None if p["wm"] is None else T(p["wm"])
    mt, gt, ot, bt, St = tops.fused_stats(
        _tx(p), T(p["y"]), torch.zeros(n), T(p["w"]), wm_t, epilogue=epi,
        eps=EPS, eps_ins=EPS_INS, **tkw)
    mj, gj, oj, bj, Sj = jops.fused_stats(
        _jx(p), jnp.asarray(p["y"]), jnp.zeros(n), jnp.asarray(p["w"]),
        None if p["wm"] is None else jnp.asarray(p["wm"]), epilogue=epi,
        eps=EPS, eps_ins=EPS_INS, backend="ref", **jkw)
    k = p["X"].shape[1]
    assert tuple(St.shape) == (k, k) and tuple(ot.shape) == (n,)
    _close_rows(mt, mj)
    _check_aug(epi, mt.numpy(), gt.numpy(), ot.numpy(), p["y"],
               None if epi == "em_svr" else _port_noise(tkw, n, 1))
    b64, S64 = _stats64(p["X"], p["y"], p["wm"], gt, ot)
    _close_max(bt, b64)
    _close_max(St, S64)
    if regime == "well":
        _close_max(bt, bj)
        _close_max(St, Sj)


@pytest.mark.parametrize("regime", ["well", "knee"])
def test_fused_stats_mc_svr_multichain(regime):
    """A (K, C) wvec with the seed: C chains, margin/gamma/omega (N, C),
    b (K, C), Sigma (C, K, K); chain c on counter plane chain0 + c."""
    p = _problem("ragged", regime)
    n, k = p["X"].shape
    C = 3
    W = np.stack([p["w"] * (1.0 + 0.5 * c) for c in range(C)], 1)
    tkw, jkw = _noise_kw("mc_svr", "seed", n)
    T = torch.from_numpy
    mt, gt, ot, bt, St = tops.fused_stats(
        T(p["X"]), T(p["y"]), torch.zeros(n), T(W), T(p["wm"]),
        epilogue="mc_svr", eps=EPS, eps_ins=EPS_INS, **tkw)
    mj, gj, oj, bj, Sj = jops.fused_stats(
        jnp.asarray(p["X"]), jnp.asarray(p["y"]), jnp.zeros(n),
        jnp.asarray(W), jnp.asarray(p["wm"]), epilogue="mc_svr", eps=EPS,
        eps_ins=EPS_INS, backend="ref", **jkw)
    assert tuple(gt.shape) == tuple(ot.shape) == (n, C)
    assert tuple(bt.shape) == (k, C) and tuple(St.shape) == (C, k, k)
    _close_max(mt, mj)
    noise = _port_noise(tkw, n, C)
    _check_aug("mc_svr", mt.numpy(), gt.numpy(), ot.numpy(),
               np.repeat(p["y"][:, None], C, 1), noise)
    for c in range(C):
        b64, S64 = _stats64(p["X"], p["y"], p["wm"], gt[:, c], ot[:, c])
        _close_max(bt[:, c], b64)
        _close_max(St[c], S64)


@pytest.mark.parametrize("variant", ["em_svr", "mc_svr,seed"])
@pytest.mark.parametrize("case", ["odd", "odd-bf16"])
def test_fused_stats_svr_vs_interpret(case, variant):
    """The reference's Pallas body in interpret mode, several row tiles
    (block_n=8), the counter row offset 29 and chain 1."""
    p = _problem(case, "well")
    epi, _, source = variant.partition(",")
    n = p["X"].shape[0]
    tkw, jkw = _noise_kw(epi, source, n)
    T = torch.from_numpy
    wm_t = None if p["wm"] is None else T(p["wm"])
    port = tops.fused_stats(_tx(p), T(p["y"]), torch.zeros(n), T(p["w"]),
                            wm_t, epilogue=epi, eps=EPS, eps_ins=EPS_INS,
                            **tkw)
    want = jops.fused_stats(
        _jx(p), jnp.asarray(p["y"]), jnp.zeros(n), jnp.asarray(p["w"]),
        None if p["wm"] is None else jnp.asarray(p["wm"]), epilogue=epi,
        eps=EPS, eps_ins=EPS_INS, backend="interpret", block_n=8, **jkw)
    _close_rows(port[0], want[0])
    for a, b in zip(port[1:3], want[1:3]):
        if epi == "em_svr":
            _close_rows(a, b)
        else:
            a, b = _f64(a, b)
            assert np.all(np.abs(a - b) <= 1e-3 * b), np.max(
                np.abs(a - b) / b)
    _close_max(port[3], want[3])
    _close_max(port[4], want[4])


@pytest.mark.parametrize("epilogue", ["em_svr", "mc_svr"])
def test_padded_rows_under_svr(epilogue):
    """Padded rows (X-row 0, y = 0) are not zero under SVR: margin 0,
    res = 0, so em_svr gives gamma = omega = eps_ins and the Sigma weight
    2/eps_ins. Only the zero X row keeps them out of b and Sigma."""
    p = _problem("ragged", "knee")
    n, n_pad = p["X"].shape[0], p["n_pad"]
    tkw, _ = _noise_kw(epilogue, "seed", n)
    T = torch.from_numpy
    out = tops.fused_stats(T(p["X"]), T(p["y"]), torch.zeros(n), T(p["w"]),
                           None, epilogue=epilogue, eps=EPS,
                           eps_ins=EPS_INS, **tkw)
    m, g, o = (t[n - n_pad:] for t in out[:3])
    assert torch.all(m == 0)
    if epilogue == "em_svr":
        ins = torch.tensor(EPS_INS, dtype=torch.float32)
        assert torch.all(g == ins) and torch.all(o == ins)
        (_, _), weight, coef = tepi.apply_epilogue(
            "em_svr", m, torch.zeros(n_pad), torch.zeros(n_pad), None, EPS,
            EPS_INS)
        assert torch.allclose(weight, torch.full((n_pad,), 2 / EPS_INS))
        assert torch.all(coef == 0)
    else:  # the draws differ row to row, but every weight is positive
        _, weight, coef = tepi.apply_epilogue(
            "mc_svr", m, torch.zeros(n_pad), torch.zeros(n_pad),
            tuple(z[n - n_pad:] for z in _port_noise(tkw, n, 1)), EPS,
            EPS_INS)
        assert torch.all(weight > 0) and torch.any(coef != 0)
    keep = slice(0, n - n_pad)
    kw = {} if epilogue == "em_svr" else dict(noise=tuple(
        z[keep] for z in _port_noise(tkw, n, 1)))
    cut = tops.fused_stats(T(p["X"][keep]), T(p["y"][keep]),
                           torch.zeros(n - n_pad), T(p["w"]), None,
                           epilogue=epilogue, eps=EPS, eps_ins=EPS_INS, **kw)
    _close_max(out[3], cut[3])
    _close_max(out[4], cut[4])


def test_wide_svr_route_launches_split_fallback():
    """K = 2,048 > FUSED_STATS_MAX_K: em_svr takes the generalised split
    route (a plain E-step, then syrk_tri), not fused_estep; it gives the
    one-pass statistic."""
    p = _problem("wide", "well")
    n = p["X"].shape[0]
    T = torch.from_numpy
    routed = tops.fused_stats(T(p["X"]), T(p["y"]), torch.zeros(n),
                              T(p["w"]), None, epilogue="em_svr", eps=EPS,
                              eps_ins=EPS_INS)
    one = tref.fused_stats(T(p["X"]), T(p["y"]), torch.zeros(n), T(p["w"]),
                           None, EPS, "em_svr", eps_ins=EPS_INS)
    assert len(routed) == 5
    for a, b in zip(routed, one):
        _close_max(a, b)


# ------------------------------------------------- the Nystrom statistic
def _nys_problem(n=203, d=7, m=45, n_pad=13, seed=3, bf16=False):
    """Padded tail rows (X-row 0, mask 0), masked rows, landmarks from
    the rows, a mixed-sign projection; rows scaled to O(1) distances."""
    g = np.random.default_rng(seed)
    X = (g.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    L = X[g.choice(n - n_pad, size=m, replace=False)].copy()
    X[n - n_pad:] = 0.0
    if bf16:
        X = torch.from_numpy(X).bfloat16().float().numpy()
    P = (0.2 * g.normal(size=(m, m))).astype(np.float32)
    mask = (g.uniform(size=n) > 0.2).astype(np.float32)
    mask[n - n_pad:] = 0.0
    w = (g.normal(size=m + 1) / np.sqrt(m)).astype(np.float32)
    return dict(X=X, L=L, P=P, mask=mask, w=w, bf16=bf16)


NYS_SIGMA = 1.3


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("variant", SVR_VARIANTS)
@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_nystrom_fused_stats_svr(case, variant, backend):
    p = _nys_problem(bf16=case == "bf16")
    epi, _, source = variant.partition(",")
    n = p["X"].shape[0]
    phi64 = tref.nystrom_phi(torch.from_numpy(p["X"]).double(),
                             torch.from_numpy(p["L"]).double(),
                             torch.from_numpy(p["P"]).double(),
                             torch.from_numpy(p["mask"]).double(),
                             NYS_SIGMA, "rbf", True).numpy()
    g = np.random.default_rng(4)
    off = g.uniform(0.35, 2.3, n) * g.choice([-1.0, 1.0], n)
    y = ((phi64 @ p["w"].astype(np.float64) + off) * p["mask"]
         ).astype(np.float32)
    tkw, jkw = _noise_kw(epi, source, n)
    kw = dict(sigma=NYS_SIGMA, kind="rbf", add_bias=True, epilogue=epi,
              eps=EPS, eps_ins=EPS_INS)
    X = torch.from_numpy(p["X"])
    X = X.bfloat16() if p["bf16"] else X
    T = torch.from_numpy
    mt, gt, ot, bt, St = tops.nystrom_fused_stats(
        X, T(p["L"]), T(p["P"]), T(y), torch.zeros(n), T(p["w"]),
        T(p["mask"]), **tkw, **kw)
    Xj = jnp.asarray(p["X"])
    Xj = Xj.astype(jnp.bfloat16) if p["bf16"] else Xj
    mj, gj, oj, bj, Sj = jops.nystrom_fused_stats(
        Xj, jnp.asarray(p["L"]), jnp.asarray(p["P"]), jnp.asarray(y),
        jnp.zeros(n), jnp.asarray(p["w"]), jnp.asarray(p["mask"]),
        backend=backend, **({"block_n": 8} if backend == "interpret" else {}),
        **jkw, **kw)
    M = p["L"].shape[0] + 1
    assert tuple(bt.shape) == (M,) and tuple(St.shape) == (M, M)
    _close_rows(mt, mj)
    noise = None if epi == "em_svr" else _port_noise(tkw, n, 1)
    if backend == "ref":
        _check_aug(epi, mt.numpy(), gt.numpy(), ot.numpy(), y, noise)
    else:
        for a, b in ((gt, gj), (ot, oj)):
            a, b = _f64(a, b)
            assert np.all(np.abs(a - b) <= 1e-3 * b), np.max(
                np.abs(a - b) / b)
    # padded and masked rows: y = 0, phi row 0: gamma = omega = eps_ins
    if epi == "em_svr":
        out = p["mask"] == 0
        assert np.all(gt.numpy()[out] == np.float32(EPS_INS))
    phi = tref.nystrom_phi(X, T(p["L"]), T(p["P"]), T(p["mask"]),
                           NYS_SIGMA, "rbf", True).numpy()
    gd, od = _f64(gt, ot)
    coef = (y - EPS_INS) / gd + (y + EPS_INS) / od
    wt = p["mask"] * (1.0 / gd + 1.0 / od)
    phi = phi.astype(np.float64)
    _close_max(bt, phi.T @ coef)
    _close_max(St, (phi * wt[:, None]).T @ phi)
    for got, want in ((bt, bj), (St, Sj)):  # test_torch_nystrom's bound
        got, want = _f64(got, want)
        assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))


# ---------------------------------------------------------- weighted_gram
@pytest.mark.parametrize("shape", [(37, 29, "f32"), (203, 300, "f32"),
                                   (45, 130, "bf16")])
def test_ops_weighted_gram_vs_interpret(shape):
    """ops.weighted_gram (the plain flavour here) against the reference's
    dense Pallas kernel in interpret mode (several 256 x 256 blocks at K
    = 300), masked weights."""
    n, k, dtype = shape
    g = np.random.default_rng(n + k)
    X = g.normal(size=(n, k)).astype(np.float32)
    if dtype == "bf16":
        X = torch.from_numpy(X).bfloat16().float().numpy()
    w = (g.uniform(0.05, 20.0, n) * (g.random(n) > 0.2)).astype(np.float32)
    Xt = torch.from_numpy(X)
    Xj = jnp.asarray(X)
    if dtype == "bf16":
        Xt, Xj = Xt.bfloat16(), Xj.astype(jnp.bfloat16)
    got = tops.weighted_gram(Xt, torch.from_numpy(w))
    want = jops.weighted_gram(Xj, jnp.asarray(w), backend="interpret")
    assert got.dtype == torch.float32 and tuple(got.shape) == (k, k)
    _close_max(got, want)
    _close_max(got, (X.astype(np.float64) * w[:, None]).T @ X)


# ------------------------------------------------- objective and metrics
@pytest.mark.parametrize("masked", [False, True])
def test_svr_objective_and_rmse_match_reference(masked):
    g = np.random.default_rng(5)
    pred = g.normal(size=203).astype(np.float32)
    y = (pred + g.normal(size=203)).astype(np.float32)
    mask = (g.random(203) > 0.3).astype(np.float32)
    T = torch.from_numpy
    np.testing.assert_allclose(
        float(tobj.svr_obj_terms(T(pred), T(y), EPS_INS, T(mask))),
        float(jobj.svr_obj_terms(pred, y, EPS_INS, mask)), rtol=1e-6)
    mk = mask if masked else None
    np.testing.assert_allclose(
        float(tobj.rmse(T(pred), T(y), None if mk is None else T(mk))),
        float(jobj.rmse(pred, y, mk)), rtol=1e-6)


# ------------------------------------------------------------ whole fits
def _year(n=60_000, n_train=50_000):
    """The first ``n_train`` rows train, the rest are held out (Table 6's
    protocol at the CPU anchor size)."""
    X, y = tsyn.make_year_like(n, 90)
    return X[:n_train], y[:n_train], X[n_train:], y[n_train:]


def _cfg(cls, options, **kw):
    return cls.from_options(options, **{"lam": lam_from_C(0.01),
                                        "eps_ins": EPS_INS,
                                        "max_iters": 100, **kw})


LIN = {
    "em": ("LIN-EM-SVR", {}),
    "mc-host": ("LIN-MC-SVR", dict(rng="host")),
    "mc-fused": ("LIN-MC-SVR", dict(rng="fused")),
    "mc-chains": ("LIN-MC-SVR", dict(rng="fused", n_chains=3)),
}


def _rel(a, b):
    a, b = _f64(a, b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def lin_fits():
    Xtr, ytr, Xte, yte = _year()
    out = {"Xte": Xte, "yte": yte, "Xtr": Xtr, "ytr": ytr}
    for name, (opts, kw) in LIN.items():
        ref = JaxSVM(_cfg(JaxConfig, opts, **kw))
        r_ref = ref.fit(Xtr, ytr)
        ports = {}
        for driver in ("scan", "loop"):
            port = PEMSVM(_cfg(SVMConfig, opts, driver=driver, **kw),
                          device="cpu")
            ports[driver] = (port, port.fit(Xtr, ytr))
        out[name] = dict(ref=ref, r_ref=r_ref, ports=ports)
    return out


def _bands(name, r, p, rmse_ref, rmse_port):
    assert r.converged and p.converged
    assert abs(rmse_ref - rmse_port) <= 0.01, (rmse_ref, rmse_port)
    assert np.all(np.isfinite(p.weights))
    if name == "em":
        assert abs(r.n_iters - p.n_iters) <= 3, (r.n_iters, p.n_iters)
        o_r, o_p = _f64(r.objective, p.objective)
        n = min(len(o_r), len(o_p))
        assert np.max(np.abs(o_p[:n] - o_r[:n]) / np.abs(o_r[:n])) <= 5e-2
        assert _rel(p.weights, r.weights) <= 5e-2
    else:
        assert abs(r.n_iters - p.n_iters) <= 15, (r.n_iters, p.n_iters)
        assert _rel(p.weights, r.weights) <= 0.15


@pytest.mark.parametrize("driver", ["scan", "loop"])
@pytest.mark.parametrize("name", list(LIN))
def test_lin_svr_fit_bands(lin_fits, name, driver):
    f = lin_fits[name]
    port, p = f["ports"][driver]
    Xte, yte = lin_fits["Xte"], lin_fits["yte"]
    rmse_ref, rmse_port = f["ref"].rmse(Xte, yte), port.rmse(Xte, yte)
    _bands(name, f["r_ref"], p, rmse_ref, rmse_port)
    assert port.score(Xte, yte) == -rmse_port
    assert set(p.aux_history) == set(f["r_ref"].aux_history) == {
        "objective", "gamma_mean", "omega_mean"}
    pred = port.predict(Xte)
    assert pred.dtype == np.float32 and pred.shape == yte.shape
    if name == "mc-chains":
        assert p.chain_weights.shape == (3, 91)
        assert np.all(np.isfinite(p.chain_std))


@pytest.mark.parametrize("name", list(LIN))
def test_lin_svr_scan_equals_loop(lin_fits, name):
    (_, s), (_, lo) = (lin_fits[name]["ports"][d] for d in ("scan", "loop"))
    assert s.objective == lo.objective and s.aux_history == lo.aux_history
    assert np.array_equal(s.last_sample, lo.last_sample)
    assert (s.n_iters, s.converged) == (lo.n_iters, lo.converged)
    assert s.n_host_syncs <= math.ceil(100 / 16)
    w, wl = _f64(s.weights, lo.weights)
    assert np.max(np.abs(w - wl)) <= 1e-5 * np.max(np.abs(wl))


def test_lin_svr_ridge_anchor(lin_fits):
    """Table 6's anchor: EM and MC fits within 0.02 of the closed-form
    ridge RMSE on the held-out rows (the reference's own EM fit is 0.004
    above it here)."""
    Xtr, ytr = lin_fits["Xtr"], lin_fits["ytr"]
    Xte, yte = lin_fits["Xte"], lin_fits["yte"]
    A = np.hstack([Xtr, np.ones((len(Xtr), 1), np.float32)]).astype(
        np.float64)
    w = np.linalg.solve(A.T @ A + 1e-6 * np.eye(A.shape[1]), A.T @ ytr)
    B = np.hstack([Xte, np.ones((len(Xte), 1))])
    ridge = float(np.sqrt(np.mean((B @ w - yte) ** 2)))
    for name in ("em", "mc-fused"):
        port = lin_fits[name]["ports"]["scan"][0]
        assert abs(port.rmse(Xte, yte) - ridge) <= 0.02


def test_svm_from_reference_svr(lin_fits):
    """An SVR config and weights carry across field for field: the
    converted model predicts the reference's f and scores -RMSE."""
    f = lin_fits["em"]
    ref, r_ref = f["ref"], f["r_ref"]
    cfg = config_from_reference(dataclasses.asdict(ref.config))
    assert (cfg.task, cfg.eps_ins, cfg.lam) == ("SVR", EPS_INS, 200.0)
    assert dataclasses.asdict(cfg) == dict(dataclasses.asdict(ref.config),
                                           backend=None)
    port = svm_from_reference(cfg, r_ref.weights, 90, device="cpu")
    Xte, yte = lin_fits["Xte"], lin_fits["yte"]
    f_ref = np.asarray(ref.predict(Xte), np.float64)
    f_port = port.predict(Xte)
    assert np.max(np.abs(f_port - f_ref)) <= 1e-5 * np.max(np.abs(f_ref))
    assert port.rmse(Xte, yte) == pytest.approx(ref.rmse(Xte, yte),
                                                rel=1e-5)
    assert port.score(Xte, yte) == pytest.approx(ref.score(Xte, yte),
                                                 rel=1e-5)
    with pytest.raises(ValueError):
        PEMSVM(SVMConfig(), device="cpu").rmse(Xte, yte)


KRN = {
    "em": ("KRN-EM-SVR", {}),
    "mc-fused": ("KRN-MC-SVR", dict(rng="fused")),
    "mc-host": ("KRN-MC-SVR", dict(rng="host")),
}

def _kcfg(cls, name, **kw):
    opts, extra = KRN[name]
    return cls.from_options(opts, **{"lam": 1.0, "sigma": math.sqrt(90),
                                     "eps_ins": EPS_INS, "max_iters": 60,
                                     **extra, **kw})


@pytest.fixture(scope="module")
def krn_fits():
    X, y, Xh, yh = _year(30_000, 25_000)
    out = {"X": X, "y": y, "Xh": Xh, "yh": yh}
    for name in KRN:
        jcfg = _kcfg(JaxConfig, name)
        ref = JaxNystrom(jcfg)
        r_ref = ref.fit(X, y)
        port = nystrom_from_reference(dataclasses.asdict(jcfg),
                                      ref._landmarks, ref._proj,
                                      r_ref.weights, device="cpu")
        d_conv = port.predict(Xh)
        ports = {}
        for driver in ("scan", "loop"):
            ny = NystromSVM(_kcfg(SVMConfig, name, driver=driver),
                            device="cpu")
            ports[driver] = (ny, ny.fit_featurized(X, y, ref._landmarks,
                                                   ref._proj))
        out[name] = dict(ref=ref, r_ref=r_ref, ports=ports, d_conv=d_conv)
    return out


@pytest.mark.parametrize("driver", ["scan", "loop"])
@pytest.mark.parametrize("name", list(KRN))
def test_krn_svr_fit_bands(krn_fits, name, driver):
    f = krn_fits[name]
    ny, p = f["ports"][driver]
    Xh, yh = krn_fits["Xh"], krn_fits["yh"]
    rmse_ref, rmse_port = f["ref"].rmse(Xh, yh), ny.rmse(Xh, yh)
    _bands(name, f["r_ref"], p, rmse_ref, rmse_port)
    assert ny.score(Xh, yh) == -rmse_port
    assert ny.svm.config.task == "SVR" and len(ny._landmarks) == 159
    assert set(p.aux_history) == {"objective", "gamma_mean", "omega_mean"}


@pytest.mark.parametrize("name", list(KRN))
def test_krn_svr_scan_equals_loop_and_conversion(krn_fits, name):
    f = krn_fits[name]
    (_, s), (_, lo) = (f["ports"][d] for d in ("scan", "loop"))
    assert s.objective == lo.objective and s.aux_history == lo.aux_history
    assert np.array_equal(s.last_sample, lo.last_sample)
    assert (s.n_iters, s.converged) == (lo.n_iters, lo.converged)
    # the converted reference model predicts the reference's f
    want = np.asarray(f["ref"].predict(krn_fits["Xh"]), np.float64)
    assert np.max(np.abs(f["d_conv"] - want)) <= 1e-4 * np.max(np.abs(want))


def _em64_trace(A, y, lam, jitter, iters):
    """Objective trace of ``iters`` EM-SVR steps from w = 0 in float64,
    with the solver's ridge and relative jitter."""
    A, y = _f64(A, y)
    K = A.shape[1]
    w = np.zeros(K)
    out = []
    for _ in range(iters):
        res = y - A @ w
        g = np.maximum(np.abs(res - EPS_INS), EPS)
        o = np.maximum(np.abs(res + EPS_INS), EPS)
        P = (A * (1.0 / g + 1.0 / o)[:, None]).T @ A + lam * np.eye(K)
        P += jitter * np.trace(P) / K * np.eye(K)
        w = np.linalg.solve(P, A.T @ ((y - EPS_INS) / g + (y + EPS_INS) / o))
        out.append(0.5 * lam * w @ w
                   + np.sum(2.0 * np.maximum(np.abs(res) - EPS_INS, 0.0)))
    return np.asarray(out)


@pytest.mark.parametrize("which", ["LIN", "KRN"])
def test_em_svr_trace_near_float64(lin_fits, krn_fits, which):
    """The port's float32 EM-SVR objective trace within 5e-2 of a float64
    EM on the same rows (X with its bias column, or the reference's
    featurizer's phi, computed in float64), at the sizes of the fits above
    (50,000 and 25,000 rows), where it reads 1.1e-2 and 2.4e-2: see the
    module docstring for why the band is not em_cls's 2e-2."""
    if which == "LIN":
        X, y = lin_fits["Xtr"], lin_fits["ytr"]
        A = np.hstack([X, np.ones((len(X), 1), np.float32)])
        p = lin_fits["em"]["ports"]["scan"][1]
        lam, jitter = lam_from_C(0.01), 1e-7
    else:
        X, y = krn_fits["X"], krn_fits["y"]
        ref = krn_fits["em"]["ref"]
        X64, L64 = _f64(X, ref._landmarks)
        d2 = ((X64 ** 2).sum(1)[:, None] - 2.0 * X64 @ L64.T
              + (L64 ** 2).sum(1)[None])
        k = np.exp(-np.maximum(d2, 0.0) / (2.0 * 90.0))
        A = np.hstack([k @ np.asarray(ref._proj, np.float64),
                       np.ones((len(X), 1))])
        p = krn_fits["em"]["ports"]["scan"][1]
        lam, jitter = 1.0, 1e-4
    t64 = _em64_trace(A, y, lam, jitter, len(p.objective))
    o = np.asarray(p.objective, np.float64)
    assert np.max(np.abs(o - t64) / t64) <= 5e-2
