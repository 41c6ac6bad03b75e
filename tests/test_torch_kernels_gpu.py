"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA device every test skips (the ``cuda``
fixture decides, never import time, so every xdist worker collects the
same tests). Run on the card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

This file imports no JAX: the card's machine has none. Tolerances are the
well-conditioned regime of tests/test_torch_kernels_ref.py, held against
the plain version evaluated in float64 (rho = m64 +- U[0.05, 2], so 1/gamma
amplifies nothing): |d| <= 1e-5 (1 + |v|) for margin and gamma,
max|d| <= 1e-5 max|ref| for b and Sigma.

The mc_hinge variants (noise operands, the counter seed, C chains) are
held as in ``chip_smoke.py`` phase 3: margins as above; gamma against the
plain epilogue on the kernel's own margin and noise (>= 99 % of rows
bitwise equal, >= 99.95 % within 1e-3 relative, all finite and >= eps);
b and Sigma against a float64 recomputation from the kernel's own gamma.
The SVR variants (em_svr; mc_svr with four noise operands, the seed, C
chains) are held the same way with gamma and omega each, on targets
y = m64 +- U[0.35, 2.3] (every |res -+ eps_ins| >= 0.05); em_svr's gamma
and omega also against the float64 plain version. weighted_gram is held
as syrk_tri.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.core import PEMSVM, SVMConfig, lam_from_C, prng
from repro_torch.data import make_blobs
from repro_torch.kernels import (_build, epilogues, fused_estep, fused_stats,
                                 ops, ref, rng, syrk)

pytestmark = pytest.mark.gpu
REL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _problem(n, k, dtype, dev, seed=0):
    g = np.random.default_rng(seed)
    X = torch.from_numpy(g.normal(size=(n, k)).astype(np.float32))
    X = X.to(dtype)
    w = torch.from_numpy((g.normal(size=k) / np.sqrt(k)).astype(np.float32))
    m64 = X.double() @ w.double()
    off = g.uniform(0.05, 2.0, n) * g.choice([-1.0, 1.0], n)
    rho = (m64 + torch.from_numpy(off)).float()
    beta = torch.from_numpy(g.normal(size=n).astype(np.float32))
    wm = torch.from_numpy((g.random(n) > 0.2).astype(np.float32))
    return [t.to(dev) for t in (X, rho, beta, w, wm)]


def _close_rows(got, want):
    assert torch.all((got.double() - want).abs()
                     <= REL * (1 + want.abs())), (got.double() - want).abs().max()


def _close_max(got, want):
    err = (got.double() - want).abs().max()
    assert err <= REL * want.abs().max(), err


SHAPES = [(1037, 29, torch.float32), (1037, 29, torch.bfloat16),
          (4099, 501, torch.float32), (2053, 300, torch.bfloat16)]
# The edges of the statistic's tile grid on the Gram engine (stat_tiles in
# csrc/gram_pipe.cuh), beside SHAPES: float32 with K % 4 == 0 (16-byte
# copies; K % 4 != 0 takes 4-byte ones), ragged last column blocks
# (K = 129, 257, also bfloat16), and a last split ending mid-stage
# (N % 32 != 0; N = 31, one partial stage).
STAT_SHAPES = SHAPES + [(4097, 500, torch.float32),
                        (3001, 129, torch.float32),
                        (2050, 257, torch.bfloat16),
                        (31, 130, torch.float32)]


@pytest.mark.parametrize("n,k,dtype", STAT_SHAPES)
def test_fused_stats_kernel(cuda, n, k, dtype):
    X, rho, beta, w, wm = _problem(n, k, dtype, cuda)
    got = fused_stats.fused_stats(X, rho, beta, w, wm, eps=1e-6)
    again = fused_stats.fused_stats(X, rho, beta, w, wm, eps=1e-6)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref.fused_stats(X.double(), rho.double(), beta.double(),
                           w.double(), wm.double(), 1e-6)
    _close_rows(got[0], want[0])
    _close_rows(got[1], want[1])
    _close_max(got[2], want[2])
    _close_max(got[3], want[3])


# fused_estep (csrc/fused_estep.cu) beside SHAPES: the K > 1536 route's
# widths, K = 1,537 and 2,049 (phase 8's; rows off the 16-byte grid, so a
# shuffle realigns each lane's four columns), 2,048 (rows on it), and rows
# wider than the register-resident 2,176 columns (two column segments, X
# read twice: K = 2,300, 4,100), at N % 8 != 0, float32 and bfloat16.
ESTEP_SHAPES = SHAPES + [(n, k, dtype) for n, k in ((517, 1537), (1031, 2048),
                                                    (517, 2049), (203, 2300),
                                                    (301, 4100))
                         for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("n,k,dtype", ESTEP_SHAPES)
def test_fused_estep_kernel(cuda, n, k, dtype):
    X, rho, beta, w, _ = _problem(n, k, dtype, cuda)
    got = fused_estep.fused_estep(X, rho, beta, w, eps=1e-6)
    again = fused_estep.fused_estep(X, rho, beta, w, eps=1e-6)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref.fused_estep(X.double(), rho.double(), beta.double(),
                           w.double(), 1e-6)
    _close_rows(got[0], want[0])
    _close_rows(got[1], want[1])
    _close_max(got[2], want[2])


@pytest.mark.parametrize("n,k,dtype", [(517, 2048, torch.float32),
                                       (517, 2049, torch.float32),
                                       (203, 4100, torch.bfloat16),
                                       (517, 2049, torch.bfloat16)])
def test_fused_estep_kernel_off_alignment(cuda, n, k, dtype):
    """X starting one element into its buffer (off the 16-byte, or for
    bfloat16 the 8-byte, grid of its loads): the same values as the
    aligned X, within the tolerance of the plain version."""
    X, rho, beta, w, _ = _problem(n, k, dtype, cuda)
    buf = torch.empty(n * k + 1, dtype=dtype, device=cuda)
    Xo = buf[1:].view(n, k)
    Xo.copy_(X)
    got = fused_estep.fused_estep(Xo, rho, beta, w, eps=1e-6)
    want = ref.fused_estep(X.double(), rho.double(), beta.double(),
                           w.double(), 1e-6)
    _close_rows(got[0], want[0])
    _close_rows(got[1], want[1])
    _close_max(got[2], want[2])
    aligned = fused_estep.fused_estep(X, rho, beta, w, eps=1e-6)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, aligned))


# Shapes of the Gram engine (csrc/gram_pipe.cuh) behind syrk_tri and
# weighted_gram, each reaching one of its paths: float32 with K % 4 != 0
# (4-byte copies) and K % 4 == 0 (16-byte copies); bfloat16 with odd and
# even K; N below one 32-row stage (1, 31) and N not a multiple of it;
# K = 1, K = 129 (a one-column edge block), K = 2,049 (a one-column edge
# block row at phase 8's width). The fourth field starts X that many
# elements into its buffer: a float32 X off 16-byte alignment takes the
# 4-byte copies, a bfloat16 X off 4-byte alignment starts its rows half a
# word early.
GRAM_SHAPES = [(n, k, dtype, 0) for n, k, dtype in SHAPES] + [
    (4097, 500, torch.float32, 0), (4097, 130, torch.float32, 0),
    (1, 7, torch.float32, 0), (1, 8, torch.float32, 0),
    (1, 1, torch.bfloat16, 0), (31, 130, torch.float32, 0),
    (31, 129, torch.bfloat16, 0), (33, 129, torch.float32, 0),
    (4099, 1, torch.float32, 0), (4099, 1, torch.bfloat16, 0),
    (3000, 2049, torch.float32, 0), (3000, 2049, torch.bfloat16, 0),
    (3000, 2048, torch.float32, 0), (8200, 257, torch.bfloat16, 0),
    (1000, 8, torch.float32, 1), (1000, 9, torch.bfloat16, 1),
    (1000, 8, torch.bfloat16, 3)]


def _gram_problem(n, k, dtype, offset, dev):
    """X (n, k) starting ``offset`` elements into its buffer, and weights
    1 / gamma of the well-conditioned regime."""
    X, rho, _, w, _ = _problem(n, k, dtype, dev)
    wt = 1.0 / (rho - X.float() @ w).abs().clamp_min(1e-6)
    if offset:
        buf = torch.zeros(n * k + offset, dtype=dtype, device=dev)
        buf[offset:] = X.reshape(-1)
        X = buf[offset:].view(n, k)
    return X, wt


@pytest.mark.parametrize("n,k,dtype,offset", GRAM_SHAPES)
def test_syrk_kernel(cuda, n, k, dtype, offset):
    X, wt = _gram_problem(n, k, dtype, offset, cuda)
    got = syrk.syrk_tri(X, wt)
    torch.cuda.synchronize()
    assert torch.equal(got, syrk.syrk_tri(X, wt))
    _close_max(got, ref.syrk_tri(X.double(), wt.double()))


def test_wrappers_reject_bad_operands(cuda):
    X, rho, beta, w, _ = _problem(64, 8, torch.float32, cuda)
    with pytest.raises(TypeError):
        syrk.syrk_tri(X.half(), rho)
    with pytest.raises(ValueError):
        syrk.syrk_tri(X.t(), rho)
    with pytest.raises(ValueError):
        fused_estep.fused_estep(X, rho[:-1], beta, w)
    with pytest.raises(TypeError):
        fused_stats.fused_stats(X, rho.double(), beta, w)


def test_fit_goes_through_the_kernels(cuda):
    X, y = make_blobs(6000, 40, seed=0)
    cfg = SVMConfig.from_options("LIN-EM-CLS", lam=lam_from_C(1.0),
                                 max_iters=100)
    before = fused_stats.LAUNCHES["em_hinge"]
    res = PEMSVM(cfg).fit(X, y)
    launched = fused_stats.LAUNCHES["em_hinge"] - before
    chunk = cfg.scan_chunk
    assert res.converged
    assert res.n_iters <= launched <= -(-res.n_iters // chunk) * chunk
    plain = PEMSVM(SVMConfig.from_options(
        "LIN-EM-CLS", lam=lam_from_C(1.0), max_iters=100, backend="ref"))
    rp = plain.fit(X, y)
    assert abs(rp.n_iters - res.n_iters) <= 3
    w, wp = res.weights.astype(np.float64), rp.weights.astype(np.float64)
    assert np.linalg.norm(w - wp) / np.linalg.norm(wp) <= 5e-2


def test_wide_route_launches_estep_and_syrk(cuda):
    X, rho, beta, w, wm = _problem(300, ops.FUSED_STATS_MAX_K + 1,
                                   torch.float32, cuda)
    counts = (dict(fused_stats.LAUNCHES), fused_estep.LAUNCHES,
              syrk.LAUNCHES)
    got = ops.fused_stats(X, rho, beta, w, wm)
    assert (fused_stats.LAUNCHES, fused_estep.LAUNCHES - 1,
            syrk.LAUNCHES - 1) == counts
    want = ref.fused_stats(X.double(), rho.double(), beta.double(),
                           w.double(), wm.double(), 1e-6)
    _close_max(got[3], want[3])


MC = [("mc_hinge,noise", 1), ("mc_hinge,seed", 1),
      ("mc_hinge,seed,multichain", 3), ("mc_hinge,seed,multichain", 4)]


def _gamma_band(g, g_plain):
    g, gp = g.reshape(-1).double(), g_plain.reshape(-1).double()
    assert torch.all(torch.isfinite(g)) and torch.all(g >= 1e-6)
    assert (g == gp).double().mean() >= 0.99
    assert ((g - gp).abs() / gp.abs() <= 1e-3).double().mean() >= 0.9995


@pytest.mark.parametrize("var,C", MC)
@pytest.mark.parametrize("n,k,dtype", STAT_SHAPES)
def test_fused_stats_mc_kernel(cuda, n, k, dtype, var, C):
    X, rho, beta, w, wm = _problem(n, k, dtype, cuda)
    seed = rng.pack_seed(prng.fold_in(prng.PRNGKey(5), 2), 3, 1).to(cuda)
    noise = ref.seed_noise(seed, n, C, "mc_hinge")
    kw = dict(noise=noise) if var == "mc_hinge,noise" else dict(seed=seed)
    if C > 1:
        w = torch.stack([w * (1.0 + 0.25 * c) for c in range(C)], 1)
    before = fused_stats.LAUNCHES[var]
    got = fused_stats.fused_stats(X, rho, beta, w, wm, epilogue="mc_hinge",
                                  **kw)
    again = fused_stats.fused_stats(X, rho, beta, w, wm,
                                    epilogue="mc_hinge", **kw)
    torch.cuda.synchronize()
    assert fused_stats.LAUNCHES[var] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    m, g, b, S = got
    _close_rows(m, X.double() @ w.double())
    r, bt = (rho, beta) if C == 1 else (rho[:, None], beta[:, None])
    (g_plain,), _, _ = epilogues.apply_epilogue("mc_hinge", m, r, bt, noise,
                                                1e-6)
    _gamma_band(g, g_plain)
    X64 = X.double()
    for c in range(C):
        gc = (g if C == 1 else g[:, c]).double()
        coef = rho.double() / gc + beta.double()
        _close_max(b if C == 1 else b[:, c], X64.T @ coef)
        S64 = (X64 * (wm.double() / gc)[:, None]).T @ X64
        _close_max(S if C == 1 else S[c], S64)


def test_mc_fit_goes_through_the_seed_kernel(cuda):
    X, y = make_blobs(6000, 40, seed=0)
    cfg = SVMConfig.from_options("LIN-MC-CLS", lam=lam_from_C(1.0),
                                 max_iters=60, rng="fused")
    before = fused_stats.LAUNCHES["mc_hinge,seed"]
    res = PEMSVM(cfg).fit(X, y)
    launched = fused_stats.LAUNCHES["mc_hinge,seed"] - before
    chunk = cfg.scan_chunk
    assert res.converged
    assert launched == min(cfg.max_iters, -(-res.n_iters // chunk) * chunk)
    assert np.all(np.isfinite(res.weights))


# ---------------------------------------------------------------- Nystrom
# The four Nystrom kernels against their plain versions in float64, at
# small odd masked shapes (padded tail rows, masked rows, the bias column,
# both kinds, bf16 X), with the tolerances of chip_smoke.py phase 3:
# rbf_gram |d| <= 1e-5 |ref| + 1e-7; phi |d| <= 1e-5 (|k| @ |proj|)
# elementwise (mixed-sign dot products), scores through |W|, margins
# through |w|; em_hinge gamma |dg| <= |dm| + 2^-24 (g + g_ref) + 1e-7;
# mc_hinge gamma against the plain epilogue on the kernel's own margin
# and noise; b and Sigma
# within 1e-5 max of a float64 recomputation from the kernel's own phi
# (the nystrom_phi kernel's output: the statistic accumulates those bits)
# and gamma.
from repro_torch.kernels import nystrom_phi as nys  # noqa: E402
from repro_torch.kernels import rbf_gram as rbfk  # noqa: E402

# (n, d, m, padded tail rows, dtype): phi widths M = m + 1 of 46, 301 and
# 258 (4-byte copies in the statistic's Gram engine, the last a ragged
# 2-column block) and 256 (16-byte copies).
NYS_SHAPES = [(203, 7, 45, 13, torch.float32), (1037, 2, 300, 5,
                                                   torch.bfloat16),
              (517, 130, 257, 0, torch.float32),
              (1031, 3, 255, 7, torch.float32)]


def _nys(n, d, m, n_pad, dtype, dev, kind="rbf", sigma=1.3, seed=0):
    """Rows scaled to O(1) distances, as the rbf_gram cases: unscaled
    normal rows at D = 130 would put every k at exp(-77) except exact
    duplicates, where float32 cancellation in |x|^2 - 2 x.l + |l|^2
    (the reference's expansion too) is all that is left."""
    g = np.random.default_rng(seed)
    X = (g.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    L = X[g.choice(n - n_pad, size=m, replace=False)].copy()
    X[n - n_pad:] = 0.0
    P = (0.2 * g.normal(size=(m, m)) / np.sqrt(m / 45)).astype(np.float32)
    mask = (g.uniform(size=n) > 0.2).astype(np.float32)
    mask[n - n_pad:] = 0.0
    X = torch.from_numpy(X).to(dtype).to(dev)
    L, P, mask = (torch.from_numpy(a).to(dev) for a in (L, P, mask))
    X64 = X.double()
    k64 = ref.rbf_gram(X64, L.double(), sigma) if kind == "rbf" else \
        X64 @ L.double().T
    return X, L, P, mask, k64


def _phi_scale(k64, P, mask, add_bias):
    s = k64.abs() @ P.double().abs()
    if add_bias:
        s = torch.cat([s, torch.ones_like(s[:, :1])], 1)
    return s * mask.double()[:, None]


def _within(got, want, scale):
    err = (got.double() - want).abs()
    assert torch.all(err <= REL * scale), (err - REL * scale).max()


def _nys_gamma_band(g, g_plain):
    """_gamma_band with the clamp compared in float32: padded and masked
    rows (rho = 0, phi row 0) sit at the clamp, float32(1e-6) < 1e-6."""
    assert torch.all(torch.isfinite(g)) and torch.all(g >= 1e-6)
    g, gp = g.reshape(-1).double(), g_plain.reshape(-1).double()
    assert (g == gp).double().mean() >= 0.99
    assert ((g - gp).abs() / gp.abs() <= 1e-3).double().mean() >= 0.9995


@pytest.mark.parametrize("shape", [((37, 29), (45, 29)), ((1000, 2),) * 2,
                                   ((300, 500), (257, 500))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rbf_gram_kernel(cuda, shape, dtype):
    g = np.random.default_rng(1)
    (n1, d), (n2, _) = shape
    X1 = torch.from_numpy((g.normal(size=(n1, d)) / np.sqrt(d)).astype(
        np.float32)).to(dtype).to(cuda)
    X2 = torch.from_numpy((g.normal(size=(n2, d)) / np.sqrt(d)).astype(
        np.float32)).to(dtype).to(cuda)
    X2[:5] = X1[:5]
    before = rbfk.LAUNCHES
    got = rbfk.rbf_gram(X1, X2, sigma=0.7)
    again = rbfk.rbf_gram(X1, X2, sigma=0.7)
    torch.cuda.synchronize()
    assert rbfk.LAUNCHES == before + 2 and torch.equal(got, again)
    want = ref.rbf_gram(X1.double(), X2.double(), 0.7)
    assert torch.all((got.double() - want).abs()
                     <= 1e-5 * want.abs() + 1e-7)


@pytest.mark.parametrize("add_bias", [False, True])
@pytest.mark.parametrize("kind", ["rbf", "linear"])
@pytest.mark.parametrize("shape", NYS_SHAPES)
def test_nystrom_phi_kernel(cuda, shape, kind, add_bias):
    X, L, P, mask, k64 = _nys(*shape, cuda, kind=kind)
    before = nys.LAUNCHES["nystrom_phi"]
    got = nys.nystrom_phi(X, L, P, mask, sigma=1.3, kind=kind,
                          add_bias=add_bias)
    again = nys.nystrom_phi(X, L, P, mask, sigma=1.3, kind=kind,
                            add_bias=add_bias)
    torch.cuda.synchronize()
    assert nys.LAUNCHES["nystrom_phi"] == before + 2
    assert torch.equal(got, again)
    want = ref.nystrom_phi(X.double(), L.double(), P.double(),
                           mask.double(), 1.3, kind, add_bias)
    _within(got, want, _phi_scale(k64, P, mask, add_bias))
    assert not torch.any(got[mask == 0])


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("shape", NYS_SHAPES)
def test_nystrom_score_kernel(cuda, shape, C):
    kind = "linear" if C == 3 else "rbf"
    X, L, P, mask, k64 = _nys(*shape, cuda, kind=kind)
    W = torch.randn(L.shape[0] + 1, C, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    before = nys.LAUNCHES["nystrom_score"]
    got = nys.nystrom_score(X, L, P, W, mask, sigma=1.3, kind=kind,
                            add_bias=True)
    torch.cuda.synchronize()
    assert nys.LAUNCHES["nystrom_score"] == before + 1
    want = ref.nystrom_score(X.double(), L.double(), P.double(), W.double(),
                             mask.double(), 1.3, kind, True)
    _within(got, want, _phi_scale(k64, P, mask, True) @ W.double().abs())


NYS_MC = ["em_hinge", "mc_hinge,noise", "mc_hinge,seed"]


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("var", NYS_MC)
@pytest.mark.parametrize("shape", NYS_SHAPES)
def test_nystrom_fused_stats_kernel(cuda, shape, var, chunked, monkeypatch):
    kind = "linear" if shape[1] == 130 else "rbf"
    X, L, P, mask, k64 = _nys(*shape, cuda, kind=kind)
    n, M = X.shape[0], L.shape[0] + 1
    g = torch.Generator(device=cuda).manual_seed(3)
    w = torch.randn(M, generator=g, device=cuda) / math.sqrt(M)
    y = torch.where(torch.rand(n, generator=g, device=cuda) < 0.5, -1.0,
                    1.0) * mask
    epi, _, source = var.partition(",")
    seed = rng.pack_seed(prng.fold_in(prng.PRNGKey(5), 2), 3, 0).to(cuda)
    noise = ref.seed_noise(seed, n, 1, "mc_hinge")
    kw = (dict(noise=noise) if source == "noise" else
          dict(seed=seed) if source == "seed" else {})
    args = (X, L, P, y, y, w, mask)
    opts = dict(sigma=1.3, kind=kind, add_bias=True, epilogue=epi, eps=1e-6)
    one = nys.nystrom_fused_stats(*args, **kw, **opts)
    if chunked:  # several row chunks give the same bits as one
        monkeypatch.setattr(nys, "SCRATCH_WORDS", 32 * M * 2)
    before = nys.LAUNCHES[f"nystrom_fused_stats[{var}]"]
    m, gam, b, S = nys.nystrom_fused_stats(*args, **kw, **opts)
    torch.cuda.synchronize()
    assert nys.LAUNCHES[f"nystrom_fused_stats[{var}]"] == before + 1
    assert all(torch.equal(a, c) for a, c in zip(one, (m, gam, b, S)))
    phi64 = ref.nystrom_phi(X.double(), L.double(), P.double(),
                            mask.double(), 1.3, kind, True)
    m64 = phi64 @ w.double()
    _within(m, m64, _phi_scale(k64, P, mask, True) @ w.double().abs())
    if epi == "em_hinge":
        g64 = (y.double() - m64).abs().clamp_min(1e-6)
        lim = ((m.double() - m64).abs() + 2.0 ** -24 * (gam.double() + g64)
               + 1e-7)
        assert torch.all((gam.double() - g64).abs() <= lim)
    else:
        (g_plain,), _, _ = epilogues.apply_epilogue("mc_hinge", m, y, y,
                                                    noise, 1e-6)
        _nys_gamma_band(gam, g_plain)
    phi = nys.nystrom_phi(X, L, P, mask, sigma=1.3, kind=kind,
                          add_bias=True).double()
    coef = y.double() / gam.double() + y.double()
    _close_max(b, phi.T @ coef)
    _close_max(S, (phi * (mask.double() / gam.double())[:, None]).T @ phi)


def test_nystrom_wide_route_launches_phi_estep_and_syrk(cuda):
    """m > NYSTROM_FUSED_MAX_M: nystrom_phi, then fused_estep + syrk_tri
    (M > FUSED_STATS_MAX_K); the featurize-and-accumulate kernel stays
    idle."""
    m = ops.FUSED_STATS_MAX_K + 8
    X, L, P, mask, _ = _nys(2000, 3, m, 0, torch.float32, cuda)
    P = P / 10
    y = torch.ones(2000, device=cuda) * mask
    w = torch.zeros(m + 1, device=cuda)
    nys.zero_launches()
    counts = (fused_estep.LAUNCHES, syrk.LAUNCHES)
    got = ops.nystrom_fused_stats(X, L, P, y, y, w, mask, sigma=1.3,
                                  add_bias=True)
    assert nys.LAUNCHES["nystrom_phi"] == 1
    assert sum(nys.LAUNCHES.values()) == 1
    assert (fused_estep.LAUNCHES - 1, syrk.LAUNCHES - 1) == counts
    want = ref.nystrom_fused_stats(X, L, P, y, y, w, mask, 1.3, "rbf", True,
                                   1e-6)
    _close_max(got[3], want[3].double())


def test_nystrom_wrappers_reject_bad_operands(cuda):
    X, L, P, mask, _ = _nys(64, 3, 8, 0, torch.float32, cuda)
    with pytest.raises(ValueError):
        nys.nystrom_phi(X, L.double(), P)
    with pytest.raises(ValueError):
        nys.nystrom_phi(X, L[:, :2].contiguous(), P)
    with pytest.raises(ValueError):
        nys.nystrom_score(X, L, P, torch.zeros(8, 1, device=cuda),
                          add_bias=True)
    with pytest.raises(ValueError):
        nys.nystrom_fused_stats(X, L, P, mask, mask,
                                torch.zeros(9, 2, device=cuda), mask,
                                seed=torch.zeros(4, dtype=torch.int64,
                                                 device=cuda),
                                epilogue="mc_hinge", add_bias=True)
    with pytest.raises(TypeError):
        rbfk.rbf_gram(X, X.bfloat16())


# The projection on the Gram engine at its odd shapes: (n, d, m, padded
# tail rows, dtype, P). m % 32 != 0 zero-fills the last 32-landmark stage;
# P % 4 != 0 pads proj to a 16-byte row stride; P = 128 with the bias
# column gives M = 129, a second column tile holding only the bias column.
PHI_ODD = [(1037, 5, 45, 13, torch.float32, 45),
           (517, 3, 100, 0, torch.bfloat16, 99),
           (300, 4, 128, 7, torch.float32, 128),
           (2051, 2, 61, 5, torch.float32, 30)]


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("shape", PHI_ODD)
def test_nystrom_phi_bitwise_across_chunk_sizes(cuda, shape, monkeypatch):
    """Each phi entry is one fmaf chain over the landmarks: the bits of
    phi and of the scores do not depend on how the rows are chunked."""
    n, d, m, n_pad, dtype, p = shape
    X, L, P, mask, _ = _nys(n, d, m, n_pad, dtype, cuda)
    P = P[:, :p].contiguous()
    W = torch.randn(p + 1, 3, generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda)
    kw = dict(sigma=1.3, add_bias=True)
    one = nys.nystrom_phi(X, L, P, mask, **kw)
    score = nys.nystrom_score(X, L, P, W, mask, **kw)
    monkeypatch.setattr(nys, "SCRATCH_WORDS", 128 * max(m, p + 1))
    assert nys._phi_chunk_rows(n, m, p + 1) == 128 < n
    many = nys.nystrom_phi(X, L, P, mask, **kw)
    score_many = nys.nystrom_score(X, L, P, W, mask, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(one), _bits(many))
    assert torch.equal(_bits(score), _bits(score_many))


@pytest.mark.parametrize("add_bias", [False, True])
@pytest.mark.parametrize("kind", ["rbf", "linear"])
@pytest.mark.parametrize("shape", PHI_ODD)
def test_nystrom_phi_odd_shapes(cuda, shape, kind, add_bias, monkeypatch):
    """phi and the scores (C = 1, 3) at the odd shapes, over several row
    chunks, against the plain version in float64."""
    n, d, m, n_pad, dtype, p = shape
    X, L, P, mask, k64 = _nys(n, d, m, n_pad, dtype, cuda, kind=kind)
    P = P[:, :p].contiguous()
    monkeypatch.setattr(nys, "SCRATCH_WORDS", 256 * max(m, p + 1))
    kw = dict(sigma=1.3, kind=kind, add_bias=add_bias)
    got = nys.nystrom_phi(X, L, P, mask, **kw)
    want = ref.nystrom_phi(X.double(), L.double(), P.double(),
                           mask.double(), 1.3, kind, add_bias)
    scale = _phi_scale(k64, P, mask, add_bias)
    _within(got, want, scale)
    assert not torch.any(got[mask == 0])
    M = p + int(add_bias)
    for C in (1, 3):
        W = torch.randn(M, C, generator=torch.Generator(
            device=cuda).manual_seed(C), device=cuda)
        s = nys.nystrom_score(X, L, P, W, mask, **kw)
        _within(s, want @ W.double(), scale @ W.double().abs())


@pytest.mark.parametrize("var", ["em_hinge", "mc_hinge,seed", "em_svr"])
def test_nystrom_fused_stats_is_fused_stats_on_phi(cuda, var, monkeypatch):
    """On fused_stats' split plan and in one chunk, the Nystrom statistic
    is fused_stats on the phi rows nystrom_phi writes, bit for bit: the
    statistic's projection is nystrom_phi's, and the row pass and the
    Gram engine after it are fused_stats'."""
    X, L, P, mask, _ = _nys(1031, 3, 255, 7, torch.float32, cuda)
    P = P[:, :250].contiguous()
    n, M = X.shape[0], 251
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    ntiles, nsplits, rows = _build.stat_plan(n, M, 1, sms)
    monkeypatch.setattr(nys, "stats_plan",
                        lambda N, m, M_, s, D=0: (ntiles, rows,
                                                  rows * nsplits))
    g = torch.Generator(device=cuda).manual_seed(4)
    w = torch.randn(M, generator=g, device=cuda) / math.sqrt(M)
    y = torch.where(torch.rand(n, generator=g, device=cuda) < 0.5, -1.0,
                    1.0) * mask
    epi, _, source = var.partition(",")
    beta = torch.zeros_like(y) if epi == "em_svr" else y
    seed = rng.pack_seed(prng.fold_in(prng.PRNGKey(5), 2), 3, 0).to(cuda)
    kw = dict(epilogue=epi, eps=1e-6,
              eps_ins=0.3 if epi == "em_svr" else 0.0,
              **(dict(seed=seed) if source == "seed" else {}))
    got = nys.nystrom_fused_stats(X, L, P, y, beta, w, mask, sigma=1.3,
                                  add_bias=True, **kw)
    phi = nys.nystrom_phi(X, L, P, mask, sigma=1.3, add_bias=True)
    want = fused_stats.fused_stats(phi, y, beta, w, mask, **kw)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


def test_nystrom_fit_goes_through_the_kernels(cuda):
    from repro_torch.core import NystromSVM
    from repro_torch.data import make_circles
    X, y = make_circles(6000, seed=0)
    Xh, yh = make_circles(2000, seed=1)
    cfg = SVMConfig.from_options("KRN-EM-CLS", lam=0.1, sigma=0.7,
                                 max_iters=60)
    nys.zero_launches()
    before = rbfk.LAUNCHES
    ny = NystromSVM(cfg, n_landmarks=77)
    res = ny.fit(X, y)
    chunk = cfg.scan_chunk
    steps = min(cfg.max_iters, -(-res.n_iters // chunk) * chunk)
    assert res.converged and rbfk.LAUNCHES == before + 1
    assert nys.LAUNCHES["nystrom_fused_stats[em_hinge]"] == steps
    assert nys.LAUNCHES["nystrom_phi"] == 0
    acc = ny.score(Xh, yh)
    assert nys.LAUNCHES["nystrom_score"] == 1
    plain = NystromSVM(SVMConfig.from_options(
        "KRN-EM-CLS", lam=0.1, sigma=0.7, max_iters=60, backend="ref"))
    rp = plain.fit_featurized(X, y, ny._landmarks, ny._proj)
    assert abs(rp.n_iters - res.n_iters) <= 3
    assert abs(plain.score(Xh, yh) - acc) <= 0.01 and acc >= 0.99
    w, wp = res.weights.astype(np.float64), rp.weights.astype(np.float64)
    assert np.linalg.norm(w - wp) / np.linalg.norm(wp) <= 5e-2


# -------------------------------------------------------------------- SVR
EPS_INS = 0.3
SVR = [("em_svr", 1), ("mc_svr,noise", 1), ("mc_svr,seed", 1),
       ("mc_svr,seed,multichain", 3), ("mc_svr,seed,multichain", 4)]


def _svr_targets(m64, mask, seed=1):
    g = np.random.default_rng(seed)
    n = m64.shape[0]
    off = g.uniform(0.35, 2.3, n) * g.choice([-1.0, 1.0], n)
    y = (m64.cpu() + torch.from_numpy(off)).float().to(m64.device)
    return y if mask is None else y * mask


def _svr_stats64(X, y, wm, g, o):
    X64, y64, g64, o64 = X.double(), y.double(), g.double(), o.double()
    wt = 1.0 / g64 + 1.0 / o64
    wt = wt if wm is None else wm.double() * wt
    coef = (y64 - EPS_INS) / g64 + (y64 + EPS_INS) / o64
    return X64.T @ coef, (X64 * wt[:, None]).T @ X64


@pytest.mark.parametrize("var,C", SVR)
@pytest.mark.parametrize("n,k,dtype", STAT_SHAPES)
def test_fused_stats_svr_kernel(cuda, n, k, dtype, var, C):
    X, _, beta, w, wm = _problem(n, k, dtype, cuda)
    y = _svr_targets(X.double() @ w.double(), None)
    epi, *rest = var.split(",")
    source = rest[0] if rest else None
    seed = rng.pack_seed(prng.fold_in(prng.PRNGKey(5), 2), 3, 1).to(cuda)
    noise = ref.seed_noise(seed, n, C, "mc_svr") if source else None
    kw = (dict(noise=noise) if source == "noise" else
          dict(seed=seed) if source == "seed" else {})
    if C > 1:
        w = torch.stack([w * (1.0 + 0.25 * c) for c in range(C)], 1)
    before = fused_stats.LAUNCHES[var]
    args = (X, y, beta, w, wm)
    opts = dict(epilogue=epi, eps=1e-6, eps_ins=EPS_INS)
    got = fused_stats.fused_stats(*args, **kw, **opts)
    again = fused_stats.fused_stats(*args, **kw, **opts)
    torch.cuda.synchronize()
    assert fused_stats.LAUNCHES[var] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    m, g, o, b, S = got
    _close_rows(m, X.double() @ w.double())
    yc = y if C == 1 else y[:, None]
    (g_plain, o_plain), _, _ = epilogues.apply_epilogue(
        epi, m, yc, torch.zeros_like(yc), noise, 1e-6, EPS_INS)
    if epi == "em_svr":
        assert torch.equal(g, g_plain) and torch.equal(o, o_plain)
        want = ref.fused_stats(X.double(), y.double(), beta.double(),
                               w.double(), wm.double(), 1e-6, "em_svr",
                               eps_ins=EPS_INS)
        _close_rows(g, want[1])
        _close_rows(o, want[2])
    else:
        _gamma_band(g, g_plain)
        _gamma_band(o, o_plain)
    for c in range(C):
        gc, oc = (g, o) if C == 1 else (g[:, c], o[:, c])
        b64, S64 = _svr_stats64(X, y, wm, gc, oc)
        _close_max(b if C == 1 else b[:, c], b64)
        _close_max(S if C == 1 else S[c], S64)


def test_svr_fit_goes_through_the_kernels(cuda):
    from repro_torch.data import make_year_like
    X, y = make_year_like(6000, 40, seed=0)
    for opts, key, kw in (("LIN-EM-SVR", "em_svr", {}),
                          ("LIN-MC-SVR", "mc_svr,seed", dict(rng="fused"))):
        cfg = SVMConfig.from_options(opts, lam=lam_from_C(0.01),
                                     eps_ins=EPS_INS, max_iters=60, **kw)
        before = dict(fused_stats.LAUNCHES)
        svm = PEMSVM(cfg)
        res = svm.fit(X, y)
        chunk = cfg.scan_chunk
        steps = min(cfg.max_iters, -(-res.n_iters // chunk) * chunk)
        launched = {k: v - before[k] for k, v in fused_stats.LAUNCHES.items()
                    if v != before[k]}
        assert res.converged and launched == {key: steps}
        plain = PEMSVM(dataclasses.replace(cfg, backend="ref"))
        rp = plain.fit(X, y)
        assert abs(plain.rmse(X, y) - svm.rmse(X, y)) <= 0.01
        assert np.all(np.isfinite(res.weights))
        if opts == "LIN-EM-SVR":
            assert abs(rp.n_iters - res.n_iters) <= 3


def test_wide_svr_route_launches_syrk_only(cuda):
    """em_svr past FUSED_STATS_MAX_K: a plain E-step, then syrk_tri; no
    fused_estep (em_hinge only) and no fused_stats."""
    X, _, beta, w, wm = _problem(300, ops.FUSED_STATS_MAX_K + 1,
                                 torch.float32, cuda)
    y = _svr_targets(X.double() @ w.double(), None)
    counts = (dict(fused_stats.LAUNCHES), fused_estep.LAUNCHES,
              syrk.LAUNCHES)
    got = ops.fused_stats(X, y, beta, w, wm, epilogue="em_svr",
                          eps_ins=EPS_INS)
    assert (fused_stats.LAUNCHES, fused_estep.LAUNCHES,
            syrk.LAUNCHES - 1) == counts
    want = ref.fused_stats(X.double(), y.double(), beta.double(),
                           w.double(), wm.double(), 1e-6, "em_svr",
                           eps_ins=EPS_INS)
    _close_max(got[4], want[4])


NYS_SVR = ["em_svr", "mc_svr,noise", "mc_svr,seed"]


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("var", NYS_SVR)
@pytest.mark.parametrize("shape", NYS_SHAPES)
def test_nystrom_fused_stats_svr_kernel(cuda, shape, var, chunked,
                                        monkeypatch):
    kind = "linear" if shape[1] == 130 else "rbf"
    X, L, P, mask, k64 = _nys(*shape, cuda, kind=kind)
    n, M = X.shape[0], L.shape[0] + 1
    g = torch.Generator(device=cuda).manual_seed(3)
    w = torch.randn(M, generator=g, device=cuda) / math.sqrt(M)
    phi64 = ref.nystrom_phi(X.double(), L.double(), P.double(),
                            mask.double(), 1.3, kind, True)
    m64 = phi64 @ w.double()
    y = _svr_targets(m64, mask)
    epi, _, source = var.partition(",")
    seed = rng.pack_seed(prng.fold_in(prng.PRNGKey(5), 2), 3, 0).to(cuda)
    noise = ref.seed_noise(seed, n, 1, "mc_svr") if source else None
    kw = (dict(noise=noise) if source == "noise" else
          dict(seed=seed) if source == "seed" else {})
    zero = torch.zeros_like(y)
    args = (X, L, P, y, zero, w, mask)
    opts = dict(sigma=1.3, kind=kind, add_bias=True, epilogue=epi, eps=1e-6,
                eps_ins=EPS_INS)
    one = nys.nystrom_fused_stats(*args, **kw, **opts)
    if chunked:  # several row chunks give the same bits as one
        monkeypatch.setattr(nys, "SCRATCH_WORDS", 32 * M * 2)
    key = f"nystrom_fused_stats[{var}]"
    before = nys.LAUNCHES[key]
    m, gam, om, b, S = nys.nystrom_fused_stats(*args, **kw, **opts)
    torch.cuda.synchronize()
    assert nys.LAUNCHES[key] == before + 1
    assert all(torch.equal(a, c) for a, c in zip(one, (m, gam, om, b, S)))
    _within(m, m64, _phi_scale(k64, P, mask, True) @ w.double().abs())
    (g_plain, o_plain), _, _ = epilogues.apply_epilogue(
        epi, m, y, zero, noise, 1e-6, EPS_INS)
    if epi == "em_svr":
        assert torch.equal(gam, g_plain) and torch.equal(om, o_plain)
        # padded and masked rows: y = 0, phi row 0, so res = 0
        assert torch.all(gam[mask == 0] == torch.tensor(EPS_INS))
    else:
        _nys_gamma_band(gam, g_plain)
        _nys_gamma_band(om, o_plain)
    phi = nys.nystrom_phi(X, L, P, mask, sigma=1.3, kind=kind,
                          add_bias=True)
    b64, S64 = _svr_stats64(phi, y, mask, gam, om)
    _close_max(b, b64)
    _close_max(S, S64)


# ---------------------------------------------------------- weighted_gram
@pytest.mark.parametrize("n,k,dtype,offset", GRAM_SHAPES)
def test_weighted_gram_kernel(cuda, n, k, dtype, offset):
    from repro_torch.kernels import weighted_gram as wg
    X, wt = _gram_problem(n, k, dtype, offset, cuda)
    before = wg.LAUNCHES
    got = wg.weighted_gram(X, wt)
    again = ops.weighted_gram(X, wt)
    torch.cuda.synchronize()
    assert wg.LAUNCHES == before + 2 and torch.equal(got, again)
    want = ref.weighted_gram(X.double(), wt.double())
    _close_max(got, want)
    _close_max(got.T, want)  # each triangle on its own, not mirrored
    with pytest.raises(TypeError):
        wg.weighted_gram(X, wt.double())


# The column window: the window kernels run the full statistic's own tiles
# over its split plan, so every window is bitwise the full kernel's column
# slice, and margin, gamma (omega) and b are bitwise the full kernel's;
# Sigma's window is also held within 1e-5 max of a float64 recomputation
# from the kernel's own gamma (and omega).
WIN_VARIANTS = ["em_hinge", "mc_hinge,noise", "mc_hinge,seed", "em_svr",
                "mc_svr,seed"]


def _windows(width):
    return [(0, width // 2), (width // 3, width // 3), (width - 1, 1),
            (0, width)]


@pytest.mark.parametrize("var", WIN_VARIANTS)
@pytest.mark.parametrize("n,k,dtype", STAT_SHAPES)
def test_fused_stats_window_kernel(cuda, n, k, dtype, var):
    X, rho, beta, w, wm = _problem(n, k, dtype, cuda)
    epi, _, source = var.partition(",")
    svr = epi.endswith("svr")
    if svr:
        beta = torch.zeros_like(rho)
    seed = rng.pack_seed(prng.fold_in(prng.PRNGKey(5), 2), 3, 0).to(cuda)
    kw = (dict(noise=ref.seed_noise(seed, n, 1, epi)) if source == "noise"
          else dict(seed=seed) if source == "seed" else {})
    kw.update(epilogue=epi, eps=1e-6, eps_ins=0.3 if svr else 0.0)
    full = fused_stats.fused_stats(X, rho, beta, w, wm, **kw)
    g64 = full[1].double()
    wt = 1.0 / g64 + (1.0 / full[2].double() if svr else 0.0)
    S64 = (X.double() * (wm.double() * wt)[:, None]).T @ X.double()
    for start, blk in _windows(k):
        before = fused_stats.LAUNCHES[var + ",window"]
        got = fused_stats.fused_stats(X, rho, beta, w, wm,
                                      col_window=(start, blk), **kw)
        torch.cuda.synchronize()
        assert fused_stats.LAUNCHES[var + ",window"] == before + 1
        assert all(torch.equal(a, c) for a, c in zip(got[:-1], full[:-1]))
        assert torch.equal(got[-1], full[-1][:, start:start + blk])
        err = (got[-1].double() - S64[:, start:start + blk]).abs().max()
        assert err <= REL * S64.abs().max(), (start, blk, err)


@pytest.mark.parametrize("var", ["em_hinge", "mc_hinge,seed", "em_svr"])
@pytest.mark.parametrize("shape", NYS_SHAPES)
def test_nystrom_fused_stats_window_kernel(cuda, shape, var, monkeypatch):
    kind = "linear" if shape[1] == 130 else "rbf"
    X, L, P, mask, _ = _nys(*shape, cuda, kind=kind)
    n, M = X.shape[0], L.shape[0] + 1
    g = torch.Generator(device=cuda).manual_seed(3)
    w = torch.randn(M, generator=g, device=cuda) / math.sqrt(M)
    y = torch.where(torch.rand(n, generator=g, device=cuda) < 0.5, -1.0,
                    1.0) * mask
    epi, _, source = var.partition(",")
    svr = epi.endswith("svr")
    seed = rng.pack_seed(prng.fold_in(prng.PRNGKey(5), 2), 3, 0).to(cuda)
    kw = dict(seed=seed) if source == "seed" else {}
    opts = dict(sigma=1.3, kind=kind, add_bias=True, epilogue=epi, eps=1e-6,
                eps_ins=0.3 if svr else 0.0)
    beta = torch.zeros_like(y) if svr else y
    monkeypatch.setattr(nys, "SCRATCH_WORDS", 32 * M * 2)  # several chunks
    full = nys.nystrom_fused_stats(X, L, P, y, beta, w, mask, **kw, **opts)
    for start, blk in _windows(M):
        before = nys.LAUNCHES[f"nystrom_fused_stats[{var},window]"]
        got = nys.nystrom_fused_stats(X, L, P, y, beta, w, mask,
                                      col_window=(start, blk), **kw, **opts)
        torch.cuda.synchronize()
        assert nys.LAUNCHES[f"nystrom_fused_stats[{var},window]"] == \
            before + 1
        assert all(torch.equal(a, c) for a, c in zip(got[:-1], full[:-1]))
        assert torch.equal(got[-1], full[-1][:, start:start + blk])


def test_ops_window_routes(cuda):
    """On the card every window runs the window kernel, also past
    FUSED_STATS_MAX_K (where the full width takes the split route) and at
    a wide window (4000 x 2000, past the reference's windowed VMEM budget):
    one em_hinge window launch a call, the window within 1e-5 max|S| of
    the plain windowed statistic, and margin, gamma, b and the window
    bitwise the full-width kernel's (and its column slice)."""
    for n, k, window in ((300, 1600, (800, 800)), (300, 4000, (0, 2000))):
        X, rho, beta, w, _ = _problem(n, k, torch.float32, cuda)
        before = dict(fused_stats.LAUNCHES)
        got = ops.fused_stats(X, rho, beta, w, col_window=window)
        torch.cuda.synchronize()
        after = dict(fused_stats.LAUNCHES)
        assert after.pop("em_hinge,window") == \
            before.pop("em_hinge,window") + 1
        assert after == before
        plain = ops.fused_stats(X, rho, beta, w, col_window=window,
                                backend="ref")
        assert got[-1].shape == (k, window[1])
        _close_rows(got[0], plain[0].double())
        scale = REL * plain[-1].abs().max()
        assert (got[-1] - plain[-1]).abs().max() <= scale
        full = fused_stats.fused_stats(X, rho, beta, w)  # the kernel, any K
        assert all(torch.equal(a, c) for a, c in zip(got[:-1], full[:-1]))
        start, blk = window
        assert torch.equal(got[-1], full[-1][:, start:start + blk])

# The cross-Gram (csrc/rbf.cuh) on both of its routes: the Gram engine's
# tile pass and the direct product of small depths. (n, D, m): depths on
# both sides of rbf_gram.CROSS_DIRECT_MAX_D and of a 32-deep stage; row
# and landmark counts that are not multiples of 128 or of 4.
CROSS_SHAPES = [(1037, 1, 45), (517, 2, 130), (203, 3, 257), (1031, 31, 99),
                (301, 32, 128), (517, 33, 61), (203, 90, 681),
                (131, 500, 258)]


def _routes(monkeypatch, route):
    """Every depth on ``route`` (rbf_gram's threshold moved past it)."""
    monkeypatch.setattr(rbfk, "CROSS_DIRECT_MAX_D",
                        1 << 20 if route == "direct" else 0)


def _cross_inputs(n, d, m, dtype, dev, seed=0):
    g = np.random.default_rng(seed)
    X = (g.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    L = (g.normal(size=(m, d)) / np.sqrt(d)).astype(np.float32)
    L[: min(5, m)] = X[: min(5, m)]
    return (torch.from_numpy(X).to(dtype).to(dev),
            torch.from_numpy(L).to(dev))


@pytest.mark.parametrize("route", ["engine", "direct"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["rbf", "linear"])
@pytest.mark.parametrize("shape", CROSS_SHAPES)
def test_cross_gram_landmark_major(cuda, shape, kind, dtype, route,
                                   monkeypatch):
    """The featurizer's cross-Gram chunk, landmark-major, over several row
    chunks: nystrom_phi with proj = I is k(X, L) itself (each phi entry is
    k + exact zeros), held to the plain version in float64 (rbf |d| <=
    1e-5 |ref| + 1e-7; linear 1e-5 of |X| @ |L|^T); the other route's
    values equal, up to the sign of a linear kind's zero."""
    n, d, m = shape
    X, L = _cross_inputs(n, d, m, dtype, cuda)
    eye = torch.eye(m, device=cuda)
    monkeypatch.setattr(nys, "SCRATCH_WORDS", 128 * max(m, d) + 1)
    assert nys._phi_chunk_rows(n, m, m, D=d) == 128 < n
    _routes(monkeypatch, route)
    got = nys.nystrom_phi(X, L, eye, sigma=0.9, kind=kind)
    _routes(monkeypatch, "engine" if route == "direct" else "direct")
    other = nys.nystrom_phi(X, L, eye, sigma=0.9, kind=kind)
    torch.cuda.synchronize()
    X64, L64 = X.double(), L.double()
    if kind == "rbf":
        want = ref.rbf_gram(X64, L64, 0.9)
        assert torch.all((got.double() - want).abs()
                         <= 1e-5 * want.abs() + 1e-7)
        assert torch.equal(_bits(got), _bits(other))
    else:
        want = X64 @ L64.T
        _within(got, want, X64.abs() @ L64.abs().T)
        assert torch.equal(got, other)


@pytest.mark.parametrize("route", ["engine", "direct"])
@pytest.mark.parametrize("dtypes", [(torch.float32,) * 2,
                                    (torch.bfloat16, torch.float32),
                                    (torch.bfloat16,) * 2])
@pytest.mark.parametrize("shape", CROSS_SHAPES)
def test_cross_gram_row_major(cuda, shape, dtypes, route, monkeypatch):
    """rbf_gram's row-major cross-Gram on each route, for each pair of
    operand types (N2 % 4 != 0 takes 4-byte stores), against the plain
    version in float64; both routes bitwise equal."""
    n, d, m = shape
    X, L = _cross_inputs(n, d, m, dtypes[0], cuda)
    L = L.to(dtypes[1])
    _routes(monkeypatch, route)
    got = rbfk.rbf_gram(X, L, sigma=0.9)
    _routes(monkeypatch, "engine" if route == "direct" else "direct")
    other = rbfk.rbf_gram(X, L, sigma=0.9)
    torch.cuda.synchronize()
    want = ref.rbf_gram(X.double(), L.double(), 0.9)
    assert torch.all((got.double() - want).abs() <= 1e-5 * want.abs() + 1e-7)
    assert torch.equal(_bits(got), _bits(other))
