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
"""
import numpy as np
import pytest
import torch

from repro_torch.core import PEMSVM, SVMConfig, lam_from_C, prng
from repro_torch.data import make_blobs
from repro_torch.kernels import (epilogues, fused_estep, fused_stats, ops,
                                 ref, rng, syrk)

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


@pytest.mark.parametrize("n,k,dtype", SHAPES)
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


@pytest.mark.parametrize("n,k,dtype", SHAPES)
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


@pytest.mark.parametrize("n,k,dtype", SHAPES)
def test_syrk_kernel(cuda, n, k, dtype):
    X, rho, _, w, _ = _problem(n, k, dtype, cuda)
    wt = 1.0 / (rho - X.float() @ w).abs().clamp_min(1e-6)
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
      ("mc_hinge,seed,multichain", 3)]


def _gamma_band(g, g_plain):
    g, gp = g.reshape(-1).double(), g_plain.reshape(-1).double()
    assert torch.all(torch.isfinite(g)) and torch.all(g >= 1e-6)
    assert (g == gp).double().mean() >= 0.99
    assert ((g - gp).abs() / gp.abs() <= 1e-3).double().mean() >= 0.9995


@pytest.mark.parametrize("var,C", MC)
@pytest.mark.parametrize("n,k,dtype", SHAPES)
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
