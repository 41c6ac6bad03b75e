#!/usr/bin/env python3
"""Float32 conditioning of the Nystrom statistic and posterior on one GPU.

    python3 chip_nystrom_numerics.py

Needs one CUDA device and ``nvcc`` (it builds the kernels as
``chip_smoke.py`` does, at first use); exits non-zero without a card.
Three measurements, the numbers behind the Nystrom findings in PERF.md and
ROADMAP.md:

1. Sigma at w = 0 on make_circles(1,000,000) with m = 1,000 landmarks
   (``chip_smoke.py`` phase 7): the range of its float64 eigenvalues, and
   for three float32 versions their 2-norm distance to it and their
   smallest eigenvalue, beside the fit's ridge plus jitter: the kernel
   (``nystrom_fused_stats``), the plain path (4,096-row splits summed in
   order), and one float32 product over all rows.
2. ``chip_smoke.py`` phase 8 (alpha-like 250,000 x 500, m = 2,048, sigma
   sqrt(500), 5 EM iterations) at lam 0.1 and 2: the kernel and plain
   fits' weights against a float64 EM on the same featurizer, and the
   condition number of the float64 posterior precision.
3. ``nystrom_phi`` against float64 where d2 = |x|^2 - 2 x.l + |l|^2
   cancels: 517 standard-normal rows at D = 130, sigma 1.3, 257
   landmarks drawn from the rows (k is ~0 except at the duplicates),
   unscaled and scaled by 1 / sqrt(D): the largest |d phi| over its
   tolerance scale |k| @ |proj|.
"""
import math
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def say(*a):
    print(*a, flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_nystrom_numerics: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import NystromSVM, SVMConfig, nystrom_projection
    from repro_torch.data import make_alpha_like, make_circles
    from repro_torch.kernels import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    f64 = dict(dtype=torch.float64, device=dev)

    def featurizer(X, m, sigma):
        L = X[np.random.default_rng(0).choice(len(X), size=m,
                                              replace=False)]
        P = nystrom_projection(L, sigma=sigma, device=dev)
        return L, P.astype(np.float32)

    def phi64(Xd, L, P, sigma, rows=65_536):
        out = torch.empty((Xd.shape[0], P.shape[1] + 1), **f64)
        Ld = torch.from_numpy(L).to(dev).double()
        Pd = torch.from_numpy(P).to(dev).double()
        for c0 in range(0, Xd.shape[0], rows):
            out[c0:c0 + rows] = ref.nystrom_phi(
                Xd[c0:c0 + rows].double(), Ld, Pd, None, sigma, "rbf", True)
        return out

    say("== 1. Sigma at w = 0, make_circles(1,000,000), m = 1,000")
    X, y = make_circles(1_000_000)
    L, P = featurizer(X, 1000, 0.7)
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    Ld, Pd = torch.from_numpy(L).to(dev), torch.from_numpy(P).to(dev)
    w = torch.zeros(P.shape[1] + 1, device=dev)
    mask = torch.ones(len(X), device=dev)
    _, g, _, S_kernel = ops.nystrom_fused_stats(Xd, Ld, Pd, yd, yd, w, mask,
                                                sigma=0.7, add_bias=True)
    _, _, _, S_plain = ops.nystrom_fused_stats(
        Xd, Ld, Pd, yd, yd, w, mask, sigma=0.7, add_bias=True,
        backend="ref")
    phi32 = ref.nystrom_phi(Xd, Ld, Pd, mask, 0.7, "rbf", True)
    S_one = (phi32 / g[:, None]).T @ phi32   # one product over all rows
    del phi32
    phi = phi64(Xd, L, P, 0.7)
    S64 = (phi / g.double()[:, None]).T @ phi
    del phi
    ev = torch.linalg.eigvalsh(S64)
    K = S64.shape[0]
    ridge = 0.1 + 1e-4 * (torch.trace(S64).item() + 0.1 * K) / K
    say(f"  float64 Sigma eigenvalues {ev.min().item():.3e} .. "
        f"{ev.max().item():.3e}; ridge lam 0.1 plus jitter {ridge:.3e}")
    for name, S in (("kernel", S_kernel), ("plain, 4,096-row splits",
                                           S_plain),
                    ("one float32 product", S_one)):
        Sd = S.double()
        dist = torch.linalg.matrix_norm(Sd - S64, ord=2).item()
        low = torch.linalg.eigvalsh(0.5 * (Sd + Sd.T)).min().item()
        say(f"  {name}: |S - S64|_2 {dist:.3e}, smallest eigenvalue "
            f"{low:.3e}")
    del S_kernel, S_plain, S_one, S64, Xd, yd

    say("== 2. chip_smoke.py phase 8 against a float64 EM, lam 0.1 and 2")
    X, y = make_alpha_like(n=300_000, k=500, seed=0)
    X, y = X[:250_000], y[:250_000]
    sigma = math.sqrt(500)
    L, P = featurizer(X, 2048, sigma)
    phi = phi64(torch.from_numpy(X).to(dev), L, P, sigma)
    y64 = torch.from_numpy(y).to(dev).double()
    K = phi.shape[1]
    eye = torch.eye(K, **f64)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for lam in (0.1, 2.0):
        fits = {}
        for backend in (None, "ref"):
            cfg = SVMConfig.from_options(
                "KRN-EM-CLS", lam=lam, sigma=sigma, max_iters=5,
                min_iters=5, backend=backend)
            ny = NystromSVM(cfg, device=dev)
            fits[backend] = ny.fit_featurized(X, y, L, P).weights
        w64 = torch.zeros(K, **f64)
        for _ in range(5):
            gam = (y64 - phi @ w64).abs().clamp_min(cfg.eps)
            Pm = (phi / gam[:, None]).T @ phi + lam * eye
            Pm = 0.5 * (Pm + Pm.T)
            Pm = Pm + (cfg.jitter * torch.trace(Pm) / K) * eye
            w64 = torch.linalg.solve(Pm, phi.T @ (y64 / gam + y64))
        ev = torch.linalg.eigvalsh(Pm)
        w64 = w64.cpu().numpy()
        say(f"  lam {lam}: posterior precision condition number "
            f"{(ev.max() / ev.min()).item():.3e}; weights rel to the "
            f"float64 EM: kernel {rel(fits[None], w64):.3e}, plain "
            f"{rel(fits['ref'], w64):.3e}; kernel vs plain "
            f"{rel(fits[None], fits['ref']):.3e}")
    del phi

    say("== 3. nystrom_phi where d2 cancels, D = 130, sigma 1.3")
    from repro_torch.kernels import nystrom_phi
    g = np.random.default_rng(0)
    X = g.normal(size=(517, 130)).astype(np.float32)
    L = X[g.choice(517, size=257, replace=False)]
    P = torch.from_numpy((0.2 * g.normal(size=(257, 257))
                          / np.sqrt(257 / 45)).astype(np.float32)).to(dev)
    for name, scale in (("unscaled", 1.0), ("scaled by 1/sqrt(D)",
                                            1 / math.sqrt(130))):
        Xd = torch.from_numpy(X * np.float32(scale)).to(dev)
        Ld = torch.from_numpy(L * np.float32(scale)).to(dev)
        got = nystrom_phi.nystrom_phi(Xd, Ld, P, sigma=1.3)
        k64 = ref.rbf_gram(Xd.double(), Ld.double(), 1.3)
        want = k64 @ P.double()
        tol = k64.abs() @ P.double().abs()
        worst = ((got.double() - want).abs() / tol).max().item()
        say(f"  {name}: max |d phi| / (|k| @ |proj|) {worst:.3e} "
            f"(tolerance 1e-5)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
