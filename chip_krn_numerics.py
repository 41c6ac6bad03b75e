#!/usr/bin/env python3
"""Table 7's exact KRN-EM-CLS in float32 and float64 on one GPU.

    python3 chip_krn_numerics.py [--steps 30]

Needs one CUDA device and ``nvcc`` (it builds the kernels as
``chip_smoke.py`` does, at first use); exits non-zero without a card.
The problem is ``chip_smoke.py`` phase 14's: make_circles(1,800), sigma
0.7, lam 2.0 (lam_from_C(1.0)), the default jitter 1e-4, 60 iterations.

1. The solver's fits: KRN-EM-CLS through the kernels on the card and
   through the plain path on the CPU (phase 14's yardstick): iterations,
   whether they converged, the objective trace.
2. EM steps from omega = 0 on the unpadded Gram, each under the solver's
   stopping rule (|d obj| <= tol N after min_iters): Sigma from the
   kernels with the posterior factored in float32 (``kernel.krn_step``'s
   arithmetic) and in float64; Sigma in float64 rounded to float32 with
   the float32 factor; everything in float64. For each, the iteration
   it stops at, and its objective at each step.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
LAM, SIGMA, N = 2.0, 0.7, 1800


def say(*a):
    print(*a, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_krn_numerics: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    chip_smoke.torch = torch
    from repro_torch.core import PEMSVM, SVMConfig, kernel, objective, stats
    from repro_torch.kernels import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    say(f"card: {chip_smoke.smi()}")
    X, y = chip_smoke.circles_data(N)
    cfg = SVMConfig.from_options("KRN-EM-CLS", lam=LAM, sigma=SIGMA,
                                 max_iters=60)

    say("== 1. the solver's fits")
    for name, device in (("kernels, card", dev), ("plain, CPU", "cpu")):
        r = PEMSVM(cfg, device=device).fit(X, y)
        say(f"  {name}: {r.n_iters} iterations, converged {r.converged}, "
            f"objective {np.round(r.objective, 3).tolist()}")

    say("== 2. EM steps on the unpadded Gram, the solver's stopping rule")
    G = kernel.gram_matrix(torch.from_numpy(X).to(dev),
                           torch.from_numpy(X).to(dev), sigma=SIGMA)
    G64 = ref.rbf_gram(torch.from_numpy(X).to(dev).double(),
                       torch.from_numpy(X).to(dev).double(), SIGMA)
    t = torch.from_numpy(y).to(dev)
    n = len(y)

    def run(sigma_of, factor64, all64=False):
        Gm = G64 if all64 else G
        tt = t.double() if all64 else t
        om = torch.zeros(n, dtype=Gm.dtype, device=dev)
        objs, small, infos = [], 0, []
        for it in range(1, args.steps + 1):
            m = Gm @ om
            g = (tt - m).abs().clamp_min(cfg.eps)
            b = Gm.T @ (tt / g + tt)
            S = sigma_of(Gm, g, om)
            if factor64 or all64:
                S, b, Gp = S.double(), b.double(), Gm.double()
            else:
                Gp = Gm
            P = S + LAM * Gp
            P = 0.5 * (P + P.T)
            P = P + (cfg.jitter * torch.trace(P) / n) * torch.eye(
                n, dtype=P.dtype, device=dev)
            infos.append(int(torch.linalg.cholesky_ex(P)[1]))
            mu = stats.posterior_params(S, b, LAM, prior_precision=Gp,
                                        jitter=cfg.jitter)[1]
            om = mu.to(Gm.dtype)
            obj = float(objective.kernel_reg(om, Gm @ om, LAM)
                        + objective.hinge_obj_terms(m, tt,
                                                    torch.ones_like(tt)))
            objs.append(obj)
            small = (small + 1 if len(objs) >= 2 and abs(objs[-1] - objs[-2])
                     <= cfg.tol * n else 0)
            if not np.isfinite(obj):
                break
        stop = next((i + 1 for i in range(cfg.min_iters - 1, len(objs))
                     if i >= 1 and abs(objs[i] - objs[i - 1])
                     <= cfg.tol * n), None)
        return stop, objs, infos

    def kernel_sigma(Gm, g, om):
        return ops.fused_stats(Gm, t, t, om, None, None, eps=cfg.eps)[-1]

    def rounded_sigma(Gm, g, om):
        Gd = G64
        return ((Gd / g.double()[:, None]).T @ Gd).float()

    def sigma64(Gm, g, om):
        return (Gm / g[:, None]).T @ Gm

    for name, fn, f64, a64 in (
            ("kernel Sigma, float32 factor", kernel_sigma, False, False),
            ("kernel Sigma, float64 factor", kernel_sigma, True, False),
            ("float64 Sigma rounded, float32 factor", rounded_sigma, False,
             False),
            ("all float64", sigma64, True, True)):
        stop, objs, infos = run(fn, f64, a64)
        failed = [i for i, v in enumerate(infos) if v]
        say(f"  {name}: stops at {stop}; P fails its factor at steps "
            f"{failed}; objective {np.round(objs, 3).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
