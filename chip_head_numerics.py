#!/usr/bin/env python3
"""Float32 EM of the max-margin head on granite-3-2b's features, one GPU.

    python3 chip_head_numerics.py [--seeds 0,1,2,3] [--steps 30]

Needs one CUDA device and ``nvcc`` (it builds the kernels as
``chip_smoke.py`` does, at first use); exits non-zero without a card.
The features are those of ``chip_smoke.py`` phase 18 (c): granite-3-2b
at full width with 4 of its 40 layers, ``Model.init(0)``, mean-pooled
over 128 tokens, 8,192 documents of ``chip_smoke.lm_docs`` split 6,144
for training (K = 2,049 with the bias, so the statistic runs
``fused_estep`` + ``syrk_tri``) and 2,048 held out. LIN-EM-CLS, lam
0.1, max_iters 60.

1. For each data seed: five fits on the same features, each with its
   iterations, whether it converged, its last objectives, held-out
   accuracy and its weights' distance to the float64 fit: the kernel
   route, the kernel route on the features moved one ulp up, the plain
   route (``backend="ref"``, float32 on the card), its one-ulp twin, and
   a float64 fit (``chip_smoke.fit64``: the plain route's step in
   float64, the solver's stopping rule).
2. Along the kernel fit's own trajectory on the first seed, step by step
   from the same state w_t: the error of each float32 output against
   float64 (margin; the Gram Sigma against float64 on the route's own
   weights 1 / gamma; b), the smallest eigenvalue of each route's P
   beside the float64 P's, the rows at the hinge, and the weights each
   step makes (kernel, plain, the two hybrids that swap the Gram, and
   the float64 solve of the kernel's float32 statistics): their distance
   to the float64 step and their objective, evaluated in float64.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_DOCS, N_TRAIN, LAYERS = 8192, 6144, 4


def say(*a):
    print(*a, flush=True)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_head_numerics: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    chip_smoke.torch = torch
    from repro_torch.configs import get_config
    from repro_torch.core import (PEMSVM, MaxMarginHead, SVMConfig,
                                  mean_pool)
    from repro_torch.core import objective, stats
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = SVMConfig(lam=0.1, max_iters=60)
    lam, eps, jitter = cfg.lam, cfg.eps, cfg.jitter
    say(f"card: {chip_smoke.smi()}")

    mcfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=LAYERS)
    model = build_model(mcfg, dev)
    model.init(0)
    head = MaxMarginHead(cfg, lambda t: mean_pool(
        model.hidden_seq({"tokens": t}).float()), device=dev)

    def operands(X, y, dtype):
        A = np.hstack([X, np.ones((len(X), 1), np.float32)])
        At = torch.from_numpy(A).to(dev, dtype)
        yt = torch.from_numpy(np.asarray(y, np.float32)).to(dev, dtype)
        return At, yt, torch.ones_like(yt)

    def acc(w, X, y):
        A = np.hstack([X, np.ones((len(X), 1), np.float32)])
        return float(np.mean(np.where(A @ w >= 0, 1.0, -1.0) == y))

    seeds = [int(s) for s in args.seeds.split(",")]
    feats = {}
    say(f"== 1. whole fits, granite-3-2b ({LAYERS} layers) head, "
        f"{N_TRAIN:,} training rows, K = {mcfg.d_model + 1}")
    for seed in seeds:
        toks, y = chip_smoke.lm_docs(mcfg.vocab, N_DOCS, seed=seed)
        X = head.extract(toks)
        Xtr, ytr, Xte, yte = X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], \
            y[N_TRAIN:]
        feats[seed] = (Xtr, ytr)
        up = np.nextafter(Xtr, np.float32(np.inf))
        w64, it64, objs64 = chip_smoke.fit64(cfg, dev, Xtr, ytr)
        say(f"  seed {seed}: float64 fit {it64} iterations, objective tail "
            f"{np.round(objs64[-3:], 3).tolist()}, held-out accuracy "
            f"{acc(w64, Xte, yte):.4f}")
        runs = {}
        for name, backend, Xf in (("kernel", None, Xtr),
                                  ("kernel+1ulp", None, up),
                                  ("plain", "ref", Xtr),
                                  ("plain+1ulp", "ref", up)):
            svm = PEMSVM(dataclasses.replace(cfg, backend=backend),
                         device=dev)
            r = svm.fit(Xf, ytr)
            runs[name] = r
            ok = bool(np.all(np.isfinite(r.weights)))
            say(f"  seed {seed}: {name:12s} {r.n_iters:2d} iterations, "
                f"converged {r.converged}, finite {ok}, objective tail "
                f"{np.round(r.objective[-3:], 3).tolist()}, held-out "
                f"accuracy {acc(r.weights, Xte, yte):.4f}, weights "
                f"{rel(r.weights, w64):.3e} from float64")
        wt = {k: r.weights for k, r in runs.items()}
        say(f"  seed {seed}: kernel vs plain "
            f"{rel(wt['kernel'], wt['plain']):.3e}, plain vs plain+1ulp "
            f"{rel(wt['plain+1ulp'], wt['plain']):.3e}, kernel vs "
            f"kernel+1ulp {rel(wt['kernel+1ulp'], wt['kernel']):.3e}")

    say(f"== 2. the kernel fit's trajectory on seed {seeds[0]}, step by "
        f"step from the same state (errors against float64)")
    Xtr, ytr = feats[seeds[0]]
    A, yt, mask = operands(Xtr, ytr, torch.float32)
    A64, y64, mask64 = A.double(), yt.double(), mask.double()
    K = A.shape[1]
    eye = torch.eye(K, dtype=torch.float64, device=dev)

    def P_of(S):
        """posterior_params' P, evaluated in float64 from S."""
        S = S.double()
        P = S + lam * eye
        P = 0.5 * (P + P.T)
        return P + (jitter * torch.trace(P) / K) * eye

    def J(w):
        w = w.double()
        return float(objective.l2_reg(w, lam) + objective.hinge_obj_terms(
            A64 @ w, y64, mask64))

    def gram64(gamma):
        return ops.syrk_tri(A64, 1.0 / gamma.double(), backend="ref")

    def b64(gamma):
        return A64.T @ (y64 / gamma.double() + y64)

    def solve32(S, b):
        return stats.posterior_params(S, b, lam, jitter=jitter)[1]

    def solve64(S, b):
        return stats.posterior_params(S.double(), b.double(), lam,
                                      jitter=jitter)[1]

    def lmin(S):
        return torch.linalg.eigvalsh(P_of(S))[0].item()

    w = torch.zeros(K, dtype=torch.float32, device=dev)
    say("  t: J(w_t) | rows |1 - y m| < 1e-3, gamma at eps | margin err "
        "kernel, plain | Gram err kernel, plain (2-norm rel) | lambda_min "
        "P: kernel, plain, float64 | step to float64 step, J: kernel, "
        "plain, kernel gamma + plain Gram, plain gamma + kernel Gram, "
        "kernel stats solved in float64 | float64 step J")
    for t in range(args.steps):
        m_k, g_k, b_k = ops.fused_estep(A, yt, yt, w, eps=eps)
        S_k = ops.syrk_tri(A, 1.0 / g_k)
        m_p, g_p, b_p = ops.fused_estep(A, yt, yt, w, eps=eps,
                                        backend="ref")
        S_p = ops.syrk_tri(A, 1.0 / g_p, backend="ref")
        m64 = A64 @ w.double()
        g64 = (y64 - m64).abs().clamp_min(eps)
        S64 = gram64(g64)
        w64 = solve64(S64, b64(g64))
        Sk64, Sp64 = gram64(g_k), gram64(g_p)
        gerr = [(torch.linalg.matrix_norm(S.double() - R, ord=2)
                 / torch.linalg.matrix_norm(R, ord=2)).item()
                for S, R in ((S_k, Sk64), (S_p, Sp64))]
        steps = {
            "kernel": solve32(S_k, b_k),
            "plain": solve32(S_p, b_p),
            "k-gamma/p-Gram": solve32(ops.syrk_tri(A, 1.0 / g_k,
                                                   backend="ref"), b_k),
            "p-gamma/k-Gram": solve32(ops.syrk_tri(A, 1.0 / g_p), b_p),
            "kernel in f64": solve64(S_k, b_k),
        }
        near = int(((1 - y64 * m64).abs() < 1e-3).sum())
        at_eps = int((g_k <= eps).sum())
        parts = ", ".join(
            f"{rel(v.cpu().numpy(), w64.cpu().numpy()):.2e} "
            f"{J(v):.1f}" for v in steps.values())
        say(f"  {t:2d}: {J(w):.2f} | {near} {at_eps} | "
            f"{(m_k.double() - m64).abs().max().item():.2e} "
            f"{(m_p.double() - m64).abs().max().item():.2e} | "
            f"{gerr[0]:.2e} {gerr[1]:.2e} | {lmin(S_k):.3e} "
            f"{lmin(S_p):.3e} {lmin(S64):.3e} | {parts} | {J(w64):.1f}")
        w = steps["kernel"]
        if not bool(torch.isfinite(w).all()):
            say(f"  the kernel step at t = {t} is not finite")
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
