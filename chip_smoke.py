#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device (an H100: the kernels are built for sm_90a) and
``nvcc``. Phases, each printing its own lines; any failure exits non-zero:

1. device: the card's name and power limit, torch/CUDA versions, TF32
   flags (both set off);
2. build: compile the kernels from ``src/repro_torch/csrc`` and print the
   compiler's register / shared-memory / spill report;
3. kernels vs plain: each kernel at its main-path shape and at odd masked
   shapes, f32 and bf16 X, in the well-conditioned and the hinge regime of
   tests/test_torch_kernels_ref.py, against the plain PyTorch version
   evaluated in float64; each called twice and required bitwise equal;
   then timed (CUDA events, median of 10 launches after warm-up) beside
   the plain version, a one-call library equivalent where one exists, and
   the bound max(flop / 67 TFLOP/s, bytes / 3.35 TB/s). The three
   mc_hinge variants of fused_stats (noise operands, the in-kernel
   counter seed, and four chains on the seed) are held so: margins
   against the float64 plain version; gamma against the plain epilogue
   applied to the kernel's own margin and noise (at least 99 % of rows
   bitwise equal, 99.95 % within 1e-3 relative, all finite and >= eps);
   b and Sigma against a float64 recomputation from the kernel's own
   gamma;
4. main path, K <= 1536: LIN-EM-CLS fit on make_alpha_like(300,000 x 500)
   (250,000 training rows, 50,000 held out) through the kernels and
   through the plain path, both on the card, held to the bands of
   tests/test_torch_em_cls.py; fused_stats must have launched once per
   iteration run;
5. main path, K > 1536: 5 iterations at K = 2,048 through fused_estep
   and syrk_tri, and not through fused_stats;
6. main path, LIN-MC-CLS (the Gibbs sampler) on the alpha-like set:
   rng='fused' through the kernels and through the plain path, both
   converged, accuracy within 0.01, posterior-mean weights within 3x the
   spread of two plain fits (seeds 0 and 1); an rng='host' fit through
   the noise-operand variant and an n_chains=4 fit through the multichain
   variant, each launched once per step run; then a torch.profiler
   breakdown of one rng='fused' fit and its set-up time.

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_FP32 = 67e12       # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s
REL = 1e-5              # tolerance of tests/test_torch_kernels_ref.py
EPS = 1e-6              # the gamma clamp of SVMConfig

torch = None            # imported in main(), after the device check


def check(ok: bool, msg: str) -> None:
    if not ok:
        print(f"FAIL: {msg}", flush=True)
        raise SystemExit(1)


def say(*a) -> None:
    print(*a, flush=True)


# ------------------------------------------------------------ measurement
def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(flop: float, nbytes: float) -> tuple[float, str]:
    t_op, t_mem = flop / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")


# ---------------------------------------------------------------- inputs
def problem(n: int, k: int, dtype, regime: str, dev, seed: int = 0):
    """(X, rho, beta, w, wmask) on ``dev``. well: rho = m64 +- U[0.05, 2]
    (gamma >= ~0.05); hinge: rho = beta = y at a random w (gamma reaches
    the clamp on rows at the knee)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn(n, k, generator=g, device=dev).to(dtype)
    w = torch.randn(k, generator=g, device=dev) / math.sqrt(k)
    y = torch.where(torch.rand(n, generator=g, device=dev) < 0.5, -1.0, 1.0)
    if regime == "well":
        m64 = X.double() @ w.double()
        off = 0.05 + 1.95 * torch.rand(n, generator=g, device=dev,
                                       dtype=torch.float64)
        rho = (m64 + off * y.double()).float()
        beta = torch.randn(n, generator=g, device=dev)
    else:
        rho = beta = y
    wm = (torch.rand(n, generator=g, device=dev) > 0.2).float()
    return X, rho.contiguous(), beta.contiguous(), w, wm


def stats64(X, rho, beta, wm, gamma):
    """b and Sigma in float64 from a given gamma (wm None = ones)."""
    X64, g = X.double(), gamma.double()
    wt = 1.0 / g if wm is None else wm.double() / g
    coef = rho.double() / g + beta.double()
    return X64.T @ coef, (X64 * wt[:, None]).T @ X64


def rows_close(name, got, want):
    err = (got.double() - want).abs()
    check(bool(torch.all(err <= REL * (1 + want.abs()))),
          f"{name}: max |d| {err.max().item():.3e} exceeds 1e-5 (1 + |v|)")
    return err.max().item()


def max_close(name, got, want):
    err = (got.double() - want).abs().max().item()
    scale = want.abs().max().item()
    check(err <= REL * scale,
          f"{name}: max |d| {err:.3e} exceeds 1e-5 max|ref| = "
          f"{REL * scale:.3e}")
    return err


def gamma_close(name, g, m, g_ref, m_ref):
    """|dgamma| <= |dm| + half an ulp each side + 1e-7 (max, |.| are
    1-Lipschitz)."""
    lim = ((m.double() - m_ref).abs() + 2.0 ** -24 * (g.double() + g_ref)
           + 1e-7)
    check(bool(torch.all((g.double() - g_ref).abs() <= lim)),
          f"{name}: gamma differs by more than the margin difference")


def gamma_band(name, g, g_plain):
    """mc_hinge gamma against the plain epilogue on the same margin and
    noise: >= 99 % bitwise, >= 99.95 % within 1e-3, finite and >= eps."""
    g, gp = g.reshape(-1), g_plain.reshape(-1)
    check(bool(torch.all(torch.isfinite(g))) and bool(torch.all(g >= EPS)),
          f"{name}: gamma not finite or below eps")
    same = (g == gp).double().mean().item()
    rel = ((g.double() - gp.double()).abs() / gp.double().abs())
    near = (rel <= 1e-3).double().mean().item()
    check(same >= 0.99 and near >= 0.9995,
          f"{name}: gamma {same:.5f} bitwise equal, {near:.5f} within 1e-3")
    return same


def twice(fn):
    a, b = fn(), fn()
    torch.cuda.synchronize()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          "two launches on the same inputs differ")
    return a


# ---------------------------------------------------------------- phases
def phase_device():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("card (nvidia-smi name, power.limit):")
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    say(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    from repro_torch.kernels import _build
    path, log, secs = _build.build()
    _build.library()
    say(f"build: {path.relative_to(ROOT)} in {secs:.1f} s "
        f"(sources: {', '.join(p.name for p in sorted(_build.CSRC.glob('*.cu')))})")
    for line in log.splitlines():
        if line.startswith("==") or "Used" in line or "spill" in line \
                or "Compiling entry" in line:
            say(f"  {line.strip()}")


def check_fused_stats(dev, n, k, dtype, regime, masked):
    from repro_torch.kernels import fused_stats, ref
    X, rho, beta, w, wm = problem(n, k, dtype, regime, dev)
    wm = wm if masked else None
    m, g, b, S = twice(lambda: fused_stats.fused_stats(X, rho, beta, w, wm,
                                                       eps=EPS))
    want = ref.fused_stats(X.double(), rho.double(), beta.double(),
                           w.double(), None if wm is None else wm.double(),
                           EPS)
    name = f"fused_stats {n}x{k} {str(dtype)[6:]} {regime}"
    err = rows_close(name + " margin", m, want[0])
    if regime == "well":
        err = max(err, rows_close(name + " gamma", g, want[1]),
                  max_close(name + " b", b, want[2]),
                  max_close(name + " Sigma", S, want[3]))
    else:
        gamma_close(name, g, m, want[1], want[0])
        b64, S64 = stats64(X, rho, beta, wm, g)
        err = max(err, max_close(name + " b", b, b64),
                  max_close(name + " Sigma", S, S64))
    say(f"  ok {name}: bitwise repeatable, max |d| {err:.3e}")
    return err, (X, rho, beta, w, wm)


def check_estep(dev, n, k, dtype, regime):
    from repro_torch.kernels import fused_estep, ref
    X, rho, beta, w, _ = problem(n, k, dtype, regime, dev)
    m, g, b = twice(lambda: fused_estep.fused_estep(X, rho, beta, w,
                                                    eps=EPS))
    want = ref.fused_estep(X.double(), rho.double(), beta.double(),
                           w.double(), EPS)
    name = f"fused_estep {n}x{k} {str(dtype)[6:]} {regime}"
    err = rows_close(name + " margin", m, want[0])
    if regime == "well":
        err = max(err, rows_close(name + " gamma", g, want[1]),
                  max_close(name + " b", b, want[2]))
    else:
        gamma_close(name, g, m, want[1], want[0])
        err = max(err, max_close(name + " b", b,
                                 stats64(X, rho, beta, None, g)[0]))
    say(f"  ok {name}: bitwise repeatable, max |d| {err:.3e}")
    return err, (X, rho, beta, w)


def check_syrk(dev, n, k, dtype, regime):
    from repro_torch.kernels import ref, syrk
    X, rho, _, w, _ = problem(n, k, dtype, regime, dev)
    wt = 1.0 / (rho - X.float() @ w).abs().clamp_min(EPS)
    (S,) = twice(lambda: syrk.syrk_tri(X, wt))
    name = f"syrk_tri {n}x{k} {str(dtype)[6:]} {regime} weights"
    err = max_close(name, S, ref.syrk_tri(X.double(), wt.double()))
    say(f"  ok {name}: bitwise repeatable, max |d| {err:.3e}")
    return err, (X, wt)


MC_VARIANTS = {  # chip_smoke name: (LAUNCHES key, noise source, chains)
    "fused_stats[mc_hinge,noise]": ("mc_hinge,noise", "noise", 1),
    "fused_stats[mc_hinge,seed]": ("mc_hinge,seed", "seed", 1),
    "fused_stats[mc_hinge,seed,C=4]": ("mc_hinge,seed,multichain", "seed",
                                       4),
}


def mc_inputs(dev, n, k, source, chains, w):
    """noise= or seed= for the call, the noise the kernel sees (the plain
    stream on the card), and the (K,) or (K, C) weights."""
    from repro_torch.core import prng
    from repro_torch.kernels import ref, rng
    seed = rng.pack_seed(prng.fold_in(prng.PRNGKey(7), 3), 11, 1).to(dev)
    noise = ref.seed_noise(seed, n, chains, "mc_hinge")
    kw = dict(noise=noise) if source == "noise" else dict(seed=seed)
    if chains > 1:
        w = torch.stack([w * (1.0 + 0.25 * c) for c in range(chains)], 1)
    return kw, noise, w.contiguous()


def check_mc(dev, n, k, dtype, regime, masked, name):
    from repro_torch.kernels import epilogues, fused_stats, ref
    _, source, chains = MC_VARIANTS[name]
    X, rho, beta, w, wm = problem(n, k, dtype, regime, dev)
    wm = wm if masked else None
    kw, noise, w = mc_inputs(dev, n, k, source, chains, w)
    m, g, b, S = twice(lambda: fused_stats.fused_stats(
        X, rho, beta, w, wm, epilogue="mc_hinge", eps=EPS, **kw))
    label = f"{name} {n}x{k} {str(dtype)[6:]} {regime}"
    m64 = X.double() @ w.double()
    err = rows_close(label + " margin", m, m64)
    r, bt = (rho, beta) if chains == 1 else (rho[:, None], beta[:, None])
    (g_plain,), _, _ = epilogues.apply_epilogue("mc_hinge", m, r, bt, noise,
                                                EPS)
    same = gamma_band(label, g, g_plain)
    for c in range(chains):
        gc = g if chains == 1 else g[:, c]
        bc = b if chains == 1 else b[:, c]
        Sc = S if chains == 1 else S[c]
        b64, S64 = stats64(X, rho, beta, wm, gc)
        err = max(err, max_close(label + " b", bc, b64),
                  max_close(label + " Sigma", Sc, S64))
    say(f"  ok {label}: bitwise repeatable, gamma {same:.5f} bitwise equal "
        f"to the plain epilogue, max |d| {err:.3e}")
    return err, (X, rho, beta, w, kw)


def phase_kernels(dev, main_nk=(250_000, 501), wide_nk=(131_072, 2048),
                  small_nk=(1037, 29)):
    from repro_torch.kernels import fused_estep, fused_stats, ref, syrk
    f32, bf16 = torch.float32, torch.bfloat16
    out = {}
    n, k = small_nk
    for regime in ("well", "hinge"):
        check_fused_stats(dev, n, k, f32, regime, True)
        check_fused_stats(dev, n, k, bf16, regime, True)
        check_fused_stats(dev, n, k, bf16, regime, False)
        check_estep(dev, n, k, bf16, regime)
        check_syrk(dev, n, k, bf16, regime)

    n, k = main_nk  # as the fit calls it: no Sigma weight mask
    check_fused_stats(dev, n, k, f32, "hinge", False)
    err, (X, rho, beta, w, _) = check_fused_stats(dev, n, k, f32, "well",
                                                  False)
    ms = time_ms(lambda: fused_stats.fused_stats(X, rho, beta, w, eps=EPS))
    plain = time_ms(lambda: ref.fused_stats(X, rho, beta, w, None, EPS))
    b_ms, by = bound(n * k * (k + 1) + 4 * n * k,
                     4 * (n * k + 2 * n + k + 2 * n + k + k * k))
    out["fused_stats"] = dict(shape=[n, k], max_abs_err=err, ms=ms,
                              plain_ms=plain, bound_ms=b_ms, bound_by=by,
                              library_ms=None)
    del X, rho, beta, w

    for name in MC_VARIANTS:
        n, k = small_nk
        for regime in ("well", "hinge"):
            check_mc(dev, n, k, f32, regime, True, name)
            check_mc(dev, n, k, bf16, regime, True, name)
            check_mc(dev, n, k, bf16, regime, False, name)
        n, k = main_nk
        err, (X, rho, beta, w, kw) = check_mc(dev, n, k, f32, "hinge",
                                              False, name)
        C = 1 if w.dim() == 1 else w.shape[1]
        ms = time_ms(lambda: fused_stats.fused_stats(
            X, rho, beta, w, epilogue="mc_hinge", eps=EPS, **kw))
        plain = time_ms(lambda: ref.fused_stats(
            X, rho, beta, w, None, EPS, "mc_hinge", **kw))
        n_noise = 2 * n if "noise" in kw else 0
        b_ms, by = bound(C * n * k * (k + 1) + 4 * C * n * k,
                         4 * (n * k + 2 * n + C * k + n_noise + 2 * n * C
                              + C * k + C * k * k))
        out[name] = dict(shape=[n, k, C], max_abs_err=err, ms=ms,
                         plain_ms=plain, bound_ms=b_ms, bound_by=by,
                         library_ms=None)
        del X, rho, beta, w, kw

    n, k = wide_nk
    check_estep(dev, n, k, f32, "hinge")
    err, (X, rho, beta, w) = check_estep(dev, n, k, f32, "well")
    ms = time_ms(lambda: fused_estep.fused_estep(X, rho, beta, w, eps=EPS))
    plain = time_ms(lambda: ref.fused_estep(X, rho, beta, w, EPS))
    b_ms, by = bound(4 * n * k, 4 * (n * k + 2 * n + k + 2 * n + k))
    out["fused_estep"] = dict(shape=[n, k], max_abs_err=err, ms=ms,
                              plain_ms=plain, bound_ms=b_ms, bound_by=by,
                              library_ms=None)
    del X, rho, beta, w

    check_syrk(dev, n, k, f32, "hinge")
    err, (X, wt) = check_syrk(dev, n, k, f32, "well")
    ms = time_ms(lambda: syrk.syrk_tri(X, wt))
    plain = time_ms(lambda: ref.syrk_tri(X, wt))
    lib = time_ms(lambda: torch.einsum("nk,n,nj->kj", X, wt, X))
    b_ms, by = bound(n * k * (k + 1), 4 * (n * k + n + k * k))
    out["syrk_tri"] = dict(shape=[n, k], max_abs_err=err, ms=ms,
                           plain_ms=plain, bound_ms=b_ms, bound_by=by,
                           library_ms=lib)
    del X, wt
    for name, row in out.items():
        say(f"  time {name} {row['shape']}: kernel {row['ms']:.3f} ms, "
            f"plain {row['plain_ms']:.3f} ms, library "
            f"{row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 3)} ms, "
            f"bound {row['bound_ms']:.3f} ms ({row['bound_by']})")
    return out


def _counts():
    from repro_torch.kernels import fused_estep, fused_stats, syrk
    out = {"fused_stats": fused_stats.LAUNCHES["em_hinge"]}
    for name, (key, _, _) in MC_VARIANTS.items():
        out[name] = fused_stats.LAUNCHES[key]
    out["fused_estep"] = fused_estep.LAUNCHES
    out["syrk_tri"] = syrk.LAUNCHES
    return out


def _zero_counts():
    from repro_torch.kernels import fused_estep, fused_stats, syrk
    fused_stats.zero_launches()
    fused_estep.LAUNCHES = syrk.LAUNCHES = 0


def _fit(cfg, dev, X, y):
    from repro_torch.core import PEMSVM
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    svm = PEMSVM(cfg, device=dev)
    res = svm.fit(X, y)
    torch.cuda.synchronize()
    return svm, res, time.perf_counter() - t0


def phase_main_path(dev, n=300_000, n_train=250_000, k=500):
    from repro_torch.core import SVMConfig, lam_from_C
    from repro_torch.data import make_alpha_like
    X, y = make_alpha_like(n=n, k=k, seed=0)
    Xtr, ytr, Xte, yte = X[:n_train], y[:n_train], X[n_train:], y[n_train:]
    cfg = SVMConfig.from_options("LIN-EM-CLS", lam=lam_from_C(1.0),
                                 max_iters=100)
    # Warm-up: the first fit in a process pays cuBLAS/cuSOLVER set-up.
    Xw, yw = make_alpha_like(n=4096, k=k, seed=1)
    for backend in (None, "ref"):
        _fit(dataclasses.replace(cfg, max_iters=2, min_iters=2,
                                 backend=backend), dev, Xw, yw)
    _zero_counts()
    svm, res, secs = _fit(cfg, dev, Xtr, ytr)
    counts = _counts()
    mem = torch.cuda.max_memory_allocated()
    acc = svm.score(Xte, yte)
    steps = min(cfg.max_iters, -(-res.n_iters // cfg.scan_chunk)
                * cfg.scan_chunk)
    say(f"  kernels fit: {secs:.3f} s, {res.n_iters} iterations "
        f"({steps} steps run, {secs / steps * 1e3:.2f} ms a step), converged "
        f"{res.converged}, {res.n_host_syncs} host syncs, held-out accuracy "
        f"{acc:.4f}, peak device memory {mem / 2**20:.0f} MiB, "
        f"launches {counts}")
    plain, rp, psecs = _fit(dataclasses.replace(cfg, backend="ref"), dev,
                            Xtr, ytr)
    pacc = plain.score(Xte, yte)
    say(f"  plain fit: {psecs:.3f} s, {rp.n_iters} iterations "
        f"({psecs / steps * 1e3:.2f} ms a step), converged "
        f"{rp.converged}, held-out accuracy {pacc:.4f}")
    chunk = cfg.scan_chunk
    L = counts["fused_stats"]
    check(res.converged and rp.converged, "a fit did not converge")
    check(res.n_iters <= L <= -(-res.n_iters // chunk) * chunk,
          f"fused_stats launched {L} times for {res.n_iters} iterations")
    check(all(v == 0 for name, v in counts.items() if name != "fused_stats"),
          f"the EM K <= 1536 path launched another kernel: {counts}")
    check(_counts() == counts, "the plain fit launched a kernel")
    check(res.n_host_syncs <= math.ceil(cfg.max_iters / chunk),
          "scan driver synced more than once per chunk")
    check(abs(res.n_iters - rp.n_iters) <= 3, "iteration counts differ by "
          f"more than 3: {res.n_iters} vs {rp.n_iters}")
    o, op = np.asarray(res.objective), np.asarray(rp.objective)
    j = min(len(o), len(op))
    orel = float(np.max(np.abs(o[:j] - op[:j]) / np.abs(op[:j])))
    w, wp = res.weights.astype(np.float64), rp.weights.astype(np.float64)
    wrel = float(np.linalg.norm(w - wp) / np.linalg.norm(wp))
    say(f"  bands: objective rel {orel:.3e} (<= 2e-2), weights rel "
        f"{wrel:.3e} (<= 5e-2), accuracy diff {abs(acc - pacc):.4f} "
        f"(<= 0.01)")
    check(orel <= 2e-2 and wrel <= 5e-2 and abs(acc - pacc) <= 0.01,
          "kernel fit outside the bands of the plain fit")
    check(bool(np.all(np.isfinite(w))), "non-finite weights")
    return res.n_iters, steps, counts


def phase_wide(dev, n=131_072, k=2047, iters=5):
    from repro_torch.core import SVMConfig, lam_from_C
    from repro_torch.data import make_alpha_like
    X, y = make_alpha_like(n=n, k=k, seed=0)
    cfg = SVMConfig.from_options("LIN-EM-CLS", lam=lam_from_C(1.0),
                                 max_iters=iters, min_iters=iters)
    _zero_counts()
    svm, res, secs = _fit(cfg, dev, X, y)
    counts = _counts()
    say(f"  K={k + 1} fit: {secs:.3f} s for {res.n_iters} iterations, "
        f"objective {res.objective[-1]:.1f}, train accuracy "
        f"{svm.score(X, y):.4f}, launches {counts}")
    check(counts["fused_estep"] > 0 and counts["syrk_tri"] > 0,
          "the K > 1536 path did not launch fused_estep and syrk_tri")
    check(all(v == 0 for name, v in counts.items() if "fused_stats" in name),
          "the K > 1536 path launched fused_stats")
    check(bool(np.all(np.isfinite(res.weights)))
          and bool(np.all(np.isfinite(res.objective))), "non-finite fit")
    return res.n_iters, res.n_iters, counts


def _report(label, svm, res, secs, cfg, Xte, yte, counts=None):
    """Print one fit's line; returns (held-out accuracy, steps run)."""
    acc = svm.score(Xte, yte)
    steps = min(cfg.max_iters, -(-res.n_iters // cfg.scan_chunk)
                * cfg.scan_chunk)
    say(f"  {label}: {secs:.3f} s, {res.n_iters} iterations ({steps} "
        f"steps run, {secs / steps * 1e3:.2f} ms a step), converged "
        f"{res.converged}, {res.n_host_syncs} host syncs, held-out accuracy "
        f"{acc:.4f}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB"
        + ("" if counts is None else f", launches {counts}"))
    check(bool(np.all(np.isfinite(res.weights))), f"{label}: non-finite "
          "weights")
    check(res.n_host_syncs <= math.ceil(cfg.max_iters / cfg.scan_chunk),
          f"{label}: scan driver synced more than once per chunk")
    return acc, steps


def _mc_fit(label, cfg, dev, data, launched=None):
    """One MC fit with the launch counts zeroed just before and read just
    after; ``launched`` names the variant that must run once a step."""
    Xtr, ytr, Xte, yte = data
    _zero_counts()
    svm, res, secs = _fit(cfg, dev, Xtr, ytr)
    counts = _counts()
    acc, steps = _report(label, svm, res, secs, cfg, Xte, yte, counts)
    if launched is None:
        check(all(v == 0 for v in counts.values()),
              f"{label}: the plain fit launched a kernel: {counts}")
    else:
        check(counts[launched] == steps, f"{label}: {launched} launched "
              f"{counts[launched]} times for {steps} steps run")
        check(all(v == 0 for name, v in counts.items() if name != launched),
              f"{label}: launched other kernels: {counts}")
    return res, acc, steps, counts


def profile_fit(label, cfg, dev, data, top=8):
    """One fit under torch.profiler: the device time by kernel name (top
    ``top``), the device's busy share of the fit's wall time, and the
    set-up (a one-step fit: bias column, padding, copy, one step)."""
    from torch.profiler import ProfilerActivity, profile
    Xtr, ytr = data[:2]
    one = dataclasses.replace(cfg, max_iters=1, min_iters=1)
    _, _, setup = _fit(one, dev, Xtr, ytr)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, res, secs = _fit(cfg, dev, Xtr, ytr)
    rows = [(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3, e.count,
             e.key) for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    steps = min(cfg.max_iters, -(-res.n_iters // cfg.scan_chunk)
                * cfg.scan_chunk)
    say(f"  profile of {label}: {secs * 1e3:.1f} ms wall for {steps} steps "
        f"(one-step fit, the set-up: {setup * 1e3:.1f} ms), device busy "
        f"{busy:.1f} ms ({busy / (secs * 1e3):.3f} of the wall time) in "
        f"{sum(r[1] for r in rows)} device activities; by self device "
        f"time:")
    for ms, count, name in rows[:top]:
        say(f"    {ms:9.3f} ms {count:6d}x  {name[:90]}")


def phase_mc(dev, n=300_000, n_train=250_000, k=500):
    from repro_torch.core import SVMConfig, lam_from_C
    from repro_torch.data import make_alpha_like
    X, y = make_alpha_like(n=n, k=k, seed=0)
    data = (X[:n_train], y[:n_train], X[n_train:], y[n_train:])
    cfg = SVMConfig.from_options("LIN-MC-CLS", lam=lam_from_C(1.0),
                                 max_iters=100, rng="fused")
    Xw, yw = make_alpha_like(n=4096, k=k, seed=1)
    for backend in (None, "ref"):  # warm-up: cuBLAS/cuSOLVER set-up
        _fit(dataclasses.replace(cfg, max_iters=2, min_iters=2,
                                 backend=backend), dev, Xw, yw)
    rk, acc_k, st_k, c_k = _mc_fit(
        "kernels fit, rng='fused'", cfg, dev, data,
        "fused_stats[mc_hinge,seed]")
    plain = dataclasses.replace(cfg, backend="ref")
    rp, acc_p, _, _ = _mc_fit("plain fit, rng='fused', seed 0", plain, dev,
                              data)
    rp1, acc_p1, _, _ = _mc_fit("plain fit, rng='fused', seed 1",
                                dataclasses.replace(plain, seed=1), dev,
                                data)
    rh, acc_h, st_h, c_h = _mc_fit(
        "kernels fit, rng='host'", dataclasses.replace(cfg, rng="host"),
        dev, data, "fused_stats[mc_hinge,noise]")
    rc, acc_c, st_c, c_c = _mc_fit(
        "kernels fit, rng='fused', n_chains=4",
        dataclasses.replace(cfg, n_chains=4), dev, data,
        "fused_stats[mc_hinge,seed,C=4]")

    profile_fit("the rng='fused' kernels fit", cfg, dev, data)

    def rel(a, b):
        a, b = a.astype(np.float64), b.astype(np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    spread = rel(rp1.weights, rp.weights)
    wrel = rel(rk.weights, rp.weights)
    say(f"  bands: kernel vs plain weights rel {wrel:.4e} (<= 3 x the seed "
        f"0 vs 1 spread of the plain path, {spread:.4e}); accuracy "
        f"kernel {acc_k:.4f} plain {acc_p:.4f} host {acc_h:.4f} 4 chains "
        f"{acc_c:.4f} (each within 0.01 of the kernel fit's); chain std "
        f"mean {float(np.mean(rc.chain_std)):.4e}")
    check(rk.converged and rp.converged, "an rng='fused' fit did not "
          "converge")
    check(abs(acc_k - acc_p) <= 0.01, "kernel and plain accuracy differ by "
          "more than 0.01")
    check(wrel <= 3 * spread, "kernel fit outside 3x the seed spread")
    check(abs(acc_h - acc_k) <= 0.01 and abs(acc_c - acc_k) <= 0.01,
          "rng='host' or n_chains=4 accuracy outside 0.01")
    check(rc.chain_weights.shape == (4, k + 1)
          and bool(np.all(np.isfinite(rc.chain_std))),
          "n_chains=4: bad chain_weights or chain_std")
    return {"fused_stats[mc_hinge,seed]": (c_k, rk.n_iters, st_k),
            "fused_stats[mc_hinge,noise]": (c_h, rh.n_iters, st_h),
            "fused_stats[mc_hinge,seed,C=4]": (c_c, rc.n_iters, st_c)}


SOURCES = {
    "fused_stats": ("src/repro_torch/csrc/fused_stats.cu",
                    "src/repro/kernels/fused_stats.py:155"),
    "fused_stats[mc_hinge,noise]": ("src/repro_torch/csrc/fused_stats.cu",
                                    "src/repro/kernels/fused_stats.py:155"),
    "fused_stats[mc_hinge,seed]": ("src/repro_torch/csrc/fused_stats.cu",
                                   "src/repro/kernels/fused_stats.py:155"),
    "fused_stats[mc_hinge,seed,C=4]": ("src/repro_torch/csrc/fused_stats.cu",
                                       "src/repro/kernels/fused_stats.py:155"),
    "fused_estep": ("src/repro_torch/csrc/fused_estep.cu",
                    "src/repro/kernels/fused_estep.py:58"),
    "syrk_tri": ("src/repro_torch/csrc/syrk.cu",
                 "src/repro/kernels/syrk.py:79"),
}


def main() -> int:
    global torch
    import torch as _torch
    torch = _torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    say("== 1. device")
    phase_device()
    say("== 2. build")
    phase_build()
    say("== 3. kernels vs plain (float64 evaluation of the plain version)")
    rows = phase_kernels(dev)
    say("== 4. main path, K <= 1536: LIN-EM-CLS on alpha-like 250,000 x 501")
    it4, st4, c4 = phase_main_path(dev)
    say("== 5. main path, K > 1536: LIN-EM-CLS at K = 2,048")
    it5, st5, c5 = phase_wide(dev)
    say("== 6. main path, LIN-MC-CLS on alpha-like 250,000 x 501")
    runs = phase_mc(dev)
    runs["fused_stats"] = (c4, it4, st4)
    for name in ("fused_estep", "syrk_tri"):
        runs[name] = (c5, it5, st5)
    say(f"== done in {time.perf_counter() - t0:.1f} s")
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        counts, iters, steps = runs[name]
        launches = counts[name]
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=launches,
                            iterations=iters, steps=steps, **rows[name]))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
