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
   the bound max(flop / 67 TFLOP/s, bytes / 3.35 TB/s);
4. main path, K <= 1536: LIN-EM-CLS fit on make_alpha_like(300,000 x 500)
   (250,000 training rows, 50,000 held out) through the kernels and
   through the plain path, both on the card, held to the bands of
   tests/test_torch_em_cls.py; fused_stats must have launched once per
   iteration run;
5. main path, K > 1536: 5 iterations at K = 2,048 through fused_estep
   and syrk_tri, and not through fused_stats.

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
    return {"fused_stats": fused_stats.LAUNCHES,
            "fused_estep": fused_estep.LAUNCHES,
            "syrk_tri": syrk.LAUNCHES}


def _zero_counts():
    from repro_torch.kernels import fused_estep, fused_stats, syrk
    fused_stats.LAUNCHES = fused_estep.LAUNCHES = syrk.LAUNCHES = 0


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
    check(counts["fused_estep"] == counts["syrk_tri"] == 0,
          "the K <= 1536 path launched the split kernels")
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
    check(counts["fused_stats"] == 0, "the K > 1536 path launched "
          "fused_stats")
    check(bool(np.all(np.isfinite(res.weights)))
          and bool(np.all(np.isfinite(res.objective))), "non-finite fit")
    return res.n_iters, res.n_iters, counts


SOURCES = {
    "fused_stats": ("src/repro_torch/csrc/fused_stats.cu",
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
    say(f"== done in {time.perf_counter() - t0:.1f} s")
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        launches, iters, steps = ((c4[name], it4, st4)
                                  if name == "fused_stats"
                                  else (c5[name], it5, st5))
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
