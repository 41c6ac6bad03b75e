"""Fused E-step on Hopper: margin = Xw, gamma = max(eps, |rho - margin|),
b = X^T (rho/gamma + beta), reading X once.

Replaces the TPU kernel ``repro/kernels/fused_estep.py::fused_estep`` (a
1-D grid over row blocks that accumulates b in a revisited output block).
It is the E-step of the K > FUSED_STATS_MAX_K route in ``ops``.

What bounds it on the H100: bytes. It does 4*N*K flop on 4*N*K bytes of X
(1 flop per byte), so the floor is reading X once at 3.35 TB/s.

Design (``csrc/fused_estep.cu``): CTAs cannot carry b from one grid step
to the next as the TPU grid does, so each warp owns a contiguous row
range (``estep_plan``: CTAS_PER_SM CTAs of WARPS warps on each SM, one
wave). The warp loads a row into registers, four consecutive columns a
lane at a time: one 16-byte (bfloat16: 8-byte) load where K % 4 == 0 and
X is aligned for it (``estep_vec16``), else four element loads, which
still read each 512-byte span of the row once a warp (phase 8's K =
2,049). It forms the row's margin and the em_hinge epilogue there, and
adds coef * row to b partials that stay in the lanes' registers, from the
same values: X is read once, with a row of every warp in flight, and no
barrier falls inside the row loop. A lane holds VALUES values, so rows
up to SEG = 32 VALUES columns stay in registers (phase 5's K = 2,048 and
phase 8's 2,049); wider rows go in SEG-wide column segments, the margins
first and then each segment's b from a second read. Each CTA adds its warps' partials in warp order and
writes one partial; a second launch sums those in CTA order. No atomics:
b is bitwise repeatable.
"""
from __future__ import annotations

import torch

from . import _build, ref

LAUNCHES = 0
WARPS = 4                # warps a CTA (csrc/fused_estep.cu ESTEP_THREADS)
VALUES = 68              # values of a row a lane holds (ESTEP_VALUES)
SEG = 32 * VALUES        # columns a segment held in registers
CTAS_PER_SM = 3          # the kernel's __launch_bounds__ minimum


def estep_vec16(X: torch.Tensor) -> bool:
    """Whether a lane's four columns are one load: K % 4 == 0 and X
    aligned to four elements (16 bytes of float32, 8 of bfloat16)."""
    return (X.shape[1] % 4 == 0
            and X.data_ptr() % (4 * X.element_size()) == 0)


def estep_plan(N: int, K: int, sms: int) -> dict:
    """The launch plan on ``sms`` SMs: ``ctas`` (one wave of CTAS_PER_SM
    an SM, fewer where N has fewer rows than warps), ``rows_per_warp``
    (consecutive rows, every CTA holding some), ``segments`` (column
    segments of SEG; 1: the row stays in registers and X is read once,
    else twice) and ``partial_words`` (the (ctas, K) b partials)."""
    ctas = max(1, min(CTAS_PER_SM * sms, -(-N // WARPS)))
    rows = -(-N // (ctas * WARPS))
    ctas = -(-N // (rows * WARPS))
    return dict(ctas=ctas, rows_per_warp=rows, segments=-(-K // SEG),
                partial_words=ctas * K)


def fused_estep(X: torch.Tensor, rho: torch.Tensor, beta: torch.Tensor,
                wvec: torch.Tensor, *, eps: float = 1e-6):
    """(margin (N,), gamma (N,), b (K,)), float32. X (N, K) float32 or
    bfloat16; rho, beta (N,), wvec (K,) float32. A CPU tensor runs the
    plain version."""
    global LAUNCHES
    if X.device.type == "cpu":
        return ref.fused_estep(X, rho, beta, wvec, eps)
    N, K = _build.check_x(X)
    for name, v, n in (("rho", rho, N), ("beta", beta, N), ("wvec", wvec, K)):
        _build.check_vec(name, v, n, X)
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    plan = estep_plan(N, K, sms)
    f32 = dict(dtype=torch.float32, device=X.device)
    margin, gamma = torch.empty(N, **f32), torch.empty(N, **f32)
    bpart = torch.empty(plan["partial_words"], **f32)
    b = torch.empty(K, **f32)
    _build.launch("rt_fused_estep", X.device, X.data_ptr(),
                  int(X.dtype == torch.bfloat16), int(estep_vec16(X)),
                  rho.data_ptr(),
                  beta.data_ptr(), wvec.data_ptr(), margin.data_ptr(),
                  gamma.data_ptr(), bpart.data_ptr(), b.data_ptr(), N, K,
                  plan["ctas"], plan["rows_per_warp"], float(eps))
    LAUNCHES += 1
    return margin, gamma, b
