"""Fused E-step on Hopper: margin = Xw, gamma = max(eps, |rho - margin|),
b = X^T (rho/gamma + beta), in one pass over X.

Replaces the TPU kernel ``repro/kernels/fused_estep.py::fused_estep`` (a
1-D grid over row blocks that accumulates b in a revisited output block).
It is the E-step of the K > FUSED_STATS_MAX_K route in ``ops``.

What bounds it on the H100: bytes. It does 4*N*K flop on 4*N*K bytes of
X (1 flop per byte), so the floor is reading X once at 3.35 TB/s.

Design (``csrc/fused_estep.cu``): CTAs cannot carry b from one grid step
to the next as the TPU grid does, so each CTA owns a contiguous row range.
A warp computes one row's margin (lane-strided, coalesced reads, a
butterfly sum) and the em_hinge epilogue in registers, and writes margin
and gamma once. The CTA then adds coef * row to a (K,) accumulator in
shared memory, each thread owning fixed columns, so there are no atomics;
the second read of the row hits L1 or L2, not HBM. Each CTA writes its
accumulator as a partial, and a second launch sums the partials in CTA
order. The accumulator limits K to what shared memory holds (~58,000).
"""
from __future__ import annotations

import torch

from . import _build, ref

LAUNCHES = 0
_ROWS_PER_STEP = 8          # one row per warp of 256 threads
_MAX_SMEM = 227 * 1024


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
    if 4 * K > _MAX_SMEM:
        raise ValueError(f"fused_estep keeps a (K,) accumulator in shared "
                         f"memory; K={K} exceeds it")
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    nctas = min(-(-N // _ROWS_PER_STEP), 4 * sms)
    rows = -(-N // nctas)
    rows = -(-rows // _ROWS_PER_STEP) * _ROWS_PER_STEP
    nctas = -(-N // rows)
    f32 = dict(dtype=torch.float32, device=X.device)
    margin, gamma = torch.empty(N, **f32), torch.empty(N, **f32)
    bpart, b = torch.empty(nctas * K, **f32), torch.empty(K, **f32)
    _build.launch("rt_fused_estep", X.device, X.data_ptr(),
                  int(X.dtype == torch.bfloat16), rho.data_ptr(),
                  beta.data_ptr(), wvec.data_ptr(), margin.data_ptr(),
                  gamma.data_ptr(), bpart.data_ptr(), b.data_ptr(), N, K,
                  nctas, rows, float(eps))
    LAUNCHES += 1
    return margin, gamma, b
