"""DCD's whole sweep as one CUDA launch: every coordinate of every epoch
of the L1-loss dual coordinate descent baseline (``baselines/dcd.py``).

Replaces no Pallas kernel: the reference runs the sweep as one jitted
``lax.scan`` (``repro/baselines/dcd.py``, ``DCDSVM.fit``). Launched a
coordinate at a time from Python, the port would pay about six launches
a coordinate: 45 M launches for Table 5's 2.5 M rows x 3 epochs.

What bounds it on the H100: the chain of dependent coordinates, each a
block-wide dot product, one thread's clipped update and an axpy, with two
barriers between them (``csrc/dcd.cu``). Its bytes bound, each row read
once an epoch over 3.35 TB/s, is far below what the chain's latency
allows; ``chip_smoke.py`` prints both.

Design: one CTA, w in shared memory (up to ``SMEM_W_FLOATS`` columns;
past that the same kernel keeps w in global memory through a template
flag), alpha and q_ii in global memory, the permutation copied to the
device once; ``threads`` from K, about four columns a thread.
"""
from __future__ import annotations

import torch

from . import _build, ref

LAUNCHES = 0
# The largest K whose w the kernel keeps in shared memory (csrc/dcd.cu's
# SMEM_W_FLOATS: 224 KiB of the 227 KiB a CTA may use).
SMEM_W_FLOATS = 56 * 1024


def threads_for(K: int) -> int:
    """Threads of the sweep's CTA: about four columns a thread, a whole
    number of warps, from 32 to 1,024."""
    return min(1024, max(32, ((K + 3) // 4 + 31) // 32 * 32))


def dcd_sweep(X: torch.Tensor, y: torch.Tensor, qdiag: torch.Tensor,
              order: torch.Tensor, C: float):
    """(w (K,), alpha (N,)) of the dual coordinate descent over the rows
    ``order`` names (int32, every epoch's permutation in turn), from
    w = 0 and alpha = 0. X (N, K) float32, y and qdiag (N,) float32. A
    CPU tensor runs the plain version."""
    global LAUNCHES
    if X.device.type == "cpu":
        return ref.dcd_sweep(X, y, qdiag, order, C)
    N, K = _build.check_x(X)
    if X.dtype != torch.float32:
        raise TypeError(f"dcd_sweep takes float32 X, got {X.dtype}")
    _build.check_vec("y", y, N, X)
    _build.check_vec("qdiag", qdiag, N, X)
    if order.device != X.device or order.dtype != torch.int32 \
            or order.dim() != 1 or not order.is_contiguous():
        raise ValueError("order must be a contiguous int32 vector on X's "
                         "device")
    w = torch.empty(K, dtype=torch.float32, device=X.device)
    alpha = torch.zeros(N, dtype=torch.float32, device=X.device)
    _build.launch("rt_dcd_sweep", X.device, X.data_ptr(), y.data_ptr(),
                  qdiag.data_ptr(), order.data_ptr(), order.numel(),
                  float(C), K, w.data_ptr(), alpha.data_ptr(),
                  threads_for(K))
    LAUNCHES += 1
    return w, alpha
