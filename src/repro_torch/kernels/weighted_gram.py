"""Dense weighted Gram on Hopper: S = X^T diag(w) X over every tile.

Replaces the TPU kernel ``repro/kernels/weighted_gram.py::weighted_gram``
(its ``pallas_call`` walks the full (K/bk)^2 output block grid, the N
sweep innermost, each output block accumulated in VMEM). It is the dense
baseline of the paper's Table 9 statistic (``benchmarks/table9_gram.py``)
and is public as ``ops.weighted_gram``; no solver calls it, in the port as
in the reference: the solvers take ``syrk_tri`` or the fused statistic.

What bounds it on the H100: fp32 FMAs. The function needs N K (K + 1)
flop (one triangle) on 4 N K bytes; the dense grid performs 2 N K^2, so
by design it can reach at most about half of the function's bound. That
is what Table 9 compares, so the kernel keeps the dense grid and never
calls ``syrk_tri`` to mirror a triangle.

Design (``csrc/weighted_gram.cu`` on the engine of ``csrc/gram_pipe.cuh``,
shared with ``syrk_tri``): a CTA of 256 threads owns one 128 x 128 tile
(i, j) of S for one row split, keeps it in registers (8 x 8 a thread)
while 32-row stages of its two column blocks stream through a cp.async
ring in shared memory (the i-block scaled by w as it arrives), and writes
a per-split partial. A second launch sums the partials in split order:
bitwise repeatable, no atomics. The splits (``_build.gram_plan``) hold at
most ROWS_PER_SPLIT rows and are sized so the last wave of CTAs is not
nearly empty; the plain ``ref.weighted_gram`` sums splits of exactly
ROWS_PER_SPLIT rows, so the two agree to rounding, not bit for bit. The
(i, j) and (j, i) tiles round differently, as the TPU kernel's blocks
do, so S is symmetric only to rounding.
"""
from __future__ import annotations

import torch

from . import _build, ref

LAUNCHES = 0


def weighted_gram(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """S = X^T diag(w) X, (K, K) float32, every tile computed. X (N, K)
    float32 or bfloat16, w (N,) float32. A CPU tensor runs the plain
    version."""
    global LAUNCHES
    if X.device.type == "cpu":
        return ref.weighted_gram(X, w)
    N, K = _build.check_x(X)
    _build.check_vec("w", w, N, X)
    nb = -(-K // _build.BK)
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    nsplits, rows = _build.gram_plan(N, nb * nb, sms)
    part = torch.empty(nsplits * nb * nb * _build.BK * _build.BK,
                       dtype=torch.float32, device=X.device)
    out = torch.empty((K, K), dtype=torch.float32, device=X.device)
    _build.launch("rt_weighted_gram", X.device, X.data_ptr(),
                  _build.gram_copy(X), w.data_ptr(), part.data_ptr(),
                  out.data_ptr(), N, K, nsplits, rows)
    LAUNCHES += 1
    return out
