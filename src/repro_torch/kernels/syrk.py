"""Triangle-tiled weighted SYRK on Hopper: S = X^T diag(w) X.

Replaces the TPU kernel ``repro/kernels/syrk.py::syrk_tri`` (its
``pallas_call`` walks the lower-triangle (bk x bk) block pairs from a
scalar-prefetched table, with the N sweep innermost so the output block
stays in VMEM).

What bounds it on the H100: fp32 FMAs. Counting only the triangle it
needs, it does N*K*(K+1) flop on 4*N*K bytes of X, about (K+1)/4 flop per
byte, far above the fp32 ridge of ~20 flop per byte (67 TFLOP/s over
3.35 TB/s). It must stay fp32 on the CUDA cores: TF32 cuts the mantissa
the way the bf16 reduction did that collapsed the posterior (DESIGN.md
§6.2).

Design (``csrc/syrk.cu`` on the engine of ``csrc/gram_pipe.cuh``, shared
with ``weighted_gram``): a TPU grid runs in order and carries the block
sum across N steps; Hopper's CTAs run in parallel in no order. So the N
sweep is split into row ranges of at most 4096 rows (``tile_plan``), and
the grid is (row split) x (lower-triangle 128 x 128 tile). Each CTA of
256 threads keeps its tile in registers (8 x 8 a thread) while 32-row
stages of its two column blocks stream through a three-slot cp.async ring
in shared memory, two stages ahead of the FMAs; the arrived stage's
i-block is scaled by w in place, and a diagonal tile copies its one block
once. Each element is one FMA chain of the once-rounded x w over the
split's rows, or on a split of more than 1,024 rows over each block of
256 rows, the blocks joining a running sum at the tile's per-split
partial in row order (a single chain over a 3,072-row split was 3.6x
less accurate than cuBLAS, enough to make P indefinite at the hinge
weights of a max-margin head: ``chip_head_numerics.py``). ``tri_finalize``
(csrc/common.cuh) sums the partials in split order and mirrors the upper
triangle: deterministic, no atomics, the bits depending only on the split
plan.
Computing only the lower tiles halves the flops of the dense product.
"""
from __future__ import annotations

import torch

from . import _build, ref

LAUNCHES = 0


def syrk_tri(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """S = X^T diag(w) X, (K, K) float32. X (N, K) float32 or bfloat16,
    w (N,) float32. A CPU tensor runs the plain version."""
    global LAUNCHES
    if X.device.type == "cpu":
        return ref.syrk_tri(X, w)
    N, K = _build.check_x(X)
    _build.check_vec("w", w, N, X)
    ntiles, nsplits, rows = _build.tile_plan(N, K, X.device)
    part = torch.empty(nsplits * ntiles * _build.BK * _build.BK,
                       dtype=torch.float32, device=X.device)
    out = torch.empty((K, K), dtype=torch.float32, device=X.device)
    _build.launch("rt_syrk_tri", X.device, X.data_ptr(),
                  _build.gram_copy(X), w.data_ptr(), part.data_ptr(),
                  out.data_ptr(), N, K, ntiles, nsplits, rows)
    LAUNCHES += 1
    return out
