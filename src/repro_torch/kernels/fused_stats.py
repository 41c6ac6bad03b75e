"""The whole EM iteration statistic on Hopper, in one pass over X:
margin = Xw; gamma = max(eps, |rho - margin|); b = X^T (rho/gamma + beta);
Sigma = X^T diag(wmask / gamma) X  (the em_hinge epilogue).

Replaces the TPU kernel ``repro/kernels/fused_stats.py::fused_stats``
(body ``_make_kernel``) for em_hinge at full width. The other epilogues,
the column window, the in-kernel RNG and multichain are still to port
(ROADMAP queue 2).

What bounds it on the H100: fp32 FMAs, not bytes. Sigma's lower triangle
is N*K*(K+1) flop on 4*N*K bytes of X, (K+1)/4 flop per byte (~125 at
K = 501), far above the fp32 ridge of ~20. The TPU's argument that X
streams count as iteration time does not carry over; the single pass is
kept because it is right and cheap. Accumulation stays fp32 without TF32.

Design (``csrc/fused_stats.cu``, tile code shared with ``syrk_tri`` in
``csrc/common.cuh``): the TPU kernel keeps the whole (K, K) Sigma in VMEM
for the N sweep (9.4 MB at K = 1536); a Hopper CTA has 227 KB of shared
memory. So Sigma is tiled across CTAs with syrk's grid, (row split) x
(lower-triangle 128 x 128 tile), and only the lower tiles are computed.

How the CTAs share the margin and gamma of a row block: they do not
exchange them; each CTA recomputes them. Before staging 32 rows, the 8
warps of a CTA compute those rows' margins (a warp a row, fixed summation
order, so every CTA gets the same bits) and the epilogue, and keep the
weight and coef in shared memory. The recomputation is bn*K FMAs next to
the tile's bn*128*128, ~3 % at K = 501. It reads the full rows again,
once per tile: the T tiles of a split are adjacent in the grid, so they
run together and those reads hit L2 rather than HBM. The tile-0 CTAs
write margin and gamma; the diagonal-tile CTAs of column block i
accumulate b[i-block] from their unweighted staged columns. Partials are
summed in split order by two small launches (Sigma with the mirror, and
b): deterministic, no atomics.
"""
from __future__ import annotations

import torch

from . import _build, ref

LAUNCHES = 0


def fused_stats(X: torch.Tensor, rho: torch.Tensor, beta: torch.Tensor,
                wvec: torch.Tensor, wmask: torch.Tensor | None = None, *,
                eps: float = 1e-6):
    """(margin (N,), gamma (N,), b (K,), Sigma (K, K)), float32. X (N, K)
    float32 or bfloat16; rho, beta, wmask (N,) and wvec (K,) float32;
    ``wmask=None`` weighs every row 1. A CPU tensor runs the plain
    version."""
    global LAUNCHES
    if X.device.type == "cpu":
        return ref.fused_stats(X, rho, beta, wvec, wmask, eps)
    N, K = _build.check_x(X)
    for name, v, n in (("rho", rho, N), ("beta", beta, N), ("wvec", wvec, K)):
        _build.check_vec(name, v, n, X)
    if wmask is not None:
        _build.check_vec("wmask", wmask, N, X)
    ntiles, nsplits, rows = _build.tile_plan(N, K, X.device)
    Kp = -(-K // _build.BK) * _build.BK
    f32 = dict(dtype=torch.float32, device=X.device)
    margin, gamma = torch.empty(N, **f32), torch.empty(N, **f32)
    part = torch.empty(nsplits * ntiles * _build.BK * _build.BK, **f32)
    bpart = torch.empty(nsplits * Kp, **f32)
    sigma, b = torch.empty((K, K), **f32), torch.empty(K, **f32)
    mask_ptr = None if wmask is None else wmask.data_ptr()
    _build.launch("rt_fused_stats", X.device, X.data_ptr(),
                  int(X.dtype == torch.bfloat16), rho.data_ptr(),
                  beta.data_ptr(), mask_ptr, wvec.data_ptr(),
                  margin.data_ptr(), gamma.data_ptr(), part.data_ptr(),
                  bpart.data_ptr(), sigma.data_ptr(), b.data_ptr(), N, K,
                  Kp, ntiles, nsplits, rows, float(eps))
    LAUNCHES += 1
    return margin, gamma, b, sigma
