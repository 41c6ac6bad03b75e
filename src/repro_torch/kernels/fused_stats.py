"""The whole iteration statistic on Hopper, in one pass over X:
margin = Xw; gamma from the epilogue; b = X^T (rho/gamma + beta);
Sigma = X^T diag(wmask / gamma) X.

Replaces the TPU kernel ``repro/kernels/fused_stats.py::fused_stats``
(body ``_make_kernel``) at full width for the hinge epilogues:

  * em_hinge: gamma = max(eps, |rho - margin|);
  * mc_hinge with noise operands: the Gibbs draw from two pre-drawn (N,)
    vectors (nu, u) (rng modes 'host' and 'fused_predraw');
  * mc_hinge with a seed: (nu, u) derived in-body from the counter cipher
    at (global row, chain) (rng mode 'fused');
  * multichain: a (K, C) wvec with the seed runs C chains, giving margin
    and gamma (N, C), b (K, C) and Sigma (C, K, K).

The SVR epilogues and the column window are still to port (ROADMAP
queue 2).

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
order, so every CTA gets the same bits); then lane k of each warp runs the
epilogue of the warp's k-th row, and the weight and coef go to shared
memory. The recomputation is bn*K FMAs next to the tile's bn*128*128, ~3 %
at K = 501. It reads the full rows again, once per tile: the T tiles of a
split are adjacent in the grid, so they run together and those reads hit
L2 rather than HBM. The tile-0 CTAs write margin and gamma; the
diagonal-tile CTAs of column block i accumulate b[i-block] from their
unweighted staged columns. Partials are summed in split order by two small
launches (Sigma with the mirror, and b): deterministic, no atomics.

The Gibbs noise (``csrc/rng.cuh``) is a pure function of (key words,
global row, chain), so every CTA that recomputes a row's gamma derives
the same draw, and the draw does not depend on the grid. The epilogue
(``csrc/epilogues.cuh``) rounds each operation as PyTorch's eager ops do.

Multichain is a chain grid dimension, fastest-varying: CTA (split, tile,
c) reads chain c's weights and noise plane and writes Sigma_c's partial.
X rows are read once per chain, from L2 for all but the first of the C
adjacent CTAs; the tile work scales with C (no chain is free here).
"""
from __future__ import annotations

import torch

from . import _build, ref

# Launches per variant, for chip_smoke.py's check that the main path ran
# through the kernel it names. Each launch adds one to exactly one entry.
LAUNCHES = {"em_hinge": 0, "mc_hinge,noise": 0, "mc_hinge,seed": 0,
            "mc_hinge,seed,multichain": 0}
_EPILOGUE_CODE = {"em_hinge": 0, "mc_hinge,noise": 1, "mc_hinge,seed": 2,
                  "mc_hinge,seed,multichain": 2}


def variant(epilogue: str, noise, seed, wvec: torch.Tensor) -> str:
    """The LAUNCHES key of a call, after validating the combination."""
    if epilogue == "em_hinge":
        if noise is not None or seed is not None or wvec.dim() != 1:
            raise ValueError("em_hinge takes no noise, no seed and a 1-D "
                             "wvec")
        return "em_hinge"
    if epilogue != "mc_hinge":
        raise NotImplementedError(
            f"epilogue {epilogue!r} has no CUDA kernel yet: ROADMAP "
            "queue 1 item 6 (SVR)")
    if (noise is None) == (seed is None):
        raise ValueError("mc_hinge takes exactly one of noise= (nu, u) "
                         "and seed=")
    if wvec.dim() == 2:
        if seed is None:
            raise ValueError("multichain fused_stats requires seed")
        return "mc_hinge,seed,multichain"
    return "mc_hinge,noise" if seed is None else "mc_hinge,seed"


def zero_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fused_stats(X: torch.Tensor, rho: torch.Tensor, beta: torch.Tensor,
                wvec: torch.Tensor, wmask: torch.Tensor | None = None,
                noise: tuple | None = None, seed: torch.Tensor | None = None,
                *, epilogue: str = "em_hinge", eps: float = 1e-6):
    """(margin, gamma, b, Sigma), float32. X (N, K) float32 or bfloat16;
    rho, beta, wmask (N,) float32, ``wmask=None`` weighs every row 1;
    wvec (K,) or (K, C) float32; ``noise`` two (N,) float32 vectors;
    ``seed`` (4,) int64 words on X's device. For C chains margin and
    gamma are (N, C), b (K, C) and Sigma (C, K, K). A CPU tensor runs the
    plain version."""
    if X.device.type == "cpu":
        return ref.fused_stats(X, rho, beta, wvec, wmask, eps, epilogue,
                               noise=noise, seed=seed)
    var = variant(epilogue, noise, seed, wvec)
    N, K = _build.check_x(X)
    for name, v, n in (("rho", rho, N), ("beta", beta, N)):
        _build.check_vec(name, v, n, X)
    if wmask is not None:
        _build.check_vec("wmask", wmask, N, X)
    nu = u = None
    if noise is not None:
        nu, u = noise
        _build.check_vec("nu", nu, N, X)
        _build.check_vec("u", u, N, X)
    if seed is not None:
        if (seed.device != X.device or seed.dtype != torch.int64
                or tuple(seed.shape) != (4,) or not seed.is_contiguous()):
            raise ValueError("seed must be a contiguous (4,) int64 tensor "
                             f"on {X.device}")
    multi = wvec.dim() == 2
    C = wvec.shape[1] if multi else 1
    if multi:
        if (wvec.device != X.device or wvec.dtype != torch.float32
                or wvec.shape[0] != K):
            raise ValueError(f"wvec must be a float32 ({K}, C) matrix on "
                             f"{X.device}")
        wt = wvec.t().contiguous()
    else:
        _build.check_vec("wvec", wvec, K, X)
        wt = wvec
    ntiles, nsplits, rows = _build.tile_plan(N, K, X.device)
    Kp = -(-K // _build.BK) * _build.BK
    f32 = dict(dtype=torch.float32, device=X.device)
    per_row = (N, C) if multi else (N,)
    margin, gamma = torch.empty(per_row, **f32), torch.empty(per_row, **f32)
    part = torch.empty(nsplits * ntiles * C * _build.BK * _build.BK, **f32)
    bpart = torch.empty(nsplits * C * Kp, **f32)
    sigma, b = torch.empty((C, K, K), **f32), torch.empty((C, K), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.launch("rt_fused_stats", X.device, X.data_ptr(),
                  int(X.dtype == torch.bfloat16), rho.data_ptr(),
                  beta.data_ptr(), ptr(wmask), wt.data_ptr(), ptr(nu),
                  ptr(u), ptr(seed), margin.data_ptr(), gamma.data_ptr(),
                  part.data_ptr(), bpart.data_ptr(), sigma.data_ptr(),
                  b.data_ptr(), N, K, Kp, ntiles, nsplits, rows, C,
                  _EPILOGUE_CODE[var], float(eps))
    LAUNCHES[var] += 1
    if multi:
        return margin, gamma, b.t(), sigma
    return margin, gamma, b[0], sigma[0]
