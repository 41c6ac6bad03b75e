"""The whole iteration statistic on Hopper, in one pass over X:
margin = Xw; the epilogue's gamma (and omega), weight and coef;
b = X^T coef; Sigma = X^T diag(wmask * weight) X.

Replaces the TPU kernel ``repro/kernels/fused_stats.py::fused_stats``
(body ``_make_kernel``) at full width for all four epilogues:

  * em_hinge: gamma = max(eps, |rho - margin|), weight 1/gamma, coef
    rho/gamma + beta;
  * em_svr (rho = y): gamma and omega = max(eps, |y - margin -+ eps_ins|),
    weight 1/gamma + 1/omega, coef (y - eps_ins)/gamma +
    (y + eps_ins)/omega (paper Eq. 25-28);
  * mc_hinge / mc_svr with noise operands: the Gibbs draws from pre-drawn
    (N,) vectors, (nu, u) or SVR's (nu_g, u_g, nu_o, u_o) (rng modes
    'host' and 'fused_predraw');
  * mc_hinge / mc_svr with a seed: the noise derived in-body from the
    counter cipher at (global row, chain), SVR's omega on mixture 1's
    counter words (rng mode 'fused');
  * multichain: a (K, C) wvec with the seed runs C chains, giving margin,
    gamma (and omega) (N, C), b (K, C) and Sigma (C, K, K).

  * the column window (``col_window = (start, blk)``, single chain): the
    block Sigma[:, start:start + blk] of one k-shard of the 2-D (data x k)
    fit, with margin, gamma (omega) and b at full width.

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
SVR doubles the per-row epilogue (two mixtures, two Threefry pairs a
mixture in the seed variants); it runs on 4 lanes a warp between the
margin and the tile phases, so it adds registers to the tile kernel but
no tile work.

Multichain is a chain grid dimension, fastest-varying: CTA (split, tile,
c) reads chain c's weights and noise plane and writes Sigma_c's partial.
X rows are read once per chain, from L2 for all but the first of the C
adjacent CTAs; the tile work scales with C (no chain is free here).

The window: ``start = k_rank * blk`` need not be a multiple of 128 (K =
502 splits into (0, 251) and (251, 251)). Of the two ways to place such
a window, this is the 128-aligned cover: the window kernel runs the full
statistic's own lower-triangle tiles whose row or column block meets the
window's column blocks (``_build.window_tiles``, 7 and 9 of 10 at K = 502),
over the full statistic's split plan, and its finalize takes each window
column from the tile that holds it, transposed above the diagonal, in
split order. Every element is then summed exactly as the full variant sums
it: the window is bitwise the full variant's column slice, and b (summed
by one CTA a block, from its B side or, for blocks right of the window,
from the rows) bitwise the full b. Offsetting the column loads instead
would do up to a tile less work but round the elements above the diagonal
differently ((x_r w) x_c against the mirror's (x_c w) x_r), and bitwise
equality with the full variant is the check that shows the window right.
The cost is the slack of the cover: at most a tile column a side.
"""
from __future__ import annotations

import torch

from . import _build, epilogues, ref

# Launches per variant, for chip_smoke.py's check that the main path ran
# through the kernel it names. Each launch adds one to exactly one entry.
# The window variants are the single-chain keys with ",window".
_SINGLE = ("em_hinge", "mc_hinge,noise", "mc_hinge,seed", "em_svr",
           "mc_svr,noise", "mc_svr,seed")
LAUNCHES = {key: 0 for key in (
    *_SINGLE, "mc_hinge,seed,multichain", "mc_svr,seed,multichain",
    *(f"{k},window" for k in _SINGLE))}
# The launchers' epilogue codes (csrc/epilogues.cuh, enum Epilogue).
_EPILOGUE_CODE = {"em_hinge": 0, "mc_hinge,noise": 1, "mc_hinge,seed": 2,
                  "mc_hinge,seed,multichain": 2, "em_svr": 3,
                  "mc_svr,noise": 4, "mc_svr,seed": 5,
                  "mc_svr,seed,multichain": 5}
# Window tile tables on the device, by (device, K, start, blk): a fit
# calls with one window every step.
_WINDOWS: dict = {}


def variant(epilogue: str, noise, seed, wvec: torch.Tensor) -> str:
    """The LAUNCHES key of a call, after validating the combination."""
    if epilogue in ("em_hinge", "em_svr"):
        if noise is not None or seed is not None or wvec.dim() != 1:
            raise ValueError(f"{epilogue} takes no noise, no seed and a 1-D "
                             "wvec")
        return epilogue
    epilogues.check_epilogue(epilogue)
    if (noise is None) == (seed is None):
        raise ValueError(f"{epilogue} takes exactly one of noise= and seed=")
    arity = epilogues.noise_arity(epilogue)
    if noise is not None and len(noise) != arity:
        raise ValueError(f"{epilogue} takes {arity} noise operands, got "
                         f"{len(noise)}")
    if wvec.dim() == 2:
        if seed is None:
            raise ValueError("multichain fused_stats requires seed")
        return f"{epilogue},seed,multichain"
    return f"{epilogue},noise" if seed is None else f"{epilogue},seed"


def noise_operands(noise: tuple | None, seed: torch.Tensor | None, N: int,
                   X: torch.Tensor) -> list:
    """The launchers' four noise operand slots (None where unused), after
    checking the (N,) ``noise`` vectors and the (4,) int64 ``seed``."""
    ops = [None] * 4
    for i, z in enumerate(noise or ()):
        _build.check_vec(f"noise[{i}]", z, N, X)
        ops[i] = z
    if seed is not None and (seed.device != X.device
                             or seed.dtype != torch.int64
                             or tuple(seed.shape) != (4,)
                             or not seed.is_contiguous()):
        raise ValueError("seed must be a contiguous (4,) int64 tensor on "
                         f"{X.device}")
    return ops


def zero_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def window_args(K: int, col_window: tuple, device: torch.device) -> list:
    """The launchers' window arguments [tab, tmap, nb, start, blk] and the
    window's tile count, the tables cached on ``device``."""
    start, blk = ref.check_window(col_window, K)
    key = (device, K, start, blk)
    if key not in _WINDOWS:
        tiles, tmap = _build.window_tiles(K, start, blk)
        _WINDOWS[key] = (
            torch.tensor(tiles, dtype=torch.int32, device=device).ravel(),
            torch.tensor(tmap, dtype=torch.int32, device=device), len(tiles))
    tab, tmap, ntw = _WINDOWS[key]
    nb = -(-K // _build.BK)
    return [tab.data_ptr(), tmap.data_ptr(), nb, start, blk], ntw


def fused_stats(X: torch.Tensor, rho: torch.Tensor, beta: torch.Tensor,
                wvec: torch.Tensor, wmask: torch.Tensor | None = None,
                noise: tuple | None = None, seed: torch.Tensor | None = None,
                *, epilogue: str = "em_hinge", eps: float = 1e-6,
                eps_ins: float = 0.0, col_window: tuple | None = None):
    """(margin, gamma, b, Sigma) for the hinge epilogues and (margin,
    gamma, omega, b, Sigma) for SVR, float32. X (N, K) float32 or
    bfloat16; rho (the target y under SVR), beta, wmask (N,) float32,
    ``wmask=None`` weighs every row 1; wvec (K,) or (K, C) float32;
    ``noise`` two (mc_hinge) or four (mc_svr) (N,) float32 vectors;
    ``seed`` (4,) int64 words on X's device; ``eps_ins`` the SVR tube. For
    C chains the per-row outputs are (N, C), b (K, C) and Sigma
    (C, K, K). ``col_window = (start, blk)`` (one chain) gives Sigma's
    column block, (K, blk), through the window kernel. A CPU tensor runs
    the plain version."""
    if X.device.type == "cpu":
        return ref.fused_stats(X, rho, beta, wvec, wmask, eps, epilogue,
                               noise=noise, seed=seed, eps_ins=eps_ins,
                               col_window=col_window)
    var = variant(epilogue, noise, seed, wvec)
    if col_window is not None and wvec.dim() == 2:
        raise ValueError("multichain fused_stats does not compose with a "
                         "column window")
    svr = epilogue.endswith("svr")
    N, K = _build.check_x(X)
    for name, v, n in (("rho", rho, N), ("beta", beta, N)):
        _build.check_vec(name, v, n, X)
    if wmask is not None:
        _build.check_vec("wmask", wmask, N, X)
    ops = noise_operands(noise, seed, N, X)
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
    # The window runs over the full statistic's split plan (bitwise).
    ntiles, nsplits, rows = _build.tile_plan(N, K, X.device)
    win, width = [None, None, 0, 0, 0], K
    if col_window is not None:
        win, ntiles = window_args(K, col_window, X.device)
        width = win[-1]
    Kp = -(-K // _build.BK) * _build.BK
    f32 = dict(dtype=torch.float32, device=X.device)
    per_row = (N, C) if multi else (N,)
    margin, gamma = torch.empty(per_row, **f32), torch.empty(per_row, **f32)
    omega = torch.empty(per_row, **f32) if svr else None
    part = torch.empty(nsplits * ntiles * C * _build.BK * _build.BK, **f32)
    bpart = torch.empty(nsplits * C * Kp, **f32)
    sigma, b = torch.empty((C, K, width), **f32), torch.empty((C, K), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.launch("rt_fused_stats", X.device, X.data_ptr(),
                  int(X.dtype == torch.bfloat16), rho.data_ptr(),
                  beta.data_ptr(), ptr(wmask), wt.data_ptr(),
                  *(ptr(z) for z in ops), ptr(seed), margin.data_ptr(),
                  gamma.data_ptr(), ptr(omega), part.data_ptr(),
                  bpart.data_ptr(), sigma.data_ptr(), b.data_ptr(), N, K, Kp,
                  ntiles, nsplits, rows, C, _EPILOGUE_CODE[var], float(eps),
                  float(eps_ins), *win)
    LAUNCHES[var if col_window is None else var + ",window"] += 1
    aug = (gamma, omega) if svr else (gamma,)
    if multi:
        return (margin, *aug, b.t(), sigma)
    return (margin, *aug, b[0], sigma[0])
