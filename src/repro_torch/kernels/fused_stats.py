"""The whole iteration statistic on Hopper, in a row pass and a tile pass
over X: margin = Xw; the epilogue's gamma (and omega), weight and coef;
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
streams count as iteration time does not carry over: here X is read
twice (once a chain by the row pass, once by the tile grid, mostly from
L2 for all but the first of a split's tiles), which is cheap beside the
FMAs. Accumulation stays fp32 without TF32.

Design (``csrc/fused_stats.cu``; the Gram engine of ``csrc/gram_pipe.cuh``
shared with ``syrk_tri`` and ``weighted_gram``): the TPU kernel keeps the
whole (K, K) Sigma in VMEM for the N sweep (9.4 MB at K = 1536); a Hopper
CTA has 227 KB of shared memory. So Sigma is tiled across CTAs with
syrk's grid, (row split) x (lower-triangle 128 x 128 tile), and only the
lower tiles are computed.

How the CTAs share the margin and gamma of a row: a row pass before the
tile grid computes them once (``stat_rows``, a warp 4 rows: their
margins with all lanes, in a fixed summation order, then lanes 0-3 run
the rows' epilogues) and writes each row's Sigma weight
wmask * weight and b coefficient to two (C, N) scratch vectors. The tile
grid is then the Gram engine: its CTAs stream 32-row stages of their two
column blocks, with the rows' weights and coefficients beside them,
through a three-stage ``cp.async`` ring and only multiply (72-74 % of
fp32 peak where ``syrk_tri`` runs it). Each diagonal-tile CTA (q, q) also
sums b's block q from its unscaled B side. Partials are summed in split
order by two small launches (Sigma with the mirror, and b):
deterministic, no atomics. The splits (``_build.stat_plan``) are at most
4,096 rows and sized so the last wave of CTAs is not nearly empty (at
250,000 x 501: 79 splits, 790 CTAs in three waves of two an SM).

The Gibbs noise (``csrc/rng.cuh``) is a pure function of (key words,
global row, chain), so the draw does not depend on the grid. The epilogue
(``csrc/epilogues.cuh``) rounds each operation as PyTorch's eager ops do.
SVR doubles the per-row epilogue (two mixtures, two Threefry pairs a
mixture in the seed variants); it runs in the row pass only, so the tile
grid is one kernel for every epilogue.

Multichain is a chain grid dimension, fastest-varying in both passes: CTA
(split, tile, c) reads chain c's weights and coefficients and writes
Sigma_c's partial. X rows are read once per chain, from L2 for all but
the first of the C adjacent CTAs; the tile work scales with C (no chain
is free here).

The window: ``start = k_rank * blk`` need not be a multiple of 128 (K =
502 splits into (0, 251) and (251, 251)). Of the two ways to place such
a window, this is the 128-aligned cover: the tile grid runs the full
statistic's own lower-triangle tiles whose row or column block meets the
window's column blocks (``_build.window_tiles``, 7 and 9 of 10 at K = 502),
over the full statistic's split plan, and its finalize takes each window
column from the tile that holds it, transposed above the diagonal, in
split order. Every element is then summed exactly as the full variant sums
it: the window is bitwise the full variant's column slice, and b (summed
by one CTA a block, from its B side or, for blocks right of the window,
from X's rows) bitwise the full b. Offsetting the column loads instead
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


def grid(N: int, K: int, C: int, sms: int, col_window: tuple | None = None,
         device: torch.device | None = None) -> tuple[int, int, int, list]:
    """(ntiles, nsplits, rows_per_split, win) of a call on ``sms`` SMs.
    The split plan is the full statistic's (``_build.stat_plan``), also
    under a column window, so that the window's columns are summed as the
    full call sums them (bitwise its slice); with a window, ``ntiles``
    counts the window's tiles and ``win`` holds the launcher's window
    arguments (``window_args``, the tables on ``device``)."""
    ntiles, nsplits, rows = _build.stat_plan(N, K, C, sms)
    if col_window is None:
        return ntiles, nsplits, rows, [None, None, 0, 0, 0]
    win, ntw = window_args(K, col_window, device)
    return ntw, nsplits, rows, win


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
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    ntiles, nsplits, rows, win = grid(N, K, C, sms, col_window, X.device)
    width = K if col_window is None else win[-1]
    Kp = -(-K // _build.BK) * _build.BK
    f32 = dict(dtype=torch.float32, device=X.device)
    per_row = (N, C) if multi else (N,)
    margin, gamma = torch.empty(per_row, **f32), torch.empty(per_row, **f32)
    omega = torch.empty(per_row, **f32) if svr else None
    wgt, coef = torch.empty(C * N, **f32), torch.empty(C * N, **f32)
    part = torch.empty(nsplits * ntiles * C * _build.BK * _build.BK, **f32)
    bpart = torch.empty(nsplits * C * Kp, **f32)
    sigma, b = torch.empty((C, K, width), **f32), torch.empty((C, K), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.launch("rt_fused_stats", X.device, X.data_ptr(),
                  _build.gram_copy(X), rho.data_ptr(), beta.data_ptr(),
                  ptr(wmask), wt.data_ptr(), *(ptr(z) for z in ops),
                  ptr(seed), margin.data_ptr(), gamma.data_ptr(), ptr(omega),
                  wgt.data_ptr(), coef.data_ptr(), part.data_ptr(),
                  bpart.data_ptr(), sigma.data_ptr(), b.data_ptr(), N, K, Kp,
                  ntiles, nsplits, rows, C, _EPILOGUE_CODE[var], float(eps),
                  float(eps_ins), *win)
    LAUNCHES[var if col_window is None else var + ",window"] += 1
    aug = (gamma, omega) if svr else (gamma,)
    if multi:
        return (margin, *aug, b.t(), sigma)
    return (margin, *aug, b[0], sigma[0])
