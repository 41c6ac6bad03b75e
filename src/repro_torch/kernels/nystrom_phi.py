"""The Nystrom kernels on Hopper: featurize, score, and featurize-and-
accumulate, with phi = k(X, landmarks) @ proj (rbf or linear kind), rows
multiplied by ``mask`` and an optional mask-valued bias column LAST.

Replaces the TPU kernels of ``repro/kernels/nystrom_phi.py``:

  * ``nystrom_phi`` (``_make_phi_kernel``): writes phi, (N, M);
  * ``nystrom_score`` (``_make_score_kernel``): phi @ W, (N, C), phi never
    written to device memory;
  * ``nystrom_fused_stats`` (``_make_fused_kernel``): the statistic of
    ``fused_stats`` on phi, em_hinge and em_svr, mc_hinge and mc_svr
    (noise operands or the counter seed); no (N, M) phi buffer exists.
    With ``col_window`` it gives the block Sigma[:, start:start + blk] of
    phi columns (one k-shard of a 2-D fit in phi-space), as
    ``fused_stats``'s window does: the window's own tiles of the full
    lower triangle over the full plan, bitwise the full column slice.

What bounds them on the H100: fp32 operations. The projection is
2 N m M flop, Sigma N M (M + 1); at m = 1,000 landmarks that is ~1,000
flop per byte of X, fifty times the ridge. The cross-Gram is 2 N m D flop
and, at small D, the bytes of its chunk scratch.

Design (``csrc/nystrom_phi.cu``; the RBF tile body from ``csrc/rbf.cuh``,
the projection and the statistic's Sigma on the Gram engine of
``csrc/gram_pipe.cuh``, the statistic's row pass from
``csrc/fused_stats.cu``). The TPU kernels hold the landmark strip, the
projection, the cross tile, the phi tile and Sigma in VMEM at once, under
a 14 MB budget; a Hopper CTA has 227 KB of shared memory. So the rows go
in chunks of R, and per chunk:

  A. the cross-Gram chunk, once, into a scratch of at most 128 MB (each
     entry is computed once; recomputing it per output column block would
     cost D / 128 times the projection), stored landmark-major: (m, R),
     rows R apart (R a multiple of 4), so that it is the projection's
     A operand as the engine copies it. Its own operands, the chunk's rows
     of X and the landmarks, are row-major (., D), the depth along a row;
     a transposing pass writes them depth-major first ((D, R) a chunk,
     (D, m) once a call, fp32), and the product runs on the same engine
     (``csrc/rbf.cuh``), or at small D on a direct route
     (``rbf_gram.cross_route``);
  B. phi tiles of 128 x 128 = chunk^T @ proj on the Gram engine: the m
     landmarks are the depth, and 32 of them at a time land in a three-slot
     ``cp.async`` ring by 16-byte copies of both operands while the CTA
     multiplies the stage before (``CopyPair``). proj goes with its rows
     16-byte aligned: where P % 4 != 0 the wrapper pads a copy to
     PROJ_ALIGN columns (zero past P) once a call. Masked in registers,
     bias column appended. ``nystrom_phi`` stores the tiles;
     ``nystrom_score`` multiplies them by W in registers and writes
     (column block, row, C) partial scores, summed in block order by a
     last launch.

``nystrom_fused_stats`` stores the phi rows of a chunk in an (R, ld)
scratch, ld = M rounded up to PHI_ALIGN columns (zero past M, so the Gram
engine copies its rows 16 bytes at a time), then
  C. the row pass of ``fused_stats``: a warp 4 rows: margin = phi . w,
     the epilogue (``csrc/epilogues.cuh``, ``csrc/rng.cuh`` for the seed
     at global row seed[2] + row), the row's Sigma weight (mask times
     1/gamma, or 1/gamma + 1/omega under SVR) and its coef;
  D. the Gram engine's statistic grid on the chunk: Sigma's lower-
     triangle 128 x 128 tiles over the chunk's row splits, b on the
     diagonal tiles, then the partials added to Sigma and b in split
     order (no atomics: bitwise repeatable).
Computing each row's margin once, before the tiles, avoids recomputing
phi per tile (2m/128 times the tile's own Sigma work). The plan
(``stats_plan``) makes a chunk a whole number of 4,096-row splits whose
tile CTAs fill whole waves of two an SM (at m = 1,000: 7 splits, 252 CTAs
on 264 slots; 8 left 24 CTAs to a second wave). Launches a call: 3
(norms, the landmarks depth-major) + 7 a chunk; at N = 1,000,000 and m =
1,000, R = 28,672, 35 chunks. The scratch is the cross and phi chunks,
the chunk's rows depth-major and the split partials, a few hundred MB,
where phi itself would be 4 GB.

Every phi entry is one thread's fmaf chain over the landmarks in order,
from +0, so the bits do not depend on R: ``nystrom_fused_stats``
accumulates the phi that ``nystrom_phi`` writes. Where m % 32 != 0 the
engine's last stage is zero-filled past m, and fmaf(0, 0, -0) is +0: an
entry whose chain over the m landmarks ends at -0 is stored as +0.
"""
from __future__ import annotations

import torch

from . import _build, ref
from . import fused_stats as _fused_stats
from . import rbf_gram as _rbf_gram

# Launches per kernel and variant, for chip_smoke.py's check that the
# main path ran through the kernel it names.
LAUNCHES = {"nystrom_phi": 0, "nystrom_score": 0,
            "nystrom_fused_stats[em_hinge]": 0,
            "nystrom_fused_stats[mc_hinge,noise]": 0,
            "nystrom_fused_stats[mc_hinge,seed]": 0,
            "nystrom_fused_stats[em_svr]": 0,
            "nystrom_fused_stats[mc_svr,noise]": 0,
            "nystrom_fused_stats[mc_svr,seed]": 0,
            **{f"nystrom_fused_stats[{v},window]": 0 for v in (
                "em_hinge", "mc_hinge,noise", "mc_hinge,seed", "em_svr",
                "mc_svr,noise", "mc_svr,seed")}}
_EPILOGUE_CODE = {"em_hinge": 0, "mc_hinge,noise": 1, "mc_hinge,seed": 2,
                  "em_svr": 3, "mc_svr,noise": 4, "mc_svr,seed": 5}
_KINDS = {"rbf": 0, "linear": 1}

GT = 128                        # phi tile edge (csrc/rbf.cuh)
SCRATCH_WORDS = 1 << 25         # each chunk scratch: at most 128 MB
# proj's rows lie PROJ_ALIGN columns apart, so that the engine copies them
# 16 bytes at a time (csrc/gram_pipe.cuh's CopyPair).
PROJ_ALIGN = 4
# The statistic's phi rows lie PHI_ALIGN columns apart, rounded up (zero
# columns past M), so the Gram engine copies them 16 bytes at a time.
PHI_ALIGN = 4


def zero_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(X, landmarks, proj, mask, kind):
    """Validate the featurizer operands; returns (N, D, m, P)."""
    N, D = _build.check_x(X)
    if kind not in _KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}")
    for name, t in (("landmarks", landmarks), ("proj", proj)):
        if (t.device != X.device or t.dtype != torch.float32
                or t.dim() != 2 or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 matrix "
                             f"on {X.device}")
    m, P = proj.shape
    if tuple(landmarks.shape) != (m, D):
        raise ValueError(f"landmarks must be ({m}, {D}), got "
                         f"{tuple(landmarks.shape)}")
    if mask is not None:
        _build.check_vec("mask", mask, N, X)
    return N, D, m, P


def _phi_chunk_rows(N: int, m: int, M: int, *, D: int = 0) -> int:
    """Rows R of a chunk of ``nystrom_phi`` / ``nystrom_score``: a
    multiple of 128 (of 4, so the chunk scratch rows stay 16-byte aligned),
    no more than N needs, with each scratch of a chunk at most
    SCRATCH_WORDS words: the cross chunk (m, R), its rows of X depth-major
    (D, R) and R rows of M (the score partials)."""
    rows = max(GT, SCRATCH_WORDS // max(m, M, D) // GT * GT)
    return min(rows, -(-N // GT) * GT)


def proj_operand(proj: torch.Tensor) -> torch.Tensor:
    """proj (m, P) with its rows 16-byte aligned, as the projection's B
    operand: proj itself where P % PROJ_ALIGN == 0 and it is 16-byte
    aligned, else an (m, P rounded up to PROJ_ALIGN) copy, zero past P."""
    m, P = proj.shape
    if P % PROJ_ALIGN == 0 and proj.data_ptr() % 16 == 0:
        return proj
    out = torch.zeros((m, -(-P // PROJ_ALIGN) * PROJ_ALIGN),
                      dtype=proj.dtype, device=proj.device)
    out[:, :P] = proj
    return out


def _featurizer_args(X, landmarks, proj, mask, N, D, m, P, add_bias, kind,
                     sigma, chunk):
    """The featurizer's leading pointers, its scratch (the norms, the
    landmark-major cross-Gram chunk kc (m, chunk), the chunk's rows of X
    depth-major xt (D, chunk), the landmarks depth-major lt (D, m rounded
    up to 4) and the aligned proj, kept alive here) and its trailing
    sizes, for ``chunk`` rows a chunk (a multiple of 4, so the rows of kc
    and xt stay 16-byte aligned)."""
    f32 = dict(dtype=torch.float32, device=X.device)
    rbf = kind == "rbf"
    projp = proj_operand(proj)
    scratch = dict(sqx=torch.empty(N if rbf else 0, **f32),
                   sql=torch.empty(m if rbf else 0, **f32),
                   kc=torch.empty((m, chunk), **f32),
                   xt=torch.empty((D, chunk), **f32),
                   lt=_rbf_gram.depth_major(m, D, X.device), proj=projp)
    head = (X.data_ptr(), int(X.dtype == torch.bfloat16),
            landmarks.data_ptr(), projp.data_ptr(),
            None if mask is None else mask.data_ptr())
    tail = dict(N=N, D=D, m=m, P=P, ldp=projp.shape[1], bias=int(add_bias),
                kind=_KINDS[kind], route=_rbf_gram.cross_route(D),
                inv=1.0 / (2.0 * float(sigma) ** 2), chunk=chunk)
    return head, scratch, tail


def _scratch(s):
    """The featurizer's scratch pointers in the launchers' order."""
    return tuple(s[k].data_ptr() for k in ("sqx", "sql", "kc", "xt", "lt"))


def nystrom_phi(X: torch.Tensor, landmarks: torch.Tensor,
                proj: torch.Tensor, mask: torch.Tensor | None = None, *,
                sigma: float = 1.0, kind: str = "rbf",
                add_bias: bool = False) -> torch.Tensor:
    """phi (N, M) float32, M = proj cols + add_bias. X (N, D) float32 or
    bfloat16; landmarks (m, D), proj (m, P), mask (N,) float32 (None:
    all rows valid). A CPU tensor runs the plain version."""
    if X.device.type == "cpu":
        return ref.nystrom_phi(X, landmarks, proj, mask, float(sigma), kind,
                               add_bias)
    N, D, m, P = _check(X, landmarks, proj, mask, kind)
    M = P + int(add_bias)
    chunk = _phi_chunk_rows(N, m, M, D=D)
    head, s, t = _featurizer_args(X, landmarks, proj, mask, N, D, m, P,
                                  add_bias, kind, sigma, chunk)
    out = torch.empty((N, M), dtype=torch.float32, device=X.device)
    _build.launch("rt_nystrom_phi", X.device, *head, *_scratch(s),
                  out.data_ptr(), t["N"], t["D"], t["m"], t["P"], t["ldp"],
                  t["bias"], t["kind"], t["route"], t["inv"], t["chunk"])
    LAUNCHES["nystrom_phi"] += 1
    return out


def score_scratch(N: int, D: int, m: int, P: int, C: int,
                  add_bias: bool, kind: str = "rbf",
                  proj_padded: bool | None = None) -> dict:
    """The float32 device buffers one ``nystrom_score`` call allocates,
    name -> shape (``_featurizer_args``' scratch, the score partials and
    the output): what the serving path's residency check reads. None of
    them is an (N, M) phi; the cross-Gram chunk ``kc`` is (m, R).
    ``proj_padded`` (default: P % PROJ_ALIGN != 0) adds proj's aligned
    copy."""
    M = P + int(add_bias)
    chunk = _phi_chunk_rows(N, m, M, D=D)
    rbf = kind == "rbf"
    out = dict(sqx=(N if rbf else 0,), sql=(m if rbf else 0,),
               kc=(m, chunk), xt=(D, chunk), lt=(D, -(-m // 4) * 4),
               spart=(-(-M // GT) * chunk * C,), out=(N, C))
    if proj_padded is None:
        proj_padded = P % PROJ_ALIGN != 0
    if proj_padded:
        out["proj"] = (m, -(-P // PROJ_ALIGN) * PROJ_ALIGN)
    return out


def nystrom_score(X: torch.Tensor, landmarks: torch.Tensor,
                  proj: torch.Tensor, W: torch.Tensor,
                  mask: torch.Tensor | None = None, *, sigma: float = 1.0,
                  kind: str = "rbf", add_bias: bool = False
                  ) -> torch.Tensor:
    """(N, C) float32 scores = nystrom_phi(X, ...) @ W, W (M, C) float32;
    masked rows score 0. A CPU tensor runs the plain version."""
    if X.device.type == "cpu":
        return ref.nystrom_score(X, landmarks, proj, W, mask, float(sigma),
                                 kind, add_bias)
    N, D, m, P = _check(X, landmarks, proj, mask, kind)
    M = P + int(add_bias)
    if (W.device != X.device or W.dtype != torch.float32 or W.dim() != 2
            or W.shape[0] != M or not W.is_contiguous()):
        raise ValueError(f"W must be a contiguous float32 ({M}, C) matrix "
                         f"on {X.device} (M = proj cols + add_bias)")
    C = W.shape[1]
    chunk = _phi_chunk_rows(N, m, M, D=D)
    head, s, t = _featurizer_args(X, landmarks, proj, mask, N, D, m, P,
                                  add_bias, kind, sigma, chunk)
    f32 = dict(dtype=torch.float32, device=X.device)
    spart = torch.empty(-(-M // GT) * chunk * C, **f32)
    out = torch.empty((N, C), **f32)
    _build.launch("rt_nystrom_score", X.device, *head, W.data_ptr(),
                  *_scratch(s), spart.data_ptr(), out.data_ptr(), t["N"],
                  t["D"], t["m"], t["P"], t["ldp"], t["bias"], C, t["kind"],
                  t["route"], t["inv"], t["chunk"])
    LAUNCHES["nystrom_score"] += 1
    return out


def stats_plan(N: int, m: int, M: int, sms: int, *, D: int = 0
               ) -> tuple[int, int, int]:
    """(ntiles, rows_per_split, chunk_rows) of the statistic on ``sms``
    SMs. Splits are at most ROWS_PER_SPLIT rows, as long as N split
    enough ways for two tile CTAs an SM allows; a chunk is a whole number
    of them (so split boundaries align across chunks, and the sums do not
    depend on the chunking) with each of its scratches at most
    SCRATCH_WORDS words: the cross chunk (m wide), its rows of X depth-
    major (D), the phi rows (M wide; their scratch pads them to the
    16-byte stride, PHI_ALIGN - 1 columns more at most). The CTAs of a chunk
    (splits x tiles) run in waves of two an SM, and every split costs its
    rows in each wave, so a chunk takes the number of splits with the
    fewest waves a split, the most of those (at m = 1,000, M = 1,001, 36
    tiles, on 132 SMs: 7 splits, 252 CTAs in one wave, where 8 would
    leave 24 CTAs to a second)."""
    nb = -(-M // _build.BK)
    ntiles = nb * (nb + 1) // 2
    slots = 2 * sms
    per_split = -(-N // -(-slots // ntiles))
    rows = min(_build.ROWS_PER_SPLIT, -(-per_split // _build.BN) * _build.BN)
    most = max(1, min(SCRATCH_WORDS // (rows * max(m, M, D)),
                      -(-N // rows)))
    splits = min(range(1, most + 1),
                 key=lambda s: (-(-s * ntiles // slots) / s, -s))
    return ntiles, rows, rows * splits


def nystrom_fused_stats(X: torch.Tensor, landmarks: torch.Tensor,
                        proj: torch.Tensor, rho: torch.Tensor,
                        beta: torch.Tensor, wvec: torch.Tensor,
                        mask: torch.Tensor | None = None,
                        noise: tuple | None = None,
                        seed: torch.Tensor | None = None, *,
                        sigma: float = 1.0, kind: str = "rbf",
                        add_bias: bool = False, epilogue: str = "em_hinge",
                        eps: float = 1e-6, eps_ins: float = 0.0,
                        col_window: tuple | None = None):
    """(margin (N,), gamma (N,), b (M,), Sigma (M, M)), float32, with
    omega (N,) after gamma under SVR: the statistic of ``fused_stats`` on
    phi, Sigma weighted by mask times the epilogue's weight. rho (the
    target y under SVR), beta (N,), wvec (M,) float32; ``noise`` two
    (mc_hinge) or four (mc_svr) (N,) float32 vectors or ``seed`` (4,)
    int64 words on X's device; ``eps_ins`` the SVR tube;
    ``col_window = (start, blk)`` gives Sigma's block of phi columns,
    (M, blk). A CPU tensor runs the plain version."""
    if X.device.type == "cpu":
        return ref.nystrom_fused_stats(
            X, landmarks, proj, rho, beta, wvec, mask, float(sigma), kind,
            add_bias, eps, epilogue, noise=noise, col_window=col_window,
            seed=seed, eps_ins=eps_ins)
    var = _fused_stats.variant(epilogue, noise, seed, wvec)
    if var not in _EPILOGUE_CODE:
        raise ValueError("the Nystrom statistic is single-chain: wvec must "
                         "be (M,)")
    svr = epilogue.endswith("svr")
    N, D, m, P = _check(X, landmarks, proj, mask, kind)
    M = P + int(add_bias)
    for name, v, n in (("rho", rho, N), ("beta", beta, N), ("wvec", wvec, M)):
        _build.check_vec(name, v, n, X)
    ops = _fused_stats.noise_operands(noise, seed, N, X)
    # The window runs over the full statistic's plan (bitwise).
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    ntiles, rows, chunk = stats_plan(N, m, M, sms, D=D)
    win, width = [None, None, 0, 0, 0], M
    if col_window is not None:
        win, ntiles = _fused_stats.window_args(M, col_window, X.device)
        width = win[-1]
    head, s, t = _featurizer_args(X, landmarks, proj, mask, N, D, m, P,
                                  add_bias, kind, sigma, chunk)
    f32 = dict(dtype=torch.float32, device=X.device)
    nsplits = chunk // rows
    Mp = -(-M // _build.BK) * _build.BK
    ld = -(-M // PHI_ALIGN) * PHI_ALIGN
    phi = torch.empty(chunk * ld, **f32)
    wgt, coef = torch.empty(chunk, **f32), torch.empty(chunk, **f32)
    part = torch.empty(nsplits * ntiles * _build.BK * _build.BK, **f32)
    bpart = torch.empty(nsplits * Mp, **f32)
    margin, gamma = torch.empty(N, **f32), torch.empty(N, **f32)
    omega = torch.empty(N, **f32) if svr else None
    sigma_out, b = torch.empty((M, width), **f32), torch.empty(M, **f32)

    def ptr(v):
        return None if v is None else v.data_ptr()

    _build.launch("rt_nystrom_fused_stats", X.device, *head,
                  rho.data_ptr(), beta.data_ptr(), wvec.data_ptr(),
                  *(ptr(z) for z in ops), ptr(seed), *_scratch(s),
                  phi.data_ptr(),
                  wgt.data_ptr(), coef.data_ptr(), part.data_ptr(),
                  bpart.data_ptr(), margin.data_ptr(), gamma.data_ptr(),
                  ptr(omega), sigma_out.data_ptr(), b.data_ptr(), t["N"],
                  t["D"], t["m"], t["P"], t["ldp"], t["bias"], t["kind"],
                  t["route"], t["inv"], chunk, ntiles, rows, ld,
                  _build.gram_copy(phi.view(chunk, ld)), _EPILOGUE_CODE[var],
                  float(eps), float(eps_ins), *win)
    LAUNCHES[f"nystrom_fused_stats[{var}"
             + ("]" if col_window is None else ",window]")] += 1
    aug = (gamma, omega) if svr else (gamma,)
    return (margin, *aug, b, sigma_out)
