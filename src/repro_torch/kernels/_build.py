"""Build and bind the CUDA kernels of ``csrc/``.

At first use, each ``csrc/*.cu`` is compiled by its own ``nvcc`` process,
all started together, and the objects are linked into
``build/kernels/librepro_torch_kernels_<hash>.so`` at the repository root.
The hash covers the sources, the headers and the flags, so an edit builds
a new library and an unchanged tree reuses the old one. The library has a
plain C interface and is loaded with ``ctypes``: no PyTorch headers, so a
build takes seconds. A failed build or load raises; nothing falls back to
the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Tile geometry of csrc/common.cuh.
BK = 128
BN = 32
# Rows one CTA sweeps before writing a partial: bounds the length of each
# sequential fp32 sum (see PERF.md, accumulation error) and the scratch.
ROWS_PER_SPLIT = 4096

_c_void_p, _c_int, _c_int64, _c_float = (ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int64, ctypes.c_float)
_SIGNATURES = {
    "rt_dcd_sweep": [_c_int, _c_void_p, *[_c_void_p] * 4, _c_int64,
                     _c_float, _c_int, _c_void_p, _c_void_p,
                     *[_c_int] * 5],
    "rt_syrk_tri": [_c_int, _c_void_p, _c_void_p, _c_int, _c_void_p,
                    _c_void_p, _c_void_p, _c_int64, _c_int, _c_int, _c_int,
                    _c_int64],
    "rt_fused_estep": [_c_int, _c_void_p, _c_void_p, _c_int, _c_int,
                       *[_c_void_p] * 7, _c_int64, _c_int, _c_int, _c_int64,
                       _c_float],
    "rt_fused_estep_occupancy": [_c_int, _c_int, _c_int, _c_void_p,
                                 _c_void_p],
    "rt_fused_stats": [_c_int, _c_void_p, _c_void_p, _c_int,
                       *[_c_void_p] * 18, _c_int64, _c_int, _c_int, _c_int,
                       _c_int, _c_int64, _c_int, _c_int, _c_float, _c_float,
                       _c_void_p, _c_void_p, _c_int, _c_int, _c_int],
    "rt_fused_stats_occupancy": [_c_int, _c_int, _c_int, _c_void_p,
                                 _c_void_p],
    "rt_weighted_gram": [_c_int, _c_void_p, _c_void_p, _c_int, _c_void_p,
                         _c_void_p, _c_void_p, _c_int64, _c_int, _c_int,
                         _c_int64],
    "rt_syrk_occupancy": [_c_int, _c_int, _c_void_p, _c_void_p],
    "rt_nystrom_phi_occupancy": [_c_int, _c_int, _c_void_p, _c_void_p],
    "rt_weighted_gram_occupancy": [_c_int, _c_int, _c_void_p, _c_void_p],
    "rt_rbf_gram": [_c_int, _c_void_p, _c_void_p, _c_int, _c_void_p, _c_int,
                    *[_c_void_p] * 5, _c_int, _c_int, _c_int, _c_float,
                    _c_int],
    "rt_rbf_gram_occupancy": [_c_int, _c_int, _c_void_p, _c_void_p],
    "rt_nystrom_cross_occupancy": [_c_int, _c_int, _c_int, _c_void_p,
                                   _c_void_p],
    "rt_nystrom_phi": [_c_int, _c_void_p, _c_void_p, _c_int,
                       *[_c_void_p] * 9, _c_int64, _c_int, _c_int,
                       _c_int, _c_int, _c_int, _c_int, _c_int, _c_float,
                       _c_int64],
    "rt_nystrom_score": [_c_int, _c_void_p, _c_void_p, _c_int,
                         *[_c_void_p] * 11, _c_int64, _c_int, _c_int,
                         _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
                         _c_float, _c_int64],
    "rt_nystrom_fused_stats": [_c_int, _c_void_p, _c_void_p, _c_int,
                               *[_c_void_p] * 26, _c_int64, _c_int, _c_int,
                               _c_int, _c_int, _c_int, _c_int, _c_int,
                               _c_float, _c_int64,
                               _c_int, _c_int64, _c_int, _c_int, _c_int,
                               _c_float, _c_float,
                               _c_void_p, _c_void_p, _c_int, _c_int, _c_int],
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "repro_torch CUDA kernels are built with it at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"


def build() -> tuple[Path, str, float]:
    """Compile (or reuse) the kernel library. Returns (path, the compiler's
    ``-Xptxas -v`` report, build seconds; 0 when reused)."""
    lib = library_path()
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, log_path.read_text() if log_path.exists() else "", 0.0
    t0 = time.perf_counter()
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"tmp-{lib.stem}-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    procs = [(src, subprocess.Popen(
        [nvcc, *FLAGS, "-c", str(src), "-o", str(tmp / (src.stem + ".o"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in sources]
    logs = []
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp_lib = tmp / lib.name
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp_lib),
         *(str(tmp / (s.stem + ".o")) for s in sources)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n"
                           f"{link.stdout}")
    log_path.write_text(log)
    os.replace(tmp_lib, lib)  # atomic: concurrent builds both succeed
    shutil.rmtree(tmp, ignore_errors=True)
    return lib, log, time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C launcher ``name`` on ``device``'s current stream; raise
    if it reports a CUDA error (a refused launch never runs, and a later
    synchronize would not say so)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    err = getattr(library(), name)(index, stream, *args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def check_x(X: torch.Tensor) -> tuple[int, int]:
    """Validate the (N, K) design matrix a kernel reads; returns (N, K)."""
    if not X.is_cuda:
        raise ValueError("the CUDA kernels take CUDA tensors")
    if X.dim() != 2 or X.shape[0] < 1 or X.shape[1] < 1:
        raise ValueError(f"X must be a non-empty (N, K) matrix, got "
                         f"{tuple(X.shape)}")
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"X must be float32 or bfloat16, got {X.dtype}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous (row-major)")
    return X.shape[0], X.shape[1]


def check_vec(name: str, v: torch.Tensor, n: int, X: torch.Tensor) -> None:
    """Validate a float32 (n,) operand on X's device."""
    if v.device != X.device:
        raise ValueError(f"{name} is on {v.device}, X on {X.device}")
    if v.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {v.dtype}")
    if tuple(v.shape) != (n,) or not v.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({n},) vector, got "
                         f"{tuple(v.shape)}")


# The Gram engine's copy paths (csrc/gram_pipe.cuh's Path), by index.
GRAM_PATHS = ("f32x4", "f32x16", "bf16")


def gram_copy(X: torch.Tensor) -> int:
    """The index in GRAM_PATHS of how the Gram engine copies X's rows:
    "f32x16", one 16-byte cp.async a four-column group, for float32 rows
    whose every group is 16-byte aligned (K % 4 == 0 and X 16-byte
    aligned); "f32x4", 4-byte copies, for other float32; "bf16", the
    covering 4-byte words, for bfloat16."""
    if X.dtype == torch.bfloat16:
        return GRAM_PATHS.index("bf16")
    aligned = X.shape[1] % 4 == 0 and X.data_ptr() % 16 == 0
    return GRAM_PATHS.index("f32x16" if aligned else "f32x4")


def tile_plan(N: int, K: int, device: torch.device) -> tuple[int, int, int]:
    """(ntiles, nsplits, rows_per_split) of the triangle-tiled Sigma grid:
    one CTA per (lower-triangle tile, row split). Splits are at most
    ROWS_PER_SPLIT rows, and numerous enough for two CTAs per SM."""
    nb = -(-K // BK)
    ntiles = nb * (nb + 1) // 2
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(-(-N // ROWS_PER_SPLIT), -(-2 * sms // ntiles))
    rows = -(-N // want)
    rows = -(-rows // BN) * BN
    return ntiles, -(-N // rows), rows


def gram_plan(N: int, ntiles: int, sms: int) -> tuple[int, int]:
    """(nsplits, rows_per_split) of the dense Gram grid (``weighted_gram``):
    one CTA per (tile, row split), two CTAs an SM. Splits hold at most
    ROWS_PER_SPLIT rows, a multiple of BN, and are numerous enough for two
    CTAs an SM where N allows; up to twice the fewest that allows. Of those
    plans it takes the one whose waves of CTAs times rows a split is least:
    a last wave that would run nearly empty is bought back with shorter
    splits (at Table 9's 250,000 x 500 on 132 SMs: 99 splits of 2,528
    rows, six full waves, in place of 62 of 4,096 in 3.76 waves)."""
    slots = 2 * sms
    fill = min(-(-slots // ntiles), -(-N // BN))
    most = max(2 * -(-N // ROWS_PER_SPLIT), 2 * fill)
    best = None
    for rows in range(ROWS_PER_SPLIT, BN - 1, -BN):
        nsplits = -(-N // rows)
        if fill <= nsplits <= most:
            cost = -(-nsplits * ntiles // slots) * rows
            if best is None or cost < best[0]:
                best = (cost, nsplits, rows)
    return best[1], best[2]


def stat_plan(N: int, K: int, C: int, sms: int) -> tuple[int, int, int]:
    """(ntiles, nsplits, rows_per_split) of ``fused_stats``' tile grid:
    the lower-triangle tiles of a width-K Sigma for C chains, one CTA per
    (split, tile, chain), split by ``gram_plan`` so that the last wave of
    CTAs is not nearly empty (at 250,000 x 501, one chain, on 132 SMs: 79
    splits of 3,168 rows, 790 CTAs in three waves of 264, in place of
    ``tile_plan``'s 62 of 4,064 in 2.35 waves). A column window runs on
    the plan of the full call."""
    nb = -(-K // BK)
    ntiles = nb * (nb + 1) // 2
    nsplits, rows = gram_plan(N, ntiles * C, sms)
    return ntiles, nsplits, rows


def window_tiles(K: int, start: int, blk: int) -> tuple[list, list]:
    """The tile table of the column window [start, start + blk) of a
    width-K Sigma (``WinArgs`` in csrc/common.cuh): the lower-triangle
    tiles (i, j), in the full grid's order, with i or j among the column
    blocks the window overlaps, each as (i, j, bmode), and the (nb, nb)
    map from (i, j) to its index in the table (-1: not computed). Each
    tile block q of b gets one CTA: the first tile whose column block is
    q (bmode 1), else the first whose row block is q (bmode 2)."""
    nb = -(-K // BK)
    lo, hi = start // BK, (start + blk - 1) // BK
    tiles = [[i, j, 0] for i in range(nb) for j in range(i + 1)
             if lo <= i <= hi or lo <= j <= hi]
    for q in range(nb):
        tile = (next((t for t in tiles if t[1] == q), None)
                or next(t for t in tiles if t[0] == q))
        assert tile[2] == 0, (K, start, blk, q)
        tile[2] = 1 if tile[1] == q else 2
    tmap = [-1] * (nb * nb)
    for idx, (i, j, _) in enumerate(tiles):
        tmap[i * nb + j] = idx
    return tiles, tmap
