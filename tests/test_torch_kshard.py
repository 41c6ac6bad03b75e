"""The port's column-windowed statistic and its 2-D (data x k) fit against
the JAX package's, on the CPU.

1. Windows. The port's plain ``fused_stats`` with ``col_window`` (the four
   epilogues, and the counter-seed route of both MC epilogues) and
   ``nystrom_fused_stats`` (em_hinge, mc_hinge, em_svr), on the reference's
   odd masked shapes and windows (``tests/test_kshard_fused.py``), against
   the reference's FULL Sigma column slice: max|d| <= 1e-5 max|S_ref|
   (float32 sums in another order; the readings are below 4e-6). Margin,
   aug and b of a window call are bitwise the port's full-width call's.
   Windows past FUSED_STATS_MAX_K hold the same way. The Nystrom route
   rule (``nystrom_fused_fits`` with a window) is the reference's exactly.
   The window kernel's tile table
   (``_build.window_tiles``) rebuilds every window column exactly in a
   float64 emulation of its finalize, and sums each block of b once.
2. Draws. The MC gamma (and omega) under a window are bitwise those
   without it, and the rowwise oracle's.
3. 2 x 2 (data x k) fits, four gloo ranks on the CPU against the
   reference's fits on four emulated devices (one JAX subprocess, outputs
   in an .npz): on make_alpha_like(4096, 23), LIN-EM-CLS, LIN-MC-CLS
   rng='fused', LIN-EM-CLS with pad_features (no bias column, K = 23 ->
   24); then LIN-EM-SVR (year-like
   50,000 x 90, bias, pad_features=2: K = 92) and NystromSVM KRN-EM-CLS
   in phi-space (m = 55, phi width 56, the reference's featurizer). Bands,
   those the port's single-device tests use: EM iterations within 3, the
   objective trace within 2e-2 relative (CLS) or 5e-2 (SVR: the EM-SVR
   iteration spreads ~2e-2 from a last-bit change, ROADMAP section 3),
   weights within 5e-2 relative; MC weights within 0.15. Each mesh fit is
   also held to the port's single-device fit: the same bands, and the MC
   chain's first objective within 1e-6 relative (the same draws: they are
   keyed by global row). All four ranks' weights are bitwise equal. An
   indivisible K raises the reference's message, naming pad_features_to.
"""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import augment as jaug
from repro.kernels import ops as jops
from repro.kernels import rng as jrng
from repro_torch.core import augment as taug
from repro_torch.core import prng
from repro_torch.data import make_alpha_like
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rng as trng

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
WINDOWS = ((0, 29), (5, 7), (22, 7), (13, 1), (0, 1))
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Keep torch to two intra-op threads: the suite runs six workers at
    once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _problem(n=37, k=29, seed=0):
    """The reference's odd masked problem (test_kshard_fused._problem)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, k)).astype(np.float32)
    y = rng.choice([-1.0, 1.0], n).astype(np.float32)
    ys = (X @ rng.normal(size=k)).astype(np.float32)
    w = rng.normal(size=k).astype(np.float32)
    wm = (rng.random(n) > 0.2).astype(np.float32)
    return X, y, ys, w, wm


def _T(a):
    return torch.from_numpy(np.array(a))


def _noise(variant, n, row0=11):
    """(jax kw, torch kw) of an epilogue variant's noise: the reference's
    fold_in-keyed draws for both packages, or the counter seed."""
    key = jax.random.PRNGKey(3)
    if variant in ("mc_hinge", "mc_svr"):
        if variant == "mc_hinge":
            z = jaug.draw_ig_noise(key, n, row0)
        else:
            k_lo, k_hi = jax.random.split(key)
            z = (*jaug.draw_ig_noise(k_lo, n, row0),
                 *jaug.draw_ig_noise(k_hi, n, row0))
        return dict(noise=z), dict(noise=tuple(_T(v) for v in z))
    if variant.endswith("seed"):
        seed = jrng.pack_seed(key, row0, 0)
        return (dict(seed=seed),
                dict(seed=_T(np.asarray(seed).astype(np.int64))))
    return {}, {}


VARIANTS = ("em_hinge", "mc_hinge", "em_svr", "mc_svr", "mc_hinge-seed",
            "mc_svr-seed")


# ------------------------------------------------------------ 1. windows
@pytest.mark.parametrize("variant", VARIANTS)
def test_windowed_statistic_vs_reference_column_slice(variant):
    X, y, ys, w, wm = _problem()
    epi = variant.split("-")[0]
    svr = epi.endswith("svr")
    rho, beta = (ys, np.zeros_like(y)) if svr else (y, y)
    jkw, tkw = _noise(variant, X.shape[0])
    kw = dict(epilogue=epi, eps=1e-4, eps_ins=0.2)
    S_ref = np.asarray(jops.fused_stats(
        jnp.asarray(X), jnp.asarray(rho), jnp.asarray(beta), jnp.asarray(w),
        jnp.asarray(wm), backend="ref", **jkw, **kw)[-1])
    args = [_T(a) for a in (X, rho, beta, w, wm)]
    full = tops.fused_stats(*args, **tkw, **kw)
    for start, blk in WINDOWS:
        win = tops.fused_stats(*args, col_window=(start, blk), **tkw, **kw)
        assert win[-1].shape == (29, blk)
        err = np.max(np.abs(win[-1].numpy() - S_ref[:, start:start + blk]))
        assert err <= REL * np.max(np.abs(S_ref)), (start, blk, err)
        for a, b in zip(win[:-1], full[:-1]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("epi", ["em_hinge", "mc_hinge", "em_svr"])
def test_nystrom_windowed_vs_reference_phi_column_slice(epi):
    rng = np.random.default_rng(1)
    n, m, d = 37, 13, 9
    X = rng.normal(size=(n, d)).astype(np.float32)
    L = rng.normal(size=(m, d)).astype(np.float32)
    proj = rng.normal(size=(m, m)).astype(np.float32)
    y = rng.choice([-1.0, 1.0], n).astype(np.float32)
    wm = (rng.random(n) > 0.3).astype(np.float32)
    wphi = rng.normal(size=m + 1).astype(np.float32)
    jkw, tkw = _noise(epi, n, 3)
    rho, beta = ((y * 0.5, np.zeros_like(y)) if epi == "em_svr"
                 else (y, y))
    kw = dict(sigma=0.9, add_bias=True, epilogue=epi, eps=1e-4,
              eps_ins=0.2)
    S_ref = np.asarray(jops.nystrom_fused_stats(
        *(jnp.asarray(a) for a in (X, L, proj, rho, beta, wphi, wm)),
        backend="ref", **jkw, **kw)[-1])
    args = [_T(a) for a in (X, L, proj, rho, beta, wphi, wm)]
    full = tops.nystrom_fused_stats(*args, **tkw, **kw)
    for start, blk in ((0, 14), (3, 5), (9, 5), (7, 7), (13, 1)):
        win = tops.nystrom_fused_stats(*args, col_window=(start, blk),
                                       **tkw, **kw)
        err = np.max(np.abs(win[-1].numpy() - S_ref[:, start:start + blk]))
        assert err <= REL * np.max(np.abs(S_ref)), (start, blk, err)
        for a, b in zip(win[:-1], full[:-1]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("window", [(0, 30), (25, 5), (-1, 3), (3, 0)])
def test_window_outside_sigma_raises(window):
    X, y, _, w, _ = (_T(a) for a in _problem())
    with pytest.raises(ValueError, match="column"):
        tops.fused_stats(X, y, y, w, col_window=window)


def test_multichain_window_raises():
    X, y, _, w, _ = (_T(a) for a in _problem())
    seed = trng.pack_seed(prng.PRNGKey(1), 0, 0)
    with pytest.raises(ValueError, match="multichain"):
        tops.fused_stats(X, y, y, torch.stack([w, w], 1), None,
                         epilogue="mc_hinge", seed=seed, col_window=(0, 5))


@pytest.mark.parametrize("K,start,blk,variant", [
    (1600, 800, 800, "em_hinge"), (2048, 0, 128, "em_hinge"),
    (2048, 1024, 1024, "mc_svr"), (2048, 1024, 1024, "mc_svr-seed"),
    (4000, 3744, 256, "em_svr"), (4000, 200, 200, "mc_hinge-seed"),
    (4000, 0, 2000, "em_hinge"), (502, 251, 251, "em_hinge"),
])
def test_wide_window_vs_full_column_slice(K, start, blk, variant):
    """A window past FUSED_STATS_MAX_K: the full-width statistic takes the
    split route there, the window does not (on the card it is the window
    kernel at any K). Margin and aug are bitwise the port's full-width
    call's, and the margin within 1e-5 of the reference's; b is within
    1e-5 max|b| of the full call's; the window is within 1e-5 max|S64| of
    the full call's column slice and of the float64 statistic from the
    port's own aug (the reference's own aug differs from it in the last
    bits of a K = 4000 margin, which a row near the SVR knee magnifies
    to 2e-3 of Sigma: ROADMAP section 3)."""
    X, y, ys, w, wm = _problem(n=24, k=K, seed=K + blk)
    epi = variant.split("-")[0]
    rho, beta = (ys, np.zeros_like(y)) if epi.endswith("svr") else (y, y)
    jkw, tkw = _noise(variant, X.shape[0])
    kw = dict(epilogue=epi, eps=1e-4, eps_ins=0.2)
    m_ref = np.asarray(jops.fused_stats(
        jnp.asarray(X), jnp.asarray(rho), jnp.asarray(beta), jnp.asarray(w),
        jnp.asarray(wm), backend="ref", **jkw, **kw)[0])
    args = [_T(a) for a in (X, rho, beta, w, wm)]
    full = tops.fused_stats(*args, **tkw, **kw)
    win = tops.fused_stats(*args, col_window=(start, blk), **tkw, **kw)
    assert win[-1].shape == (K, blk)
    for a, b in zip(win[:-2], full[:-2]):
        assert torch.equal(a, b)
    assert np.max(np.abs(win[0].numpy() - m_ref)) <= REL * np.max(
        np.abs(m_ref))
    b_full = full[-2].numpy()
    assert np.max(np.abs(win[-2].numpy() - b_full)) <= REL * np.max(
        np.abs(b_full))
    wt = sum(1.0 / a.double() for a in win[1:-2]) * _T(wm).double()
    X64 = _T(X).double()
    S64 = ((X64 * wt[:, None]).T @ X64[:, start:start + blk]).numpy()
    scale = REL * np.max(np.abs(S64))
    assert np.max(np.abs(win[-1].numpy() - S64)) <= scale
    assert np.max(np.abs(win[-1].numpy()
                         - full[-1][:, start:start + blk].numpy())) <= scale


@pytest.mark.parametrize("m,d,blk,epilogue,rng", [
    (681, 90, 341, "em_svr", False), (1000, 500, 500, "em_hinge", False),
    (1000, 500, 100, "mc_hinge", True), (600, 1500, 300, "mc_svr", False),
    (55, 2, 28, "em_hinge", False),
])
def test_nystrom_fused_fits_window_matches_reference(m, d, blk, epilogue,
                                                     rng):
    assert (tops.nystrom_fused_fits(m, d, True, 256, epilogue, blk, rng)
            == jops.nystrom_fused_fits(m, d, True, 256, epilogue, blk,
                                       rng))


@pytest.mark.parametrize("K,start,blk", [
    (29, 5, 7), (29, 13, 1), (502, 0, 251), (502, 251, 251),
    (682, 0, 341), (682, 341, 341), (92, 46, 46), (300, 130, 7),
    (1024, 300, 3), (1100, 0, 1100), (700, 127, 2), (700, 640, 60),
])
def test_window_tile_table_rebuilds_the_column_slice(K, start, blk):
    """A float64 emulation of the window kernel's index work: tiles of a
    random symmetric S taken as the table says, then finalized as
    win_finalize does (the tile that holds each element, transposed above
    the diagonal) rebuild S[:, start:start + blk] exactly; every block of
    b is summed by exactly one tile, from its B side (bmode 1, the column
    block) or its rows (bmode 2, the row block)."""
    BK = _build.BK
    nb = -(-K // BK)
    A = np.random.default_rng(K + start).normal(size=(nb * BK, nb * BK))
    S = A + A.T
    tiles, tmap = _build.window_tiles(K, start, blk)
    part = [S[i * BK:(i + 1) * BK, j * BK:(j + 1) * BK] for i, j, _ in tiles]
    out = np.empty((K, blk))
    for r in range(K):
        for c in range(start, start + blk):
            bi, bj = r // BK, c // BK
            if bi >= bj:
                out[r, c - start] = part[tmap[bi * nb + bj]][r % BK, c % BK]
            else:
                out[r, c - start] = part[tmap[bj * nb + bi]][c % BK, r % BK]
    np.testing.assert_array_equal(out, S[:K, start:start + blk])
    blocks = sorted(j if mode == 1 else i for i, j, mode in tiles if mode)
    assert blocks == list(range(nb))
    lo, hi = start // BK, (start + blk - 1) // BK
    assert all(i >= j and (lo <= i <= hi or lo <= j <= hi)
               for i, j, _ in tiles)


# -------------------------------------------------------------- 2. draws
@pytest.mark.parametrize("variant", ["mc_hinge", "mc_svr", "mc_hinge-seed",
                                     "mc_svr-seed"])
def test_windowed_mc_draws_bitwise(variant):
    """The window narrows Sigma only: the MC gamma (and omega) are those of
    the full-width call and, for mc_hinge with noise, of the port's
    rowwise oracle ``augment.gamma_mc_rowwise``."""
    X, y, ys, w, _ = _problem(64, 16, seed=7)
    epi = variant.split("-")[0]
    rho, beta = ((ys, np.zeros_like(y)) if epi == "mc_svr" else (y, y))
    key, row0, eps = prng.PRNGKey(9), 17, 1e-6
    if variant == "mc_hinge":
        kw = dict(noise=taug.draw_ig_noise(key, 64, row0))
    elif variant == "mc_svr":
        kw = dict(noise=taug.draw_svr_noise(key, 64, row0))
    else:
        kw = dict(seed=trng.pack_seed(key, row0, 0))
    args = [_T(a) for a in (X, rho, beta, w)]
    full = tops.fused_stats(*args, None, epilogue=epi, eps=eps, **kw)
    win = tops.fused_stats(*args, None, epilogue=epi, eps=eps,
                           col_window=(4, 4), **kw)
    for a, b in zip(win[1:-2], full[1:-2]):
        assert torch.equal(a, b)
    if variant == "mc_hinge":
        want = taug.gamma_mc_rowwise(key, args[1] - args[0] @ args[3], eps,
                                     row0)
        assert torch.equal(win[1], want)


# ------------------------------------------------------ 3. 2 x 2 fits
_REF_CODE = """
import sys
import numpy as np
from repro import compat
from repro.core import PEMSVM, SVMConfig
from repro.core.nystrom import NystromSVM
from repro.data import make_circles, make_year_like
d = np.load(sys.argv[1])
X, y = d["X"], d["y"]
mesh = compat.make_mesh((2, 2), ("data", "k"), axis_types=("auto",) * 2)
out = {}
def rec(name, r):
    out[name + "_w"] = np.asarray(r.weights)
    out[name + "_obj"] = np.asarray(r.objective)
    out[name + "_it"] = r.n_iters
def fit(name, Xf, yf, **kw):
    rec(name, PEMSVM(SVMConfig(k_shard_axis="k", **kw), mesh=mesh).fit(
        Xf, yf))
fit("em_cls", X, y)
fit("mc_cls", X, y, algorithm="MC", rng="fused")
fit("pad", X, y, add_bias=False, pad_features=2)
Xs, ys = make_year_like(60_000, 90)
fit("em_svr", Xs[:50_000], ys[:50_000], task="SVR", lam=200.0, eps_ins=0.3,
    pad_features=2)
Xc, yc = make_circles(3000)
ny = NystromSVM(SVMConfig(formulation="KRN", lam=0.1, sigma=0.7,
                          k_shard_axis="k"), n_landmarks=55, mesh=mesh)
rec("krn_cls", ny.fit(Xc, yc))
out["krn_L"], out["krn_P"] = ny._landmarks, ny._proj
np.savez(sys.argv[2], **out)
"""

_PORT_CODE = """
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=240))
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.core import NystromSVM, PEMSVM, SVMConfig
from repro_torch.data import make_circles, make_year_like
d = np.load(out + "/inputs.npz")
X, y = d["X"], d["y"]
mesh = DeviceMesh("cpu", torch.arange(4).view(2, 2),
                  mesh_dim_names=("data", "k"))
res = {}
def rec(name, r):
    res[name + "_w"] = r.weights
    res[name + "_obj"] = np.asarray(r.objective)
    res[name + "_it"] = r.n_iters
def fit(name, Xf, yf, **kw):
    rec(name, PEMSVM(SVMConfig(k_shard_axis="k", **kw), device="cpu",
                     mesh=mesh).fit(Xf, yf))
    if rank == 0:
        rec(name + "_one", PEMSVM(SVMConfig(**kw), device="cpu").fit(Xf, yf))
fit("em_cls", X, y)
fit("mc_cls", X, y, algorithm="MC", rng="fused")
fit("pad", X, y, add_bias=False, pad_features=2)
Xs, ys = make_year_like(60_000, 90)
fit("em_svr", Xs[:50_000], ys[:50_000], task="SVR", lam=200.0, eps_ins=0.3,
    pad_features=2)
Xc, yc = make_circles(3000)
L, P = d["krn_L"], d["krn_P"]
kcfg = dict(formulation="KRN", lam=0.1, sigma=0.7)
rec("krn_cls", NystromSVM(SVMConfig(k_shard_axis="k", **kcfg),
                          n_landmarks=55, device="cpu", mesh=mesh
                          ).fit_featurized(Xc, yc, L, P))
if rank == 0:
    rec("krn_cls_one", NystromSVM(SVMConfig(**kcfg), n_landmarks=55,
                                  device="cpu").fit_featurized(Xc, yc, L, P))
try:
    PEMSVM(SVMConfig(add_bias=False, k_shard_axis="k", max_iters=2),
           device="cpu", mesh=mesh).fit(X, y)
    res["error"] = np.array("no error")
except ValueError as e:
    res["error"] = np.array(str(e))
np.savez(f"{out}/rank{rank}.npz", **res)
dist.destroy_process_group()
"""


def run_ranks(code: str, outdir: Path, world: int = 4,
              timeout: float = 600.0) -> list:
    """Run ``code`` as ``world`` gloo ranks (argv: rank, world, the file
    store, ``outdir``); if one fails, stop the others. Returns each rank's
    rank{r}.npz. A failure reports the ranks that failed on their own
    before those stopped after them."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    init = outdir / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), str(r), str(world),
         str(init), str(outdir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    failed: list = []
    while any(p.poll() is None for p in procs):
        failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if failed or time.monotonic() > deadline:
            for p in procs:
                p.kill()
            break
        time.sleep(0.1)
    logs = [p.communicate()[0] for p in procs]
    for r in failed + [r for r in range(world) if r not in failed]:
        assert procs[r].returncode == 0, \
            f"rank {r} (rc {procs[r].returncode}):\n{logs[r]}"
    return [dict(np.load(outdir / f"rank{r}.npz")) for r in range(world)]


def run_reference(code: str, args: list, n_devices: int = 4):
    """Start the reference's mesh fits in a JAX subprocess with
    ``n_devices`` emulated host devices; returns the Popen."""
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{n_devices}",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code),
                             *map(str, args)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def finish(proc, timeout: float = 600.0) -> None:
    log = proc.communicate(timeout=timeout)[0]
    assert proc.returncode == 0, log


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """The reference's 2 x 2 fits (they also give the Nystrom featurizer),
    then the port's on four gloo ranks."""
    out = tmp_path_factory.mktemp("kshard")
    X, y = make_alpha_like(4096, 23, seed=0)
    np.savez(out / "data.npz", X=X, y=y)
    finish(run_reference(_REF_CODE, [out / "data.npz", out / "ref.npz"]))
    ref = dict(np.load(out / "ref.npz"))
    np.savez(out / "inputs.npz", X=X, y=y, krn_L=ref["krn_L"],
             krn_P=ref["krn_P"])
    return ref, run_ranks(_PORT_CODE, out)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _trace_rel(a, b):
    n = min(len(a), len(b))
    a, b = np.asarray(a[:n], np.float64), np.asarray(b[:n], np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


CASES = ("em_cls", "mc_cls", "pad", "em_svr", "krn_cls")


@pytest.mark.parametrize("case", CASES)
def test_kshard_ranks_bitwise_equal(fits, case):
    ranks = fits[1]
    for r in ranks[1:]:
        assert np.array_equal(r[case + "_w"], ranks[0][case + "_w"])
        assert np.array_equal(r[case + "_obj"], ranks[0][case + "_obj"])


@pytest.mark.parametrize("case,trace_band", [
    ("em_cls", 2e-2), ("pad", 2e-2), ("em_svr", 5e-2), ("krn_cls", 2e-2)])
@pytest.mark.parametrize("against", ["reference", "one device"])
def test_kshard_em_fit_bands(fits, case, trace_band, against):
    ref, ranks = fits
    port = ranks[0]
    other = ref if against == "reference" else {
        k.replace("_one", ""): v for k, v in port.items() if "_one" in k}
    assert abs(int(port[case + "_it"]) - int(other[case + "_it"])) <= 3
    assert _trace_rel(port[case + "_obj"], other[case + "_obj"]) <= trace_band
    assert _rel(port[case + "_w"], other[case + "_w"]) <= 5e-2


def test_kshard_mc_chain(fits):
    """MC on the 2 x 2 mesh draws the one-device chain (its first
    objective equals the one-device fit's within 1e-6: the same draws)
    and lands within 0.15 of the reference's mesh fit and of the port's
    one-device fit."""
    ref, ranks = fits
    port = ranks[0]
    o, o1 = port["mc_cls_obj"], port["mc_cls_one_obj"]
    assert abs(o[0] - o1[0]) <= 1e-6 * abs(o1[0])
    assert _rel(port["mc_cls_w"], ref["mc_cls_w"]) <= 0.15
    assert _rel(port["mc_cls_w"], port["mc_cls_one_w"]) <= 0.15


def test_kshard_pad_features_zero_columns(fits):
    """K = 23 without bias pads to 24 for the 2-way k axis; the padded
    weight stays exactly 0 and the rest match the unpadded fit."""
    ref, ranks = fits
    w = ranks[0]["pad_w"]
    assert w.shape == (24,) and w[23] == 0.0
    assert ref["pad_w"].shape == (24,)
    assert ranks[0]["em_svr_w"].shape == (92,)


def test_kshard_indivisible_k_names_the_pad_helper(fits):
    for r in fits[1]:
        msg = str(r["error"])
        assert "does not divide" in msg and "pad_features_to" in msg, msg


def test_config_from_reference_carries_the_mesh_fields():
    import dataclasses
    from repro.core import SVMConfig as JaxConfig
    from repro_torch.core.convert import config_from_reference
    kw = dict(k_shard_axis="k", pad_features=2, triangle_reduce=False,
              reduce_dtype="bfloat16", eps=1e-3)
    cfg = config_from_reference(dataclasses.asdict(JaxConfig(**kw)))
    assert all(getattr(cfg, k) == v for k, v in kw.items())


@pytest.mark.parametrize("K,multiple", [(7, 4), (7, 7), (7, 1), (23, 2),
                                        (91, 2), (5, None)])
def test_pad_features_to_matches_reference(K, multiple):
    from repro.data.pipeline import pad_features_to as jpad
    from repro_torch.data import pad_features_to
    X = np.random.default_rng(K).normal(size=(5, K)).astype(np.float32)
    got, want = pad_features_to(X, multiple), jpad(X, multiple)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
