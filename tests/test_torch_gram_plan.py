"""The host-side plan of the Gram engine (csrc/gram_pipe.cuh), on the CPU.

``_build.gram_plan`` cuts weighted_gram's rows into splits, one CTA per
(tile, split); ``_build.stat_plan`` does so for fused_stats' tile grid (C
chains), and ``nystrom_phi.stats_plan`` cuts the Nystrom statistic's rows
into splits and chunks of splits; ``_build.gram_copy`` picks how a stage
of X's rows is copied. None needs a card: the plans are arithmetic, and
the copy path reads only X's dtype, width and data pointer.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, fused_stats
from repro_torch.kernels import nystrom_phi as nys

PLANS = [(250_000, 16, 132), (1, 16, 132), (31, 1, 132), (33, 1, 132),
         (1000, 1, 132), (4099, 9, 132), (100_000, 9, 132),
         (131_072, 256, 132), (250_000, 289, 132), (463_715, 1, 132),
         (12_289, 4, 114), (4096, 1, 1), (10_000_000, 16, 132)]


@pytest.mark.parametrize("n,ntiles,sms", PLANS)
def test_gram_plan_covers_rows_once(n, ntiles, sms):
    nsplits, rows = _build.gram_plan(n, ntiles, sms)
    assert rows % _build.BN == 0 and 0 < rows <= _build.ROWS_PER_SPLIT
    # splits [s * rows, (s + 1) * rows) cover [0, n) once, none empty
    cover = np.zeros(n, dtype=np.int64)
    for s in range(nsplits):
        lo, hi = s * rows, min(n, (s + 1) * rows)
        assert lo < hi
        cover[lo:hi] += 1
    assert np.all(cover == 1)
    # two CTAs an SM, unless there are fewer 32-row stages than that
    assert nsplits * ntiles >= min(2 * sms, -(-n // _build.BN) * ntiles)


def test_gram_plan_fills_the_last_wave_at_table9():
    """250,000 x 500 (16 tiles) on 132 SMs: 99 splits of 2,528 rows are
    six full waves of 264 CTAs; 4,096-row splits left the fourth wave a
    quarter empty."""
    assert _build.gram_plan(250_000, 16, 132) == (99, 2528)
    nsplits, _ = _build.gram_plan(250_000, 16, 132)
    assert nsplits * 16 % 264 == 0


def test_gram_plan_random_sizes():
    g = np.random.default_rng(0)
    for _ in range(500):
        n = int(g.integers(1, 3_000_000))
        ntiles = int(g.choice([1, 4, 9, 16, 136, 153, 289]))
        sms = int(g.choice([1, 66, 114, 132]))
        nsplits, rows = _build.gram_plan(n, ntiles, sms)
        assert rows % _build.BN == 0 and rows <= _build.ROWS_PER_SPLIT
        assert (nsplits - 1) * rows < n <= nsplits * rows
        assert nsplits * ntiles >= min(2 * sms, -(-n // _build.BN) * ntiles)


@pytest.mark.parametrize("k,dtype,offset,want", [
    (500, torch.float32, 0, "f32x16"),  # Table 9: 16-byte copies
    (2048, torch.float32, 0, "f32x16"),  # phase 5
    (2049, torch.float32, 0, "f32x4"),  # phase 8: 4-byte copies
    (91, torch.float32, 0, "f32x4"),
    (8, torch.float32, 1, "f32x4"),  # X off 16-byte alignment
    (8, torch.float32, 4, "f32x16"),
    (29, torch.bfloat16, 0, "bf16"),  # bf16: the covering words
    (300, torch.bfloat16, 1, "bf16"),
])
def test_gram_copy_path(k, dtype, offset, want):
    buf = torch.zeros(8 * k + offset, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    X = buf[offset:].view(8, k)
    assert _build.GRAM_PATHS[_build.gram_copy(X)] == want


STAT_PLANS = [(250_000, 501, 1, 132), (250_000, 501, 4, 132),
              (125_000, 502, 1, 132), (62_504, 501, 1, 132),
              (463_715, 91, 1, 132), (231_864, 92, 1, 132),
              (1037, 29, 1, 132), (31, 130, 4, 132), (1, 1, 1, 132),
              (4099, 2049, 1, 114)]


@pytest.mark.parametrize("n,k,C,sms", STAT_PLANS)
def test_stat_plan_covers_rows_once(n, k, C, sms):
    ntiles, nsplits, rows = _build.stat_plan(n, k, C, sms)
    nb = -(-k // _build.BK)
    assert ntiles == nb * (nb + 1) // 2
    assert rows % _build.BN == 0 and 0 < rows <= _build.ROWS_PER_SPLIT
    assert (nsplits - 1) * rows < n <= nsplits * rows
    # two CTAs an SM, counting the chains, where N has the stages for it
    assert nsplits * ntiles * C >= min(2 * sms,
                                       -(-n // _build.BN) * ntiles * C)


def test_stat_plan_fills_the_waves_at_the_main_shapes():
    """250,000 x 501 on 132 SMs: 79 splits of 3,168 rows, 790 CTAs in
    three waves of 264 (tile_plan's 62 splits left 2.35); a rank's
    125,000 x 502: 52 splits, 520 CTAs in two; the year shape's one
    tile keeps 264 splits, one wave."""
    assert _build.stat_plan(250_000, 501, 1, 132) == (10, 79, 3168)
    assert _build.stat_plan(125_000, 502, 1, 132) == (10, 52, 2432)
    assert _build.stat_plan(463_715, 91, 1, 132) == (1, 264, 1760)


@pytest.mark.parametrize("n,k,window", [
    (125_000, 502, (0, 251)), (125_000, 502, (251, 251)),
    (231_864, 92, (46, 46)), (4099, 501, (500, 1)), (1037, 29, (5, 7))])
def test_window_runs_on_the_full_plan(n, k, window):
    """A column window of fused_stats runs over the full call's splits
    (so its columns are summed as the full call sums them), on the
    window's tiles of the full triangle."""
    ntiles, nsplits, rows, win = fused_stats.grid(n, k, 1, 132)
    assert (ntiles, nsplits, rows) == _build.stat_plan(n, k, 1, 132)
    got = fused_stats.grid(n, k, 1, 132, window, torch.device("cpu"))
    tiles, _ = _build.window_tiles(k, *window)
    assert got[1:3] == (nsplits, rows)
    assert got[0] == len(tiles) <= ntiles
    assert got[3][2:] == [-(-k // _build.BK), *window]


# (N, m, M): phase 7's rings, phase 10's year split and a rank's half of
# it, odd small shapes of the GPU tests.
NYS_PLANS = [(1_000_000, 1000, 1001), (463_715, 681, 682),
             (231_864, 681, 682), (203, 45, 46), (1037, 300, 301),
             (517, 257, 258), (1031, 255, 256), (70_001, 1023, 1024),
             (1, 1, 2)]


@pytest.mark.parametrize("scratch", [None, "small"])
@pytest.mark.parametrize("n,m,M", NYS_PLANS)
def test_stats_plan_covers_rows_once(n, m, M, scratch, monkeypatch):
    """Chunks are whole numbers of splits, the splits of every chunk
    together cover [0, n) once, and the split length does not depend on
    the scratch size (so a call cut into more chunks sums the same
    splits: the chunked calls of the GPU tests are bitwise the one-chunk
    call)."""
    ntiles, rows, chunk = nys.stats_plan(n, m, M, 132)
    if scratch:
        monkeypatch.setattr(nys, "SCRATCH_WORDS", 32 * M * 2)
    nt2, rows2, chunk2 = nys.stats_plan(n, m, M, 132)
    assert (nt2, rows2) == (ntiles, rows)
    assert rows % _build.BN == 0 and 0 < rows <= _build.ROWS_PER_SPLIT
    assert chunk2 % rows2 == 0
    assert chunk2 * max(m, M) <= max(nys.SCRATCH_WORDS, rows * max(m, M))
    cover = np.zeros(n, dtype=np.int64)
    for c0 in range(0, n, chunk2):
        nr = min(chunk2, n - c0)
        for s in range(-(-nr // rows)):
            lo, hi = c0 + s * rows, min(c0 + nr, c0 + (s + 1) * rows)
            assert lo < hi and lo % rows == 0
            cover[lo:hi] += 1
    assert np.all(cover == 1)


def test_stats_plan_fills_one_wave_a_chunk():
    """m = 1,000 (36 tiles) on 132 SMs: 7 splits of 4,096 rows a chunk,
    252 CTAs in one wave (8 splits, 288 CTAs, left 24 to a second); m =
    681 (21 tiles): 12 splits, 252 CTAs."""
    assert nys.stats_plan(1_000_000, 1000, 1001, 132) == (36, 4096, 28672)
    assert nys.stats_plan(463_715, 681, 682, 132) == (21, 4096, 49152)
    for n, m, M in NYS_PLANS[:3]:
        ntiles, rows, chunk = nys.stats_plan(n, m, M, 132)
        assert chunk // rows * ntiles <= 2 * 132
