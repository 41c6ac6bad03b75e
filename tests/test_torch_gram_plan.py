"""The host-side plan of the Gram engine (csrc/gram_pipe.cuh), on the CPU.

``_build.gram_plan`` cuts weighted_gram's rows into splits, one CTA per
(tile, split); ``_build.gram_copy`` picks how a stage of X's rows is
copied. Neither needs a card: the plan is arithmetic, and the copy path
reads only X's dtype, width and data pointer.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build

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
