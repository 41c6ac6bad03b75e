"""The launch plan of DCD's sweep kernel (``kernels/dcd.py::plan``) and
the alpha window of ``csrc/dcd.cu``, on the CPU.

The kernel itself runs only on the card (``tests/test_torch_dcd_gpu.py``);
this file holds what surrounds it: for every K from 1 to 70,000 the plan
names one route, a kernel that ``csrc/dcd.cu`` builds, a ring whose
stages cover any row's 16-byte aligned span, and a ring and w that fit a
CTA's shared memory; the plan's constants are the ``constexpr``s of the
source, read from it; and the scheme by which the chain's lanes load
alpha a block ahead and correct it from the coordinates' own writes reads
the last value written, for any order.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import dcd

SOURCE = (Path(dcd.__file__).resolve().parents[1] / "csrc" / "dcd.cu"
          ).read_text()
GRID = sorted(set(range(1, 5001)) | set(range(5001, 70_001, 7))
              | {dcd.SMEM_W_FLOATS + d for d in (-1, 0, 1, 2)}
              | {70_000})


def _constexprs():
    ints = {m[1]: int(m[2]) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", SOURCE)}
    lanes = re.search(r"constexpr int LANE_FLOATS\[\] = \{([\d, ]+)\};",
                      SOURCE)
    return ints, tuple(int(v) for v in lanes[1].split(","))


def test_constants_are_the_sources():
    ints, lanes = _constexprs()
    names = ("SMEM_BYTES", "STATIC_BYTES", "MAX_DEPTH", "ONE_WARP_K",
             "GROUP_WARPS", "REG_K", "WIDE_WARPS", "PIECE_FLOATS",
             "SMEM_W_FLOATS")
    assert set(ints) == set(names)
    for name in names:
        assert getattr(dcd, name) == ints[name], name
    assert dcd.LANE_FLOATS == lanes
    assert dcd.SMEM_BYTES == 232_448          # an H100 CTA's opt-in limit


def test_static_shared_memory_within_its_share():
    # full[MAX_DEPTH], empty[MAX_DEPTH] (8 bytes each), part[2][warps]
    assert 16 * dcd.MAX_DEPTH + 8 * dcd.WIDE_WARPS <= dcd.STATIC_BYTES


def test_every_k_has_one_route():
    for K in GRID:
        p = dcd.plan(K)
        want = ("registers" if K <= dcd.REG_K else
                "shared" if K <= dcd.SMEM_W_FLOATS else "global")
        assert p.route == want, K
        assert p.route in dcd.ROUTES
        if p.route == "registers":
            assert p.warps == (1 if K <= dcd.ONE_WARP_K
                               else dcd.GROUP_WARPS), K
            need = -(-K // (32 * p.warps))
            assert p.lane_floats == min(b for b in dcd.LANE_FLOATS
                                        if b >= need), K
            assert p.smem_w == 0
        else:
            assert (p.warps, p.lane_floats) == (dcd.WIDE_WARPS, 0), K
            assert p.smem_w == (K if p.route == "shared" else 0), K
        assert 32 * (p.warps + 1) <= 1024      # the producer is one more


def test_ring_and_w_fit_shared_memory():
    for K in GRID:
        p = dcd.plan(K)
        assert 0 < p.smem_bytes <= dcd.SMEM_BYTES - dcd.STATIC_BYTES, K
        assert p.smem_bytes == 4 * (p.depth * p.stage + p.smem_w)
        assert p.smem_bytes + dcd.STATIC_BYTES <= 232_448, K


def test_stage_covers_any_rows_span():
    """A stage takes the 16-byte aligned span that covers a row (or a
    piece of one), whatever word of its 16-byte chunk the row starts at."""
    for K in GRID:
        p = dcd.plan(K)
        width = K if p.route == "registers" else dcd.PIECE_FLOATS
        assert p.stage % 4 == 0, K
        for off in range(4):
            for length in {min(width, K), K % width or width}:
                assert -(-(off + length) // 4) * 4 <= p.stage, (K, off)


def test_ring_depth():
    """Deep enough to cover a row's read at the chain's rate: the whole
    ring on the one-warp route, at least four stages elsewhere."""
    for K in GRID:
        p = dcd.plan(K)
        assert 4 <= p.depth <= dcd.MAX_DEPTH, K
        if K <= dcd.ONE_WARP_K:
            assert p.depth == dcd.MAX_DEPTH, K
    assert dcd.plan(801).depth >= 8


def test_warps_override_for_the_layout_probe():
    p = dcd.plan(801, warps=dcd.GROUP_WARPS)
    assert (p.route, p.warps, p.lane_floats) == ("registers", 4, 8)
    assert dcd.plan(801, warps=1) == dcd.plan(801)
    with pytest.raises(ValueError):
        dcd.plan(801, warps=2)
    with pytest.raises(ValueError):
        dcd.plan(2048, warps=1)          # 64 floats a lane: no kernel
    with pytest.raises(ValueError):
        dcd.plan(0)


def _window_reads(order, stale, match_last=True):
    """The alpha each coordinate reads under csrc/dcd.cu's window: lanes
    hold the rows of the current and the next block of 32 coordinates;
    a block's alpha is loaded when the block before it begins, and that
    load sees only the writes made ``stale`` or more coordinates before
    it (2: the chain barrier of several warps orders all but the last
    write; the last is matched against the new window, as the kernel's
    ``ilast``, unless ``match_last`` is off). Every coordinate's new value
    (here t + 1) is recorded against the window entries of its row."""
    steps = len(order)
    log = []                         # (t, row, value) of every write

    def load(block, at):
        rows = [int(order[u]) if u < steps else -1
                for u in range(32 * block, 32 * block + 32)]
        seen = {row: v for t, row, v in log if t <= at - stale}
        return [rows, [seen.get(r, 0.0) for r in rows], [None] * 32]

    cur, nxt = load(0, 0), load(1, 0)
    last = (-1, 0.0)
    reads = []
    for t in range(steps):
        src = t % 32
        if src == 0 and t > 0:
            cur, nxt = nxt, load(t // 32 + 1, t)
            if match_last:
                nxt[2] = [last[1] if r == last[0] and r >= 0 else None
                          for r in nxt[0]]
        i = cur[0][src]
        a = cur[2][src] if cur[2][src] is not None else cur[1][src]
        reads.append(a)
        a_new = float(t + 1)
        log.append((t, i, a_new))
        for win in (cur, nxt):
            win[2] = [a_new if r == i else o for r, o in zip(win[0], win[2])]
        last = (i, a_new)
    return reads


def _sequential_reads(order):
    mem, reads = {}, []
    for t, i in enumerate(order):
        reads.append(mem.get(int(i), 0.0))
        mem[int(i)] = float(t + 1)
    return reads


def _orders():
    g = np.random.default_rng(5)
    out = {f"perm N={n}": np.concatenate([g.permutation(n)
                                          for _ in range(300 // n + 3)])
           for n in (1, 2, 3, 15, 16, 17, 31, 32, 33, 63, 64, 65, 100)}
    rows = g.integers(0, 12, size=200)
    out["runs"] = np.repeat(rows, g.integers(1, 6, size=200))
    out["one row"] = np.zeros(130, dtype=np.int64)
    out["stride 32"] = np.arange(200) % 32
    return out


@pytest.mark.parametrize("name", list(_orders()))
@pytest.mark.parametrize("stale", [1, 2])
def test_window_reads_the_last_write(name, stale):
    order = _orders()[name]
    assert _window_reads(order, stale) == _sequential_reads(order)


def test_window_needs_the_last_write_matched():
    """Without matching the last write against a new window, a load two
    coordinates stale reads an old alpha: the model can fail."""
    orders = _orders().values()
    assert all(_window_reads(o, 1, match_last=False)
               == _sequential_reads(o) for o in orders)
    assert any(_window_reads(o, 2, match_last=False)
               != _sequential_reads(o) for o in orders)
