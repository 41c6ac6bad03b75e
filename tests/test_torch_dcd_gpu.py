"""DCD's sweep kernel (``kernels/dcd.py``, ``csrc/dcd.cu``) against its
plain version, on the card.

Marked ``gpu``: without a CUDA device every test skips (the ``cuda``
fixture decides, never import time). Run on the card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_dcd_gpu.py

This file imports no JAX. Tolerance: w within 1e-5 of max|w| of the plain
version on the same inputs (the two differ only in the order each
coordinate's dot product is summed), alpha within 1e-5 of C; two calls
bitwise equal (one CTA, a fixed reduction order).

Beyond the shapes of the Table 5 path: each side of every route boundary
of ``dcd.plan`` (registers on one warp and on four, w in shared memory,
in global memory) and of a lane bucket, K % 4 = 1, 2 and 3 (rows off the
16-byte grid), N below, at and above the ring's depth and the lanes'
32-coordinate window over many epochs (alpha read again within the
prefetch distance of its write), and orders that name a row several
times in a row.
"""
import numpy as np
import pytest
import torch

from repro_torch.baselines.dcd import permutations
from repro_torch.kernels import dcd, ref

pytestmark = pytest.mark.gpu
REL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _problem(N, K, epochs, dev, seed=0):
    g = np.random.default_rng(seed)
    X = g.standard_normal((N, K)).astype(np.float32)
    X[:, -1] = 1.0                                   # the bias column
    y = np.where(g.standard_normal(N) + X[:, 0] > 0, 1.0, -1.0)
    X, y = torch.from_numpy(X).to(dev), torch.from_numpy(
        y.astype(np.float32)).to(dev)
    order = torch.from_numpy(permutations(seed, N, epochs)).to(dev)
    return X, y, torch.sum(X * X, dim=1), order


def _check(X, y, q, order, C):
    """Two kernel calls bitwise equal, one launch each, and both within
    the tolerance of the plain version on the same inputs."""
    n0 = dcd.LAUNCHES
    w, alpha = dcd.dcd_sweep(X, y, q, order, C)
    w2, alpha2 = dcd.dcd_sweep(X, y, q, order, C)
    torch.cuda.synchronize()
    assert dcd.LAUNCHES == n0 + 2
    assert torch.equal(w, w2) and torch.equal(alpha, alpha2)
    want_w, want_a = ref.dcd_sweep(X.cpu(), y.cpu(), q.cpu(), order.cpu(),
                                   C)
    err = (w.cpu() - want_w).abs().max() / want_w.abs().max()
    assert err <= REL, err
    assert (alpha.cpu() - want_a).abs().max() <= REL * C
    assert alpha.min() >= 0 and alpha.max() <= C


@pytest.mark.parametrize("N,K,epochs", [
    (2000, 20, 3), (1024, 801, 2), (256, 4097, 2),
    (48, dcd.SMEM_W_FLOATS + 1001, 1),
    # K % 4 = 2, 3 (801 is 1)
    (600, 802, 2), (600, 803, 2),
    # a lane bucket's edge, and each side of every route boundary
    (600, 32, 3), (600, 33, 3),
    (300, dcd.ONE_WARP_K, 2), (300, dcd.ONE_WARP_K + 1, 2),
    (200, dcd.REG_K, 2), (200, dcd.REG_K + 1, 2),
    (48, dcd.SMEM_W_FLOATS, 1), (48, dcd.SMEM_W_FLOATS + 1, 1)])
def test_sweep_matches_plain(cuda, N, K, epochs):
    _check(*_problem(N, K, epochs, cuda), 0.75)


@pytest.mark.parametrize("K", [801, dcd.ONE_WARP_K + 3, dcd.REG_K + 1])
@pytest.mark.parametrize("n,of_depth", [(3, False), (-1, True), (0, True),
                                        (1, True), (31, False), (32, False),
                                        (33, False), (64, False),
                                        (65, False)])
def test_small_n_many_epochs(cuda, K, n, of_depth):
    """N around the ring's depth D (N = D + n where ``of_depth``) and the
    32-coordinate window: each row comes back every N coordinates, inside
    the distance the kernel reads rows and alpha ahead."""
    D = dcd.plan(K).depth
    N = D + n if of_depth else n
    _check(*_problem(N, K, 20 if N <= D + 1 else 6, cuda, seed=N), 2.0)


@pytest.mark.parametrize("K", [803, dcd.ONE_WARP_K + 2, dcd.REG_K + 3])
def test_rows_named_again_in_a_row(cuda, K):
    """An order (any int32 order is accepted) that names one row several
    times in a row, across the window's 32-coordinate blocks."""
    X, y, q, _ = _problem(40, K, 1, cuda, seed=7)
    g = np.random.default_rng(7)
    rows = g.integers(0, 40, size=300)
    order = np.repeat(rows, g.integers(1, 6, size=300))[:700]
    _check(X, y, q, torch.from_numpy(order.astype(np.int32)).to(cuda), 1.5)


def test_nan_row_gives_nan_as_plain(cuda):
    X, y, q, order = _problem(200, 33, 1, cuda)
    X[17, 5] = float("nan")
    q = torch.sum(X * X, dim=1)
    w, alpha = dcd.dcd_sweep(X, y, q, order, 1.0)
    want_w, want_a = ref.dcd_sweep(X.cpu(), y.cpu(), q.cpu(), order.cpu(),
                                   1.0)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(w.cpu()), torch.isnan(want_w))
    assert torch.isnan(w).any()
    assert torch.equal(torch.isnan(alpha.cpu()), torch.isnan(want_a))


@pytest.mark.parametrize("bad", [-1, 40])
def test_order_outside_the_rows_raises(cuda, bad):
    X, y, q, order = _problem(40, 33, 1, cuda)
    order[7] = bad
    n0 = dcd.LAUNCHES
    with pytest.raises(ValueError, match="order names rows"):
        dcd.dcd_sweep(X, y, q, order, 1.0)
    assert dcd.LAUNCHES == n0
