"""DCD's sweep kernel (``kernels/dcd.py``, ``csrc/dcd.cu``) against its
plain version, on the card.

Marked ``gpu``: without a CUDA device every test skips (the ``cuda``
fixture decides, never import time). Run on the card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_dcd_gpu.py

This file imports no JAX. Tolerance: w within 1e-5 of max|w| of the plain
version on the same inputs (the two differ only in the order each
coordinate's dot product is summed), alpha within 1e-5 of C; two calls
bitwise equal (one CTA, a fixed reduction order).
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


@pytest.mark.parametrize("N,K,epochs", [(2000, 20, 3), (1024, 801, 2),
                                        (256, 4097, 2),
                                        (48, dcd.SMEM_W_FLOATS + 1001, 1)])
def test_sweep_matches_plain(cuda, N, K, epochs):
    X, y, q, order = _problem(N, K, epochs, cuda)
    C = 0.75
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
