"""Kill and resume on the card: the reliability surface of the port
(``SVMConfig.fault``, ``fit(resume_from=...)``) through the CUDA kernels.

Marked ``gpu``: without a CUDA device every test skips (the ``cuda``
fixture decides, never import time). Run on the card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_resume_gpu.py

This file imports no JAX. Gates: a fit preempted by ``runtime.faults``
and resumed from its last snapshot is BITWISE the uninterrupted fit on
the card for the scan, loop and stream drivers (the stream one killed
inside a pass, snapshots every 3 chunks), EM and MC, and for a Nystrom
fit; the resumed scan fit launches ``fused_stats`` once for each
iteration it runs; a fit without ``fault`` has the host syncs it had
before checkpoints existed (scan: one a chunk, <= ceil(max_iters /
scan_chunk); stream: one an iteration), and a fit with checkpoints on
has the same.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import NystromSVM, PEMSVM, SVMConfig, lam_from_C
from repro_torch.data import make_alpha_like, make_circles
from repro_torch.kernels import fused_stats, nystrom_phi
from repro_torch.runtime import FaultPolicy, faults

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def alpha():
    return make_alpha_like(20_000, 101, seed=0)


def _same(a, b):
    assert np.array_equal(a.weights, b.weights)
    assert np.array_equal(a.last_sample, b.last_sample)
    assert a.objective == b.objective and a.n_iters == b.n_iters


@pytest.mark.parametrize("driver,algo", [
    ("scan", "EM"), ("scan", "MC"), ("loop", "MC"), ("stream", "EM"),
    ("stream", "MC")])
def test_kill_resume_bitwise_on_the_card(cuda, alpha, driver, algo,
                                         tmp_path):
    X, y = alpha
    kw = dict(algorithm=algo, driver=driver, lam=lam_from_C(1.0),
              scan_chunk=4, chunk_rows=4096, max_iters=12, min_iters=12,
              burnin=3, rng="fused" if algo == "MC" else "host")
    ref = PEMSVM(SVMConfig(**kw), device=cuda).fit(X, y)
    cfg = SVMConfig(**kw, fault=FaultPolicy(
        ckpt_dir=str(tmp_path), ckpt_every=4, ckpt_chunks=3))
    with pytest.raises(faults.SimulatedPreemption):
        PEMSVM(cfg, device=cuda).fit(X, y,
                                     fault_hook=faults.kill_at_iteration(8))
    fused_stats.zero_launches()
    res = PEMSVM(cfg, device=cuda).fit(X, y, resume_from=str(tmp_path))
    _same(ref, res)
    assert res.n_host_syncs == ref.n_host_syncs
    launched = sum(fused_stats.LAUNCHES.values())
    if driver == "scan":
        assert res.resumed_at == 8 and launched == 12 - 8
    elif driver == "stream":
        # the last commit is iteration 8's mid-pass snapshot after 3 of
        # its 5 chunks: 2 chunks left of it, then 4 passes
        assert res.resumed_at == 7
        assert launched == 2 + 4 * 5


def test_host_syncs_unchanged_without_fault(cuda, alpha, tmp_path):
    X, y = alpha
    kw = dict(lam=lam_from_C(1.0), max_iters=40, scan_chunk=16)
    plain = PEMSVM(SVMConfig(**kw), device=cuda).fit(X, y)
    ckpt = PEMSVM(SVMConfig(**kw, fault=FaultPolicy(
        ckpt_dir=str(tmp_path), ckpt_every=1)), device=cuda).fit(X, y)
    assert plain.n_host_syncs == ckpt.n_host_syncs <= math.ceil(40 / 16)
    _same(plain, ckpt)
    strm = PEMSVM(SVMConfig(**kw, driver="stream", chunk_rows=8192),
                  device=cuda).fit(X, y)
    assert strm.n_host_syncs == strm.n_iters


def test_nystrom_kill_resume_bitwise_on_the_card(cuda, tmp_path):
    X, y = make_circles(20_000, seed=0)
    kw = dict(formulation="KRN", lam=0.1, sigma=0.7, max_iters=6,
              min_iters=6, scan_chunk=1)
    ref = NystromSVM(SVMConfig(**kw), n_landmarks=200, device=cuda)
    r_ref = ref.fit(X, y)
    cfg = SVMConfig(**kw, fault=FaultPolicy(ckpt_dir=str(tmp_path),
                                            ckpt_every=1))
    with pytest.raises(faults.SimulatedPreemption):
        NystromSVM(cfg, n_landmarks=200, device=cuda).fit(
            X, y, fault_hook=faults.kill_at_iteration(3))
    nystrom_phi.zero_launches()
    ny = NystromSVM(cfg, n_landmarks=200, device=cuda)
    res = ny.fit(X, y, resume_from=str(tmp_path))
    assert res.resumed_at == 3
    _same(r_ref, res)
    assert sum(nystrom_phi.LAUNCHES.values()) >= 3
    assert np.array_equal(ny.decision_function(X[:3000]),
                          ref.decision_function(X[:3000]))
