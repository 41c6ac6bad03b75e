"""The stream driver's host-to-device path on the card: the pinned,
side-stream chunk placer, the page-locked array source and the resident
set-up built on the device.

Marked ``gpu``: without a CUDA device every test skips (the ``cuda``
fixture decides, never import time). Run on the card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_stream_gpu.py

This file imports no JAX. Gates: stream fits bitwise equal across
``prefetch`` 1, 2 and 4 and across two runs, for both copy paths (the
staging ring of ``fit_chunks`` and the page-locked arrays of ``fit``);
an MLT fit (M + 1 passes an iteration, no host synchronize between
them) on the staging ring with every copy held back by a device sleep,
bitwise the fit without the sleeps at each depth; every chunk a consumer
reads is the chunk the host sent, while the consumer's stream is held
back by device sleeps and the caching allocator is churned between
chunks, and while the copies lag across two passes of one placer (what
``record_stream`` and the staging slots' events protect); the resident
set-up's matrix bitwise the host-built one.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core import PEMSVM, SVMConfig
from repro_torch.core import distributed
from repro_torch.data import (ChunkPrefetcher, DevicePlacer, PageLock,
                              make_blobs, make_mnist8m_like, pad_features_to,
                              rows_to_device)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


SLOW_COPY_CYCLES = 20_000_000  # ~10 ms at the H100's clock


@pytest.fixture
def slow_copies(monkeypatch):
    """Every chunk's copies wait behind a device sleep on the placer's side
    stream, so a copy out of a pinned slot lags far behind the host."""
    assemble = DevicePlacer._assemble

    def slow(self, *a, **k):
        torch.cuda._sleep(SLOW_COPY_CYCLES)
        return assemble(self, *a, **k)
    return lambda: monkeypatch.setattr(DevicePlacer, "_assemble", slow)


def _chunks(X, y, rows):
    """Full-width padded chunks (bias column = mask), as fit_chunks takes
    them."""
    Xb = np.concatenate([X, np.ones((len(X), 1), np.float32)], 1)
    Xp, tp, mp = distributed.pad_rows(Xb, y, 1, multiple=rows)

    def make():
        for i0 in range(0, Xp.shape[0], rows):
            yield Xp[i0:i0 + rows], tp[i0:i0 + rows], mp[i0:i0 + rows]
    return make, Xb.shape[1]


@pytest.mark.parametrize("source", ["arrays", "chunks"])
def test_stream_fit_bitwise_across_prefetch_and_runs(cuda, source):
    X, y = make_blobs(20_000, 40, seed=2)
    runs = []
    for prefetch in (1, 2, 4, 2):
        cfg = SVMConfig(driver="stream", chunk_rows=1024, prefetch=prefetch,
                        max_iters=6, min_iters=6)
        svm = PEMSVM(cfg, device=cuda)
        if source == "arrays":
            res = svm.fit(X, y)
        else:
            make, K = _chunks(X, y.astype(np.float32), 1024)
            res = svm.fit_chunks(make, K)
        assert res.n_host_syncs == res.n_iters == 6
        runs.append(res.weights)
    for w in runs[1:]:
        np.testing.assert_array_equal(w, runs[0])


def test_mlt_staging_ring_bitwise_with_lagging_copies(cuda, slow_copies):
    """MLT runs M + 1 passes an iteration with no host synchronize between
    them, so a pass's first chunks are staged while the last copies of
    the pass before may still read the same pinned slots: the placer's
    slot events must hold across passes. With every copy held back by a
    device sleep, the fit at prefetch 1, 2 and 4 is bitwise the fit
    without the sleeps."""
    X, labels = make_mnist8m_like(8_000, 63, 4, seed=5)
    make, K = _chunks(X, labels, 1024)

    def fit(prefetch):
        cfg = SVMConfig.from_options(
            "LIN-EM-MLT", num_classes=4, driver="stream", chunk_rows=1024,
            prefetch=prefetch, max_iters=3, min_iters=3)
        res = PEMSVM(cfg, device=cuda).fit_chunks(make, K)
        assert res.n_host_syncs == res.n_iters == 3
        return res.weights

    want = fit(2)
    slow_copies()
    for prefetch in (1, 2, 4):
        np.testing.assert_array_equal(fit(prefetch), want)


def test_stream_fit_matches_resident_on_the_card(cuda):
    """At eps 1e-2, the eps of the reference's own stream-against-scan
    tests. At the default 1e-6 the first card run put the two fits'
    weights 1.58e-2 apart after 8 iterations: rows near the hinge's knee
    weigh up to 1/eps, so the float32 reassociation of chunk sums against
    one resident sum is amplified far past this 1e-4 bound."""
    X, y = make_blobs(20_000, 40, seed=3)
    kw = dict(eps=1e-2, max_iters=8, min_iters=8)
    a = PEMSVM(SVMConfig(**kw), device=cuda).fit(X, y)
    b = PEMSVM(SVMConfig(driver="stream", chunk_rows=2048, **kw),
               device=cuda).fit(X, y)
    rel = np.abs(b.weights - a.weights).max() / np.abs(a.weights).max()
    assert rel <= 1e-4, rel
    assert b.peak_input_bytes == 4 * (2048 * 41 * 4 + 2 * 2048 * 4)


@pytest.mark.parametrize("pinned_source", [False, True])
@pytest.mark.parametrize("depth", [1, 3])
def test_placed_chunks_survive_allocator_churn(cuda, pinned_source, depth):
    """The consumer's stream lags behind the copies (a device sleep a
    chunk) while it allocates and frees blocks of the chunks' size: every
    chunk it reads must be the one the host sent, never a block the copy
    stream has reused or a staging slot overwritten too early."""
    rng = np.random.default_rng(0)
    n, rows, width = 48, 512, 33
    host = rng.normal(size=(n * rows, width - 1)).astype(np.float32)
    target = rng.normal(size=n * rows).astype(np.float32)
    placer = DevicePlacer(cuda, rows, width, width - 1,
                          pinned_source=pinned_source)

    def source():
        for i in range(n):
            sl = slice(i * rows, (i + 1) * rows)
            yield host[sl], target[sl], None

    sums = []
    with contextlib.ExitStack() as stack:
        if pinned_source:
            stack.enter_context(PageLock(cuda, host, target))
        for X, t, m in ChunkPrefetcher(source(), depth=depth, place=placer):
            torch.cuda._sleep(200_000)
            junk = [torch.empty_like(X).fill_(-7.0) for _ in range(3)]
            sums.append(torch.stack([X[:, :-1].double().sum(),
                                     X[:, -1].double().sum(),
                                     t.double().sum(), m.double().sum()]))
            del junk
        got = torch.stack(sums).cpu().numpy()
    want = np.stack([[host[i * rows:(i + 1) * rows].astype(np.float64).sum(),
                      rows, target[i * rows:(i + 1) * rows].astype(
                          np.float64).sum(), rows] for i in range(n)])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-6)


@pytest.mark.parametrize("depth", [1, 3])
def test_staging_slots_wait_across_passes(cuda, slow_copies, depth):
    """Two passes of one placer, as the stream driver makes them, with
    every copy held back by a device sleep: the second pass's worker must
    not stage into a pinned slot whose copy of the first pass is still
    queued. Every chunk the consumer reads is the one the host sent."""
    slow_copies()
    rng = np.random.default_rng(1)
    n, rows, width = 12, 512, 17
    host = rng.normal(size=(2, n * rows, width - 1)).astype(np.float32)
    placer = DevicePlacer(cuda, rows, width, width - 1)
    sums = []
    for p in range(2):
        def source(p=p):
            for i in range(n):
                Xi = host[p, i * rows:(i + 1) * rows]
                yield Xi, Xi[:, 0], None
        for X, t, m in ChunkPrefetcher(source(), depth=depth, place=placer):
            sums.append(torch.stack([X[:, :-1].double().sum(),
                                     t.double().sum()]))
    got = torch.stack(sums).cpu().numpy()
    want = np.stack([[host[p, i * rows:(i + 1) * rows].astype(
        np.float64).sum(), host[p, i * rows:(i + 1) * rows, 0].astype(
        np.float64).sum()] for p in range(2) for i in range(n)])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-6)


def test_page_lock_registers_and_unregisters(cuda):
    a = np.zeros((4096, 8), np.float32)
    with pytest.raises(ValueError, match="C-contiguous"):
        PageLock(cuda, a[:, ::2])
    for _ in range(2):          # unregistered on exit: registers again
        with PageLock(cuda, a):
            t = torch.from_numpy(a)
            assert t.is_pinned()
            d = torch.empty(a.shape, device=cuda).copy_(t, non_blocking=True)
        assert not torch.from_numpy(a).is_pinned()
    assert float(d.abs().sum()) == 0.0


@pytest.mark.parametrize("kw", [dict(), dict(add_bias=False),
                                dict(pad_features=8)])
def test_resident_setup_bitwise_the_host_assembly(cuda, kw):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(70_001, 37)).astype(np.float32)
    y = np.where(rng.random(70_001) < 0.5, 1.0, -1.0).astype(np.float32)
    svm = PEMSVM(SVMConfig(**kw), device=cuda)
    data, _ = svm._prepare(X, svm._targets(y))
    Xh = X
    if svm.config.add_bias:
        Xh = np.concatenate([Xh, np.ones((len(X), 1), np.float32)], 1)
    Xh = pad_features_to(Xh, svm.config.pad_features)
    want = distributed.shard_rows(None, Xh, y)
    for a, b in zip(data, want):
        assert torch.equal(a.cpu(), torch.from_numpy(b))


@pytest.mark.parametrize("block_bytes", [4096, 1 << 20, 64 << 20])
def test_rows_to_device_blocks(cuda, block_bytes):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(9_999, 21)).astype(np.float32)
    out = torch.full((10_000, 23), 3.0, device=cuda)
    rows_to_device(X, out, block_bytes=block_bytes)
    got = out.cpu().numpy()
    np.testing.assert_array_equal(got[:9_999, :21], X)
    assert np.all(got[9_999:] == 3.0) and np.all(got[:, 21:] == 3.0)
