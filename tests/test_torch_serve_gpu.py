"""The serving path on the card: bucket and offset invariance of both score
cells, the scorer against ``decision_function``, the residency check and
``nystrom_score`` at the exact KRN model's P = 1.

Marked ``gpu``: without a CUDA device every test skips (the ``cuda``
fixture decides, never import time). Run on the card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_serve_gpu.py

This file imports no JAX. Gates, bitwise: a request's scores at every
bucket of the ladder (128 ... 1024, and chunks of 1024 past it) and at
several row offsets (singly and coalesced behind other requests in a
``ServeLoop``) equal the same rows of one large dispatch, for the linear
cell (LIN-EM-CLS, MLT, an MC-posterior model's uncertainty columns) and
the Nystrom cell (rbf and linear kind, MLT, the exact KRN model);
``decision_function`` of models fitted on the card equals the scorer.
``phi_never_materialized`` holds at bucket 1024 and ``nystrom_score``
launches once a dispatch. Banded: ``nystrom_score`` with P = 1 (exact
KRN's omega column) at m = 1,800 and 16,384 landmarks within
1e-5 (|k| @ |omega|) of float64.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import NystromSVM, PEMSVM, SVMConfig
from repro_torch.data import make_blobs, make_circles
from repro_torch.kernels import nystrom_phi as nys
from repro_torch.serving import (ServableModel, ServeLoop, SVMScorer,
                                 WeightPager, phi_never_materialized)

pytestmark = pytest.mark.gpu

SIZES = (1, 77, 128, 129, 256, 300, 512, 700, 1024, 1100, 2520)
OFFSETS = (0, 1, 5, 333)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rows(n=3000, d=11, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _models(seed=0):
    """Servable models of every cell configuration the tests hold."""
    rng = np.random.default_rng(seed)
    d = 11
    out = {
        "linear": ServableModel("cls", rng.normal(size=(d + 1, 1)), 1, d,
                                add_bias=True),
        "linear-mlt": ServableModel("mlt", rng.normal(size=(16, 3)), 3, d,
                                    add_bias=True),
        "linear-posterior": ServableModel(
            "cls", rng.normal(size=(d + 1, d + 2)), 1, d, add_bias=True),
    }
    for kind, m, C in (("rbf", 48, 1), ("rbf", 400, 10), ("linear", 37, 3)):
        out[f"nystrom-{kind}-{m}"] = ServableModel(
            "cls" if C == 1 else "mlt", rng.normal(size=(m + 1, C)), C, d,
            landmarks=_rows(m, d, seed + 1),
            proj=rng.normal(size=(m, m)) / m, phi_kind=kind,
            phi_sigma=3.0, phi_add_bias=True)
    Xk, _ = make_circles(1800, seed=seed)
    out["exact-krn"] = ServableModel(
        "cls", np.ones((1, 1)), 1, 2, landmarks=Xk,
        proj=rng.normal(size=(1800, 1)), phi_sigma=0.7)
    return out


@pytest.mark.parametrize("name", list(_models()))
def test_bucket_and_offset_invariance(cuda, name):
    model = _models()[name]
    X = _rows(3000, model.n_features, 3)
    sc = SVMScorer(model, device=cuda)
    oracle = sc.score(X[:2520 + 333])
    for n in SIZES:
        for j in OFFSETS:
            np.testing.assert_array_equal(sc.score(X[j:j + n]),
                                          oracle[j:j + n], err_msg=f"{n} {j}")
    pager = WeightPager(device=cuda)
    pager.register(model)
    loop = ServeLoop(pager)
    for filler in (1, 127, 128, 500, 900):
        f0 = loop.submit(model.name, X[:filler])
        f1 = loop.submit(model.name, X[1000:1100])
        assert loop.step() == 2
        np.testing.assert_array_equal(f0.result(timeout=30), oracle[:filler])
        np.testing.assert_array_equal(f1.result(timeout=30),
                                      oracle[1000:1100])


def test_threaded_loop_matches_single_dispatches(cuda):
    """The drain thread dispatches on the scorer's stream: coalesced
    results equal the requests served alone."""
    model = _models()["nystrom-rbf-400"]
    X = _rows(3000, 11, 4)
    pager = WeightPager(device=cuda)
    pager.register(model)
    alone = pager.scorer(model.name)
    loop = ServeLoop(pager, max_wait_ms=1.0).start()
    rng = np.random.default_rng(0)
    spans = [(int(j), int(n)) for j, n in zip(rng.integers(0, 2400, 64),
                                              rng.integers(1, 513, 64))]
    try:
        futs = [loop.submit(model.name, X[j:j + n]) for j, n in spans]
        outs = [f.result(timeout=60) for f in futs]
    finally:
        loop.stop()
    for (j, n), got in zip(spans, outs):
        np.testing.assert_array_equal(got, alone.score(X[j:j + n]))


def _fit_models(cuda):
    Xb, yb = make_blobs(2000, 11, seed=1)
    lin = PEMSVM(SVMConfig(max_iters=20), device=cuda)
    lin.fit(Xb, yb)
    X, y = make_circles(2000, seed=1)
    ny = NystromSVM(SVMConfig(formulation="KRN", lam=0.1, sigma=0.7,
                              max_iters=20), n_landmarks=300, device=cuda)
    ny.fit(X, y)
    krn = PEMSVM(SVMConfig(formulation="KRN", lam=0.1, sigma=0.7,
                           max_iters=10), device=cuda)
    krn.fit(X[:1800], y[:1800])
    return {"linear": (lin, Xb, yb), "nystrom": (ny, X, y),
            "exact-krn": (krn, X, y)}


def test_decision_function_is_the_scorer(cuda):
    from repro_torch.kernels import nystrom_phi
    for name, (model, X, y) in _fit_models(cuda).items():
        sc = model.scorer()
        before = nystrom_phi.LAUNCHES["nystrom_score"]
        f = model.decision_function(X)
        dispatches = -(-len(X) // sc.max_bucket)
        launched = nystrom_phi.LAUNCHES["nystrom_score"] - before
        assert launched == (0 if name == "linear" else dispatches), name
        np.testing.assert_array_equal(f, sc.margins(X))
        for n, j in ((1, 0), (300, 7), (1024, 900)):
            np.testing.assert_array_equal(sc.margins(X[j:j + n]),
                                          f[j:j + n])
        assert model.score(X, y) > 0.9, name
        if name != "linear":
            assert phi_never_materialized(sc, 1024), name
            assert phi_never_materialized(sc, 256), name
        assert model.scorer() is sc


@pytest.mark.parametrize("m", [1800, 16_384])
def test_nystrom_score_p1_against_float64(cuda, m):
    """The exact KRN model's cell: P = 1 (proj_operand pads it to four
    columns), D = 2 (the direct cross-Gram route)."""
    L, _ = make_circles(m, seed=2)
    X, _ = make_circles(1024, seed=3)
    omega = np.random.default_rng(m).normal(size=(m, 1)).astype(np.float32)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa
    W = T(np.ones((1, 1), np.float32))
    got = nys.nystrom_score(T(X), T(L), T(omega), W, sigma=0.7).cpu().numpy()
    X64, L64 = X.astype(np.float64), L.astype(np.float64)
    d2 = ((X64 ** 2).sum(1)[:, None] - 2 * X64 @ L64.T
          + (L64 ** 2).sum(1)[None])
    k = np.exp(-np.maximum(d2, 0.0) / (2 * 0.49))
    want = k @ omega.astype(np.float64)
    scale = np.abs(k) @ np.abs(omega.astype(np.float64))
    assert np.all(np.abs(got - want) <= 1e-5 * scale), \
        np.max(np.abs(got - want) / scale)
