"""The port's serving path (``repro_torch.serving``: ServableModel,
SVMScorer, WeightPager, ServeLoop, phi_never_materialized;
``export_servable`` / ``scorer`` / ``decision_function`` of PEMSVM and
NystromSVM) against the JAX package's, on the CPU.

Tolerances, each with its reason:

* served scores against the reference's SVMScorer on the same
  ServableModel (carried across by ``convert.servable_from_reference``):
  |d score| <= 1e-5 (|phi| @ |W|) elementwise, phi the (biased, padded)
  row or the Nystrom features, the bound of tests/test_torch_nystrom.py
  (a dot product with mixed-sign terms errs with the sum of their
  magnitudes);
* within the port: bitwise. A request's scores do not depend on its
  bucket (128 ... 1024, and chunks of 1024 past it), on its row offset in
  a coalesced batch, or on what shares the batch; ``decision_function``
  is the scorer's;
* the pager's hits, misses, evictions and resident set: exactly the
  reference pager's on the same event sequence;
* std columns against a float64 Sigma oracle computed in the port (the
  reference fails its own oracle tests,
  ``test_svm_serving.py::test_mc_uncertainty_*``, so the port is not held
  to them): the oracle takes the port's own float32 E-step margins, so it
  differs only by S's float32 accumulation, |dS| <= N 2^-24 |S|; std^2 is
  a quadratic form in P^{-1}, so |d std| / std <= 1/2 cond(P) N 2^-24;
* the multichain ensemble's std against ``np.std(ddof=1)`` of the chain
  margins in float64: 1e-5 of the columns' |x| @ |U| scale.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro.core import PEMSVM as JaxSVM
from repro.core import SVMConfig as JaxConfig
from repro.core.nystrom import NystromSVM as JaxNystrom
from repro.serving import SVMScorer as JaxScorer
from repro.serving import WeightPager as JaxPager
from repro_torch.core import NystromSVM, PEMSVM, SVMConfig
from repro_torch.core import kernel as tkernel
from repro_torch.core.convert import servable_from_reference
from repro_torch.kernels import ops
from repro_torch.serving import (DeadlineExceeded, ServableModel, ServeLoop,
                                 ServeRejected, SVMScorer, WeightPager,
                                 phi_never_materialized)

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Keep torch to two intra-op threads: the suite runs six workers at
    once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _problem(task, n=420, d=11, m=3, seed=0):
    """The reference's serving-test problem (tests/test_svm_serving.py)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d)
    if task == "SVR":
        y = (X @ w + 0.05 * rng.normal(size=n)).astype(np.float32)
    elif task == "MLT":
        y = np.argmax(X @ rng.normal(size=(m, d)).T, 1).astype(np.int32)
    else:
        y = np.where(X @ w > 0, 1.0, -1.0).astype(np.float32)
    return X, y


def _cfg(cls, task, family, **kw):
    if family == "linear":
        return cls(task=task, num_classes=3, max_iters=25, **kw)
    return cls(formulation="KRN", task=task, num_classes=3, sigma=3.0,
               lam=0.1, max_iters=25, **kw)


def _port_fit(task, family, **kw):
    X, y = _problem(task)
    if family == "linear":
        model = PEMSVM(_cfg(SVMConfig, task, family, **kw), device="cpu")
    else:
        model = NystromSVM(_cfg(SVMConfig, task, family, **kw),
                           n_landmarks=24, device="cpu")
    model.fit(X, y)
    return model, X, y


def _ref_fit(task, family):
    X, y = _problem(task)
    if family == "linear":
        model = JaxSVM(_cfg(JaxConfig, task, family))
    else:
        model = JaxNystrom(_cfg(JaxConfig, task, family), n_landmarks=24)
    model.fit(X, y)
    return model, X, y


def _fields(model) -> dict:
    return {f.name: (np.asarray(getattr(model, f.name))
                     if f.name in ("weights", "landmarks", "proj")
                     and getattr(model, f.name) is not None
                     else getattr(model, f.name))
            for f in dataclasses.fields(model)}


def _scale(m: ServableModel, X: np.ndarray) -> np.ndarray:
    """|phi| @ |W| in float64: the served rows' bound scale."""
    X = X.astype(np.float64)
    if m.family == "linear":
        phi = X
        if m.add_bias:
            phi = np.hstack([phi, np.ones((len(X), 1))])
        phi = np.hstack([phi, np.zeros((len(X), m.weights.shape[0]
                                         - phi.shape[1]))])
    else:
        L = m.landmarks.astype(np.float64)
        d2 = ((X[:, None] - L[None]) ** 2).sum(-1)
        k = np.exp(-d2 / (2 * m.phi_sigma ** 2))
        phi = np.abs(k) @ np.abs(m.proj.astype(np.float64))
        if m.phi_add_bias:
            phi = np.hstack([phi, np.ones((len(X), 1))])
    return np.abs(phi) @ np.abs(m.weights.astype(np.float64))


def _within(got, want, scale):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= REL * scale), np.max(err - REL * scale)


# ------------------------------------------------- against the reference
@pytest.mark.parametrize("task", ["CLS", "SVR", "MLT"])
@pytest.mark.parametrize("family", ["linear", "nystrom"])
def test_served_scores_match_reference_scorer(task, family):
    ref, X, _ = _ref_fit(task, family)
    rm = ref.export_servable(name="m")
    tm = servable_from_reference(_fields(rm))
    assert (tm.family, tm.n_outputs, tm.n_features) == (
        rm.family, rm.n_outputs, rm.n_features)
    assert tm.nbytes == rm.nbytes and tm.has_uncertainty == \
        rm.has_uncertainty
    want = JaxScorer(rm).score(X)
    got = SVMScorer(tm, device="cpu").score(X)
    assert got.shape == want.shape and got.dtype == np.float32
    _within(got, want, _scale(tm, X))


def test_exact_krn_serves_like_reference():
    """The exact-Gram model rides the Nystrom score cell in both packages
    (landmarks = the training rows, proj = omega[:, None], W = [[1.]])."""
    rng = np.random.default_rng(1)
    r = np.concatenate([rng.uniform(0, 1, 100), rng.uniform(1.5, 2.5, 100)])
    th = rng.uniform(0, 2 * np.pi, 200)
    X = np.stack([r * np.cos(th), r * np.sin(th)], 1).astype(np.float32)
    y = np.concatenate([np.ones(100), -np.ones(100)]).astype(np.float32)
    kw = dict(formulation="KRN", lam=0.1, sigma=0.7, max_iters=25)
    ref = JaxSVM(JaxConfig(**kw))
    ref.fit(X, y)
    rm = ref.export_servable()
    tm = servable_from_reference(_fields(rm))
    assert tm.family == "nystrom" and tm.weights.shape == (1, 1)
    _within(SVMScorer(tm, device="cpu").margins(X),
            JaxScorer(rm).margins(X), _scale(tm, X)[:, 0])
    # the port's own exact KRN: served through the cell, within the bound
    # of the cross-Gram x omega route and of float64
    port = PEMSVM(SVMConfig(**kw), device="cpu")
    port.fit(X, y)
    pm = port.export_servable()
    assert pm.landmarks.shape == (200, 2) and pm.proj.shape == (200, 1)
    f = port.decision_function(X)
    np.testing.assert_array_equal(f, SVMScorer(pm, device="cpu").margins(X))
    omega = port._weights[:200]
    old = tkernel.decision_function(omega, port._train_X,
                                    torch.from_numpy(X), kind="rbf",
                                    sigma=0.7).numpy()
    _within(f, old, _scale(pm, X)[:, 0])
    X64 = X.astype(np.float64)
    k64 = np.exp(-((X64[:, None] - X64[None]) ** 2).sum(-1) / (2 * 0.49))
    _within(f, k64 @ pm.proj[:, 0].astype(np.float64), _scale(pm, X)[:, 0])
    assert port.score(X, y) > 0.95


# --------------------------------------------------------- bucket bits
@pytest.mark.parametrize("task", ["CLS", "SVR", "MLT"])
@pytest.mark.parametrize("family", ["linear", "nystrom"])
def test_bucket_and_offset_invariance(task, family):
    """Every bucket of the ladder and every row offset give a request the
    same bits: singly, coalesced behind other requests in one dispatch,
    and in 1,024-row chunks past the largest bucket."""
    model, X, _ = _port_fit(task, family)
    Xbig = np.concatenate([X] * 6)             # 2,520 rows: 3 chunks
    oracle = model.decision_function(Xbig)
    sc = model.scorer()
    k = 1 if task != "MLT" else 3

    def flat(s):
        return s[:, 0] if k == 1 else s[:, :k]

    for n in (1, 77, 128, 129, 300, 420, 700, 1024, 1100, 2520):
        for j in (0, 5, 333):
            got = flat(sc.score(Xbig[j:j + n]))
            np.testing.assert_array_equal(got, oracle[j:j + n])
    pager = WeightPager(device="cpu")
    pager.register(model.export_servable(name="m"))
    loop = ServeLoop(pager)
    for filler in (1, 127, 128, 500, 900):
        f0 = loop.submit("m", Xbig[:filler])
        f1 = loop.submit("m", Xbig[1000:1100])
        assert loop.step() == 2
        np.testing.assert_array_equal(flat(f0.result(timeout=5)),
                                      oracle[:filler])
        np.testing.assert_array_equal(flat(f1.result(timeout=5)),
                                      oracle[1000:1100])


def test_decision_function_is_the_scorer():
    for family in ("linear", "nystrom"):
        model, X, _ = _port_fit("CLS", family)
        sc = model.scorer()
        np.testing.assert_array_equal(model.decision_function(X),
                                      sc.margins(X))
        np.testing.assert_array_equal(model.predict(X), sc.predict(X))
        assert model.scorer() is sc


def test_no_cell_rebuilt_at_a_seen_bucket():
    """Repeat calls at a seen bucket build nothing, and a second model of
    the same configuration reuses the shared cell; a refit makes a new
    scorer on the same cell."""
    X, y = _problem("CLS", n=300, d=19)
    svm = PEMSVM(SVMConfig(max_iters=20), device="cpu")
    svm.fit(X, y)
    s = svm.scorer()
    t0 = s.traces
    svm.decision_function(X[:90])
    t1 = s.traces
    assert t1 - t0 <= 1
    for n in (90, 90, 17, 128, 1):
        svm.decision_function(X[:n])
    assert s.traces == t1, "rebuilt at a seen bucket"
    assert svm.scorer() is s, "scorer rebuilt without a refit"
    svm2 = PEMSVM(SVMConfig(max_iters=20), device="cpu")
    svm2.fit(X, y)
    assert svm2.scorer() is not s
    svm2.decision_function(X[:50])
    assert svm2.scorer().traces == t1, "same-config model rebuilt"
    assert svm2.scorer()._cell is s._cell
    svm.fit(X, y)
    assert svm.scorer() is not s
    svm.decision_function(X[:90])
    assert svm.scorer().traces == t1


def test_nystrom_no_rebuild():
    ny, X, _ = _port_fit("CLS", "nystrom")
    s = ny.scorer()
    ny.decision_function(X[:40])
    t = s.traces
    for n in (40, 128, 3):
        ny.decision_function(X[:n])
    assert s.traces == t


def test_phi_never_materialized_on_the_cpu():
    """The plain version builds phi, so on the CPU the check says so for
    the Nystrom family; the linear family has no phi."""
    ny, _, _ = _port_fit("CLS", "nystrom")
    assert phi_never_materialized(ny.scorer(), 512) is False
    lin, _, _ = _port_fit("CLS", "linear")
    assert phi_never_materialized(lin.scorer(), 512) is True


# --------------------------------------------------------------- pager
_EVENTS = [("reg", "a"), ("reg", "b"), ("reg", "c"), ("reg", "d"),
           ("get", "a"), ("get", "a"), ("get", "b"), ("get", "c"),
           ("get", "d"), ("get", "a"), ("reg", "c"), ("get", "c"),
           ("get", "b"), ("get", "b"), ("reg", "a"), ("get", "d"),
           ("get", "a"), ("get", "c"), ("get", "e"), ("get", "b")]


def test_pager_counts_match_reference():
    svm, _, _ = _port_fit("CLS", "linear")
    base = svm.export_servable()
    jp, tp = JaxPager(max_resident=2), WeightPager(max_resident=2,
                                                   device="cpu")
    for i, (ev, name) in enumerate(_EVENTS):
        if ev == "reg":
            kw = dict(task=base.task, weights=base.weights * (i + 1),
                      n_outputs=1, n_features=base.n_features,
                      add_bias=True, name=name)
            from repro.serving import ServableModel as JaxModel
            jp.register(JaxModel(**kw))
            tp.register(ServableModel(**kw))
        else:
            outs = []
            for p in (jp, tp):
                try:
                    outs.append(p.scorer(name).model.name)
                except KeyError:
                    outs.append(KeyError)
            assert outs[0] == outs[1]
        assert (tp.hits, tp.misses, tp.evictions) == (
            jp.hits, jp.misses, jp.evictions), i
        assert tp.resident_names == jp.resident_names, i
        assert tp.model_names == jp.model_names
        assert tp.resident_bytes == jp.resident_bytes


def test_pager_lru_and_stale_eviction():
    svm, X, _ = _port_fit("CLS", "linear")
    base = svm.export_servable()
    pager = WeightPager(max_resident=2, device="cpu")
    for name in ("a", "b", "c"):
        pager.register(dataclasses.replace(base, name=name))
    assert pager.scorer("a") is pager.scorer("a")
    assert pager.hits == 1 and pager.misses == 1
    pager.scorer("b")
    pager.scorer("c")                       # evicts "a" (LRU)
    assert pager.resident_names == ["b", "c"] and pager.evictions == 1
    s_b = pager.scorer("b")
    pager.register(dataclasses.replace(base, name="b",
                                       weights=base.weights * 2.0))
    s_b2 = pager.scorer("b")
    assert s_b2 is not s_b
    np.testing.assert_array_equal(s_b2.score(X[:8]),
                                  2.0 * s_b.score(X[:8]))
    with pytest.raises(KeyError):
        pager.scorer("nope")
    np.testing.assert_array_equal(pager.scorer("a").score(X[:32]),
                                  pager.scorer("c").score(X[:32]))


# ---------------------------------------------------------- serve loop
def _loop_model():
    svm, X, _ = _port_fit("CLS", "linear")
    pager = WeightPager(device="cpu")
    pager.register(svm.export_servable(name="m"))
    return svm, X, pager


def test_serve_loop_threaded_and_errors():
    svm, X, pager = _loop_model()
    loop = ServeLoop(pager, max_wait_ms=1.0).start()
    try:
        futs = [loop.submit("m", X[i * 20:(i + 1) * 20]) for i in range(8)]
        bad = loop.submit("missing", X[:4])
        outs = [f.result(timeout=10) for f in futs]
        with pytest.raises(KeyError):
            bad.result(timeout=10)
    finally:
        loop.stop()
    np.testing.assert_array_equal(np.concatenate(outs)[:, 0],
                                  svm.decision_function(X[:160]))
    assert loop.n_requests == 8 and loop.n_rows == 160
    assert len(loop.latencies_ms) == 8
    q = loop.latency_quantiles()
    assert q["p50_ms"] is not None and q["p99_ms"] >= q["p50_ms"]


def test_serve_loop_synchronous_coalesces_one_dispatch():
    svm, X, pager = _loop_model()
    loop = ServeLoop(pager)
    sizes = [1, 77, 130, 212]
    futs, i = [], 0
    for s in sizes:
        futs.append(loop.submit("m", X[i:i + s]))
        i += s
    assert loop.step() == len(sizes)
    assert loop.n_batches == 1 and loop.n_rows == 420
    np.testing.assert_array_equal(
        np.concatenate([f.result(timeout=5) for f in futs])[:, 0],
        svm.decision_function(X))
    assert loop.step() == 0
    assert ServeLoop(pager).latency_quantiles()["p50_ms"] is None
    wide = loop.submit("m", np.ones((3, 12), np.float32))
    assert loop.step() == 1
    with pytest.raises(ValueError, match="expects"):
        wide.result(timeout=5)


def test_bounded_intake_sheds_with_explicit_rejection():
    svm, X, pager = _loop_model()
    loop = ServeLoop(pager, max_queue=2)
    f1 = loop.submit("m", X[:4])
    f2 = loop.submit("m", X[4:8])
    f3 = loop.submit("m", X[8:12])
    assert f3.done()
    with pytest.raises(ServeRejected, match="capacity"):
        f3.result()
    assert loop.n_rejected == 1
    assert loop.step() == 2
    np.testing.assert_array_equal(
        np.concatenate([f1.result(timeout=5), f2.result(timeout=5)])[:, 0],
        svm.decision_function(X[:8]))
    f4 = loop.submit("m", X[:2])
    assert loop.step() == 1 and f4.result(timeout=5).shape[0] == 2
    q = loop.latency_quantiles()
    assert q["rejected"] == 1 and q["expired"] == 0


def test_deadlines_expire_at_drain():
    svm, X, pager = _loop_model()
    loop = ServeLoop(pager, default_deadline_ms=1.0)
    doomed = loop.submit("m", X[:4])
    doomed2 = loop.submit("m", X[:4], deadline_ms=1.0)
    patient = loop.submit("m", X[4:8], deadline_ms=60_000.0)
    time.sleep(0.05)
    assert loop.step() == 3
    assert loop.n_requests == 1 and loop.n_expired == 2
    for f in (doomed, doomed2):
        with pytest.raises(DeadlineExceeded, match="expired"):
            f.result()
    np.testing.assert_array_equal(patient.result(timeout=5)[:, 0],
                                  svm.decision_function(X[4:8]))
    assert loop.latency_quantiles()["expired"] == 2


def test_scorer_rejects_wrong_width():
    svm, X, _ = _port_fit("CLS", "linear")
    with pytest.raises(ValueError, match="expects"):
        svm.scorer().score(X[:5, :-1])
    with pytest.raises(ValueError, match="expected|expects"):
        svm.decision_function(X[:5, :-1])
    narrow = ServableModel(task="cls", weights=np.ones((5, 1), np.float32),
                           n_outputs=1, n_features=5, add_bias=True)
    with pytest.raises(ValueError, match="exceeds the model's fitted"):
        SVMScorer(narrow, device="cpu").score(X[:3, :5])


def test_padded_biased_linear_parity():
    """add_bias + pad_features: the cell's prep (bias column first, then
    zero columns) scores as the host-built padded row does."""
    X, y = _problem("CLS", d=13)
    svm = PEMSVM(SVMConfig(max_iters=25, pad_features=8), device="cpu")
    svm.fit(X, y)
    m = svm.export_servable()
    assert m.weights.shape == (16, 1) and m.n_features == 13
    Xb = np.concatenate([X, np.ones((len(X), 1), np.float32)], 1)
    Xb = np.pad(Xb, ((0, 0), (0, 2)))
    _within(svm.decision_function(X), Xb.astype(np.float64)
            @ m.weights[:, 0].astype(np.float64), _scale(m, X)[:, 0])
    svm._n_features = 16                     # preps to 17 columns
    svm._scorer_cache = None
    with pytest.raises(ValueError, match="preps to"):
        svm.export_servable()


def test_mlt_posterior_refused():
    svm, X, y = _port_fit("MLT", "linear")
    with pytest.raises(NotImplementedError, match="MLT posterior"):
        svm.export_servable(posterior_from=(X, y))
    k = PEMSVM(SVMConfig(formulation="KRN", max_iters=3), device="cpu")
    k.fit(X[:64], np.where(X[:64, 0] > 0, 1.0, -1.0))
    with pytest.raises(NotImplementedError, match="exact-Gram"):
        k.export_servable(posterior_from=(X, y))


# --------------------------------------------------------- uncertainty
def _std_oracle(phi64, P):
    sol = np.linalg.solve(P, phi64.T)
    return np.sqrt(np.sum(phi64.T * sol, axis=0))


@pytest.mark.parametrize("family", ["linear", "nystrom"])
@pytest.mark.parametrize("task", ["CLS", "SVR"])
def test_std_columns_against_a_float64_sigma_oracle(family, task):
    kw = dict(lam=0.5, eps=1e-2) if family == "linear" else dict(eps=1e-2)
    model, X, y = _port_fit(task, family, **kw)
    svm = model if family == "linear" else model.svm
    cfg = svm.config
    sm = model.export_servable(posterior_from=(X, y))
    assert sm.has_uncertainty
    sc = SVMScorer(sm, device="cpu")
    margin, std = sc.score_with_std(X[:200])
    plain = model.export_servable()
    _within(margin, model.decision_function(X[:200]),
            _scale(plain, X[:200])[:, 0])
    # the oracle, in float64 from the port's own float32 E-step rows
    if family == "linear":
        phi = np.concatenate([X, np.ones((len(X), 1), np.float32)], 1)
    else:
        lm, pj = (torch.from_numpy(a) for a in svm._phi_arrays)
        phi = ops.nystrom_phi(torch.from_numpy(X), lm, pj, None,
                              sigma=cfg.sigma, add_bias=True).numpy()
    w = svm._weights
    epi = "em_hinge" if task == "CLS" else "em_svr"
    yt = torch.from_numpy(y.astype(np.float32))
    beta = yt if task == "CLS" else torch.zeros_like(yt)
    out = ops.fused_stats(torch.from_numpy(phi), yt, beta, w, epilogue=epi,
                          eps=cfg.eps, eps_ins=cfg.eps_ins)
    p64 = phi.astype(np.float64)
    if task == "CLS":
        wt = 1.0 / out[1].numpy().astype(np.float64)
    else:
        wt = (1.0 / out[1].numpy().astype(np.float64)
              + 1.0 / out[2].numpy().astype(np.float64))
    S = (p64 * wt[:, None]).T @ p64
    K = S.shape[0]
    P = S + cfg.lam * np.eye(K)
    P = 0.5 * (P + P.T)
    P += cfg.jitter * (np.trace(P) / K) * np.eye(K)
    want = _std_oracle(p64[:200], P)
    bound = 0.5 * np.linalg.cond(P) * len(X) * 2.0 ** -24
    rel = np.max(np.abs(std.astype(np.float64) - want) / want)
    assert rel <= bound, (rel, bound)
    assert np.all(std > 0)


def test_ensemble_std_is_the_chain_spread():
    """A multichain fit serves (w_c - w_bar) / sqrt(C - 1) columns: the
    served std is np.std(ddof=1) of the chains' margins."""
    X, y = _problem("CLS")
    svm = PEMSVM(SVMConfig(algorithm="MC", rng="fused", n_chains=4,
                           max_iters=15, burnin=5), device="cpu")
    res = svm.fit(X, y)
    m = svm.export_servable()
    assert m.weights.shape == (12, 5) and m.has_uncertainty
    margin, std = svm.scorer().score_with_std(X)
    np.testing.assert_array_equal(margin, svm.decision_function(X))
    Xb = np.concatenate([X, np.ones((len(X), 1))], 1)
    chain_margins = Xb @ res.chain_weights.astype(np.float64).T
    want = np.std(chain_margins, axis=1, ddof=1)
    scale = np.sqrt(np.sum((np.abs(Xb) @ np.abs(m.weights[:, 1:].astype(
        np.float64))) ** 2, axis=1))
    assert np.all(np.abs(std - want) <= REL * scale + 1e-7)
