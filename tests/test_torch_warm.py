"""Warm-started stream generations of the port (``fit(warm_start=...)``,
``SVMConfig.decay`` and ``window``, ``stats.StatsWindow``,
``FitResult.stats`` / ``stats_window``) and the out-of-core Nystrom
landmarks (``data.reservoir_rows``, ``NystromSVM.fit_libsvm``) against the
JAX package, on the CPU.

Exact: ``StatsWindow``'s ``folded``, ``advance`` and ``pack`` / ``unpack``
on the same arrays; ``reservoir_rows``' rows and count on the same chunks
and seed; ``pad_features_to``'s ``width=`` mode; the landmarks
``NystromSVM.fit_libsvm`` draws from the same file; hard expiry within the
port (a donor dragging generations past the horizon changes nothing, bit
for bit; the counterpart of the reference's
``test_fleet.py::test_window_hard_expiry_is_exact``); the config guards
(the reference's exception types).

Banded: decay and window stream fits of the second generation, both
packages warm-started from one reference donor carried across by
``convert.fit_result_from_reference``, in the stream bands of
tests/test_torch_stream.py (EM: iterations equal, objective trace 2e-2,
weights 5e-2, score 0.01); the effective statistics within the same 5e-2;
``fit_libsvm``'s fit in the Nystrom bands of tests/test_torch_nystrom.py
(iterations within 3, objective 2e-2, weights 5e-2, accuracy 0.01).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import PEMSVM as JaxSVM
from repro.core import SVMConfig as JaxConfig
from repro.core import stats as jstats
from repro.core.nystrom import NystromSVM as JaxNystrom
from repro.data import pipeline as jpipe
from repro_torch.core import NystromSVM, PEMSVM, SVMConfig
from repro_torch.core import stats as tstats
from repro_torch.core.convert import fit_result_from_reference
from repro_torch.data import pipeline as tpipe
from repro_torch.data import save_libsvm


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Keep torch to two intra-op threads: the suite runs six workers at
    once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _problem(task, seed=0, N=1024, K=16, M=3):
    """The reference's stream-test problem (tests/test_streaming.py)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, K)).astype(np.float32)
    w_true = rng.normal(size=K)
    if task == "MLT":
        y = np.argmax(X @ rng.normal(size=(M, K)).T, 1).astype(np.int32)
    else:
        y = np.where(X @ w_true + 0.3 * rng.normal(size=N) > 0, 1.0,
                     -1.0).astype(np.float32)
    return X, y


# --------------------------------------------------------------- exact
def _entries(rng, n, K, mlt=False):
    lead = (3,) if mlt else ()
    return [{"S": rng.normal(size=lead + (K, K)).astype(np.float32),
             "b": rng.normal(size=lead + (K,)).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("horizon,n_entries,mlt", [
    (1, 0, False), (2, 1, False), (3, 2, False), (3, 4, False),
    (4, 3, True)])
def test_stats_window_matches_reference(horizon, n_entries, mlt):
    rng = np.random.default_rng(horizon * 10 + n_entries)
    entries = _entries(rng, n_entries, 7, mlt)
    fresh = _entries(rng, 1, 7, mlt)[0]
    jw = jstats.StatsWindow(horizon, entries)
    tw = tstats.StatsWindow(horizon, entries)
    assert len(tw.entries) == len(jw.entries) == min(n_entries, horizon - 1)
    jf, tf = jw.folded(fresh), tw.folded(fresh)
    for k in ("S", "b"):
        np.testing.assert_array_equal(tf[k], np.asarray(jf[k]))
    # the same fold on device tensors (as the stream driver folds)
    T = {k: torch.from_numpy(v) for k, v in fresh.items()}
    tt = tstats.StatsWindow(horizon, [{k: torch.from_numpy(v)
                                       for k, v in e.items()}
                                      for e in entries]).folded(T)
    for k in ("S", "b"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jf[k]))
    ja, ta = jw.advance(fresh), tw.advance(T)
    assert len(ta) == len(ja)
    for a, b in zip(ta, ja):
        for k in ("S", "b"):
            assert isinstance(a[k], np.ndarray)
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    jp, tp = jstats.StatsWindow.pack(ja), tstats.StatsWindow.pack(ta)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k])
    back = tstats.StatsWindow.unpack(tp)
    jback = jstats.StatsWindow.unpack(jp)
    assert len(back) == len(jback)
    for a, b in zip(back, jback):
        for k in ("S", "b"):
            np.testing.assert_array_equal(a[k], b[k])


def _chunks(X, rows, mask_every=0):
    out = []
    for i0 in range(0, X.shape[0], rows):
        Xc = np.zeros((rows, X.shape[1]), np.float32)
        n = min(rows, X.shape[0] - i0)
        Xc[:n] = X[i0:i0 + n]
        mc = np.zeros(rows, np.float32)
        mc[:n] = 1.0
        if mask_every:
            mc[::mask_every] = 0.0
        out.append((Xc, np.zeros(rows, np.float32), mc))
    return out


@pytest.mark.parametrize("n,rows,m,mask_every,seed", [
    (1000, 128, 40, 0, 0), (1000, 100, 40, 3, 1), (257, 64, 300, 0, 2),
    (5000, 512, 64, 7, 3), (50, 16, 50, 0, 4)])
def test_reservoir_rows_match_reference(n, rows, m, mask_every, seed):
    X = np.random.default_rng(seed).normal(size=(n, 5)).astype(np.float32)
    ch = _chunks(X, rows, mask_every)
    jr, jn = jpipe.reservoir_rows(iter(ch), m, seed=seed)
    tr, tn = tpipe.reservoir_rows(iter(ch), m, seed=seed)
    assert tn == jn
    assert tr.dtype == jr.dtype == np.float32
    np.testing.assert_array_equal(tr, jr)


def test_reservoir_rows_refuses_an_empty_source():
    with pytest.raises(ValueError, match="no valid rows"):
        tpipe.reservoir_rows(iter(()), 4)


@pytest.mark.parametrize("args,kw", [
    ((), dict(width=10)), ((), dict(width=13)), ((8,), {}), ((None,), {}),
    ((5,), {})])
def test_pad_features_to_matches_reference(args, kw):
    X = np.arange(40, dtype=np.float32).reshape(4, 10)
    np.testing.assert_array_equal(tpipe.pad_features_to(X, *args, **kw),
                                  jpipe.pad_features_to(X, *args, **kw))
    if kw.get("width") == 10:
        assert tpipe.pad_features_to(X, width=10) is X


def test_pad_features_width_guard():
    X = np.ones((4, 10), np.float32)
    with pytest.raises(ValueError, match="refusing to slice"):
        tpipe.pad_features_to(X, width=7)
    with pytest.raises(AssertionError):
        tpipe.pad_features_to(X, 8, width=16)


# ------------------------------------------------------- config guards
@pytest.mark.parametrize("kw", [
    dict(driver="stream", window=2, decay=0.5),
    dict(driver="loop", window=2),
    dict(driver="scan", decay=0.5),
    dict(driver="stream", decay=1.0),
    dict(driver="stream", decay=-0.1),
    dict(driver="stream", window=-1),
])
def test_config_guards_raise_as_the_reference(kw):
    with pytest.raises(AssertionError):
        JaxConfig(**kw)
    with pytest.raises(AssertionError):
        SVMConfig(**kw)


_KW = dict(algorithm="EM", task="CLS", driver="stream", chunk_rows=64,
           max_iters=4, min_iters=4)


@pytest.mark.parametrize("donor_kw,kw,match", [
    ({}, dict(window=2), "stats_window"),
    ({}, dict(decay=0.5), "warm_start.stats"),
    (dict(decay=0.5), dict(window=3), "stats_window"),
])
def test_warm_start_without_donor_stats_raises(donor_kw, kw, match):
    """A donor without the statistics a fold needs is refused, in both
    packages, before the fit runs."""
    X, y = _problem("CLS", N=256, K=6)
    jd = JaxSVM(JaxConfig(**_KW, **donor_kw)).fit(X, y)
    td = PEMSVM(SVMConfig(**_KW, **donor_kw), device="cpu").fit(X, y)
    with pytest.raises(ValueError, match=match):
        JaxSVM(JaxConfig(**_KW, **kw)).fit(X, y, warm_start=jd)
    with pytest.raises(ValueError, match=match):
        PEMSVM(SVMConfig(**_KW, **kw), device="cpu").fit(X, y,
                                                          warm_start=td)


@pytest.mark.parametrize("driver", ["scan", "loop", "stream"])
def test_warm_start_shape_mismatch_raises(driver):
    X, y = _problem("CLS", N=256, K=6)
    kw = dict(_KW, driver=driver)
    donor = PEMSVM(SVMConfig(**kw), device="cpu").fit(X, y)
    with pytest.raises(ValueError, match="warm_start weights have shape"):
        PEMSVM(SVMConfig(**kw), device="cpu").fit(X[:, :5], y,
                                                  warm_start=donor)


@pytest.mark.parametrize("driver", ["scan", "loop", "stream"])
def test_warm_start_begins_at_the_donor(driver):
    """Every driver starts from the donor's last sample: one EM iteration
    warm-started from a converged fit's last sample is that fit's next
    iterate, and the two packages agree on it."""
    X, y = _problem("CLS", N=512, K=8)
    kw = dict(_KW, driver=driver, max_iters=1, min_iters=1)
    donor = JaxSVM(JaxConfig(**dict(_KW, driver="loop", max_iters=3,
                                    min_iters=3))).fit(X, y)
    td = fit_result_from_reference(donor.last_sample)
    rr = JaxSVM(JaxConfig(**dict(kw, driver="loop"))).fit(
        X, y, warm_start=donor)
    rt = PEMSVM(SVMConfig(**kw), device="cpu").fit(X, y, warm_start=td)
    cold = PEMSVM(SVMConfig(**kw), device="cpu").fit(X, y)
    np.testing.assert_allclose(rt.weights, rr.weights, rtol=1e-4,
                               atol=1e-5 * np.abs(rr.weights).max())
    assert _rel(cold.weights, rr.weights) > 1e-3


# ---------------------------------------------- warm-started generations
def _gen2(task, mode, iters):
    """Generation 1 by the reference, carried across as a donor; then
    generation 2 on relabelled rows by both packages from that donor."""
    opts = f"LIN-EM-{task}"
    kw = dict(driver="stream", chunk_rows=100, eps=1e-2, max_iters=iters,
              min_iters=iters, **mode)
    if task == "MLT":
        kw["num_classes"] = 3
    X, y = _problem(task)
    y2 = (y + 1) % 3 if task == "MLT" else -y
    y2 = y2.astype(y.dtype)

    def ref_fit(*a, **k):
        svm = JaxSVM(JaxConfig.from_options(opts, **kw))
        if task == "MLT":
            with jax.disable_jit():
                return svm, svm.fit(*a, **k)
        return svm, svm.fit(*a, **k)

    _, g1 = ref_fit(X, y)
    donor = fit_result_from_reference(g1.last_sample, g1.stats,
                                      g1.stats_window)
    rsvm, rr = ref_fit(X, y2, warm_start=g1)
    tsvm = PEMSVM(SVMConfig.from_options(opts, **kw), device="cpu")
    rt = tsvm.fit(X, y2, warm_start=donor)
    return X, y2, rsvm, rr, tsvm, rt


@pytest.mark.parametrize("task,iters", [("CLS", 10), ("MLT", 6)])
@pytest.mark.parametrize("mode", [dict(decay=0.5), dict(window=2),
                                  dict(window=3)])
def test_warm_generation_matches_reference(task, iters, mode):
    X, y2, rsvm, rr, tsvm, rt = _gen2(task, mode, iters)
    assert rt.n_iters == rr.n_iters
    assert _rel(rt.weights, rr.weights) <= 5e-2
    o, orr = np.asarray(rt.objective), np.asarray(rr.objective)
    assert np.max(np.abs(o - orr) / np.abs(orr)) <= 2e-2
    assert abs(tsvm.score(X, y2) - rsvm.score(X, y2)) <= 0.01
    for k in ("S", "b"):
        assert rt.stats[k].shape == rr.stats[k].shape
        assert isinstance(rt.stats[k], np.ndarray)
        assert _rel(rt.stats[k], rr.stats[k]) <= 5e-2
    if "window" in mode:
        assert len(rt.stats_window) == len(rr.stats_window) == \
            mode["window"] - 1
        for a, b in zip(rt.stats_window, rr.stats_window):
            for k in ("S", "b"):
                assert isinstance(a[k], np.ndarray)
                assert _rel(a[k], b[k]) <= 5e-2
        # the donor's ring entry rides along unchanged (window 3)
        if mode["window"] == 3:
            np.testing.assert_array_equal(rt.stats_window[1]["S"],
                                          np.asarray(rr.stats_window[1]["S"]))
    else:
        assert rt.stats_window is None and rr.stats_window is None


def test_window_hard_expiry_is_exact():
    """window=2 keeps exactly one previous generation's fresh partials: a
    donor dragging a stale generation past the horizon changes nothing,
    bit for bit, while the retained generation moves the fit."""
    X, y = _problem("CLS", N=512, K=8)
    kw = dict(_KW, max_iters=6, min_iters=6, window=2)
    fit = lambda y, **k: PEMSVM(SVMConfig(**kw), device="cpu").fit(  # noqa
        X, y, **k)
    g1 = fit(y)
    assert g1.stats is not None and len(g1.stats_window) == 1
    g2 = fit(-y, warm_start=g1)
    assert len(g2.stats_window) == 1
    for k in ("S", "b"):
        np.testing.assert_array_equal(
            g2.stats[k], g2.stats_window[0][k] + g1.stats_window[0][k])
    g3 = fit(y, warm_start=g2)
    fat = dataclasses.replace(
        g2, stats_window=g2.stats_window + g1.stats_window)
    g3b = fit(y, warm_start=fat)
    np.testing.assert_array_equal(g3.weights, g3b.weights)
    np.testing.assert_array_equal(g3.stats["S"], g3b.stats["S"])
    fresh = fit(y)
    assert not np.allclose(g3.weights, fresh.weights)


def test_decay_folds_the_donor_statistics():
    """decay: the effective statistics are fresh + decay * the donor's,
    bitwise (the reference's association order), and folding a donor's
    statistics moves the fit."""
    X, y = _problem("CLS", N=512, K=8)
    kw = dict(_KW, max_iters=5, min_iters=5, decay=0.5)
    g1 = PEMSVM(SVMConfig(**kw), device="cpu").fit(X, y)
    zero = dataclasses.replace(
        g1, stats={k: np.zeros_like(v) for k, v in g1.stats.items()})
    g2 = PEMSVM(SVMConfig(**kw), device="cpu").fit(X, -y, warm_start=g1)
    g2z = PEMSVM(SVMConfig(**kw), device="cpu").fit(X, -y, warm_start=zero)
    assert g2.stats_window is None
    assert not np.allclose(g2.weights, g2z.weights)
    # one iteration from the same state: the fresh statistics are equal,
    # so the folded ones differ by exactly decay * the donor's
    one = dict(kw, max_iters=1, min_iters=1)
    a = PEMSVM(SVMConfig(**one), device="cpu").fit(X, -y, warm_start=g1)
    b = PEMSVM(SVMConfig(**one), device="cpu").fit(X, -y, warm_start=zero)
    for k in ("S", "b"):
        np.testing.assert_array_equal(
            a.stats[k], b.stats[k] + np.float32(0.5) * g1.stats[k])


def test_window_multiclass_shapes():
    X, _ = _problem("CLS", N=512, K=8)
    rng = np.random.default_rng(5)
    ym = np.argmax(X @ rng.normal(size=(3, 8)).T, 1).astype(np.int32)
    kw = dict(algorithm="EM", task="MLT", num_classes=3, driver="stream",
              chunk_rows=64, max_iters=4, min_iters=4, window=2)
    d1 = PEMSVM(SVMConfig(**kw), device="cpu").fit(X, ym)
    d2 = PEMSVM(SVMConfig(**kw), device="cpu").fit(X, (ym + 1) % 3,
                                                    warm_start=d1)
    assert d2.stats["S"].shape == (3, 9, 9)
    assert d2.stats_window[0]["S"].shape == (3, 9, 9)
    assert d2.stats_window[0]["b"].shape == (3, 9)
    for k in ("S", "b"):
        np.testing.assert_array_equal(
            d2.stats[k], d2.stats_window[0][k] + d1.stats_window[0][k])
    assert not np.allclose(d1.weights, d2.weights)


def test_multichain_warm_start_and_window():
    """n_chains > 1: the donor's last sample is (C, K) and its ring holds
    the multichain statistic, (C, K, K) and (K, C)."""
    X, y = _problem("CLS", N=512, K=8)
    kw = dict(algorithm="MC", rng="fused", n_chains=3, driver="stream",
              chunk_rows=128, max_iters=3, min_iters=3, burnin=1, window=2)
    g1 = PEMSVM(SVMConfig(**kw), device="cpu").fit(X, y)
    assert g1.last_sample.shape == (3, 9)
    assert g1.stats_window[0]["S"].shape == (3, 9, 9)
    g2 = PEMSVM(SVMConfig(**kw), device="cpu").fit(X, y, warm_start=g1)
    for k in ("S", "b"):
        np.testing.assert_array_equal(
            g2.stats[k], g2.stats_window[0][k] + g1.stats_window[0][k])


# -------------------------------------------------- Nystrom from a file
def _ring_file(tmp_path, n=1500, seed=3):
    rng = np.random.default_rng(seed)
    r = np.concatenate([rng.uniform(0, 1, n // 2),
                        rng.uniform(1.5, 2.5, n - n // 2)])
    th = rng.uniform(0, 2 * np.pi, n)
    X = np.stack([r * np.cos(th), r * np.sin(th),
                  0.1 * rng.normal(size=n)], 1).astype(np.float32)
    y = np.where(np.arange(n) < n // 2, 1.0, -1.0).astype(np.float32)
    perm = rng.permutation(n)
    X, y = X[perm], y[perm]
    path = str(tmp_path / "rings.libsvm")
    save_libsvm(path, X, y)
    return path, X, y


@pytest.mark.parametrize("n_landmarks", [40, None])
def test_nystrom_fit_libsvm_matches_reference(tmp_path, n_landmarks):
    path, X, y = _ring_file(tmp_path)
    kw = dict(formulation="KRN", driver="stream", chunk_rows=256, lam=0.1,
              sigma=0.7, max_iters=20)
    jn = JaxNystrom(JaxConfig(**kw), n_landmarks=n_landmarks, seed=2)
    rr = jn.fit_libsvm(path, 3)
    tn = NystromSVM(SVMConfig(**kw), n_landmarks=n_landmarks, seed=2,
                    device="cpu")
    rt = tn.fit_libsvm(path, 3)
    np.testing.assert_array_equal(tn._landmarks, jn._landmarks)
    want_m = n_landmarks or int(np.ceil(np.sqrt(len(y))))
    assert tn._landmarks.shape == (want_m, 3)
    assert abs(rt.n_iters - rr.n_iters) <= 3
    o, orr = np.asarray(rt.objective), np.asarray(rr.objective)
    j = min(len(o), len(orr))
    assert np.max(np.abs(o[:j] - orr[:j]) / np.abs(orr[:j])) <= 2e-2
    assert _rel(rt.weights, rr.weights) <= 5e-2
    assert abs(tn.score(X, y) - jn.score(X, y)) <= 0.01


def test_nystrom_warm_start_reuses_the_featurizer(tmp_path):
    """A warm-started Nystrom fit keeps the installed landmarks and
    projection (the donor's weights live in their phi-space), from arrays
    and from a file."""
    path, X, y = _ring_file(tmp_path)
    kw = dict(formulation="KRN", driver="stream", chunk_rows=256, lam=0.1,
              sigma=0.7, max_iters=6, min_iters=6, window=2)
    ny = NystromSVM(SVMConfig(**kw), n_landmarks=30, seed=1, device="cpu")
    g1 = ny.fit_libsvm(path, 3)
    lm, pj = ny._landmarks, ny._proj
    g2 = ny.fit(X[::-1].copy(), y[::-1].copy(), warm_start=g1)
    assert ny._landmarks is lm and ny._proj is pj
    g3 = ny.fit_libsvm(path, 3, warm_start=g2)
    assert ny._landmarks is lm
    assert g3.weights.shape == g1.weights.shape == (31,)
    assert ny.score(X, y) > 0.95
    fresh = NystromSVM(SVMConfig(**kw), n_landmarks=30, seed=5,
                       device="cpu")
    fresh.fit(X, y)
    assert not np.array_equal(fresh._landmarks, lm)


_MESH_WARM = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world)
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.core import PEMSVM, SVMConfig
from repro_torch.core.convert import fit_result_from_reference
d = np.load(out + "/inputs.npz")
mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("data",))
cfg = SVMConfig(**json.loads(str(d["kw"])))
donor = fit_result_from_reference(d["last"])
res = PEMSVM(cfg, device="cpu", mesh=mesh).fit(d["X"], d["y"],
                                               warm_start=donor)
alone = PEMSVM(cfg, device="cpu").fit(d["X"], d["y"], warm_start=donor)
np.savez(f"{out}/rank{rank}.npz", w=res.weights, alone=alone.weights)
dist.destroy_process_group()
"""


@pytest.mark.parametrize("world", [1, 2])
def test_warm_start_on_a_mesh(world, tmp_path):
    """On a mesh every rank starts from the same donor sample (replicated):
    the ranks' weights are bitwise equal; a one-rank mesh is bitwise the
    one-device warm fit in the same process (thread count and all), two
    ranks within 1e-5 of it (the same sums in another order, five EM
    iterations at eps 1e-2)."""
    import json
    from test_torch_kshard import run_ranks
    X, y = _problem("CLS", N=512, K=8)
    kw = dict(max_iters=5, min_iters=5, eps=1e-2)
    donor = PEMSVM(SVMConfig(**dict(kw, max_iters=2, min_iters=2)),
                   device="cpu").fit(X, -y)
    one = PEMSVM(SVMConfig(**kw), device="cpu").fit(X, y, warm_start=donor)
    cold = PEMSVM(SVMConfig(**kw), device="cpu").fit(X, y)
    np.savez(tmp_path / "inputs.npz", X=X, y=y, kw=json.dumps(kw),
             last=donor.last_sample)
    ranks = run_ranks(_MESH_WARM, tmp_path, world=world)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["w"], ranks[0]["w"])
    w, alone = ranks[0]["w"], ranks[0]["alone"]
    if world == 1:
        np.testing.assert_array_equal(w, alone)
    else:
        assert np.max(np.abs(w - alone)) <= 1e-5 * np.max(np.abs(alone))
    assert np.max(np.abs(alone - one.weights)) <= 1e-5 * np.max(
        np.abs(one.weights))
    assert _rel(one.weights, cold.weights) > 1e-4
