"""Kill it. Resume it. Get the same bits: the port's reliability surface
(``SVMConfig.fault``, ``fit(resume_from=, resume_step=, fault_hook=,
epoch=)``, ``core/resume.py``), case for case with the reference's
tests/test_elastic_fit.py on the CPU, then against the JAX package.

1. Same config, same driver: a fit preempted by ``runtime.faults`` and
   resumed from its last committed snapshot is BITWISE the uninterrupted
   fit: scan, loop and stream (killed between iterations and inside a
   pass), EM and MC, CLS, SVR and MLT, three chains, exact KRN, Nystrom
   (``fit`` and ``fit_libsvm``), a windowed warm start. The budget extends
   on resume (max_iters is outside the fingerprint), ``resume_step`` pins
   a snapshot, the semantic fields are checked, and a fit without
   ``fault`` has the parent's host syncs (scan <= ceil(max_iters /
   scan_chunk), stream one an iteration).
2. Across drivers: the stream driver's boundary snapshot resumed into the
   scan and loop drivers lands within the band tests/test_torch_stream.py
   holds stream against resident (EM 1e-4 of max|w| after 30 iterations,
   MC 2e-4 inside its 4-iteration exactness window), or within twice what
   the uninterrupted stream fit is from the resident one, where the
   layout change alone costs more. (The reference's own stream-to-resident
   resume test fails under the installed jax, ROADMAP section 3; nothing
   here compares with it.)
3. Straggler reactions (record, raise) on a step clock that only the
   injected delays advance: no wall-clock step time decides a verdict.
4. Against the reference: ``config_fingerprint`` strings are equal over a
   grid of configs (LIN and Nystrom, EM and MC, CLS, SVR and MLT, rng,
   n_chains, decay, window); a port snapshot has the reference's array
   names, dtypes and shapes and its meta keys at the same config
   (boundary and mid-pass, a window ring); a port fit resumed from the
   reference's snapshot (and the reverse) lands within the bands
   tests/test_torch_em_cls.py holds the port to against the reference
   (objective trace 2e-2 relative, weights 5e-2, equal iterations).
5. On a mesh (four gloo ranks, a file store): a fit killed on 2 x 2 with
   the k-sharded statistic resumes on 4 x 1 and on one device within the
   band the layout change costs without a kill (the uninterrupted fits on
   those layouts: EM 1e-4, MC 2e-2 relative), and on 2 x 2 again bitwise;
   only rank 0 writes; ``report_slow_shard`` with ``on_straggler='drop'``
   zeroes that shard's live weight at an injected slow step.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.core import NystromSVM as RefNystrom
from repro.core import PEMSVM as RefSVM
from repro.core import SVMConfig as RefConfig
from repro.core import resume as ref_resume
from repro.runtime import faults as ref_faults
from repro.runtime.policy import FaultPolicy as RefPolicy
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import NystromSVM, PEMSVM, SVMConfig
from repro_torch.core import resume as resume_mod
from repro_torch.core import solver as solver_mod
from repro_torch.core.linear import SVMData
from repro_torch.data import make_circles, save_libsvm
from repro_torch.runtime import faults
from repro_torch.runtime.policy import FaultPolicy, StragglerError
from test_torch_kshard import run_ranks

_rng = np.random.default_rng(0)
N, K = 257, 9
X = _rng.normal(size=(N, K)).astype(np.float32)
_w_true = _rng.normal(size=K + 1)
Y_CLS = np.where(X @ _w_true[:K] + _w_true[K] > 0, 1.0, -1.0).astype(
    np.float32)
Y_SVR = (X @ _w_true[:K]).astype(np.float32)
Y_MLT = np.argmax(X @ _rng.normal(size=(3, K)).T, 1).astype(np.int32)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads, as tests/test_torch_em_cls.py: the suite runs
    six workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def svm(cfg):
    return PEMSVM(cfg, device="cpu")


def _kill_fit(model, X, y, hook, **fit_kw):
    """Run a fit that MUST be preempted by ``hook``."""
    with pytest.raises(faults.SimulatedPreemption):
        model.fit(X, y, fault_hook=hook, **fit_kw)


def _same(a, b):
    """Bitwise equal fits: weights, last sample, trace, iterations."""
    assert np.array_equal(a.weights, b.weights)
    assert np.array_equal(a.last_sample, b.last_sample)
    assert a.objective == b.objective
    assert a.n_iters == b.n_iters and a.converged == b.converged


# ------------------------------------------- same-driver bitwise parity
@pytest.mark.parametrize("algo", ["EM", "MC"])
@pytest.mark.parametrize("task", ["CLS", "SVR"])
def test_stream_kill_resume_bitwise(algo, task, tmp_path):
    """Stream driver, killed between iterations: the resumed trajectory
    is the uninterrupted one, bit for bit (the carry key continues the
    chain; mid-pass snapshots ride along every 2 chunks)."""
    tgt = Y_CLS if task == "CLS" else Y_SVR
    kw = dict(algorithm=algo, task=task, driver="stream", chunk_rows=64,
              max_iters=12, min_iters=12, burnin=3)
    ref = svm(SVMConfig(**kw)).fit(X, tgt)

    pol = FaultPolicy(ckpt_dir=str(tmp_path), ckpt_every=2, ckpt_chunks=2)
    cfg = SVMConfig(**kw, fault=pol)
    _kill_fit(svm(cfg), X, tgt, faults.kill_at_iteration(7))
    res = svm(cfg).fit(X, tgt, resume_from=str(tmp_path))

    assert res.resumed_at is not None and res.resumed_at >= 6
    _same(ref, res)
    assert res.n_host_syncs == ref.n_host_syncs == 12


def _five_chunks():
    """A restartable fit_chunks source: 257 rows padded to 5 x 64."""
    Xp = np.concatenate([X, np.zeros((63, K), np.float32)])
    Xp = np.concatenate([Xp, np.ones((320, 1), np.float32)], axis=1)
    Xp[N:, K] = 0.0
    yp = np.concatenate([Y_CLS, np.zeros(63, np.float32)])
    mp = np.concatenate([np.ones(N, np.float32),
                         np.zeros(63, np.float32)])
    for i0 in range(0, 320, 64):
        yield SVMData(Xp[i0:i0 + 64], yp[i0:i0 + 64], mp[i0:i0 + 64])


@pytest.mark.parametrize("kw", [
    dict(), dict(rng="fused", n_chains=3)], ids=["mc", "mc3"])
def test_midpass_kill_resume_bitwise(kw, tmp_path):
    """Preempt INSIDE a pass (chunk 12, then chunk 18 with three chains)
    with a snapshot every chunk: the resume skips the folded chunks,
    starts from the saved partial totals and row, takes the saved
    subkey without splitting, and the MC chain (or three) continues
    bitwise."""
    kw = dict(algorithm="MC", task="CLS", driver="stream", chunk_rows=64,
              max_iters=8, min_iters=8, burnin=2, **kw)
    ref = svm(SVMConfig(**kw)).fit_chunks(_five_chunks, K + 1)

    d = str(tmp_path)
    pol = FaultPolicy(ckpt_dir=d, ckpt_every=100, ckpt_chunks=1)
    cfg = SVMConfig(**kw, fault=pol)
    kill = 18 if "n_chains" in kw else 12
    with pytest.raises(faults.SimulatedPreemption):
        svm(cfg).fit_chunks(faults.kill_after_chunks(_five_chunks, kill),
                            K + 1)

    payload = resume_mod.load_snapshot(Checkpointer(d))
    assert payload["in_pass"] and payload["chunk_idx"] == kill % 5
    assert payload["row0"] == 64 * (kill % 5)
    assert payload["state"].shape == (
        (3, K + 1) if "n_chains" in kw else (K + 1,))

    # a mid-pass snapshot is stream-only and chunk_rows-pinned
    with pytest.raises(ValueError, match="driver='stream'"):
        svm(dataclasses.replace(cfg, driver="scan")).fit(
            X, Y_CLS, resume_from=d)
    with pytest.raises(ValueError, match="chunk_rows"):
        svm(dataclasses.replace(cfg, chunk_rows=32)).fit(
            X, Y_CLS, resume_from=d)

    res = svm(cfg).fit_chunks(_five_chunks, K + 1, resume_from=d)
    assert res.resumed_at == kill // 5
    _same(ref, res)
    if "n_chains" in kw:
        assert np.array_equal(ref.chain_weights, res.chain_weights)
        assert np.array_equal(ref.chain_std, res.chain_std)


@pytest.mark.parametrize("algo", ["EM", "MC"])
def test_scan_kill_resume_bitwise(algo, tmp_path):
    """The scan driver checkpoints at its host syncs; killed there, it
    resumes bitwise, and checkpoints add no host sync."""
    kw = dict(algorithm=algo, task="CLS", driver="scan", scan_chunk=4,
              max_iters=12, min_iters=12, burnin=3)
    ref = svm(SVMConfig(**kw)).fit(X, Y_CLS)
    pol = FaultPolicy(ckpt_dir=str(tmp_path), ckpt_every=4)
    cfg = SVMConfig(**kw, fault=pol)
    _kill_fit(svm(cfg), X, Y_CLS, faults.kill_at_iteration(8))
    res = svm(cfg).fit(X, Y_CLS, resume_from=str(tmp_path))
    assert res.resumed_at == 8
    _same(ref, res)
    assert res.n_host_syncs == ref.n_host_syncs == 3
    assert svm(cfg).fit(X, Y_CLS).n_host_syncs == 3


_MLT_SVR = [(options, kw, driver) for options, kw in [
    ("LIN-MC-MLT", dict(num_classes=3, eps=1e-1)),
    ("LIN-EM-MLT", dict(num_classes=3, eps=1e-1)),
    ("LIN-MC-SVR", dict(eps_ins=0.3, rng="fused", n_chains=2)),
] for driver in ("scan", "loop", "stream")
    if (options, driver) != ("LIN-EM-MLT", "stream")]


@pytest.mark.parametrize("options,kw,driver", _MLT_SVR)
def test_kill_resume_bitwise_mlt_svr(options, kw, driver, tmp_path):
    """MLT (M + 1 passes an iteration on the stream driver, snapshots at
    iteration boundaries) and two SVR chains resume bitwise."""
    y = {"MLT": Y_MLT, "SVR": Y_SVR}[options.split("-")[-1]]
    kw = dict(kw, driver=driver, chunk_rows=64, scan_chunk=3, max_iters=9,
              min_iters=9, burnin=2)
    ref = svm(SVMConfig.from_options(options, **kw)).fit(X, y)
    cfg = SVMConfig.from_options(options, **kw, fault=FaultPolicy(
        ckpt_dir=str(tmp_path), ckpt_every=3, ckpt_chunks=2))
    _kill_fit(svm(cfg), X, y, faults.kill_at_iteration(6))
    res = svm(cfg).fit(X, y, resume_from=str(tmp_path))
    assert res.resumed_at is not None and res.resumed_at >= 5
    _same(ref, res)


def test_loop_kill_resume_bitwise(tmp_path):
    kw = dict(algorithm="MC", task="CLS", driver="loop", max_iters=10,
              min_iters=10, burnin=2)
    ref = svm(SVMConfig(**kw)).fit(X, Y_CLS)
    pol = FaultPolicy(ckpt_dir=str(tmp_path), ckpt_every=3)
    cfg = SVMConfig(**kw, fault=pol)
    _kill_fit(svm(cfg), X, Y_CLS, faults.kill_at_iteration(7))
    res = svm(cfg).fit(X, Y_CLS, resume_from=str(tmp_path))
    _same(ref, res)
    assert res.n_checkpoints >= 1


@pytest.mark.parametrize("algo", ["EM", "MC"])
def test_exact_krn_kill_resume_bitwise(algo, tmp_path):
    """The exact-Gram KRN fit resumes its dual weights bitwise."""
    Xc, yc = make_circles(300, seed=1)
    kw = dict(formulation="KRN", algorithm=algo, sigma=0.7, max_iters=8,
              min_iters=8, burnin=2, scan_chunk=2)
    ref = svm(SVMConfig(**kw)).fit(Xc, yc)
    cfg = SVMConfig(**kw, fault=FaultPolicy(ckpt_dir=str(tmp_path),
                                            ckpt_every=2))
    _kill_fit(svm(cfg), Xc, yc, faults.kill_at_iteration(4))
    res = svm(cfg).fit(Xc, yc, resume_from=str(tmp_path))
    assert res.resumed_at == 4
    _same(ref, res)


def test_extend_budget_bitwise(tmp_path):
    """max_iters is OUTSIDE the fingerprint: a finished 5-iteration fit
    resumes into a 10-iteration budget and lands exactly where the
    one-shot 10-iteration fit does."""
    kw = dict(algorithm="EM", task="CLS", driver="loop", min_iters=1,
              tol=1e-12)
    pol = FaultPolicy(ckpt_dir=str(tmp_path), ckpt_every=5)
    r1 = svm(SVMConfig(**kw, max_iters=5, fault=pol)).fit(X, Y_CLS)
    r2 = svm(SVMConfig(**kw, max_iters=10, fault=pol)).fit(
        X, Y_CLS, resume_from=str(tmp_path))
    ref = svm(SVMConfig(**kw, max_iters=10)).fit(X, Y_CLS)
    assert (r1.n_iters, r2.n_iters) == (5, 10)
    assert r2.resumed_at == 5
    assert np.array_equal(ref.weights, r2.weights)


def test_resume_step_pins_snapshot(tmp_path):
    """``resume_step`` picks a committed step (it * 1_000_000 for a
    boundary); replaying from iteration 6 reproduces the donor run
    bitwise, the objective history carried through the snapshot."""
    kw = dict(algorithm="EM", task="CLS", driver="loop", max_iters=10,
              min_iters=10)
    pol = FaultPolicy(ckpt_dir=str(tmp_path), ckpt_every=3, keep_k=10)
    cfg = SVMConfig(**kw, fault=pol)
    ref = svm(cfg).fit(X, Y_CLS)                    # commits 3, 6, 9, 10
    assert Checkpointer(str(tmp_path)).all_steps() == [
        3_000_000, 6_000_000, 9_000_000, 10_000_000]
    res = svm(cfg).fit(X, Y_CLS, resume_from=str(tmp_path),
                       resume_step=resume_mod.step_id(6))
    assert res.resumed_at == 6
    _same(ref, res)


# ----------------------------------------------- cross-layout elasticity
def _stream_problem(seed=0, n=1024, k=16):
    """tests/test_torch_stream.py's problem."""
    rng = np.random.default_rng(seed)
    Xs = rng.normal(size=(n, k)).astype(np.float32)
    w = rng.normal(size=k)
    return Xs, np.where(Xs @ w + 0.3 * rng.normal(size=n) > 0, 1.0, -1.0)


def _rel_max(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("target_driver", ["scan", "loop"])
@pytest.mark.parametrize("algo,iters,kill,band", [
    ("EM", 30, 6, 1e-4), ("MC", 4, 2, 2e-4)])
def test_stream_snapshot_resumes_in_resident_drivers(
        target_driver, algo, iters, kill, band, tmp_path):
    """A boundary snapshot of the stream driver (chunks of 100 rows)
    restores into the scan and loop drivers; the result is held against
    the uninterrupted fit of that driver within the stream-vs-resident
    band of tests/test_torch_stream.py, or twice the distance of the
    uninterrupted stream fit from it where that is larger (the chunked
    float32 sums reassociate, and the MC chain doubles such differences
    each iteration: 3.7e-4 after 4 iterations at one or eight torch
    threads, 1.2e-6 at two; resuming adds nothing to it)."""
    Xs, ys = _stream_problem()
    kw = dict(algorithm=algo, eps=1e-2, max_iters=iters, min_iters=iters,
              burnin=2, scan_chunk=2)
    ref = svm(SVMConfig(**kw, driver=target_driver)).fit(Xs, ys)
    stream = SVMConfig(**kw, driver="stream", chunk_rows=100)
    layout = _rel_max(svm(stream).fit(Xs, ys).weights, ref.weights)
    pol = FaultPolicy(ckpt_dir=str(tmp_path), ckpt_every=kill)
    _kill_fit(svm(dataclasses.replace(stream, fault=pol)), Xs, ys,
              faults.kill_at_iteration(kill))
    res = svm(SVMConfig(**kw, driver=target_driver, fault=pol)).fit(
        Xs, ys, resume_from=str(tmp_path))
    assert res.resumed_at == kill and res.n_iters == iters
    assert _rel_max(res.weights, ref.weights) <= max(band, 2 * layout)


def test_window_kill_resume_bitwise(tmp_path):
    """The warm start's hard-expiry ring rides the snapshot (win{i}_*): a
    windowed fit killed mid-flight resumes WITHOUT the donor in hand and
    folds bit-identical sums; window is semantic."""
    kw = dict(algorithm="MC", task="CLS", driver="stream", chunk_rows=64,
              max_iters=10, min_iters=10, burnin=3, window=2)
    donor = svm(SVMConfig(**kw)).fit(X, Y_CLS)
    ref = svm(SVMConfig(**kw)).fit(X, -Y_CLS, warm_start=donor)

    d = str(tmp_path)
    cfg = SVMConfig(**kw, fault=FaultPolicy(ckpt_dir=d, ckpt_every=2))
    with pytest.raises(faults.SimulatedPreemption):
        svm(cfg).fit(X, -Y_CLS, warm_start=donor,
                     fault_hook=faults.kill_at_iteration(5))
    res = svm(cfg).fit(X, -Y_CLS, resume_from=d)
    _same(ref, res)
    assert np.array_equal(res.stats["S"], ref.stats["S"])
    assert np.array_equal(res.stats_window[0]["S"],
                          ref.stats_window[0]["S"])
    with pytest.raises(ValueError, match="window"):
        svm(SVMConfig(**{**kw, "window": 3}, fault=cfg.fault)).fit(
            X, -Y_CLS, resume_from=d)


# --------------------------------------------------- guard-rail errors
def test_resume_and_warm_start_mutually_exclusive():
    donor = svm(SVMConfig(driver="loop", max_iters=2, min_iters=2)).fit(
        X, Y_CLS)
    with pytest.raises(ValueError, match="mutually exclusive"):
        svm(SVMConfig(driver="loop", max_iters=2, min_iters=2)).fit(
            X, Y_CLS, resume_from="/nonexistent/anywhere", warm_start=donor)


def test_fingerprint_mismatch_names_field(tmp_path):
    pol = FaultPolicy(ckpt_dir=str(tmp_path), ckpt_every=2)
    kw = dict(algorithm="EM", task="CLS", driver="loop", max_iters=4,
              min_iters=4)
    svm(SVMConfig(**kw, fault=pol)).fit(X, Y_CLS)
    with pytest.raises(ValueError, match="lam"):
        svm(SVMConfig(**kw, lam=2.0, fault=pol)).fit(
            X, Y_CLS, resume_from=str(tmp_path))
    with pytest.raises(ValueError, match="shape"):
        svm(SVMConfig(**kw, fault=pol)).fit(
            X[:, :5], Y_CLS, resume_from=str(tmp_path))


# --------------------------------------------------- straggler reactions
class _Clock:
    """The drivers' step clock, advanced only by the injected delays."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, seconds):
        self.t += seconds


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(solver_mod, "time",
                        types.SimpleNamespace(perf_counter=c))
    return c


@pytest.mark.parametrize("driver", ["loop", "scan"])
def test_straggler_record_events(driver, clock):
    """on_straggler='record': the delayed iteration lands in
    FitResult.straggler_events without touching the trajectory (the scan
    driver observes once a host sync, so there it is the sync's last
    iteration)."""
    kw = dict(algorithm="EM", task="CLS", driver=driver, scan_chunk=2,
              max_iters=10, min_iters=10)
    pol = FaultPolicy(on_straggler="record", straggler_threshold=1.5,
                      straggler_warmup=2)
    hook = faults.compose_hooks(
        faults.delay_iterations(range(1, 11), 0.05, sleep=clock.sleep),
        faults.delay_iterations([6], 0.5, sleep=clock.sleep))
    res = svm(SVMConfig(**kw, fault=pol)).fit(X, Y_CLS, fault_hook=hook)
    assert [e["it"] for e in res.straggler_events] == [6]
    assert res.straggler_events[0]["seconds"] == pytest.approx(0.55)
    _same(svm(SVMConfig(**kw)).fit(X, Y_CLS), res)


def test_straggler_raise(tmp_path, clock):
    """on_straggler='raise' hands control to an outer controller, and the
    last committed checkpoint makes the restart lossless."""
    kw = dict(algorithm="EM", task="CLS", driver="loop", max_iters=10,
              min_iters=10)
    pol = FaultPolicy(ckpt_dir=str(tmp_path), ckpt_every=2,
                      on_straggler="raise", straggler_threshold=3.0,
                      straggler_warmup=2)
    floor = faults.delay_iterations(range(1, 11), 0.05, sleep=clock.sleep)
    with pytest.raises(StragglerError, match="iteration 6"):
        svm(SVMConfig(**kw, fault=pol)).fit(
            X, Y_CLS, fault_hook=faults.compose_hooks(
                floor, faults.delay_iterations([6], 0.5,
                                               sleep=clock.sleep)))
    res = svm(SVMConfig(**kw, fault=pol)).fit(
        X, Y_CLS, resume_from=str(tmp_path), fault_hook=floor)
    assert res.resumed_at == 6 and res.straggler_events == []
    _same(svm(SVMConfig(**kw)).fit(X, Y_CLS), res)


# --------------------------------------------------------- Nystrom path
def _rings():
    rng = np.random.default_rng(0)
    Xc = rng.normal(size=(300, 6)).astype(np.float32)
    yc = np.where(np.linalg.norm(Xc[:, :2], axis=1) > 1.1, 1.0,
                  -1.0).astype(np.float32)
    return Xc, yc


def test_nystrom_stream_kill_resume_bitwise(tmp_path):
    """Landmark selection is seed-deterministic, so a fresh model resumes
    the phi-space fit bitwise; a model that holds its featurizer reuses
    it (no new landmarks), and its scores are the uninterrupted model's."""
    Xc, yc = _rings()
    kw = dict(formulation="KRN", algorithm="MC", task="CLS",
              driver="stream", chunk_rows=64, max_iters=10, min_iters=10,
              burnin=3, sigma=1.5)
    ref = NystromSVM(SVMConfig(**kw), n_landmarks=32, seed=1, device="cpu")
    rref = ref.fit(Xc, yc)

    d = str(tmp_path)
    pol = FaultPolicy(ckpt_dir=d, ckpt_every=2, ckpt_chunks=2, keep_k=20)
    svm1 = NystromSVM(SVMConfig(**kw, fault=pol), n_landmarks=32, seed=1,
                      device="cpu")
    with pytest.raises(faults.SimulatedPreemption):
        svm1.fit(Xc, yc, fault_hook=faults.kill_at_iteration(6))
    svm2 = NystromSVM(SVMConfig(**kw, fault=pol), n_landmarks=32, seed=1,
                      device="cpu")
    res = svm2.fit(Xc, yc, resume_from=d)
    _same(rref, res)
    assert svm2.score(Xc, yc) == ref.score(Xc, yc) > 0.8
    lm = svm1._landmarks
    res1 = svm1.fit(Xc, yc, resume_from=d, resume_step=6_000_000)
    assert svm1._landmarks is lm
    _same(rref, res1)
    assert np.array_equal(svm1.decision_function(Xc),
                          ref.decision_function(Xc))


def test_nystrom_fit_libsvm_kill_resume_bitwise(tmp_path):
    """fit_libsvm(resume_from=...): the reservoir landmarks are redrawn
    from the seed by a fresh model, the stream resumes inside the file."""
    Xc, yc = _rings()
    path = str(tmp_path / "rings.libsvm")
    save_libsvm(path, Xc, yc)
    kw = dict(formulation="KRN", algorithm="EM", task="CLS",
              driver="stream", chunk_rows=64, max_iters=6, min_iters=6,
              sigma=1.5)
    ref = NystromSVM(SVMConfig(**kw), n_landmarks=24, seed=2,
                     device="cpu").fit_libsvm(path, 6)
    d = str(tmp_path / "ckpt")
    cfg = SVMConfig(**kw, fault=FaultPolicy(ckpt_dir=d, ckpt_every=2,
                                            ckpt_chunks=3))
    with pytest.raises(faults.SimulatedPreemption):
        NystromSVM(cfg, n_landmarks=24, seed=2, device="cpu").fit_libsvm(
            path, 6, fault_hook=faults.kill_at_iteration(3))
    res = NystromSVM(cfg, n_landmarks=24, seed=2, device="cpu").fit_libsvm(
        path, 6, resume_from=d)
    assert res.resumed_at == 2      # iteration 3's mid-pass snapshot
    _same(ref, res)


# ----------------------------------------------- against the JAX package
def _config_grid():
    out = []
    for form in ("LIN", "KRN"):
        for algo in ("EM", "MC"):
            for task in ("CLS", "SVR", "MLT"):
                base = dict(formulation=form, algorithm=algo, task=task,
                            num_classes=3 if task == "MLT" else 2,
                            lam=0.37, sigma=1.3, eps_ins=0.2, seed=5)
                out.append(base)
                if algo == "MC":
                    out.append(dict(base, rng="fused", chain0=2))
                    if form == "LIN" and task != "MLT":
                        out.append(dict(base, rng="fused", n_chains=3))
                if task == "CLS":
                    out.append(dict(base, driver="stream", decay=0.25))
                    out.append(dict(base, driver="stream", window=3))
                    out.append(dict(base, pad_features=4)
                               if form == "LIN" else dict(base, jitter=1e-3))
    return out


def test_fingerprints_match_the_reference():
    """The same config gives the same fingerprint JSON in both packages:
    the LIN configs directly, the Nystrom ones through each package's
    NystromSVM delegate (PhiSpec's repr included)."""
    grid = _config_grid()
    assert len(grid) == 32
    for kw in grid:
        if kw["formulation"] == "LIN":
            ours = resume_mod.config_fingerprint(SVMConfig(**kw))
            theirs = ref_resume.config_fingerprint(RefConfig(**kw))
        else:
            ours = resume_mod.config_fingerprint(NystromSVM(
                SVMConfig(**kw), device="cpu").svm.config)
            theirs = ref_resume.config_fingerprint(
                RefNystrom(RefConfig(**kw)).svm.config)
        assert ours == theirs, kw
    assert resume_mod._SEMANTIC_FIELDS == ref_resume._SEMANTIC_FIELDS
    assert resume_mod.step_id(7, 3) == ref_resume.step_id(7, 3)


def _layout(d):
    """Every committed snapshot's (step, array names/dtypes/shapes, meta
    keys) in a directory."""
    ck = Checkpointer(d, keep_k=100)
    out = {}
    for step in ck.all_steps():
        arrays, manifest = ck.restore_named(step)
        out[step] = ({k: (str(v.dtype), v.shape) for k, v in arrays.items()},
                     sorted(manifest["meta"]))
    return out


@pytest.mark.parametrize("case", ["loop-em", "stream-mc-midpass",
                                  "stream-window", "scan-mlt"])
def test_snapshot_layout_matches_the_reference(case, tmp_path):
    """The same fit checkpointed by both packages: the same committed
    steps, and at each the same array names, dtypes and shapes and the
    same meta keys; the boundary key words are equal (the key chain is
    the reference's, EM included)."""
    kw = dict(max_iters=6, min_iters=6, burnin=2, chunk_rows=64,
              scan_chunk=2)
    pol = dict(ckpt_every=2, keep_k=100)
    y, donor_kw = Y_CLS, None
    if case == "loop-em":
        kw.update(driver="loop")
    elif case == "stream-mc-midpass":
        kw.update(driver="stream", algorithm="MC")
        pol.update(ckpt_chunks=2)
    elif case == "stream-window":
        kw.update(driver="stream", algorithm="MC", window=2, max_iters=3,
                  min_iters=3)
        donor_kw = dict(kw)
    else:
        kw.update(task="MLT", num_classes=3, algorithm="MC", eps=1e-1)
        y = Y_MLT
    dp, dr = str(tmp_path / "port"), str(tmp_path / "ref")
    pfit = dict(warm_start=svm(SVMConfig(**donor_kw)).fit(X, y)) \
        if donor_kw else {}
    rfit = dict(warm_start=RefSVM(RefConfig(**donor_kw)).fit(X, y)) \
        if donor_kw else {}
    svm(SVMConfig(**kw, fault=FaultPolicy(ckpt_dir=dp, **pol))).fit(
        X, y, **pfit)
    RefSVM(RefConfig(**kw, fault=RefPolicy(ckpt_dir=dr, **pol))).fit(
        X, y, **rfit)
    port, ref = _layout(dp), _layout(dr)
    assert port == ref and len(port) >= 2
    for step in port:
        a, _ = Checkpointer(dp, keep_k=100).restore_named(step)
        b, _ = Checkpointer(dr, keep_k=100).restore_named(step)
        assert np.array_equal(a["key"], b["key"]), step
        if "sub" in a:
            assert np.array_equal(a["sub"], b["sub"]), step


def _em_band(res, ref):
    """tests/test_torch_em_cls.py's bands against the reference."""
    assert res.n_iters == ref.n_iters
    o, r = np.asarray(res.objective), np.asarray(ref.objective)
    assert np.max(np.abs(o - r) / np.abs(r)) <= 2e-2
    assert (np.linalg.norm(res.weights - ref.weights)
            / np.linalg.norm(ref.weights)) <= 5e-2


@pytest.mark.parametrize("driver", ["loop", "stream"])
def test_resume_across_packages(driver, tmp_path):
    """A port fit resumed from the reference's snapshot (for the stream
    driver a MID-PASS one: the reference's partial totals and cursor)
    lands within the port-vs-reference bands of the reference's
    uninterrupted fit, and a reference fit resumed from the port's
    snapshot within them of the port's uninterrupted fit."""
    Xs, ys = _stream_problem()
    kw = dict(algorithm="EM", driver=driver, chunk_rows=100, max_iters=12,
              min_iters=12)
    ref = RefSVM(RefConfig(**kw)).fit(Xs, ys)
    port = svm(SVMConfig(**kw)).fit(Xs, ys)
    dr, dp = str(tmp_path / "ref"), str(tmp_path / "port")
    pol = dict(ckpt_every=3, ckpt_chunks=4 if driver == "stream" else 0)
    with pytest.raises(ref_faults.SimulatedPreemption):
        RefSVM(RefConfig(**kw, fault=RefPolicy(ckpt_dir=dr, **pol))).fit(
            Xs, ys, fault_hook=ref_faults.kill_at_iteration(7))
    with pytest.raises(faults.SimulatedPreemption):
        svm(SVMConfig(**kw, fault=FaultPolicy(ckpt_dir=dp, **pol))).fit(
            Xs, ys, fault_hook=faults.kill_at_iteration(7))
    if driver == "stream":
        assert resume_mod.load_snapshot(Checkpointer(dr))["in_pass"]
    # each resume goes on committing into the other package's directory
    p_from_r = svm(SVMConfig(**kw)).fit(Xs, ys, resume_from=dr)
    r_from_p = RefSVM(RefConfig(**kw)).fit(Xs, ys, resume_from=dp)
    # the last commit: iteration 6's boundary, or the second mid-pass
    # snapshot of iteration 7 (6 iterations done)
    assert p_from_r.resumed_at == r_from_p.resumed_at == 6
    _em_band(p_from_r, ref)
    _em_band(r_from_p, port)


# ------------------------------------------------------- mesh (gloo ranks)
_MESH_CODE = """
import datetime, sys, tempfile, types
import numpy as np
import torch
import torch.distributed as dist
rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
sys.stderr = sys.stdout = open(out + f"/log{rank}", "w", buffering=1)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=240))
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import PEMSVM, SVMConfig, solver
from repro_torch.data import make_alpha_like
from repro_torch.runtime import faults
from repro_torch.runtime.policy import FaultPolicy
saves = [0]
_save = Checkpointer.save
def counted(self, *a, **k):
    saves[0] += 1
    return _save(self, *a, **k)
Checkpointer.save = counted
X, y = make_alpha_like(512, 23, seed=0)
mesh_a = DeviceMesh("cpu", torch.arange(4).view(2, 2),
                    mesh_dim_names=("data", "model"))
mesh_b = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("data",))
res = {}
def fit(cfg, mesh, **kw):
    return PEMSVM(cfg, device="cpu", mesh=mesh).fit(X, y, **kw)
for algo in ("EM", "MC"):
    kw = dict(algorithm=algo, task="CLS", driver="loop", max_iters=10,
              min_iters=10, burnin=3, eps=1e-2)
    d = out + "/ckpt_" + algo
    pol = FaultPolicy(ckpt_dir=d, ckpt_every=3, keep_k=10)
    ref_b = fit(SVMConfig(**kw), mesh_b)
    ref_a = fit(SVMConfig(**kw, k_shard_axis="model"), mesh_a)
    ref_1 = PEMSVM(SVMConfig(**kw), device="cpu").fit(X, y)
    try:
        fit(SVMConfig(**kw, k_shard_axis="model", fault=pol), mesh_a,
            fault_hook=faults.kill_at_iteration(7))
        raise SystemExit("kill did not fire")
    except faults.SimulatedPreemption:
        pass
    res_b = fit(SVMConfig(**kw, fault=pol), mesh_b, resume_from=d,
                resume_step=6_000_000)
    res_a = fit(SVMConfig(**kw, k_shard_axis="model", fault=pol), mesh_a,
                resume_from=d, resume_step=6_000_000)
    fits = [("ref_b", ref_b), ("ref_a", ref_a), ("ref_1", ref_1),
            ("res_b", res_b), ("res_a", res_a)]
    if rank == 0:       # one process resumes on its one device
        fits.append(("res_1", PEMSVM(SVMConfig(**kw, fault=pol),
                                     device="cpu").fit(
            X, y, resume_from=d, resume_step=6_000_000)))
    dist.barrier()
    for name, r in fits:
        res[algo + "_" + name] = r.weights
        res[algo + "_" + name + "_at"] = -1 if r.resumed_at is None \\
            else r.resumed_at
res["saves"] = saves[0]
# straggler drop: the step clock moves only by the injected delays
class Clock:
    t = 0.0
    def __call__(self):
        return self.t
    def sleep(self, s):
        self.t += s
clock = Clock()
solver.time = types.SimpleNamespace(perf_counter=clock)
kw = dict(algorithm="EM", task="CLS", driver="loop", max_iters=10,
          min_iters=10, eps=1e-2)
pol = FaultPolicy(on_straggler="drop", straggler_threshold=1.5,
                  straggler_warmup=2)
m = PEMSVM(SVMConfig(**kw, fault=pol), device="cpu", mesh=mesh_b)
m.report_slow_shard(3)
hook = faults.compose_hooks(
    faults.delay_iterations(range(1, 11), 0.05, sleep=clock.sleep),
    faults.delay_iterations([6] if rank == 3 else [], 2.0,
                            sleep=clock.sleep))
r = m.fit(X, y, fault_hook=hook)
res["drop_w"] = r.weights
res["drop_events"] = np.array([e["it"] for e in r.straggler_events])
res["full_w"] = fit(SVMConfig(**kw), mesh_b).weights
res["live_w"] = fit(SVMConfig(**kw), mesh_b,
                    live=np.array([1, 1, 1, 0], np.float32)).weights
if rank == 0:
    res["sub_w"] = PEMSVM(SVMConfig(**kw), device="cpu").fit(
        X[:384], y[:384]).weights
np.savez(out + f"/rank{rank}.npz", **res)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("resume_mesh")
    try:
        return run_ranks(_MESH_CODE, out)
    except AssertionError as e:
        logs = "".join(f"--- rank {r}\n{(out / f'log{r}').read_text()}"
                       for r in range(4) if (out / f"log{r}").exists())
        raise AssertionError(f"{e}\n{logs}") from None


@pytest.mark.parametrize("algo,band", [("EM", 1e-4), ("MC", 2e-2)])
def test_mesh_remesh_resume(mesh_runs, algo, band):
    """A fit killed on 2 x 2 (k-sharded statistic) after iteration 7
    resumes from its iteration-6 snapshot: on 2 x 2 bitwise the
    uninterrupted 2 x 2 fit; on 4 x 1 and on one device within the band
    that the layout change itself costs (the uninterrupted 4 x 1 and
    one-device fits against the 2 x 2 one, times two, floored at the
    reference's EM 1e-4 / MC 2e-2). Every rank holds the same weights;
    rank 0 alone wrote snapshots."""
    r0 = mesh_runs[0]
    for r in mesh_runs[1:]:
        for k in r:
            if k != "saves":
                assert np.array_equal(r[k], r0[k]), k
    w = {k: r0[f"{algo}_{k}"] for k in ("ref_a", "ref_b", "ref_1", "res_a",
                                        "res_b", "res_1")}
    assert all(int(r0[f"{algo}_res_{k}_at"]) == 6 for k in "ab1")
    assert np.array_equal(w["res_a"], w["ref_a"])
    for k in ("b", "1"):
        layout = _rel_max(w[f"ref_{k}"], w["ref_a"])
        assert _rel_max(w[f"res_{k}"], w[f"ref_{k}"]) <= max(
            2 * layout, band), (k, layout)
    assert int(r0["saves"]) > 0
    assert all(int(r["saves"]) == 0 for r in mesh_runs[1:])


def test_mesh_straggler_drop(mesh_runs):
    """on_straggler='drop': shard 3 is reported slow, rank 3's iteration 6
    is delayed 2 s on the step clock, the ranks agree on the verdict, and
    shard 3's live weight goes to 0 from iteration 7: the fit differs from
    the full one, every rank holds the same weights and events, and a fit
    started with live = [1, 1, 1, 0] lands near the fit on the three
    surviving shards' rows."""
    for r in mesh_runs:
        assert r["drop_events"].tolist() == [6]
        assert np.array_equal(r["drop_w"], mesh_runs[0]["drop_w"])
    r0 = mesh_runs[0]
    assert np.all(np.isfinite(r0["drop_w"]))
    assert not np.allclose(r0["drop_w"], r0["full_w"])
    assert _rel_max(r0["live_w"], r0["sub_w"]) < 5e-2
