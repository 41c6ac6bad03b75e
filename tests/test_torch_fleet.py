"""The port's fleet controller (``repro_torch.runtime.controller``,
``runtime.lease``), case for case with the reference's tests/test_fleet.py
on the CPU: a fleet of fit attempts under a deterministic chaos schedule
(``runtime.faults.FleetSchedule``): kills, graceful terminations, hangs
caught by the progress watchdog, flaky loaders, straggler-forced
degradation and grow-back, recovers to the BITWISE uninterrupted fit;
the controller units (deterministic backoff, terminal classification,
retry budgets, real-OS-process ``SubprocessHost`` lifecycles); lease
election (dueling startup, expiry takeover, torn lease files,
renew-before-mint); and the split-brain proofs: a frozen leader's zombie
worker is fenced out at the rename boundary, and the standby's recovered
model is bitwise the undisturbed fit.

The reference's forced remesh under a controller (one JAX process over
emulated devices) has no counterpart here: a port mesh is one process a
rank, and phase 11 of chip_smoke.py kills a 2 x 2 fit and resumes it on
4 x 1 (tests/test_torch_resume.py on the CPU). The window cases of the
reference file are in tests/test_torch_warm.py and test_torch_resume.py.

Then against the JAX package: the backoff schedule is the reference's
number for number, the lease file is one format (a lease either package
wrote is read, renewed and taken over by the other, and terms and epochs
come from one fence), a port fleet resumes a fit from the reference's
snapshots, and a ``SubprocessHost`` child fits and resumes with
``repro_torch`` alone (no JAX module in the child).
"""
import dataclasses
import os
import textwrap
import threading
import time
import types
import warnings

import numpy as np
import pytest

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.core import PEMSVM as RefSVM
from repro.core import SVMConfig as RefConfig
from repro.runtime.controller import FleetPolicy as RefFleetPolicy
from repro.runtime.lease import LeaseManager as RefLeaseManager
from repro.runtime.lease import LeasePolicy as RefLeasePolicy
from repro.runtime.policy import FaultPolicy as RefFaultPolicy
from repro_torch.checkpoint import (Checkpointer, FencedCommitError,
                                    read_fence)
from repro_torch.core import PEMSVM, SVMConfig
from repro_torch.core import solver as solver_mod
from repro_torch.core.linear import SVMData
from repro_torch.runtime import faults
from repro_torch.runtime.controller import (FleetController, FleetError,
                                            FleetPolicy, LeadershipLost,
                                            SubprocessHost)
from repro_torch.runtime.faults import FleetSchedule
from repro_torch.runtime.lease import (LeaseLost, LeaseManager, LeasePolicy,
                                       LEASE_FILE)
from repro_torch.runtime.policy import FaultPolicy


_rng = np.random.default_rng(0)
N, K = 257, 9
X = _rng.normal(size=(N, K)).astype(np.float32)
_w_true = _rng.normal(size=K + 1)
Y_CLS = np.where(X @ _w_true[:K] + _w_true[K] > 0, 1.0, -1.0).astype(
    np.float32)
Y_SVR = (X @ _w_true[:K]).astype(np.float32)


def _svm(cfg):
    return PEMSVM(cfg, device="cpu")


class _Clock:
    """The drivers' step clock, advanced only by the injected delays;
    ``pace`` also sleeps 20 ms of wall time."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, seconds):
        self.t += seconds

    def pace(self, seconds):
        self.t += seconds
        time.sleep(0.02)


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(solver_mod, "time",
                        types.SimpleNamespace(perf_counter=c))
    return c


def _chunk_factory(tgt):
    """Restartable 5-chunk source over the module data (257 rows padded
    to 5 x 64) — the shape ``fit_chunks`` consumes."""
    Xp = np.concatenate([X, np.zeros((63, K), np.float32)])
    yp = np.concatenate([tgt, np.zeros(63, np.float32)])
    mp = np.concatenate([np.ones(N, np.float32),
                         np.zeros(63, np.float32)])

    def make():
        for i0 in range(0, 320, 64):
            yield SVMData(Xp[i0:i0 + 64], yp[i0:i0 + 64], mp[i0:i0 + 64])
    return make


# ---------------------------------------------- end-to-end chaos recovery
@pytest.mark.parametrize("algo", ["EM", "MC"])
@pytest.mark.parametrize("task", ["CLS", "SVR"])
def test_fleet_chaos_recovers_bitwise(algo, task, tmp_path):
    """The headline: a fleet run through a deterministic chaos schedule
    — SIGKILL-style preemption on attempt 0, SIGTERM-style eviction on
    attempt 1, a flaky loader failing on EVERY attempt — converges to
    the exact bits of the undisturbed fit, for EM and MC, CLS and SVR.
    Every failure funnels into resume-from-snapshot on the same layout,
    so recovery is lossless by construction, not by tolerance."""
    tgt = Y_CLS if task == "CLS" else Y_SVR
    base = _chunk_factory(tgt)
    kw = dict(algorithm=algo, task=task, driver="stream", chunk_rows=64,
              max_iters=12, min_iters=12, burnin=3)
    ref = _svm(SVMConfig(**kw)).fit_chunks(base, K)

    pol = FaultPolicy(ckpt_dir=str(tmp_path), ckpt_every=2,
                      loader_retries=3, loader_backoff=1e-3)
    cfg = SVMConfig(**kw, fault=pol)

    def make_host(level):
        # A FRESH flaky wrapper per attempt: chunk position 2 fails once
        # per attempt, so even the completing attempt absorbs a loader
        # retry (surfaced on FitResult.loader_retries below).
        flaky = faults.io_error_every_nth(base, nth=3, times=1)

        def host(ctx):
            return _svm(cfg).fit_chunks(
                flaky, K, resume_from=ctx.resume_from,
                fault_hook=ctx.fault_hook)
        return host

    fc = FleetController(
        make_host, str(tmp_path),
        policy=FleetPolicy(max_attempts=5, backoff_s=1e-3, seed=3),
        schedule=FleetSchedule({
            0: lambda cancel: faults.kill_at_iteration(4),
            1: lambda cancel: faults.terminate_at_iteration(7),
        }))
    fr = fc.run()

    assert [a.outcome for a in fr.attempts] == [
        "retryable", "retryable", "completed"]
    assert fr.recovered and fr.n_relaunches == 2
    assert fr.attempts[1].resume_step is not None     # resumed, not fresh
    assert fr.result.resumed_at is not None and fr.result.resumed_at >= 6
    assert fr.result.loader_retries >= 1              # flaky loader absorbed
    assert fr.result.loader_backoff_s > 0.0
    assert np.array_equal(ref.weights, fr.result.weights)
    assert np.allclose(ref.objective, fr.result.objective)


def test_fleet_watchdog_catches_hang(tmp_path):
    """A worker that stops advancing WITHOUT dying (the failure liveness
    checks miss): the monotonic-progress watchdog sees no checkpoint
    advance, cancels the attempt, and the relaunch finishes bitwise."""
    kw = dict(algorithm="EM", task="CLS", driver="loop", max_iters=10,
              min_iters=10)
    ref = _svm(SVMConfig(**kw)).fit(X, Y_CLS)
    pol = FaultPolicy(ckpt_dir=str(tmp_path), ckpt_every=1)
    cfg = SVMConfig(**kw, fault=pol)

    def make_host(level):
        def host(ctx):
            return _svm(cfg).fit(X, Y_CLS, resume_from=ctx.resume_from,
                                   fault_hook=ctx.fault_hook)
        return host

    fc = FleetController(
        make_host, str(tmp_path),
        # watchdog_s outlasts the first commit but not the injected hang
        policy=FleetPolicy(max_attempts=3, backoff_s=1e-3,
                           watchdog_s=3.0, poll_s=0.02),
        schedule=FleetSchedule({
            0: lambda cancel: faults.hang_at_iteration(
                3, until=cancel, max_seconds=30.0),
        }))
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # cooperative cancel: no abandon
        fr = fc.run()

    assert [a.outcome for a in fr.attempts] == ["watchdog", "completed"]
    assert fr.attempts[0].commits >= 1
    assert fr.attempts[0].first_commit_s is not None
    assert fr.result.resumed_at == 3
    assert np.array_equal(ref.weights, fr.result.weights)


def test_fleet_abandons_noncooperative_hang(tmp_path):
    """A worker stuck INSIDE one iteration never reaches the fault hook,
    so it cannot observe cancel: the watchdog fires, the supervise loop
    waits at most kill_grace_s for it to exit, and run() abandons the
    daemon thread (RuntimeWarning) instead of spinning on it forever —
    the relaunch then completes normally."""
    kw = dict(algorithm="EM", task="CLS", driver="loop", max_iters=8,
              min_iters=8)
    ref = _svm(SVMConfig(**kw)).fit(X, Y_CLS)
    cfg = SVMConfig(**kw, fault=FaultPolicy(ckpt_dir=str(tmp_path),
                                            ckpt_every=1))
    release = threading.Event()   # bounds the abandoned worker's life

    def make_host(level):
        def host(ctx):
            if ctx.attempt == 0:
                release.wait(30.0)    # ignores ctx.cancel entirely
                raise RuntimeError("hung worker released")
            return _svm(cfg).fit(X, Y_CLS, resume_from=ctx.resume_from,
                                   fault_hook=ctx.fault_hook)
        return host

    fc = FleetController(
        make_host, str(tmp_path),
        policy=FleetPolicy(max_attempts=3, backoff_s=1e-3,
                           watchdog_s=0.3, poll_s=0.02,
                           kill_grace_s=0.2))
    try:
        with pytest.warns(RuntimeWarning, match="abandoning"):
            fr = fc.run()
    finally:
        release.set()

    assert [a.outcome for a in fr.attempts] == ["abandoned", "completed"]
    # Abandoned within ~watchdog + grace, not the worker's 30s hang.
    assert fr.attempts[0].seconds < 5.0
    assert fr.recovered and fr.final_level == 0
    assert np.array_equal(ref.weights, fr.result.weights)


def test_fleet_straggler_degrade_then_growback(tmp_path, clock):
    """``on_straggler="raise"`` escalates to the controller: the fleet
    SHRINKS one provisioning level, and after ``recover_commits`` of
    observed progress at the degraded level it cancels the attempt and
    GROWS back to level 0 — three lifecycles, one bitwise trajectory.
    (Both levels keep the single-device layout here, so parity stays
    bitwise.) The verdicts come from the step clock, which only the
    injected delays advance; each iteration also sleeps 20 ms of wall
    time, so the controller sees the degraded attempt's commits."""
    kw = dict(algorithm="EM", task="CLS", driver="loop", max_iters=14,
              min_iters=14)
    ref = _svm(SVMConfig(**kw)).fit(X, Y_CLS)
    pol = FaultPolicy(ckpt_dir=str(tmp_path), ckpt_every=1,
                      on_straggler="raise", straggler_threshold=3.0,
                      straggler_warmup=2)
    cfg = SVMConfig(**kw, fault=pol)
    # a uniform floor, so that only the spike at iteration 6 crosses
    # 3 x EMA
    floor = faults.delay_iterations(range(1, 15), 0.05, sleep=clock.pace)
    levels_used = []

    def make_host(level):
        levels_used.append(level)

        def host(ctx):
            return _svm(cfg).fit(X, Y_CLS, resume_from=ctx.resume_from,
                                   fault_hook=ctx.fault_hook)
        return host

    fc = FleetController(
        make_host, str(tmp_path),
        policy=FleetPolicy(max_attempts=5, backoff_s=1e-3,
                           recover_commits=1, poll_s=0.01),
        n_levels=2,
        schedule=FleetSchedule({
            0: lambda cancel: faults.compose_hooks(
                floor, faults.delay_iterations([6], 0.5,
                                               sleep=clock.sleep)),
            1: lambda cancel: floor,
            2: lambda cancel: floor,
        }))
    fr = fc.run()

    assert [a.outcome for a in fr.attempts] == [
        "straggler", "reprovision", "completed"]
    assert levels_used == [0, 1, 0]
    assert fr.final_level == 0
    assert np.array_equal(ref.weights, fr.result.weights)


# -------------------------------------------------- controller unit tests
def test_relaunch_delay_deterministic():
    pol = FleetPolicy(backoff_s=0.1, backoff_cap_s=1.0, jitter=0.2,
                      seed=7)
    d = pol.relaunch_delay(1, 2)
    assert d == pol.relaunch_delay(1, 2)            # replayable
    assert d != pol.relaunch_delay(1, 3)            # decorrelated
    assert 0.1 <= d <= 0.1 * 1.2                    # jitter bounds
    assert d != FleetPolicy(backoff_s=0.1, backoff_cap_s=1.0, jitter=0.2,
                            seed=8).relaunch_delay(1, 2)

    flat = FleetPolicy(backoff_s=0.1, backoff_cap_s=10.0, jitter=0.0)
    assert flat.relaunch_delay(1, 0) == pytest.approx(0.1)
    assert flat.relaunch_delay(3, 0) == pytest.approx(0.4)  # doubles
    capped = FleetPolicy(backoff_s=0.1, backoff_cap_s=0.15, jitter=0.0)
    assert capped.relaunch_delay(5, 0) == pytest.approx(0.15)


def test_terminal_classification_beats_retryable(tmp_path):
    """FileNotFoundError IS an OSError (retryable family), but the
    terminal check runs first — a poisoned/missing checkpoint must not
    burn the retry budget on a config problem retrying cannot fix."""
    def make_host(level):
        def host(ctx):
            raise FileNotFoundError("poisoned checkpoint directory")
        return host

    fc = FleetController(make_host, str(tmp_path),
                         policy=FleetPolicy(max_attempts=4))
    with pytest.raises(FleetError) as ei:
        fc.run()
    assert isinstance(ei.value.cause, FileNotFoundError)
    assert len(ei.value.attempts) == 1              # no retries spent
    assert ei.value.attempts[0].outcome == "terminal"


def test_fingerprint_mismatch_is_terminal(tmp_path):
    """The real terminal path end-to-end: a relaunch with a DIFFERENT
    semantic config hits the resume fingerprint check (ValueError naming
    the field) and the controller stops immediately."""
    kw = dict(algorithm="EM", task="CLS", driver="loop", max_iters=4,
              min_iters=4)
    pol = FaultPolicy(ckpt_dir=str(tmp_path), ckpt_every=2)
    _svm(SVMConfig(**kw, fault=pol)).fit(X, Y_CLS)   # donor checkpoint

    def make_host(level):
        def host(ctx):
            return _svm(SVMConfig(**kw, lam=2.0, fault=pol)).fit(
                X, Y_CLS, resume_from=ctx.resume_from)
        return host

    fc = FleetController(make_host, str(tmp_path),
                         policy=FleetPolicy(max_attempts=4))
    with pytest.raises(FleetError) as ei:
        fc.run()
    assert "lam" in str(ei.value.cause)
    assert ei.value.attempts[0].outcome == "terminal"


def test_retry_budget_exhausted_with_deterministic_backoff(tmp_path):
    def make_host(level):
        def host(ctx):
            raise IOError("host storage gone")
        return host

    slept = []
    pol = FleetPolicy(max_attempts=3, backoff_s=0.01, jitter=0.5, seed=11)
    fc = FleetController(make_host, str(tmp_path), policy=pol,
                         sleep=slept.append)
    with pytest.raises(FleetError, match="budget exhausted"):
        fc.run()
    # Exactly the policy's deterministic schedule, no real sleeping.
    assert slept == [pol.relaunch_delay(1, 1), pol.relaunch_delay(2, 2)]


def test_subprocess_host_died_then_completes(tmp_path):
    """SubprocessHost: a real OS process that crashes on attempt 0
    (HostDied, retryable) and succeeds on attempt 1; ``load_result``
    supplies the controller's return value."""
    code = textwrap.dedent("""
        import os, sys
        if os.environ["FLEET_ATTEMPT"] == "0":
            print("injected crash")
            sys.exit(3)
        print("level", os.environ["FLEET_LEVEL"])
    """)

    fc = FleetController(
        lambda level: SubprocessHost(code, load_result=lambda: "done"),
        str(tmp_path), policy=FleetPolicy(max_attempts=3, backoff_s=0.0))
    fr = fc.run()
    assert fr.result == "done"
    assert [a.outcome for a in fr.attempts] == ["retryable", "completed"]
    assert "exited 3" in fr.attempts[0].error
    assert "injected crash" in fr.attempts[0].error   # output tail kept


def test_subprocess_verbose_child_does_not_deadlock(tmp_path):
    """A child that writes far more than the OS pipe buffer (~64KB) to
    stdout must still exit: stdout is drained concurrently, so a
    healthy-but-verbose worker neither blocks on write nor gets killed
    as a spurious 'watchdog'."""
    code = textwrap.dedent("""
        import sys
        for i in range(4000):
            print("x" * 80)          # ~320KB >> pipe buffer
        sys.exit(0)
    """)

    fc = FleetController(
        lambda level: SubprocessHost(code, load_result=lambda: "ok",
                                     poll_s=0.02),
        str(tmp_path),
        policy=FleetPolicy(max_attempts=1, watchdog_s=20.0,
                           poll_s=0.02))
    fr = fc.run()
    assert fr.result == "ok"
    assert [a.outcome for a in fr.attempts] == ["completed"]


def test_subprocess_watchdog_real_sigterm(tmp_path):
    """A subprocess that never commits progress: the watchdog fires and
    cancellation is REAL (SIGTERM, then SIGKILL past the grace window)
    — no cooperative gap, unlike in-process attempts."""
    code = textwrap.dedent("""
        import os, time
        if os.environ["FLEET_ATTEMPT"] == "0":
            time.sleep(60)          # hung: no commits, no exit
    """)

    fc = FleetController(
        lambda level: SubprocessHost(code, poll_s=0.02),
        str(tmp_path),
        policy=FleetPolicy(max_attempts=3, backoff_s=1e-3,
                           watchdog_s=0.5, poll_s=0.02, kill_grace_s=2.0))
    fr = fc.run()
    assert [a.outcome for a in fr.attempts] == ["watchdog", "completed"]
    assert fr.attempts[0].seconds < 30.0              # killed, not waited


# --------------------------------------------------- loader retry surface
def test_retrying_chunks_jitter_deterministic():
    """Backoff jitter is keyed on the seed: the same (seed, failure
    sequence) sleeps the same schedule bit-for-bit; a different seed
    desynchronizes. RetryStats surfaces what was absorbed."""
    import itertools

    from repro_torch.data import RetryStats
    from repro_torch.data.pipeline import retrying_chunks

    def run(seed):
        inj = faults.io_error_every_nth(lambda: iter(range(6)), 2,
                                        times=1)
        slept, stats = [], RetryStats()
        out = list(retrying_chunks(
            lambda skip: itertools.islice(inj(), skip, None),
            retries=3, backoff=0.5, jitter=0.3, seed=seed,
            sleep=slept.append, stats=stats))
        return out, slept, stats

    out_a, slept_a, st_a = run(seed=5)
    out_b, slept_b, _ = run(seed=5)
    out_c, slept_c, _ = run(seed=6)
    assert out_a == out_b == out_c == list(range(6))  # all drained
    assert slept_a == slept_b                         # replayable
    assert slept_a != slept_c                         # decorrelated
    assert len(slept_a) == 3                          # positions 1, 3, 5
    for s in slept_a:
        assert 0.5 <= s <= 0.5 * 1.3                  # base * (1+j*U)
    assert st_a.retries == 3 and st_a.exhausted == 0
    assert st_a.backoff_s == pytest.approx(sum(slept_a))


# -------------------------------------------------- lease election units
def _clockpair(d, ttl=2.0):
    """Two managers on one dir sharing a settable fake clock."""
    t = [0.0]
    pol = LeasePolicy(ttl_s=ttl)
    a = LeaseManager(str(d), "A", policy=pol, clock=lambda: t[0])
    b = LeaseManager(str(d), "B", policy=pol, clock=lambda: t[0])
    return a, b, t


def test_lease_dueling_startup_one_winner(tmp_path):
    """O_EXCL arbitration: of two controllers starting on an empty
    directory, exactly one becomes leader at term 1 (and the fence
    advances with it); the other stands by."""
    a, b, t = _clockpair(tmp_path)
    la, lb = a.try_acquire(), b.try_acquire()
    assert la is not None and lb is None
    assert la.term == 1 and la.owner == "A"
    assert read_fence(str(tmp_path)) == 1
    assert b.try_acquire() is None                   # still standing by
    assert a.try_acquire().term == 1                 # re-entrant for owner


def test_lease_expiry_takeover_advances_term_and_fence(tmp_path):
    a, b, t = _clockpair(tmp_path, ttl=2.0)
    assert a.try_acquire().term == 1
    t[0] = 1.0
    a.renew()                                        # healthy heartbeat
    assert b.try_acquire() is None
    t[0] = 3.5                                       # stamp 1.0 + ttl 2.0 < now
    lb = b.try_acquire()
    assert lb is not None and lb.term == 2           # term+1 takeover
    assert read_fence(str(tmp_path)) == 2            # fence rides along
    with pytest.raises(LeaseLost, match="deadline"):
        a.renew()                                    # deposed leader
    assert b.read().owner == "B"                     # A never wrote


def test_lease_renew_refuses_past_own_deadline_before_writing(tmp_path):
    """The frozen-leader-wakes race: a leader past its OWN ttl must not
    touch the lease file even if no usurper has appeared yet — the
    check is on its own stamp, not on what is on disk."""
    a, b, t = _clockpair(tmp_path, ttl=1.0)
    a.try_acquire()
    t[0] = 5.0                                       # woke from a long pause
    with pytest.raises(LeaseLost, match="standing down"):
        a.renew()
    assert a.read().owner == "A"                     # file untouched
    assert a.state is None                           # holder gave it up


def test_lease_torn_file_is_breakable(tmp_path):
    a, b, t = _clockpair(tmp_path)
    assert a.try_acquire().term == 1
    faults.tear_file(os.path.join(str(tmp_path), LEASE_FILE), 7)
    assert a.read() is None                          # unreadable != crash
    lb = b.try_acquire()                             # torn -> breakable now
    assert lb is not None and lb.term == 2


def test_lease_release_lets_standby_in_immediately(tmp_path):
    a, b, t = _clockpair(tmp_path)
    a.try_acquire()
    b.release()                                      # non-owner: no-op
    assert a.read().owner == "A"
    a.release()
    assert a.read() is None
    assert b.try_acquire().term == 2                 # no ttl wait needed


def test_mint_epoch_requires_live_lease(tmp_path):
    """Renew-before-mint at the lease level: mint_epoch verifies
    ownership in the SAME critical section that advances the fence, so
    a manager whose lease expired (or was usurped) raises LeaseLost
    WITHOUT advancing — the usurper's term stays the top of the
    counter."""
    a, b, t = _clockpair(tmp_path, ttl=2.0)
    assert a.try_acquire().term == 1
    assert a.mint_epoch() == 2                   # healthy leader mints
    assert read_fence(str(tmp_path)) == 2
    t[0] = 5.0                                   # a's lease ages out
    lb = b.try_acquire()
    assert lb is not None and lb.term == 3       # past fence AND term
    with pytest.raises(LeaseLost):
        a.mint_epoch()                           # deposed: refuses
    assert read_fence(str(tmp_path)) == 3        # fence NOT advanced
    assert b.renew().term == 3                   # usurper unharmed


def test_stale_leader_cannot_fence_out_usurper(tmp_path):
    """THE fence-inversion regression: leader A's lease silently
    expires mid-attempt (a renewal-free window) and standby B takes
    over at term 2. A's relaunch must NOT advance the shared fence
    past B's term — that would fence out the LEGITIMATE leader's
    workers and outrank B's line in (epoch, step) restore order. With
    renew-before-mint, A stands down with LeadershipLost and the fence
    still reads B's term."""
    d = str(tmp_path)
    t = [0.0]
    lease = LeasePolicy(ttl_s=2.0)
    usurper = LeaseManager(d, "B", policy=lease, clock=lambda: t[0])

    def make_host(level):
        def host(ctx):
            # While A's attempt runs: its lease ages out unnoticed
            # (the clock jump) and B takes over; then a retryable
            # failure sends A toward a relaunch it must refuse.
            t[0] = 5.0
            assert usurper.try_acquire() is not None
            raise IOError("flaky host")
        return host

    A = FleetController(
        make_host, d,
        policy=FleetPolicy(max_attempts=3, backoff_s=1e-3, poll_s=0.01),
        lease=lease, owner="A", clock=lambda: t[0])
    with pytest.raises(LeadershipLost):
        A.run()
    assert read_fence(d) == 2                    # B's term, NOT beyond
    assert usurper.read().owner == "B"           # lease untouched by A


def test_leader_renews_through_drain_window(tmp_path):
    """Abandoning one non-cooperative worker must not cost the lease:
    kill_grace_s EXCEEDS the ttl here, so a renewal-free cancel-drain
    would guarantee an unnecessary takeover (and the relaunch mint
    would then stand down). With the drain heartbeat the same
    controller keeps its term across the abandon and completes."""
    kw = dict(algorithm="EM", task="CLS", driver="loop", max_iters=6,
              min_iters=6)
    ref = _svm(SVMConfig(**kw)).fit(X, Y_CLS)
    d = str(tmp_path)
    cfg = SVMConfig(**kw, fault=FaultPolicy(ckpt_dir=d, ckpt_every=1))
    release = threading.Event()

    def make_host(level):
        def host(ctx):
            if ctx.attempt == 0:
                release.wait(30.0)               # ignores cancel
                raise RuntimeError("hung worker released")
            return _svm(cfg).fit(X, Y_CLS, resume_from=ctx.resume_from,
                                   fault_hook=ctx.fault_hook,
                                   epoch=ctx.epoch)
        return host

    fc = FleetController(
        make_host, d,
        policy=FleetPolicy(max_attempts=3, backoff_s=1e-3,
                           watchdog_s=0.3, poll_s=0.02,
                           kill_grace_s=1.2),
        lease=LeasePolicy(ttl_s=0.6, renew_every_s=0.1), owner="A")
    try:
        with pytest.warns(RuntimeWarning, match="abandoning"):
            fr = fc.run()
    finally:
        release.set()

    assert [a.outcome for a in fr.attempts] == ["abandoned", "completed"]
    assert fr.term == 1                          # never deposed
    assert fc._lease.read() is None              # released cleanly
    assert np.array_equal(ref.weights, fr.result.weights)


def test_renew_oserror_is_missed_heartbeat(tmp_path, monkeypatch):
    """An OSError from the lease WRITE (ENOSPC-style) mid-supervision
    must neither crash the controller out from under a live worker nor
    depose it: the failure is a missed heartbeat (one RuntimeWarning
    per streak), renewals retry next poll, and once the disk recovers
    the reign completes with its term intact."""
    kw = dict(algorithm="EM", task="CLS", driver="loop", max_iters=8,
              min_iters=8)
    d = str(tmp_path)
    cfg = SVMConfig(**kw, fault=FaultPolicy(ckpt_dir=d, ckpt_every=1))

    def make_host(level):
        def host(ctx):
            return _svm(cfg).fit(X, Y_CLS, resume_from=ctx.resume_from,
                                   fault_hook=ctx.fault_hook,
                                   epoch=ctx.epoch)
        return host

    real = LeaseManager._write_replace
    fails = {"n": 0}

    def flaky_write(self, st):
        # Acquisition goes through _write_excl, so this hits RENEWALS:
        # fail the first two, then recover.
        if fails["n"] < 2:
            fails["n"] += 1
            raise OSError(28, "No space left on device")
        return real(self, st)

    monkeypatch.setattr(LeaseManager, "_write_replace", flaky_write)
    fc = FleetController(
        make_host, d, policy=FleetPolicy(max_attempts=2, poll_s=0.01),
        lease=LeasePolicy(ttl_s=5.0, renew_every_s=0.01), owner="A")
    with pytest.warns(RuntimeWarning, match="missed heartbeat"):
        fr = fc.run()

    assert fails["n"] >= 1                       # failure was exercised
    assert fr.term == 1
    assert [a.outcome for a in fr.attempts] == ["completed"]


def test_controller_mints_fresh_epoch_per_attempt(tmp_path):
    """Even without an election, every launch gets a fresh fence epoch
    advanced BEFORE the attempt starts — the abandoned-worker
    window is closed by construction, not by the election feature."""
    seen = []

    def make_host(level):
        def host(ctx):
            seen.append(ctx.epoch)
            if ctx.attempt == 0:
                raise IOError("flaky host")
            return "ok"
        return host

    fc = FleetController(make_host, str(tmp_path),
                         policy=FleetPolicy(max_attempts=3, backoff_s=0.0))
    fr = fc.run()
    assert seen == [1, 2]
    assert [a.epoch for a in fr.attempts] == [1, 2]
    assert read_fence(str(tmp_path)) == 2
    assert fr.term == 0                              # no election configured


def test_standby_timeout_gives_up_cleanly(tmp_path):
    foreign = LeaseManager(str(tmp_path), "other")
    assert foreign.try_acquire() is not None         # healthy live leader

    def make_host(level):
        def host(ctx):                               # must never launch
            raise AssertionError("standby launched a host")
        return host

    fc = FleetController(
        make_host, str(tmp_path), policy=FleetPolicy(max_attempts=1),
        lease=LeasePolicy(ttl_s=30.0, poll_s=0.02, standby_timeout_s=0.15),
        owner="B")
    with pytest.raises(FleetError, match="standing by"):
        fc.run()


# ------------------------------------------------ split-brain chaos proofs
def test_dueling_controllers_elect_and_both_finish_bitwise(tmp_path):
    """Two controllers started on the SAME checkpoint directory with no
    coordination beyond the lease file: one leads and fits; the other
    stands by, acquires after the release, resumes from the final
    snapshot (instantly — the fit is already converged), and both
    return the bitwise-identical model."""
    kw = dict(algorithm="EM", task="CLS", driver="loop", max_iters=8,
              min_iters=8)
    ref = _svm(SVMConfig(**kw)).fit(X, Y_CLS)
    cfg = SVMConfig(**kw, fault=FaultPolicy(ckpt_dir=str(tmp_path),
                                            ckpt_every=1))

    def make_host(level):
        def host(ctx):
            return _svm(cfg).fit(X, Y_CLS, resume_from=ctx.resume_from,
                                   fault_hook=ctx.fault_hook,
                                   epoch=ctx.epoch)
        return host

    def ctrl(owner):
        return FleetController(
            make_host, str(tmp_path),
            policy=FleetPolicy(max_attempts=2, poll_s=0.02),
            lease=LeasePolicy(ttl_s=5.0, poll_s=0.05), owner=owner)

    out = {}
    ts = [threading.Thread(target=lambda o=o: out.update({o: ctrl(o).run()}))
          for o in ("A", "B")]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=120)
        assert not th.is_alive()

    terms = sorted(fr.term for fr in out.values())
    assert terms[0] >= 1 and terms[1] > terms[0]      # distinct reigns
    for fr in out.values():
        assert np.array_equal(ref.weights, fr.result.weights)
    # The loser's fit resumed from the winner's FINAL snapshot.
    late = max(out.values(), key=lambda fr: fr.term)
    assert late.result.resumed_at == 8


def test_frozen_leader_takeover_fences_zombie_commit(tmp_path):
    """The acceptance scenario of co-supervision. Controller A leads and its
    worker commits; A freezes mid-supervision (injected GC pause) while
    its worker blocks NON-cooperatively inside an iteration (ignores
    cancel — a genuine zombie). Standby B's lease expires A, takes over
    at term+1 (fence rides along), resumes from A's last commit and
    completes. The zombie is then released: it attempts its next
    boundary commit and is REJECTED at the rename boundary
    (FencedCommitError) — the on-disk record set does not change. A
    thaws, notices its lease is gone, and raises LeadershipLost. B's
    model is bitwise the undisturbed single-controller fit on the same
    layout."""
    kw = dict(algorithm="EM", task="CLS", driver="loop", max_iters=14,
              min_iters=14)
    ref = _svm(SVMConfig(**kw)).fit(X, Y_CLS)
    d = str(tmp_path)
    cfg = SVMConfig(**kw, fault=FaultPolicy(ckpt_dir=d, ckpt_every=1))

    frozen = threading.Event()
    release = threading.Event()
    zombie = {}

    def make_host_a(level):
        def host(ctx):
            # ROGUE worker: ignores ctx.fault_hook (and with it the
            # controller's cancel) — blocks at iteration 5 until the
            # TEST releases it, then keeps fitting and tries to commit.
            try:
                return _svm(cfg).fit(
                    X, Y_CLS, resume_from=ctx.resume_from,
                    fault_hook=faults.hold_at_iteration(
                        5, release=release, max_seconds=120.0),
                    epoch=ctx.epoch)
            except Exception as e:
                zombie["error"] = e
                raise
        return host

    def make_host_b(level):
        def host(ctx):
            return _svm(cfg).fit(X, Y_CLS, resume_from=ctx.resume_from,
                                   fault_hook=ctx.fault_hook,
                                   epoch=ctx.epoch)
        return host

    lease = LeasePolicy(ttl_s=0.6, renew_every_s=0.1, poll_s=0.05)
    A = FleetController(
        make_host_a, d,
        policy=FleetPolicy(max_attempts=2, poll_s=0.02,
                           kill_grace_s=0.3),
        lease=lease, owner="A",
        sleep=faults.freezable_sleep(frozen, max_seconds=120.0))
    B = FleetController(
        make_host_b, d,
        policy=FleetPolicy(max_attempts=2, poll_s=0.02),
        lease=lease, owner="B")

    out = {}

    def run_a():
        try:
            out["A"] = A.run()
        except FleetError as e:
            out["A"] = e

    ta = threading.Thread(target=run_a)
    ta.start()
    # Wait until A's worker has committed and is held at iteration 5.
    deadline = time.monotonic() + 60.0
    ck = Checkpointer(d, keep_k=0)
    while (ck.latest_record() or (0, 0))[1] < 5_000_000:
        assert time.monotonic() < deadline, "A's worker never reached it=5"
        time.sleep(0.02)
    assert read_fence(d) == 1                        # A's reign, epoch 1
    frozen.set()                                     # leader goes dark

    fr_b = None
    tb = threading.Thread(
        target=lambda: out.__setitem__("B", B.run()))
    tb.start()
    tb.join(timeout=120)
    assert not tb.is_alive()
    fr_b = out["B"]
    assert fr_b.term == 2                            # takeover at term+1
    assert fr_b.attempts[0].epoch == 2
    assert fr_b.result.resumed_at == 5               # resumed A's line
    assert np.array_equal(ref.weights, fr_b.result.weights)  # BITWISE

    # Release the zombie: it fits on and attempts its next boundary
    # commit, which the fence must reject without touching the records.
    records_before = ck.all_records()
    release.set()
    deadline = time.monotonic() + 60.0
    while "error" not in zombie:
        assert time.monotonic() < deadline, "zombie never hit the fence"
        time.sleep(0.02)
    assert isinstance(zombie["error"], FencedCommitError)
    assert zombie["error"].epoch == 1 and zombie["error"].fence == 2
    assert ck.all_records() == records_before        # nothing landed
    assert ck.latest_record()[0] == 2                # B's line on top

    # Thaw A: its next renewal sees the missed deadline and it stands
    # down with LeadershipLost (abandoning the already-dead worker).
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        frozen.clear()
        ta.join(timeout=120)
    assert not ta.is_alive()
    assert isinstance(out["A"], LeadershipLost)
    # Depending on whether the zombie thread was already dead at thaw,
    # A notices via the fenced commit or via its missed renewal.
    assert out["A"].attempts[0].outcome in ("fenced", "abandoned",
                                            "lease-lost")

    # The directory's resolved restore is B's line — epoch-major, so
    # even a zombie commit that HAD raced past the fence could not
    # outrank it.
    arrays, manifest = ck.restore_named()
    assert manifest["epoch"] == 2


# ----------------------------------------------- against the JAX package
def test_backoff_schedule_is_the_references():
    for kw in (dict(), dict(backoff_s=0.1, backoff_cap_s=1.0, jitter=0.2,
                            seed=7), dict(jitter=0.5, seed=11)):
        ours, theirs = FleetPolicy(**kw), RefFleetPolicy(**kw)
        for c in range(1, 6):
            for a in range(4):
                assert ours.relaunch_delay(c, a) == theirs.relaunch_delay(
                    c, a)


@pytest.mark.parametrize("first", ["ref", "port"])
def test_lease_is_one_file_across_packages(tmp_path, first):
    """A lease one package wrote is the other's: read as the same state,
    healthy (standby), then taken over past its ttl at term + 1 with the
    fence; the deposed holder refuses to renew past its own deadline and
    never touches the usurper's file."""
    t = [0.0]
    pol = (RefLeasePolicy if first == "ref" else LeasePolicy)(ttl_s=2.0)
    mk_a, mk_b = ((RefLeaseManager, LeaseManager) if first == "ref"
                  else (LeaseManager, RefLeaseManager))
    a = mk_a(str(tmp_path), "A", policy=pol, clock=lambda: t[0])
    b = mk_b(str(tmp_path), "B", policy=pol, clock=lambda: t[0])
    la = a.try_acquire()
    assert la.term == 1 and read_fence(str(tmp_path)) == 1
    assert dataclasses.astuple(b.read()) == dataclasses.astuple(la)
    assert b.try_acquire() is None
    t[0] = 3.5
    lb = b.try_acquire()
    assert lb is not None and lb.term == 2 and lb.owner == "B"
    assert read_fence(str(tmp_path)) == 2
    assert type(a.read()).__name__ == "LeaseState" and a.read().owner == "B"
    with pytest.raises(RuntimeError, match="deadline"):
        a.renew()
    assert b.mint_epoch() == 3 and read_fence(str(tmp_path)) == 3


def test_port_fleet_resumes_the_references_fit(tmp_path):
    """A reference fit preempted after iteration 6 leaves its snapshots; a
    port fleet on that directory mints the next epoch, resumes from them
    and completes within the port-vs-reference bands of the reference's
    uninterrupted fit (tests/test_torch_em_cls.py)."""
    kw = dict(algorithm="EM", task="CLS", driver="loop", max_iters=10,
              min_iters=10)
    d = str(tmp_path)
    ref = RefSVM(RefConfig(**kw)).fit(X, Y_CLS)
    from repro.runtime import faults as ref_faults
    with pytest.raises(ref_faults.SimulatedPreemption):
        RefSVM(RefConfig(**kw, fault=RefFaultPolicy(ckpt_dir=d,
                                                    ckpt_every=3))).fit(
            X, Y_CLS, fault_hook=ref_faults.kill_at_iteration(7))
    cfg = SVMConfig(**kw, fault=FaultPolicy(ckpt_dir=d, ckpt_every=1))

    def make_host(level):
        def host(ctx):
            return _svm(cfg).fit(X, Y_CLS, resume_from=ctx.resume_from,
                                 fault_hook=ctx.fault_hook, epoch=ctx.epoch)
        return host

    fr = FleetController(make_host, d,
                         policy=FleetPolicy(max_attempts=2)).run()
    assert [a.outcome for a in fr.attempts] == ["completed"]
    assert fr.attempts[0].resume_step == 6_000_000
    assert fr.result.resumed_at == 6 and fr.result.n_iters == 10
    assert Checkpointer(d).latest_record() == (1, 10_000_000)
    assert RefCheckpointer(d).latest_record() == (1, 10_000_000)
    o, r = np.asarray(fr.result.objective), np.asarray(ref.objective)
    assert np.max(np.abs(o - r) / np.abs(r)) <= 2e-2
    assert (np.linalg.norm(fr.result.weights - ref.weights)
            / np.linalg.norm(ref.weights)) <= 5e-2


def test_subprocess_host_fits_with_the_port_alone(tmp_path):
    """A ``SubprocessHost`` child (``python -c``, ``repro_torch`` on its
    path from the controller) fits with the port: attempt 0 is preempted
    after iteration 4 and exits nonzero (HostDied, retryable); attempt 1
    resumes from the controller's directory under a fresh epoch and
    finishes bitwise the child's own uninterrupted fit, with no JAX module
    loaded in the child."""
    out = tmp_path / "out.npz"
    code = textwrap.dedent(f"""
        import os, sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from repro_torch.core import PEMSVM, SVMConfig
        from repro_torch.data import make_blobs
        from repro_torch.runtime import FaultPolicy, faults
        X, y = make_blobs(512, 12, seed=3)
        kw = dict(algorithm="MC", driver="loop", max_iters=9,
                  min_iters=9, burnin=2)
        cfg = SVMConfig(**kw, fault=FaultPolicy(
            ckpt_dir={str(tmp_path / 'ckpt')!r}, ckpt_every=2))
        resume = os.environ["FLEET_RESUME"] or None
        epoch = int(os.environ["FLEET_EPOCH"])
        hook = (faults.kill_at_iteration(4)
                if os.environ["FLEET_ATTEMPT"] == "0" else None)
        r = PEMSVM(cfg, device="cpu").fit(X, y, resume_from=resume,
                                          fault_hook=hook, epoch=epoch)
        ref = PEMSVM(SVMConfig(**kw), device="cpu").fit(X, y)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        np.savez({str(out)!r}, w=r.weights, ref=ref.weights,
                 at=r.resumed_at, bad=len(bad))
    """)
    fc = FleetController(
        lambda level: SubprocessHost(
            code, load_result=lambda: dict(np.load(out))),
        str(tmp_path / "ckpt"),
        policy=FleetPolicy(max_attempts=3, backoff_s=0.0))
    fr = fc.run()
    assert [a.outcome for a in fr.attempts] == ["retryable", "completed"]
    assert "SimulatedPreemption" in fr.attempts[0].error
    assert [a.epoch for a in fr.attempts] == [1, 2]
    res = fr.result
    assert int(res["at"]) == 4 and int(res["bad"]) == 0
    assert np.array_equal(res["w"], res["ref"])
