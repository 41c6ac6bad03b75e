"""FleetController: the fit-side supervisor (DESIGN.md §Reliability), the
port's copy of ``repro/runtime/controller.py`` (plain Python and numpy).

A single fit is preemption-safe: kill it at any point and
``fit(resume_from=...)`` replays the identical trajectory from the last
committed snapshot. This module is the outer control loop that treats a
whole fleet of fit attempts as the unit of reliability. The controller
owns worker lifecycles end to end:

  * it LAUNCHES attempts: an in-process callable built per provisioning
    level (``make_host(level)``), or a real OS process
    (:class:`SubprocessHost`, the multi-host simulation: SIGTERM-able,
    crash-isolated);
  * it CONSUMES the signals the workers already emit: ``StragglerError``
    (``FaultPolicy(on_straggler="raise")``), preemption exceptions,
    loader-retry exhaustion, and, through the shared checkpoint
    directory, monotonic progress (``Checkpointer.all_records`` is the
    heartbeat: a worker that commits is alive and advancing; a worker
    that is alive but not committing is indistinguishable from a hang,
    which is what the watchdog assumes);
  * it REACTS per a declarative :class:`FleetPolicy`, the state machine

        attempt --retryable--> backoff --> relaunch (same level)
        attempt --straggler--> DEGRADE (level+1: shrink the mesh)
        attempt --no progress for watchdog_s--> kill --> relaunch
        degraded + recover_commits of progress --> GROW (level-1)
        attempt --terminal--> FleetError (fingerprint mismatch,
                               poisoned checkpoint, unknown exception)

    with retry budgets, exponential backoff with DETERMINISTIC jitter
    (keyed on (policy.seed, attempt)), and shrink/grow re-provisioning by
    relaunching onto a different level's mesh: the checkpoint format is
    layout-free (``core/resume``), so re-provisioning is
    ``make_host(new_level)`` plus resume, with ``elastic.remesh`` placing
    the restored tensors on whatever mesh the new host holds.

Because every worker failure funnels into resume-from-snapshot, the
recovered model is bit-identical to the undisturbed fit whenever the
relaunch keeps the layout, and within the reassociation band across
layouts (``tests/test_torch_fleet.py``, under a deterministic chaos
schedule, ``runtime.faults.FleetSchedule``).

Epoch fencing: the controller mints a fresh attempt EPOCH before every
launch (``advance_fence`` on the shared checkpoint directory, then
``HostContext.epoch`` into the worker's ``fit(..., epoch=)``). A worker
abandoned mid-iteration that later wakes and tries to commit finds the
fence ahead of its epoch and is REJECTED at the rename boundary
(``FencedCommitError``); even a commit that raced past the fence check
orders epoch-major below the successor's, so ``restore`` never selects
it. Hosts that ignore ``ctx.epoch`` still work: their writers run
unfenced.

Multi-controller co-supervision: pass ``lease=LeasePolicy(...)`` and
several controllers may call ``run()`` on the SAME checkpoint directory.
They elect a leader through a crash-safe lease file (``runtime.lease``):
one acquires and supervises, the rest stand by. The leader's heartbeat
covers its whole reign: renewals continue through the cancel-drain
window, the post-supervise join and the relaunch backoff. If the leader
freezes past the ttl anyway, a standby takes over at ``term+1``, which
also advances the fence, so every worker the old leader launched is
fenced out before the new leader launches its first resume. Epoch
minting is renew-before-mint (``LeaseManager.mint_epoch``), so a
controller whose lease silently expired stands down with
:class:`LeadershipLost` without advancing the fence. Loss is also found
at the supervision-loop renewal and through a worker's
``FencedCommitError``; all three end the reign.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
import subprocess
import sys
import threading
import time
import warnings
from typing import Any, Callable

import numpy as np

from repro_torch.checkpoint import (Checkpointer, FencedCommitError,
                                    FencedWriterError, advance_fence,
                                    read_fence)

from .faults import FleetSchedule
from .lease import LeaseLost, LeaseManager, LeasePolicy
from .policy import StragglerError

_CTRL_SEQ = itertools.count()

# the directory that holds the repro_torch package
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class AttemptCancelled(RuntimeError):
    """Raised inside a worker when the controller cancels its attempt
    (watchdog kill or grow-back re-provisioning). Carries no verdict —
    the controller classifies from its own recorded cancel reason."""


class HostDied(RuntimeError):
    """A subprocess host exited nonzero (crash / injected kill)."""


class FleetError(RuntimeError):
    """Terminal controller failure: a non-retryable worker error or an
    exhausted retry budget. ``attempts`` carries the full lifecycle log
    for post-mortems."""

    def __init__(self, msg: str, attempts: list, cause=None):
        super().__init__(msg)
        self.attempts = attempts
        self.cause = cause


class LeadershipLost(FleetError):
    """This controller was deposed mid-supervision: its lease expired
    (missed renewals — frozen, partitioned) or a worker's commit came
    back fenced, both meaning another controller now leads this
    checkpoint directory. NOT a fleet failure — the usurper is already
    resuming the fit from the last committed snapshot; this controller
    must simply stop. ``attempts`` logs the deposed reign."""


@dataclasses.dataclass(frozen=True)
class FleetPolicy:
    """Declarative fleet reaction policy. Everything deterministic:
    backoff jitter is keyed on (seed, attempt index), so a chaos test
    replays the exact schedule and two controllers with different seeds
    never synchronize their retry storms."""

    max_attempts: int = 6           # total launches (incl. the first)
    backoff_s: float = 0.05         # base relaunch delay; doubles per
                                    # CONSECUTIVE failure
    backoff_cap_s: float = 5.0      # exponential growth ceiling
    jitter: float = 0.1             # delay *= 1 + jitter * U[0,1)
    seed: int = 0                   # jitter determinism key
    watchdog_s: float | None = None  # no checkpoint advance within this
                                    # -> presume hang, kill, relaunch
                                    # (None = no watchdog)
    poll_s: float = 0.02            # progress-monitor poll interval
    kill_grace_s: float = 2.0       # cancel -> abandon/SIGKILL deadline
    recover_commits: int = 0        # commits at a degraded level before
                                    # growing back toward level 0
                                    # (0 = stay degraded once shrunk)
    # Classification. Terminal is checked FIRST, so FileNotFoundError
    # (poisoned/empty checkpoint dir) stays terminal even though it is
    # an OSError; ValueError covers the config-fingerprint mismatch and
    # shape mismatches — retrying cannot fix a wrong config. Fencing
    # errors are classified before either: they mean ANOTHER controller
    # leads, which is LeadershipLost, not a worker fault.
    terminal: tuple = (ValueError, FileNotFoundError, AssertionError)
    retryable: tuple = (RuntimeError, IOError, OSError)

    def __post_init__(self):
        assert self.max_attempts >= 1, self.max_attempts
        assert self.backoff_s >= 0.0, self.backoff_s
        assert self.backoff_cap_s >= self.backoff_s
        assert self.jitter >= 0.0, self.jitter
        assert self.watchdog_s is None or self.watchdog_s > 0.0
        assert self.poll_s > 0.0, self.poll_s
        assert self.recover_commits >= 0, self.recover_commits

    def relaunch_delay(self, consecutive: int, attempt: int) -> float:
        """Deterministic backoff before relaunch ``attempt`` after
        ``consecutive`` straight failures (>= 1)."""
        base = min(self.backoff_cap_s,
                   self.backoff_s * (2 ** max(consecutive - 1, 0)))
        u = float(np.random.default_rng((self.seed, attempt)).random())
        return base * (1.0 + self.jitter * u)


@dataclasses.dataclass
class HostContext:
    """Everything one attempt needs from the controller. ``fault_hook``
    composes the scheduled injectors with the controller's cancel check
    — pass it into ``fit(..., fault_hook=ctx.fault_hook)`` (or ignore it
    for hosts, like subprocesses, that are cancelled externally).
    ``epoch`` is the attempt's fence epoch — pass it into
    ``fit(..., epoch=ctx.epoch)`` so this attempt's commits are fenced
    against the directory (a host that ignores it writes unfenced,
    which is safe but forfeits zombie-commit rejection for itself)."""

    attempt: int
    level: int
    resume_from: str | None
    fault_hook: Callable[[int], None]
    cancel: threading.Event
    epoch: int = 0


@dataclasses.dataclass
class AttemptRecord:
    index: int
    level: int
    outcome: str                    # completed | retryable | straggler |
    #                                 watchdog | abandoned | reprovision |
    #                                 lease-lost | fenced | terminal
    error: str | None = None
    resume_step: int | None = None  # latest valid snapshot at launch
    epoch: int = 0                  # fence epoch minted for the attempt
    commits: int = 0                # checkpoint commits observed
    seconds: float = 0.0
    first_commit_s: float | None = None  # launch -> first commit (the
    #                                 recovery-latency numerator)


@dataclasses.dataclass
class FleetResult:
    result: Any                     # the completing attempt's FitResult
    attempts: list                  # AttemptRecord log, launch order
    final_level: int
    n_relaunches: int               # attempts beyond the first
    recovered: bool                 # True if any failure was absorbed
    term: int = 0                   # lease term held while completing
    #                                 (0 = no election configured)


class SubprocessHost:
    """One attempt as a real OS process — the multi-host simulation.

    ``code`` is a self-contained Python program (run via ``python -c``,
    with the directory holding ``repro_torch`` first on its
    ``PYTHONPATH``) that performs the fit and exits 0; it reads its
    attempt context from
    the environment: ``FLEET_ATTEMPT``, ``FLEET_LEVEL``,
    ``FLEET_RESUME`` (empty string = fresh), ``FLEET_EPOCH`` (the fence
    epoch — pass ``int(os.environ["FLEET_EPOCH"])`` into
    ``fit(..., epoch=)`` for fenced commits). Cancellation is REAL
    here: the controller's cancel event becomes SIGTERM, then SIGKILL
    after ``FleetPolicy.kill_grace_s`` — no cooperative gap. Nonzero
    exit raises :class:`HostDied` (retryable); on success
    ``load_result()`` (if given) produces the value returned to the
    controller — e.g. reading the weights the program wrote, or loading
    the final snapshot from the shared checkpoint directory.
    """

    def __init__(self, code: str, *, env: dict | None = None,
                 load_result: Callable[[], Any] | None = None,
                 grace_s: float = 2.0, poll_s: float = 0.05):
        self.code = code
        self.env = dict(env or {})
        self.load_result = load_result
        self.grace_s = grace_s
        self.poll_s = poll_s

    def __call__(self, ctx: HostContext) -> Any:
        env = dict(os.environ, **self.env)
        # the child imports repro_torch from this checkout
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_SRC, env.get("PYTHONPATH")) if p)
        env["FLEET_ATTEMPT"] = str(ctx.attempt)
        env["FLEET_LEVEL"] = str(ctx.level)
        env["FLEET_RESUME"] = ctx.resume_from or ""
        env["FLEET_EPOCH"] = str(ctx.epoch)
        proc = subprocess.Popen([sys.executable, "-c", self.code],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        # Drain stdout concurrently: a child that writes more than the
        # OS pipe buffer (~64KB) would otherwise block on write and
        # never exit, turning a healthy-but-verbose worker into a hang
        # (or a spurious watchdog kill).
        out_parts: list[str] = []

        def _drain(stream=proc.stdout):
            try:
                out_parts.append(stream.read())
            except (OSError, ValueError):
                pass

        reader = threading.Thread(target=_drain, daemon=True,
                                  name=f"fleet-stdout-{ctx.attempt}")
        reader.start()
        try:
            while proc.poll() is None:
                if ctx.cancel.is_set():
                    proc.terminate()          # SIGTERM-style first
                    try:
                        proc.wait(timeout=self.grace_s)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()
                    raise AttemptCancelled(
                        f"attempt {ctx.attempt} cancelled (subprocess "
                        "terminated)")
                time.sleep(self.poll_s)
        finally:
            if proc.poll() is None and ctx.cancel.is_set():
                proc.kill()
            reader.join(timeout=self.grace_s)
        out = "".join(out_parts)
        if proc.returncode != 0:
            tail = "\n".join(out.strip().splitlines()[-8:])
            raise HostDied(
                f"subprocess host exited {proc.returncode} on attempt "
                f"{ctx.attempt}:\n{tail}")
        return self.load_result() if self.load_result else None


class FleetController:
    """Supervise fit attempts until one completes or the policy says
    stop. See the module docstring for the state machine.

    ``make_host(level)`` returns the attempt callable for a provisioning
    level: ``host(ctx: HostContext) -> result``. Level 0 is the full
    fleet; higher levels are progressively degraded layouts (e.g. the
    (2,2) k-shard mesh at 0, the flat (4,) mesh at 1). ``n_levels``
    bounds degradation. The shared ``ckpt_dir`` is both the resume
    source and the progress heartbeat; the controller never parses
    snapshots itself, only watches committed (epoch, step) records
    advance.

    ``lease=LeasePolicy(...)`` opts into leader election: ``run()``
    first wins (or stands by for) the directory's lease, and only the
    leader supervises. ``owner`` names this controller in the lease and
    fence files (defaults to a unique pid-scoped name). ``stop`` is an
    external kill switch for a standby that should give up.
    """

    def __init__(self, make_host: Callable[[int], Callable],
                 ckpt_dir: str, *, policy: FleetPolicy | None = None,
                 n_levels: int = 1,
                 schedule: FleetSchedule | None = None,
                 sleep: Callable[[float], None] = time.sleep,
                 lease: LeasePolicy | None = None,
                 owner: str | None = None,
                 clock: Callable[[], float] = time.time):
        assert n_levels >= 1, n_levels
        self.make_host = make_host
        self.ckpt_dir = str(ckpt_dir)
        self.policy = policy or FleetPolicy()
        self.n_levels = n_levels
        self.schedule = schedule or FleetSchedule()
        self.sleep = sleep
        self.owner = owner or f"ctrl-pid{os.getpid()}-{next(_CTRL_SEQ)}"
        self.stop = threading.Event()
        self._lease = (LeaseManager(self.ckpt_dir, self.owner,
                                    policy=lease, clock=clock)
                       if lease is not None else None)
        self._last_epoch = 0
        self._last_renew = 0.0       # monotonic time of last heartbeat
        self._renew_failing = False  # warn once per OSError streak
        self._ckpt = Checkpointer(self.ckpt_dir)

    # ---------------------------------------------------------- internals
    def _latest_record(self) -> tuple | None:
        try:
            return self._ckpt.latest_record()
        except OSError:
            return None

    def _latest_step(self) -> int | None:
        rec = self._latest_record()
        return rec[1] if rec is not None else None

    def _mint_epoch(self, term: int) -> int:
        """A fresh fence epoch for the next attempt — advanced BEFORE
        the launch, so the previous attempt's line is already cut off
        when the successor first touches the directory (a zombie's late
        commit meets the fence, not a race).

        With an election configured this is RENEW-BEFORE-MINT: the
        mint goes through ``LeaseManager.mint_epoch``, which verifies
        ownership against the lease file in the same critical section
        that advances the fence. A leader whose lease silently expired
        (however briefly unnoticed) raises ``LeaseLost`` here and
        stands down WITHOUT advancing the fence — so a stale leader
        can never fence out the legitimate new leader's workers, which
        would invert the split-brain guarantee. The first attempt
        under a fresh lease term reuses the term itself: acquisition
        already advanced the fence to it, and terms/epochs share one
        counter (reusing never advances the fence, so it cannot cause
        an inversion either — at worst the worker opens superseded and
        gets ``FencedWriterError``)."""
        if self._lease is not None:
            if (term > 0 and self._last_epoch < term
                    and read_fence(self.ckpt_dir) <= term):
                try:
                    self._lease.renew()      # LeaseLost -> stand down
                    self._renew_failing = False
                    self._last_renew = time.monotonic()
                except OSError as e:
                    # Stamp write failed AFTER ownership verified (a
                    # renew OSError can only come from the write; read
                    # errors parse as foreign -> LeaseLost): missed
                    # heartbeat, and reusing the term advances nothing.
                    self._warn_renew_failure(e)
                epoch = term
            else:
                epoch = self._lease.mint_epoch()
                self._last_renew = time.monotonic()
        else:
            cur = read_fence(self.ckpt_dir)
            epoch = max(cur, self._last_epoch) + 1
            advance_fence(self.ckpt_dir, epoch, self.owner)
        self._last_epoch = epoch
        return epoch

    def _renew_if_due(self) -> LeaseLost | None:
        """The lease heartbeat: renew once ``renew_s`` has elapsed
        since the last renewal; no-op without an election or when the
        lease is already gone. Returns the ``LeaseLost`` when
        leadership is lost (callers cancel and stand down), else None.
        An ``OSError`` from the lease write (ENOSPC, EIO) is a MISSED
        heartbeat, not loss: warn once per failure streak and retry at
        the next poll — if failures persist past the ttl, the
        own-deadline check converts them into ``LeaseLost`` with the
        proper stand-down, and meanwhile the worker stays supervised."""
        if self._lease is None or self._lease.state is None:
            return None
        if time.monotonic() - self._last_renew < self._lease.policy.renew_s:
            return None
        try:
            self._lease.renew()
        except LeaseLost as e:
            return e
        except OSError as e:
            self._warn_renew_failure(e)
            return None
        self._renew_failing = False
        self._last_renew = time.monotonic()
        return None

    def _warn_renew_failure(self, e: OSError) -> None:
        """One RuntimeWarning per OSError streak; the stamp stays
        unrenewed so the next poll retries, and persistent failures
        age out through the lease's own-deadline check."""
        if not self._renew_failing:
            warnings.warn(
                f"controller {self.owner} failed to renew its lease "
                f"on {self.ckpt_dir} ({e!r}); treating as a missed "
                "heartbeat and retrying — persistent failures stand "
                "down via the lease ttl", RuntimeWarning, stacklevel=3)
        self._renew_failing = True

    def _join_renewing(self, thread: threading.Thread,
                       timeout: float | None) -> None:
        """``thread.join`` that keeps the lease heartbeat alive while
        waiting (the inter-attempt window the ttl must survive).
        Without an election this is a plain join. Loss detected here
        is not raised — the next attempt's mint stands down via
        ``LeadershipLost`` before the fence is touched."""
        if self._lease is None or self._lease.state is None:
            thread.join(timeout=timeout)
            return
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while thread.is_alive():
            thread.join(timeout=self.policy.poll_s)
            self._renew_if_due()
            if deadline is not None and time.monotonic() > deadline:
                return

    def _sleep_renewing(self, delay: float) -> None:
        """Relaunch backoff that keeps the lease heartbeat alive: the
        delay is sliced so renewals land every ~renew_s/2 (sliced by
        COUNT, not wall clock, so an injected test sleep still sees
        the same total). As with the join, loss here surfaces at the
        next mint, which stands down without advancing the fence."""
        if (self._lease is None or self._lease.state is None
                or delay <= 0.0):
            self.sleep(delay)
            return
        slice_s = max(self._lease.policy.renew_s / 2.0, 1e-3)
        n = max(1, math.ceil(delay / slice_s))
        for _ in range(n):
            self.sleep(delay / n)
            self._renew_if_due()

    def _compose_hook(self, attempt: int, cancel: threading.Event
                      ) -> Callable[[int], None]:
        scheduled = self.schedule.hook_for(attempt, cancel)

        def hook(it: int) -> None:
            if scheduled is not None:
                scheduled(it)
            # After the injector: a cancel-aware hang returns here on
            # wake-up and the attempt aborts cooperatively.
            if cancel.is_set():
                raise AttemptCancelled(
                    f"attempt {attempt} cancelled at iteration {it}")
        return hook

    def _supervise(self, thread: threading.Thread, cancel: threading.Event,
                   rec: AttemptRecord, level: int,
                   last_rec: tuple | None) -> str | None:
        """Progress-monitor loop while the attempt thread runs. Returns
        the cancel reason (None if the attempt ended on its own).
        ``last_rec`` is the committed-record baseline sampled just
        before ``thread.start()``, so a commit landing between launch
        and the first poll still counts.

        When an election is configured this loop is also the leader's
        heartbeat: the lease is renewed every ``renew_s`` of wall
        clock — INCLUDING while draining a cancelled attempt (with
        defaults ``kill_grace_s`` equals the lease ttl, so a
        renewal-free drain would guarantee an unnecessary takeover
        just for abandoning one hung worker). A controller frozen
        inside ``self.sleep`` (the injected GC pause) misses renewals;
        on wake-up ``renew()`` refuses to touch the lease past its own
        deadline and raises ``LeaseLost``, which cancels the attempt
        with reason "lease-lost". A renewal that fails with ``OSError``
        counts as a missed heartbeat and is retried (``_renew_if_due``)
        — the worker is never left running unsupervised.

        After a cancel the loop drains the thread for at most
        ``kill_grace_s`` more — a non-cooperative hang (worker stuck
        inside one iteration, never reaching the fault hook) would
        otherwise keep ``thread.is_alive()`` true forever; breaking out
        lets ``run()``'s abandon branch engage as documented."""
        pol = self.policy
        t0 = time.monotonic()
        last_advance = t0
        reason: str | None = None
        t_cancel = 0.0
        while thread.is_alive():
            self.sleep(pol.poll_s)
            step = self._latest_record()
            if step != last_rec:
                now = time.monotonic()
                last_rec = step
                last_advance = now
                rec.commits += 1
                if rec.first_commit_s is None:
                    rec.first_commit_s = now - t0
            lost = self._renew_if_due()   # heartbeat, drain included
            if lost is not None and reason != "lease-lost":
                rec.error = rec.error or str(lost)
                if reason is None:        # keep an earlier drain clock
                    t_cancel = time.monotonic()
                    cancel.set()
                reason = "lease-lost"
            if reason is not None:
                if time.monotonic() - t_cancel > pol.kill_grace_s:
                    break      # non-cooperative hang: abandon in run()
                continue       # cancelled; drain within the grace window
            if (level > 0 and pol.recover_commits > 0
                    and rec.commits >= pol.recover_commits):
                reason = "reprovision"   # healthy again: grow back
                t_cancel = time.monotonic()
                cancel.set()
            elif (pol.watchdog_s is not None
                    and time.monotonic() - last_advance > pol.watchdog_s):
                reason = "watchdog"      # alive but not advancing
                t_cancel = time.monotonic()
                cancel.set()
        return reason

    # --------------------------------------------------------------- run
    def run(self) -> FleetResult:
        """Win (or wait for) leadership, then supervise to completion.
        Without a lease policy this is single-controller supervision,
        single-controller supervision with per-attempt epoch fencing."""
        if self._lease is None:
            return self._run_supervised(term=0)
        lpol = self._lease.policy
        t0 = time.monotonic()
        while True:
            if self.stop.is_set():
                raise FleetError(
                    f"controller {self.owner} stopped while standing "
                    "by", [])
            st = self._lease.try_acquire()
            if st is not None:
                self._last_renew = time.monotonic()
                try:
                    result = self._run_supervised(term=st.term)
                finally:
                    # No-op if the lease was already lost (state is
                    # cleared before LeaseLost propagates); otherwise
                    # lets a standby take over without aging out the
                    # ttl — including after normal completion.
                    self._lease.release()
                return result
            if (lpol.standby_timeout_s is not None
                    and time.monotonic() - t0 > lpol.standby_timeout_s):
                raise FleetError(
                    f"controller {self.owner} gave up standing by "
                    f"after {lpol.standby_timeout_s}s (leader "
                    f"{self._lease.read()})", [])
            self.sleep(lpol.poll_s)

    def _run_supervised(self, term: int) -> FleetResult:
        pol = self.policy
        attempts: list[AttemptRecord] = []
        level = 0
        consecutive = 0
        for attempt in range(pol.max_attempts):
            cancel = threading.Event()
            try:
                epoch = self._mint_epoch(term)
            except LeaseLost as e:
                # Renew-before-mint refused: the lease expired (or was
                # usurped) somewhere renewals could not reach — the
                # fence was NOT advanced, so the new leader's workers
                # are untouched; this controller simply stops.
                raise LeadershipLost(
                    f"controller {self.owner} (term {term}) stood down "
                    f"before launching attempt {attempt}: {e}",
                    attempts) from e
            ctx = HostContext(
                attempt=attempt, level=level,
                resume_from=(self.ckpt_dir
                             if self._latest_record() is not None
                             else None),
                fault_hook=self._compose_hook(attempt, cancel),
                cancel=cancel, epoch=epoch)
            rec = AttemptRecord(index=attempt, level=level, outcome="?",
                                resume_step=self._latest_step(),
                                epoch=epoch)
            attempts.append(rec)
            host = self.make_host(level)
            box: dict[str, Any] = {}

            def work(host=host, ctx=ctx, box=box):
                try:
                    box["result"] = host(ctx)
                except BaseException as e:  # noqa: BLE001 — classified
                    box["error"] = e

            t0 = time.monotonic()
            thread = threading.Thread(target=work, daemon=True,
                                      name=f"fleet-attempt-{attempt}")
            # Baseline for commit counting, sampled immediately before
            # launch (an abandoned prior worker may still commit late).
            baseline = self._latest_record()
            thread.start()
            reason = self._supervise(thread, cancel, rec, level, baseline)
            self._join_renewing(thread, pol.kill_grace_s
                                if cancel.is_set() else None)
            rec.seconds = time.monotonic() - t0

            if thread.is_alive():
                # True hang: the cancel check never ran. Abandon the
                # daemon thread and relaunch from the last snapshot.
                warnings.warn(
                    f"fleet attempt {attempt} did not exit within "
                    f"{pol.kill_grace_s}s of cancellation; abandoning "
                    f"the worker thread (it cannot win: epoch {epoch} "
                    "is fenced out before the relaunch, so a late "
                    "commit is rejected at the rename boundary)",
                    RuntimeWarning, stacklevel=2)
                rec.outcome = "abandoned"
                rec.error = rec.error or (f"cancelled ({reason}), "
                                          "thread abandoned")
                consecutive += 1
            elif "result" in box and reason is None:
                rec.outcome = "completed"
                return FleetResult(result=box["result"], attempts=attempts,
                                   final_level=level,
                                   n_relaunches=attempt,
                                   recovered=attempt > 0, term=term)
            elif "result" in box:
                # Completed, but only after a cancel was issued (e.g.
                # the final commit and the watchdog raced, or the lease
                # was lost mid-final-iteration). For reprovision/
                # watchdog the result is still valid — the fit
                # finished. For a lost lease it is NOT ours to return.
                if reason != "lease-lost":
                    rec.outcome = "completed"
                    return FleetResult(result=box["result"],
                                       attempts=attempts,
                                       final_level=level,
                                       n_relaunches=attempt,
                                       recovered=attempt > 0, term=term)
                rec.outcome = "lease-lost"
            else:
                err = box.get("error")
                rec.error = rec.error or repr(err)
                if isinstance(err, AttemptCancelled):
                    rec.outcome = reason or "cancelled"
                    if reason == "reprovision":
                        level = max(level - 1, 0)    # grow back
                        consecutive = 0
                    else:
                        consecutive += 1             # watchdog kill
                elif isinstance(err, (FencedCommitError,
                                      FencedWriterError)):
                    # Another controller advanced the fence past this
                    # attempt's epoch: we have been deposed even if our
                    # own renewal has not noticed yet.
                    rec.outcome = "fenced"
                    raise LeadershipLost(
                        f"controller {self.owner} (term {term}) was "
                        f"fenced out at epoch {epoch}: {err} — another "
                        "controller leads this directory", attempts,
                        cause=err) from err
                elif isinstance(err, StragglerError):
                    rec.outcome = "straggler"
                    level = min(level + 1, self.n_levels - 1)  # degrade
                    consecutive = 0
                elif isinstance(err, pol.terminal):
                    rec.outcome = "terminal"
                    raise FleetError(
                        f"attempt {attempt} failed terminally "
                        f"(non-retryable {type(err).__name__}); see "
                        ".attempts for the lifecycle log", attempts,
                        cause=err) from err
                elif isinstance(err, pol.retryable):
                    rec.outcome = "retryable"
                    consecutive += 1
                else:
                    rec.outcome = "terminal"
                    raise FleetError(
                        f"attempt {attempt} raised unclassified "
                        f"{type(err).__name__} — treating as terminal",
                        attempts, cause=err) from err

            if reason == "lease-lost":
                rec.outcome = ("abandoned" if rec.outcome == "abandoned"
                               else "lease-lost")
                raise LeadershipLost(
                    f"controller {self.owner} lost the lease on "
                    f"{self.ckpt_dir} during attempt {attempt} (term "
                    f"{term}); the usurper's fence already rejects "
                    "this reign's commits", attempts)

            if attempt + 1 < pol.max_attempts and consecutive > 0:
                self._sleep_renewing(
                    pol.relaunch_delay(consecutive, attempt + 1))

        raise FleetError(
            f"retry budget exhausted: {pol.max_attempts} attempts, none "
            "completed", attempts)
