"""Deterministic fault injection, the port's copy of
``repro/runtime/faults.py`` (plain Python): every reliability claim is
backed by a test that actually kills a fit and resumes it, and these
injectors make those kills reproducible bit for bit.

  * ``kill_after_chunks``: preempt the stream driver at an exact chunk
    (the budget counts across iterations and passes, so the kill can land
    mid-pass at any chosen chunk);
  * ``kill_at_iteration`` / ``delay_iterations``: ``fault_hook``
    callables for the drivers: preempt after iteration k, or stretch step
    k's wall time so that ``StepTimeMonitor`` flags it;
  * ``io_error_every_nth``: a flaky loader that raises ``IOError`` a
    fixed number of times per chunk position (the bookkeeping persists
    across re-created iterators, so bounded retry drains past every
    transient failure);
  * ``delay_chunks``: per-chunk sleeps, the stream driver's straggler.

For the fleet controller (``runtime.controller``), which sees faults per
attempt:

  * ``hang_at_iteration``: a worker that stops advancing without dying,
    until the controller's cancel event fires;
  * ``terminate_at_iteration``: SIGTERM-style eviction between
    iterations, after the boundary checkpoint committed;
  * ``FleetSchedule``: attempt index -> hook factory, so a chaos test
    replays the same fault sequence on every run.

For several controllers on one checkpoint directory:

  * ``hold_at_iteration``: a non-cooperative zombie that blocks at
    iteration k until a test releases it, ignoring cancel, then attempts
    its next commit (which the epoch fence must reject);
  * ``freezable_sleep``: a ``sleep`` for the controller that stalls while
    a test event is set (a GC pause or a partition);
  * ``tear_file``: truncates a file, a torn write.

The injectors wrap chunk factories (zero-argument callables returning a
fresh iterator, what ``PEMSVM.fit_chunks`` consumes) or act as
``fit(..., fault_hook=...)`` callables; they never reach into the solver,
so the code under test is the production path.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, Iterator


class SimulatedTermination(RuntimeError):
    """SIGTERM-style graceful preemption: unlike ``SimulatedPreemption``
    (SIGKILL — no notice), this models an eviction NOTICE delivered
    between iterations, with the boundary checkpoint already committed.
    Controllers may relaunch immediately (no crash suspicion)."""


class SimulatedPreemption(RuntimeError):
    """The injected stand-in for SIGKILL/eviction: raised at the exact
    configured point; tests catch it and resume from the last committed
    checkpoint like a restarted job would."""


def kill_after_chunks(make_chunks: Callable[[], Iterable], n: int,
                      exc: type = SimulatedPreemption
                      ) -> Callable[[], Iterator]:
    """Wrap a chunk factory with a whole-fit chunk budget: after ``n``
    chunks have been yielded across ALL iterators the returned factory
    ever produced, the next pull raises ``exc``. The cumulative count is
    what lets a test kill at an arbitrary chunk of an arbitrary pass."""
    count = [0]

    def factory() -> Iterator:
        for chunk in make_chunks():
            if count[0] >= n:
                raise exc(f"simulated preemption after {n} chunks")
            count[0] += 1
            yield chunk
    return factory


def kill_at_iteration(k: int, exc: type = SimulatedPreemption
                      ) -> Callable[[int], None]:
    """``fault_hook`` killing the fit right after iteration ``k``
    completes (its checkpoint, if due, is already committed — matching
    a preemption that lands between steps)."""
    def hook(it: int) -> None:
        if it >= k:
            raise exc(f"simulated preemption at iteration {k}")
    return hook


def delay_iterations(iterations: Iterable[int], seconds: float,
                     sleep: Callable[[float], None] = time.sleep
                     ) -> Callable[[int], None]:
    """``fault_hook`` inflating the wall time of the given iterations —
    the host-loop drivers time the hook inside the step window, so
    ``StepTimeMonitor`` sees these steps as stragglers."""
    slow = frozenset(iterations)

    def hook(it: int) -> None:
        if it in slow:
            sleep(seconds)
    return hook


def compose_hooks(*hooks: Callable[[int], None]) -> Callable[[int], None]:
    """Run several fault hooks in order (e.g. delay then kill)."""
    def hook(it: int) -> None:
        for h in hooks:
            h(it)
    return hook


def io_error_every_nth(make_chunks: Callable[[], Iterable], nth: int,
                       times: int = 1) -> Callable[[], Iterator]:
    """Flaky-loader factory: pulling chunk position ``nth-1, 2*nth-1,
    ...`` raises ``IOError`` — ``times`` times per position, after which
    that position succeeds forever. Failure bookkeeping is shared across
    every iterator the factory creates, so a retrying consumer
    (``data.pipeline.retrying_chunks``) provably drains the stream:
    each retry replays the already-served prefix and gets one failure
    closer to passing the flaky position."""
    assert nth >= 1, nth
    fails: dict[int, int] = {}

    def factory() -> Iterator:
        for i, chunk in enumerate(make_chunks()):
            if (i + 1) % nth == 0 and fails.get(i, 0) < times:
                fails[i] = fails.get(i, 0) + 1
                raise IOError(
                    f"injected loader failure at chunk {i} "
                    f"({fails[i]}/{times})")
            yield chunk
    return factory


def terminate_at_iteration(k: int) -> Callable[[int], None]:
    """``fault_hook`` delivering a graceful SIGTERM-style eviction right
    after iteration ``k`` completes (boundary snapshot, if due, already
    committed — the polite preemption cloud schedulers send first)."""
    return kill_at_iteration(k, exc=SimulatedTermination)


def hang_at_iteration(k: int, *, until: threading.Event,
                      poll: float = 0.01, max_seconds: float = 60.0,
                      sleep: Callable[[float], None] = time.sleep
                      ) -> Callable[[int], None]:
    """``fault_hook`` simulating a HANG at iteration ``k``: the worker
    stops advancing (no checkpoint commits, no exception) until the
    controller's cancel event ``until`` fires — exactly the failure a
    liveness heartbeat misses and a monotonic-progress watchdog
    catches. Once cancelled the hook raises nothing itself; the
    controller's own cancel check (composed after it) converts the
    wake-up into an attempt abort. ``max_seconds`` bounds the block so
    a test with a broken watchdog fails instead of deadlocking."""
    def hook(it: int) -> None:
        if it != k:
            return
        t0 = time.monotonic()
        while not until.is_set():
            if time.monotonic() - t0 > max_seconds:
                raise RuntimeError(
                    f"hang_at_iteration({k}) gave up after "
                    f"{max_seconds}s — no watchdog cancelled it")
            sleep(poll)
    return hook


def hold_at_iteration(k: int, *, release: threading.Event,
                      poll: float = 0.01, max_seconds: float = 60.0,
                      sleep: Callable[[float], None] = time.sleep
                      ) -> Callable[[int], None]:
    """``fault_hook`` simulating a NON-cooperative zombie: at iteration
    ``k`` the worker blocks until the TEST-controlled ``release`` event
    fires — the controller's cancel is ignored, so the controller
    abandons the worker (or a standby takes over), and when the test
    later releases it, the fit RESUMES and attempts its next boundary
    commit as if nothing happened. That late commit is the zombie write
    the epoch fence must reject at the rename boundary; contrast
    ``hang_at_iteration``, whose cooperative worker aborts on cancel
    and never writes again. ``max_seconds`` bounds the block so a test
    that forgets to release fails instead of deadlocking."""
    def hook(it: int) -> None:
        if it != k:
            return
        t0 = time.monotonic()
        while not release.is_set():
            if time.monotonic() - t0 > max_seconds:
                raise RuntimeError(
                    f"hold_at_iteration({k}) gave up after "
                    f"{max_seconds}s — the test never released it")
            sleep(poll)
    return hook


def freezable_sleep(frozen: threading.Event, *,
                    base: Callable[[float], None] = time.sleep,
                    poll: float = 0.01, max_seconds: float = 60.0
                    ) -> Callable[[float], None]:
    """A ``sleep`` replacement for ``FleetController(sleep=...)`` that
    simulates a GC pause / partition: while ``frozen`` is set, every
    call blocks (the supervision loop stops polling AND stops renewing
    its lease) until the event clears — the thread never dies, it just
    goes dark, which is exactly the leader failure lease expiry exists
    to catch. ``max_seconds`` bounds the freeze so a stuck test fails
    loudly."""
    def sleep_fn(seconds: float) -> None:
        base(seconds)
        t0 = time.monotonic()
        while frozen.is_set():
            if time.monotonic() - t0 > max_seconds:
                raise RuntimeError(
                    f"freezable_sleep frozen for over {max_seconds}s — "
                    "the test never thawed it")
            base(poll)
    return sleep_fn


def tear_file(path: str, nbytes: int = 8) -> None:
    """Simulate a torn write: truncate ``path`` to its first ``nbytes``
    bytes (a crash mid-write from a non-atomic writer). Readers must
    treat the result as absent/breakable, never crash on it."""
    with open(path, "rb") as f:
        head = f.read(max(nbytes, 0))
    with open(path, "wb") as f:
        f.write(head)


class FleetSchedule:
    """Deterministic per-ATTEMPT fault plan for ``FleetController``:
    ``plans[i]`` is a factory ``(cancel_event) -> fault_hook`` applied
    to attempt ``i`` (0-based, counting every launch including
    relaunches). Attempts without a plan run clean. The factory takes
    the controller's cancel event so cancel-aware injectors
    (``hang_at_iteration``) can be scheduled declaratively; factories
    that ignore it are just ``lambda cancel: kill_at_iteration(5)``.
    """

    def __init__(self, plans: dict[int, Callable] | None = None):
        self.plans = dict(plans or {})

    def hook_for(self, attempt: int,
                 cancel: threading.Event) -> Callable[[int], None] | None:
        factory = self.plans.get(attempt)
        return factory(cancel) if factory is not None else None


def delay_chunks(make_chunks: Callable[[], Iterable],
                 at_chunks: Iterable[int], seconds: float,
                 sleep: Callable[[float], None] = time.sleep
                 ) -> Callable[[], Iterator]:
    """Straggler injection for the stream driver: sleeping before the
    given cumulative chunk indices stretches the pass (and hence the
    iteration) that consumes them."""
    slow = frozenset(at_chunks)
    count = [0]

    def factory() -> Iterator:
        for chunk in make_chunks():
            if count[0] in slow:
                sleep(seconds)
            count[0] += 1
            yield chunk
    return factory
