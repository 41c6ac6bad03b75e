"""The port's runtime units (``repro_torch.runtime``, the retrying loader
and the prefetcher of ``repro_torch.data``), case for case with the
reference's tests/test_runtime.py: straggler monitor, elastic schedule,
fault injectors, retrying loader, prefetcher error propagation.

Then against the JAX package: the monitor flags the same steps with the
same EMA on one sequence of step times, every injector gives the same
sequence of chunks and errors, the fault policy has the reference's
fields and defaults, ``remesh`` places host arrays (a tree of them) on
the device it is given, and ``runtime`` exports the reference's names.

The end-to-end kill/resume proofs live in tests/test_torch_resume.py;
this file pins the small mechanisms those proofs compose."""
import dataclasses
import types

import numpy as np
import pytest
import torch

import repro.runtime as ref_runtime
from repro.runtime import faults as ref_faults
from repro.runtime.policy import FaultPolicy as RefFaultPolicy
from repro.runtime.straggler import StepTimeMonitor as RefMonitor
from repro_torch import runtime
from repro_torch.data import ChunkPrefetcher
from repro_torch.data.pipeline import retrying_chunks
from repro_torch.runtime import faults
from repro_torch.runtime.elastic import remesh, scale_batch_schedule
from repro_torch.runtime.policy import FaultPolicy
from repro_torch.runtime.straggler import StepTimeMonitor


# ------------------------------------------------------ StepTimeMonitor
def test_monitor_warmup_never_flags():
    m = StepTimeMonitor(warmup_steps=3, threshold=1.5)
    # grossly slow steps during warmup are absorbed, not flagged
    assert not any(m.observe(i, 100.0) for i in range(1, 4))
    assert m.events == []
    assert m.ema > 0.0


def test_monitor_flags_and_records():
    m = StepTimeMonitor(warmup_steps=2, threshold=2.0)
    m.observe(1, 1.0)
    m.observe(2, 1.0)
    assert m.ema == pytest.approx(1.0)
    assert not m.observe(3, 1.9)      # under threshold x EMA
    assert m.observe(4, 2.5)          # over
    (step, seconds, ema), = m.events
    assert step == 4 and seconds == 2.5 and ema == pytest.approx(
        m.ema, rel=0.2)
    assert m.summary()["straggler_events"] == 1


def test_monitor_straggler_does_not_poison_ema():
    """A flagged step must NOT move the EMA — otherwise one straggler
    raises the baseline and masks the next one."""
    m = StepTimeMonitor(warmup_steps=1, threshold=2.0, ema_decay=0.9)
    m.observe(1, 1.0)
    ema_before = m.ema
    assert m.observe(2, 50.0)         # straggler
    assert m.ema == ema_before        # untouched
    assert m.observe(3, 50.0)         # still flagged against old EMA
    # healthy step moves it
    m.observe(4, 1.0)
    assert m.ema != ema_before or m.ema == pytest.approx(1.0)


def test_monitor_from_policy():
    pol = FaultPolicy(straggler_threshold=3.5, straggler_warmup=7)
    m = StepTimeMonitor.from_policy(pol)
    assert m.threshold == 3.5 and m.warmup_steps == 7


# -------------------------------------------------- scale_batch_schedule
def test_scale_batch_keep_global():
    gb, lr = scale_batch_schedule(1024, old_workers=8, new_workers=4)
    assert (gb, lr) == (1024, 1.0)
    with pytest.raises(AssertionError):
        scale_batch_schedule(1000, old_workers=8, new_workers=3)


def test_scale_batch_keep_per_worker():
    gb, lr = scale_batch_schedule(1024, old_workers=8, new_workers=4,
                                  keep_global=False)
    assert gb == 128 * 4
    assert lr == pytest.approx(0.5)


# ---------------------------------------------------------- fault tools
def _ten_chunks():
    for i in range(10):
        yield (np.full((2,), i, np.float32),)


def test_kill_after_chunks_counts_across_iterators():
    killed = faults.kill_after_chunks(_ten_chunks, 13)
    got = [int(c[0][0]) for c in killed()]          # pass 1: 10 chunks
    assert got == list(range(10))
    it2 = killed()                                   # pass 2: 3 more
    assert [int(next(it2)[0][0]) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(faults.SimulatedPreemption):
        next(it2)


def test_kill_at_iteration_and_compose():
    log = []
    hook = faults.compose_hooks(log.append, faults.kill_at_iteration(3))
    hook(1), hook(2)
    with pytest.raises(faults.SimulatedPreemption):
        hook(3)
    assert log == [1, 2, 3]


def test_io_error_every_nth_persists_across_factories():
    # positions 3 and 7 each fail twice; a restarting consumer hits the
    # first still-failing position per pass -> 4 failing passes, then clean
    flaky = faults.io_error_every_nth(_ten_chunks, nth=4, times=2)
    for expect_fail in (True, True, True, True, False):
        try:
            n = sum(1 for _ in flaky())
        except IOError:
            assert expect_fail
        else:
            assert not expect_fail and n == 10


# ------------------------------------------------------ retrying_chunks
def test_retrying_chunks_drains_flaky_source():
    flaky = faults.io_error_every_nth(_ten_chunks, nth=3, times=2)
    naps = []
    got = list(retrying_chunks(
        lambda done: __import__("itertools").islice(flaky(), done, None),
        retries=10, backoff=0.01, sleep=naps.append))
    assert [int(c[0][0]) for c in got] == list(range(10))
    # 3 flaky positions x 2 failures each = 6 retries, backoff doubling
    assert len(naps) == 6
    assert naps[0] == pytest.approx(0.01)
    assert naps[1] == pytest.approx(0.02)  # consecutive failure doubles


def test_retrying_chunks_exhausts_budget():
    flaky = faults.io_error_every_nth(_ten_chunks, nth=3, times=99)
    with pytest.raises(IOError):
        list(retrying_chunks(
            lambda done: __import__("itertools").islice(flaky(), done,
                                                        None),
            retries=3, backoff=0.0, sleep=lambda s: None))


def test_retrying_chunks_retries_open_failure():
    """The factory call itself is inside the retry net (opening the
    file can fail too, not just reading a chunk)."""
    attempts = [0]

    def factory(done):
        attempts[0] += 1
        if attempts[0] <= 2:
            raise IOError("open failed")
        import itertools
        return itertools.islice(_ten_chunks(), done, None)

    got = list(retrying_chunks(factory, retries=3, backoff=0.0,
                               sleep=lambda s: None))
    assert len(got) == 10 and attempts[0] == 3


def test_retrying_chunks_foreign_exception_propagates():
    def bad(done):
        def gen():
            yield (np.zeros(1),)
            raise ValueError("not an IO problem")
        return gen()

    with pytest.raises(ValueError):
        list(retrying_chunks(bad, retries=5, backoff=0.0,
                             sleep=lambda s: None))


# -------------------------------------- ChunkPrefetcher error forwarding
def test_prefetcher_propagates_worker_exception():
    """Regression: a loader exception inside the prefetch thread must
    re-raise at the consumer's iteration site — not hang the consumer
    on q.get() and not vanish into the thread."""
    def chunks():
        yield (np.zeros((4,), np.float32),)
        yield (np.ones((4,), np.float32),)
        raise IOError("disk vanished mid-file")

    pf = ChunkPrefetcher(chunks(), depth=2)
    got = []
    with pytest.raises(IOError, match="disk vanished"):
        for c in pf:
            got.append(c)
    assert len(got) == 2              # everything before the fault arrived


def test_prefetcher_propagates_preemption():
    killed = faults.kill_after_chunks(_ten_chunks, 4)
    with pytest.raises(faults.SimulatedPreemption):
        for _ in ChunkPrefetcher(killed(), depth=2):
            pass


def test_prefetcher_normal_completion_unchanged():
    out = list(ChunkPrefetcher(_ten_chunks(), depth=2))
    assert len(out) == 10
    assert ChunkPrefetcher(_ten_chunks(), depth=2).max_resident_bytes == 0


# ------------------------------------------------- against the JAX package
def test_monitor_matches_the_reference():
    times = [0.3, 0.1, 0.12, 0.5, 0.11, 0.1, 0.9, 0.1, 3.0, 0.2, 0.1]
    a, b = StepTimeMonitor(threshold=2.0, warmup_steps=2), RefMonitor(
        threshold=2.0, warmup_steps=2)
    flags = [(a.observe(i, t), b.observe(i, t)) for i, t in enumerate(times)]
    assert all(x == y for x, y in flags) and any(x for x, _ in flags)
    assert a.events == b.events and a.ema == b.ema
    assert a.summary() == b.summary()


def test_fault_policy_is_the_reference_dataclass():
    fields = [(f.name, f.default) for f in dataclasses.fields(FaultPolicy)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(RefFaultPolicy)]
    assert not FaultPolicy().checkpoints_enabled
    assert FaultPolicy(ckpt_dir="d").checkpoints_enabled
    with pytest.raises(AssertionError):
        FaultPolicy(on_straggler="retry")


def test_runtime_exports_the_references_names():
    names = {n for n in dir(ref_runtime) if not n.startswith("_")
             and not isinstance(getattr(ref_runtime, n), types.ModuleType)}
    assert len(names) == 33 and names <= set(dir(runtime))


def _trace(make, passes=3):
    """Every pass's chunks (their first value) or the error that ended it."""
    out = []
    for _ in range(passes):
        got = []
        try:
            for c in make():
                got.append(int(np.asarray(c[0]).ravel()[0]))
            out.append(("ok", got))
        except Exception as e:  # noqa: BLE001 (the injected errors)
            out.append((type(e).__name__, got))
    return out


@pytest.mark.parametrize("case", ["kill", "io", "delay"])
def test_injectors_match_the_reference(case):
    naps = {"port": [], "ref": []}

    def build(mod, tag):
        if case == "kill":
            return mod.kill_after_chunks(_ten_chunks, 23)
        if case == "io":
            return mod.io_error_every_nth(_ten_chunks, nth=4, times=2)
        return mod.delay_chunks(_ten_chunks, [3, 12], 0.5,
                                sleep=naps[tag].append)

    port = _trace(build(faults, "port"))
    ref = _trace(build(ref_faults, "ref"))
    assert port == ref
    assert naps["port"] == naps["ref"]


def test_hooks_match_the_reference():
    naps = {"port": [], "ref": []}

    def run(mod, tag):
        hook = mod.compose_hooks(
            mod.delay_iterations([2, 4], 0.25, sleep=naps[tag].append),
            mod.terminate_at_iteration(5))
        done = []
        try:
            for it in range(1, 9):
                hook(it)
                done.append(it)
        except RuntimeError as e:
            return done, type(e).__name__
        return done, None

    assert run(faults, "port") == run(ref_faults, "ref") == (
        [1, 2, 3, 4], "SimulatedTermination")
    assert naps["port"] == naps["ref"] == [0.25, 0.25]


def test_remesh_places_host_arrays():
    tree = {"state": np.arange(6, dtype=np.float32).reshape(2, 3),
            "key": np.array([0, 7], np.int64),
            "totals": [torch.ones(2), np.float64(2.5)]}
    out = remesh(tree, torch.device("cpu"))
    assert isinstance(out["state"], torch.Tensor)
    assert torch.equal(out["state"], torch.arange(6.0).view(2, 3))
    assert out["key"].dtype == torch.int64 and out["totals"][1].dtype == \
        torch.float64
    assert out["state"].data_ptr() != tree["state"].__array_interface__[
        "data"][0]
    # a mesh's ranks place on their device of the mesh's type
    on_mesh = remesh(tree, types.SimpleNamespace(device_type="cpu"))
    assert torch.equal(on_mesh["state"], out["state"])
