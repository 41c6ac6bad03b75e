"""The port's Checkpointer (``repro_torch.checkpoint``) case for case with
the reference's tests/test_checkpoint.py: atomicity, keep-K GC, async
errors, restore, epoch fencing (multi-writer safety); trees of torch
tensors, restored on ``device='cpu'``.

Then against the JAX package (``repro.checkpoint``): the leaf names of a
nested tree are the reference flattener's; the same tree written by both
packages gives byte-identical array files and equal manifests (but for
the wall-clock ``time``); a directory written by either package restores
through the other's Checkpointer (names, arrays bitwise, meta, epoch,
FENCE), keep-K and the torn-snapshot fallback see the other package's
snapshots; and the fence is one counter across packages: a port writer is
fenced out (at open and at commit) by a fence the reference advanced, and
the reverse.
"""
import collections
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro.checkpoint import checkpointer as ref_checkpointer
from repro_torch.checkpoint import (Checkpointer, CheckpointWriteError,
                                    FencedCommitError, FencedWriterError,
                                    advance_fence, read_fence)
from repro_torch.checkpoint import checkpointer as port_checkpointer


def _tree(x=1.0):
    return {"a": torch.full((4, 3), x), "b": {"c": torch.arange(5) * int(x)}}


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(10, _tree(2.0), blocking=True)
    out = ck.restore(_tree(0.0))
    np.testing.assert_allclose(np.asarray(out["a"]), 2.0)
    np.testing.assert_allclose(np.asarray(out["b"]["c"]), np.arange(5) * 2)


def test_latest_and_keep_k(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_k=2)
    for s in [1, 2, 3, 4]:
        ck.save(s, _tree(float(s)), blocking=True)
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4
    out = ck.restore(_tree(0.0), step=3)
    np.testing.assert_allclose(np.asarray(out["a"]), 3.0)


def test_uncommitted_checkpoint_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _tree(5.0), blocking=True)
    # simulate crash mid-save of step 6: directory exists, no COMMIT
    os.makedirs(tmp_path / "step_000000006" / "arrays")
    assert ck.latest_step() == 5


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path)).restore(_tree())


def test_async_save_overlaps_and_waits(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1.0))        # async
    ck.save(2, _tree(2.0))        # waits for 1, starts 2
    ck.wait()
    assert ck.all_steps() == [1, 2]


def test_shape_mismatch_is_diagnosable_valueerror(tmp_path):
    """A shape mismatch at restore is an operator-facing config error,
    not an internal invariant: the message must name the leaf, both
    shapes, and explain that an elastic remesh changes SHARDING never
    shape (so the operator doesn't misattribute it to resizing the
    fleet)."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(), blocking=True)
    bad = {"a": torch.zeros((2, 2)), "b": {"c": torch.arange(5)}}
    with pytest.raises(ValueError) as ei:
        ck.restore(bad)
    msg = str(ei.value)
    assert "'a'" in msg and "(4, 3)" in msg and "(2, 2)" in msg
    assert "remesh" in msg and "SHARDING" in msg


def test_background_write_failure_carries_step_and_dir(tmp_path,
                                                       monkeypatch):
    """An async write failure surfaces at the next save()/wait() as
    CheckpointWriteError carrying the step id and directory (so a fleet
    log can attribute the lost commit), with the original error as
    __cause__."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1.0), blocking=True)

    def boom(*a, **k):
        raise IOError("injected: disk full")
    monkeypatch.setattr(np, "save", boom)
    ck.save(5, _tree(5.0))
    with pytest.raises(CheckpointWriteError) as ei:
        ck.wait()
    assert ei.value.step == 5
    assert ei.value.directory == str(tmp_path)
    assert "step_000000005" in str(ei.value)
    assert isinstance(ei.value.__cause__, IOError)
    monkeypatch.undo()
    assert ck.all_steps() == [1]          # on-disk state untouched
    ck.save(5, _tree(5.0), blocking=True)  # writer still usable
    assert ck.all_steps() == [1, 5]


def test_stale_tmp_swept_at_construction(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(), blocking=True)
    # simulate a crash mid-save: orphaned work dir, no COMMIT
    os.makedirs(tmp_path / ".tmp_step_000000002" / "arrays")
    ck2 = Checkpointer(str(tmp_path))
    assert not (tmp_path / ".tmp_step_000000002").exists()
    assert ck2.all_steps() == [1]  # committed steps untouched


def test_restore_missing_leaf_names_it(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.zeros(3)}, blocking=True)
    with pytest.raises(ValueError, match="no leaf named 'zzz'"):
        ck.restore({"a": torch.zeros(3), "zzz": torch.zeros(2)})


def test_meta_roundtrip_and_restore_named(tmp_path):
    ck = Checkpointer(str(tmp_path))
    meta = {"it": 7, "objs": [1.0, 0.5], "fingerprint": "xyz"}
    ck.save(7, {"state": torch.arange(4.0), "key": torch.zeros(2)},
            meta=meta, blocking=True)
    arrays, manifest = ck.restore_named()
    assert manifest["meta"] == meta
    assert set(arrays) == {"state", "key"}
    np.testing.assert_array_equal(arrays["state"], np.arange(4.0))
    # pinned step works too
    arrays2, m2 = ck.restore_named(step=7)
    assert m2["step"] == 7


# ------------------------------------------------ torn-write defense
def _truncate(path, nbytes=8):
    """Simulate a torn write: keep only the first bytes of a file —
    what a power loss can leave behind despite a COMMIT marker written
    by an fsync-less older writer."""
    with open(path, "rb") as f:
        head = f.read(nbytes)
    with open(path, "wb") as f:
        f.write(head)


def test_torn_array_falls_back_with_warning(tmp_path):
    """A truncated leaf in the NEWEST committed snapshot must not kill
    the resume: restore warns and falls back to the previous keep_k
    entry; ``latest_valid_step`` reports the step restore will use."""
    ck = Checkpointer(str(tmp_path), keep_k=3)
    for s in [1, 2, 3]:
        ck.save(s, _tree(float(s)), blocking=True)
    _truncate(tmp_path / "step_000000003" / "arrays" / "0.npy")

    assert ck.latest_step() == 3                 # still committed...
    with pytest.warns(RuntimeWarning, match="step_000000003"):
        assert ck.latest_valid_step() == 2       # ...but not restorable
    with pytest.warns(RuntimeWarning):
        out = ck.restore(_tree(0.0))
    np.testing.assert_allclose(np.asarray(out["a"]), 2.0)


def test_torn_manifest_falls_back(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_k=3)
    ck.save(1, _tree(1.0), blocking=True)
    ck.save(2, _tree(2.0), blocking=True)
    _truncate(tmp_path / "step_000000002" / "manifest.json")
    with pytest.warns(RuntimeWarning):
        arrays, manifest = ck.restore_named()
    assert manifest["step"] == 1


def test_wrong_shape_on_disk_is_corruption(tmp_path):
    """Bit-rot that still parses: an array whose shape/dtype disagrees
    with the manifest is treated as corruption, not silently restored."""
    ck = Checkpointer(str(tmp_path), keep_k=3)
    ck.save(1, _tree(1.0), blocking=True)
    ck.save(2, _tree(2.0), blocking=True)
    np.save(tmp_path / "step_000000002" / "arrays" / "0.npy",
            np.zeros((9, 9), np.float64))
    with pytest.warns(RuntimeWarning, match="corrupt"):
        out = ck.restore(_tree(0.0))
    np.testing.assert_allclose(np.asarray(out["a"]), 1.0)


def test_all_corrupt_is_poisoned_directory(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_k=3)
    for s in [1, 2]:
        ck.save(s, _tree(float(s)), blocking=True)
        _truncate(tmp_path / f"step_{s:09d}" / "manifest.json")
    with pytest.warns(RuntimeWarning):
        with pytest.raises(FileNotFoundError, match="poisoned"):
            ck.restore(_tree(0.0))
    with pytest.warns(RuntimeWarning):
        assert ck.latest_valid_step() is None


def test_pinned_step_loads_strictly(tmp_path):
    """An EXPLICITLY pinned step does not silently fall back — the
    caller asked for those bits, so corruption raises."""
    ck = Checkpointer(str(tmp_path), keep_k=3)
    ck.save(1, _tree(1.0), blocking=True)
    ck.save(2, _tree(2.0), blocking=True)
    _truncate(tmp_path / "step_000000002" / "arrays" / "0.npy")
    with pytest.raises(Exception):
        ck.restore(_tree(0.0), step=2)
    out = ck.restore(_tree(0.0), step=1)         # older pin still fine
    np.testing.assert_allclose(np.asarray(out["a"]), 1.0)


# ------------------------------------------ crash window + GC races
def test_crash_between_rename_and_commit_is_recoverable(tmp_path):
    """Death in the window between os.rename(tmp, final) and the COMMIT
    write leaves a final dir with no marker. Restore must never
    consider it, and the NEXT writer of the same step must replace it
    cleanly rather than erroring or committing the orphan's bits."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1.0), blocking=True)
    # Simulate the crash window for step 2: full final dir, no COMMIT.
    ck.save(2, _tree(99.0), blocking=True)
    os.remove(tmp_path / "step_000000002.COMMIT")
    assert ck.latest_step() == 1                  # orphan invisible
    # The relaunch re-saves step 2 (different bits — the orphan's were
    # never acknowledged): it must win.
    ck2 = Checkpointer(str(tmp_path))
    ck2.save(2, _tree(2.0), blocking=True)
    assert ck2.latest_step() == 2
    out = ck2.restore(_tree(0.0), step=2)
    np.testing.assert_allclose(np.asarray(out["a"]), 2.0)


def test_competitor_gc_race_falls_back_with_warning(tmp_path):
    """all_records() -> _read_record() can race another writer's _gc:
    the listed snapshot vanishes between listing and load. That must be
    absorbed by skip-and-warn (FileNotFoundError is just another form
    of 'this entry is unreadable'), falling back to the previous
    record."""
    ck = Checkpointer(str(tmp_path), keep_k=3)
    for s in [1, 2, 3]:
        ck.save(s, _tree(float(s)), blocking=True)
    # Competitor's _gc deleted the newest snapshot dir but its COMMIT
    # marker still lists it (the rmtree-then-remove window).
    shutil.rmtree(tmp_path / "step_000000003")
    assert ck.latest_step() == 3                  # still listed...
    with pytest.warns(RuntimeWarning, match="step_000000003"):
        out = ck.restore(_tree(0.0))              # ...but skipped
    np.testing.assert_allclose(np.asarray(out["a"]), 2.0)
    with pytest.warns(RuntimeWarning):
        assert ck.latest_valid_step() == 2


def test_same_record_never_clobbered(tmp_path):
    """save() must not rmtree a COMMITTED copy of the same (epoch,
    step) — under co-supervision that can be a competitor's live
    restore source. The duplicate save is dropped (same epoch + step
    implies identical trajectory bits in production; here we use
    different bits to observe which copy survives)."""
    ck = Checkpointer(str(tmp_path), epoch=1, owner="w1")
    ck.save(5, _tree(1.0), blocking=True)
    ck2 = Checkpointer(str(tmp_path), epoch=1, owner="w2")
    ck2.save(5, _tree(7.0), blocking=True)        # dropped, no error
    out = ck2.restore(_tree(0.0))
    np.testing.assert_allclose(np.asarray(out["a"]), 1.0)


# ------------------------------------------------------ epoch fencing
def test_fence_reads_zero_and_advances_monotonically(tmp_path):
    d = str(tmp_path)
    assert read_fence(d) == 0
    assert advance_fence(d, 3, "a") == 3
    assert advance_fence(d, 2, "b") == 3          # advance-only
    assert read_fence(d) == 3
    _truncate(tmp_path / "FENCE", 2)              # torn fence
    # No epoch-tagged entries on disk -> nothing to recover a floor
    # from; reads 0 rather than crashing.
    assert read_fence(d) == 0


def test_torn_fence_recovers_floor_from_epoch_tags(tmp_path):
    """A torn/deleted FENCE must not roll the advance-only counter
    backward: read_fence recovers a floor from the epoch tags in
    step/COMMIT names, advance_fence refuses to write below it, and a
    previously-fenced zombie epoch STAYS fenced after the corruption
    (tear_file chaos simulates exactly this torn metadata)."""
    d = str(tmp_path)
    zombie = Checkpointer(d, epoch=1, owner="z")
    zombie.save(1, _tree(1.0), blocking=True)
    succ = Checkpointer(d, epoch=2, owner="s")
    succ.save(2, _tree(2.0), blocking=True)

    _truncate(tmp_path / "FENCE", 2)              # torn fence
    assert read_fence(d) == 2                     # floor from .e tags
    assert advance_fence(d, 1, "x") == 2          # cannot roll back
    zombie.save(10, _tree(666.0))                 # zombie still fenced
    with pytest.raises(FencedCommitError) as ei:
        zombie.wait()
    assert ei.value.fence == 2

    os.remove(tmp_path / "FENCE")                 # deleted outright
    assert read_fence(d) == 2                     # same floor
    with pytest.raises(FencedWriterError):
        Checkpointer(d, epoch=1, owner="late")    # stale open refused


def test_legacy_writer_stays_unfenced(tmp_path):
    """epoch=None (the single-writer mode) must behave as an unfenced
    writer: no FENCE file appears, names carry no epoch tag, commits
    are never rejected even if someone else fences the directory."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1.0), blocking=True)
    assert not (tmp_path / "FENCE").exists()
    assert (tmp_path / "step_000000001").exists()
    advance_fence(str(tmp_path), 9, "other")
    ck.save(2, _tree(2.0), blocking=True)         # still commits
    assert ck.all_steps() == [1, 2]


def test_stale_fence_token_rejected_at_open(tmp_path):
    Checkpointer(str(tmp_path), epoch=4)
    with pytest.raises(FencedWriterError, match="epoch 4"):
        Checkpointer(str(tmp_path), epoch=3)
    Checkpointer(str(tmp_path), epoch=4)          # same epoch reopens


def test_zombie_commit_rejected_at_rename_boundary(tmp_path):
    """The core fencing guarantee: a writer superseded AFTER it
    enqueued a save has the commit rejected at the rename boundary —
    the snapshot never becomes visible, bitwise nothing on disk
    changes, and the error carries enough context to log."""
    zombie = Checkpointer(str(tmp_path), epoch=1, owner="zombie")
    zombie.save(1, _tree(1.0), blocking=True)
    before = sorted(os.listdir(tmp_path))
    successor = Checkpointer(str(tmp_path), epoch=2, owner="succ")
    zombie.save(10, _tree(666.0))                 # late zombie write
    with pytest.raises(FencedCommitError) as ei:
        zombie.wait()
    assert (ei.value.step, ei.value.epoch, ei.value.fence) == (10, 1, 2)
    assert zombie.fenced_commits == 1
    # Bitwise: the directory is unchanged except the advanced FENCE.
    after = sorted(os.listdir(tmp_path))
    assert after == before
    successor.save(2, _tree(2.0), blocking=True)
    assert successor.latest_record() == (2, 2)


def test_epoch_major_ordering_beats_step_ordering(tmp_path):
    """Belt-and-suspenders: even if a zombie's HIGHER step id had
    landed (simulating a commit that raced past the fence check), the
    successor's lower-step snapshot outranks it — records order
    epoch-major, and a pinned step resolves to its newest epoch."""
    old = Checkpointer(str(tmp_path), epoch=1, owner="old")
    old.save(5, _tree(5.0), blocking=True)
    old.save(10, _tree(10.0), blocking=True)      # zombie's high step
    succ = Checkpointer(str(tmp_path), epoch=2, owner="succ")
    succ.save(5, _tree(50.0), blocking=True)      # resumed line, low step
    assert succ.all_records() == [(1, 5), (1, 10), (2, 5)]
    assert succ.latest_record() == (2, 5)
    out = succ.restore(_tree(0.0))
    np.testing.assert_allclose(np.asarray(out["a"]), 50.0)
    out = succ.restore(_tree(0.0), step=5)        # pin -> newest epoch
    np.testing.assert_allclose(np.asarray(out["a"]), 50.0)


def test_keep_k_gc_ages_out_superseded_line_first(tmp_path):
    ck1 = Checkpointer(str(tmp_path), keep_k=2, epoch=1)
    ck1.save(8, _tree(8.0), blocking=True)
    ck1.save(9, _tree(9.0), blocking=True)
    ck2 = Checkpointer(str(tmp_path), keep_k=2, epoch=2)
    ck2.save(1, _tree(1.0), blocking=True)
    ck2.save(2, _tree(2.0), blocking=True)
    assert ck2.all_records() == [(2, 1), (2, 2)]  # old line gc'd first


def test_tmp_sweep_is_owner_scoped(tmp_path):
    """A new fenced writer must not sweep a live competitor's in-flight
    tmp dir (same epoch, different owner); it must sweep its own
    leftovers, legacy untagged tmps, and fenced-out lines' tmps."""
    d = tmp_path
    os.makedirs(d / ".tmp_step_000000001.e000002.alice" / "arrays")
    os.makedirs(d / ".tmp_step_000000002.e000002.bob" / "arrays")
    os.makedirs(d / ".tmp_step_000000003.e000001.carol" / "arrays")
    os.makedirs(d / ".tmp_step_000000004" / "arrays")   # legacy
    Checkpointer(str(d), epoch=2, owner="bob")
    assert (d / ".tmp_step_000000001.e000002.alice").exists()  # live peer
    assert not (d / ".tmp_step_000000002.e000002.bob").exists()   # own
    assert not (d / ".tmp_step_000000003.e000001.carol").exists()  # fenced
    assert not (d / ".tmp_step_000000004").exists()               # legacy


def test_manifest_records_epoch(tmp_path):
    ck = Checkpointer(str(tmp_path), epoch=3)
    ck.save(1, _tree(1.0), blocking=True)
    _, manifest = ck.restore_named()
    assert manifest["epoch"] == 3
    assert (tmp_path / "step_000000001.e000003").exists()


def test_restore_places_tensors_on_the_device(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(3.0), blocking=True)
    out = ck.restore(_tree(0.0), device="cpu")
    assert isinstance(out["a"], torch.Tensor) and out["a"].device.type == "cpu"
    assert out["a"].dtype == torch.float32
    assert out["b"]["c"].dtype == torch.int64
    torch.testing.assert_close(out["b"]["c"], torch.arange(5) * 3)


def test_save_copies_the_host_array_at_once(tmp_path):
    """save() takes its host copy synchronously: an in-place update of the
    caller's array after save() returns never reaches the file."""
    ck = Checkpointer(str(tmp_path))
    a, t = np.zeros(1000, np.float64), torch.zeros(7)
    ck.save(1, {"a": a, "t": t})
    a += 1.0
    t += 1.0
    ck.wait()
    arrays, _ = ck.restore_named()
    assert not arrays["a"].any() and not arrays["t"].any()


# ------------------------------------------------- against the JAX package
_Pair = collections.namedtuple("_Pair", "x y")


def _nested():
    g = np.random.default_rng(0)
    return {"w": g.normal(size=(3, 2)).astype(np.float32),
            "z": [np.arange(4, dtype=np.int32),
                  (np.float64(2.5), None, np.zeros((0,), np.float32))],
            "a": {"k": np.array([7, 9], np.uint32),
                  "p": _Pair(np.ones(2, np.float32), np.int64(3))},
            "10": np.eye(2, dtype=np.float32)}


def test_leaf_names_and_order_are_the_reference_flatteners():
    tree = _nested()
    names, leaves, treedef = port_checkpointer._tree_flatten_with_names(tree)
    rnames, rleaves, _ = ref_checkpointer._tree_flatten_with_names(tree)
    assert names == rnames
    assert all(a is b for a, b in zip(leaves, rleaves))
    back = port_checkpointer._tree_unflatten(treedef, leaves)
    assert port_checkpointer._tree_flatten_with_names(back)[0] == names
    assert isinstance(back["a"]["p"], _Pair) and back["z"][1][1] is None


def _files(d):
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def _manifest_without_time(raw):
    m = json.loads(raw)
    assert isinstance(m.pop("time"), float)
    return m


@pytest.mark.parametrize("epoch", [None, 3])
def test_same_tree_gives_the_reference_files(tmp_path, epoch):
    """Both packages write one tree: the same file names, byte-identical
    .npy files and COMMIT markers, manifests equal but for the wall-clock
    time, and (fenced) the same epoch in FENCE and the directory names."""
    meta = {"it": 4, "objs": [1.5, 0.25], "fingerprint": "{}"}
    kw = {} if epoch is None else dict(epoch=epoch, owner="w")
    tree = _nested()
    for mk, sub in ((Checkpointer, "port"), (ref_ckpt.Checkpointer, "ref")):
        ck = mk(str(tmp_path / sub), **kw)
        ck.save(4, tree, meta=meta, blocking=True)
        ck.save(5_000_002, tree, meta=meta, blocking=True)
    port, ref = _files(tmp_path / "port"), _files(tmp_path / "ref")
    assert sorted(port) == sorted(ref)
    for name in port:
        if name.endswith("manifest.json"):
            assert (_manifest_without_time(port[name])
                    == _manifest_without_time(ref[name]))
        elif name == "FENCE":
            assert (json.loads(port[name])["epoch"]
                    == json.loads(ref[name])["epoch"] == epoch)
        else:
            assert port[name] == ref[name], name


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_directories_interchange(tmp_path, writer):
    """A fenced directory written by one package (three steps, keep_k = 2,
    a superseded epoch line) restores through the other's Checkpointer:
    the same records, steps and latest step, every leaf name and array
    bitwise, the meta and epoch of each snapshot, and the FENCE."""
    d = str(tmp_path)
    W, R = ((ref_ckpt.Checkpointer, Checkpointer) if writer == "ref"
            else (Checkpointer, ref_ckpt.Checkpointer))
    g = np.random.default_rng(1)
    trees = {s: {"state": g.normal(size=(5,)).astype(np.float32),
                 "key": np.array([0, s], np.uint32),
                 "samp_sum": g.normal(size=(5,))} for s in (1, 2, 3)}
    old = W(d, keep_k=2, epoch=1, owner="old")
    old.save(9, trees[1], meta={"it": 9}, blocking=True)
    new = W(d, keep_k=2, epoch=2, owner="new")
    for s in (1, 2, 3):
        new.save(s * 1_000_000, trees[s], meta={"it": s}, blocking=True)
    rd = R(d, keep_k=2)
    assert rd.all_records() == [(2, 2_000_000), (2, 3_000_000)]
    assert rd.latest_step() == 3_000_000 and read_fence(d) == 2
    assert ref_ckpt.read_fence(d) == 2
    for s in (2, 3):
        arrays, manifest = rd.restore_named(s * 1_000_000)
        assert manifest["meta"] == {"it": s} and manifest["epoch"] == 2
        assert sorted(arrays) == sorted(trees[s])
        for k, v in trees[s].items():
            assert arrays[k].dtype == v.dtype
            assert np.array_equal(arrays[k], v), k


def test_torn_reference_snapshot_falls_back_in_the_port(tmp_path):
    ck = ref_ckpt.Checkpointer(str(tmp_path), keep_k=3)
    for s in (1, 2):
        ck.save(s, {"a": np.full(3, float(s), np.float32)}, blocking=True)
    with open(tmp_path / "step_000000002" / "arrays" / "0.npy", "r+b") as f:
        f.truncate(8)
    with pytest.warns(RuntimeWarning, match="step_000000002"):
        out = Checkpointer(str(tmp_path)).restore(
            {"a": np.zeros(3, np.float32)})
    assert torch.equal(out["a"], torch.full((3,), 1.0))


@pytest.mark.parametrize("fencer", ["ref", "port"])
def test_one_fence_across_packages(tmp_path, fencer):
    """The fence is one counter: a writer of one package is refused at open
    below a fence the other advanced, and a commit in flight when the other
    package advances the fence is rejected at the rename boundary, leaving
    the records as they were."""
    d = str(tmp_path)
    adv, W = ((ref_ckpt.advance_fence, Checkpointer) if fencer == "ref"
              else (advance_fence, ref_ckpt.Checkpointer))
    writer = W(d, epoch=3, owner="w")
    writer.save(1, {"a": np.ones(2, np.float32)}, blocking=True)
    assert adv(d, 5, "other") == 5
    before = sorted(os.listdir(d))
    writer.save(2, {"a": np.zeros(2, np.float32)})
    with pytest.raises(Exception) as ei:
        writer.wait()
    assert type(ei.value).__name__ == "FencedCommitError"
    assert (ei.value.epoch, ei.value.fence) == (3, 5)
    assert sorted(os.listdir(d)) == before
    with pytest.raises(Exception) as ei:
        W(d, epoch=4, owner="late")
    assert type(ei.value).__name__ == "FencedWriterError"
