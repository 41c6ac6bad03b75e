"""Fault-tolerant checkpointing: async, atomic, keep-K, elastic restore,
epoch-fenced multi-writer safety. The port's copy of
``repro/checkpoint/checkpointer.py``: the same directories, manifests and
array files, so that a snapshot written by either package restores
through the other's ``Checkpointer``; only the tree walk (a flattener
that names the leaves as the reference's tree utilities do) and the
placement of restored arrays (``torch`` tensors on a given device) are
the port's own.

Layout (one directory per step; the epoch tag appears for fenced
writers with epoch > 0 — legacy single-writer directories stay valid):
    <dir>/step_000000100/            # epoch-0 (legacy) name
    <dir>/step_000000100.e000003/    # the same step written at epoch 3
        manifest.json        # tree structure, shapes, dtypes, epoch
        arrays/<idx>.npy     # one file per leaf (host-gathered)
    <dir>/step_000000100.e000003.COMMIT  # written last -> atomicity
    <dir>/FENCE              # advance-only max epoch ever granted

Design points for 1000+ node deployments (documented where this
single-host implementation stands in for the multi-host version):
  * save is ASYNC: the step's arrays are snapshotted to host memory
    synchronously (cheap device->host copy) and written by a background
    thread, so training never blocks on the filesystem;
  * atomicity by COMMIT marker — restore only considers committed steps,
    so a node failure mid-save never corrupts the restore point. Every
    file (arrays, manifest, the marker) is fsynced and the containing
    directories are fsynced around the rename, so the commit cannot be
    reordered ahead of its data by the page cache on a power loss;
  * EPOCH FENCING makes the directory safe under multiple concurrent
    writers (several controllers co-supervising one checkpoint store):
    a writer opened with a fence token (``epoch=``) advances the
    shared ``FENCE`` file at open; its commits re-read the fence AFTER
    the data fsync and BEFORE the rename/COMMIT become visible, and a
    superseded writer (fence > own epoch) has the commit rejected at
    that rename boundary (``FencedCommitError``) — a zombie worker's
    late commit can never win over a relaunch's line. Restore resolves
    the newest snapshot by ``(epoch, step)`` ordering, epoch-major, so
    even a commit that races past the fence check never outranks the
    successor line. Fencing at COMMIT rather than at ``save()`` keeps
    the check off the hot path and closes the enqueue->write race: the
    authoritative read happens on the writer thread, after the data is
    durable, immediately before visibility;
  * defense in depth past the marker: restore VALIDATES the newest
    committed snapshot (manifest parse, array load, shape/dtype check
    against the manifest) and on a truncated/corrupt/concurrently-GCed
    snapshot it warns and falls back to the previous entry instead of
    crashing the resume (`latest_valid_step`/`restore*`);
  * keep_k garbage collection bounds disk (ordered by (epoch, step),
    so a superseded line's snapshots age out first);
  * ELASTIC restore: arrays are saved as full (host-gathered) logical
    tensors, so a checkpoint written on a 2x16x16 mesh restores onto a
    16x16 (or any other) mesh — restore places each leaf on the
    device it is given (on a ``torch.distributed`` mesh the solver
    state is replicated, so every rank places the same host array).
    On multi-host each host would write only its addressable shards
    (same manifest format, per-shard files), which is a file-naming
    change, not a format change.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import threading
import time
import warnings
from typing import Any

import numpy as np
import torch

FENCE_FILE = "FENCE"

_OWNER_SEQ = itertools.count()   # unique default owner per writer

_FENCE_LOCK = threading.Lock()   # serialize in-process fence advances

_STEP_RE = re.compile(r"^step_(\d{9})(?:\.e(\d{6}))?$")
_COMMIT_RE = re.compile(r"^step_(\d{9})(?:\.e(\d{6}))?\.COMMIT$")
_TMP_RE = re.compile(r"^\.tmp_step_(\d{9})(?:\.e(\d{6}))?(?:\.(.+))?$")


class FencedWriterError(RuntimeError):
    """Raised at ``Checkpointer`` construction when the fence token is
    already superseded: another writer line (a lease takeover, a
    relaunched attempt) advanced the shared FENCE past this epoch, so
    nothing this writer could commit would ever be restored."""


class FencedCommitError(RuntimeError):
    """A commit was rejected at the rename boundary: the shared FENCE
    advanced past this writer's epoch between open and commit — the
    writer is a zombie (its controller abandoned it, or its controller
    lost the lease) and its snapshot must not become visible."""

    def __init__(self, msg: str, *, step: int, epoch: int, fence: int,
                 directory: str):
        super().__init__(msg)
        self.step = step
        self.epoch = epoch
        self.fence = fence
        self.directory = directory


class CheckpointWriteError(RuntimeError):
    """A background checkpoint write failed. Wraps the original error
    with the step id and directory so a fleet log can attribute the
    lost commit to a snapshot (the on-disk state stays at the previous
    commit). The original exception rides ``__cause__``."""

    def __init__(self, msg: str, *, step: int, epoch: int,
                 directory: str):
        super().__init__(msg)
        self.step = step
        self.epoch = epoch
        self.directory = directory


def _fsync_path(path: str) -> None:
    """fsync a file or directory by path (directory fsync is what makes
    a rename durable on POSIX filesystems)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fence_floor(directory: str) -> int:
    """Lower bound on the max epoch ever granted, recovered from the
    epoch tags in step/COMMIT/tmp names. Every tagged entry was written
    by a writer whose epoch the fence had been advanced to, so the
    advance-only counter can never legitimately sit below this."""
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    floor = 0
    for f in names:
        m = _STEP_RE.match(f) or _COMMIT_RE.match(f) or _TMP_RE.match(f)
        if m is not None:
            floor = max(floor, int(m.group(2) or 0))
    return floor


def read_fence(directory: str) -> int:
    """Max epoch ever granted on this checkpoint directory (0 if no
    fenced writer has opened it). A torn/corrupt/deleted FENCE file
    does NOT read as 0 — that would let ``advance_fence`` roll the
    advance-only counter backward and previously-fenced zombie epochs
    would pass the commit-boundary check again. Instead the fence is
    recovered from the epoch tags present in the directory
    (``_fence_floor``): a lower bound, but one that covers every epoch
    with on-disk evidence, so zombie rejection survives torn
    metadata."""
    try:
        with open(os.path.join(directory, FENCE_FILE)) as f:
            return int(json.load(f)["epoch"])
    except (OSError, TypeError, ValueError, KeyError,
            json.JSONDecodeError):
        return _fence_floor(directory)


def advance_fence(directory: str, epoch: int, owner: str | None = None
                  ) -> int:
    """Advance the shared fence to ``epoch`` (no-op if already there or
    beyond); returns the resulting fence. The write is atomic
    (tmp + fsync + rename + directory fsync), so a concurrent reader
    sees either the old or the new epoch, never a tear. Advance-only:
    the fence is the single monotonic counter that attempt epochs AND
    lease terms are minted from (``runtime/lease.py``); because
    ``read_fence`` recovers a floor from on-disk epoch tags when the
    FENCE file itself is torn, corruption cannot be leveraged to write
    an epoch below what the directory's contents already prove."""
    # The lock serializes in-process advancers (several controllers in
    # one test process): without it, two threads could interleave
    # read-then-replace and roll the fence BACKWARD. Cross-process the
    # window is benign for correctness of the protocols built on top —
    # terms/epochs are minted max(fence)+1 and verified after write
    # (lease re-read; FencedWriterError at open) — but in-process we
    # can simply not have the window.
    with _FENCE_LOCK:
        cur = read_fence(directory)
        if epoch <= cur:
            return cur
        os.makedirs(directory, exist_ok=True)
        tmp = os.path.join(
            directory,
            f".{FENCE_FILE}.tmp.{os.getpid()}.{next(_OWNER_SEQ)}")
        with open(tmp, "w") as f:
            json.dump({"epoch": int(epoch), "owner": owner,
                       "time": time.time()}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(directory, FENCE_FILE))
        _fsync_path(directory)
        return epoch


def _tree_flatten_with_names(tree):
    """(names, leaves, treedef) of a tree of dicts, lists, tuples and
    namedtuples, in the order and with the names the reference gets from
    its ``tree_flatten_with_path``: dict keys sorted, a sequence entry
    named by its index, a namedtuple field by ``.field``, the path joined
    with "/"; None is an empty subtree. ``treedef`` rebuilds the tree
    (``_tree_unflatten``)."""
    paths, leaves = [], []

    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return (dict, list(node), {k: walk(node[k], path + (str(k),))
                                       for k in sorted(node)})
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return (type(node), None, [walk(getattr(node, f),
                                            path + (f".{f}",))
                                       for f in node._fields])
        if isinstance(node, (list, tuple)):
            return (type(node), None, [walk(v, path + (str(i),))
                                       for i, v in enumerate(node)])
        paths.append(path)
        leaves.append(node)
        return _LEAF

    treedef = walk(tree, ())
    return ["/".join(p) for p in paths], leaves, treedef


_LEAF = object()


def _tree_unflatten(treedef, leaves):
    """The tree of ``treedef`` with ``leaves`` in flattening order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if node is _LEAF:
            return next(it)
        kind, order, kids = node
        if kind is dict:
            vals = {k: build(kids[k]) for k in sorted(kids)}
            return {k: vals[k] for k in order}
        vals = [build(k) for k in kids]
        if kind is list:
            return vals
        if kind is tuple:
            return tuple(vals)
        return kind(*vals)

    return build(treedef)


def _host_copy(x) -> np.ndarray:
    """A host copy of one leaf, taken now: a tensor (on any device) or
    anything numpy takes. The copy keeps the background write from seeing
    a later in-place update of the caller's array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


class Checkpointer:
    """``epoch=None`` (default) is the legacy single-writer mode: no
    fence is advanced and commits are never rejected — exactly the
    pre-fencing behavior. ``epoch=e`` opens a FENCED writer: the shared
    FENCE advances to ``e`` at open (raising :class:`FencedWriterError`
    if already superseded) and every commit re-checks the fence at the
    rename boundary. ``owner`` scopes the tmp work directories so a
    sweep never deletes a live competitor's in-flight write."""

    def __init__(self, directory: str, keep_k: int = 3, *,
                 epoch: int | None = None, owner: str | None = None):
        self.dir = directory
        self.keep_k = keep_k
        self.epoch = int(epoch) if epoch is not None else 0
        self._fenced = epoch is not None
        self.owner = (str(owner) if owner
                      else f"pid{os.getpid()}w{next(_OWNER_SEQ)}")
        self.fenced_commits = 0          # rejected-at-boundary count
        os.makedirs(directory, exist_ok=True)
        if self._fenced:
            fence = read_fence(directory)
            if fence > self.epoch:
                raise FencedWriterError(
                    f"checkpoint writer opened with fence token (epoch) "
                    f"{self.epoch}, but {directory} has already granted "
                    f"epoch {fence} — this writer line is superseded and "
                    "must not commit (resume under a fresh epoch instead)")
            advance_fence(directory, self.epoch, self.owner)
        self._sweep_stale_tmp()
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ------------------------------------------------------------- naming
    def _name(self, step: int, epoch: int | None = None) -> str:
        e = self.epoch if epoch is None else epoch
        base = f"step_{step:09d}"
        return base if e == 0 else f"{base}.e{e:06d}"

    @staticmethod
    def _parse_commit(fname: str) -> tuple[int, int] | None:
        m = _COMMIT_RE.match(fname)
        if m is None:
            return None
        return (int(m.group(2) or 0), int(m.group(1)))   # (epoch, step)

    def _sweep_stale_tmp(self) -> None:
        """Remove stale ``.tmp_step_*`` work directories left by a
        crash mid-save. OWNER-SCOPED: with several writers sharing the
        directory, sweeping everything would delete a live competitor's
        in-flight write. A tmp is swept iff it belongs to this owner,
        predates this writer's epoch (its line is fenced — it can never
        commit, so its work is garbage), or carries no owner tag at all
        (legacy writer, by definition single-writer)."""
        for f in os.listdir(self.dir):
            m = _TMP_RE.match(f)
            if m is None:
                continue
            tmp_epoch = int(m.group(2) or 0)
            tmp_owner = m.group(3)
            if (tmp_owner is None or tmp_owner == self.owner
                    or tmp_epoch < self.epoch):
                shutil.rmtree(os.path.join(self.dir, f),
                              ignore_errors=True)

    # ------------------------------------------------------------- saving
    def save(self, step: int, tree: Any, *, blocking: bool = False,
             meta: dict | None = None) -> None:
        """Snapshot to host, then write in the background.

        ``meta`` is an optional JSON-able dict stored in the manifest —
        the solver keeps its scalar resume state (iteration, histories,
        config fingerprint) there so the array leaves stay pure tensors.
        """
        self.wait()  # at most one outstanding save
        names, leaves, _ = _tree_flatten_with_names(tree)
        host = [_host_copy(x) for x in leaves]   # device->host snapshot

        def _write():
            name = self._name(step)
            # Fenced writers OWN their tmp dirs (multi-writer safety);
            # legacy writers keep the untagged name, whose sweep
            # assumes single-writer.
            tmp = os.path.join(
                self.dir, f".tmp_{name}.{self.owner}" if self._fenced
                else f".tmp_{name}")
            try:
                final = os.path.join(self.dir, name)
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(os.path.join(tmp, "arrays"))
                manifest = {"step": step, "epoch": self.epoch,
                            "time": time.time(),
                            "meta": meta or {}, "leaves": []}
                for i, (n, a) in enumerate(zip(names, host)):
                    with open(os.path.join(tmp, "arrays", f"{i}.npy"),
                              "wb") as f:
                        np.save(f, a)
                        f.flush()
                        os.fsync(f.fileno())
                    manifest["leaves"].append(
                        {"name": n, "idx": i, "shape": list(a.shape),
                         "dtype": str(a.dtype)})
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                    os.fsync(f.fileno())
                # Data must be durable BEFORE the rename/COMMIT become
                # visible, or a power loss could leave a committed step
                # with torn contents.
                _fsync_path(os.path.join(tmp, "arrays"))
                _fsync_path(tmp)
                # FENCE CHECK at the rename boundary: after the data
                # fsync, before anything becomes visible. A writer
                # whose epoch was superseded while it was writing (its
                # controller lost the lease; its attempt was abandoned
                # and relaunched) is a zombie — reject the commit.
                if self._fenced:
                    fence = read_fence(self.dir)
                    if fence > self.epoch:
                        shutil.rmtree(tmp, ignore_errors=True)
                        self.fenced_commits += 1
                        raise FencedCommitError(
                            f"commit of {name} in {self.dir} rejected: "
                            f"writer epoch {self.epoch} superseded by "
                            f"fence {fence} — a newer attempt owns this "
                            "checkpoint line (zombie write fenced out)",
                            step=step, epoch=self.epoch, fence=fence,
                            directory=self.dir)
                if os.path.exists(final + ".COMMIT"):
                    # Same (epoch, step) already committed — never
                    # clobber a committed snapshot; same epoch + same
                    # step means the identical trajectory bits anyway.
                    shutil.rmtree(tmp, ignore_errors=True)
                else:
                    # A final dir WITHOUT a commit marker is the crash
                    # window (death between rename and COMMIT): it was
                    # never a restore candidate, so the next writer of
                    # the same step replaces it.
                    shutil.rmtree(final, ignore_errors=True)
                    os.rename(tmp, final)
                    _fsync_path(self.dir)              # durable rename
                    with open(final + ".COMMIT", "w") as f:
                        f.flush()
                        os.fsync(f.fileno())           # atomic commit mark
                    _fsync_path(self.dir)
                self._gc()
            except FencedCommitError as e:
                self._error = e
            except Exception as e:  # noqa: BLE001
                shutil.rmtree(tmp, ignore_errors=True)
                self._error = CheckpointWriteError(
                    f"background checkpoint write of {name} in "
                    f"{self.dir} failed ({e!r}) — the commit is lost; "
                    "on-disk state stays at the previous committed "
                    "snapshot", step=step, epoch=self.epoch,
                    directory=self.dir)
                self._error.__cause__ = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        if not self.keep_k:
            return
        records = self.all_records()
        for e, s in records[: -self.keep_k]:
            name = self._name(s, e)
            shutil.rmtree(os.path.join(self.dir, name),
                          ignore_errors=True)
            try:
                os.remove(os.path.join(self.dir, name + ".COMMIT"))
            except OSError:
                pass

    # ------------------------------------------------------------ restore
    def all_records(self) -> list[tuple[int, int]]:
        """All committed snapshots as ``(epoch, step)``, sorted
        epoch-major: the LAST entry is what restore resolves with no
        pin. Epoch-major ordering is the fencing guarantee's second
        half — even a zombie commit that raced past the fence check
        never outranks the successor line's snapshots."""
        out = []
        for f in os.listdir(self.dir):
            rec = self._parse_commit(f)
            if rec is not None:
                out.append(rec)
        return sorted(out)

    def all_steps(self) -> list[int]:
        return sorted({s for _, s in self.all_records()})

    def latest_record(self) -> tuple[int, int] | None:
        records = self.all_records()
        return records[-1] if records else None

    def latest_step(self) -> int | None:
        rec = self.latest_record()
        return rec[1] if rec else None

    def _read_record(self, epoch: int, step: int, mmap: bool = False
                     ) -> tuple[dict, dict]:
        """Load + VALIDATE one committed snapshot: the manifest must
        parse and every leaf array must load with the manifest's
        shape/dtype. Raises on any corruption (truncated npy, torn
        manifest, missing file — including a directory a competitor's
        GC deleted between listing and load) — the fallback loop below
        turns that into skip-and-warn. ``mmap``: the arrays are mapped
        read-only, not read (a truncated file still fails to map)."""
        final = os.path.join(self.dir, self._name(step, epoch))
        with open(os.path.join(final, "manifest.json")) as f:
            manifest = json.load(f)
        arrays: dict[str, np.ndarray] = {}
        for e in manifest["leaves"]:
            a = np.load(os.path.join(final, "arrays", f"{e['idx']}.npy"),
                        mmap_mode="r" if mmap else None)
            if (list(a.shape) != list(e["shape"])
                    or str(a.dtype) != e["dtype"]):
                raise ValueError(
                    f"leaf {e['name']!r} of {self._name(step, epoch)} "
                    f"loads as {a.shape}/{a.dtype}, manifest says "
                    f"{e['shape']}/{e['dtype']} — corrupt snapshot")
            arrays[e["name"]] = a
        return arrays, manifest

    def _resolve_pin(self, step: int) -> tuple[int, int]:
        """A pinned step resolves to its newest epoch (the successor
        line's copy when both a zombie and its successor committed the
        same step id)."""
        epochs = [e for e, s in self.all_records() if s == step]
        if not epochs:
            raise FileNotFoundError(
                f"no committed checkpoint for step {step} in {self.dir}")
        return max(epochs), step

    def _load_valid(self, step: int | None, mmap: bool = False
                    ) -> tuple[int, dict, dict]:
        """Resolve ``step`` to a VALID snapshot. An explicit step is
        loaded strictly (corruption raises — the caller pinned it). With
        ``step=None``, committed records are tried newest-first in
        ``(epoch, step)`` order; a truncated/corrupt/concurrently-
        deleted snapshot is skipped with a warning and the previous
        entry is used instead, so one torn write (or a competitor's GC
        racing this read) never poisons the whole resume directory."""
        if step is not None:
            epoch, step = self._resolve_pin(step)
            arrays, manifest = self._read_record(epoch, step, mmap)
            return step, arrays, manifest
        records = self.all_records()
        if not records:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        for e, s in reversed(records):
            try:
                arrays, manifest = self._read_record(e, s, mmap)
                return s, arrays, manifest
            except Exception as exc:  # noqa: BLE001 — corrupt: try older
                warnings.warn(
                    f"checkpoint {self._name(s, e)} in {self.dir} is "
                    f"unreadable ({exc!r}); falling back to the previous "
                    "committed snapshot", RuntimeWarning, stacklevel=3)
        raise FileNotFoundError(
            f"all {len(records)} committed checkpoints in {self.dir} are "
            "corrupt — nothing to restore (poisoned checkpoint "
            "directory)")

    def latest_valid_step(self) -> int | None:
        """Newest committed step that actually loads — what restore()
        with ``step=None`` will use. Corrupt newer steps warn."""
        try:
            step, _, _ = self._load_valid(None)
        except FileNotFoundError:
            return None
        return step

    def restore(self, tree_like: Any, step: int | None = None,
                device=None, place=None) -> Any:
        """Restore into the structure of ``tree_like`` as tensors on
        ``device`` (the CPU when None). Checkpoints hold logical host
        arrays, so the mesh that wrote one need not be the mesh that
        restores it: this is the elastic-remesh path. ``place(name,
        array)``: the tensor to keep of each leaf (a mesh rank's block),
        the arrays then memory-mapped, so a leaf is read only as far as
        ``place`` reads it."""
        step, arrays, manifest = self._load_valid(step, place is not None)
        names, leaves, treedef = _tree_flatten_with_names(tree_like)
        by_name = {e["name"]: e for e in manifest["leaves"]}
        out = []
        for n, leaf in zip(names, leaves):
            if n not in by_name:
                raise ValueError(
                    f"checkpoint step_{step:09d} in {self.dir} has no "
                    f"leaf named {n!r}; it holds "
                    f"{sorted(e['name'] for e in manifest['leaves'])} — "
                    "the restore tree's structure does not match what "
                    "was saved (config/model mismatch?)")
            a = arrays[n]
            want = tuple(getattr(leaf, "shape", a.shape))
            if tuple(a.shape) != want:
                raise ValueError(
                    f"checkpoint leaf {n!r} of step_{step:09d} in "
                    f"{self.dir} has shape {tuple(a.shape)}, the restore "
                    f"tree expects {want} — restoring requires matching "
                    "logical shapes (checkpoints are layout-free, so an "
                    "elastic remesh changes SHARDING, never shape; a "
                    "shape change means a different dataset, "
                    "featurization, or model was used)")
            out.append(torch.from_numpy(a).to(device) if place is None
                       else place(n, a))
        return _tree_unflatten(treedef, out)

    def restore_named(self, step: int | None = None
                      ) -> tuple[dict, dict]:
        """Restore as a flat ``{leaf_name: np.ndarray}`` dict plus the
        manifest (which carries ``meta``). Structure-free counterpart of
        ``restore`` for callers whose payload shape is data-dependent —
        the solver's resume path, where history lengths and the presence
        of mid-pass accumulators vary per checkpoint."""
        _, arrays, manifest = self._load_valid(step)
        return arrays, manifest
