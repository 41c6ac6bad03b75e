"""Host-side data preparation and the host-to-device chunk path: the
port's copies of ``pad_features_to``, ``reservoir_rows``,
``RetryStats``, ``retrying_chunks`` and ``ChunkPrefetcher`` from
``repro/data/pipeline.py`` (that module imports jax, so the port keeps
its own), and the device side of the copy.

On the card a chunk reaches the device through ``DevicePlacer``: the
rows are copied host-to-device from page-locked memory on a side CUDA
stream, either from a pinned staging ring (any host array; one host
memcpy a chunk) or straight from a source the caller page-locked with
``PageLock`` (``cudaHostRegister``, no host copy). The consumer's stream
waits on the copy's event; no host synchronize is involved.
``rows_to_device`` is the same path for the resident fit's set-up, and
the serving cells place each request bucket the same way.
``reservoir_rows`` draws Nystrom landmarks from a chunk source in one
pass. ``ShardedBatcher`` is the LM trainer's token batcher, on one
device or on a mesh: every rank builds the same host batch and keeps its
data-parallel rows (the reference's ``_place`` under ``P(batch_axes,
None)``), rows row-major over ``batch_axes``.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Iterable, Iterator

import numpy as np
import torch


def pad_features_to(X: np.ndarray, multiple: int | None = None, *,
                    width: int | None = None) -> np.ndarray:
    """Zero-pad the feature (last) dimension of a host row block so that its
    width divides ``multiple``: the route to a k_shard-divisible statistic
    width (``linear._k_block`` refuses an indivisible one rather than drop
    Sigma columns; ``SVMConfig.pad_features`` applies this in ``fit``).
    Zero columns are exact no-ops for every statistic: their Sigma rows
    and columns and b entries are zero and the ridge pins their weights to
    0. An already divisible width is returned as it is.

    ``width=`` instead pads to an absolute width (serving: a request widens
    to the model's fitted width, never narrows) and refuses a target below
    the current width, since slicing features off would change every
    score."""
    K = X.shape[-1]
    if width is not None:
        assert multiple is None, "pass either multiple or width, not both"
        if width < K:
            raise ValueError(
                f"target width {width} is below the current feature "
                f"width {K}; refusing to slice columns off")
        pad = width - K
    else:
        if multiple is None or multiple <= 1:
            return X
        pad = (-K) % multiple
    if pad == 0:
        return X
    return np.pad(X, [(0, 0)] * (X.ndim - 1) + [(0, pad)])


def reservoir_rows(chunks: Iterable, m: int, seed: int = 0
                   ) -> tuple[np.ndarray, int]:
    """A uniform sample of ``m`` valid rows from an iterator of (X, y,
    mask) host chunks, in one pass and O(m * D) memory: reservoir sampling
    over the rows with mask > 0, so an out-of-core source
    (``iter_libsvm``) can supply Nystrom landmarks without being resident.
    Valid row j replaces a reservoir slot with probability m / (j + 1);
    the slots of a chunk's rows come from one ``rng.integers`` call with a
    per-row upper bound, so a seed draws the reference's rows. Returns
    (rows (m', D), n_valid) with m' = min(m, n_valid)."""
    rng = np.random.default_rng(seed)
    reservoir: list[np.ndarray] = []
    seen = 0
    for Xc, _, mc in chunks:
        rows = np.asarray(Xc, np.float32)[np.asarray(mc) > 0]
        fill = min(max(m - len(reservoir), 0), len(rows))
        reservoir.extend(np.array(r) for r in rows[:fill])
        seen += fill
        rows = rows[fill:]
        if not len(rows):
            continue
        # Row i of this chunk is valid row seen + i: its slot is drawn
        # from [0, seen + i + 1).
        slots = rng.integers(0, seen + 1 + np.arange(len(rows)))
        seen += len(rows)
        for i in np.nonzero(slots < m)[0]:    # in order: later rows win
            reservoir[slots[i]] = np.array(rows[i])
    if not reservoir:
        raise ValueError("reservoir_rows: source yielded no valid rows")
    return np.stack(reservoir), seen


def padded_width(width: int, multiple: int | None) -> int:
    """The width ``pad_features_to`` gives a block ``width`` columns
    wide."""
    if multiple is None or multiple <= 1:
        return width
    return width + (-width) % multiple


@dataclasses.dataclass
class RetryStats:
    """Cumulative loader-retry accounting for one consumer: how much I/O
    flakiness a fit absorbed. ``retrying_chunks`` mutates the instance it
    is handed; the stream driver keeps one a fit and reports it as
    ``FitResult.loader_retries`` / ``loader_backoff_s``."""

    retries: int = 0          # total retry_on failures absorbed
    backoff_s: float = 0.0    # total seconds slept backing off
    exhausted: int = 0        # budgets that ran out (error re-raised)


def retrying_chunks(factory: Callable[[int], Iterable], *,
                    retries: int = 3, backoff: float = 0.05,
                    jitter: float = 0.0, seed: int = 0,
                    retry_on: tuple = (IOError, OSError),
                    sleep: Callable[[float], None] = time.sleep,
                    stats: RetryStats | None = None
                    ) -> Iterator:
    """Bounded retry with exponential backoff around a restartable chunk
    source: how ``driver="stream"`` turns a flaky file system into
    retries instead of a crash.

    ``factory(skip)`` returns a fresh iterator with the first ``skip``
    chunks already skipped. On a ``retry_on`` error the source is
    re-created past the chunks already yielded, after sleeping
    ``backoff * 2**(attempt-1) * (1 + jitter*u)`` seconds with
    ``u ~ U[0,1)`` drawn from a ``seed``-keyed generator: the same (seed,
    failure sequence) sleeps the same schedule. ``retries`` consecutive
    failures at the same position exhaust the budget and re-raise (a
    success resets the count). ``retries=0`` is pass-through. Exceptions
    outside ``retry_on`` propagate at once. ``stats`` (a
    :class:`RetryStats`) accumulates what was absorbed.
    """
    rng = np.random.default_rng(seed)
    yielded = 0
    attempt = 0
    it = None
    while True:
        try:
            if it is None:     # (re)open inside the retry net: the
                it = iter(factory(yielded))  # open itself can fail too
            chunk = next(it)
        except StopIteration:
            return
        except retry_on:
            attempt += 1
            if attempt > retries:
                if stats is not None:
                    stats.exhausted += 1
                raise
            pause = backoff * (2 ** (attempt - 1))
            if jitter > 0.0:
                pause *= 1.0 + jitter * float(rng.random())
            if stats is not None:
                stats.retries += 1
                stats.backoff_s += pause
            sleep(pause)
            it = None
            continue
        attempt = 0
        yielded += 1
        yield chunk


class HostPlacer:
    """The placer of the reference's contract: ``place`` (a callable,
    ``torch.from_numpy`` of each array by default) runs in the worker;
    nothing is placed at the consumer or retired."""

    def __init__(self, place: Callable | None = None):
        self.fn = place or (
            lambda arrs: tuple(torch.from_numpy(np.asarray(a))
                               for a in arrs))

    def stage(self, arrs, slot: int):
        return self.fn(arrs)

    def place(self, staged, slot: int):
        return staged

    def retire(self, slot: int) -> None:
        pass


class ChunkPrefetcher:
    """Bounded background prefetch over an iterator of host array tuples.

    A worker thread pulls host blocks from ``chunks`` and stages them (a
    ``HostPlacer``, which places them there as the reference does, or a
    ``DevicePlacer``; a plain callable is wrapped in a ``HostPlacer``),
    parking up to ``depth`` staged blocks in a queue; the consumer places
    each block as it takes it. At most ``depth + 2`` blocks are resident
    at once: ``depth`` queued, one in the worker's hand and one held by
    the consumer. Each resident block holds one of ``depth + 2`` staging
    slots; the consumer retires a block's slot once its work on the block
    is enqueued, and only then does the worker stage into that slot
    again. A ``DevicePlacer`` keeps each slot's last event (the copies
    out of it, then the consumer's work on its block) for its whole life,
    across passes too, and waits on it before it stages into the slot: so
    the bound holds on the device however far the host runs ahead of it,
    and no pinned slot is overwritten while a copy still reads it.
    ``max_resident_bytes`` reports ``nbytes * (depth + 2)`` of the blocks
    seen.

    Worker exceptions (e.g. a libsvm parse error mid-file) are forwarded
    through the queue and re-raised at the consumer's iteration site; a
    consumer that stops early never hangs.
    """

    _DONE = object()
    _ERROR = object()

    def __init__(self, chunks: Iterable, depth: int = 2, place=None):
        if depth < 1:
            raise ValueError(
                f"prefetch depth must be >= 1 (got {depth}): the worker "
                "needs at least one queue slot, so actual residency is "
                "never below 3 chunks and a silent clamp would break "
                "the documented (depth + 2) bound")
        self.chunks = chunks
        self.depth = int(depth)
        self.placer = (place if hasattr(place, "retire")
                       else HostPlacer(place))
        self.max_resident_bytes = 0

    @staticmethod
    def _nbytes(arrs) -> int:
        return sum(int(a.nbytes) for a in arrs)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        tokens: queue.Queue = queue.Queue()
        for slot in range(self.depth + 2):
            tokens.put(slot)
        stop = threading.Event()
        placer = self.placer

        def put(item) -> bool:
            # Stop-aware bounded put: never blocks forever against a
            # consumer that stopped draining.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def token():
            while not stop.is_set():
                try:
                    return tokens.get(timeout=0.2)
                except queue.Empty:
                    continue
            return None

        def worker():
            try:
                for arrs in self.chunks:
                    slot = token()
                    if slot is None:
                        return
                    if not put((None, (placer.stage(arrs, slot), slot))):
                        return
            except BaseException as e:  # noqa: BLE001 — forwarded below
                put((self._ERROR, e))
            else:
                put((self._DONE, None))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                tag, payload = q.get()
                if tag is self._DONE:
                    return
                if tag is self._ERROR:
                    raise payload
                staged, slot = payload
                arrs = placer.place(staged, slot)
                self.max_resident_bytes = max(
                    self.max_resident_bytes,
                    self._nbytes(arrs) * (self.depth + 2))
                yield arrs
                # The consumer's work on this block is enqueued: its
                # slot goes back, the placer holding the event that ends
                # that work.
                placer.retire(slot)
                tokens.put(slot)
        finally:
            stop.set()
            t.join(timeout=1.0)


def _cudart_check(err, what: str) -> None:
    if int(err) != 0:
        raise RuntimeError(f"{what} failed: {err}")


class PageLock:
    """Page-lock host arrays in place (``cudaHostRegister``) for the life
    of a ``with`` block, so the card copies straight from them. A failed
    registration raises: nothing falls back to pageable copies. On exit
    the device is synchronized (a copy may still read the arrays) and the
    arrays are unregistered."""

    def __init__(self, device: torch.device, *arrays: np.ndarray):
        self.device = device
        self.arrays = [a for a in arrays if a.nbytes]
        for a in self.arrays:
            if not a.flags.c_contiguous:
                raise ValueError("PageLock needs C-contiguous arrays")
        self._done: list[np.ndarray] = []

    def __enter__(self) -> "PageLock":
        cudart = torch.cuda.cudart()
        try:
            for a in self.arrays:
                _cudart_check(cudart.cudaHostRegister(a.ctypes.data,
                                                      a.nbytes, 0),
                              f"cudaHostRegister of {a.nbytes} bytes")
                self._done.append(a)
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def __exit__(self, *exc) -> None:
        if self._done:
            torch.cuda.synchronize(self.device)
        cudart = torch.cuda.cudart()
        while self._done:
            a = self._done.pop()
            _cudart_check(cudart.cudaHostUnregister(a.ctypes.data),
                          "cudaHostUnregister")


class DevicePlacer:
    """Places host chunks on ``device`` as the stream driver consumes them:
    ``(X, target, mask)`` with n <= ``rows`` rows and D <= ``width``
    columns becomes X (rows, width) float32 with X in [:n, :D], every
    other entry 0; target (rows,) and mask (rows,) zero past n (a target
    of None, a serving request's, stays None).
    ``mask=None`` means all n rows are valid; then column ``bias_col``
    (when given) is 1 on them, the bias column of in-memory arrays. A
    full-size block with a mask (every block, when ``rows`` and ``width``
    are None) is copied as it is.

    ``stage`` runs in the prefetcher's worker: the host side. It first
    waits for the device to be done with the block that slot ``slot``
    last held (the placer keeps that event for its whole life, so the
    wait holds across passes). With ``pinned_source=True`` the source
    arrays are used as they are (the caller has page-locked them,
    ``PageLock``); otherwise they are copied into the slot's pinned
    staging buffers. ``place`` runs in the consumer: on a CUDA device it
    allocates the chunk, copies it host-to-device (``non_blocking``) and
    assembles it on a side stream, ending in an event that the
    consumer's current stream waits on and that frees the slot; the
    tensors are ``record_stream``-ed on that stream, so the caching
    allocator does not hand their blocks back to the copy stream while a
    kernel still reads them. ``retire`` moves the slot's event past the
    consumer's work on the block. No host synchronize. On the CPU the
    same assembly runs on ``torch.from_numpy`` of the arrays."""

    def __init__(self, device, rows: int | None = None,
                 width: int | None = None, bias_col: int | None = None,
                 pinned_source: bool = False):
        self.device = torch.device(device)
        self.rows, self.width, self.bias_col = rows, width, bias_col
        self.cuda = self.device.type == "cuda"
        self.pinned_source = pinned_source
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._slots: dict = {}   # slot -> its pinned staging buffers
        self._free: dict = {}    # slot -> event ending the use of its block

    # -------------------------------------------------- worker side
    def stage(self, arrs, slot: int):
        """The host tensors the copies will read."""
        ev = self._free.get(slot)
        if ev is not None:
            ev.synchronize()
        src = [None if a is None else
               torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]
        if not self.cuda or self.pinned_source:
            return src
        buf = self._slots.get(slot)
        if buf is None or not all(map(_fits, src, buf)):
            buf = self._slots[slot] = [None if a is None else torch.empty(
                (max(self.rows or 0, a.shape[0]),) + tuple(a.shape[1:]),
                dtype=a.dtype, pin_memory=True) for a in src]
        return [None if a is None else b[:a.shape[0]].copy_(a)
                for a, b in zip(src, buf)]

    # ------------------------------------------------ consumer side
    def place(self, staged, slot: int, rows: int | None = None):
        """The chunk on the device; ``rows`` overrides the placer's row
        count for this chunk (a serving bucket)."""
        if not self.cuda:
            return self._assemble(*staged, non_blocking=False, rows=rows)
        cur = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            arrs = self._assemble(*staged, non_blocking=True, rows=rows)
        self.retire(slot, self.stream)
        cur.wait_event(self._free[slot])
        for a in arrs:
            if a is not None:
                a.record_stream(cur)
        return arrs

    def retire(self, slot: int, stream=None) -> None:
        """Record on ``stream`` (the current stream by default) the event
        after which slot ``slot`` may be staged into again."""
        if not self.cuda:
            return
        ev = torch.cuda.Event()
        ev.record(stream or torch.cuda.current_stream(self.device))
        self._free[slot] = ev

    def _assemble(self, X, target, mask, *, non_blocking, rows=None):
        n, D = X.shape
        R, K, dev = rows or self.rows or n, self.width or D, self.device
        if n > R or D > K:
            raise ValueError(f"a chunk of {tuple(X.shape)} does not fit the "
                             f"({R}, {K}) chunk shape")
        f32 = dict(dtype=torch.float32, device=dev)
        nb = non_blocking
        if n == R and D == K and mask is not None:
            return tuple(None if a is None else
                         torch.empty(a.shape, dtype=a.dtype, device=dev)
                         .copy_(a, non_blocking=nb) for a in (X, target,
                                                               mask))
        Xd = torch.empty((R, K), **f32)
        if D == K:
            Xd[:n].copy_(X, non_blocking=nb)
        else:
            Xd[:n, :D].copy_(X, non_blocking=nb)
            Xd[:n, D:].zero_()
        td = None
        if target is not None:
            td = torch.empty((R,), dtype=target.dtype, device=dev)
            td[:n].copy_(target, non_blocking=nb)
        md = torch.empty((R,), **f32)
        if mask is None:
            md[:n].fill_(1.0)
        else:
            md[:n].copy_(mask, non_blocking=nb)
        if self.bias_col is not None:
            Xd[:n, self.bias_col].fill_(1.0)
        if n < R:
            Xd[n:].zero_()
            if td is not None:
                td[n:].zero_()
            md[n:].zero_()
        return Xd, td, md


def _fits(a, b) -> bool:
    """Whether staging slot b can hold host tensor a."""
    if a is None or b is None:
        return a is b
    return (a.dtype == b.dtype and a.shape[1:] == b.shape[1:]
            and a.shape[0] <= b.shape[0])


def rows_to_device(X: np.ndarray, out: torch.Tensor,
                   block_bytes: int = 32 << 20) -> None:
    """Copy host rows X (n, D) into ``out[:n, :D]``. On the card the rows go
    in blocks of about ``block_bytes`` through two of a ``DevicePlacer``'s
    pinned staging slots, each copy ``non_blocking`` on its side stream,
    overlapping the host memcpy of one block with the transfer of the
    other; the current stream then waits for the copies (no host
    synchronize). The rest of ``out`` is left as it is."""
    n, D = X.shape
    if n == 0:
        return
    if out.device.type != "cuda":
        out[:n, :D].copy_(torch.from_numpy(X))
        return
    block = max(1, block_bytes // max(1, D * X.itemsize))
    placer = DevicePlacer(out.device, min(block, n))
    cur = torch.cuda.current_stream(out.device)
    placer.stream.wait_stream(cur)
    for j, r0 in enumerate(range(0, n, block)):
        (src,) = placer.stage((X[r0:r0 + block],), j % 2)
        with torch.cuda.stream(placer.stream):
            out[r0:r0 + src.shape[0], :D].copy_(src, non_blocking=True)
        placer.retire(j % 2, placer.stream)
    cur.wait_stream(placer.stream)


class ShardedBatcher:
    """Iterates (tokens, targets) batches from a token stream (the
    reference's ``ShardedBatcher``).

    Targets are next-token shifted. The windows of ``seq_len + 1`` tokens
    are visited in ``np.random.default_rng(seed).permutation`` order, so
    every batch is the reference's integer for integer. State is the step
    counter; ``seek`` restores the position after a restart, also in the
    middle of an iteration: the prefetch worker tags every queued batch
    with a generation counter, ``seek`` bumps it, and batches prefetched
    before it are dropped (the worker restarts from the new step). The
    worker builds each batch as int32 host arrays, page-locked when the
    device is a card; the consumer copies them to ``device`` (a
    non-blocking copy on the current stream). On a ``mesh`` (a
    ``DeviceMesh`` with named axes) each rank yields its block of the
    batch's rows over ``batch_axes`` (the batch must divide over them, as
    the reference's placement must), the rest of the host batch dropped
    before the copy; ``device`` then defaults to the mesh's device type
    (the current card)."""

    def __init__(self, stream: np.ndarray, batch: int, seq_len: int,
                 mesh=None, batch_axes=("data",), prefetch: int = 2,
                 seed: int = 0, device=None):
        self.stream = stream
        self.batch, self.seq_len = batch, seq_len
        self.mesh, self.batch_axes = mesh, tuple(batch_axes)
        self._rows = slice(0, batch)
        if mesh is not None:
            from repro_torch.core.distributed import check_mesh
            from repro_torch.sharding.layout import index
            check_mesh(mesh)
            i, n = index(mesh, self.batch_axes)
            if batch % n:
                raise ValueError(f"a batch of {batch} does not divide over "
                                 f"{self.batch_axes} ({n} shards)")
            self._rows = slice(i * (batch // n), (i + 1) * (batch // n))
            if device is None:
                device = mesh.device_type
        self.prefetch = prefetch
        self.device = torch.device("cpu" if device is None else device)
        self.step = 0
        self._gen = 0
        n_windows = (len(stream) - 1) // seq_len
        self.n_windows = n_windows
        self.rng = np.random.default_rng(seed)
        self._order = self.rng.permutation(n_windows)

    def seek(self, step: int) -> None:
        # Order matters: the worker re-reads ``step`` only after it
        # observes the generation bump.
        self.step = step
        self._gen += 1

    def _host_batch(self, step: int):
        idx = [self._order[(step * self.batch + i) % self.n_windows]
               for i in range(self.batch)]
        toks = np.stack([self.stream[j * self.seq_len:
                                     j * self.seq_len + self.seq_len + 1]
                         for j in idx])
        return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)

    def _stage(self, arrs):
        out = tuple(torch.from_numpy(np.ascontiguousarray(a[self._rows]))
                    for a in arrs)
        if self.device.type == "cuda":
            out = tuple(t.pin_memory() for t in out)
        return out

    def _place(self, staged):
        return tuple(t.to(self.device, non_blocking=True) for t in staged)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            gen = -1
            s = 0
            while not stop.is_set():
                if gen != self._gen:
                    gen = self._gen
                    s = self.step
                item = (gen, s, self._stage(self._host_batch(s)))
                placed = False
                while not stop.is_set() and gen == self._gen:
                    try:
                        q.put(item, timeout=0.2)
                        placed = True
                        break
                    except queue.Full:
                        continue
                if placed:
                    s += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                gen, s, arrs = q.get()
                if gen != self._gen:
                    continue  # stale: prefetched before the last seek()
                self.step = s + 1
                yield self._place(arrs)
        finally:
            stop.set()
            t.join(timeout=1.0)
