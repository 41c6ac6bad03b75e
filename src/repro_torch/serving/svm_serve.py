"""SVM serving: port of ``repro/serving/svm_serve.py``.

A fitted model exports a frozen :class:`ServableModel`; an
:class:`SVMScorer` holds its arrays on the device and scores requests
through a bucketed score cell; :class:`WeightPager` pages many tenant
models over the shared cells (LRU); :class:`ServeLoop` decouples request
intake from device work (coalesce, bucket-pad, one dispatch, split).

Bucket invariance. A request's scores must not depend on the bucket it
rides or on its row offset in that bucket. cuBLAS picks its algorithm
(and split-K) by shape, and the CPU matmul is not stable across row
counts either, so the linear cell multiplies fixed (tile, Kfit) row tiles
of the bucket, one product a tile: every bucket runs the same per-tile
computation. The Nystrom cell on the card launches the hand-written
``nystrom_score`` once a bucket: each phi entry is one fmaf chain over the
landmarks and each row's score sums its column blocks in block order, so
a row's bits depend on neither the row count nor the row's position (the
card tests hold this at every bucket of the ladder and several offsets).
Its plain version (the CPU, or ``backend="ref"``) builds phi with a
matmul and so runs a tile at a time, as the linear cell does.

A request bucket reaches the device as the stream driver's chunks do:
host rows staged into one of two page-locked slots of a ``DevicePlacer``,
copied on its side stream, the bias column (= mask) and the zero padding
rows and columns written on the device. One device-to-host copy a
dispatch brings the scores back.

The Nystrom cell never writes an (N, M) phi: ``nystrom_score`` keeps the
phi tile in registers and multiplies it by W there. What it does write is
the cross-Gram chunk, an (m, R) scratch (``kernels/nystrom_phi.py``,
stage A): the port's designed route. With U = L^{-T} from the Cholesky
factor of the posterior precision P = lam I + S appended as extra weight
columns, std(margin) = ||phi U|| row-wise comes out of the same dispatch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch.data.pipeline import DevicePlacer
from repro_torch.kernels import nystrom_phi as _nystrom_phi
from repro_torch.kernels import ops

DEFAULT_TILE = 128

# One score cell per static configuration, shared by every tenant model
# with that configuration: weights are operands, not part of the cell.
# BUILD_COUNTS is the counterpart of the reference's trace count: a cell
# builds its plan (the bucket's fixed-shape row tiles) once for each new
# bucket, where jax traces once a shape; a call at a seen bucket builds
# nothing.
_CELL_CACHE: dict[tuple, "_Cell"] = {}
BUILD_COUNTS: dict[tuple, int] = {}


class _Cell:
    """A score cell: ``cell(bucket, X, mask, W, lm, pj) -> (B, C)`` on the
    bucket's prepared rows X (linear: (B, Kfit) with the bias column and
    the padding already written; Nystrom: (B, D) raw rows) and mask
    (B,)."""

    def __init__(self, key: tuple):
        self.key = key
        self.tile = key[-1] if key[0] == "linear" else key[4]
        self._plans: dict[int, list] = {}
        BUILD_COUNTS.setdefault(key, 0)

    def tiles(self, bucket: int) -> list:
        """The bucket's fixed-shape row tiles, built once a bucket."""
        plan = self._plans.get(bucket)
        if plan is None:
            assert bucket % self.tile == 0, (bucket, self.tile)
            plan = self._plans[bucket] = [
                slice(i, i + self.tile) for i in range(0, bucket, self.tile)]
            BUILD_COUNTS[self.key] += 1
        return plan


class _LinearCell(_Cell):
    """key ("linear", add_bias, tile): (X @ W) * mask, a (tile, Kfit) @
    (Kfit, C) product a tile. The reference's LIN cell is plain XLA; this
    one is a torch matmul at the same fixed shape."""

    def __call__(self, bucket, X, mask, W, lm=None, pj=None):
        out = torch.empty((X.shape[0], W.shape[1]), dtype=torch.float32,
                          device=X.device)
        for rows in self.tiles(bucket):
            torch.mm(X[rows], W, out=out[rows])
        return out.mul_(mask[:, None])


class _NystromCell(_Cell):
    """key ("nystrom", kind, sigma, phi_add_bias, tile, backend):
    ``ops.nystrom_score``, once a bucket on the card, a tile at a time
    where the plain version runs."""

    def __call__(self, bucket, X, mask, W, lm, pj):
        _, kind, sigma, add_bias, _, backend = self.key
        kw = dict(sigma=sigma, kind=kind, add_bias=add_bias, backend=backend)
        tiles = self.tiles(bucket)
        if ops._resolve(backend, X) == "cuda":
            return ops.nystrom_score(X, lm, pj, W, mask, **kw)
        return torch.cat([ops.nystrom_score(X[r], lm, pj, W, mask[r], **kw)
                          for r in tiles])


def _get_cell(key: tuple) -> _Cell:
    """The shared score cell of a static configuration key."""
    cell = _CELL_CACHE.get(key)
    if cell is None:
        cls = _LinearCell if key[0] == "linear" else _NystromCell
        cell = _CELL_CACHE[key] = cls(key)
    return cell


@dataclasses.dataclass(frozen=True, eq=False)
class ServableModel:
    """Frozen host-side export of a fitted SVM: everything serving needs.

    ``weights`` is (Kfit, C) float32: columns [0, n_outputs) are margin
    directions (1, or num_classes for MLT); any further columns are the
    posterior uncertainty directions U = L^{-T} (or the multichain
    ensemble's), so std(margin) = ||phi @ U|| row-wise. ``landmarks`` /
    ``proj`` present selects the Nystrom score cell (this carries the
    exact KRN model too: landmarks = the training rows, proj =
    omega[:, None], weights = [[1.]]); absent selects the linear cell,
    which appends the bias column and pads to Kfit on the device."""
    task: str                       # "cls" | "svr" | "mlt"
    weights: np.ndarray             # (Kfit, C) f32, margin cols first
    n_outputs: int                  # margin columns (1 or num_classes)
    n_features: int                 # raw request width D
    add_bias: bool = False          # linear-cell bias column
    landmarks: np.ndarray | None = None
    proj: np.ndarray | None = None
    phi_kind: str = "rbf"
    phi_sigma: float = 1.0
    phi_add_bias: bool = False
    backend: str | None = None
    name: str = "svm"

    def __post_init__(self):
        object.__setattr__(
            self, "weights", np.asarray(self.weights, np.float32))
        assert self.weights.ndim == 2 and \
            self.n_outputs <= self.weights.shape[1]
        if self.landmarks is not None:
            object.__setattr__(
                self, "landmarks", np.asarray(self.landmarks, np.float32))
            object.__setattr__(
                self, "proj", np.asarray(self.proj, np.float32))

    @property
    def family(self) -> str:
        return "linear" if self.landmarks is None else "nystrom"

    @property
    def has_uncertainty(self) -> bool:
        return self.weights.shape[1] > self.n_outputs

    @property
    def nbytes(self) -> int:
        n = self.weights.nbytes
        if self.landmarks is not None:
            n += self.landmarks.nbytes + self.proj.nbytes
        return n


def _device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "SVMScorer runs on the GPU by default and no CUDA device is "
            "visible; pass device='cpu' to score with the plain PyTorch "
            "path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


class SVMScorer:
    """Device-resident scorer for one :class:`ServableModel`, on
    ``cuda:0`` unless ``device`` says otherwise.

    The arrays go to the device once, at construction; every ``score``
    pads its rows to a bucket of the ladder tile, 2 tile, ..., max_bucket
    (larger batches go in chunks of max_bucket), dispatches the shared
    cell and brings the real rows back. Padding rows have mask 0 and
    never change a score. Every dispatch of a scorer runs on the stream
    that was current where it was built (a drain thread has its own
    current stream), one dispatch at a time."""

    def __init__(self, model: ServableModel, *, tile: int = DEFAULT_TILE,
                 max_bucket: int = 1024, device=None):
        assert max_bucket % tile == 0
        self.model = model
        self.tile = tile
        self.max_bucket = max_bucket
        self.device = dev = _device(device)
        self._W = _tensor(model.weights, dev)
        D = model.n_features
        if model.family == "nystrom":
            self._lm = _tensor(model.landmarks, dev)
            self._pj = _tensor(model.proj, dev)
            self.cell_key = ("nystrom", model.phi_kind,
                             float(model.phi_sigma), model.phi_add_bias,
                             tile, model.backend)
            width, bias_col = D, None
        else:
            self._lm = self._pj = None
            self.cell_key = ("linear", model.add_bias, tile)
            width = self._W.shape[0]
            bias_col = D if model.add_bias else None
        self._cell = _get_cell(self.cell_key)
        self._stream = (torch.cuda.current_stream(dev)
                        if dev.type == "cuda" else None)
        self._placer = DevicePlacer(dev, max_bucket, width, bias_col)
        self._slot = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------ buckets
    def bucket_for(self, n: int) -> int:
        b = self.tile
        while b < n and b < self.max_bucket:
            b *= 2
        return b

    @property
    def traces(self) -> int:
        """Bucket plans built by this scorer's (shared) cell: the
        counterpart of the reference's compilation count."""
        return BUILD_COUNTS.get(self.cell_key, 0)

    # ------------------------------------------------------------ scoring
    def _check_width(self) -> None:
        m = self.model
        if m.family == "linear":
            Kfit = self._W.shape[0]
            if m.n_features + int(m.add_bias) > Kfit:
                raise ValueError(
                    f"request feature width {m.n_features} (+bias="
                    f"{m.add_bias}) exceeds the model's fitted width {Kfit}")

    def _run(self, X: torch.Tensor, mask: torch.Tensor, bucket: int):
        return self._cell(bucket, X, mask, self._W, self._lm, self._pj)

    def _dispatch(self, X: np.ndarray, bucket: int) -> np.ndarray:
        """One bucket: stage the rows in a pinned slot, place them on the
        device (bias column, padding, mask), run the cell, and copy the
        real rows' scores back (the dispatch's one device-to-host copy)."""
        with self._lock, _on(self._stream):
            slot, self._slot = self._slot, self._slot ^ 1
            staged = self._placer.stage((X, None, None), slot)
            Xb, _, mb = self._placer.place(staged, slot, rows=bucket)
            out = self._run(Xb, mb, bucket)
            self._placer.retire(slot)
            return out[:X.shape[0]].cpu().numpy()

    def score(self, X: np.ndarray) -> np.ndarray:
        """(n, C) float32 score columns for (n, D) raw request rows."""
        X = np.asarray(X, np.float32)
        if X.ndim != 2 or X.shape[1] != self.model.n_features:
            raise ValueError(
                f"model {self.model.name!r} expects (n, "
                f"{self.model.n_features}) requests, got {X.shape}")
        self._check_width()
        n = X.shape[0]
        if n == 0:
            return np.zeros((0, self._W.shape[1]), np.float32)
        outs, i = [], 0
        while i < n:
            take = min(n - i, self.max_bucket)
            outs.append(self._dispatch(X[i:i + take], self.bucket_for(take)))
            i += take
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def margins(self, X: np.ndarray) -> np.ndarray:
        out = self.score(X)[:, : self.model.n_outputs]
        return out[:, 0] if self.model.n_outputs == 1 else out

    def score_with_std(self, X: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray]:
        """(margin, std): the uncertainty columns U ride the same weight
        block, so margin and std come out of one dispatch:
        std_i = ||phi_i @ U|| = sqrt(phi_i^T P^{-1} phi_i)."""
        assert self.model.has_uncertainty, (
            "model exported without posterior; use "
            "export_servable(posterior_from=(X, y))")
        out = self.score(X)
        k = self.model.n_outputs
        margin = out[:, 0] if k == 1 else out[:, :k]
        std = np.sqrt(np.sum(out[:, k:].astype(np.float64) ** 2, axis=1))
        return margin, std.astype(np.float32)

    def predict(self, X: np.ndarray) -> np.ndarray:
        m = self.margins(X)
        if self.model.task == "mlt":
            return np.argmax(m, axis=1)
        if self.model.task == "svr":
            return m
        return np.where(m >= 0, 1, -1)


def _on(stream):
    """``torch.cuda.stream(stream)``, or nothing on the CPU (None)."""
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


def _allocated(nbytes: int) -> int:
    """Bytes the caching allocator books for a request (512-byte
    granules)."""
    return -(-max(nbytes, 1) // 512) * 512


def phi_never_materialized(scorer: SVMScorer, bucket: int) -> bool:
    """Whether a score call at ``bucket`` rows writes no (bucket, M) phi
    (or (bucket, P), (bucket, m) cross-Gram) buffer: the serving path's
    residency gate. There is no jaxpr to walk, so on the card it reads the
    wrapper's scratch shapes (``nystrom_phi.score_scratch``: none but the
    (bucket, C) scores may be such a buffer; the cross-Gram chunk is
    landmark-major, (m, R)) and the call's peak allocated bytes (no more
    than that scratch and the scores). Needs bucket > tile. The plain
    version builds phi, so on the CPU (or with ``backend="ref"``) the
    answer for the Nystrom family is False."""
    m = scorer.model
    if m.family == "linear":
        return True
    assert bucket > scorer.tile and bucket % scorer.tile == 0
    X = torch.zeros((bucket, m.n_features), dtype=torch.float32,
                    device=scorer.device)
    if ops._resolve(m.backend, X) != "cuda":
        return False
    P = m.proj.shape[1]
    lm_rows, D = m.landmarks.shape
    phi_widths = {P, P + int(m.phi_add_bias), lm_rows}
    scratch = _nystrom_phi.score_scratch(
        bucket, D, lm_rows, P, m.weights.shape[1], m.phi_add_bias,
        m.phi_kind)
    # every buffer but the scores themselves ("out", (bucket, C))
    if any(len(s) == 2 and s[0] == bucket and s[1] in phi_widths
           for name, s in scratch.items() if name != "out"):
        return False
    mask = torch.ones((bucket,), dtype=torch.float32, device=scorer.device)
    dev = scorer.device
    with scorer._lock, _on(scorer._stream):
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        scorer._run(X, mask, bucket)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
    allowed = sum(_allocated(4 * int(np.prod(s))) for s in scratch.values())
    return peak <= allowed


class WeightPager:
    """LRU device residency for many tenant models over the shared cells:
    ``register`` keeps the host-side ServableModel (dropping a resident
    scorer with stale weights); ``scorer`` pages its arrays onto the
    device (an SVMScorer) and evicts the least recently used tenant past
    ``max_resident``. Cells are shared by configuration, so paging a
    tenant in is a weight upload."""

    def __init__(self, max_resident: int = 8, *,
                 tile: int = DEFAULT_TILE, max_bucket: int = 1024,
                 device=None):
        assert max_resident >= 1
        self.max_resident = max_resident
        self.tile = tile
        self.max_bucket = max_bucket
        self.device = device
        self._models: dict[str, ServableModel] = {}
        self._resident: OrderedDict[str, SVMScorer] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def register(self, model: ServableModel) -> None:
        self._models[model.name] = model
        self._resident.pop(model.name, None)  # stale weights out

    @property
    def model_names(self) -> list[str]:
        return list(self._models)

    @property
    def resident_names(self) -> list[str]:
        return list(self._resident)

    @property
    def resident_bytes(self) -> int:
        return sum(s.model.nbytes for s in self._resident.values())

    def scorer(self, name: str) -> SVMScorer:
        if name in self._resident:
            self.hits += 1
            self._resident.move_to_end(name)
            return self._resident[name]
        if name not in self._models:
            raise KeyError(f"unknown model {name!r}; register() first")
        self.misses += 1
        s = SVMScorer(self._models[name], tile=self.tile,
                      max_bucket=self.max_bucket, device=self.device)
        self._resident[name] = s
        while len(self._resident) > self.max_resident:
            self._resident.popitem(last=False)
            self.evictions += 1
        return s


class DeadlineExceeded(RuntimeError):
    """A request's deadline passed before it was scored; its Future fails
    with this instead of waiting forever."""


class ServeRejected(RuntimeError):
    """Backpressure: the intake queue is at capacity, so the request was
    shed at submit time, an immediate rejection the client can retry
    elsewhere."""


@dataclasses.dataclass
class _Request:
    model: str
    X: np.ndarray
    future: Future
    t_submit: float
    deadline_s: float | None = None   # absolute perf_counter() time


class ServeLoop:
    """Continuous-batching request loop: ``submit`` enqueues (model, rows)
    and returns a Future; a drain, threaded (``start``) or synchronous
    (``step``), coalesces the queued requests per model, scores each
    model's rows as one bucketed dispatch through the
    :class:`WeightPager`, and splits the rows back to the Futures. A
    request's bits do not depend on what it was coalesced with (module
    docstring).

    With ``max_queue`` the intake is bounded: a submit against a full
    queue returns a Future already failed with :class:`ServeRejected`
    (``n_rejected``). A request whose deadline (``deadline_ms``, or
    ``default_deadline_ms``) has passed when the drain picks it up fails
    with :class:`DeadlineExceeded` (``n_expired``) and takes no batch
    rows; expiry is checked at drain time, so ``step()`` is
    deterministic."""

    def __init__(self, pager: WeightPager, *, max_batch: int = 1024,
                 max_wait_ms: float = 2.0, max_queue: int | None = None,
                 default_deadline_ms: float | None = None):
        assert max_queue is None or max_queue >= 1, max_queue
        self.pager = pager
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.default_deadline_ms = default_deadline_ms
        self._q: queue.Queue[_Request] = queue.Queue(
            maxsize=max_queue or 0)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Client threads (submit) and the drain thread update the
        # counters; every read-modify-write holds this lock.
        self._stats_lock = threading.Lock()
        self.latencies_ms: list[float] = []
        self.n_requests = 0
        self.n_rows = 0
        self.n_batches = 0
        self.n_rejected = 0
        self.n_expired = 0

    # ------------------------------------------------------------- intake
    def submit(self, model: str, X: np.ndarray, *,
               deadline_ms: float | None = None) -> Future:
        X = np.asarray(X, np.float32)
        assert X.ndim == 2 and X.shape[0] >= 1
        fut: Future = Future()
        now = time.perf_counter()
        ms = deadline_ms if deadline_ms is not None \
            else self.default_deadline_ms
        deadline = now + ms / 1e3 if ms is not None else None
        try:
            self._q.put_nowait(_Request(model, X, fut, now, deadline))
        except queue.Full:
            with self._stats_lock:
                self.n_rejected += 1
            fut.set_exception(ServeRejected(
                f"intake queue at capacity ({self._q.maxsize} requests); "
                "request shed: retry against another replica or back "
                "off"))
        return fut

    # -------------------------------------------------------------- drain
    def _drain_queue(self, block: bool) -> list[_Request]:
        reqs: list[_Request] = []
        rows = 0
        timeout = self.max_wait_ms / 1e3
        while rows < self.max_batch:
            try:
                r = self._q.get(block=block and not reqs,
                                timeout=timeout if block else None)
            except queue.Empty:
                break
            reqs.append(r)
            rows += r.X.shape[0]
        return reqs

    def _serve(self, reqs: list[_Request]) -> None:
        # Deadlines first: an expired request takes no batch rows.
        now = time.perf_counter()
        live: list[_Request] = []
        for r in reqs:
            if r.deadline_s is not None and now > r.deadline_s:
                with self._stats_lock:
                    self.n_expired += 1
                r.future.set_exception(DeadlineExceeded(
                    f"request for {r.model!r} expired after "
                    f"{(now - r.t_submit) * 1e3:.1f} ms in queue "
                    f"(deadline {(r.deadline_s - r.t_submit) * 1e3:.1f} "
                    "ms)"))
            else:
                live.append(r)
        by_model: dict[str, list[_Request]] = {}
        for r in live:
            by_model.setdefault(r.model, []).append(r)
        for name, group in by_model.items():
            try:
                scorer = self.pager.scorer(name)
                X = (group[0].X if len(group) == 1
                     else np.concatenate([r.X for r in group]))
                scores = scorer.score(X)
            except Exception as e:  # noqa: BLE001 -- fail the futures
                for r in group:
                    r.future.set_exception(e)
                continue
            done = time.perf_counter()
            i = 0
            for r in group:
                n = r.X.shape[0]
                r.future.set_result(scores[i:i + n])
                i += n
            with self._stats_lock:
                self.n_batches += 1
                self.n_requests += len(group)
                self.n_rows += i
                self.latencies_ms.extend(
                    (done - r.t_submit) * 1e3 for r in group)

    def step(self) -> int:
        """Synchronous drain: serve everything queued now. Returns the
        number of requests drained."""
        reqs = self._drain_queue(block=False)
        if reqs:
            self._serve(reqs)
        return len(reqs)

    # ------------------------------------------------------------ threaded
    def _run(self) -> None:
        while not self._stop.is_set():
            reqs = self._drain_queue(block=True)
            if reqs:
                self._serve(reqs)
        self.step()  # final flush

    def start(self) -> "ServeLoop":
        assert self._thread is None, "already started"
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="svm-serve-loop")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------- stats
    def latency_quantiles(self) -> dict:
        with self._stats_lock:
            counts = {"rejected": self.n_rejected,
                      "expired": self.n_expired}
            lat = np.asarray(self.latencies_ms)
        if lat.size == 0:
            return {"p50_ms": None, "p99_ms": None, **counts}
        q = np.quantile(lat, [0.5, 0.99])
        return {"p50_ms": float(q[0]), "p99_ms": float(q[1]), **counts}
