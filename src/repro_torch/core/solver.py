"""PEMSVM driver: port of ``repro/core/solver.py`` for the paper's option
strings LIN-{EM,MC}-{CLS,MLT,SVR} and the exact-Gram KRN-{EM,MC}-CLS, with
the ``scan`` (default), ``loop`` and ``stream`` drivers, in X-space or
(``phi_spec``, the delegate of ``NystromSVM``) in Nystrom phi-space, on
one device or on a device mesh.

The run protocol is the paper's: the objective is evaluated every
iteration and the fit stops when its change falls to tol*N (Sec 5.5);
gamma is clamped for support vectors (Sec 5.7.3); the bias is a fixed unit
feature (Sec 2.1). MC fits walk the reference's key chain
(``prng.PRNGKey(seed)``, one ``split`` an iteration), average the samples
after ``burnin`` into the posterior mean, and with ``n_chains > 1`` run C
chains over one X stream. MLT (Crammer-Singer, Sec 3.3) carries an (M, K)
state and sweeps the classes (``core/multiclass.py``); the exact KRN
solver (Sec 3.1) fits the dual weights on the padded Gram matrix of the
training rows, which it keeps for prediction (``core/kernel.py``).

The stream driver (``driver="stream"``; ``fit``, ``fit_chunks``,
``fit_libsvm``) is the paper's Fig. 1 iteration as a map-reduce over row
chunks (Sec 5.6): Sigma and the mu-numerator are exact sums over rows, so
the data set passes through the device ``chunk_rows`` rows at a time,
copied from page-locked host memory on a side stream
(``data.pipeline``), and only (prefetch + 2) chunks are resident at once.
The resident drivers' set-up builds the padded, biased statistic matrix
on the device from the same page-locked copy path.

``PEMSVM(config)`` runs on ``cuda:0`` and its statistic goes through the
hand-written kernels (``kernels/ops.py``); ``device="cpu"`` runs the plain
PyTorch path. With ``mesh`` (a ``torch.distributed`` DeviceMesh with
``mesh_dim_names``) every rank fits its row block of the data axes and
the statistics are summed over them, the paper's Fig. 1; a
``config.k_shard_axis`` splits Sigma's columns over that axis (the 2-D
statistic; the exact KRN fit shards the Gram's rows over the data axes).
``fit(warm_start=result)`` starts a new fit from a finished one's last
sample; on the stream driver ``config.decay`` folds the donor's
statistics in at weight decay, or ``config.window`` a hard-expiry ring of
the last generations' fresh statistics (``stats.StatsWindow``).

A fitted model exports a frozen ``serving.ServableModel``
(``export_servable``, with posterior or multichain uncertainty columns)
and serves through a device-resident ``serving.SVMScorer`` built once a
fit (``scorer``); ``decision_function`` and ``predict`` go through it.

Reliability (``config.fault``, a ``runtime.FaultPolicy``; the fit
keywords ``resume_from``, ``resume_step``, ``fault_hook`` and ``epoch``):
every driver commits snapshots through ``checkpoint.Checkpointer``
(``core/resume.py``; the stream driver also inside a pass), resumes one
bit for bit, calls the fault hook once a host sync and feeds the
straggler monitor, as the reference's ``_FitRuntime`` does
(``_FitRuntime`` here). The snapshots are the reference's files, so
either package resumes the other's.

``SVMConfig`` carries every field of the reference, so a reference config
converts field for field (``core/convert.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.data.libsvm import iter_libsvm, load_libsvm
from repro_torch.data.pipeline import (ChunkPrefetcher, DevicePlacer,
                                       PageLock, RetryStats, pad_features_to,
                                       padded_width, retrying_chunks,
                                       rows_to_device)
from repro_torch.kernels import ops
from repro_torch.runtime.elastic import remesh
from repro_torch.runtime.policy import FaultPolicy, StragglerError
from repro_torch.runtime.straggler import StepTimeMonitor
from . import (distributed, kernel, linear, multiclass, objective, prng,
               resume as resume_mod, stats, svr)
from .linear import SVMData

FORMULATIONS = ("LIN", "KRN")
ALGORITHMS = ("EM", "MC")
TASKS = ("CLS", "MLT", "SVR")


def lam_from_C(C: float) -> float:
    """Paper Eq. 1: min 1/2 lam ||w||^2 + 2 sum xi  <=>  C = 2/lam."""
    return 2.0 / C


@dataclasses.dataclass(frozen=True)
class SVMConfig:
    formulation: str = "LIN"
    algorithm: str = "EM"
    task: str = "CLS"
    lam: float = 1.0
    eps: float = 1e-6            # gamma clamp (paper Sec 5.7.3)
    eps_ins: float = 1e-3        # SVR precision (paper Sec 3.2 footnote)
    num_classes: int = 2
    kernel: str = "rbf"
    sigma: float = 1.0
    max_iters: int = 200
    min_iters: int = 10          # guard against flat-start plateaus
    patience: int = 1            # consecutive small-change iters required
    tol: float = 1e-3            # stop at |delta obj| <= tol * N (Sec 5.5)
    driver: str = "scan"         # scan = chunked on-device driver
    scan_chunk: int = 16         # device iterations per host sync
    chunk_rows: int = 4096       # stream driver: rows device-resident at once
    prefetch: int = 2            # stream driver: host->device lookahead depth
    burnin: int = 10             # MC burn-in (Sec 5.13)
    jitter: float | None = None  # None -> 1e-7 (LIN), 1e-4 (KRN fp32 Gram)
    triangle_reduce: bool = True
    reduce_dtype: str | None = None  # 'bfloat16' = compressed reduction
    backend: str | None = None   # kernels backend: None (by device) | ref | cuda
    add_bias: bool = True
    seed: int = 0
    k_shard_axis: str | None = None  # beyond-paper 2-D Sigma statistic
    pad_features: int | None = None  # zero-pad LIN width to a multiple
    phi_spec: Any = None         # Nystrom phi-space mode (NystromSVM)
    fault: Any = None            # checkpoint/retry/straggler policy
    decay: float = 0.0           # warm-start statistic decay (stream only)
    window: int = 0              # hard-expiry statistics horizon (stream)
    rng: str = "host"            # MC noise source: host | fused |
                                 # fused_predraw
    n_chains: int = 1            # parallel Gibbs chains over one X stream
    chain0: int = 0              # first chain id (counter plane offset)

    def __post_init__(self):
        assert self.formulation in FORMULATIONS, self.formulation
        assert self.algorithm in ALGORITHMS, self.algorithm
        assert self.task in TASKS, self.task
        assert self.driver in ("scan", "loop", "stream"), self.driver
        assert self.scan_chunk >= 1, self.scan_chunk
        assert self.rng in ("host", "fused", "fused_predraw"), self.rng
        assert self.n_chains >= 1, self.n_chains
        assert self.chain0 >= 0, self.chain0
        if self.rng != "host":
            assert self.algorithm == "MC", (
                f"rng={self.rng!r} selects the MC noise source; "
                "algorithm='EM' draws no noise")
        if self.n_chains > 1:
            assert self.rng == "fused", (
                "n_chains > 1 requires rng='fused' (the per-chain noise "
                "is derived in-kernel from the chain counter plane)")
            assert self.task in ("CLS", "SVR"), (
                "n_chains > 1 covers CLS/SVR; MLT's class sweep is one "
                "chain (run separate fits with distinct chain0 instead)")
            assert self.phi_spec is None, (
                "n_chains > 1 is the LIN X-space multichain kernel; "
                "the Nystrom phi route is single-chain")
            assert self.k_shard_axis is None, (
                "n_chains > 1 does not compose with the 2-D column-"
                "windowed statistic; drop k_shard_axis")
        assert self.pad_features is None or (
            self.pad_features >= 1 and self.phi_spec is None
            and self.formulation == "LIN"), self.pad_features
        assert self.chunk_rows >= 1, self.chunk_rows
        assert self.prefetch >= 1, self.prefetch
        assert 0.0 <= self.decay < 1.0, self.decay
        assert self.decay == 0.0 or self.driver == "stream", (
            "decay (online warm-start statistics) requires "
            "driver='stream'")
        assert self.window >= 0, self.window
        assert self.window == 0 or self.driver == "stream", (
            "window (hard-expiry warm-start statistics) requires "
            "driver='stream'")
        assert self.window == 0 or self.decay == 0.0, (
            "window and decay are competing warm-start semantics "
            "(hard expiry vs geometric); pick one")
        if self.phi_spec is not None:
            assert self.formulation == "LIN", (
                "phi_spec is the LIN-delegate mode NystromSVM builds; "
                "construct a KRN config and wrap it in NystromSVM")
            assert not self.add_bias, (
                "phi_spec carries its own phi-space bias column; "
                "X-space add_bias must be False")
        if self.jitter is None:
            object.__setattr__(
                self, "jitter",
                1e-4 if self.formulation == "KRN" else 1e-7)

    @classmethod
    def from_options(cls, options: str, **kw) -> "SVMConfig":
        f, a, t = options.upper().split("-")
        return cls(formulation=f, algorithm=a, task=t, **kw)

    @property
    def options(self) -> str:
        return f"{self.formulation}-{self.algorithm}-{self.task}"


@dataclasses.dataclass
class FitResult:
    weights: np.ndarray             # final weights (EM) / posterior mean
    last_sample: np.ndarray         # the last iterate (MC: the last draw)
    objective: list
    aux_history: dict
    n_iters: int
    converged: bool
    n_host_syncs: int = 0           # the fit loop's device->host transfers
    #                                 (a gloo collective on CUDA tensors
    #                                 also passes through the host; those
    #                                 are not counted)
    chain_weights: np.ndarray | None = None  # (C, K) per-chain posterior
    #                                 means (n_chains > 1); ``weights`` is
    #                                 their cross-chain mean
    chain_std: np.ndarray | None = None      # (K,) cross-chain std
    #                                 (ddof=1) of the per-chain means
    peak_input_bytes: int = 0       # stream driver: the most input bytes
    #                                 resident at once, (prefetch + 2)
    #                                 chunks
    loader_retries: int = 0         # stream driver: loader failures
    #                                 absorbed by retrying_chunks
    loader_backoff_s: float = 0.0   # seconds slept backing those off
    stats: dict | None = None       # stream driver with decay > 0 or
    #                                 window >= 1: the effective (S, b) of
    #                                 the last M-step, numpy; feed back
    #                                 through fit(warm_start=result)
    stats_window: list | None = None  # window >= 1: the hard-expiry ring
    #                                 the next generation folds (this
    #                                 fit's fresh (S, b) first), numpy
    straggler_events: list = dataclasses.field(default_factory=list)
    #                                 the straggler monitor's events (and
    #                                 any background checkpoint error)
    resumed_at: int | None = None   # completed iterations restored from a
    #                                 checkpoint (None = a fresh fit)
    n_checkpoints: int = 0          # snapshots committed during this fit


class _FitRuntime:
    """Per-fit state beside the drivers (the reference's ``_FitRuntime``):
    the warm start, the fault policy, the checkpointer and the restored
    resume payload, the straggler monitor, this rank's liveness weight,
    and the host loop's scalar state, owned here (not in loop locals) so
    that the stream driver's mid-pass saver sees a consistent snapshot of
    the counters and histories.

    A warm start (``warm_start``, a donor ``FitResult``) begins at the
    donor's last sample; with ``decay > 0`` the donor's effective
    statistics (``stats``) are folded in, with ``window >= 2`` its ring
    (``stats_window``, cut to window - 1 generations here: the hard
    expiry). ``resume_from`` (a directory or a ``Checkpointer``;
    ``resume_step`` pins a snapshot) instead continues a preempted fit,
    with the donor statistics its snapshot carries (the two keywords are
    exclusive).

    On a mesh every rank holds the same state after each reduction, so
    the mesh's rank 0 alone opens a writer (the reference's single
    writer); every rank restores, after a barrier that makes the last
    fit's final commit visible to all of them, and the ranks agree on each
    straggler verdict. Host numpy; every rank holds the same arrays."""

    def __init__(self, svm: "PEMSVM", *, warm_start=None, live=None,
                 resume_from=None, resume_step: int | None = None,
                 fault_hook: Callable | None = None,
                 epoch: int | None = None):
        cfg = svm.config
        self.svm = svm
        self.policy = cfg.fault or FaultPolicy()
        self.monitor = StepTimeMonitor.from_policy(self.policy)
        self.hook = fault_hook
        self.live = live
        self.events: list = []
        self.n_checkpoints = 0
        self.last_saved_it = 0
        self.resumed_at: int | None = None
        self.midpass: dict | None = None
        self.pending_sub = None
        self.cur_it = 0
        self.retry = RetryStats()
        if resume_from is not None and warm_start is not None:
            raise ValueError(
                "resume_from (continue THIS fit from its checkpoint) and "
                "warm_start (start a NEW fit from a finished model) are "
                "mutually exclusive")
        if resume_step is not None and resume_from is None:
            raise ValueError("resume_step without resume_from")
        mesh = svm.mesh is not None
        self.checkpointing = (self.policy.checkpoints_enabled
                              or resume_from is not None)
        writer = not (self.checkpointing and mesh) or svm._whole().index == 0
        # ``epoch`` is the attempt's fence token: the writer advances the
        # shared FENCE at open and every commit re-checks it.
        self.ckpt = (Checkpointer(self.policy.ckpt_dir,
                                  keep_k=self.policy.keep_k, epoch=epoch)
                     if self.policy.checkpoints_enabled and writer
                     else None)
        self.payload: dict | None = None
        if resume_from is not None:
            if mesh:
                dist.barrier(group=svm._whole().group)
            src = (resume_from if isinstance(resume_from, Checkpointer)
                   else Checkpointer(str(resume_from),
                                     keep_k=self.policy.keep_k,
                                     epoch=(epoch if self.ckpt is None
                                            and writer else None)))
            self.payload = resume_mod.load_snapshot(src, resume_step)
            resume_mod.check_compatible(self.payload, cfg)
            self.resumed_at = int(self.payload["it"])
            if self.ckpt is None and writer:
                # keep committing to the directory resumed from, so a
                # chain of preemptions never loses progress
                self.ckpt = src

        self.warm_state: np.ndarray | None = None
        self.prev_stats: dict | None = None
        self.window_entries: list = []
        if warm_start is not None:
            self.warm_state = np.asarray(warm_start.last_sample, np.float32)
            if cfg.decay > 0.0:
                if warm_start.stats is None:
                    raise ValueError(
                        "decay > 0 folds the previous fit's statistics "
                        "into the new one, but warm_start.stats is None; "
                        "the donor fit must itself run driver='stream' "
                        "with decay > 0 (which fills FitResult.stats)")
                self.prev_stats = {k: np.asarray(v)
                                   for k, v in warm_start.stats.items()}
            if cfg.window >= 2:
                if warm_start.stats_window is None:
                    raise ValueError(
                        "window >= 2 keeps the previous generations' fresh "
                        "statistics, but warm_start.stats_window is None; "
                        "the donor fit must itself run driver='stream' "
                        "with window >= 1 (which fills "
                        "FitResult.stats_window)")
                self.window_entries = [
                    {k: np.asarray(v) for k, v in e.items()}
                    for e in warm_start.stats_window][: cfg.window - 1]
        if self.payload is not None and self.payload.get("prev_stats"):
            self.prev_stats = self.payload["prev_stats"]
        if self.payload is not None and self.payload.get("window_stats"):
            self.window_entries = self.payload["window_stats"]

    # ---------------------------------------------------- host loop state
    def init_loop(self, state0: torch.Tensor) -> torch.Tensor:
        """Restore or initialise the loop state; returns the first state on
        the fit's device. A restored state is placed through
        ``runtime.elastic.remesh``, so a snapshot written on one mesh
        layout resumes on whatever mesh this PEMSVM holds; the restored
        key chain goes to the device for MC (EM fits draw nothing and
        keep no device key: their chain, which a snapshot records as the
        reference does, is walked on the host, ``key_after``)."""
        cfg = self.svm.config
        dev = self.svm.device
        p = self.payload
        sub = None
        if p is not None:
            restored = np.asarray(p["state"], np.float32)
            if restored.shape != tuple(state0.shape):
                raise ValueError(
                    f"checkpoint state has shape {restored.shape}, this "
                    f"fit expects {tuple(state0.shape)}; the same data "
                    "set and featurization are required to resume")
            key = resume_mod.key_tensor(p["key"])
            self.it0 = int(p["it"])
            self.aux_hist = {k: [float(x) for x in v]
                             for k, v in p["aux"].items()}
            self.aux_hist["objective"] = [float(v) for v in p["objs"]]
            self.n_avg = int(p["n_avg"])
            self.n_small = int(p["n_small"])
            # the saved sum itself, until the first new sample: bitwise
            # the uninterrupted fit's mean * n_avg
            self.samp = np.array(p["samp_sum"], np.float64)
            self.mean_w = self.samp / self.n_avg if self.n_avg > 0 else None
            state = remesh(restored, dev)
            if p["in_pass"]:
                sub = resume_mod.key_tensor(p["sub"])
                self.midpass = {
                    "totals": remesh(p["totals"], dev),
                    "skip": int(p["chunk_idx"]),
                    "row0": int(p["row0"]),
                }
        else:
            key = prng.PRNGKey(cfg.seed)
            self.it0 = 0
            self.aux_hist = {}
            self.n_avg = 0
            self.n_small = 0
            self.samp = None
            self.mean_w = None
            state = state0
            if self.warm_state is not None:
                if self.warm_state.shape != tuple(state0.shape):
                    raise ValueError(
                        f"warm_start weights have shape "
                        f"{self.warm_state.shape}, this fit expects "
                        f"{tuple(state0.shape)}")
                state = remesh(self.warm_state, dev)
        # the host chain: (splits so far, key, the last split's subkey)
        self._chain = (self.it0 + (sub is not None), key, sub)
        mc = cfg.algorithm == "MC"
        self.key = key.to(dev) if mc else None
        self.pending_sub = sub.to(dev) if mc and sub is not None else None
        self.last_saved_it = self.it0
        return state

    def key_after(self, n: int, sub: bool = False):
        """The chain's key after ``n`` splits (``sub``: the n-th split's
        subkey), for a snapshot: an MC fit's live device key (the driver
        keeps it at ``n``), or for EM the reference's chain walked on the
        host from the last one asked for."""
        if self.key is not None:
            return self.key
        k_n, key, last = self._chain
        while k_n < n:
            pair = prng.split(key)
            key, last = pair[0], pair[1]
            k_n += 1
        self._chain = (k_n, key, last)
        return last if sub else key

    # -------------------------------------------------------- checkpoints
    def samp_sum_of(self, shape) -> np.ndarray:
        """The float64 MC sample sum, mean * n_avg (the restored sum until
        the first new sample)."""
        if self.samp is not None:
            return self.samp.copy()
        if self.mean_w is not None:
            return np.asarray(self.mean_w, np.float64) * self.n_avg
        return np.zeros(tuple(shape), np.float64)

    def boundary_due(self, it: int) -> bool:
        return (self.ckpt is not None
                and it - self.last_saved_it >= self.policy.ckpt_every)

    def save_snapshot(self, it: int, state, key, *, converged: bool = False,
                      samp_sum=None, n_syncs: int | None = None,
                      sub=None, totals: dict | None = None,
                      chunk_idx: int = 0, row0: int = 0,
                      blocking: bool = False) -> None:
        if self.ckpt is None:
            return
        objs = self.aux_hist.get("objective", [])
        resume_mod.save_snapshot(
            self.ckpt, self.svm.config, it=it, state=state, key=key,
            samp_sum=(self.samp_sum_of(state.shape) if samp_sum is None
                      else samp_sum),
            n_avg=self.n_avg, n_small=self.n_small, objs=objs,
            aux_hist=self.aux_hist,
            n_syncs=len(objs) if n_syncs is None else n_syncs,
            converged=converged, prev_stats=self.prev_stats,
            window_stats=self.window_entries or None, sub=sub,
            totals=totals, chunk_idx=chunk_idx, row0=row0,
            blocking=blocking)
        self.n_checkpoints += 1
        if totals is None:
            self.last_saved_it = it

    def finish(self) -> None:
        """After the final blocking save: on a mesh every rank waits for
        rank 0's commit, so any rank may resume from it at once."""
        if self.checkpointing and self.svm.mesh is not None:
            dist.barrier(group=self.svm._whole().group)

    def flush(self) -> None:
        """Drain the background writer at fit exit, normal or unwinding
        (preemption, straggler): once fit returns or raises, every
        enqueued snapshot is committed. A write failure is recorded as an
        event, not raised (it must not mask the exception being unwound;
        the directory stays at the previous commit)."""
        if self.ckpt is None:
            return
        try:
            self.ckpt.wait()
        except Exception as e:  # noqa: BLE001
            self.events.append({"checkpoint_error": repr(e)})

    # ---------------------------------------------------------- straggler
    def observe(self, it: int, seconds: float) -> None:
        """Feed the step time to the monitor and react to a straggler
        verdict per ``on_straggler``. On a mesh with a fault policy the
        ranks agree on the verdict (any rank's), so a raise or a drop
        happens on every rank at the same step."""
        flag = self.monitor.observe(it, seconds)
        svm = self.svm
        if svm.mesh is not None and svm.config.fault is not None:
            t = torch.tensor([float(flag)], device=svm.device)
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=svm._whole().group)
            flag = bool(t.item())
        if not flag:
            return
        self.events.append({"it": it, "seconds": float(seconds),
                            "ema": float(self.monitor.ema)})
        pol = self.policy
        if pol.on_straggler == "raise":
            raise StragglerError(
                f"iteration {it} took {seconds:.4f}s > "
                f"{pol.straggler_threshold} x EMA "
                f"{self.monitor.ema:.4f}s")
        if pol.on_straggler == "drop":
            self.drop_shards(svm._suspect_shards)
            svm._suspect_shards.clear()

    def drop_shards(self, idxs) -> None:
        """Zero the liveness weight of this rank's shard if it is among
        ``idxs``: its statistics drop out and every reduction
        renormalizes (``stats.preduce``). The steps hold this tensor, so
        the next step reduces without the shard."""
        if self.live is None or not idxs:
            return
        if self.svm._shard_index() in {int(i) for i in idxs}:
            self.live.fill_(0.0)


def _check_krn(cfg: SVMConfig) -> None:
    """The exact-Gram KRN solver's limits, the reference's: the host key
    chain only, binary classification only, and no stream driver (the
    N x N Gram statistic is not additive over row chunks). NystromSVM
    covers the rest in phi-space."""
    if cfg.rng != "host":
        raise ValueError(
            f"rng={cfg.rng!r} needs the fused LIN statistics; the "
            "exact-Gram KRN step has no counter plumbing; use NystromSVM "
            "for kernel models")
    if cfg.task != "CLS":
        raise NotImplementedError(
            "the paper's exact KRN solver covers binary classification "
            f"only; NystromSVM serves KRN {cfg.task} through the phi-space "
            "route")
    if cfg.driver == "stream":
        raise NotImplementedError(
            "driver='stream' cannot use the exact N x N Gram statistic "
            "(not row-chunk-additive); use NystromSVM, whose phi-space "
            "route streams raw rows")


def _device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "PEMSVM runs on the GPU by default and no CUDA device is "
            "visible; pass device='cpu' to run the plain PyTorch path on "
            "the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class PEMSVM:
    """Parallel EM SVM (the paper's PEMSVM): LIN-{EM,MC}-{CLS,MLT,SVR} in
    X-space or Nystrom phi-space, and the exact-Gram KRN-{EM,MC}-CLS, on
    one device or on a device mesh.

    ``mesh``: a ``torch.distributed.device_mesh.DeviceMesh`` with
    ``mesh_dim_names``, on a process group the caller has created (NCCL
    for one card a rank, gloo on the CPU or for ranks sharing a card).
    ``data_axes`` defaults to every mesh axis but ``config.k_shard_axis``,
    as in the reference. Every rank constructs the model and calls
    ``fit`` with the same host arrays; outputs are replicated."""

    def __init__(self, config: SVMConfig, device=None, mesh=None,
                 data_axes=None):
        if config.formulation == "KRN":
            _check_krn(config)
        if config.fault is not None and not isinstance(config.fault,
                                                       FaultPolicy):
            raise TypeError("config.fault must be a runtime.FaultPolicy, "
                            f"got {type(config.fault).__name__}")
        self.config = config
        self.device = _device(device)
        self.mesh = mesh
        self._axes = self._k_axis = None
        if mesh is None:
            if config.k_shard_axis is not None or data_axes is not None:
                raise ValueError("k_shard_axis and data_axes name axes of a "
                                 "device mesh; pass mesh=")
            self.data_axes: tuple[str, ...] = ()
        else:
            distributed.check_mesh(mesh)
            if mesh.device_type != self.device.type:
                raise ValueError(
                    f"the mesh is on {mesh.device_type!r} devices and the "
                    f"fit on {self.device}; pass a matching device=")
            k = config.k_shard_axis
            if data_axes is None:
                data_axes = distributed.data_axes_of(
                    mesh, (k,) if k else ())
            self.data_axes = tuple(data_axes)
            if k is not None and k in self.data_axes:
                raise ValueError(f"k_shard_axis {k!r} is also a data axis")
            if self.data_axes:
                self._axes = distributed.axes_of(mesh, self.data_axes)
            if k is not None:
                self._k_axis = distributed.axes_of(mesh, (k,))
        # fp32 statistics must stay fp32: TF32 keeps ~3 decimal digits, and
        # a reduced-precision Sigma collapsed the posterior (DESIGN.md
        # §6.2). Both flags are process-wide in PyTorch.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self._weights: torch.Tensor | None = None
        self._n_features: int | None = None
        # The training rows (device tensor) of an exact KRN fit: its
        # decision function is a cross-Gram with them.
        self._train_X: torch.Tensor | None = None
        # Nystrom phi-space featurizer arrays (landmarks, K_mm^{-1/2}) as
        # float32 numpy; set by NystromSVM before fit when phi_spec is set.
        self._phi_arrays: tuple | None = None
        # (C, K) per-chain posterior means of a multichain fit: the
        # ensemble's uncertainty columns in export_servable.
        self._chain_weights: np.ndarray | None = None
        self._scorer_cache: tuple | None = None
        # data-shard indices a health probe has flagged; consumed by the
        # fault policy's on_straggler='drop' reaction
        self._suspect_shards: set[int] = set()

    def report_slow_shard(self, *shard_idx: int) -> None:
        """Name data-shard indices as straggler suspects. With
        ``FaultPolicy(on_straggler='drop')`` the next straggler event
        zeroes their liveness weight: their statistics drop out and every
        reduction renormalizes (``stats.preduce``). On a deployment a
        per-host health probe feeds this; in tests the fault harness
        does. Every rank of a mesh names the same shards."""
        self._suspect_shards.update(int(i) for i in shard_idx)

    def _shard_index(self) -> int:
        """This rank's data shard (0 without a mesh)."""
        return 0 if self._axes is None else self._axes.index

    def _whole(self) -> distributed.MeshAxes:
        """Every axis of the mesh: the group the ranks agree over, index 0
        the single writer of snapshots."""
        return distributed.axes_of(self.mesh, self.mesh.mesh_dim_names)

    def _phi(self):
        """The featurizer arrays as device tensors (None in X-space)."""
        if self.config.phi_spec is None:
            return None
        if self._phi_arrays is None:
            raise RuntimeError(
                "config.phi_spec is set but no featurizer arrays were "
                "installed; fit through NystromSVM, which selects landmarks "
                "and computes K_mm^{-1/2} before delegating")
        return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(
            self.device) for a in self._phi_arrays)

    # ------------------------------------------------------------- fitting
    def fit(self, X: np.ndarray, y: np.ndarray, *, resume_from=None,
            resume_step: int | None = None,
            warm_start: FitResult | None = None, live=None,
            fault_hook: Callable | None = None,
            epoch: int | None = None) -> FitResult:
        """Fit on host arrays X (N, D) and labels y in {+-1} (CLS), integer
        class ids in [0, num_classes) (MLT) or real targets (SVR). With
        ``driver="stream"`` the arrays are page-locked for the fit and
        stream through the device in chunks (``_fit_stream_arrays``).

        The keyword group is the reference's elastic surface.
        ``resume_from`` (a directory or a ``Checkpointer``) continues a
        preempted fit from its last committed snapshot (``resume_step``
        pins one) on whatever driver and mesh THIS model holds: snapshots
        hold logical host tensors (``core/resume.py``), and either
        package's snapshots resume in the other. ``warm_start`` (a
        previous ``FitResult``) starts a NEW fit from its last sample;
        with ``config.decay > 0`` or ``config.window >= 2`` (stream
        driver) its statistics are folded in (``_fit_stream``). ``live``
        (mesh only) is the initial liveness weight of each data shard,
        shape (num_shards,): a shard at 0 drops out of every reduction and
        the sums renormalize (``stats.preduce``). ``fault_hook(it)`` is
        called once a host sync with the completed iterations (the fault
        injectors of ``runtime.faults``). ``epoch`` is the attempt's fence
        token under several controllers (``runtime.controller``): a
        superseded attempt's commits are rejected."""
        cfg = self.config
        live = self._live(live)
        rt = _FitRuntime(self, warm_start=warm_start, live=live,
                         resume_from=resume_from, resume_step=resume_step,
                         fault_hook=fault_hook, epoch=epoch)
        try:
            X = np.ascontiguousarray(X, np.float32)
            self._n_features = X.shape[1]
            target = self._targets(np.asarray(y))
            if cfg.driver == "stream":
                return self._fit_stream_arrays(X, target, rt)
            N = X.shape[0]
            step, data, state = self._resident_step(X, target, live)
            if cfg.driver == "loop":
                return self._fit_loop(data, state, step, N, rt)
            return self._fit_scan(data, state, step, N, rt)
        finally:
            rt.flush()

    def _resident_step(self, X: np.ndarray, target: np.ndarray, live):
        """(step, data, state0) of a resident fit: the statistic matrix
        (or the exact KRN Gram) on the device and the step over it."""
        cfg = self.config
        if cfg.formulation == "KRN":
            data, gram, state = self._prepare_krn(X, target)

            def step(data, omega, key):
                return kernel.krn_step(
                    data, gram, omega, key, mode=cfg.algorithm, lam=cfg.lam,
                    eps=cfg.eps, jitter=cfg.jitter, backend=cfg.backend,
                    axes=self._axes, triangle=cfg.triangle_reduce,
                    reduce_dtype=cfg.reduce_dtype, live=live)
            return step, data, state
        phi = self._phi()
        data, state = self._prepare(X, target, phi)
        common = dict(mode=cfg.algorithm, lam=cfg.lam, eps=cfg.eps,
                      jitter=cfg.jitter, backend=cfg.backend,
                      rng=cfg.rng, chain0=cfg.chain0, phi=phi,
                      phi_spec=cfg.phi_spec, axes=self._axes,
                      triangle=cfg.triangle_reduce,
                      k_shard_axis=self._k_axis,
                      reduce_dtype=cfg.reduce_dtype, live=live)
        if cfg.task == "MLT":
            step = functools.partial(multiclass.mlt_step,
                                     num_classes=cfg.num_classes, **common)
        elif cfg.task == "SVR":
            step = functools.partial(svr.svr_step, eps_ins=cfg.eps_ins,
                                     n_chains=cfg.n_chains, **common)
        else:
            step = functools.partial(linear.cls_step,
                                     n_chains=cfg.n_chains, **common)
        return step, data, state

    def _width(self, n_features: int) -> int:
        """The statistic matrix's width for raw rows ``n_features`` wide:
        the bias column (LIN), then ``pad_features``' zero columns. In
        phi-space (``add_bias`` False) the raw width."""
        cfg = self.config
        bias = int(cfg.add_bias and cfg.formulation == "LIN")
        return padded_width(n_features + bias, cfg.pad_features)

    def _state_width(self, n_features: int) -> int:
        """The weight vector's width: the statistic width, or in phi-space
        the projection's columns plus the phi-space bias."""
        if self.config.phi_spec is None:
            return self._width(n_features)
        return (self._phi_arrays[1].shape[1]
                + int(self.config.phi_spec.add_bias))

    def _live(self, live) -> torch.Tensor | None:
        """This rank's liveness weight as a 0-d device tensor (all shards
        live by default on a mesh: bitwise the plain sums), from the
        per-data-shard vector ``live``; None without a mesh."""
        if self.mesh is None:
            if live is not None:
                raise ValueError("live (per-shard liveness weights) needs a "
                                 "mesh: a one-device fit has no shards to "
                                 "drop")
            return None
        n = 1 if self._axes is None else self._axes.size
        vec = np.ones((n,), np.float32)
        if live is not None:
            live = np.asarray(live, np.float32)
            if live.shape != (n,):
                raise ValueError(f"live must be one weight per data shard, "
                                 f"shape ({n},); got {live.shape}")
            vec = live
        i = 0 if self._axes is None else self._axes.index
        return torch.tensor(vec[i], dtype=torch.float32, device=self.device)

    def _fit_scan(self, data: SVMData, state: torch.Tensor, step: Callable,
                  N: int, rt: _FitRuntime) -> FitResult:
        """Chunked on-device driver (reference ``_fit_scan`` and
        ``_chunk_runner``).

        ``scan_chunk`` iterations run back to back with the state, the
        key chain, the MC sample sum, the Sec 5.5 stopping counters and
        the converged flag kept as device tensors; once converged,
        ``torch.where`` freezes every update, so the later iterations of
        the chunk are exact no-ops. Nothing in a chunk waits for the
        device: the host sees one transfer per chunk (the stacked trace,
        the chunk's float32 sample sum and the flags) and decides whether
        to launch the next, so n_host_syncs <= ceil(max_iters /
        scan_chunk). The chunk sums are combined in float64 on the host.
        The trace is truncated at the converged iteration, which makes
        the trace and the last sample equal to the loop driver's.

        Reliability: a resume restores the whole carry from a boundary
        snapshot (state, key, the float64 sample sum, the sample count,
        the stopping counter, the previous objective, the sync count).
        With checkpoints on, the key's words and the stopping counter ride
        the chunk's one transfer, and the state too when a snapshot is
        due, so snapshots add no host sync; the fault hook and the
        straggler monitor run once a transfer, and the fit ends with a
        blocking snapshot.
        """
        cfg = self.config
        dev = self.device
        is_mc = cfg.algorithm == "MC"
        state = rt.init_loop(state)
        key = rt.key
        keys = self._aux_keys
        aux_hist = rt.aux_hist
        for k in keys:
            aux_hist.setdefault(k, [])
        objs = aux_hist["objective"]
        tol_n = torch.tensor(cfg.tol * N, dtype=torch.float32, device=dev)
        prev_obj = torch.tensor(objs[-1] if objs else math.inf,
                                dtype=torch.float32, device=dev)
        n_small = torch.tensor(rt.n_small, dtype=torch.int32, device=dev)
        n_avg = torch.tensor(rt.n_avg, dtype=torch.int32, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        it_done = torch.zeros((), dtype=torch.int32, device=dev)
        samp_total = rt.samp_sum_of(state.shape)
        n_syncs = int(rt.payload["n_syncs"]) if rt.payload else 0
        it0 = rt.it0
        converged = False
        count, done_at, key_words = rt.n_avg, 0, None
        while it0 < cfg.max_iters:
            t0 = time.perf_counter()
            chunk = min(cfg.scan_chunk, cfg.max_iters - it0)
            samp = torch.zeros_like(state)
            trace = []
            for it in range(it0 + 1, it0 + chunk + 1):
                key, sub = _next_key(key)
                new_state, aux = step(data, state, sub)
                obj = aux["objective"]
                state = torch.where(done, state, new_state)
                if is_mc and it > cfg.burnin:
                    take = ~done
                    n_avg = n_avg + take.to(torch.int32)
                    samp = torch.where(take, samp + new_state, samp)
                small = torch.abs(obj - prev_obj) <= tol_n
                n_small = torch.where(
                    done, n_small,
                    torch.where(small, n_small + 1, torch.zeros_like(n_small)))
                conv_now = ~done & (n_small >= cfg.patience) & (
                    it >= cfg.min_iters)
                if is_mc:
                    conv_now = conv_now & (n_avg >= 1)
                it_done = torch.where(conv_now, torch.full_like(it_done, it),
                                      it_done)
                prev_obj = torch.where(done, prev_obj, obj)
                done = done | conv_now
                trace.append(torch.stack([aux[k] for k in keys]))
            # The single per-chunk host sync: trace, sample sum and flags
            # (with checkpoints on, the stopping counter, the key and, when
            # a snapshot is due, the state) in one copy.
            extra = []
            due = rt.boundary_due(it0 + chunk)
            if rt.ckpt is not None:
                extra = [n_small] + ([key] if is_mc else [])
                extra += [state] if due else []
            tr, s_np, done_np, at_np, avg_np, *more = _one_copy(
                torch.stack(trace), samp, done, it_done, n_avg, *extra)
            n_syncs += 1
            samp_total += s_np
            converged = bool(done_np)
            done_at = int(at_np)
            count = int(avg_np)
            valid = (done_at - it0) if converged else chunk
            for j, k in enumerate(keys):
                aux_hist[k].extend(float(v) for v in tr[:valid, j])
            it0 += chunk
            done_its = done_at if converged else it0
            rt.cur_it = done_its
            if rt.ckpt is not None:
                rt.n_avg, rt.n_small = count, int(more[0])
                key_words = more[1] if is_mc else None
                if not converged and due:
                    rt.save_snapshot(
                        done_its, more[-1],
                        key_words if is_mc else rt.key_after(it0),
                        samp_sum=samp_total, n_syncs=n_syncs)
            if rt.hook is not None:
                rt.hook(done_its)
            rt.observe(done_its, time.perf_counter() - t0)
            if converged:
                break
        n_iters = done_at if converged else it0
        last = state.cpu().numpy().astype(np.float32)
        weights = ((samp_total / count).astype(np.float32) if count > 0
                   else last)
        if rt.ckpt is not None and n_iters > rt.last_saved_it:
            rt.save_snapshot(n_iters, last, key_words if key_words is not None
                             else rt.key_after(it0), converged=converged,
                             samp_sum=samp_total, n_syncs=n_syncs,
                             blocking=True)
        rt.finish()
        return self._finish(weights, last, aux_hist, n_iters, converged,
                            n_syncs, rt)

    def _fit_host_loop(self, iterate: Callable, state0: torch.Tensor,
                       rt: _FitRuntime,
                       host_aux: Callable | None = None) -> FitResult:
        """Host-loop tail of the reference's loop and stream drivers: key
        chain, trace bookkeeping, the MC posterior average (a float64
        running mean after ``burnin``) and the Sec 5.5 stopping rule, one
        host sync per iteration. ``iterate(sub_key, state) -> (state,
        scalars, n_valid)`` with ``scalars`` a dict of 0-d device tensors:
        the aux keys, or whatever ``host_aux`` maps (on the host, after the
        one transfer) to ``(aux, n_valid)`` when ``n_valid`` is None.

        The loop scalars live on ``rt``, which restores them from a
        snapshot (``init_loop``). Per iteration, as the reference: the
        subkey (a mid-pass resume takes the saved subkey instead of
        splitting), the iteration, histories, average and stopping
        counter, the boundary snapshot (the state joins the iteration's
        transfer when one is due), the fault hook, the straggler monitor,
        then the convergence test; the fit ends with a blocking
        snapshot."""
        cfg = self.config
        is_mc = cfg.algorithm == "MC"
        state = rt.init_loop(state0)
        keys = self._aux_keys
        aux_hist = rt.aux_hist
        for k in keys:
            aux_hist.setdefault(k, [])
        objs = aux_hist["objective"]
        converged = False
        it = rt.it0
        for it in range(rt.it0 + 1, cfg.max_iters + 1):
            t0 = time.perf_counter()
            if rt.pending_sub is not None:
                sub, rt.pending_sub = rt.pending_sub, None
            else:
                rt.key, sub = _next_key(rt.key)
            rt.cur_it = it
            state, scalars, n_valid = iterate(sub, state)
            names = keys if host_aux is None else tuple(scalars)
            average = is_mc and it > cfg.burnin
            due = rt.boundary_due(it)
            vals, *w = _one_copy(torch.stack([scalars[k] for k in names]),
                                 *([state] if average or due else []))
            aux = {k: float(v) for k, v in zip(names, vals)}
            if host_aux is not None:
                aux, n_valid = host_aux(aux)
            for k in keys:
                aux_hist[k].append(aux[k])
            if average:
                rt.mean_w = w[0] if rt.mean_w is None else (
                    rt.samp_sum_of(w[0].shape) + w[0]) / (rt.n_avg + 1)
                rt.n_avg += 1
                rt.samp = None
            if (len(objs) >= 2
                    and abs(objs[-1] - objs[-2]) <= cfg.tol * n_valid):
                rt.n_small += 1
            else:
                rt.n_small = 0
            if due:
                rt.save_snapshot(it, w[0], rt.key_after(it))
            if rt.hook is not None:
                rt.hook(it)
            rt.observe(it, time.perf_counter() - t0)
            if it >= cfg.min_iters and rt.n_small >= cfg.patience:
                if not is_mc or rt.n_avg >= 1:
                    converged = True
                    break
        last = state.cpu().numpy().astype(np.float32)
        if rt.ckpt is not None and it > rt.last_saved_it:
            rt.save_snapshot(it, last, rt.key_after(it), converged=converged,
                             blocking=True)
        rt.finish()
        weights = (rt.mean_w.astype(np.float32) if rt.mean_w is not None
                   else last)
        return self._finish(weights, last, aux_hist, it, converged,
                            len(objs), rt)

    def _fit_loop(self, data: SVMData, state: torch.Tensor, step: Callable,
                  N: int, rt: _FitRuntime) -> FitResult:
        """Per-iteration driver: the semantic oracle for the scan driver."""
        def iterate(sub, state):
            state, aux = step(data, state, sub)
            return state, aux, N

        return self._fit_host_loop(iterate, state, rt)

    # ------------------------------------------------------- the stream
    def fit_libsvm(self, path: str, n_features: int, rank: int = 0,
                   world: int = 1, **fit_kw) -> FitResult:
        """Fit from a libsvm file. With ``driver="stream"`` the file is
        re-read chunk by chunk every pass (``data.libsvm.iter_libsvm``
        through the prefetcher) and the data set is never resident on the
        host or the device; other drivers load it and defer to ``fit``.
        ``rank``/``world`` stripe the lines per host (paper Sec 5.6).
        ``fit_kw`` goes to ``fit`` / ``fit_chunks``: the elastic keywords
        (``resume_from``, ``warm_start``, ``fault_hook``, ...)."""
        cfg = self.config
        if cfg.driver != "stream":
            X, y = load_libsvm(path, n_features, rank=rank, world=world)
            return self.fit(X, y, **fit_kw)
        if world > 1:
            # A rank stripe is a partial data set; the stream driver has no
            # cross-rank reduction, so a stripe would train on 1/world of
            # the rows.
            raise NotImplementedError(
                "driver='stream' with world > 1 needs a cross-host "
                "reduction that does not exist yet; stream the full "
                "file (world=1) or use a resident driver on a mesh")
        self._n_features = n_features

        def make_chunks():
            for Xc, yc, mc in iter_libsvm(path, cfg.chunk_rows, n_features,
                                          rank=rank, world=world):
                if cfg.add_bias:
                    # the bias column is the mask: padded rows stay zero
                    Xc = np.concatenate([Xc, mc[:, None]], axis=1)
                if cfg.pad_features:
                    Xc = pad_features_to(Xc, cfg.pad_features)
                yield Xc, self._stream_target(yc, mc), mc

        return self.fit_chunks(make_chunks, self._state_width(n_features),
                               **fit_kw)

    def fit_chunks(self, make_chunks: Callable, K: int, *,
                   resume_from=None, resume_step: int | None = None,
                   warm_start: FitResult | None = None,
                   fault_hook: Callable | None = None,
                   epoch: int | None = None) -> FitResult:
        """Out-of-core fit over a restartable chunk source: ``make_chunks()``
        returns a fresh iterator of host ``(X, target, mask)`` blocks of one
        shape, their width already final (bias column appended, features
        padded; raw rows in phi-space), and ``K`` is the weight vector's
        width. The chunks reach the device through a pinned staging ring
        (``data.pipeline.DevicePlacer``). This is the seam the fault
        injectors wrap (``runtime.faults.kill_after_chunks``, ...): loader
        retries, mid-pass snapshots and the resume's skip compose around
        the factory per ``config.fault``; the keywords as in ``fit``."""
        cfg = self.config
        if cfg.driver != "stream":
            raise ValueError(
                f"fit_chunks is the stream driver's entry point; "
                f"config.driver is {cfg.driver!r}")
        rt = _FitRuntime(self, warm_start=warm_start,
                         resume_from=resume_from, resume_step=resume_step,
                         fault_hook=fault_hook, epoch=epoch)
        try:
            return self._fit_stream(make_chunks, K,
                                    DevicePlacer(self.device), rt)
        finally:
            rt.flush()

    def _stream_target(self, y: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """One chunk's targets, cast and checked on its valid rows as
        ``fit`` checks them."""
        y = np.asarray(y)
        self._targets(y[np.asarray(mask) > 0])
        return np.asarray(y, np.int32 if self.config.task == "MLT"
                          else np.float32)

    def _fit_stream_arrays(self, X: np.ndarray, target: np.ndarray,
                           rt: _FitRuntime) -> FitResult:
        """``driver="stream"`` on in-memory arrays: chunk views of X, which
        is page-locked in place for the fit (``PageLock``), so that each
        chunk is copied to the device with no host copy, and of the
        targets (copied once to pinned memory: small, and a small array
        may share a page with others); the bias column, the padded tail
        and the chunk's mask are written on the device
        (``DevicePlacer``)."""
        cfg = self.config
        N, D = X.shape
        cr = cfg.chunk_rows
        target = np.ascontiguousarray(target)
        bias = D if cfg.add_bias and cfg.formulation == "LIN" else None
        cuda = self.device.type == "cuda"
        placer = DevicePlacer(self.device, cr, self._width(D), bias,
                              pinned_source=cuda)

        def make_chunks():
            for i0 in range(0, N, cr):
                yield X[i0:i0 + cr], target[i0:i0 + cr], None

        K = self._state_width(D)
        if not cuda:
            return self._fit_stream(make_chunks, K, placer, rt)
        target = torch.from_numpy(target).pin_memory().numpy()
        with PageLock(self.device, X):
            return self._fit_stream(make_chunks, K, placer, rt)

    def _fit_stream(self, make_chunks: Callable, K: int, placer,
                    rt: _FitRuntime) -> FitResult:
        """The out-of-core driver (reference ``_fit_stream``).

        Each iteration sweeps the chunks through the prefetcher, sums the
        per-chunk statistic dicts on the device in chunk order
        (``totals = totals + part``), then runs the posterior solve or
        draw on the sums; MLT sweeps M + 1 times (one pass a class, then
        the objective). ``row0``, the chunk's global row, is a host int
        carried across the chunks. Nothing in a sweep waits for the
        device: the scalars stay device tensors until the iteration's one
        transfer (``_fit_host_loop``), so ``n_host_syncs == n_iters``.

        The chunk source is wrapped in ``retrying_chunks`` per the fault
        policy (a flaky loader restarts past the chunks already folded).
        With ``ckpt_chunks > 0`` a MID-PASS snapshot commits every n
        chunks: the pre-iteration state, the iteration's subkey and the
        partial totals, copied to the host only then, with the chunk
        cursor and ``row0``; a resume skips the folded chunks (``source``),
        starts ``totals`` and ``row0`` from the snapshot and finishes the
        same pass, bit for bit. MLT snapshots at iteration boundaries only
        (a class sweep's cursor would also need the class).

        A warm start begins at the donor's last sample. With
        ``config.decay > 0`` the M-step takes fresh + decay * the donor's
        effective (S, b); with ``config.window >= 1`` it takes the fresh
        statistics plus the retained ring at full weight
        (``StatsWindow.folded``); MLT folds per class, before each class's
        M-step. The donor statistics are placed once and frozen for the
        whole fit (generations advance per fit), and the objective stays
        fresh-data-only. ``FitResult.stats`` is the effective (S, b) of
        the last M-step and ``stats_window`` the ring advanced by this
        fit's fresh (S, b), both numpy, copied after the loop."""
        cfg = self.config
        if self.mesh is not None:
            raise NotImplementedError(
                "driver='stream' is single-process: on a mesh, stream "
                "per-host shards via data_axes striping instead "
                "(rank/world in fit_libsvm)")
        dev = self.device
        fns = _stream_fns(cfg, self._phi())
        is_mlt = cfg.task == "MLT"
        if is_mlt:
            state0 = torch.zeros((cfg.num_classes, K), dtype=torch.float32,
                                 device=dev)
        else:
            state0 = linear.init_weight(K, dev, cfg.n_chains)
        pol = rt.policy
        peak = 0

        def on_device(d):
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    for k, v in d.items()}

        prev = None if rt.prev_stats is None else on_device(rt.prev_stats)
        win = (stats.StatsWindow(cfg.window,
                                 [on_device(e) for e in rt.window_entries])
               if cfg.window >= 1 else None)
        keep = cfg.decay > 0.0 or win is not None
        held: dict = {}          # the last M-step's effective and fresh stats

        def fold(S, b, y=None):
            """The M-step's (S, b): the fresh sums plus the donor's."""
            if prev is not None:
                S = S + cfg.decay * (prev["S"] if y is None else prev["S"][y])
                b = b + cfg.decay * (prev["b"] if y is None else prev["b"][y])
            if win is not None:
                for e in win.entries:     # newest first, as folded()
                    S = S + (e["S"] if y is None else e["S"][y])
                    b = b + (e["b"] if y is None else e["b"][y])
            return S, b

        def source(skip):
            it = make_chunks()
            return itertools.islice(it, skip, None) if skip else it

        def sweep(fn, skip0=0, totals=None, row0=0, saver=None):
            """One pass: the chunks' contributions summed on the device.
            ``skip0`` / ``totals`` / ``row0`` continue a partly swept pass
            (a mid-pass resume); ``saver`` commits the partial totals
            every ``ckpt_chunks`` chunks."""
            nonlocal peak
            src = retrying_chunks(lambda done: source(skip0 + done),
                                  retries=pol.loader_retries,
                                  backoff=pol.loader_backoff,
                                  jitter=pol.loader_jitter, seed=cfg.seed,
                                  stats=rt.retry)
            pf = ChunkPrefetcher(src, depth=cfg.prefetch, place=placer)
            consumed = skip0
            for chunk in pf:
                data = SVMData(*chunk)
                part = fn(data, row0)
                totals = part if totals is None else _add_stats(totals, part)
                row0 += data.X.shape[0]
                consumed += 1
                if saver is not None and consumed % pol.ckpt_chunks == 0:
                    saver(totals, consumed, row0)
            if totals is None:
                raise ValueError("stream source yielded no chunks")
            peak = max(peak, pf.max_resident_bytes)
            return totals

        def iterate(sub, state):
            midpass, rt.midpass = rt.midpass, None
            if is_mlt:
                fresh, eff = [], []
                for y in range(cfg.num_classes):
                    t = sweep(lambda d, r0, _y=y:
                              fns["chunk"](d, state, sub, r0, _y))
                    S, b = fold(t["S"], t["b"], y)
                    if keep:
                        fresh.append((t["S"], t["b"]))
                        eff.append((S, b))
                    state = fns["mstep"](state, S, b, sub, y)
                if keep:
                    held["fresh"], held["eff"] = _stacked(fresh), _stacked(eff)
                t = sweep(lambda d, r0: fns["obj"](d, state))
                return state, {"objective": fns["obj_total"](state,
                                                              t["loss"]),
                               "mask_sum": t["mask_sum"]}, None

            def saver(totals, consumed, row0):
                # the pre-iteration state, this iteration's subkey and the
                # partial totals: a resume replays the rest of THIS pass
                it = rt.cur_it
                rt.save_snapshot(
                    it - 1, state, rt.key_after(it),
                    sub=sub if sub is not None else rt.key_after(it, True),
                    totals=totals, chunk_idx=consumed, row0=row0)

            body = lambda d, r0: fns["chunk"](d, state, sub, r0)  # noqa: E731
            sv = (saver if rt.ckpt is not None and pol.ckpt_chunks > 0
                  else None)
            if midpass is not None:
                t = sweep(body, midpass["skip"], midpass["totals"],
                          midpass["row0"], sv)
            else:
                t = sweep(body, saver=sv)
            S, b = fold(t["S"], t["b"])
            if keep:
                held["fresh"] = {"S": t["S"], "b": t["b"]}
                held["eff"] = {"S": S, "b": b}
            state, obj = fns["mstep"](S, b, t["loss"], sub)
            return state, {"objective": obj,
                           **{k: v for k, v in t.items()
                              if k not in ("S", "b", "loss")}}, None

        def host_aux(h):
            den = max(h["mask_sum"], 1.0)
            aux = {"objective": h["objective"]}
            if cfg.task == "SVR":
                aux["gamma_mean"] = h["gamma_sum"] / den
                aux["omega_mean"] = h["omega_sum"] / den
            elif not is_mlt:
                aux["gamma_mean"] = h["gamma_sum"] / den
                aux["n_sv"] = h["n_sv"]
            return aux, h["mask_sum"]

        result = self._fit_host_loop(iterate, state0, rt, host_aux)
        result.peak_input_bytes = int(peak)
        result.loader_retries = rt.retry.retries
        result.loader_backoff_s = rt.retry.backoff_s
        if held:
            result.stats = {k: v.cpu().numpy()
                            for k, v in held["eff"].items()}
            if win is not None:
                result.stats_window = stats.StatsWindow(
                    cfg.window, rt.window_entries).advance(held["fresh"])
        return result

    def _finish(self, weights, last, aux_hist, n_iters, converged,
                n_syncs, rt: _FitRuntime) -> FitResult:
        """The FitResult, with the reference's multichain post-processing
        (``_finalize_chains``): a (C, K) fit state is the per-chain
        posterior means, exposed as ``chain_weights``; ``weights`` is
        their float64 cross-chain mean and ``chain_std`` their ddof=1
        std. Single-chain fits pass through."""
        res = FitResult(weights=weights, last_sample=last,
                        objective=list(aux_hist["objective"]),
                        aux_history=aux_hist, n_iters=n_iters,
                        converged=converged, n_host_syncs=n_syncs,
                        straggler_events=rt.events,
                        resumed_at=rt.resumed_at,
                        n_checkpoints=rt.n_checkpoints)
        if self.config.n_chains > 1:
            cw = np.asarray(weights, np.float32)
            res.chain_weights = cw
            res.chain_std = np.std(cw.astype(np.float64), axis=0,
                                   ddof=1).astype(np.float32)
            res.weights = np.mean(cw.astype(np.float64),
                                  axis=0).astype(np.float32)
        self._weights = torch.from_numpy(res.weights).to(self.device)
        self._chain_weights = res.chain_weights
        return res

    @property
    def _aux_keys(self) -> tuple:
        """The per-iteration diagnostics the step reports, in the order the
        scan driver stacks them."""
        return _AUX_KEYS[self.config.formulation, self.config.task]

    def _targets(self, y: np.ndarray) -> np.ndarray:
        """The targets as the step takes them: +-1 float32 labels (CLS),
        int32 class ids (MLT) or float32 values (SVR)."""
        cfg = self.config
        if cfg.task == "MLT":
            labels = np.asarray(y, np.int32)
            if labels.size and (labels.min() < 0
                                or labels.max() >= cfg.num_classes):
                raise ValueError(
                    f"MLT labels must be class ids in [0, "
                    f"{cfg.num_classes}), got [{labels.min()}, "
                    f"{labels.max()}]")
            return labels
        target = np.asarray(y, np.float32)
        if cfg.task == "CLS":
            uniq = set(np.unique(target).tolist())
            if not uniq <= {-1.0, 1.0}:
                raise ValueError(f"CLS labels must be +-1, got {uniq}")
        return target

    def _prepare_krn(self, X: np.ndarray, target: np.ndarray):
        """(data, the padded Gram, omega = 0) of an exact KRN fit. The Gram
        of the training rows is computed on the device (``rbf_gram``) and
        padded as blockdiag(K, I) to a multiple of 8 rows a data shard;
        this rank's data are its block of the Gram's rows, and the whole
        padded Gram is the replicated prior. Padded rows have target 0
        and mask 0."""
        cfg = self.config
        dev = self.device
        shards = 1 if self._axes is None else self._axes.size
        _, tp, mask = distributed.pad_rows(X[:, :0], target, shards)
        n_all = tp.shape[0]
        self._train_X = torch.from_numpy(X).to(dev)
        gram = kernel.pad_gram(kernel.gram_matrix(
            self._train_X, self._train_X, kind=cfg.kernel, sigma=cfg.sigma,
            backend=cfg.backend), n_all - X.shape[0])
        n_loc = n_all // shards
        i = 0 if self._axes is None else self._axes.index
        rows = slice(i * n_loc, (i + 1) * n_loc)
        data = SVMData(gram[rows], torch.from_numpy(tp[rows]).to(dev),
                       torch.from_numpy(mask[rows]).to(dev))
        state = torch.zeros((n_all,), dtype=torch.float32, device=dev)
        return data, gram, state

    def _prepare(self, X: np.ndarray, target: np.ndarray, phi=None):
        """(data, state0) of a resident fit. The statistic matrix is built
        once, on the device: this rank's block of the rows padded as the
        reference pads them (``distributed.pad_rows`` over all data
        shards), the raw rows copied into its [:n, :D] slice through
        pinned staging (``rows_to_device``), then the bias column (1 on
        real rows) and the zero padding rows and columns written on the
        device. The values are those of the host-built matrix, bit for
        bit, without its two host copies of X."""
        cfg = self.config
        dev = self.device
        N, D = X.shape
        shards = 1 if self._axes is None else self._axes.size
        _, tp, mask = distributed.pad_rows(X[:, :0], target, shards)
        n_loc = tp.shape[0] // shards
        i = 0 if self._axes is None else self._axes.index
        lo, hi = min(i * n_loc, N), min((i + 1) * n_loc, N)
        width = self._width(D)
        Xd = torch.empty((n_loc, width), dtype=torch.float32, device=dev)
        Xd[:, D:].zero_()
        if cfg.add_bias and cfg.formulation == "LIN":
            Xd[:hi - lo, D].fill_(1.0)
        Xd[hi - lo:].zero_()
        rows_to_device(X[lo:hi], Xd)
        rows = slice(i * n_loc, (i + 1) * n_loc)
        data = SVMData(Xd, torch.from_numpy(tp[rows]).to(dev),
                       torch.from_numpy(mask[rows]).to(dev))
        K = self._state_width(D)
        if cfg.task == "MLT":
            return data, torch.zeros((cfg.num_classes, K),
                                     dtype=torch.float32, device=dev)
        return data, linear.init_weight(K, dev, cfg.n_chains)

    # ---------------------------------------------------------- inference
    def export_servable(self, *, name: str = "svm",
                        posterior_from: tuple | None = None):
        """Freeze this fitted model into a ``serving.ServableModel``, all
        of the serving path's view of it.

        The exact KRN model rides the Nystrom score cell: landmarks are
        the training rows, the projection is the dual weight column
        omega[:, None] and the score weight [[1.]], so score =
        k(X, X_train) @ omega through ``nystrom_score``.

        ``posterior_from=(X, y)`` appends the posterior uncertainty
        directions U = L^{-T} as weight columns (``_posterior_columns``);
        a multichain fit without it appends its ensemble's columns
        (w_c - w_bar) / sqrt(C - 1), so ||x @ U|| is the ddof=1 std of
        the chains' margins. Either is served by
        ``SVMScorer.score_with_std`` from the same dispatch."""
        from repro_torch.serving import ServableModel

        cfg = self.config
        if self._weights is None:
            raise RuntimeError("fit first")
        w = self._weights.cpu().numpy().astype(np.float32)
        task = cfg.task.lower()
        if cfg.formulation == "KRN":
            if posterior_from is not None:
                raise NotImplementedError(
                    "posterior serving for the exact-Gram model needs the "
                    "kernel prior precision; fit NystromSVM, whose "
                    "phi-space posterior is lam^{-1} I exactly")
            train = self._train_X.cpu().numpy()
            return ServableModel(
                task=task, weights=np.ones((1, 1), np.float32),
                n_outputs=1, n_features=train.shape[1], landmarks=train,
                proj=w[:train.shape[0], None], phi_kind=cfg.kernel,
                phi_sigma=cfg.sigma, phi_add_bias=False,
                backend=cfg.backend, name=name)
        if cfg.task == "MLT":
            W, n_out = np.ascontiguousarray(w.T), cfg.num_classes
        else:
            W, n_out = w[:, None], 1
        if posterior_from is not None:
            U = self._posterior_columns(*posterior_from)
            W = np.concatenate([W, U], axis=1)
        elif self._chain_weights is not None:
            cw = self._chain_weights.astype(np.float64)
            U = (cw - cw.mean(axis=0)) / np.sqrt(cw.shape[0] - 1)
            W = np.concatenate([W, U.T.astype(np.float32)], axis=1)
        if cfg.phi_spec is not None:
            lm, pj = self._phi_arrays
            return ServableModel(
                task=task, weights=W, n_outputs=n_out,
                n_features=lm.shape[1], landmarks=lm, proj=pj,
                phi_kind=cfg.phi_spec.kind, phi_sigma=cfg.phi_spec.sigma,
                phi_add_bias=cfg.phi_spec.add_bias, backend=cfg.backend,
                name=name)
        D = self._n_features
        if D is None:
            if cfg.pad_features:
                raise ValueError(
                    "raw feature width unknown (fit_chunks with "
                    "pad_features); set svm._n_features or fit via "
                    "fit/fit_libsvm")
            D = W.shape[0] - int(cfg.add_bias)
        if self._width(D) != W.shape[0]:
            raise ValueError(
                f"recorded request width {D} preps to {self._width(D)} "
                f"columns but the fitted weights have {W.shape[0]}")
        return ServableModel(task=task, weights=W, n_outputs=n_out,
                             n_features=D, add_bias=cfg.add_bias,
                             backend=cfg.backend, name=name)

    def _posterior_columns(self, X: np.ndarray, y: np.ndarray
                           ) -> np.ndarray:
        """U = L^{-T}, (Kfit, Kfit) float32: the uncertainty directions of
        the weight posterior N(mu, P^{-1}) at the fitted weights. One
        E-step over (X, y) on the device (``ops.fused_stats``; in
        phi-space on ``nystrom_phi``'s features) rebuilds S; then, in
        float64 on the host as in the reference, P = S + lam I,
        symmetrised, plus the config's relative jitter, L = chol(P). The
        served std is ||phi U|| = sqrt(phi^T P^{-1} phi)."""
        cfg = self.config
        if cfg.task == "MLT":
            raise NotImplementedError(
                "MLT posterior columns need per-class statistics; export "
                "per-class binary models instead")
        dev = self.device
        X = np.ascontiguousarray(X, np.float32)
        if cfg.phi_spec is not None:
            lm, pj = self._phi()
            Xp = ops.nystrom_phi(
                torch.from_numpy(X).to(dev), lm, pj, None,
                sigma=cfg.phi_spec.sigma, kind=cfg.phi_spec.kind,
                add_bias=cfg.phi_spec.add_bias, backend=cfg.backend)
        else:
            n, D = X.shape
            Xp = torch.zeros((n, self._width(D)), dtype=torch.float32,
                             device=dev)
            if cfg.add_bias:
                Xp[:, D] = 1.0
            rows_to_device(X, Xp)
        yf = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
        beta = yf if cfg.task == "CLS" else torch.zeros_like(yf)
        epi = "em_hinge" if cfg.task == "CLS" else "em_svr"
        out = ops.fused_stats(Xp, yf, beta, self._weights, None, None,
                              epilogue=epi, eps=cfg.eps,
                              eps_ins=cfg.eps_ins, backend=cfg.backend)
        S = out[-1].cpu().numpy().astype(np.float64)
        K = S.shape[0]
        P = S + cfg.lam * np.eye(K)
        P = 0.5 * (P + P.T)
        P += (cfg.jitter * np.trace(P) / K) * np.eye(K)
        L = np.linalg.cholesky(P)
        return np.linalg.solve(L, np.eye(K)).T.astype(np.float32)

    def scorer(self):
        """The device-resident ``serving.SVMScorer`` of this fitted model,
        built once a fit: its arrays go to the device at construction and
        every ``decision_function`` / ``predict`` reuses them. A refit
        assigns new source arrays, which invalidates the cache by
        identity."""
        from repro_torch.serving import SVMScorer

        src = (self._weights, self._train_X, self._phi_arrays)
        if (self._scorer_cache is None
                or any(a is not b
                       for a, b in zip(self._scorer_cache[0], src))):
            self._scorer_cache = (src, SVMScorer(self.export_servable(),
                                                 device=self.device))
        return self._scorer_cache[1]

    def decision_function(self, X: np.ndarray) -> np.ndarray:
        """Margins as float32, (n,) or for MLT the (n, M) class scores,
        through ``scorer()``: the bucketed linear cell (X with the bias
        column and padding, times w), in phi-space and for the exact KRN
        model the Nystrom score cell (``nystrom_score``)."""
        if self._weights is None:
            raise RuntimeError("fit first")
        X = np.asarray(X, np.float32)
        if self._n_features is None:  # fits straight from fit_chunks
            self._n_features = X.shape[1]
        return self.scorer().margins(X)

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Labels in {+-1} (CLS), class ids (MLT) or the regression values
        f (SVR)."""
        f = self.decision_function(X)
        if self.config.task == "MLT":
            return np.argmax(f, axis=1)
        if self.config.task == "SVR":
            return f
        return np.where(f >= 0, 1, -1)

    def rmse(self, X: np.ndarray, y: np.ndarray) -> float:
        """Root-mean-square prediction error (SVR)."""
        if self.config.task != "SVR":
            raise ValueError("rmse is the SVR error metric")
        pred = self.predict(X)
        return float(np.sqrt(np.mean(
            (pred - np.asarray(y, np.float32)) ** 2)))

    def score(self, X: np.ndarray, y: np.ndarray) -> float:
        """Higher is better for every task: accuracy for CLS and MLT, the
        negated RMSE for SVR (``rmse`` gives the error itself)."""
        if self.config.task == "SVR":
            return -self.rmse(X, y)
        return float(np.mean(self.predict(X) == np.asarray(y)))


# The per-iteration diagnostics of each step, by (formulation, task): the
# class sweep reports the objective only, the exact KRN step no n_sv.
_AUX_KEYS = {("LIN", "CLS"): ("objective", "gamma_mean", "n_sv"),
             ("LIN", "MLT"): ("objective",),
             ("LIN", "SVR"): ("objective", "gamma_mean", "omega_mean"),
             ("KRN", "CLS"): ("objective", "gamma_mean")}


def _stacked(pairs: list) -> dict:
    """MLT's per-class (S, b) pairs as one (M, K, K) S and (M, K) b."""
    return {"S": torch.stack([S for S, _ in pairs]),
            "b": torch.stack([b for _, b in pairs])}


def _add_stats(a: dict, b: dict) -> dict:
    """The stream driver's sum of two chunk dicts, field by field."""
    return {k: a[k] + b[k] for k in a}


def _stream_fns(cfg: SVMConfig, phi) -> dict:
    """The stream driver's per-chunk bodies and its M-step (reference
    ``_stream_fns``): ``chunk`` maps one chunk to a dict of row-additive
    device tensors, ``mstep`` is the posterior solve or draw on the sums
    (for MLT also taking the class, with ``obj`` / ``obj_total`` the
    objective pass). ``phi`` is the featurizer pair in phi-space, else
    None."""
    common = dict(mode=cfg.algorithm, eps=cfg.eps, backend=cfg.backend,
                  phi=phi, phi_spec=cfg.phi_spec)
    if cfg.task == "MLT":
        def chunk(data, W, key, row0, y):
            return multiclass.mlt_class_chunk_stats(
                data, W, key, row0, y, num_classes=cfg.num_classes,
                rng=cfg.rng, chain0=cfg.chain0, **common)

        def mstep(W, S, b, key, y):
            L, mu = stats.posterior_params(S, b, cfg.lam, jitter=cfg.jitter)
            if cfg.algorithm == "EM":
                w_new = mu
            else:
                ky = prng.fold_in(key, y)
                if cfg.rng != "host":
                    ky = prng.fold_in(ky, cfg.chain0)
                w_new = stats.draw_weight(ky, L, mu)
            W = W.clone()
            W[y] = w_new
            return W

        def obj(data, W):
            return multiclass.mlt_chunk_obj(data, W, phi, cfg.phi_spec,
                                            cfg.backend)

        def obj_total(W, loss_sum):
            return objective.l2_reg(W, cfg.lam) + loss_sum

        return dict(chunk=chunk, mstep=mstep, obj=obj, obj_total=obj_total)

    chains = dict(rng=cfg.rng, n_chains=cfg.n_chains, chain0=cfg.chain0)
    if cfg.task == "SVR":
        def chunk(data, w, key, row0):
            return svr.svr_chunk_stats(data, w, key, row0,
                                       eps_ins=cfg.eps_ins, **common,
                                       **chains)
    else:
        def chunk(data, w, key, row0):
            return linear.cls_chunk_stats(data, w, key, row0, **common,
                                          **chains)

    def mstep(S, b, loss_sum, key):
        if cfg.n_chains > 1:
            # the chunk loss is already the cross-chain mean
            w_new = linear.multichain_draw(key, S, b, cfg.lam, cfg.jitter,
                                           cfg.chain0)
            return w_new, (objective.l2_reg(w_new, cfg.lam) / cfg.n_chains
                           + loss_sum)
        L, mu = stats.posterior_params(S, b, cfg.lam, jitter=cfg.jitter)
        if cfg.algorithm == "EM":
            w_new = mu
        elif cfg.rng == "host":
            w_new = stats.draw_weight(key, L, mu)
        else:
            w_new = stats.draw_weight(
                linear.chain_keys(key, cfg.chain0, 1)[0], L, mu)
        return w_new, objective.l2_reg(w_new, cfg.lam) + loss_sum

    return dict(chunk=chunk, mstep=mstep)


def _one_copy(*tensors: torch.Tensor) -> list:
    """The tensors copied to the host in one transfer, as float64 numpy
    arrays of their shapes (float32 values, counts and uint32 key words are
    exact in float64)."""
    flat = torch.cat([t.to(torch.float64).ravel() for t in tensors]
                     ).cpu().numpy()
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[i:i + n].reshape(tuple(t.shape)))
        i += n
    return out


def _next_key(key: torch.Tensor | None):
    """(key, sub): the reference's ``key, sub = jax.random.split(key)``;
    no key (EM) stays no key."""
    if key is None:
        return None, None
    k = prng.split(key)
    return k[0], k[1]
