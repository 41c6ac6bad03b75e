"""Checkpoint payload for preemption-safe fits (DESIGN.md §Reliability),
the port's copy of ``repro/core/resume.py``: the same arrays, dtypes and
meta keys, so a snapshot either package writes resumes in the other.

The E-step statistics are exact sums over rows and the MC chain is keyed
per global row, so a fit's whole resumable state is O(K^2), never O(N):

  arrays   state (K,)/(M,K)/(C,K) float32, the key chain's carry key as
           its two uint32 words (the port's keys are int64 tensors of
           those words, ``core/prng.py``), the float64 MC sample sum
           (= mean * n_avg, driver-independent), and for a MID-PASS
           stream snapshot the iteration subkey plus the partial chunk
           totals (tot_*); with decayed warm-start statistics the frozen
           donor (S, b) (prev_*); with a windowed warm start the whole
           hard-expiry ring (win{i}_*, ``stats.StatsWindow.pack``).
  meta     scalar loop state: completed iterations, histories, stopping
           counters, the chunk cursor, and the config FINGERPRINT (the
           semantic fields that must match for the resumed trajectory to
           be the uninterrupted one).

Driver and layout fields (driver, scan_chunk, chunk_rows, prefetch,
backend, mesh axes, reduce dtype and packing, the fault policy) are
outside the fingerprint: a snapshot written by ``driver="stream"`` on one
mesh restores into ``driver="scan"`` on another, since every excluded
field only re-associates the same exact sums. A mid-pass snapshot's
chunk cursor is meaningful only for a stream fit with the same
chunk_rows (checked at restore).

Step numbering: ``step = it * 1_000_000 + chunk_idx``, so boundary and
mid-pass snapshots share one monotonic axis; under several controllers
each attempt also carries a fence epoch (``fit(..., epoch=)``), and
snapshots order epoch-major.
"""
from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer

from .stats import StatsWindow

_MIDPASS_STRIDE = 1_000_000

# Fields whose values change the fit trajectory itself (as opposed to its
# schedule or layout). max_iters is excluded on purpose: resuming with a
# larger budget is how a preempted fit is extended. rng / n_chains /
# chain0 are semantic: they select which counter stream the chain reads.
_SEMANTIC_FIELDS = (
    "formulation", "algorithm", "task", "lam", "eps", "eps_ins",
    "num_classes", "kernel", "sigma", "min_iters", "patience", "tol",
    "burnin", "jitter", "add_bias", "seed", "pad_features", "decay",
    "window", "rng", "n_chains", "chain0",
)


def config_fingerprint(cfg) -> str:
    vals = {f: getattr(cfg, f) for f in _SEMANTIC_FIELDS}
    vals["phi_spec"] = repr(cfg.phi_spec) if cfg.phi_spec else None
    return json.dumps(vals, sort_keys=True)


def step_id(it: int, chunk_idx: int = 0) -> int:
    assert 0 <= chunk_idx < _MIDPASS_STRIDE, chunk_idx
    return it * _MIDPASS_STRIDE + chunk_idx


def _host(x) -> np.ndarray:
    """A host array of a tensor (on any device) or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def key_words(key) -> np.ndarray:
    """A key as the reference stores it: its two uint32 words."""
    return _host(key).astype(np.uint32)


def key_tensor(words, device=None) -> torch.Tensor:
    """The port's key (an int64 tensor of the words) of stored words."""
    return torch.from_numpy(np.asarray(words).astype(np.int64)).to(device)


def save_snapshot(ckpt: Checkpointer, cfg, *, it: int, state, key,
                  samp_sum, n_avg: int, n_small: int, objs: list,
                  aux_hist: dict, n_syncs: int, converged: bool = False,
                  prev_stats: dict | None = None,
                  window_stats: list | None = None,
                  sub=None, totals: dict | None = None,
                  chunk_idx: int = 0, row0: int = 0,
                  blocking: bool = False) -> int:
    """Commit one resume point; returns its step id. Tensors are copied to
    the host here; the write goes on the checkpointer's thread.

    ``it`` is the number of COMPLETED iterations; ``sub``/``totals``
    present make this a mid-pass stream snapshot of iteration it + 1,
    with ``chunk_idx`` chunks already folded into ``totals``.
    """
    in_pass = totals is not None
    arrays: dict[str, Any] = {
        "state": _host(state).astype(np.float32),
        "key": key_words(key),
        "samp_sum": np.asarray(samp_sum, np.float64),
    }
    if in_pass:
        arrays["sub"] = key_words(sub)
        for k, v in totals.items():
            arrays[f"tot_{k}"] = _host(v)
    if prev_stats is not None:
        for k, v in prev_stats.items():
            arrays[f"prev_{k}"] = _host(v)
    if window_stats:
        arrays.update(StatsWindow.pack(window_stats))
    meta = {
        "fingerprint": config_fingerprint(cfg),
        "it": int(it),
        "n_avg": int(n_avg),
        "n_small": int(n_small),
        "objs": [float(v) for v in objs],
        "aux": {k: [float(x) for x in v] for k, v in aux_hist.items()},
        "n_syncs": int(n_syncs),
        "converged": bool(converged),
        "in_pass": bool(in_pass),
        "chunk_idx": int(chunk_idx),
        "row0": int(row0),
        "chunk_rows": int(cfg.chunk_rows),
    }
    step = step_id(it + 1 if in_pass else it, chunk_idx if in_pass else 0)
    ckpt.save(step, arrays, meta=meta, blocking=blocking)
    return step


def load_snapshot(ckpt: Checkpointer, step: int | None = None) -> dict:
    """Flat payload dict: meta scalars + 'state'/'key'/'samp_sum' host
    arrays, plus 'sub'/'totals'/'prev_stats'/'window_stats' when present
    (None otherwise)."""
    arrays, manifest = ckpt.restore_named(step)
    meta = manifest["meta"]
    payload = dict(meta)
    payload["step"] = manifest["step"]
    # The attempt epoch the snapshot was committed under (0 for unfenced
    # writers): attempt lineage, not problem semantics, so outside the
    # fingerprint.
    payload["epoch"] = int(manifest.get("epoch", 0))
    payload["state"] = arrays["state"]
    payload["key"] = arrays["key"]
    payload["samp_sum"] = arrays["samp_sum"]
    payload["sub"] = arrays.get("sub")
    totals = {k[len("tot_"):]: v for k, v in arrays.items()
              if k.startswith("tot_")}
    payload["totals"] = totals or None
    prev = {k[len("prev_"):]: v for k, v in arrays.items()
            if k.startswith("prev_")}
    payload["prev_stats"] = prev or None
    payload["window_stats"] = StatsWindow.unpack(arrays) or None
    return payload


def check_compatible(payload: dict, cfg) -> None:
    fp = config_fingerprint(cfg)
    if payload["fingerprint"] != fp:
        theirs = json.loads(payload["fingerprint"])
        ours = json.loads(fp)
        diff = sorted(k for k in ours
                      if ours[k] != theirs.get(k, object()))
        raise ValueError(
            "checkpoint was written by a semantically different config; "
            f"mismatched fields: {diff} — resume requires the same "
            "problem (driver/mesh/chunking MAY differ, these may not)")
    if payload["in_pass"]:
        if cfg.driver != "stream":
            raise ValueError(
                "mid-pass checkpoint (partial chunk totals) can only "
                f"resume into driver='stream', not {cfg.driver!r}; pick "
                "an iteration-boundary step (Checkpointer.all_steps) "
                "for cross-driver resume")
        if payload["chunk_rows"] != cfg.chunk_rows:
            raise ValueError(
                "mid-pass checkpoint's chunk cursor was written at "
                f"chunk_rows={payload['chunk_rows']}, current config "
                f"has {cfg.chunk_rows}; the skip count would land "
                "mid-chunk — match chunk_rows or resume from a "
                "boundary step")
