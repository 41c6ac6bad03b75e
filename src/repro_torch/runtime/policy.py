"""FaultPolicy: the reliability settings a fit carries, the port's copy of
``repro/runtime/policy.py``.

The policy rides on ``SVMConfig.fault`` (frozen, so the config stays
hashable) and tells the drivers how to react:

  * checkpoint cadence: a boundary snapshot every ``ckpt_every``
    iterations, and with the stream driver also every ``ckpt_chunks``
    chunks inside a pass, through ``repro_torch.checkpoint.Checkpointer``
    (``core/resume.py``); snapshots hold O(K^2) statistics, never O(N)
    data;
  * loader retry with exponential backoff
    (``data.pipeline.retrying_chunks``): a default policy retries a
    failing chunk source ``loader_retries = 3`` times, so every stream fit
    runs through the retry wrapper even with ``SVMConfig.fault`` at None;
  * straggler detection (``runtime.straggler.StepTimeMonitor``) and the
    reaction ``on_straggler``: ``"record"`` events into the FitResult,
    ``"drop"`` the shards ``PEMSVM.report_slow_shard`` named out of the
    live-weighted reduction (``stats.preduce``), or ``"raise"`` a
    ``StragglerError`` for an outer controller to resume from the last
    checkpoint (``runtime.controller``).
"""
from __future__ import annotations

import dataclasses

ON_STRAGGLER = ("record", "drop", "raise")


class StragglerError(RuntimeError):
    """Raised by the drivers when ``on_straggler="raise"`` and a step
    exceeds the monitor's threshold: the signal for an outer controller to
    stop the fit and resume it from the last committed checkpoint on a
    healthy mesh (``PEMSVM.fit(..., resume_from=...)``)."""


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Reliability policy for a fit, with the reference's defaults;
    ``ckpt_dir=None`` disables checkpointing."""

    ckpt_dir: str | None = None     # directory for snapshots (None = off)
    ckpt_every: int = 10            # iterations between boundary snapshots
    ckpt_chunks: int = 0            # stream: also snapshot every n chunks
    #                                 mid-pass (0 = boundary-only)
    keep_k: int = 3                 # committed checkpoints retained on disk
    loader_retries: int = 3         # consecutive loader failures tolerated
    loader_backoff: float = 0.05    # base seconds; doubles per retry
    loader_jitter: float = 0.0      # backoff *= 1 + jitter * U[0, 1), the
    #                                 draw keyed on SVMConfig.seed
    straggler_threshold: float = 2.5  # x EMA -> straggler event
    straggler_warmup: int = 5       # steps ignored
    on_straggler: str = "record"    # record | drop | raise

    def __post_init__(self):
        assert self.ckpt_every >= 1, self.ckpt_every
        assert self.ckpt_chunks >= 0, self.ckpt_chunks
        assert self.keep_k >= 1, self.keep_k
        assert self.loader_retries >= 0, self.loader_retries
        assert self.loader_backoff >= 0.0, self.loader_backoff
        assert self.loader_jitter >= 0.0, self.loader_jitter
        assert self.straggler_threshold > 1.0, self.straggler_threshold
        assert self.on_straggler in ON_STRAGGLER, self.on_straggler

    @property
    def checkpoints_enabled(self) -> bool:
        return self.ckpt_dir is not None
