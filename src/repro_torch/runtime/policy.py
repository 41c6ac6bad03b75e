"""FaultPolicy: the reliability settings a fit carries, the port's copy of
``repro/runtime/policy.py`` (the dataclass and its defaults only).

The stream driver reads the loader-retry fields: a default policy retries
a failing chunk source ``loader_retries = 3`` times with exponential
backoff (``data.pipeline.retrying_chunks``), so every stream fit runs
through the retry wrapper even with ``SVMConfig.fault`` left at None.
The checkpoint and straggler fields keep the reference's names and
defaults; the code that reads them (and ``SVMConfig.fault`` itself) is
ROADMAP queue 1 item 11.
"""
from __future__ import annotations

import dataclasses

ON_STRAGGLER = ("record", "drop", "raise")


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Reliability policy for a fit, with the reference's defaults;
    ``ckpt_dir=None`` disables checkpointing."""

    ckpt_dir: str | None = None     # directory for snapshots (None = off)
    ckpt_every: int = 10            # iterations between boundary snapshots
    ckpt_chunks: int = 0            # stream: also snapshot every n chunks
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
