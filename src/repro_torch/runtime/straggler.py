"""Straggler detection, the port's copy of ``repro/runtime/straggler.py``.

``StepTimeMonitor`` keeps an EMA of the step wall time; a step slower
than ``threshold`` x EMA is a straggler event. The drivers feed it once a
host sync (``core/solver.py``'s ``_FitRuntime.observe``); on a mesh the
ranks agree on each verdict, so every rank reacts to the same events. The
data-plane reaction is the live-weighted reduction (``stats.preduce``)
and the re-mesh from the last checkpoint (``runtime.elastic``,
``runtime.controller``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StepTimeMonitor:
    ema_decay: float = 0.9
    threshold: float = 2.5        # x EMA -> straggler
    warmup_steps: int = 5         # ignore first-step noise

    ema: float = 0.0
    n: int = 0
    events: list = dataclasses.field(default_factory=list)

    @classmethod
    def from_policy(cls, policy) -> "StepTimeMonitor":
        """Build from a ``runtime.policy.FaultPolicy``: the drivers'
        construction path."""
        return cls(threshold=policy.straggler_threshold,
                   warmup_steps=policy.straggler_warmup)

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler event."""
        self.n += 1
        if self.n <= self.warmup_steps:
            self.ema = seconds if self.ema == 0.0 else (
                0.5 * self.ema + 0.5 * seconds)
            return False
        is_straggler = seconds > self.threshold * self.ema
        if is_straggler:
            self.events.append((step, seconds, self.ema))
        else:
            # only healthy steps move the EMA (stragglers would poison it)
            self.ema = (self.ema_decay * self.ema
                        + (1 - self.ema_decay) * seconds)
        return is_straggler

    def summary(self) -> dict:
        return {"steps": self.n, "ema_s": self.ema,
                "straggler_events": len(self.events)}
