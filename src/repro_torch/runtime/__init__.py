"""Run-time policy of a fit. Only ``FaultPolicy``'s loader-retry fields
are read so far (the stream driver's ``retrying_chunks``); checkpoints,
the straggler monitor and the fleet controller are ROADMAP queue 1 item
11."""
from .policy import FaultPolicy  # noqa: F401
