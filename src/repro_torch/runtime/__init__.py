"""Runtime control plane, the port's copy of ``repro/runtime``: the fault
policy, straggler detection, elastic re-meshing, the fleet supervisor
that owns worker lifecycles (with lease-based leader election for several
controllers on one checkpoint directory), and the deterministic fault
injectors that prove the recovery paths work."""
from .controller import (AttemptCancelled, AttemptRecord,  # noqa: F401
                         FleetController, FleetError, FleetPolicy,
                         FleetResult, HostContext, HostDied,
                         LeadershipLost, SubprocessHost)
from .elastic import remesh, scale_batch_schedule  # noqa: F401
from .faults import (FleetSchedule, SimulatedPreemption,  # noqa: F401
                     SimulatedTermination, compose_hooks, delay_chunks,
                     delay_iterations, freezable_sleep, hang_at_iteration,
                     hold_at_iteration, io_error_every_nth,
                     kill_after_chunks, kill_at_iteration, tear_file,
                     terminate_at_iteration)
from .lease import (LeaseLost, LeaseManager, LeasePolicy,  # noqa: F401
                    LeaseState)
from .policy import FaultPolicy, StragglerError  # noqa: F401
from .straggler import StepTimeMonitor  # noqa: F401
