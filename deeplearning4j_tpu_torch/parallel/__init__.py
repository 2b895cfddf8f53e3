"""Serving lifecycle errors, fault injection, supervised restart, the
preemption drains and single-card parallel inference."""

from .failures import (EngineSupervisor, HeartbeatMonitor,
                       PreemptionHandler, WorkerLostError, run_elastic)
from .faults import (NULL_INJECTOR, Cancelled, DeadlineExceeded,
                     FaultInjector, RejectedError)
from .inference import InferenceMode, ParallelInference
# the SERVING drain handler, exported under a distinct name as in the JAX
# package: failures.PreemptionHandler (training checkpoint-on-SIGTERM)
# keeps its name
from .preemption import DrainReport
from .preemption import PreemptionHandler as ServingPreemptionHandler

__all__ = ["Cancelled", "DeadlineExceeded", "DrainReport",
           "EngineSupervisor", "FaultInjector", "HeartbeatMonitor",
           "InferenceMode", "NULL_INJECTOR", "ParallelInference",
           "PreemptionHandler", "RejectedError", "ServingPreemptionHandler",
           "WorkerLostError", "run_elastic"]
