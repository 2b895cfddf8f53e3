"""Serving lifecycle errors, fault injection and supervised restart."""

from .failures import EngineSupervisor, HeartbeatMonitor, WorkerLostError
from .faults import (NULL_INJECTOR, Cancelled, DeadlineExceeded,
                     FaultInjector, RejectedError)

__all__ = ["Cancelled", "DeadlineExceeded", "EngineSupervisor",
           "FaultInjector", "HeartbeatMonitor", "NULL_INJECTOR",
           "RejectedError", "WorkerLostError"]
