"""The port of ``repro.distributed``: fault tolerance, and the data axis
across ranks (``collectives``, ``sharding``, ``compression``); the model
axis and ``hlo_analysis`` are later items of ROADMAP.md."""

from repro_torch.distributed.fault_tolerance import (FailureInjector, Fault,
                                                     Heartbeat,
                                                     InjectedFault,
                                                     StragglerWatchdog,
                                                     failure_faults)

__all__ = ["FailureInjector", "Fault", "Heartbeat", "InjectedFault",
           "StragglerWatchdog", "failure_faults"]
