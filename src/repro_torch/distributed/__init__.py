"""The port of ``repro.distributed``: fault tolerance, and the data and
model axes across ranks (``collectives``, ``sharding``, ``compression``);
``hlo_analysis`` is a later item of ROADMAP.md."""

from repro_torch.distributed.fault_tolerance import (FailureInjector, Fault,
                                                     Heartbeat,
                                                     InjectedFault,
                                                     StragglerWatchdog,
                                                     failure_faults)

__all__ = ["FailureInjector", "Fault", "Heartbeat", "InjectedFault",
           "StragglerWatchdog", "failure_faults"]
