"""Fault tolerance of the port (``repro.distributed``); multi-device comes
later (ROADMAP.md, multi-device)."""

from repro_torch.distributed.fault_tolerance import (FailureInjector, Fault,
                                                     Heartbeat,
                                                     InjectedFault,
                                                     StragglerWatchdog,
                                                     failure_faults)

__all__ = ["FailureInjector", "Fault", "Heartbeat", "InjectedFault",
           "StragglerWatchdog", "failure_faults"]
