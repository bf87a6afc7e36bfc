"""`repro_torch.ft`: the serving tier's host-layer fault injection.

`repro_torch.ft.chaos` - `FaultPlan`/`ChaosInjector` raising or stalling
at configured `repro_torch.serve.ServeEngine` pump rounds (transfer
failures, slow devices, per-tenant lane faults), with the typed error
ladder the engine retries or surfaces - and `repro_torch.ft.runner`'s
`Watchdog` over per-flush wall time.

Port of `repro.ft` without the fabric-level `FaultModel` (ROADMAP queue
A item 9) and the training runner (item 11).
"""

from repro_torch.ft.chaos import (
    FAULT_KINDS,
    ChaosError,
    ChaosInjector,
    ExecuteFault,
    FaultEvent,
    FaultPlan,
    RetriesExhaustedError,
    TransferFault,
    TransientFaultError,
)
from repro_torch.ft.runner import Watchdog

__all__ = [
    "FAULT_KINDS",
    "ChaosError",
    "ChaosInjector",
    "ExecuteFault",
    "FaultEvent",
    "FaultPlan",
    "RetriesExhaustedError",
    "TransferFault",
    "TransientFaultError",
    "Watchdog",
]
