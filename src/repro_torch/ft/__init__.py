"""`repro_torch.ft`: fault injection for serving and training.

`repro_torch.ft.chaos` - `FaultPlan`/`ChaosInjector` raising or stalling
at configured `repro_torch.serve.ServeEngine` pump rounds (transfer
failures, slow devices, per-tenant lane faults), with the typed error
ladder the engine retries or surfaces - and `repro_torch.ft.runner`:
the `Watchdog` over per-flush or per-step wall time, and the training
runner (`run_training`, `run_with_restarts`, `FailureInjector`) with
checkpoint resume.

Port of `repro.ft` without the fabric-level `FaultModel` (ROADMAP queue
A item 9).
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
from repro_torch.ft.runner import (
    FailureInjector,
    Watchdog,
    run_training,
    run_with_restarts,
)

__all__ = [
    "FAULT_KINDS",
    "ChaosError",
    "ChaosInjector",
    "ExecuteFault",
    "FailureInjector",
    "FaultEvent",
    "FaultPlan",
    "RetriesExhaustedError",
    "TransferFault",
    "TransientFaultError",
    "Watchdog",
    "run_training",
    "run_with_restarts",
]
