"""`repro_torch.serve`: multi-tenant streaming over the interface fabric.

Port of `repro.serve`: tenants (`TenantSpec`) each bring an
`InterfaceConfig` and a `repro_torch.traffic` tick stream; the
`ServeEngine` packs compatible tenants onto shared precompiled
`InterfaceSession`s and steps each group as one masked ``run_batched``
over the lane axis, with micro-batched ingest (`IngestQueue`), capacity
limits and typed rejection errors (`AdmissionPolicy`), per-tenant
`repro_torch.obs` metrics, bounded retries (`RetryPolicy`), a per-lane
health state machine (`HealthPolicy` / `HealthTracker`), deadline
shedding, host-layer fault injection (`ServeEngine(chaos=...)`), a
background pump (`ServeEngine.start`/`stop`), autoscaling lane
capacities (`AutoscalePolicy`) and per-tenant token-bucket rate limiting
(`RateLimitedError`).  It serves on the card unless the caller passes
``device="cpu"``.  Tenants may compile a fabric `FaultModel` into their
session (``TenantSpec(fault=...)``) and step through the per-chip
sharded tick (``TenantSpec(shard="chips")`` on a multi-chip config).

The LM prefill/decode loop lives in `repro_torch.serve.lm_engine`; its
`ServeEngine` is a different class from the fabric engine exported here.
"""

from repro_torch.interface.session import CompositionError
from repro_torch.serve.admission import (
    AdmissionController,
    AdmissionError,
    AdmissionPolicy,
    DeadlineExceededError,
    FrameValidationError,
    QueueOverflowError,
    RateLimitedError,
    ServeError,
    TokenBucket,
    validate_frames,
)
from repro_torch.serve.engine import (
    AutoscalePolicy,
    ServeEngine,
    TenantGroup,
    group_key,
)
from repro_torch.serve.health import (
    HealthPolicy,
    HealthTracker,
    LaneState,
    RetryPolicy,
)
from repro_torch.serve.queue import IngestQueue, TickRequest
from repro_torch.serve.tenant import TenantSpec, compat_key, default_connectivity

__all__ = [
    "AdmissionController",
    "AdmissionError",
    "AdmissionPolicy",
    "AutoscalePolicy",
    "CompositionError",
    "DeadlineExceededError",
    "FrameValidationError",
    "HealthPolicy",
    "HealthTracker",
    "IngestQueue",
    "LaneState",
    "QueueOverflowError",
    "RateLimitedError",
    "RetryPolicy",
    "ServeEngine",
    "ServeError",
    "TenantGroup",
    "TenantSpec",
    "TickRequest",
    "TokenBucket",
    "compat_key",
    "default_connectivity",
    "group_key",
    "validate_frames",
]
