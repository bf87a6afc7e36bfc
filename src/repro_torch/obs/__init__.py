"""`repro_torch.obs` - observability for the port's serving tier.

  `repro_torch.obs.trace`    host-side span tracing -> Chrome-trace JSON,
                             aligned with `torch.profiler` timelines via
                             `torch.profiler.record_function`
  `repro_torch.obs.metrics`  counters, streaming p50/p95/p99 histograms,
                             JSONL sink
  `repro_torch.obs.report`   ``python -m repro_torch.obs.report``
                             per-tier (arbiter/CAM/NoC/chip) tables
  `repro_torch.obs.telemetry` the session's ``telemetry=`` records
                             (per-tick and per-core series)

Port of `repro.obs`.
"""

from __future__ import annotations

# `report` is deliberately NOT imported eagerly: it is a ``python -m``
# entry point, and importing it from the package would make runpy warn
# about the module already being in sys.modules when invoked as a CLI.
from repro_torch.obs import metrics, telemetry, trace  # noqa: F401
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Histogram,
    JsonlSink,
    MetricsRegistry,
    percentiles,
)
from repro_torch.obs.telemetry import (  # noqa: F401
    TELEMETRY_MODES,
    CoreStats,
    CoreTelemetry,
    TickTelemetry,
)
from repro_torch.obs.trace import Tracer, active_tracer, span  # noqa: F401

__all__ = [
    "metrics",
    "telemetry",
    "trace",
    "TELEMETRY_MODES",
    "CoreStats",
    "CoreTelemetry",
    "TickTelemetry",
    "Counter",
    "Histogram",
    "JsonlSink",
    "MetricsRegistry",
    "percentiles",
    "Tracer",
    "active_tracer",
    "span",
]
