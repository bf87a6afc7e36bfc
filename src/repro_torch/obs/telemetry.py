"""Telemetry records of `InterfaceSession` runs.

Port of `repro.obs.telemetry`.  A session run normally returns only the
accumulated `StepStats`.  The ``telemetry=`` knob of ``run`` /
``run_batched`` adds richer records:

``"off"``
    ``(currents, accumulated StepStats)``, as always.
``"ticks"``
    also the per-tick `StepStats`: ``(currents, accumulated,
    TickTelemetry)``, every field of ``TickTelemetry.per_tick`` with a
    leading ``(T,)`` axis (``(B, T)`` under ``run_batched``); summed over
    ticks in order it gives the accumulated record.
``"cores"``
    also per-core breakdowns (`CoreStats`): events, arbiter grant
    latency, AER encode energy, and NoC/chip hops attributed to each
    event's source core, each ``(T, cores)``.  They sum (latency: max)
    back to the per-tick totals.

Currents and accumulated stats are the same bits in every mode:
telemetry only adds outputs.  The summarising helpers (`percentiles`,
`to_records`) run on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.interface.stats import StepStats
from repro_torch.obs import metrics as obs_metrics

TELEMETRY_MODES = ("off", "ticks", "cores")


def validate_mode(mode: str) -> str:
    if mode not in TELEMETRY_MODES:
        raise ValueError(
            f"unknown telemetry mode {mode!r}; expected one of "
            f"{', '.join(repr(m) for m in TELEMETRY_MODES)}"
        )
    return mode


class CoreStats(NamedTuple):
    """Per-core slice of one tick's accounting (fields ``(..., cores)``).

    Invariants against the per-tick `StepStats`: ``events`` sums to
    ``events`` exactly; ``encode_latency``'s max is ``encode_latency``;
    ``encode_energy``, ``noc_hops`` and ``chip_hops`` sum to theirs (hops
    are attributed to each event's *source* core).
    """

    events: torch.Tensor          # spikes serviced per core
    encode_latency: torch.Tensor  # arbiter grant completion (units)
    encode_energy: torch.Tensor   # address-line toggles
    noc_hops: torch.Tensor        # mesh links used by this core's events
    chip_hops: torch.Tensor       # inter-chip links (zero when chips=1)


class TickTelemetry(NamedTuple):
    """Per-tick `StepStats` series (every field with a ``(T,)`` axis)."""

    per_tick: StepStats

    @property
    def ticks(self) -> int:
        return int(self.per_tick.events.shape[-1])

    def series(self, field: str) -> torch.Tensor:
        """One field's per-tick series."""
        return getattr(self.per_tick, field)

    def percentiles(self, field: str, qs=(50, 95, 99)) -> dict:
        """p50/p95/p99 (by default) of one field across ticks."""
        values = self.series(field).reshape(-1).tolist()
        return obs_metrics.percentiles(values, qs)

    def to_records(self) -> list:
        """JSONL-ready dicts, one per tick (batched runs flatten B x T)."""
        flat = {k: v.reshape(-1).tolist()
                for k, v in self.per_tick._asdict().items()}
        return [{k: float(v[t]) for k, v in flat.items()}
                for t in range(len(flat["events"]))]


class CoreTelemetry(NamedTuple):
    """`TickTelemetry` plus per-core breakdowns (`CoreStats`, ``(T, cores)``)."""

    per_tick: StepStats
    per_core: CoreStats

    @property
    def ticks(self) -> TickTelemetry:
        return TickTelemetry(per_tick=self.per_tick)

    def core_totals(self) -> CoreStats:
        """Per-core sums over the run (latency: per-core max, not sum)."""
        c = self.per_core
        return CoreStats(events=c.events.sum(-2),
                         encode_latency=c.encode_latency.amax(-2),
                         encode_energy=c.encode_energy.sum(-2),
                         noc_hops=c.noc_hops.sum(-2),
                         chip_hops=c.chip_hops.sum(-2))


__all__ = [
    "TELEMETRY_MODES",
    "validate_mode",
    "CoreStats",
    "TickTelemetry",
    "CoreTelemetry",
]
