"""Per-tick interface cost record with streaming accumulation.

Port of `repro.interface.stats`.  Every field is a float32 tensor of one
shape: ``()`` for a single stream, ``(B,)`` for a batch of streams.
Latency fields are per-tick quantities; accumulating sums them like
everything else, so ``summary(ticks=T)`` reports the mean per tick.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class StepStats(NamedTuple):
    """Per-tick (or accumulated) interface cost record."""

    events: torch.Tensor            # total address events this tick
    encode_latency: torch.Tensor    # max grant latency (units)
    encode_energy: torch.Tensor     # address-line toggles
    cam_searches: torch.Tensor      # CAM search operations
    cam_energy: torch.Tensor        # CAM model energy units
    cam_time_ns: torch.Tensor       # serialized CAM search time
    noc_hops: torch.Tensor          # chip-local mesh link traversals
    noc_latency: torch.Tensor       # chip-local delivery latency (ns)
    noc_energy: torch.Tensor        # chip-local NoC energy (units)
    chip_hops: torch.Tensor         # inter-chip link traversals (0: one chip)
    chip_latency: torch.Tensor      # inter-chip delivery latency (ns)
    chip_energy: torch.Tensor       # inter-chip energy (model units)

    @classmethod
    def zeros(cls, shape=(), device=None) -> "StepStats":
        """The additive identity: every field a float32 zero of ``shape``."""
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return cls(*([z] * len(cls._fields)))

    def accumulate(self, other: "StepStats") -> "StepStats":
        """Elementwise running sum (the tick loop's carry)."""
        return StepStats(*(a + b for a, b in zip(self, other)))

    def mean(self, ticks) -> "StepStats":
        """Per-tick means of an accumulated record.

        ``ticks`` must be a positive tick count: dividing by zero would
        silently turn every field into inf/nan, so that raises instead.
        """
        ticks_f = float(ticks)
        if not math.isfinite(ticks_f) or ticks_f <= 0:
            raise ValueError(
                f"ticks must be a positive tick count, got {ticks!r}; "
                f"a zero-tick mean would silently report inf/nan")
        d = torch.tensor(ticks_f, dtype=torch.float32)
        return StepStats(*(a / d.to(a.device) for a in self))

    def summary(self, ticks=None) -> dict:
        """Plain-float dict: totals, or per-tick means when `ticks` given."""
        rec = self if ticks is None else self.mean(ticks)
        return {k: float(v) for k, v in rec._asdict().items()}
