"""Inter-chip router tier, as far as the flat single-chip fabric needs it.

Port of the flat-table parts of `repro.noc.hierarchy`: `chip_of_core` and
the zero branch of `chip_step_costs` / `chip_step_costs_events`.  The
two-tier `HierTables` (``chips > 1``) is ROADMAP queue A item 7;
sessions refuse multi-chip configs until then.
"""

from __future__ import annotations

import torch

from repro_torch.noc.router import NocTables


def chip_of_core(core: torch.Tensor, cores_per_chip: int):
    """Global core id -> (chip, local core) under the row-major chip split."""
    return core // cores_per_chip, core % cores_per_chip


def _zeros(tables, like: torch.Tensor):
    if not isinstance(tables, NocTables):
        raise NotImplementedError(
            "two-tier HierTables (chips > 1) are not ported yet: "
            "ROADMAP queue A item 7")
    z = torch.zeros(like.shape[:-1], dtype=torch.float32, device=like.device)
    return z, z, z


def chip_step_costs(tables, spikes_flat: torch.Tensor):
    """Per-tick inter-chip cost (chip_hops, chip_latency_ns, chip_energy),
    each (B,); all zeros on flat single-chip `NocTables`."""
    return _zeros(tables, spikes_flat)


def chip_step_costs_events(tables, ev_idx: torch.Tensor, ev_w: torch.Tensor):
    """Event-indexed `chip_step_costs`: zeros on flat single-chip tables."""
    return _zeros(tables, ev_w)
