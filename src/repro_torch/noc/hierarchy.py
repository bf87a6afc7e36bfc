"""Hierarchical two-tier NoC: chip-local meshes + an inter-chip router level.

Port of `repro.noc.hierarchy`.  A fabric of ``chips x cores_per_chip``
cores: every chip runs the configured transport scheme over its own
``cores_per_chip``-core mesh, the chips sit on their own near-square
grid, and an event whose subscribers span chips travels an XY multicast
spanning tree over that grid (re-entering a remote chip at its router
port, local core 0).

`HierTables` carries `NocTables`' five data fields with their flat
semantics (the local fields summed over the chip meshes), so
`noc_router.noc_step_costs` and every registered ``cam_accounting``
policy take it unchanged, plus the inter-chip tier (``chip_hops``,
``chip_depth``, ``chip_link_table``), costed by `chip_step_costs` with
`ppa`'s ``CHIP_*`` constants.  Every table field is an exact integer
count; the per-tick costs sum exact small integers in float32, so every
reduction order gives the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import ppa
from repro_torch.interface import registry as interface_registry
from repro_torch.noc import multicast, topology
from repro_torch.noc.router import NocScheme, _latency, _multicast_link_loads


class HierTables(NamedTuple):
    """Precomputed two-tier routing tables (compile once, reuse per tick).

    The first five data fields mirror `NocTables`; the ``chip_*`` fields
    are the inter-chip tier.
    """

    scheme: str
    chips: int
    cores_per_chip: int
    subs: torch.Tensor             # (cores_total, S) bool subscriptions
    dest_counts: torch.Tensor      # (S,) int32 subscribed-core count
    hops: torch.Tensor             # (S,) int32 chip-local link traversals
    depth: torch.Tensor            # (S,) int32 deepest chip-local path
    link_table: torch.Tensor       # (S, chips * L_local) float32
    chip_hops: torch.Tensor        # (S,) int32 inter-chip link traversals
    chip_depth: torch.Tensor       # (S,) int32 deepest inter-chip path
    chip_link_table: torch.Tensor  # (S, L_chip) float32 per-chip-link events


def chip_of_core(core: torch.Tensor, cores_per_chip: int):
    """Global core id -> (chip, local core) under the row-major chip split."""
    return core // cores_per_chip, core % cores_per_chip


def build_hier_tables(tags: torch.Tensor, valid: torch.Tensor, *, chips: int,
                      cores_per_chip: int, neurons_per_core: int,
                      tag_bits: int,
                      scheme: str = "multicast_tree") -> HierTables:
    """Two-tier routing tables from the CAM state (cf. `router.build_tables`).

    The configured scheme governs each chip-local mesh; the inter-chip
    tier always routes one copy along the XY spanning tree over the
    destination chips.  The JAX package maps the chip-local tier over
    chips with `vmap`; here it is a loop over chips, each step the same
    whole-tensor policy calls.
    """
    entry: NocScheme = interface_registry.get_noc_scheme(scheme)
    dev = tags.device
    cores_total = chips * cores_per_chip
    subs = multicast.subscription_matrix(tags, valid, cores_total,
                                         neurons_per_core, tag_bits)
    dmask = subs.T                                             # (S, C_total)
    total = cores_total * neurons_per_core
    src_core = torch.arange(total, dtype=torch.int32,
                            device=dev) // neurons_per_core
    src_chip, src_local = chip_of_core(src_core, cores_per_chip)

    # physically routed destinations (broadcast widens to every core)
    routed = entry.expand_dests(dmask, cores_total)            # (S, C_total)
    routed_c = routed.reshape(-1, chips, cores_per_chip)

    # ---- inter-chip tier: XY tree over the chip grid ----------------------
    chip_ids = torch.arange(chips, device=dev)
    chip_mask = routed_c.any(-1)                               # (S, chips)
    remote = chip_mask & (chip_ids[None, :] != src_chip[:, None])
    chip_hops = multicast.multicast_tree_hops(remote, src_chip, chips)
    chip_link_table = _multicast_link_loads(remote, src_chip, chips)
    chip_hopmat = topology.hop_matrix(chips, dev)
    chip_depth = torch.where(remote, chip_hopmat[src_chip], 0).amax(-1).to(
        torch.int32)

    # ---- chip-local tier: the configured scheme on every chip's mesh ------
    # On a remote chip the event is re-injected at the router port (local
    # core 0); on the source chip it starts at the source core itself.
    local_hopmat = topology.hop_matrix(cores_per_chip, dev)
    hops = torch.zeros(total, dtype=torch.int32, device=dev)
    depth = torch.zeros(total, dtype=torch.int32, device=dev)
    loads = []
    for k in range(chips):
        mask = routed_c[:, k]                                  # (S, cpc)
        src = torch.where(src_chip == k, src_local, 0).to(torch.int32)
        hops = hops + entry.hops(mask, src, cores_per_chip)
        loads.append(entry.link_loads(mask, src, cores_per_chip))
        routed_k = entry.expand_dests(mask, cores_per_chip)
        depth = torch.maximum(depth, torch.where(
            routed_k, local_hopmat[src], 0).amax(-1).to(torch.int32))

    return HierTables(
        scheme=scheme, chips=chips, cores_per_chip=cores_per_chip,
        subs=subs, dest_counts=dmask.sum(-1).to(torch.int32),
        hops=hops.to(torch.int32), depth=depth,
        link_table=torch.cat(loads, dim=-1),
        chip_hops=chip_hops, chip_depth=chip_depth,
        chip_link_table=chip_link_table)


def _zeros(like: torch.Tensor):
    z = torch.zeros(like.shape[:-1], dtype=torch.float32, device=like.device)
    return z, z, z


def _costs(hops, depth, loads):
    latency = _latency(depth, loads, ppa.CHIP_HOP_LATENCY_NS,
                       ppa.CHIP_LINK_SERIALIZATION_NS)
    return hops, latency, hops * ppa.CHIP_HOP_ENERGY


def chip_step_costs(tables, spikes_flat: torch.Tensor):
    """Per-tick inter-chip cost (chip_hops, chip_latency_ns, chip_energy),
    each (B,), from (B, S) spikes; all zeros for flat single-chip tables
    (`NocTables`)."""
    if not isinstance(tables, HierTables):
        return _zeros(spikes_flat)
    ev = spikes_flat.to(torch.float32)
    hops = (ev * tables.chip_hops).sum(-1)
    loads = (ev[..., None] * tables.chip_link_table).sum(-2)   # (B, L_chip)
    depth = torch.where(spikes_flat > 0, tables.chip_depth, 0).amax(-1)
    return _costs(hops, depth.to(torch.float32), loads)


def chip_step_costs_events(tables, ev_idx: torch.Tensor, ev_w: torch.Tensor):
    """Event-indexed `chip_step_costs` for the sparse tick: gathers the
    per-source chip-tier columns at the tick's events (``ev_idx``/``ev_w``
    as in `router.noc_step_costs_events`); exact integer sums give the
    dense form's bits.  Zeros for flat single-chip tables."""
    if not isinstance(tables, HierTables):
        return _zeros(ev_w)
    hops = (ev_w * tables.chip_hops[ev_idx]).sum(-1)
    loads = (ev_w[..., None] * tables.chip_link_table[ev_idx]).sum(-2)
    depth = (ev_w * tables.chip_depth[ev_idx].to(torch.float32)).amax(-1)
    return _costs(hops, depth, loads)


__all__ = ["HierTables", "build_hier_tables", "chip_step_costs",
           "chip_step_costs_events", "chip_of_core"]
