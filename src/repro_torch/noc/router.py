"""Mesh router model: per-link event loads, contention latency, energy.

Port of `repro.noc.router`.  `build_tables` precomputes, from the CAM
routing tables alone, everything the per-tick accounting needs:

  dest_counts (S,)    cores subscribed to each source  -> CAM search count
  hops        (S,)    mesh links traversed per event under the NoC scheme
  depth       (S,)    deepest source->destination path -> traversal latency
  link_table  (S, L)  events injected on each physical link per source spike

Per-tick costs reduce exact small integers in float32, so every
reduction order gives the same bits; the products are written as
elementwise multiply-and-sum rather than matmuls so no TF32 setting can
touch them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core import ppa
from repro_torch.interface import registry as interface_registry
from repro_torch.noc import multicast, topology


class NocTables(NamedTuple):
    scheme: str
    subs: torch.Tensor          # (cores, S) bool subscription matrix
    dest_counts: torch.Tensor   # (S,) int32 subscribed-core count
    hops: torch.Tensor          # (S,) int32 link traversals per event
    depth: torch.Tensor         # (S,) int32 deepest path per event
    link_table: torch.Tensor    # (S, L) float32 per-link events per spike


@dataclasses.dataclass(frozen=True)
class NocScheme:
    """Registry entry: the transport policy of one NoC scheme.

    The callables take and return torch tensors with the shapes of
    `repro.noc.router.NocScheme`; ``cam_accounting`` and
    ``sparse_cam_accounting`` take a leading batch axis on their per-tick
    arguments (``spikes_flat`` (B, S), ``ev_idx``/``ev_w`` (B, events),
    ``total_events`` (B,)) and return (B,) tensors.
    """

    name: str
    expand_dests: Callable
    hops: Callable
    link_loads: Callable
    cam_accounting: Callable
    sparse_cam_accounting: Callable | None = None


def _flatten_links(h_inc: torch.Tensor, v_inc: torch.Tensor) -> torch.Tensor:
    """(S, H, W-1) + (S, H-1, W) -> (S, L) in topology link order."""
    s = h_inc.shape[0]
    return torch.cat([h_inc.reshape(s, -1), v_inc.reshape(s, -1)], dim=-1)


def _unicast_link_loads(dest_mask: torch.Tensor, src_core: torch.Tensor,
                        cores: int) -> torch.Tensor:
    """One routed copy per destination on every link of its XY path."""
    dev = dest_mask.device
    w, h = topology.mesh_dims(cores)
    xy = topology.core_coords(cores, dev)
    dx, dy = xy[:, 0], xy[:, 1]
    sx, sy = xy[src_core, 0], xy[src_core, 1]                  # (S,)
    m = dest_mask.to(torch.float32)                            # (S, C)

    rows = torch.arange(h, device=dev)
    cols_h = torch.arange(max(w - 1, 0), device=dev)
    rows_v = torch.arange(max(h - 1, 0), device=dev)
    cols = torch.arange(w, device=dev)

    on_col = (dx[:, None] == cols[None, :]).to(torch.float32)  # (C, W)
    cnt_w = (m[:, :, None] * on_col[None]).sum(1)              # (S, W)
    at = ((dx[:, None] == cols[None, :])[:, :, None] &
          (dy[:, None] == rows[None, :])[:, None, :])          # (C, W, H)
    cnt_wy = (m[:, :, None, None] * at.to(torch.float32)[None]).sum(1)
    pre_w = cnt_w.cumsum(-1)                                   # (S, W)
    tot_w = pre_w[:, -1:]
    crossings = torch.where(cols_h[None, :] >= sx[:, None],
                            tot_w - pre_w[:, :-1], pre_w[:, :-1])
    h_inc = (rows[None, :, None] == sy[:, None, None]) * \
        crossings[:, None, :]                                  # (S, H, W-1)
    pre_y = cnt_wy.cumsum(-1)                                  # (S, W, H)
    tot_y = pre_y[:, :, -1:]
    v_cross = torch.where(rows_v[None, None, :] >= sy[:, None, None],
                          tot_y - pre_y[:, :, :-1], pre_y[:, :, :-1])
    v_inc = v_cross.movedim(1, 2)                              # (S, H-1, W)
    return _flatten_links(h_inc, v_inc)


def _multicast_link_loads(dest_mask: torch.Tensor, src_core: torch.Tensor,
                          cores: int) -> torch.Tensor:
    """XY spanning tree: row trunk + one column branch per dest column."""
    dev = dest_mask.device
    w, h = topology.mesh_dims(cores)
    xy = topology.core_coords(cores, dev)
    dx, dy = xy[:, 0], xy[:, 1]
    sx, sy = xy[src_core, 0], xy[src_core, 1]                  # (S,)

    rows = torch.arange(h, device=dev)
    cols_h = torch.arange(max(w - 1, 0), device=dev)
    rows_v = torch.arange(max(h - 1, 0), device=dev)
    cols = torch.arange(w, device=dev)

    big = 1 << 20
    has = dest_mask.any(-1, keepdim=True)
    minx = torch.where(dest_mask, dx[None, :], big).amin(-1)
    maxx = torch.where(dest_mask, dx[None, :], -big).amax(-1)
    lo = torch.minimum(sx, minx)[:, None]
    hi = torch.maximum(sx, maxx)[:, None]
    h_span = has & (cols_h[None, :] >= lo) & (cols_h[None, :] < hi)
    h_inc = ((rows[None, :, None] == sy[:, None, None]) &
             h_span[:, None, :]).to(torch.float32)

    in_col = dest_mask[:, :, None] & (dx[None, :, None] == cols[None, None, :])
    miny = torch.where(in_col, dy[None, :, None], big).amin(1)
    maxy = torch.where(in_col, dy[None, :, None], -big).amax(1)
    has_col = in_col.any(1)                                    # (S, W)
    vlo = torch.minimum(sy[:, None], miny)[:, None, :]         # (S, 1, W)
    vhi = torch.maximum(sy[:, None], maxy)[:, None, :]
    v_inc = (has_col[:, None, :] & (rows_v[None, :, None] >= vlo) &
             (rows_v[None, :, None] < vhi)).to(torch.float32)
    return _flatten_links(h_inc, v_inc)


def _all_cores_mask(dest_mask: torch.Tensor, cores: int) -> torch.Tensor:
    return torch.ones((dest_mask.shape[0], cores), dtype=torch.bool,
                      device=dest_mask.device)


def _broadcast_link_loads(dest_mask, src_core, cores):
    """Broadcast floods the multicast tree over every core."""
    return _multicast_link_loads(_all_cores_mask(dest_mask, cores), src_core,
                                 cores)


def build_tables(tags: torch.Tensor, valid: torch.Tensor, *, cores: int,
                 neurons_per_core: int, tag_bits: int,
                 scheme: str = "multicast_tree") -> NocTables:
    """Precompute routing tables for the interface tick from the CAM state."""
    entry: NocScheme = interface_registry.get_noc_scheme(scheme)
    subs = multicast.subscription_matrix(tags, valid, cores,
                                         neurons_per_core, tag_bits)
    dmask = subs.T                                             # (S, C)
    total = cores * neurons_per_core
    src_core = torch.arange(total, dtype=torch.int32,
                            device=tags.device) // neurons_per_core
    hopmat = topology.hop_matrix(cores, tags.device)

    routed = entry.expand_dests(dmask, cores)
    hops = entry.hops(dmask, src_core, cores)
    depth = torch.where(routed, hopmat[src_core], 0).amax(-1).to(torch.int32)

    return NocTables(scheme=scheme, subs=subs,
                     dest_counts=dmask.sum(-1).to(torch.int32),
                     hops=hops, depth=depth,
                     link_table=entry.link_loads(dmask, src_core, cores))


def _latency(depth, loads, hop_ns, link_ns):
    """Deepest path plus the busiest link's serialization backlog (a
    one-core mesh has no links: its backlog is 0, as ``initial=0.0``)."""
    if loads.shape[-1] == 0:
        busiest = torch.zeros_like(depth)
    else:
        busiest = loads.amax(-1).clamp_min(0.0)
    return depth * hop_ns + busiest * link_ns


def noc_step_costs(tables: NocTables, spikes_flat: torch.Tensor):
    """Per-tick NoC cost from a flat (B, S) spike tensor.

    Returns (hops, latency_ns, energy, per-link loads) with a leading
    batch axis.
    """
    ev = spikes_flat.to(torch.float32)
    hops = (ev * tables.hops).sum(-1)
    loads = (ev[..., None] * tables.link_table).sum(-2)        # (B, L)
    depth = torch.where(spikes_flat, tables.depth, 0).amax(-1)
    latency = _latency(depth.to(torch.float32), loads,
                       ppa.NOC_HOP_LATENCY_NS, ppa.NOC_LINK_SERIALIZATION_NS)
    energy = hops * ppa.NOC_HOP_ENERGY
    return hops, latency, energy, loads


def noc_step_costs_events(tables: NocTables, ev_idx: torch.Tensor,
                          ev_w: torch.Tensor):
    """Event-indexed `noc_step_costs` for the sparse tick.

    ev_idx: (B, events) int32 flat source indices (pad slots point
    anywhere); ev_w: (B, events) float32 1.0/0.0 live weights.  Gathers
    the per-source table rows at the events, so cost scales with events.
    """
    hops = (ev_w * tables.hops[ev_idx]).sum(-1)
    loads = (ev_w[..., None] * tables.link_table[ev_idx]).sum(-2)
    depth = (ev_w * tables.depth[ev_idx].to(torch.float32)).amax(-1)
    latency = _latency(depth, loads, ppa.NOC_HOP_LATENCY_NS,
                       ppa.NOC_LINK_SERIALIZATION_NS)
    energy = hops * ppa.NOC_HOP_ENERGY
    return hops, latency, energy, loads


# ---------------------------------------------------------------------------
# CAM search accounting policies (leading batch axis on per-tick inputs).
# ---------------------------------------------------------------------------


def _flood_cam_accounting(tables, spikes_flat, valid_cnt, total_events, cores):
    """Flood: every event is searched in every core (seed accounting)."""
    searches = total_events * cores
    entries_per_search = valid_cnt.mean().expand_as(total_events)
    return searches, entries_per_search


def _flood_sparse_cam_accounting(tables, ev_idx, ev_w, valid_cnt,
                                 total_events, cores):
    """Flood accounting never reads the spike vector; same closed form."""
    return _flood_cam_accounting(tables, None, valid_cnt, total_events, cores)


def _subscribed_cam_accounting(tables, spikes_flat, valid_cnt, total_events,
                               cores):
    """Mesh: an event is searched only where some CAM entry subscribes."""
    searches = (spikes_flat * tables.dest_counts).sum(-1).to(torch.float32)
    swept = (valid_cnt[:, None] * tables.subs * spikes_flat[:, None, :]
             ).sum((-2, -1))
    entries_per_search = swept / searches.clamp_min(1.0)
    return searches, entries_per_search


def _subscribed_sparse_cam_accounting(tables, ev_idx, ev_w, valid_cnt,
                                      total_events, cores):
    """Event-indexed `_subscribed_cam_accounting` (bit-identical).

    ``valid_cnt @ subs`` is the per-source swept-entry total; it depends
    only on routing state (exact integers, so its order is free).
    """
    per_source = (valid_cnt[:, None] * tables.subs).sum(0)      # (S,)
    searches = (ev_w * tables.dest_counts[ev_idx]).sum(-1)
    swept = (ev_w * per_source[ev_idx]).sum(-1)
    entries_per_search = swept / searches.clamp_min(1.0)
    return searches, entries_per_search


for _entry in (
    NocScheme("broadcast",
              expand_dests=_all_cores_mask,
              hops=lambda m, src, cores: multicast.broadcast_tree_hops(
                  src, cores),
              link_loads=_broadcast_link_loads,
              cam_accounting=_flood_cam_accounting,
              sparse_cam_accounting=_flood_sparse_cam_accounting),
    NocScheme("unicast",
              expand_dests=lambda m, cores: m,
              hops=lambda m, src, cores: multicast.unicast_hops(
                  m, src, cores),
              link_loads=_unicast_link_loads,
              cam_accounting=_subscribed_cam_accounting,
              sparse_cam_accounting=_subscribed_sparse_cam_accounting),
    NocScheme("multicast_tree",
              expand_dests=lambda m, cores: m,
              hops=lambda m, src, cores: multicast.multicast_tree_hops(
                  m, src, cores),
              link_loads=_multicast_link_loads,
              cam_accounting=_subscribed_cam_accounting,
              sparse_cam_accounting=_subscribed_sparse_cam_accounting),
):
    if _entry.name not in interface_registry.NOC_SCHEMES:
        interface_registry.register_noc_scheme(_entry.name, _entry)
del _entry
