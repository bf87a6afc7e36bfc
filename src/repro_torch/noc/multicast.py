"""Multicast routing: destination masks from CAM tables + spanning-tree costs.

Port of `repro.noc.multicast`.  Core c holds an entry with tag t iff
some synapse in c subscribes to source neuron t, so the subscription
matrix is the per-source destination bitmask of a mesh multicast router
and its row population is the CAM search count an event triggers.

Hop-count models per source neuron:
  unicast        one routed copy per destination core (sum of distances).
  multicast tree one copy along the union of the XY paths: a row trunk
                 over the destination columns plus one column branch per
                 destination column (closed form, no search).
  broadcast      the multicast tree over every core.
"""

from __future__ import annotations

import torch

from repro_torch.noc import topology

_INF = 1 << 20


def subscription_matrix(tags: torch.Tensor, valid: torch.Tensor,
                        cores: int, neurons_per_core: int,
                        tag_bits: int) -> torch.Tensor:
    """(cores, total) bool: core c holds >=1 valid CAM entry for source s.

    Packs each stored tag back to its integer source id and scatters, so
    memory is O(cores * entries + cores * total).
    """
    total = cores * neurons_per_core
    bit_w = 1 << torch.arange(tag_bits - 1, -1, -1, device=tags.device)
    src_int = (tags.long() * bit_w).sum(-1)                      # (C, E)
    # tag values outside the populated address space never match a source
    hit = valid & (src_int < total)
    core_idx = torch.arange(cores, device=tags.device)[:, None].expand_as(
        src_int)
    subs = torch.zeros((cores, total), dtype=torch.bool, device=tags.device)
    subs[core_idx[hit], src_int[hit]] = True
    return subs


def unicast_hops(dest_mask: torch.Tensor, src_core: torch.Tensor,
                 cores: int) -> torch.Tensor:
    """(S,) total mesh hops when each destination gets its own copy."""
    hops = topology.hop_matrix(cores, dest_mask.device)          # (C, C)
    return (dest_mask * hops[src_core]).sum(-1).to(torch.int32)


def multicast_tree_hops(dest_mask: torch.Tensor, src_core: torch.Tensor,
                        cores: int) -> torch.Tensor:
    """(S,) edge count of the XY multicast spanning tree per source.

    A horizontal trunk on the source row spanning [min(sx, min dx),
    max(sx, max dx)] plus, in every destination column, a vertical branch
    spanning [min(sy, min dy), max(sy, max dy)] over that column.
    """
    w, _ = topology.mesh_dims(cores)
    xy = topology.core_coords(cores, dest_mask.device)           # (C, 2)
    dx, dy = xy[:, 0], xy[:, 1]
    sx, sy = xy[src_core, 0][:, None], xy[src_core, 1][:, None]  # (S, 1)

    m = dest_mask.bool()                                         # (S, C)
    any_dest = m.any(-1)
    minx = torch.where(m, dx[None, :], _INF).amin(-1, keepdim=True)
    maxx = torch.where(m, dx[None, :], -_INF).amax(-1, keepdim=True)
    trunk = (torch.maximum(sx, maxx) - torch.minimum(sx, minx))[:, 0]

    cols = torch.arange(w, device=m.device)
    col = dx[None, :, None] == cols[None, None, :]               # (1, C, W)
    in_col = m[:, :, None] & col                                 # (S, C, W)
    miny = torch.where(in_col, dy[None, :, None], _INF).amin(1)
    maxy = torch.where(in_col, dy[None, :, None], -_INF).amax(1)
    has_col = in_col.any(1)                                      # (S, W)
    branch = torch.where(has_col,
                         torch.maximum(sy, maxy) - torch.minimum(sy, miny), 0)
    edges = trunk + branch.sum(-1)
    return torch.where(any_dest, edges, 0).to(torch.int32)


def broadcast_tree_hops(src_core: torch.Tensor, cores: int) -> torch.Tensor:
    """(S,) spanning-tree edges to flood every core from each source."""
    all_cores = torch.ones((src_core.shape[0], cores), dtype=torch.bool,
                           device=src_core.device)
    return multicast_tree_hops(all_cores, src_core, cores)
