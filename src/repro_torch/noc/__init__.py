"""Inter-core transport of the PyTorch port: mesh, multicast, router.

Port of `repro.noc`, with its public names:

  topology.py   mesh coordinates, XY dimension-order routing, hop matrices
  multicast.py  per-source destination masks from the CAM tables; hop counts
                for unicast replication vs. a single multicast spanning tree
  router.py     per-link event loads, contention latency and energy
  hierarchy.py  two-tier fabric: chip-local meshes + the inter-chip level
  placement.py  neuron-to-core placement (host numpy) and its traffic cost
"""

from repro_torch.noc.topology import (NocConfig, mesh_dims, core_coords,
                                      hop_matrix)
from repro_torch.noc.multicast import (subscription_matrix, dest_core_mask,
                                       unicast_hops, multicast_tree_hops,
                                       broadcast_tree_hops)
from repro_torch.noc.router import (NocTables, build_tables, link_loads,
                                    noc_step_costs)
from repro_torch.noc.hierarchy import (HierTables, build_hier_tables,
                                       chip_step_costs, chip_of_core)
from repro_torch.noc.placement import (identity_placement, random_placement,
                                       greedy_overlap_placement,
                                       traffic_cost, apply_placement,
                                       fanout_adjacency,
                                       clustered_connectivity)

__all__ = [
    "NocConfig", "mesh_dims", "core_coords", "hop_matrix",
    "subscription_matrix", "dest_core_mask", "unicast_hops",
    "multicast_tree_hops", "broadcast_tree_hops",
    "NocTables", "build_tables", "link_loads", "noc_step_costs",
    "HierTables", "build_hier_tables", "chip_step_costs", "chip_of_core",
    "identity_placement", "random_placement", "greedy_overlap_placement",
    "traffic_cost", "apply_placement", "fanout_adjacency",
    "clustered_connectivity",
]
