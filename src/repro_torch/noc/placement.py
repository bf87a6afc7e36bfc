"""Neuron-to-core placement: greedy hyperedge-overlap optimizer + baselines.

Port of `repro.noc.placement`.  Where neurons live determines how hard
the NoC and the CAMs work: a source whose fan-out is spread over many
cores multicasts to all of them and triggers one CAM search per core.
Modelling the network as a *hypergraph* (one hyperedge per source
neuron, spanning its destinations - Ronzani & Silvano) exposes the
lever: co-locating destinations that share sources collapses hyperedges
onto few cores, cutting both link traffic and search count.  The greedy
optimizer places nodes in descending-degree order onto the core whose
current members share the most hyperedges with them.

This is an OFFLINE host-side pass in numpy, as in the JAX package (its
float64 tie-breaks give the JAX package's permutations exactly); it
takes the port's `InterfaceParams` tensors (on any device) and returns
them on a resolved device (`apply_placement`,
`clustered_connectivity`).

Conventions: `perm[old_global_id] = new_global_id`; the core of a neuron
is `new_global_id // neurons_per_core`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.interface.types import InterfaceParams, resolve_device
from repro_torch.noc.topology import mesh_dims


def _host(t) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _params_on(device, tags, valid, weights, targets) -> InterfaceParams:
    return InterfaceParams(*(torch.from_numpy(a).to(device)
                             for a in (tags, valid, weights, targets)))


# ---------------------------------------------------------------------------
# Connectivity extraction
# ---------------------------------------------------------------------------


def _bits_to_int(bits: np.ndarray) -> np.ndarray:
    weights = 1 << np.arange(bits.shape[-1] - 1, -1, -1)
    return (bits * weights).sum(axis=-1)


def fanout_adjacency(params, cfg) -> np.ndarray:
    """(S, S) bool: A[s, d] = source neuron s drives destination neuron d.

    Decoded from the CAM tables of an `InterfaceParams` (tensors on any
    device); each row of A is one hyperedge (a source and the sinks it
    spans).
    """
    n = cfg.neurons_per_core
    tags = _host(params.tags)
    valid = _host(params.valid)
    targets = _host(params.targets)
    total = cfg.cores * n
    a = np.zeros((total, total), dtype=bool)
    src = _bits_to_int(tags)                                   # (C, E)
    for c in range(cfg.cores):
        e = np.flatnonzero(valid[c])
        a[src[c, e], c * n + targets[c, e]] = True
    return a


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------


def identity_placement(total: int) -> np.ndarray:
    return np.arange(total, dtype=np.int64)


def random_placement(seed: int, total: int) -> np.ndarray:
    return np.random.RandomState(seed).permutation(total).astype(np.int64)


def greedy_overlap_placement(a: np.ndarray, cores: int,
                             neurons_per_core: int) -> np.ndarray:
    """Greedy hyperedge-overlap partitioning (deterministic).

    Cores are grown one at a time: seed with the highest-degree unplaced
    node, then repeatedly pull in the unplaced node with the highest
    affinity to the growing core until it is full.  Affinity counts
        |{hyperedges covering the candidate that the core already touches}|
      + 0.5 * direct adjacency to core members
    i.e. primarily synaptic reuse (a source already delivered to this core
    serves a new co-located sink for free - one multicast delivery + one
    CAM search amortized over more synapses), secondarily keeping sources
    next to their own sinks (fewer mesh hops).  Growing core-by-core keeps
    each hyperedge's sinks together instead of scattering cold-start seeds
    across every core.
    """
    total = a.shape[0]
    assert cores * neurons_per_core >= total
    deg = (a.sum(0) + a.sum(1)).astype(np.float64)
    tiebreak = 1e-6 * deg
    unplaced = np.ones(total, dtype=bool)
    perm = np.empty(total, dtype=np.int64)
    for c in range(cores):
        if not unplaced.any():
            break
        cov = np.zeros(total, dtype=bool)       # hyperedges this core touches
        aff = np.zeros(total, dtype=np.float64)
        for slot in range(neurons_per_core):
            if not unplaced.any():
                break
            score = np.where(unplaced, aff + tiebreak, -np.inf)
            m = int(np.argmax(score))
            perm[m] = c * neurons_per_core + slot
            unplaced[m] = False
            new_srcs = a[:, m] & ~cov
            cov |= a[:, m]
            if new_srcs.any():                  # newly covered hyperedges
                aff += a[new_srcs].sum(axis=0)
            aff += 0.5 * (a[m] + a[:, m])       # adjacency to m itself
    return perm


# ---------------------------------------------------------------------------
# Traffic-cost objective (numpy mirror of the router's closed forms)
# ---------------------------------------------------------------------------


def _tree_edges(sx, sy, dmask, dx, dy, w) -> np.ndarray:
    """(S,) XY multicast spanning-tree edge counts (numpy)."""
    big = 1 << 20
    has = dmask.any(axis=1)
    minx = np.where(dmask, dx[None, :], big).min(axis=1)
    maxx = np.where(dmask, dx[None, :], -big).max(axis=1)
    trunk = np.maximum(sx, maxx) - np.minimum(sx, minx)
    branch = np.zeros_like(trunk)
    for col in range(w):
        in_col = dmask & (dx[None, :] == col)
        has_col = in_col.any(axis=1)
        miny = np.where(in_col, dy[None, :], big).min(axis=1)
        maxy = np.where(in_col, dy[None, :], -big).max(axis=1)
        branch += np.where(has_col, np.maximum(sy, maxy) -
                           np.minimum(sy, miny), 0)
    return np.where(has, trunk + branch, 0)


def placement_dest_cores(a: np.ndarray, perm: np.ndarray,
                         neurons_per_core: int, cores: int) -> np.ndarray:
    """(S, cores) bool: destination-core mask of each source under perm."""
    total = a.shape[0]
    core_of = perm // neurons_per_core                         # (S,)
    dmask = np.zeros((total, cores), dtype=bool)
    srcs, dsts = np.nonzero(a)
    dmask[srcs, core_of[dsts]] = True
    return dmask


def traffic_cost(a: np.ndarray, perm: np.ndarray, cores: int,
                 neurons_per_core: int, rates: np.ndarray | None = None
                 ) -> float:
    """Expected multicast-tree link traversals per tick under a placement.

    rates: optional (S,) per-source spike rates (uniform if omitted).
    Lower is better; single objective shared by optimizer and benchmarks.
    """
    w, _ = mesh_dims(cores)
    x = np.arange(cores) % w
    y = np.arange(cores) // w
    dmask = placement_dest_cores(a, perm, neurons_per_core, cores)
    src_core = perm // neurons_per_core
    edges = _tree_edges(x[src_core], y[src_core], dmask, x, y, w)
    r = np.ones(a.shape[0]) if rates is None else np.asarray(rates)
    return float((edges * r).sum())


def cam_search_count(a: np.ndarray, perm: np.ndarray, cores: int,
                     neurons_per_core: int) -> float:
    """CAM searches per tick if every source fired once: sum of dest cores."""
    dmask = placement_dest_cores(a, perm, neurons_per_core, cores)
    return float(dmask.sum())


# ---------------------------------------------------------------------------
# Applying a placement to the fabric
# ---------------------------------------------------------------------------


def apply_placement(params, cfg, perm: np.ndarray, device=None):
    """Rewrite CAM tables so neuron `g` now lives at global id `perm[g]`.

    Returns (new_params, new_cfg): each synapse entry moves to its target's
    new core, its stored tag is relabelled to the source's new id, and the
    per-core entry count grows to the most loaded core (padded invalid) -
    placement concentrates synapses, so cores may hold more entries than
    the uniform seed layout.  ``new_params`` is an `InterfaceParams` on
    ``device`` (the CUDA device when None; ``device="cpu"`` for the CPU).
    """
    device = resolve_device(device)
    n = cfg.neurons_per_core
    tags = _host(params.tags)
    valid = _host(params.valid)
    weights = _host(params.weights)
    targets = _host(params.targets)
    src_old = _bits_to_int(tags)

    per_core: list[list[tuple[int, float, int]]] = [[] for _ in range(cfg.cores)]
    for c in range(cfg.cores):
        for e in np.flatnonzero(valid[c]):
            new_dest = int(perm[c * n + targets[c, e]])
            new_src = int(perm[src_old[c, e]])
            per_core[new_dest // n].append(
                (new_src, float(weights[c, e]), new_dest % n))

    entries = max(cfg.cam.entries, max((len(p) for p in per_core), default=1))
    new_tags = np.zeros((cfg.cores, entries, cfg.tag_bits), np.int32)
    new_valid = np.zeros((cfg.cores, entries), bool)
    new_weights = np.zeros((cfg.cores, entries), np.float32)
    new_targets = np.zeros((cfg.cores, entries), np.int32)
    bit_w = 1 << np.arange(cfg.tag_bits - 1, -1, -1)
    for c, items in enumerate(per_core):
        for e, (src, wgt, tgt) in enumerate(items):
            new_tags[c, e] = (src & bit_w) > 0
            new_valid[c, e] = True
            new_weights[c, e] = wgt
            new_targets[c, e] = tgt

    new_cfg = dataclasses.replace(
        cfg, cam_entries_per_core=entries,
        cam=dataclasses.replace(cfg.cam, entries=entries))
    new_params = _params_on(device, new_tags, new_valid, new_weights,
                            new_targets)
    return new_params, new_cfg


# ---------------------------------------------------------------------------
# Structured workload generator (benchmarks/tests)
# ---------------------------------------------------------------------------


def clustered_connectivity(seed: int, cfg, cluster_size: int,
                           fan_in: int | None = None, device=None):
    """Cluster-structured fabric wiring, scrambled across cores.

    Neurons form clusters of `cluster_size` in a hidden "virtual" id space;
    every destination draws its `fan_in` sources from its own cluster.
    Virtual ids are then randomly scrambled onto physical ids, so the
    locality exists but no layout exposes it until a placement optimizer
    recovers it.  Returns an `InterfaceParams` on ``device`` (the CUDA
    device when None; ``device="cpu"`` for the CPU), the JAX package's
    arrays for the same seed.
    """
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    n = cfg.neurons_per_core
    total = cfg.cores * n
    fan_in = fan_in if fan_in is not None else max(1, cfg.cam.entries // n)
    assert n * fan_in <= cfg.cam.entries, "fan_in overflows the CAM"
    scramble = rng.permutation(total)          # virtual -> physical id

    tags = np.zeros((cfg.cores, cfg.cam.entries, cfg.tag_bits), np.int32)
    valid = np.zeros((cfg.cores, cfg.cam.entries), bool)
    weights = rng.randn(cfg.cores, cfg.cam.entries).astype(np.float32) * 0.5 + 1.0
    targets = np.zeros((cfg.cores, cfg.cam.entries), np.int32)
    bit_w = 1 << np.arange(cfg.tag_bits - 1, -1, -1)

    fill = np.zeros(cfg.cores, dtype=np.int64)
    for vd in range(total):
        d = scramble[vd]
        base = (vd // cluster_size) * cluster_size
        vsrcs = base + rng.choice(min(cluster_size, total - base),
                                  size=fan_in, replace=False)
        for vs in vsrcs:
            s = scramble[vs]
            c, e = d // n, fill[d // n]
            tags[c, e] = (s & bit_w) > 0
            valid[c, e] = True
            targets[c, e] = d % n
            fill[c] += 1
    return _params_on(device, tags, valid, weights, targets)
