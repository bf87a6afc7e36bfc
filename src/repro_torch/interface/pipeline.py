"""The core-interface tick: arbiter -> AER encode -> NoC -> CAM, once.

Port of the event-driven path of `repro.interface.pipeline`, written over
a leading batch axis B (one lane per stream of ``run_batched``; ``run``
is one lane).  A `RoutingIndex` built once per (params, cfg) decodes
every CAM entry's stored tag to its global source index, so the per-tick
CAM match is the gather ``spikes_flat[src_idx] & active`` and a
deterministic per-target sum (`kernels.sparse_tick.ref.scatter_currents`).

``cfg.impl`` selects the tick:

  ``"xla"``            the dense event tick in plain torch (`dense_tick`);
  ``"pallas"``         the same dense tick with the CAM match through the
                       CUDA `cam_search` kernel (match counts of every CAM
                       entry's tag against every source address) and the
                       AER address streams through the CUDA `hat_encode`
                       kernel (their plain versions on CPU tensors);
  ``"pallas_sparse"``  per-core event compaction feeding the fused CUDA
                       `sparse_tick` kernel (its plain version on CPU
                       tensors), with the dense tick as the fallback on a
                       tick where some core overflows its event buffer.
                       Both branches give the same bits.

Not ported yet, and refused with `NotImplementedError`: ``oracle=True``
(ROADMAP queue A item 8), ``telemetry`` (item 7) and multi-chip tables
(item 7).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import arbiter as arb
from repro_torch.core import cam as cam_mod
from repro_torch.interface import registry as interface_registry
from repro_torch.interface.stats import StepStats
from repro_torch.interface.types import int_to_bits
from repro_torch.kernels.cam_search import ops as cam_ops
from repro_torch.kernels.hat_encode import ops as hat_ops
from repro_torch.kernels.sparse_tick import ops as sparse_ops
from repro_torch.kernels.sparse_tick import ref as sparse_ref
from repro_torch.noc import hierarchy
from repro_torch.noc import router as noc_router


def not_ported(what: str, item: int) -> NotImplementedError:
    """The error for a JAX surface this package does not carry yet."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue A item "
        f"{item}); use the JAX package `repro` for it")


def build_tables(params, cfg) -> noc_router.NocTables:
    """NoC routing tables for the configured scheme (build once, reuse)."""
    if getattr(cfg, "chips", 1) > 1:
        raise not_ported("chips > 1 (two-tier HierTables)", 7)
    return noc_router.build_tables(params.tags, params.valid,
                                   cores=cfg.cores,
                                   neurons_per_core=cfg.neurons_per_core,
                                   tag_bits=cfg.tag_bits,
                                   scheme=cfg.noc.scheme)


class RoutingIndex(NamedTuple):
    """Compile-time decode of the CAM tags into gather/kernel operands.

    The first six fields are those of `repro.interface.pipeline.
    RoutingIndex`; ``csr`` is the port's own: the live entries grouped by
    flat target, which fixes the order of every current's sum.
    """

    src_idx: torch.Tensor     # (cores, entries) int32 global source index
    active: torch.Tensor      # (cores, entries) bool: valid & tag in range
    src_chip: torch.Tensor    # (cores, entries) int32 source chip
    src_core: torch.Tensor    # (cores, entries) int32 source core within chip
    q_words: torch.Tensor     # (cores*entries, W) int32 packed entry tags
    src_words: torch.Tensor   # (cores*neurons, W) int32 packed source addrs
    csr: sparse_ref.TargetCSR


def build_routing_index(params, cfg) -> RoutingIndex:
    """Decode each CAM entry's tag to a source index, once (int-pack)."""
    dev = params.tags.device
    total = cfg.cores * cfg.neurons_per_core
    bits = cfg.tag_bits
    bit_w = 1 << torch.arange(bits - 1, -1, -1, device=dev)
    src_int = (params.tags.long() * bit_w).sum(-1)               # (C, E)
    # tag values outside the populated address space never match a source
    active = params.valid & (src_int < total)
    src_idx = src_int.clamp_max(total - 1).to(torch.int32)
    per_chip = getattr(cfg, "cores_per_chip", None) or cfg.cores
    src_chip, src_core = hierarchy.chip_of_core(
        src_idx // cfg.neurons_per_core, per_chip)
    q_words = cam_ops.pack_bits(params.tags.reshape(-1, bits))
    src_words = cam_ops.pack_bits(
        int_to_bits(torch.arange(total, device=dev), bits))
    csr = sparse_ref.build_target_csr(params.targets, active,
                                      cfg.neurons_per_core)
    return RoutingIndex(src_idx=src_idx, active=active,
                        src_chip=src_chip.to(torch.int32),
                        src_core=src_core.to(torch.int32),
                        q_words=q_words, src_words=src_words, csr=csr)


def _entry_drive(params, spikes_flat, routing: RoutingIndex, impl: str):
    """(B, cores, entries) float32 {0,1}: is this entry's source spiking?

    ``impl="pallas"`` matches every entry's packed tag against every
    source address (one `cam_search` count launch for all B lanes) and
    masks with ``params.valid``, as the JAX package does; every other impl
    takes the compile-time gather.  A tag outside the address space
    matches no source, so both give the same drive.
    """
    if impl == "pallas":
        counts = cam_ops.cam_match_counts(routing.q_words, routing.src_words,
                                          spikes_flat, impl="pallas")
        hit = counts.reshape((-1,) + tuple(params.valid.shape)) > 0
        return (hit & params.valid).to(torch.float32)
    return sparse_ref.entry_drive(spikes_flat, routing.src_idx,
                                  routing.active).to(torch.float32)


def _addr_streams(spikes, impl: str):
    """(..., cores, n) int32 AER address streams (service order, pad n).

    ``impl="pallas"`` takes the `hat_encode` kernel path when n is a
    multiple of its 256-neuron cluster and within its size limit (one
    launch for every lane and core), as the JAX package does; otherwise
    the plain version.
    """
    row, n = 256, spikes.shape[-1]
    hat_impl = ("pallas" if impl == "pallas" and n % row == 0
                and n <= hat_ops.MAX_PALLAS_N else "xla")
    stream, _ = hat_ops.encode_stream(spikes, row=row, impl=hat_impl)
    return stream


def resolve_sparse_plan(cfg, arb_cfg: arb.ArbiterConfig | None = None):
    """Validate and resolve the ``impl="pallas_sparse"`` policy bundle.

    Returns ``(policy, sparse_cam_accounting, capacity)`` with ``policy``
    a `kernels.sparse_tick.ops.SparsePolicy`.

    Raises:
      ValueError: under the conditions of the JAX package's
        `resolve_sparse_plan` (no sparse policy at this size, no
        event-indexed CAM accounting, a non-positive capacity).
    """
    n = cfg.neurons_per_core
    if arb_cfg is None:
        arb_cfg = arb.ArbiterConfig(cfg.scheme, n)
    entry = interface_registry.get_arbiter(cfg.scheme)
    ctx = arb.make_context(arb_cfg)
    latency_fn = (entry.sparse_tick_latency(ctx)
                  if entry.sparse_tick_latency is not None else None)
    encode_fn = (entry.sparse_encode_energy(ctx)
                 if entry.sparse_encode_energy is not None else None)
    if latency_fn is None or encode_fn is None:
        raise ValueError(
            f"impl='pallas_sparse' is unsupported for arbiter scheme "
            f"{cfg.scheme!r} at n={n}: the scheme's sparse tick policies "
            f"are undefined there (use impl='xla' or 'pallas')")
    noc_scheme = interface_registry.get_noc_scheme(cfg.noc.scheme)
    if noc_scheme.sparse_cam_accounting is None:
        raise ValueError(
            f"impl='pallas_sparse' is unsupported for NoC scheme "
            f"{cfg.noc.scheme!r}: it registers no event-indexed CAM "
            f"accounting (use impl='xla' or 'pallas')")
    capacity = sparse_ops.resolve_capacity(
        getattr(cfg, "sparse_capacity", None), n)
    policy = sparse_ops.SparsePolicy(latency_fn, encode_fn,
                                     entry.kernel_policy, arb_cfg.levels)
    return policy, noc_scheme.sparse_cam_accounting, capacity


def _stats(cfg, searches, entries_per_search, hits_total, cam_cycle_ns,
           total_events, encode_latency, encode_energy, noc, chip):
    """The accounting tail shared by the dense and the sparse form."""
    match_per_search = hits_total.to(torch.float32) / searches.clamp_min(1.0)
    mismatch_per_search = entries_per_search - match_per_search
    cam_energy = searches * cam_mod.energy(cfg.cam, match_per_search,
                                           mismatch_per_search)
    noc_hops, noc_latency, noc_energy, _ = noc
    chip_hops, chip_latency, chip_energy = chip
    return StepStats(events=total_events,
                     encode_latency=encode_latency,
                     encode_energy=encode_energy,
                     cam_searches=searches,
                     cam_energy=cam_energy,
                     cam_time_ns=searches * cam_cycle_ns,
                     noc_hops=noc_hops,
                     noc_latency=noc_latency,
                     noc_energy=noc_energy,
                     chip_hops=chip_hops,
                     chip_latency=chip_latency,
                     chip_energy=chip_energy)


def accounting_stats(cfg, tables, spikes, latencies, enc_per_core,
                     hits_total, valid, cam_cycle_ns,
                     noc_scheme=None) -> StepStats:
    """The per-tick PPA accounting tail of the dense tick.

    spikes (B, cores, n) bool; latencies and enc_per_core (B, cores);
    hits_total (B,).  Returns `StepStats` with (B,) fields.
    """
    if noc_scheme is None:
        noc_scheme = interface_registry.get_noc_scheme(cfg.noc.scheme)
    spikes_flat = spikes.reshape(spikes.shape[0], -1)
    per_core = spikes.sum(-1)
    total_events = per_core.sum(-1).to(torch.float32)
    valid_cnt = valid.sum(1).to(torch.float32)
    searches, entries_per_search = noc_scheme.cam_accounting(
        tables, spikes_flat, valid_cnt, total_events, cfg.cores)
    return _stats(cfg, searches, entries_per_search, hits_total, cam_cycle_ns,
                  total_events, latencies.amax(-1),
                  (enc_per_core * per_core).sum(-1),
                  noc_router.noc_step_costs(tables, spikes_flat),
                  hierarchy.chip_step_costs(tables, spikes_flat))


def sparse_accounting_stats(cfg, tables, counts, ev_idx, ev_w, latencies,
                            enc_per_core, hits_total, valid, cam_cycle_ns,
                            sparse_cam_accounting) -> StepStats:
    """Event-indexed `accounting_stats` for the sparse tick.

    Gathers every per-source table row at this tick's events instead of
    reducing over the fabric; every reduction sums the same exact small
    integers as the dense form, so the stats are the same.
    """
    total_events = counts.sum(-1).to(torch.float32)
    valid_cnt = valid.sum(1).to(torch.float32)
    searches, entries_per_search = sparse_cam_accounting(
        tables, ev_idx, ev_w, valid_cnt, total_events, cfg.cores)
    return _stats(cfg, searches, entries_per_search, hits_total, cam_cycle_ns,
                  total_events, latencies.amax(-1),
                  (enc_per_core * counts).sum(-1),
                  noc_router.noc_step_costs_events(tables, ev_idx, ev_w),
                  hierarchy.chip_step_costs_events(tables, ev_idx, ev_w))


class TickPlan(NamedTuple):
    """Everything a tick needs that depends only on (params, cfg)."""
    cfg: object
    tables: noc_router.NocTables
    routing: RoutingIndex
    cam_cycle_ns: float
    noc_scheme: noc_router.NocScheme
    tick_latency: Callable          # dense (B, cores, n) -> (B, cores)
    sparse: tuple | None            # resolve_sparse_plan(...) or None


def make_plan(params, cfg, tables=None, arb_cfg=None, routing=None,
              cam_cycle_ns=None) -> TickPlan:
    """Build (or adopt) the tick's tables, index and policies, once.

    Raises:
      ValueError: on tables built for another NoC scheme or chip count,
        or an unsupported ``pallas_sparse`` configuration.
      NotImplementedError: on a surface not ported yet (chips > 1, a
        scheme that would need the arbiter simulator).
    """
    if tables is None:
        tables = build_tables(params, cfg)
    if tables.scheme != cfg.noc.scheme:
        raise ValueError(
            f"NoC tables were built for scheme {tables.scheme!r} but the "
            f"config requests {cfg.noc.scheme!r}; rebuild them with "
            f"repro_torch.interface.build_tables(params, cfg)")
    if getattr(tables, "chips", 1) != getattr(cfg, "chips", 1):
        raise ValueError(
            f"NoC tables were built for chips={getattr(tables, 'chips', 1)} "
            f"but the config requests chips={getattr(cfg, 'chips', 1)}; "
            f"rebuild them with repro_torch.interface.build_tables(params, "
            f"cfg)")
    if arb_cfg is None:
        arb_cfg = arb.ArbiterConfig(cfg.scheme, cfg.neurons_per_core)
    sparse = (resolve_sparse_plan(cfg, arb_cfg)
              if cfg.impl == "pallas_sparse" else None)
    if routing is None:
        routing = build_routing_index(params, cfg)
    if cam_cycle_ns is None:
        cam_cycle_ns = cam_mod.cycle_time_ns(cfg.cam)
    return TickPlan(cfg=cfg, tables=tables, routing=routing,
                    cam_cycle_ns=cam_cycle_ns,
                    noc_scheme=interface_registry.get_noc_scheme(
                        cfg.noc.scheme),
                    tick_latency=arb.tick_latency_fn(arb_cfg),
                    sparse=sparse)


def dense_tick(plan: TickPlan, params, spikes):
    """The dense event tick on (B, cores, n) bool frames.

    Returns (currents (B, cores, n), `StepStats` with (B,) fields).
    """
    cfg, n = plan.cfg, plan.cfg.neurons_per_core
    latencies = plan.tick_latency(spikes)
    spikes_flat = spikes.reshape(spikes.shape[0], -1)
    drive = _entry_drive(params, spikes_flat, plan.routing, cfg.impl)
    currents = sparse_ref.scatter_currents(drive * params.weights,
                                           plan.routing.csr, n)
    hits_total = drive.sum((-2, -1))
    addr_seq = _addr_streams(spikes, cfg.impl)
    enc_per_core = arb.encode_energy_units(cfg.scheme, n, addr_seq)
    stats = accounting_stats(cfg, plan.tables, spikes, latencies,
                             enc_per_core, hits_total, params.valid,
                             plan.cam_cycle_ns, plan.noc_scheme)
    return currents, stats


def sparse_tick(plan: TickPlan, params, spikes, buf, counts):
    """The sparse branch on (B, cores, n) frames already compacted into
    ``buf``/``counts`` with no core over capacity."""
    cfg, n = plan.cfg, plan.cfg.neurons_per_core
    policy, sparse_cam, _ = plan.sparse
    spikes_flat = spikes.reshape(spikes.shape[0], -1)
    currents, latencies, enc_per_core, hits_total = sparse_ops.sparse_tick(
        spikes_flat, buf, counts, plan.routing.src_idx, plan.routing.active,
        params.weights, plan.routing.csr, n=n, policy=policy)
    ev_idx, ev_w = sparse_ops.event_indices(buf, n)
    stats = sparse_accounting_stats(
        cfg, plan.tables, counts, ev_idx, ev_w, latencies, enc_per_core,
        hits_total, params.valid, plan.cam_cycle_ns, sparse_cam)
    return currents, stats


def tick(plan: TickPlan, params, spikes, overflow: bool | None = None):
    """One tick of (B, cores, n) bool frames under ``plan.cfg.impl``.

    ``overflow`` is the ``pallas_sparse`` branch choice: True takes the
    dense fallback, False the sparse kernel (the caller has proven that
    no core exceeds the capacity), None decides here from the event
    counts, at the cost of one device-to-host copy.
    """
    if plan.sparse is None:
        return dense_tick(plan, params, spikes)
    if overflow is None:
        overflow = bool((spikes.sum(-1) > plan.sparse[2]).any())
    if overflow:
        return dense_tick(plan, params, spikes)
    buf, counts = sparse_ops.compact_events(spikes, plan.sparse[2])
    return sparse_tick(plan, params, spikes, buf, counts)


def interface_tick(params, spikes: torch.Tensor, cfg,
                   tables: noc_router.NocTables | None = None,
                   arb_cfg: arb.ArbiterConfig | None = None,
                   routing: RoutingIndex | None = None,
                   cam_cycle_ns: float | None = None,
                   oracle: bool = False,
                   telemetry: str = "off",
                   sparse_unchecked: bool = False,
                   ) -> tuple[torch.Tensor, StepStats]:
    """One fabric tick of a (cores, neurons_per_core) frame.

    Arguments as in `repro.interface.pipeline.interface_tick`.  Returns
    currents (cores, neurons_per_core) float32 and scalar `StepStats`.
    """
    if telemetry not in ("off", "cores"):
        raise ValueError(
            f"interface_tick telemetry must be 'off' or 'cores' (the "
            f"'ticks' mode is a session-level scan concern), got {telemetry!r}")
    if telemetry != "off":
        raise not_ported("telemetry='cores'", 7)
    if oracle:
        raise not_ported("interface_tick(oracle=True)", 8)
    cores, n = spikes.shape
    if n != cfg.neurons_per_core or cores != cfg.cores:
        raise ValueError(
            f"spikes shape ({cores}, {n}) does not match config "
            f"({cfg.cores}, {cfg.neurons_per_core})")
    if spikes.dtype != torch.bool:
        spikes = spikes > 0
    plan = make_plan(params, cfg, tables, arb_cfg, routing, cam_cycle_ns)
    currents, stats = tick(plan, params, spikes[None],
                           overflow=False if sparse_unchecked else None)
    return currents[0], StepStats(*(f[0] for f in stats))
