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
                       entry's tag against every source address, once per
                       tick) and the arbiter's tick latency and AER encode
                       energy through the CUDA `hat_encode` kernel's
                       `hat_run`, once per run for all of its ticks
                       (`arbiter_terms`; on CPU tensors their plain
                       versions, tick by tick);
  ``"pallas_sparse"``  the ticks where no core overflows its event
                       buffer go through `kernels.sparse_tick.ops.
                       sparse_run`: compaction, the sparse tick and the
                       event-indexed accounting, one CUDA launch for all
                       of a run's ticks (`run_stream`; its plain version
                       on CPU tensors); a tick where some core overflows
                       takes the dense tick.  Both branches give the same
                       bits.

On ``cfg.chips > 1`` the tables are two-tier (`noc.hierarchy.HierTables`)
and every path, B1's kernel included, accounts the inter-chip tier.
``interface_tick(oracle=True)`` is the pre-optimization reference: the
arbiter's discrete-event simulator per core and a dense sweep of every
CAM tag against every source address; ``telemetry="cores"`` adds the
per-core breakdown (`per_core_stats`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core import arbiter as arb
from repro_torch.core import cam as cam_mod
from repro_torch.core import ppa
from repro_torch.interface import registry as interface_registry
from repro_torch.interface.config import as_interface_config
from repro_torch.interface.stats import StepStats
from repro_torch.interface.types import int_to_bits
from repro_torch.kernels.cam_search import ops as cam_ops
from repro_torch.kernels.hat_encode import ops as hat_ops
from repro_torch.kernels.sparse_tick import ops as sparse_ops
from repro_torch.kernels.sparse_tick import ref as sparse_ref
from repro_torch.kernels.hat_encode import ref as hat_ref
from repro_torch.noc import hierarchy
from repro_torch.noc import router as noc_router
from repro_torch.obs import telemetry as obs_telemetry


def build_tables(params, cfg):
    """NoC routing tables for the configured scheme (build once, reuse).

    Flat single-chip `NocTables`, or two-tier `hierarchy.HierTables`
    (chip-local meshes + the inter-chip tier) when ``cfg.chips > 1``.
    """
    chips = getattr(cfg, "chips", 1)
    if chips > 1:
        return hierarchy.build_hier_tables(
            params.tags, params.valid, chips=chips,
            cores_per_chip=cfg.cores_per_chip,
            neurons_per_core=cfg.neurons_per_core,
            tag_bits=cfg.tag_bits, scheme=cfg.noc.scheme)
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


def _hat_impl(cfg) -> str:
    """``"pallas"`` where the `hat_encode` kernel takes this fabric (n a
    multiple of its 256-neuron chunk and within its size limit), as the
    JAX package's ``_addr_streams`` decides; otherwise ``"xla"``."""
    return ("pallas" if cfg.impl == "pallas"
            and hat_ops.takes(cfg.neurons_per_core) else "xla")


def arbiter_terms(plan, stream):
    """(latencies, enc_per_core), each (T, B, cores), of every tick of a
    (B, T, cores, n) stream from one `hat_run` launch, where the kernel
    takes the run (``impl="pallas"`` on CUDA frames at an n it takes).
    None elsewhere: `dense_tick` then computes them tick by tick."""
    if not (stream.is_cuda and _hat_impl(plan.cfg) == "pallas"):
        return None
    lat, enc, _ = hat_ops.hat_run(stream, plan.hat, impl="pallas")
    return lat, enc


def tick_terms(plan, spikes):
    """(latencies, enc_per_core), each (B, cores), of one tick's (B,
    cores, n) frames: through `hat_run` on this one tick (the kernel where
    the plan takes it, its plain version elsewhere)."""
    lat, enc, _ = hat_ops.hat_run(spikes[:, None], plan.hat,
                                  impl=_hat_impl(plan.cfg))
    return lat[0], enc[0]


def plain_terms(plan, frames):
    """(latencies, enc_per_core) of (..., n) frames in plain torch: the
    scheme's dense latency and the encode energy of the AER streams."""
    return hat_ref.arbiter_terms_ref(frames, plan.hat.latency_fn,
                                     plan.hat.encode_fn)[:2]


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
    hat: hat_ops.HatPolicy          # the dense arbiter latency and energy
    run: sparse_ops.SparseRun | None  # pallas_sparse's operands, or None


# The CUDA sparse run's form of each NoC scheme's event-indexed CAM
# accounting: True searches every event in every core, False sweeps the
# subscribed cores' entries.  A scheme with another form runs only on the
# plain path.
_KERNEL_FLOOD = {noc_router.flood_sparse_cam_accounting: True,
                 noc_router.subscribed_sparse_cam_accounting: False}


def bind_sparse_run(params, cfg, tables, routing, cam_cycle_ns,
                    sparse) -> sparse_ops.SparseRun:
    """The ``pallas_sparse`` run's operands, built once: on the card the
    per-source NoC tables, the swept-entry totals (``valid_cnt @ subs``),
    the flood's entries per search and the stats coefficients as the
    kernel takes them."""
    policy, sparse_cam, capacity = sparse

    def account(counts, ev_idx, ev_w, latencies, enc_per_core, hits_total):
        return sparse_accounting_stats(
            cfg, tables, counts, ev_idx, ev_w, latencies, enc_per_core,
            hits_total, params.valid, cam_cycle_ns, sparse_cam)

    kernel_tables = None
    if params.weights.is_cuda:
        chip = None
        if isinstance(tables, hierarchy.HierTables):
            chip = (tables.chip_hops, tables.chip_depth,
                    tables.chip_link_table.contiguous(),
                    (ppa.CHIP_HOP_LATENCY_NS, ppa.CHIP_LINK_SERIALIZATION_NS,
                     ppa.CHIP_HOP_ENERGY))
        valid_cnt = params.valid.sum(1).to(torch.float32)
        floats = (float(valid_cnt.mean()), cam_cycle_ns,
                  *cam_mod.energy_coefficients(cfg.cam),
                  ppa.NOC_HOP_LATENCY_NS, ppa.NOC_LINK_SERIALIZATION_NS,
                  ppa.NOC_HOP_ENERGY)
        swept = noc_router.swept_per_source(tables, valid_cnt)
        flood = _KERNEL_FLOOD.get(interface_registry.get_noc_scheme(
            cfg.noc.scheme).sparse_cam_accounting)
        kernel_tables = (tables.hops, tables.depth, tables.dest_counts,
                         swept.to(torch.int32),
                         tables.link_table.contiguous(), flood, floats, chip)
    return sparse_ops.bind_run(
        routing.src_idx, routing.active, params.weights, routing.csr,
        n=cfg.neurons_per_core, capacity=capacity, policy=policy,
        account=account, kernel_tables=kernel_tables)


def _check_tables(tables, cfg) -> None:
    """Refuse tables built for another NoC scheme or chip count."""
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


def make_plan(params, cfg, tables=None, arb_cfg=None, routing=None,
              cam_cycle_ns=None) -> TickPlan:
    """Build (or adopt) the tick's tables, index and policies, once.

    Raises:
      ValueError: on tables built for another NoC scheme or chip count,
        an unsupported ``pallas_sparse`` configuration, or (on the card)
        a scheme `hat_run`'s kernel has no form for.
    """
    if tables is None:
        tables = build_tables(params, cfg)
    _check_tables(tables, cfg)
    if arb_cfg is None:
        arb_cfg = arb.ArbiterConfig(cfg.scheme, cfg.neurons_per_core)
    n = cfg.neurons_per_core
    # where the scheme has no closed-form tick latency the simulator gives
    # it, and hat_run's kernel has no branch for that
    kernel_policy = (interface_registry.get_arbiter(cfg.scheme).kernel_policy
                     if arb.has_closed_form(arb_cfg) else None)
    hat = hat_ops.bind_run(
        arb.tick_latency_fn(arb_cfg),
        functools.partial(arb.encode_energy_units, cfg.scheme, n),
        kernel_policy, arb_cfg.levels, n,
        params.weights.device if cfg.impl == "pallas" else "cpu")
    sparse = (resolve_sparse_plan(cfg, arb_cfg)
              if cfg.impl == "pallas_sparse" else None)
    if routing is None:
        routing = build_routing_index(params, cfg)
    if cam_cycle_ns is None:
        cam_cycle_ns = cam_mod.cycle_time_ns(cfg.cam)
    run = (None if sparse is None else
           bind_sparse_run(params, cfg, tables, routing, cam_cycle_ns, sparse))
    return TickPlan(cfg=cfg, tables=tables, routing=routing,
                    cam_cycle_ns=cam_cycle_ns,
                    noc_scheme=interface_registry.get_noc_scheme(
                        cfg.noc.scheme),
                    hat=hat, run=run)


def _core_counts(tables, spikes):
    """(events, noc_hops, chip_hops) of each core of (..., cores, n)
    frames, each hop attributed to its event's source core through the
    per-source tables `accounting_stats` totals over (exact integers)."""
    ev = spikes.to(torch.float32)
    frame = tuple(spikes.shape[-2:])
    events = ev.sum(-1)
    noc_hops = (ev * tables.hops.reshape(frame)).sum(-1)
    if isinstance(tables, hierarchy.HierTables):
        chip_hops = (ev * tables.chip_hops.reshape(frame)).sum(-1)
    else:
        chip_hops = torch.zeros_like(events)
    return events, noc_hops, chip_hops


def per_core_stats(cfg, tables, spikes, latencies,
                   enc_per_core) -> obs_telemetry.CoreStats:
    """Per-core telemetry breakdown of (..., cores, n) frames.

    Events, encode energy and the NoC and chip hops sum exactly back to
    the tick's `StepStats` (hops attributed to each event's source core);
    the tick's ``encode_latency`` is the max over cores.
    """
    events, noc_hops, chip_hops = _core_counts(tables, spikes)
    return obs_telemetry.CoreStats(events=events,
                                   encode_latency=latencies.to(torch.float32),
                                   encode_energy=enc_per_core * events,
                                   noc_hops=noc_hops, chip_hops=chip_hops)


def dense_tick(plan: TickPlan, params, spikes, terms=None, cores=False):
    """The dense event tick on (B, cores, n) bool frames.

    ``terms`` is this tick's precomputed ``(latencies, enc_per_core)``,
    each (B, cores) (`arbiter_terms`); None computes them here
    (`tick_terms`).  Returns (currents (B, cores, n), `StepStats` with
    (B,) fields), and with ``cores`` the tick's `CoreStats` ((B, cores)
    fields) third.
    """
    cfg, n = plan.cfg, plan.cfg.neurons_per_core
    if terms is None:
        terms = tick_terms(plan, spikes)
    latencies, enc_per_core = terms
    spikes_flat = spikes.reshape(spikes.shape[0], -1)
    drive = _entry_drive(params, spikes_flat, plan.routing, cfg.impl)
    currents = sparse_ref.scatter_currents(drive * params.weights,
                                           plan.routing.csr, n)
    hits_total = drive.sum((-2, -1))
    stats = accounting_stats(cfg, plan.tables, spikes, latencies,
                             enc_per_core, hits_total, params.valid,
                             plan.cam_cycle_ns, plan.noc_scheme)
    if cores:
        return currents, stats, per_core_stats(cfg, plan.tables, spikes,
                                               latencies, enc_per_core)
    return currents, stats


def run_stream(plan: TickPlan, params, stream, overflow, acc0=None,
               telemetry="off"):
    """Every tick of a (B, T, cores, n) stream under ``pallas_sparse``.

    ``overflow`` (T,) host bools pick each tick's branch: the dense tick
    writes its currents and its stats row first, then one `sparse_run`
    computes every other tick and sums the (T, 12, B) stats table in tick
    order, starting from each lane's seed ``acc0`` (12, B) (None: 0.0).
    Returns (currents (B, T, cores, n), (12, B) summed stats); under
    ``telemetry`` "ticks" or "cores" also the (T, 12, B) table and, for
    "cores", the run's `CoreStats` with (T, B, cores) fields (None for
    "ticks"): the sparse ticks' latency and encode energy from the
    kernel's per-core output, events and hop attribution from the frames.
    """
    lanes, ticks = stream.shape[:2]
    cfg, dev = plan.cfg, stream.device
    cores = telemetry == "cores"
    currents = torch.empty((lanes, ticks, cfg.cores, cfg.neurons_per_core),
                           dtype=torch.float32, device=dev)
    table = torch.empty((ticks, len(StepStats._fields), lanes),
                        dtype=torch.float32, device=dev)
    core = (torch.empty((2, ticks, lanes, cfg.cores), dtype=torch.float32,
                        device=dev) if cores else None)
    for t in range(ticks):
        if overflow[t]:
            cur, st, *cs = dense_tick(plan, params, stream[:, t], cores=cores)
            currents[:, t] = cur
            table[t] = torch.stack(tuple(st))
            if cores:
                core[0, t] = cs[0].encode_latency
                core[1, t] = cs[0].encode_energy
    sparse = [t for t in range(ticks) if not overflow[t]]
    acc = sparse_ops.sparse_run(stream, None if len(sparse) == ticks
                                else sparse, plan.run, currents, table, acc0,
                                core)
    if telemetry == "off":
        return currents, acc
    per_core = None
    if cores:
        events, noc_hops, chip_hops = _core_counts(
            plan.tables, stream.transpose(0, 1))         # (T, B, C) each
        per_core = obs_telemetry.CoreStats(events, core[0], core[1],
                                           noc_hops, chip_hops)
    return currents, acc, table, per_core


def tick(plan: TickPlan, params, spikes, overflow: bool | None = None,
         cores: bool = False):
    """One tick of (B, cores, n) bool frames under ``plan.cfg.impl``.

    ``overflow`` is the ``pallas_sparse`` branch choice: True takes the
    dense fallback, False the sparse run (the caller has proven that no
    core exceeds the capacity), None decides here from the event counts,
    at the cost of one device-to-host copy.  Returns (currents (B, cores,
    n), `StepStats` with (B,) fields), and with ``cores`` the tick's
    `CoreStats` ((B, cores) fields) third, from whichever branch ran.
    """
    if plan.run is not None and overflow is None:
        overflow = bool((spikes.sum(-1) > plan.run.capacity).any())
    if plan.run is None or overflow:
        return dense_tick(plan, params, spikes, cores=cores)
    currents, _, table, core = run_stream(
        plan, params, spikes[:, None].contiguous(), [False],
        telemetry="cores" if cores else "ticks")
    out = (currents[:, 0], StepStats(*table[0].unbind(0)))
    if cores:
        out += (obs_telemetry.CoreStats(*(f[0] for f in core)),)
    return out


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
    currents (cores, neurons_per_core) float32 and scalar `StepStats`,
    and under ``telemetry="cores"`` the tick's `CoreStats` third.
    """
    if telemetry not in ("off", "cores"):
        raise ValueError(
            f"interface_tick telemetry must be 'off' or 'cores' (the "
            f"'ticks' mode is a session-level scan concern), got {telemetry!r}")
    cfg = as_interface_config(cfg)
    cores, n = spikes.shape
    if n != cfg.neurons_per_core or cores != cfg.cores:
        raise ValueError(
            f"spikes shape ({cores}, {n}) does not match config "
            f"({cfg.cores}, {cfg.neurons_per_core})")
    if spikes.dtype != torch.bool:
        spikes = spikes > 0
    if oracle:
        return _oracle_tick(params, spikes, cfg, tables, arb_cfg,
                            cam_cycle_ns, telemetry)
    plan = make_plan(params, cfg, tables, arb_cfg, routing, cam_cycle_ns)
    currents, stats, *core = tick(plan, params, spikes[None],
                                  overflow=False if sparse_unchecked else None,
                                  cores=telemetry == "cores")
    out = (currents[0], StepStats(*(f[0] for f in stats)))
    return out + tuple(obs_telemetry.CoreStats(*(f[0] for f in c))
                       for c in core)


def _oracle_tick(params, spikes, cfg, tables, arb_cfg, cam_cycle_ns,
                 telemetry):
    """The pre-optimization reference tick: every core's arbiter through
    the discrete-event simulator, and a dense sweep of every CAM tag
    against every source address (packed int32 words: the booleans of the
    JAX package's bit-by-bit compare), each target's sum in ascending
    entry order from 0.0."""
    cores, n = spikes.shape
    if tables is None:
        tables = build_tables(params, cfg)
    _check_tables(tables, cfg)
    if arb_cfg is None:
        arb_cfg = arb.ArbiterConfig(cfg.scheme, n)
    if cam_cycle_ns is None:
        cam_cycle_ns = cam_mod.cycle_time_ns(cfg.cam)
    req = torch.where(spikes, 0.0, arb.INF).to(torch.float32)
    grants = arb.Arbiter(arb_cfg, req.device).simulate(req)  # (cores, n)
    latencies = torch.where(
        spikes.any(-1),
        torch.where(torch.isfinite(grants), grants, 0.0).amax(-1), 0.0)

    spikes_flat = spikes.reshape(-1)
    bits = cfg.tag_bits
    src_words = cam_ops.pack_bits(int_to_bits(
        torch.arange(cores * n, device=spikes.device), bits))  # (S, W)
    tag_words = cam_ops.pack_bits(params.tags.reshape(-1, bits)).reshape(
        cores, -1, src_words.shape[-1])                       # (C, E, W)
    drive = torch.empty(params.valid.shape, dtype=torch.float32,
                        device=spikes.device)
    for c in range(cores):
        eq = (tag_words[c][:, None, :] == src_words[None]).all(-1)  # (E, S)
        hit = eq & params.valid[c][:, None] & spikes_flat[None, :]
        drive[c] = hit.sum(1).to(torch.float32)
    everything = sparse_ref.build_target_csr(
        params.targets, torch.ones_like(params.valid), n)
    currents = sparse_ref.scatter_currents((drive * params.weights)[None],
                                           everything, n)[0]
    hits_total = drive.sum()

    addr_seq = hat_ref.compact_stream(
        *hat_ref.hat_encode_ref(spikes, row=1)[:2])
    enc_per_core = arb.encode_energy_units(cfg.scheme, n, addr_seq)
    stats = accounting_stats(cfg, tables, spikes[None], latencies[None],
                             enc_per_core[None], hits_total[None],
                             params.valid, cam_cycle_ns)
    stats = StepStats(*(f[0] for f in stats))
    if telemetry == "cores":
        return currents, stats, per_core_stats(cfg, tables, spikes,
                                               latencies, enc_per_core)
    return currents, stats
