"""Compile-once sessions over the core-interface pipeline.

Port of `repro.interface.session`.  `Interface(config).compile(params)`
builds the NoC tables (two-tier when ``cfg.chips > 1``), the CAM
`RoutingIndex` (with its target CSR) and the arbiter plan once, on one
device, and returns an `InterfaceSession` whose `run` / `run_batched`
step the tick over a spike stream in a Python loop, accumulating
`StepStats` in tick order (the JAX package's ``lax.scan`` carry).

Sessions run on the CUDA device unless the caller asks for another:
``compile(params, device=None)`` means ``"cuda"`` and raises when there
is none; tests pass ``device="cpu"``.

``impl="pallas_sparse"`` picks a branch per tick without a per-tick
host sync: `run` computes the stream's (T,) overflow vector (does any
core of any lane exceed the event capacity?) in one reduction and copies
it to the host once; the overflowing ticks take the dense fallback, and
every other tick of every lane goes through one `sparse_run` (one kernel
launch on the card, `pipeline.run_stream`).  Both give the same bits.

``impl="pallas"`` computes the arbiter's tick latency and encode energy
of every tick of a run first, in one `hat_run` (one kernel launch on the
card, `pipeline.arbiter_terms`), then runs the dense tick on each frame
with its slice.

Chip sharding: ``run(spikes, shard="chips")`` runs the per-chip slice of
every tick - the CAM match and scatter, the per-core arbiter latency and
the AER encode stage.  When the caller runs a process group of at least
``chips`` ranks, the per-chip constants are placed once on a
``("chips",)`` mesh (`repro_torch.launch.mesh.make_chip_mesh`,
`repro_torch.parallel.sharding.leading_axis_specs`) and each rank steps
its own chip, the results gathered in chip order (`_mesh_loop`);
otherwise one body runs over a leading chips axis on the session's one
device, the JAX package's single-device fallback (its ``vmap`` over
chips).  ``session.last_shard_body`` says which ran (``"mesh"`` or
``"single"``).  The body is the ``xla`` form under every impl (as in the JAX
package), so it launches no kernel; the per-core vectors are
reassembled in fabric order and go through `pipeline.accounting_stats`,
so currents and stats are the unsharded session's bits.

Observability: ``run(..., telemetry="ticks"|"cores")`` also returns the
per-tick `StepStats` (`repro_torch.obs.telemetry.TickTelemetry`) and, at
``"cores"``, per-core breakdowns (`CoreTelemetry`), under every impl:
``pallas_sparse`` takes the per-tick rows B1 writes and its optional
per-core output, ``pallas`` the per-core terms B3 returns.  Currents and
accumulated stats are the same bits in every mode.

Masked runs (the serving tier's ragged lanes): ``mask`` erases each
masked tick by ``spikes & mask`` before the loop, whose body is the
unmasked one; an all-False frame gives exactly zero `StepStats` and zero
currents under every impl and scheme.  ``stats0`` seeds each lane's
accumulator, so a stream served in chunks sums its stats in the order of
one uninterrupted run, bit for bit (under ``pallas_sparse`` the seed is
the first term of the kernel's tick-order sum).  Masking composes with
``shard="chips"``, not with telemetry (`CompositionError`).

Fault injection: ``compile(params, fault=FaultModel(...))`` perturbs the
routing state before the tables, the routing index and the kernels'
operands are built, and masks dead cores' spikes and dropped events
before every run, keyed by ``fault_tick0`` (each stream's global tick
offset), so a faulted stream run in chunks draws the faults of one run.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import arbiter as arb
from repro_torch.core import cam as cam_mod
from repro_torch.interface import pipeline, report
from repro_torch.interface.config import as_interface_config
from repro_torch.interface.stats import StepStats
from repro_torch.interface.types import InterfaceParams, resolve_device
from repro_torch.kernels.sparse_tick import ref as sparse_ref
from repro_torch.obs import telemetry as obs_telemetry

_SHARD_MODES = (None, "chips")


class CompositionError(ValueError):
    """A requested run-mode combination is not supported.

    Typed rejection (still a ValueError), as in the JAX package: telemetry
    together with ``mask`` or with ``shard="chips"`` on a multi-chip
    config, and ``shard="chips"`` on a one-chip tenant config
    (`repro_torch.serve.TenantSpec`).
    """


class Interface:
    """Factory for precompiled sessions over one interface configuration."""

    def __init__(self, config):
        """config: `InterfaceConfig` or a field-compatible config."""
        self.config = as_interface_config(config)

    def compile(self, params, device=None, fault=None) -> "InterfaceSession":
        """Bind routing state on ``device``; build all plans/tables once.

        fault: optional `repro_torch.ft.faults.FaultModel` compiled into
        the session (see the module docstring).

        Raises:
          RuntimeError: ``device`` is None or CUDA and there is no GPU.
          ValueError: the fault model does not fit the config, or
            ``impl="pallas_sparse"`` and a configured scheme lacks sparse
            tick policies (`pipeline.resolve_sparse_plan`).
        """
        return InterfaceSession(self.config, params, device=device,
                                fault=fault)

    def ppa_report(self) -> dict:
        """Unified area/latency/energy report for this configuration."""
        return report.ppa_report(self.config)


class InterfaceSession:
    """A precompiled (config, params) binding on one device.

    Attributes built once at construction:
      tables    NoC subscription/hop/link tables (`NocTables`, or
                `noc.hierarchy.HierTables` when ``cfg.chips > 1``)
      arb_plan  arbiter plan (`ArbiterConfig`)
      routing   CAM tags decoded to source addresses (`RoutingIndex`)
      cam_cycle_ns  CAM search cycle time for the configured variant
      device    where every tensor of the session lives
      fault     the compiled `FaultModel`, or None
    """

    def __init__(self, config, params, device=None, fault=None):
        self.config = cfg = as_interface_config(config)
        self.device = resolve_device(device)
        if fault is not None:
            fault.validate(cfg)
            if fault.is_null:
                fault = None          # compiles exactly as fault-free
        self.fault = fault
        params = InterfaceParams(*params).to(self.device)
        if fault is not None:
            params = fault.apply_params(params, cfg)
        self.params = params
        self.arb_plan = arb.ArbiterConfig(cfg.scheme, cfg.neurons_per_core)
        self.tables = pipeline.build_tables(self.params, cfg)
        self.cam_cycle_ns = cam_mod.cycle_time_ns(cfg.cam)
        self.plan = pipeline.make_plan(self.params, cfg, self.tables,
                                       self.arb_plan,
                                       cam_cycle_ns=self.cam_cycle_ns)
        self.routing = self.plan.routing
        self._chip_shard = None
        self.last_shard_body = None       # "mesh" | "single" after shard=

    # ---- introspection ---------------------------------------------------

    def ppa_report(self) -> dict:
        """Unified area/latency/energy report for this configuration."""
        return report.ppa_report(self.config)

    # ---- execution -------------------------------------------------------

    def step(self, spikes) -> tuple[torch.Tensor, StepStats]:
        """One tick.  spikes: (cores, neurons_per_core) bool."""
        spikes = self._check(spikes, 2)
        currents, stats = pipeline.tick(self.plan, self.params, spikes[None])
        return currents[0], StepStats(*(f[0] for f in stats))

    def run(self, spikes, shard: str | None = None, telemetry: str = "off",
            mask=None, stats0: StepStats | None = None, fault_tick0=None):
        """Multi-timestep simulation, ticks in order.

        spikes: (T, cores, neurons_per_core) bool
        shard: None, or ``"chips"``: the per-chip body over a chips axis
            on this device (module docstring); the flat run at one chip.
        telemetry: ``"off"``, ``"ticks"`` or ``"cores"``: the latter two
            also return a `TickTelemetry` / `CoreTelemetry` with (T,) and
            (T, cores) fields (`repro_torch.obs.telemetry`).
        mask: optional (T,) bool - ticks where it is False contribute
            exactly zero stats and zero currents.
        stats0: optional `StepStats` of 0-d fields seeding the accumulator
            (only with ``mask``); zeros when omitted.
        fault_tick0: global tick index of ``spikes[0]`` for the compiled
            `FaultModel`'s drop stream (0 when omitted); only on a session
            compiled with a spike-perturbing fault.
        returns (currents (T, cores, neurons_per_core) float32, accumulated
        `StepStats` of 0-d tensors[, telemetry]); ``stats.summary(ticks=T)``
        gives per-tick means.

        Raises:
          CompositionError: ``mask`` with ``telemetry``, or ``telemetry``
            with ``shard="chips"`` on a multi-chip config.
          ValueError: on a mis-shaped stream or mask, an unknown ``shard``
            or telemetry mode, ``stats0`` without ``mask``, or
            ``fault_tick0`` on a session without a spike-perturbing fault.
        """
        spikes = self._check(spikes, 3)
        if mask is not None:
            mask = torch.as_tensor(mask)[None]
        if stats0 is not None:
            stats0 = StepStats(*(torch.as_tensor(f).reshape(1)
                                 for f in stats0))
        if fault_tick0 is not None:
            fault_tick0 = torch.as_tensor(fault_tick0).reshape(1)
        out = self.run_batched(spikes[None], shard, telemetry, mask, stats0,
                               fault_tick0)
        first = (out[0][0], StepStats(*(f[0] for f in out[1])))
        if len(out) == 2:
            return first
        return first + (_lane(out[2], 0),)

    def run_batched(self, spikes, shard: str | None = None,
                    telemetry: str = "off", mask=None,
                    stats0: StepStats | None = None, fault_tick0=None):
        """Batched run: spikes (B, T, cores, neurons_per_core) bool.

        Returns (currents (B, T, C, N), stats with (B,)-shaped fields, each
        accumulated over that lane's T ticks[, telemetry with (B, T) and
        (B, T, cores) fields]).  The lanes share every tick's launches (a
        written-out batch axis, not a loop over lanes).

        ``mask`` (B, T) bool marks the live ticks of each lane: masked
        ticks contribute zero stats and currents, so ragged streams
        right-padded to one T give each lane the bits of its solo run (an
        all-False lane returns its ``stats0`` row unchanged).  ``stats0``
        seeds the per-lane accumulator ((B,)-shaped fields; zeros when
        omitted); thread the returned stats back in to chunk one stream
        over several calls.  ``fault_tick0`` is a scalar or a (B,) vector
        of per-lane global tick offsets; each lane folds its index into
        the drop stream.  Raises as `run` does.
        """
        sharded = self._mode(shard, telemetry, mask)
        spikes = self._check(spikes, 4)
        spikes = self._apply_fault(spikes, fault_tick0)
        acc0 = None
        if mask is not None:
            mask = self._check_mask(mask, spikes, 2)
            spikes = spikes & mask[:, :, None, None]
            acc0 = self._seed(stats0, spikes.shape[0])
        elif stats0 is not None:
            raise ValueError("stats0 is only meaningful with mask")
        if sharded:
            if self._mesh_ranks():
                return self._mesh_loop(spikes, acc0)
            return self._sharded_loop(spikes, acc0)
        return self._loop(spikes, acc0, telemetry)

    def _mode(self, shard, telemetry, mask) -> bool:
        """Validate the run modes; True for the per-chip sharded body.

        The JAX package's order: ``mask`` with telemetry is refused
        first, then an unknown shard mode, then an unknown telemetry mode,
        then telemetry with a multi-chip shard.
        """
        if mask is not None and telemetry != "off":
            raise CompositionError(
                "mask does not compose with telemetry; run the masked "
                "scan without telemetry (currents and accumulated stats "
                "are bit-identical across paths)")
        if shard not in _SHARD_MODES:
            raise ValueError(
                f"unknown shard mode {shard!r}; expected one of "
                f"{', '.join(repr(m) for m in _SHARD_MODES)}")
        sharded = shard is not None and self.config.chips > 1
        if telemetry != "off":
            obs_telemetry.validate_mode(telemetry)
            if sharded:
                raise CompositionError(
                    "telemetry is not supported together with shard="
                    "'chips'; run unsharded (the default) to collect "
                    "per-tick/per-core series - currents are bit-identical "
                    "across both paths")
        return sharded

    def _loop(self, stream: torch.Tensor, acc0: torch.Tensor | None = None,
              telemetry: str = "off"):
        """(B, T, C, n) frames -> ((B, T, C, n) currents, (B,) stats[,
        telemetry]), each lane's stats summed in tick order from its
        ``acc0`` column ((12, B); None: 0.0)."""
        if self.plan.run is not None:
            stream = stream.contiguous()
            out = pipeline.run_stream(self.plan, self.params, stream,
                                      self._overflow(stream), acc0,
                                      telemetry)
            stats = StepStats(*out[1].unbind(0))
            if telemetry == "off":
                return out[0], stats
            return out[0], stats, _telemetry(out[2], out[3])
        lanes, ticks = stream.shape[:2]
        cores = telemetry == "cores"
        terms = pipeline.arbiter_terms(self.plan, stream)
        stream = stream.transpose(0, 1).contiguous()
        acc = acc0 if acc0 is not None else torch.zeros(
            (len(StepStats._fields), lanes), dtype=torch.float32,
            device=self.device)
        currents, rows, per_core = [], [], []
        for t in range(ticks):
            cur, st, *cs = pipeline.dense_tick(
                self.plan, self.params, stream[t],
                None if terms is None else (terms[0][t], terms[1][t]),
                cores=cores)
            row = torch.stack(tuple(st))
            acc = acc + row
            currents.append(cur)
            rows.append(row)
            per_core += cs
        out = self._stack_currents(currents, lanes)
        stats = StepStats(*acc.unbind(0))
        if telemetry == "off":
            return out, stats
        table = self._stack_rows(rows, lanes)
        core = None
        if cores:
            core = (obs_telemetry.CoreStats(*map(torch.stack, zip(*per_core)))
                    if per_core else self._empty_cores(lanes))
        return out, stats, _telemetry(table, core)

    def _stack_currents(self, currents, lanes):
        if currents:
            return torch.stack(currents, dim=1)
        cfg = self.config
        return torch.zeros((lanes, 0, cfg.cores, cfg.neurons_per_core),
                           dtype=torch.float32, device=self.device)

    def _stack_rows(self, rows, lanes):
        if rows:
            return torch.stack(rows)
        return torch.zeros((0, len(StepStats._fields), lanes),
                           dtype=torch.float32, device=self.device)

    def _empty_cores(self, lanes):
        z = torch.zeros((0, lanes, self.config.cores), dtype=torch.float32,
                        device=self.device)
        return obs_telemetry.CoreStats(*([z] * 5))

    def _overflow(self, stream: torch.Tensor) -> list:
        """Per tick of a (B, T, C, n) stream: does any core of any lane
        exceed the event capacity?  One reduction and one host copy."""
        if stream.shape[0] * stream.shape[1] == 0:
            return [False] * stream.shape[1]
        per_core = stream.sum(-1)                        # (B, T, C)
        return (per_core.amax((0, 2)) > self.plan.run.capacity).tolist()

    # ---- chip sharding ---------------------------------------------------

    def _chip_body(self, frames: torch.Tensor):
        """The per-chip tick over a leading chips axis, in the ``xla``
        form: (B, chips, cores_per_chip, n) frames -> currents of the same
        shape, latencies and enc_per_core (B, chips, cores_per_chip), CAM
        hits (B, chips).  Each chip gathers its entries' sources from the
        whole fabric's spikes.  Every target is local to its core, so the
        session's target CSR never crosses a chip: each target sums its
        own chip's entries in ascending entry order from 0.0, as the
        flat tick does."""
        cfg = self.config
        lanes, chips, cpc, n = frames.shape
        split = (lambda x: x.reshape((chips, cpc) + x.shape[1:]))
        drive = sparse_ref.entry_drive(
            frames.reshape(lanes, -1), split(self.routing.src_idx),
            split(self.routing.active)).to(torch.float32)  # (B, chips, cpc, E)
        contrib = drive * split(self.params.weights)
        currents = sparse_ref.scatter_currents(
            contrib.reshape(lanes, cfg.cores, -1), self.routing.csr, n)
        latencies, enc = pipeline.plain_terms(self.plan, frames)
        hits = drive.sum((-2, -1))
        return currents.reshape(frames.shape), latencies, enc, hits

    def _sharded_tick(self, spikes: torch.Tensor):
        """One tick of (B, cores, n) frames through the per-chip body,
        reassembled in fabric order, then the shared accounting tail."""
        cfg = self.config
        frames = spikes.reshape(spikes.shape[0], cfg.chips, cfg.cores_per_chip,
                                cfg.neurons_per_core)
        cur, lat, enc, hits = self._chip_body(frames)
        lanes = spikes.shape[0]
        stats = pipeline.accounting_stats(
            cfg, self.tables, spikes, lat.reshape(lanes, cfg.cores),
            enc.reshape(lanes, cfg.cores), hits.sum(-1), self.params.valid,
            self.cam_cycle_ns)
        return cur.reshape(spikes.shape), stats

    def _mesh_ranks(self) -> bool:
        """Is there a process group of at least ``chips`` ranks?  Then
        ``shard="chips"`` runs over a ``("chips",)`` mesh of its first
        ``chips`` ranks, as the JAX package maps the body over a device
        mesh when there are enough devices."""
        import torch.distributed as dist
        return (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() >= self.config.chips)

    def _chip_constants(self):
        """This rank's chip of the per-chip constants, placed once: the
        (chips, cores_per_chip, entries) weights, source indices, live
        mask and targets as DTensors split over the chip mesh by
        `leading_axis_specs`, and the chip's own target CSR."""
        if self._chip_shard is not None:
            return self._chip_shard
        from repro_torch.launch.mesh import make_chip_mesh
        from repro_torch.parallel import sharding as shd
        cfg = self.config
        mesh = make_chip_mesh(cfg.chips, device=self.device.type)
        stack = (lambda x: x.reshape((cfg.chips, cfg.cores_per_chip)
                                     + x.shape[1:]))
        per_chip = {"weights": stack(self.params.weights),
                    "targets": stack(self.params.targets),
                    "src_idx": stack(self.routing.src_idx),
                    "active": stack(self.routing.active)}
        placed = (shd.shard_tree(per_chip,
                                 shd.leading_axis_specs(per_chip, "chips"),
                                 mesh)
                  if mesh.get_coordinate() is not None else None)
        local = ({k: v.to_local()[0] for k, v in placed.items()}
                 if placed is not None else None)
        csr = (sparse_ref.build_target_csr(local["targets"], local["active"],
                                           cfg.neurons_per_core)
               if local is not None else None)
        self._chip_shard = (mesh, placed, local, csr)
        return self._chip_shard

    def _mesh_loop(self, stream: torch.Tensor, acc0=None):
        """The sharded run over the chip mesh: this rank steps its own
        chip through every tick (`_chip_body`'s work on one chip, the
        whole fabric's spikes replicated), the per-chip results of the
        whole run are gathered once in chip order (copies, never sums),
        and every rank runs the accounting tail on them tick by tick."""
        from torch.distributed.tensor import DTensor, Shard
        cfg = self.config
        mesh, _, local, csr = self._chip_constants()
        if local is None:                 # a rank beyond the chip mesh
            self.last_shard_body = "single"
            return self._sharded_loop(stream, acc0)
        chip = mesh.get_local_rank("chips")
        lanes, ticks = stream.shape[:2]
        cpc, n = cfg.cores_per_chip, cfg.neurons_per_core
        rows = []
        for t in range(ticks):
            spikes = stream[:, t]
            frames = spikes.reshape(lanes, cfg.chips, cpc, n)[:, chip]
            drive = sparse_ref.entry_drive(
                spikes.reshape(lanes, -1), local["src_idx"],
                local["active"]).to(torch.float32)        # (B, cpc, E)
            cur = sparse_ref.scatter_currents(drive * local["weights"], csr,
                                              n)
            lat, enc = pipeline.plain_terms(self.plan, frames[:, None])
            hits = drive.sum((-2, -1))
            rows.append(torch.cat([cur.reshape(lanes, -1), lat[:, 0],
                                   enc[:, 0], hits[:, None]], dim=-1))
        mine = (torch.stack(rows, dim=1) if rows else torch.zeros(
            (lanes, 0, cpc * n + 2 * cpc + 1), device=self.device))
        packed = DTensor.from_local(mine[:, :, None], mesh, [Shard(2)],
                                    run_check=False).full_tensor()
        cur_all = packed[..., :cpc * n].reshape(lanes, ticks, cfg.cores, n)
        lat_all = packed[..., cpc * n:cpc * n + cpc].reshape(
            lanes, ticks, cfg.cores)
        enc_all = packed[..., cpc * n + cpc:-1].reshape(lanes, ticks,
                                                         cfg.cores)
        hits_all = packed[..., -1].sum(-1)
        acc = acc0 if acc0 is not None else torch.zeros(
            (len(StepStats._fields), lanes), dtype=torch.float32,
            device=self.device)
        for t in range(ticks):
            stats = pipeline.accounting_stats(
                cfg, self.tables, stream[:, t], lat_all[:, t],
                enc_all[:, t], hits_all[:, t], self.params.valid,
                self.cam_cycle_ns)
            acc = acc + torch.stack(tuple(stats))
        self.last_shard_body = "mesh"
        return cur_all, StepStats(*acc.unbind(0))

    def _sharded_loop(self, stream: torch.Tensor, acc0=None):
        """`_loop` over the per-chip sharded tick."""
        self.last_shard_body = "single"
        lanes, ticks = stream.shape[:2]
        stream = stream.transpose(0, 1).contiguous()
        acc = acc0 if acc0 is not None else torch.zeros(
            (len(StepStats._fields), lanes), dtype=torch.float32,
            device=self.device)
        currents = []
        for t in range(ticks):
            cur, st = self._sharded_tick(stream[t])
            acc = acc + torch.stack(tuple(st))
            currents.append(cur)
        return (self._stack_currents(currents, lanes),
                StepStats(*acc.unbind(0)))

    # ---- fault injection -------------------------------------------------

    def _apply_fault(self, spikes: torch.Tensor, fault_tick0):
        """The compiled `FaultModel`'s spike transform on (B, T, C, n)
        frames, lane b keyed by (b, fault_tick0[b] + t).

        A no-op (and ``fault_tick0`` refused) when the session has no
        spike-perturbing fault, so the fault-free path is the plain one.
        """
        if self.fault is None or not self.fault.perturbs_spikes:
            if fault_tick0 is not None:
                raise ValueError(
                    "fault_tick0 is only meaningful on a session compiled "
                    "with a spike-perturbing FaultModel (dead_cores or "
                    "drop_rate)")
            return spikes
        lanes = spikes.shape[0]
        t0 = torch.as_tensor(0 if fault_tick0 is None else fault_tick0,
                             dtype=torch.int64, device=self.device)
        t0 = t0.broadcast_to((lanes,))
        lane = torch.arange(lanes, dtype=torch.int64, device=self.device)
        return self.fault.apply_spikes(spikes, tick0=t0, lane=lane)

    # ---- inputs ----------------------------------------------------------

    def _check_mask(self, mask, spikes, ndim: int) -> torch.Tensor:
        if isinstance(mask, np.ndarray):
            mask = torch.from_numpy(mask)
        mask = torch.as_tensor(mask, device=self.device)
        if tuple(mask.shape) != tuple(spikes.shape[:ndim]):
            raise ValueError(
                f"mask shape {tuple(mask.shape)} does not cover the spike "
                f"stream's leading axes {tuple(spikes.shape[:ndim])}")
        if mask.dtype != torch.bool:
            mask = mask > 0
        return mask

    def _seed(self, stats0, lanes: int) -> torch.Tensor:
        """The (12, B) float32 accumulator seed of ``stats0`` ((B,)
        fields; None: zeros), a fresh tensor on the session's device."""
        if stats0 is None:
            return torch.zeros((len(StepStats._fields), lanes),
                               dtype=torch.float32, device=self.device)
        fields = [torch.as_tensor(np.asarray(f) if not torch.is_tensor(f)
                                  else f) for f in stats0]
        if len(fields) != len(StepStats._fields) or any(
                tuple(f.shape) != (lanes,) for f in fields):
            raise ValueError(
                f"stats0 must be a StepStats of ({lanes},) fields, got "
                f"shapes {[tuple(f.shape) for f in fields]}")
        return torch.stack([f.to(self.device, torch.float32)
                            for f in fields])

    def _check(self, spikes, ndim: int) -> torch.Tensor:
        if isinstance(spikes, np.ndarray):
            spikes = torch.from_numpy(spikes)
        spikes = torch.as_tensor(spikes, device=self.device)
        if spikes.ndim != ndim or tuple(spikes.shape[-2:]) != (
                self.config.cores, self.config.neurons_per_core):
            raise ValueError(
                f"expected {ndim}-d spikes ending in "
                f"({self.config.cores}, {self.config.neurons_per_core}), "
                f"got shape {tuple(spikes.shape)}")
        if spikes.dtype != torch.bool:
            spikes = spikes > 0
        return spikes


def _telemetry(table: torch.Tensor, core):
    """The batched telemetry record of a run: the (T, 12, B) table as
    (B, T) per-tick fields, and the (T, B, cores) `CoreStats` as (B, T,
    cores) fields (None: ``"ticks"``)."""
    per_tick = StepStats(*table.permute(1, 2, 0).unbind(0))
    if core is None:
        return obs_telemetry.TickTelemetry(per_tick=per_tick)
    return obs_telemetry.CoreTelemetry(
        per_tick=per_tick,
        per_core=obs_telemetry.CoreStats(*(f.transpose(0, 1) for f in core)))


def _lane(record, b: int):
    """One lane of a batched telemetry record."""
    if isinstance(record, obs_telemetry.TickTelemetry):
        return obs_telemetry.TickTelemetry(
            per_tick=StepStats(*(f[b] for f in record.per_tick)))
    return obs_telemetry.CoreTelemetry(
        per_tick=StepStats(*(f[b] for f in record.per_tick)),
        per_core=obs_telemetry.CoreStats(*(f[b] for f in record.per_core)))

