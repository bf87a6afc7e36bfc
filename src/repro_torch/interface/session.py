"""Compile-once sessions over the core-interface pipeline.

Port of the flat, unmasked path of `repro.interface.session`.
`Interface(config).compile(params)` builds the NoC tables, the CAM
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

Masked runs (the serving tier's ragged lanes): ``mask`` erases each
masked tick by ``spikes & mask`` before the loop, whose body is the
unmasked one; an all-False frame gives exactly zero `StepStats` and zero
currents under every impl and scheme.  ``stats0`` seeds each lane's
accumulator, so a stream served in chunks sums its stats in the order of
one uninterrupted run, bit for bit (under ``pallas_sparse`` the seed is
the first term of the kernel's tick-order sum).

Not ported yet (`NotImplementedError`, naming the ROADMAP queue A item):
``chips > 1``, ``shard=``, ``telemetry=`` and ``fault_tick0=`` (item 7),
``fault=`` (item 9).  ``mask`` with ``telemetry`` raises the JAX
package's `CompositionError`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import arbiter as arb
from repro_torch.core import cam as cam_mod
from repro_torch.interface import pipeline
from repro_torch.interface.config import as_interface_config
from repro_torch.interface.stats import StepStats
from repro_torch.interface.types import InterfaceParams, resolve_device

_SHARD_MODES = (None, "chips")


class CompositionError(ValueError):
    """A requested run-mode combination is not supported.

    Typed rejection (still a ValueError), as in the JAX package: today
    ``mask`` together with ``telemetry``, and ``shard="chips"`` on a
    one-chip tenant config (`repro_torch.serve.TenantSpec`).
    """


class Interface:
    """Factory for precompiled sessions over one interface configuration."""

    def __init__(self, config):
        """config: `InterfaceConfig` or a field-compatible config."""
        self.config = as_interface_config(config)

    def compile(self, params, device=None, fault=None) -> "InterfaceSession":
        """Bind routing state on ``device``; build all plans/tables once.

        Raises:
          RuntimeError: ``device`` is None or CUDA and there is no GPU.
          ValueError: ``impl="pallas_sparse"`` and a configured scheme
            lacks sparse tick policies (`pipeline.resolve_sparse_plan`).
          NotImplementedError: on a surface not ported yet.
        """
        if fault is not None:
            raise pipeline.not_ported("compile(fault=...) (FaultModel)", 9)
        return InterfaceSession(self.config, params, device=device)


class InterfaceSession:
    """A precompiled (config, params) binding on one device.

    Attributes built once at construction:
      tables    NoC subscription/hop/link tables (`NocTables`)
      arb_plan  arbiter plan (`ArbiterConfig`)
      routing   CAM tags decoded to source addresses (`RoutingIndex`)
      cam_cycle_ns  CAM search cycle time for the configured variant
      device    where every tensor of the session lives
    """

    def __init__(self, config, params, device=None):
        self.config = cfg = as_interface_config(config)
        if cfg.chips > 1:
            raise pipeline.not_ported("chips > 1", 7)
        self.device = resolve_device(device)
        self.params = InterfaceParams(*params).to(self.device)
        self.arb_plan = arb.ArbiterConfig(cfg.scheme, cfg.neurons_per_core)
        self.tables = pipeline.build_tables(self.params, cfg)
        self.cam_cycle_ns = cam_mod.cycle_time_ns(cfg.cam)
        self.plan = pipeline.make_plan(self.params, cfg, self.tables,
                                       self.arb_plan,
                                       cam_cycle_ns=self.cam_cycle_ns)
        self.routing = self.plan.routing

    # ---- execution -------------------------------------------------------

    def step(self, spikes) -> tuple[torch.Tensor, StepStats]:
        """One tick.  spikes: (cores, neurons_per_core) bool."""
        spikes = self._check(spikes, 2)
        currents, stats = pipeline.tick(self.plan, self.params, spikes[None])
        return currents[0], StepStats(*(f[0] for f in stats))

    def run(self, spikes, shard: str | None = None, telemetry: str = "off",
            mask=None, stats0: StepStats | None = None, fault_tick0=None
            ) -> tuple[torch.Tensor, StepStats]:
        """Multi-timestep simulation, ticks in order.

        spikes: (T, cores, neurons_per_core) bool
        mask: optional (T,) bool - ticks where it is False contribute
            exactly zero stats and zero currents.
        stats0: optional `StepStats` of 0-d fields seeding the accumulator
            (only with ``mask``); zeros when omitted.
        returns (currents (T, cores, neurons_per_core) float32, accumulated
        `StepStats` of 0-d tensors); ``stats.summary(ticks=T)`` gives
        per-tick means.

        Raises:
          CompositionError: ``mask`` with ``telemetry``.
          ValueError: on a mis-shaped stream or mask, an unknown ``shard``
            mode, or ``stats0`` without ``mask``.
          NotImplementedError: ``shard=``, ``telemetry=`` or
            ``fault_tick0=`` (ROADMAP queue A item 7).
        """
        spikes = self._check(spikes, 3)
        if mask is not None:
            mask = torch.as_tensor(mask)[None]
        if stats0 is not None:
            stats0 = StepStats(*(torch.as_tensor(f).reshape(1)
                                 for f in stats0))
        currents, stats = self.run_batched(spikes[None], shard, telemetry,
                                           mask, stats0, fault_tick0)
        return currents[0], StepStats(*(f[0] for f in stats))

    def run_batched(self, spikes, shard: str | None = None,
                    telemetry: str = "off", mask=None,
                    stats0: StepStats | None = None, fault_tick0=None
                    ) -> tuple[torch.Tensor, StepStats]:
        """Batched run: spikes (B, T, cores, neurons_per_core) bool.

        Returns (currents (B, T, C, N), stats with (B,)-shaped fields, each
        accumulated over that lane's T ticks).  The lanes share every
        tick's launches (a written-out batch axis, not a loop over lanes).

        ``mask`` (B, T) bool marks the live ticks of each lane: masked
        ticks contribute zero stats and currents, so ragged streams
        right-padded to one T give each lane the bits of its solo run (an
        all-False lane returns its ``stats0`` row unchanged).  ``stats0``
        seeds the per-lane accumulator ((B,)-shaped fields; zeros when
        omitted); thread the returned stats back in to chunk one stream
        over several calls.  Raises as `run` does.
        """
        self._refuse(shard, telemetry, mask, fault_tick0)
        spikes = self._check(spikes, 4)
        if mask is not None:
            mask = self._check_mask(mask, spikes, 2)
            return self._loop(spikes & mask[:, :, None, None],
                              self._seed(stats0, spikes.shape[0]))
        if stats0 is not None:
            raise ValueError("stats0 is only meaningful with mask")
        return self._loop(spikes)

    def _loop(self, stream: torch.Tensor, acc0: torch.Tensor | None = None):
        """(B, T, C, n) frames -> ((B, T, C, n) currents, (B,) stats),
        each lane's stats summed in tick order from its ``acc0`` column
        ((12, B); None: 0.0)."""
        if self.plan.run is not None:
            stream = stream.contiguous()
            currents, acc = pipeline.run_stream(
                self.plan, self.params, stream, self._overflow(stream), acc0)
            return currents, StepStats(*acc.unbind(0))
        lanes, ticks = stream.shape[:2]
        terms = pipeline.arbiter_terms(self.plan, stream)
        stream = stream.transpose(0, 1).contiguous()
        acc = acc0 if acc0 is not None else torch.zeros(
            (len(StepStats._fields), lanes), dtype=torch.float32,
            device=self.device)
        currents = []
        for t in range(ticks):
            cur, st = pipeline.dense_tick(
                self.plan, self.params, stream[t],
                None if terms is None else (terms[0][t], terms[1][t]))
            acc = acc + torch.stack(tuple(st))
            currents.append(cur)
        cfg = self.config
        if currents:
            out = torch.stack(currents, dim=1)
        else:
            out = torch.zeros((lanes, 0, cfg.cores, cfg.neurons_per_core),
                              dtype=torch.float32, device=self.device)
        return out, StepStats(*acc.unbind(0))

    def _overflow(self, stream: torch.Tensor) -> list:
        """Per tick of a (B, T, C, n) stream: does any core of any lane
        exceed the event capacity?  One reduction and one host copy."""
        if stream.shape[0] * stream.shape[1] == 0:
            return [False] * stream.shape[1]
        per_core = stream.sum(-1)                        # (B, T, C)
        return (per_core.amax((0, 2)) > self.plan.run.capacity).tolist()

    def _refuse(self, shard, telemetry, mask, fault_tick0):
        """Refuse, by name, the run modes this package does not carry,
        and ``mask`` with ``telemetry`` as the JAX package does."""
        if shard not in _SHARD_MODES:
            raise ValueError(
                f"unknown shard mode {shard!r}; expected one of "
                f"{', '.join(repr(m) for m in _SHARD_MODES)}")
        if mask is not None and telemetry != "off":
            raise CompositionError(
                "mask does not compose with telemetry; run the masked "
                "scan without telemetry (currents and accumulated stats "
                "are bit-identical across paths)")
        if shard is not None:
            raise pipeline.not_ported(f"run(shard={shard!r})", 7)
        if telemetry != "off":
            raise pipeline.not_ported(f"run(telemetry={telemetry!r})", 7)
        if fault_tick0 is not None:
            raise pipeline.not_ported("run(fault_tick0=...)", 7)

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
