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

Not ported yet (`NotImplementedError`, naming the ROADMAP queue A item):
``chips > 1``, ``shard=``, ``mask=``/``stats0=``, ``telemetry=`` and
``fault_tick0=`` (item 7), ``fault=`` (item 9).
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
        returns (currents (T, cores, neurons_per_core) float32, accumulated
        `StepStats` of 0-d tensors); ``stats.summary(ticks=T)`` gives
        per-tick means.
        """
        self._refuse(shard, telemetry, mask, stats0, fault_tick0)
        spikes = self._check(spikes, 3)
        currents, stats = self._loop(spikes[None])
        return currents[0], StepStats(*(f[0] for f in stats))

    def run_batched(self, spikes, shard: str | None = None,
                    telemetry: str = "off", mask=None,
                    stats0: StepStats | None = None, fault_tick0=None
                    ) -> tuple[torch.Tensor, StepStats]:
        """Batched run: spikes (B, T, cores, neurons_per_core) bool.

        Returns (currents (B, T, C, N), stats with (B,)-shaped fields, each
        accumulated over that lane's T ticks).  The lanes share every
        tick's launches (a written-out batch axis, not a loop over lanes).
        """
        self._refuse(shard, telemetry, mask, stats0, fault_tick0)
        spikes = self._check(spikes, 4)
        return self._loop(spikes)

    def _loop(self, stream: torch.Tensor):
        """(B, T, C, n) frames -> ((B, T, C, n) currents, (B,) stats)."""
        if self.plan.run is not None:
            stream = stream.contiguous()
            currents, acc = pipeline.run_stream(
                self.plan, self.params, stream, self._overflow(stream))
            return currents, StepStats(*acc.unbind(0))
        lanes, ticks = stream.shape[:2]
        terms = pipeline.arbiter_terms(self.plan, stream)
        stream = stream.transpose(0, 1).contiguous()
        acc = torch.zeros((len(StepStats._fields), lanes),
                          dtype=torch.float32, device=self.device)
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

    def _refuse(self, shard, telemetry, mask, stats0, fault_tick0):
        """Refuse, by name, the run modes this package does not carry."""
        if shard not in _SHARD_MODES:
            raise ValueError(
                f"unknown shard mode {shard!r}; expected one of "
                f"{', '.join(repr(m) for m in _SHARD_MODES)}")
        if shard is not None:
            raise pipeline.not_ported(f"run(shard={shard!r})", 7)
        if telemetry != "off":
            raise pipeline.not_ported(f"run(telemetry={telemetry!r})", 7)
        if mask is not None or stats0 is not None:
            raise pipeline.not_ported("run(mask=..., stats0=...)", 7)
        if fault_tick0 is not None:
            raise pipeline.not_ported("run(fault_tick0=...)", 7)

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
