"""Tenant specifications for the fabric serving tier.

Port of `repro.serve.tenant`.  A *tenant* is one independent user of the
interface fabric: it owns an `InterfaceConfig`, a `repro_torch.traffic`
scenario (its tick-stream workload), and a seed.  Tenants do not own a
compiled session - the engine packs *compatible* tenants (same fabric
configuration and connectivity, see `compat_key`) onto one precompiled
`InterfaceSession` and steps them as lanes of a single masked
`run_batched` call.

A tenant's stream is drawn on the CPU from a `torch.Generator` keyed by
(seed, round) (`repro_torch.traffic.stream_seed`), so it is the same
whether the engine serves on the card or on the CPU, and a caller can
rebuild it for a solo run.  A tenant may compile a fabric `FaultModel`
into its session (``fault=``) and step its group through the per-chip
sharded tick (``shard="chips"``, on a multi-chip config).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from repro_torch import traffic
from repro_torch.ft.faults import FaultModel
from repro_torch.interface.config import InterfaceConfig, as_interface_config
from repro_torch.interface.session import CompositionError
from repro_torch.interface.types import random_connectivity


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant: a fabric config plus the traffic it will stream.

    name:               unique tenant id (the metrics/report label).
    config:             `InterfaceConfig` (any field-compatible config is
                        lifted at construction).
    scenario:           registered `repro_torch.traffic` scenario driving
                        this tenant's tick stream.
    scenario_params:    overrides merged into the scenario's defaults.
    seed:               tenant-private seed of the tick stream.
    connectivity_seed:  seed of the shared fabric connectivity; part of
                        the compatibility key - tenants only share a
                        session when they share (config, connectivity).
    fault:              optional `repro_torch.ft.faults.FaultModel`
                        compiled into this tenant's session.  Part of the
                        compatibility key, so faulted tenants never share
                        a session with clean ones.
    shard:              None, or ``"chips"``: this tenant's group steps
                        through the per-chip sharded tick (the session's
                        single-device body over a chips axis).  Needs
                        ``config.chips > 1``: on a one-chip config the
                        typed `CompositionError`.  Part of the
                        compatibility key.
    """

    name: str
    config: InterfaceConfig
    scenario: str = "sparse_poisson"
    scenario_params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    seed: int = 0
    connectivity_seed: int = 0
    fault: FaultModel | None = None
    shard: str | None = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        object.__setattr__(self, "config", as_interface_config(self.config))
        if self.shard is not None:
            if self.shard != "chips":
                raise ValueError(
                    f"tenant {self.name!r}: unknown shard mode "
                    f"{self.shard!r}; expected None or 'chips'")
            if self.config.chips == 1:
                raise CompositionError(
                    f"tenant {self.name!r}: shard='chips' on a one-chip "
                    f"config would silently run the flat path; use a config "
                    f"with chips > 1 or omit shard")
        if self.fault is not None:
            if not isinstance(self.fault, FaultModel):
                raise ValueError(
                    f"tenant {self.name!r}: fault must be a FaultModel, "
                    f"got {type(self.fault).__name__}")
            self.fault.validate(self.config)
        # fail at registration, not first flush, on unknown scenarios/params
        spec = traffic.get_scenario(self.scenario)
        unknown = sorted(set(self.scenario_params) - set(spec.defaults))
        if unknown:
            raise ValueError(
                f"tenant {self.name!r}: unknown scenario parameter(s) "
                f"{', '.join(unknown)} for {self.scenario!r}; valid: "
                f"{', '.join(sorted(spec.defaults))}")

    def stream(self, ticks: int, round: int = 0) -> torch.Tensor:
        """(ticks, cores, neurons_per_core) bool CPU tick stream of one
        round.

        Successive ``round`` values give the generator a fresh seed
        (`repro_torch.traffic.stream_seed`), so a tenant streaming in
        chunks draws fresh (but deterministic) traffic each round.
        """
        gen = torch.Generator().manual_seed(
            traffic.stream_seed(self.seed, round))
        return traffic.generate(self.scenario, gen, ticks, self.config,
                                **dict(self.scenario_params))

    def expected_rate(self) -> float:
        """Analytic mean spike probability of this tenant's stream."""
        return traffic.expected_rate(
            self.scenario, self.config.cores, self.config.neurons_per_core,
            **dict(self.scenario_params))


def compat_key(spec: TenantSpec) -> tuple:
    """Hashable session-compatibility key.

    Tenants mapping to the same key are guaranteed steppable as lanes of
    one `InterfaceSession.run_batched` call: the session binds (config,
    connectivity) and, when set, the compiled-in `FaultModel`, so all
    three are pinned here, plus the ``shard`` placement.  Scenario and
    seed stay out - a group legitimately mixes workloads.
    """
    return (spec.config, spec.connectivity_seed, spec.fault, spec.shard)


def default_connectivity(config: InterfaceConfig, connectivity_seed: int,
                         device=None):
    """The deterministic shared connectivity a group compiles against:
    `random_connectivity` drawn on the CPU from ``connectivity_seed`` (the
    same tensors whichever device serves), moved to ``device`` when given
    (None leaves it on the CPU)."""
    return random_connectivity(torch.Generator().manual_seed(
        int(connectivity_seed)), config, device=device)
