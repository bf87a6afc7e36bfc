"""DEPRECATED shim over `repro_torch.interface` - the multi-core fabric.

Port of `repro.core.fabric`, kept so call sites written against the
legacy API run on the port:

  * `FabricConfig` is the legacy config type (validating, like the JAX
    one, that an explicit ``cam=CamConfig(...)`` agrees with
    ``cam_entries_per_core``);
  * `FabricParams` / `StepStats` / `int_to_bits` / `random_connectivity`
    re-export the `repro_torch.interface` definitions;
  * `step` delegates to `repro_torch.interface.pipeline.interface_tick`
    and warns with a `DeprecationWarning`.

New code uses `repro_torch.interface.Interface(cfg).compile(params)`.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import torch

from repro_torch.core import cam as cam_mod
from repro_torch.interface import pipeline as _pipeline
from repro_torch.interface import report as _report
from repro_torch.interface.config import resolve_cam, resolve_chips
from repro_torch.interface.stats import StepStats  # noqa: F401  (re-export)
from repro_torch.interface.types import (  # noqa: F401  (re-exports)
    InterfaceParams as FabricParams,
    int_to_bits,
    random_connectivity,
)
from repro_torch.noc import topology as noc_topology


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    cores: int | None = None                 # total; default 4 when omitted
    neurons_per_core: int = 256
    cam_entries_per_core: int | None = None  # defaults to 512 w/o explicit cam
    scheme: str = "hier_tree"
    cam: cam_mod.CamConfig | None = None
    noc: noc_topology.NocConfig | None = None
    impl: str = "xla"            # "xla" | "pallas" | "pallas_sparse"
    chips: int = 1                           # cores = chips x cores_per_chip
    cores_per_chip: int | None = None        # derived: cores // chips
    sparse_capacity: int | None = None       # pallas_sparse event budget

    def __post_init__(self):
        cores, per_chip = resolve_chips(self.chips, self.cores,
                                        self.cores_per_chip)
        object.__setattr__(self, "cores", cores)
        object.__setattr__(self, "cores_per_chip", per_chip)
        cam, entries = resolve_cam(self.cam, self.cam_entries_per_core)
        object.__setattr__(self, "cam", cam)
        object.__setattr__(self, "cam_entries_per_core", entries)
        if self.noc is None:
            object.__setattr__(self, "noc", noc_topology.NocConfig())
        if self.impl not in ("xla", "pallas", "pallas_sparse"):
            raise ValueError(
                f"unknown impl {self.impl!r}; expected 'xla', 'pallas' or "
                f"'pallas_sparse'")
        if self.sparse_capacity is not None and self.sparse_capacity < 1:
            raise ValueError(
                f"sparse_capacity must be a positive event count, got "
                f"{self.sparse_capacity}")

    @property
    def tag_bits(self) -> int:
        return max(1, math.ceil(math.log2(self.cores * self.neurons_per_core)))


def noc_tables(params: FabricParams, cfg: FabricConfig):
    """Routing tables for the configured NoC scheme (build once, reuse)."""
    return _pipeline.build_tables(params, cfg)


def step(params: FabricParams, spikes: torch.Tensor, cfg: FabricConfig,
         tables=None) -> tuple[torch.Tensor, StepStats]:
    """One fabric tick.  DEPRECATED: use `repro_torch.interface.Interface`.

    spikes: (cores, neurons_per_core) bool; tables: optional precomputed
    `noc_tables(params, cfg)`.  Returns currents (cores, neurons_per_core)
    float32 and scalar `StepStats`, the bits of `InterfaceSession.run`.
    """
    warnings.warn(
        "fabric.step is deprecated; use repro_torch.interface.Interface(cfg)"
        ".compile(params).run(spikes) for the compile-once API",
        DeprecationWarning, stacklevel=2)
    return _pipeline.interface_tick(params, spikes, cfg, tables)


def interface_area_um2(cfg: FabricConfig) -> dict:
    """Static area report for one core's interface (model units/um^2)."""
    return _report.interface_area_um2(cfg)
