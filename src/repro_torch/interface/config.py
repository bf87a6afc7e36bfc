"""`InterfaceConfig`: the validated static description of one fabric.

Port of `repro.interface.config`: the same fields, the same validation
and the same error messages under the same conditions.  The legacy
`repro_torch.core.fabric.FabricConfig` (or any field-compatible config,
the JAX package's included) lifts into it through `from_fabric`, and
`fabric()` goes back.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import cam as cam_mod
from repro_torch.noc import topology as noc_topology


def resolve_cam(cam: cam_mod.CamConfig | None, entries: int | None,
                default_entries: int = 512):
    """Shared cam/cam_entries_per_core reconciliation.

    Returns the effective ``(cam, entries)`` pair; raises `ValueError`
    when an explicit config and an explicit entry count disagree.
    """
    if cam is None:
        cam = cam_mod.CamConfig(entries=default_entries if entries is None
                                else entries)
    elif entries is not None and cam.entries != entries:
        raise ValueError(
            f"cam_entries_per_core={entries} conflicts with explicit "
            f"cam=CamConfig(entries={cam.entries}); pass one or make them agree")
    return cam, cam.entries


def resolve_chips(chips: int, cores: int | None,
                  cores_per_chip: int | None, default_cores: int = 4):
    """Shared chips/cores/cores_per_chip reconciliation.

    ``cores`` is the *total* core count and is authoritative when given;
    otherwise it is ``chips * cores_per_chip`` (or ``default_cores``).
    See `repro.interface.config.resolve_chips` for the full contract.

    Returns the effective ``(cores, cores_per_chip)`` pair.
    """
    if not isinstance(chips, int) or chips < 1:
        raise ValueError(f"chips must be a positive int, got {chips!r}")
    if cores is None:
        cores = (chips * cores_per_chip if cores_per_chip is not None
                 else default_cores)
    if cores_per_chip is not None and chips * cores_per_chip == cores:
        return cores, cores_per_chip
    if cores_per_chip is not None and cores % cores_per_chip != 0:
        raise ValueError(
            f"cores_per_chip={cores_per_chip} conflicts with cores={cores} "
            f"and cannot be a stale derived value; pass chips (and "
            f"optionally cores_per_chip) to repartition")
    if cores % chips != 0:
        raise ValueError(
            f"cores={cores} conflicts with chips={chips}"
            + (f" (cores_per_chip={cores_per_chip})"
               if cores_per_chip is not None else "")
            + ": chips must divide the total core count "
            "(or pass cores_per_chip alone to derive the total)")
    return cores, cores // chips


@dataclasses.dataclass(frozen=True)
class InterfaceConfig:
    """Static description of the full core-interface pipeline.

    Fields as in `repro.interface.config.InterfaceConfig`.  ``impl``
    selects the tick backend: ``"xla"`` (the gather/scatter event tick in
    plain torch), ``"pallas_sparse"`` (every tick without an overflowing
    core through the fused `repro_torch.kernels.sparse_tick` kernel, one
    launch a run, with the dense tick as the overflow fallback), or
    ``"pallas"`` (the dense tick with the CAM match through the
    `repro_torch.kernels.cam_search` kernel and the AER streams through
    the `repro_torch.kernels.hat_encode` kernel).
    """

    cores: int | None = None                  # total; default 4 when omitted
    neurons_per_core: int = 256
    cam_entries_per_core: int | None = None   # defaults to 512 w/o explicit cam
    scheme: str = "hier_tree"
    cam: cam_mod.CamConfig | None = None
    noc: noc_topology.NocConfig | None = None
    impl: str = "xla"
    chips: int = 1
    cores_per_chip: int | None = None         # derived: cores // chips
    sparse_capacity: int | None = None        # pallas_sparse event budget

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
        # Fail at construction, not at first tick, on unregistered schemes.
        from repro_torch.core import arbiter  # noqa: F401  (registers built-ins)
        from repro_torch.interface import registry
        if self.scheme not in registry.ARBITERS:
            raise ValueError(
                f"unknown arbiter scheme {self.scheme!r}; registered: "
                f"{', '.join(registry.ARBITERS.names())}")
        if self.cam.variant not in registry.CAM_VARIANTS:
            raise ValueError(
                f"unknown CAM variant {self.cam.variant!r}; registered: "
                f"{', '.join(registry.CAM_VARIANTS.names())}")

    @property
    def tag_bits(self) -> int:
        """AER address width: bits needed to tag every neuron uniquely."""
        return max(1, math.ceil(math.log2(self.cores * self.neurons_per_core)))

    @classmethod
    def from_fabric(cls, cfg) -> "InterfaceConfig":
        """Lift a legacy `FabricConfig` (or any field-compatible config)
        into a validated `InterfaceConfig`.  A foreign ``cam``/``noc`` is
        rebuilt from its fields as this package's own config."""
        cam = cfg.cam
        if not isinstance(cam, cam_mod.CamConfig):
            cam = cam_mod.CamConfig(**dataclasses.asdict(cam))
        noc = cfg.noc
        if not isinstance(noc, noc_topology.NocConfig):
            noc = noc_topology.NocConfig(noc.scheme)
        return cls(cores=cfg.cores, neurons_per_core=cfg.neurons_per_core,
                   scheme=cfg.scheme, cam=cam, noc=noc,
                   impl=getattr(cfg, "impl", "xla"),
                   chips=getattr(cfg, "chips", 1),
                   sparse_capacity=getattr(cfg, "sparse_capacity", None))

    def fabric(self):
        """The equivalent legacy `FabricConfig` (for un-migrated call
        sites)."""
        from repro_torch.core import fabric as fabric_mod
        return fabric_mod.FabricConfig(
            cores=self.cores, neurons_per_core=self.neurons_per_core,
            scheme=self.scheme, cam=self.cam, noc=self.noc, impl=self.impl,
            chips=self.chips, sparse_capacity=self.sparse_capacity)


def as_interface_config(config) -> InterfaceConfig:
    """Accept an `InterfaceConfig` or any field-compatible config object
    (lifted by `InterfaceConfig.from_fabric`)."""
    if isinstance(config, InterfaceConfig):
        return config
    return InterfaceConfig.from_fabric(config)
