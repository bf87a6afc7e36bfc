"""`repro_torch.interface` - the core-interface API of the PyTorch port.

The same surface as `repro.interface`, on torch tensors:

    from repro_torch.interface import Interface, InterfaceConfig

    cfg = InterfaceConfig(cores=16, neurons_per_core=256,
                          cam_entries_per_core=512, impl="pallas_sparse")
    params = random_connectivity(torch.Generator("cuda").manual_seed(0), cfg)
    session = Interface(cfg).compile(params)      # on the GPU by default
    currents, stats = session.run(spikes_TxCxN)   # ticks in order
    stats.summary(ticks=T)                        # per-tick means

Scheme selection goes through the registries in
`repro_torch.interface.registry`, as in the JAX package.
"""

from __future__ import annotations

import importlib

from repro_torch.interface import registry  # noqa: F401  (dependency-free)
from repro_torch.interface.registry import (  # noqa: F401
    ARBITERS,
    CAM_VARIANTS,
    NOC_SCHEMES,
    get_arbiter,
    get_cam_variant,
    get_noc_scheme,
    register_arbiter,
    register_cam_variant,
    register_noc_scheme,
)

_LAZY_EXPORTS = {
    "Interface": "repro_torch.interface.session",
    "InterfaceSession": "repro_torch.interface.session",
    "InterfaceConfig": "repro_torch.interface.config",
    "as_interface_config": "repro_torch.interface.config",
    "StepStats": "repro_torch.interface.stats",
    "InterfaceParams": "repro_torch.interface.types",
    "int_to_bits": "repro_torch.interface.types",
    "random_connectivity": "repro_torch.interface.types",
    "params_from_numpy": "repro_torch.interface.types",
    "interface_tick": "repro_torch.interface.pipeline",
    "accounting_stats": "repro_torch.interface.pipeline",
    "build_tables": "repro_torch.interface.pipeline",
    "RoutingIndex": "repro_torch.interface.pipeline",
    "build_routing_index": "repro_torch.interface.pipeline",
    "ppa_report": "repro_torch.interface.report",
    "interface_area_um2": "repro_torch.interface.report",
}

__all__ = sorted([
    "registry", "ARBITERS", "CAM_VARIANTS", "NOC_SCHEMES",
    "register_arbiter", "register_cam_variant", "register_noc_scheme",
    "get_arbiter", "get_cam_variant", "get_noc_scheme",
    *_LAZY_EXPORTS,
])


def __getattr__(name: str):
    module = _LAZY_EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'repro_torch.interface' has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value     # cache for subsequent lookups
    return value


def __dir__():
    return __all__
