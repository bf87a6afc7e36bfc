"""Unified PPA entry point for the core interface.

Port of `repro.interface.report`: `ppa_report(config)` gathers, in one
dict, the area/latency/energy accounting that is a function of the
configuration alone - the arbiter closed forms (unit-domain and
calibrated ns), the CAM variant's cycle time / energy / area, and the
NoC static topology facts.  Dynamic per-tick costs come from
`InterfaceSession.run`'s `StepStats`.  The keys and values are the JAX
package's; ``chips > 1`` raises `NotImplementedError` (ROADMAP queue A
item 7), as the sessions do.
"""

from __future__ import annotations

import torch

from repro_torch.core import cam as cam_mod
from repro_torch.core import ppa
from repro_torch.interface.config import as_interface_config
from repro_torch.interface.pipeline import not_ported
from repro_torch.noc import topology


def _closed_form(fn, scheme: str, n: int):
    """Closed forms exist only for the paper's five schemes; custom
    arbiters registered at runtime report None instead of crashing."""
    return fn(scheme, n) if scheme in ppa.SCHEMES else None


def interface_area_um2(cfg) -> dict:
    """Static area report for one core's interface (model units/um^2)."""
    n = cfg.neurons_per_core
    return {
        "arbiter_norm_area": _closed_form(ppa.area_normalized, cfg.scheme, n),
        "arbiter_units": _closed_form(ppa.area_units, cfg.scheme, n),
        "cam_um2": cam_mod.area_um2(cfg.cam),
        "cam_um2_baseline": cam_mod.area_um2(
            cam_mod.CamConfig(cfg.cam.entries, cscd=False, feedback=False,
                              speculative=False)),
    }


def ppa_report(config) -> dict:
    """One dict covering arbiter / CAM / NoC area, latency and energy.

    config: `InterfaceConfig` or a field-compatible config.

    Raises:
      NotImplementedError: ``chips > 1`` (ROADMAP queue A item 7).
    """
    cfg = as_interface_config(config)
    if cfg.chips > 1:
        raise not_ported("ppa_report at chips > 1", 7)
    n = cfg.neurons_per_core
    cam = cfg.cam
    conv = cam_mod.CamConfig(cam.entries, cscd=False, feedback=False,
                             speculative=False)
    mesh_cores = cfg.cores
    w, h = topology.mesh_dims(mesh_cores)
    hops = topology.hop_matrix(mesh_cores, device="cpu")
    chip_hops = topology.hop_matrix(cfg.chips, device="cpu")
    area = interface_area_um2(cfg)

    return {
        "config": {
            "cores": cfg.cores,
            "chips": cfg.chips,
            "cores_per_chip": cfg.cores_per_chip,
            "neurons_per_core": n,
            "tag_bits": cfg.tag_bits,
            "arbiter": cfg.scheme,
            "cam_variant": cam.variant,
            "cam_entries": cam.entries,
            "noc_scheme": cfg.noc.scheme,
        },
        "arbiter": {
            "sparse_latency_units": _closed_form(ppa.sparse_latency_units,
                                                 cfg.scheme, n),
            "burst_latency_units": _closed_form(ppa.burst_latency_units,
                                                cfg.scheme, n),
            "sparse_latency_ns": _closed_form(ppa.sparse_latency_ns,
                                              cfg.scheme, n),
            "burst_latency_ns": _closed_form(ppa.burst_latency_ns,
                                             cfg.scheme, n),
            "area_units": area["arbiter_units"],
            "area_normalized": area["arbiter_norm_area"],
        },
        "cam": {
            "cycle_time_ns": cam_mod.cycle_time_ns(cam),
            "cycle_time_ns_conventional": cam_mod.cycle_time_ns(conv),
            "cycle_improvement": cam_mod.cycle_improvement(cam.entries),
            "search_energy_all_match": cam_mod.search_energy(
                cam, float(cam.entries), 0.0),
            "search_energy_all_mismatch": cam_mod.search_energy(
                cam, 0.0, float(cam.entries)),
            "area_um2": area["cam_um2"],
            "area_um2_conventional": area["cam_um2_baseline"],
        },
        "noc": {
            "mesh_dims": (w, h),
            "links": topology.num_links(mesh_cores) * cfg.chips,
            "mean_hop_distance": float(hops.to(torch.float32).mean()),
            "max_hop_distance": int(hops.max()),
            "hop_latency_ns": ppa.NOC_HOP_LATENCY_NS,
            "link_serialization_ns": ppa.NOC_LINK_SERIALIZATION_NS,
            "hop_energy": ppa.NOC_HOP_ENERGY,
        },
        "hierarchy": {
            "chips": cfg.chips,
            "chip_mesh_dims": topology.mesh_dims(cfg.chips),
            "chip_links": topology.num_links(cfg.chips),
            "mean_chip_hop_distance": float(
                chip_hops.to(torch.float32).mean()),
            "max_chip_hop_distance": int(chip_hops.max()),
            "chip_hop_latency_ns": ppa.CHIP_HOP_LATENCY_NS,
            "chip_link_serialization_ns": ppa.CHIP_LINK_SERIALIZATION_NS,
            "chip_hop_energy": ppa.CHIP_HOP_ENERGY,
        },
        "per_core_area": {
            "arbiter_units": area["arbiter_units"],
            "cam_um2": area["cam_um2"],
        },
    }
