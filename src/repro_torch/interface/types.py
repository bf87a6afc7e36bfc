"""Shared datatypes of the core-interface pipeline.

Port of `repro.interface.types`.  `InterfaceParams` is the routing state
every stage operates on: the CAM tags/valid bits that define
subscriptions, plus synaptic weights and per-core target rows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class InterfaceParams(NamedTuple):
    """Routing state of the whole fabric (tensors on one device)."""
    tags: torch.Tensor      # (cores, entries, tag_bits) int32 {0,1} source tags
    valid: torch.Tensor     # (cores, entries) bool
    weights: torch.Tensor   # (cores, entries) float32 synaptic weight
    targets: torch.Tensor   # (cores, entries) int32 target neuron within core

    def to(self, device) -> "InterfaceParams":
        """The same routing state on ``device``."""
        return InterfaceParams(*(t.to(device) for t in self))


def int_to_bits(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Big-endian {0,1} int32 bit expansion along a trailing axis."""
    shifts = torch.arange(bits - 1, -1, -1, device=x.device)
    return ((x[..., None] >> shifts) & 1).to(torch.int32)


def random_connectivity(generator: torch.Generator, cfg, fan_in: float = 0.9,
                        device=None) -> InterfaceParams:
    """Random routing tables: each CAM entry subscribes to a random source.

    Draws from ``generator`` (so the tensors are made on the generator's
    device) and moves them to ``device`` when given.  The numbers differ
    from `repro.interface.random_connectivity` for the same seed; use
    `params_from_numpy` to give both packages the same routing state.
    """
    gdev = generator.device
    shape = (cfg.cores, cfg.cam.entries)
    total = cfg.cores * cfg.neurons_per_core
    src = torch.randint(0, total, shape, generator=generator, device=gdev)
    tags = int_to_bits(src, cfg.tag_bits)
    valid = torch.rand(shape, generator=generator, device=gdev) < fan_in
    weights = torch.randn(shape, generator=generator, device=gdev) * 0.5 + 1.0
    targets = torch.randint(0, cfg.neurons_per_core, shape,
                            generator=generator, device=gdev,
                            dtype=torch.int32)
    params = InterfaceParams(tags, valid, weights.to(torch.float32), targets)
    return params if device is None else params.to(device)


def params_from_numpy(tags, valid, weights, targets,
                      device="cpu") -> InterfaceParams:
    """`InterfaceParams` from numpy arrays (e.g. the JAX package's params).

    Lets both packages compute on the same routing state: pass
    ``np.asarray`` of each field of a `repro.interface.InterfaceParams`.
    """
    return InterfaceParams(
        tags=torch.tensor(np.asarray(tags, np.int32), device=device),
        valid=torch.tensor(np.asarray(valid, bool), device=device),
        weights=torch.tensor(np.asarray(weights, np.float32),
                                device=device),
        targets=torch.tensor(np.asarray(targets, np.int32), device=device))
