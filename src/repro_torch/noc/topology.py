"""2D-mesh topology: coordinates, XY dimension-order routing, hop matrices.

Port of `repro.noc.topology`.  Cores sit on a W x H grid, row-major: core
c is at (x, y) = (c % W, c // W).  Link indexing (used by `router.py`):

  horizontal link (y, x) connects (x, y) <-> (x+1, y),   x in [0, W-2]
  vertical   link (y, x) connects (x, y) <-> (x, y+1),   y in [0, H-2]
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class NocConfig:
    """Inter-core transport configuration: a registered NoC scheme name
    ("broadcast", "unicast", "multicast_tree", or any scheme registered
    through `repro_torch.interface.register_noc_scheme`)."""
    scheme: str = "multicast_tree"

    def __post_init__(self):
        # Deferred import: `router` registers the built-in schemes on import
        # and itself imports this module, so the cycle must break here.
        from repro_torch.interface import registry as interface_registry
        from repro_torch.noc import router  # noqa: F401  (registers built-ins)
        if self.scheme not in interface_registry.NOC_SCHEMES:
            raise ValueError(
                f"unknown NoC scheme: {self.scheme!r}; registered: "
                f"{', '.join(interface_registry.NOC_SCHEMES.names())}")


def mesh_dims(cores: int) -> tuple[int, int]:
    """Near-square (W, H) factorization with W * H >= cores, W >= H."""
    w = max(1, math.ceil(math.sqrt(cores)))
    h = math.ceil(cores / w)
    return w, h


def core_coords(cores: int, device=None) -> torch.Tensor:
    """(cores, 2) int32 grid coordinates (x, y), row-major placement."""
    w, _ = mesh_dims(cores)
    c = torch.arange(cores, dtype=torch.int32, device=device)
    return torch.stack([c % w, c // w], dim=-1)


def hop_matrix(cores: int, device=None) -> torch.Tensor:
    """(cores, cores) Manhattan hop distances under XY routing."""
    xy = core_coords(cores, device)
    d = (xy[:, None, :] - xy[None, :, :]).abs()
    return d.sum(-1).to(torch.int32)


def num_links(cores: int) -> int:
    w, h = mesh_dims(cores)
    return h * (w - 1) + (h - 1) * w
