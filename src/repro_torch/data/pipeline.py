"""Input data for the port's SNN: rate-coded class rasters.

Port of `repro.data.pipeline.snn_batch`.  It draws from a
`torch.Generator`, so its numbers differ from `jax.random`'s for the
same seed; the rasters have the same shapes and firing statistics.  Give
both packages one raster as numpy arrays where bits must agree.
"""

from __future__ import annotations

import torch

from repro_torch.interface.session import resolve_device

PROTO_SEED = 7      # the JAX package draws its class prototypes from key 7


def snn_batch(generator: torch.Generator, batch: int, t_steps: int,
              d_in: int, n_classes: int, rate: float = 0.3, device=None):
    """Rate-coded event rasters with class-dependent firing patterns.

    Returns ``{"x": (batch, t_steps, d_in) float32 {0,1}, "y": (batch,)
    int64 labels}``: input i of a class-y sample fires with probability
    ``rate * (0.4 + proto[y, i])`` each step, ``proto`` a fixed {0,1}
    pattern per class.  Drawn on ``generator``'s device, returned on
    ``device`` (the CUDA device when None; pass ``device="cpu"`` for the
    CPU).
    """
    device = resolve_device(device)
    gdev = generator.device
    y = torch.randint(0, n_classes, (batch,), generator=generator,
                      device=gdev)
    proto = (torch.rand((n_classes, d_in),
                        generator=torch.Generator().manual_seed(PROTO_SEED))
             < 0.5).to(torch.float32).to(gdev)
    rates = rate * (0.4 + proto[y])                       # (B, d_in)
    x = (torch.rand((batch, t_steps, d_in), generator=generator, device=gdev)
         < rates[:, None, :]).to(torch.float32)
    return {"x": x.to(device), "y": y.to(device)}
