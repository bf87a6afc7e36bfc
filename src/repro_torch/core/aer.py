"""Address-Event Representation (AER) encode/decode and raster streaming.

Port of `repro.core.aer`: bit-field packing of neuron addresses into the
HAT hierarchy levels (2 bits per level, high level first), raster ->
event-stream encoding under an arbitration scheme with each event's
grant time from the discrete-event model, its inverse, and the ordering
oracle of the `hat_encode` kernel.  Within a tick a burst drains in
ascending address order (the simulator's tie-break); across ticks events
keep raster order.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.arbiter import Arbiter, ArbiterConfig


def pack_address(addr: torch.Tensor, n: int, branching: int = 4
                 ) -> torch.Tensor:
    """Split addresses into hierarchy-level fields, high level first.

    addr: (...,) int in [0, n) -> (..., levels) int in [0, branching).
    """
    levels = max(1, round(math.log(n, branching)))
    fields = [(addr // branching ** lvl) % branching
              for lvl in range(levels - 1, -1, -1)]
    return torch.stack(fields, dim=-1)


def unpack_address(fields: torch.Tensor, branching: int = 4) -> torch.Tensor:
    """Inverse of `pack_address`: (..., levels) fields -> (...,) int32."""
    addr = torch.zeros(fields.shape[:-1], dtype=torch.int32,
                       device=fields.device)
    for lvl in range(fields.shape[-1]):
        addr = addr * branching + fields[..., lvl].to(torch.int32)
    return addr


def hat_event_order(spikes: torch.Tensor):
    """Oracle of the hat_encode kernel: compact the active addresses.

    spikes: (..., n) bool -> (addresses (..., n) int32, ascending actives
    then n-padded; count (...) int32).
    """
    n = spikes.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=spikes.device)
    order = torch.where(spikes, idx, n).sort(-1).values.to(torch.int32)
    return order, spikes.sum(-1).to(torch.int32)


def encode_raster(raster: torch.Tensor, scheme: str = "hier_tree",
                  tick_ns: float = 1000.0) -> dict:
    """Encode a spike raster (T, N) bool into an AER stream.

    Returns a dict with per-tick event addresses (T, N) int32 (padded
    with N), grant times (T, N) float32 in arbiter units offset by the
    tick starts (inf on pads), and per-tick event counts (T,) int32.
    """
    t_steps, n = raster.shape
    raster = raster.to(torch.bool)
    starts = torch.arange(t_steps, dtype=torch.float32,
                          device=raster.device) * tick_ns
    req = torch.where(raster, 0.0, float("inf")).to(torch.float32)
    grants = Arbiter(ArbiterConfig(scheme=scheme, n=n),
                     req.device).simulate(req)
    addrs, counts = hat_event_order(raster)
    real = addrs < n
    at = grants.gather(-1, addrs.clamp_max(n - 1).long())
    grant_sorted = torch.where(real, at, float("inf"))
    return {"addresses": addrs, "grant_times": grant_sorted + starts[:, None],
            "counts": counts}


def decode_events(addresses: torch.Tensor, counts: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Inverse of `encode_raster`: event stream -> spike raster (T, N)."""
    width = addresses.shape[-1]
    live = (torch.arange(width, device=addresses.device)[None, :]
            < counts[:, None])
    safe = addresses.clamp_max(n - 1).long()   # pad slots write False
    out = torch.zeros((addresses.shape[0], n), dtype=torch.uint8,
                      device=addresses.device)
    return out.scatter_reduce(-1, safe, live.to(torch.uint8),
                              reduce="amax").bool()
