"""Plain torch version of the fused sparse event tick.

Port of `repro.kernels.sparse_tick.ref`, with a leading batch axis B on
every per-tick tensor.  The sparse tick makes per-tick cost scale with
*events*: active addresses are compacted per core into a fixed-capacity
buffer (`compact_events`), and the arbiter latency, AER encode energy and
accounting read that buffer instead of dense (cores, n) masks.

Deterministic scatter.  Currents are float32 sums of non-integer weights,
and their bits depend on the order of the sum.  The JAX package adds each
target's entries in ascending entry order, starting from 0.0.  CUDA's
``index_add_`` uses atomics, whose order is not fixed, so the port sums
through a compile-time CSR of the live entries grouped by flat target
(`build_target_csr`): the plain version gathers a padded (cores * n,
max_in_degree) table and adds it column by column, and the CUDA kernel
walks the same segments in the same order.  Entries that are not live,
and pad slots, contribute exactly 0.0, which changes no partial sum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TargetCSR(NamedTuple):
    """Live CAM entries grouped by flat target ``core * n + target``."""
    ptr: torch.Tensor      # (cores * n + 1,) int32 segment offsets
    entry: torch.Tensor    # (nnz,) int32 flat entry ``core * entries + e``
    gather: torch.Tensor   # (cores * n, max_in_degree) int64; pad = cores*entries


def build_target_csr(targets: torch.Tensor, active: torch.Tensor,
                     n: int) -> TargetCSR:
    """Compile-time CSR of the live entries, ascending entry per target."""
    cores, entries = targets.shape
    dev = targets.device
    flat_entry = torch.arange(cores * entries, device=dev)
    flat_target = (targets.long() +
                   torch.arange(cores, device=dev)[:, None] * n).reshape(-1)
    live = active.reshape(-1)
    flat_entry, flat_target = flat_entry[live], flat_target[live]
    # stable sort by target keeps ascending entry order inside each segment
    order = torch.sort(flat_target, stable=True).indices
    flat_entry, flat_target = flat_entry[order], flat_target[order]
    degree = torch.bincount(flat_target, minlength=cores * n)
    ptr = torch.zeros(cores * n + 1, dtype=torch.int64, device=dev)
    ptr[1:] = degree.cumsum(0)
    width = int(degree.max()) if degree.numel() else 0
    gather = torch.full((cores * n, width), cores * entries,
                        dtype=torch.int64, device=dev)
    if flat_entry.numel():
        slot = torch.arange(flat_entry.numel(), device=dev) - ptr[flat_target]
        gather[flat_target, slot] = flat_entry
    return TargetCSR(ptr=ptr.to(torch.int32), entry=flat_entry.to(torch.int32),
                     gather=gather)


def scatter_currents(contrib: torch.Tensor, csr: TargetCSR,
                     n: int) -> torch.Tensor:
    """(B, cores, entries) contributions -> (B, cores, n) currents.

    Each target sums its entries in ascending entry order from 0.0: one
    addition per CSR column, so the order is the same on every device.
    """
    b, cores, entries = contrib.shape
    flat = torch.cat([contrib.reshape(b, cores * entries),
                      contrib.new_zeros((b, 1))], dim=-1)
    vals = flat[:, csr.gather]                          # (B, cores*n, D)
    acc = contrib.new_zeros((b, cores * n))
    for j in range(vals.shape[-1]):
        acc = acc + vals[..., j]
    return acc.reshape(b, cores, n)


def compact_events(spikes: torch.Tensor, capacity: int):
    """Compact spike frames into per-core event address buffers.

    Args:
      spikes: (..., cores, n) bool frames.
      capacity: max events per core the buffer can hold (K).

    Returns:
      buf:    (..., cores, K + 1) int32 - each row holds that core's active
              addresses in ascending (service) order, padded with ``n``.
      counts: (..., cores) int32 live event count per row.  Rows where
              ``counts > capacity`` are truncated and must take the dense
              fallback.
    """
    csum = spikes.to(torch.int32).cumsum(-1)             # (..., C, n)
    slots = torch.arange(1, capacity + 2, dtype=csum.dtype,
                         device=spikes.device)
    slots = slots.expand(csum.shape[:-1] + (capacity + 1,)).contiguous()
    buf = torch.searchsorted(csum, slots, out_int32=True)
    return buf, csum[..., -1].to(torch.int32)


def event_indices(buf: torch.Tensor, n: int):
    """Flat global source indices + live weights for accounting gathers.

    Args:
      buf: (..., cores, K + 1) compacted address buffer.
      n:   neurons per core (the buffer's pad value).

    Returns:
      ev_idx: (..., cores * K) int32 flat source-neuron indices (pad slots
              point at index 0 and are neutralized by ``ev_w``).
      ev_w:   (..., cores * K) float32 1.0 on live events, 0.0 on pads.
    """
    cores = buf.shape[-2]
    addr = buf[..., :-1]                                 # (..., C, K)
    real = addr < n
    base = torch.arange(cores, dtype=torch.int32, device=buf.device)[:, None]
    ev_idx = torch.where(real, addr + base * n, 0)
    lead = buf.shape[:-2]
    return (ev_idx.reshape(lead + (-1,)),
            real.reshape(lead + (-1,)).to(torch.float32))


def entry_drive(spikes_flat: torch.Tensor, src_idx: torch.Tensor,
                active: torch.Tensor) -> torch.Tensor:
    """(B, cores, entries) bool: is each live entry's source spiking?"""
    return spikes_flat[:, src_idx] & active


def sparse_tick_ref(spikes_flat, buf, counts, src_idx, active, weights, csr,
                    *, n: int, latency_fn, encode_fn):
    """The fused sparse tick body in plain torch (the kernel's yardstick).

    Args:
      spikes_flat: (B, cores * n) bool flat spike frames.
      buf, counts: output of `compact_events`, (B, cores, K + 1) / (B, cores).
      src_idx:     (cores, entries) int32 decoded CAM source indices.
      active:      (cores, entries) bool live-entry mask.
      weights:     (cores, entries) float32 synaptic weights.
      csr:         `TargetCSR` of the live entries.
      latency_fn, encode_fn: the scheme's sparse policies.

    Returns:
      (currents (B, cores, n) f32, latencies (B, cores) f32,
       enc_per_core (B, cores) f32, hits per core (B, cores) f32)
    """
    latencies = latency_fn(buf, counts)
    enc_per_core = encode_fn(buf, counts)
    drive = entry_drive(spikes_flat, src_idx, active).to(torch.float32)
    currents = scatter_currents(drive * weights, csr, n)
    return currents, latencies, enc_per_core, drive.sum(-1)
