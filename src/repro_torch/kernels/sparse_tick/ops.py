"""Dispatch layer for the fused sparse event tick.

Port of `repro.kernels.sparse_tick.ops`.  `sparse_tick` validates shapes
and dispatches on where its operands lie: CPU tensors take the plain
torch version (`ref.sparse_tick_ref`), CUDA tensors launch the CUDA
kernel (`kernel.sparse_tick_cuda`) or raise.  There is no fallback from
the kernel to the plain version.

Capacity policy: the per-core event buffer holds ``capacity`` live
addresses (+1 pad slot).  `resolve_capacity` turns the user-facing
``sparse_capacity`` knob (``None`` = ``max(8, n // 8)``) into the
effective value, clamped to ``n - 1`` so a full-frame burst always
overflows into the dense fallback.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

from repro_torch.kernels.sparse_tick import kernel as sparse_kernel
from repro_torch.kernels.sparse_tick import ref

compact_events = ref.compact_events
event_indices = ref.event_indices

MIN_CAPACITY = 8
CAPACITY_DIVISOR = 8


class SparsePolicy(NamedTuple):
    """A scheme's sparse policies, as plain torch callables and as the
    kernel's compile-time branch (``kernel_policy`` None: plain only)."""
    latency_fn: Callable
    encode_fn: Callable
    kernel_policy: Optional[int]
    levels: int


def default_capacity(n: int) -> int:
    """Heuristic event capacity per core: n/8, at least `MIN_CAPACITY`."""
    return max(MIN_CAPACITY, n // CAPACITY_DIVISOR)


def resolve_capacity(requested: int | None, n: int) -> int:
    """Effective buffer capacity for a fabric with ``n`` neurons/core."""
    if requested is None:
        requested = default_capacity(n)
    if requested < 1:
        raise ValueError(
            f"sparse_capacity must be a positive event count, got "
            f"{requested}")
    return max(1, min(requested, n - 1))


def sparse_tick(spikes_flat, buf, counts, src_idx, active, weights, csr, *,
                n: int, policy: SparsePolicy):
    """Fused sparse tick: CAM gather + scatter + latency + encode energy.

    Args:
      spikes_flat: (B, cores * n) bool frames; buf (B, cores, K + 1) int32
        and counts (B, cores) int32 from `compact_events`.
      src_idx, active, weights: (cores, entries) routing operands.
      csr: `ref.TargetCSR` of the live entries.
      n: neurons per core (the buffer pad value).
      policy: the scheme's `SparsePolicy`.

    Returns:
      (currents (B, cores, n) f32, latencies (B, cores) f32,
       enc_per_core (B, cores) f32, hits (B,) f32)

    Raises:
      ValueError: on mismatched operand shapes, or a CUDA operand set
        whose scheme has no kernel branch.
    """
    lanes, cores = counts.shape[0], src_idx.shape[0]
    if buf.ndim != 3 or buf.shape[:2] != (lanes, cores) or counts.ndim != 2:
        raise ValueError(
            f"event buffer shapes {tuple(buf.shape)}/{tuple(counts.shape)} "
            f"do not match {cores} cores")
    if tuple(spikes_flat.shape) != (lanes, cores * n):
        raise ValueError(
            f"spikes_flat shape {tuple(spikes_flat.shape)} != "
            f"({lanes}, {cores * n})")
    if not (src_idx.shape == active.shape == weights.shape):
        raise ValueError(
            f"CAM operand shapes disagree: {tuple(src_idx.shape)}, "
            f"{tuple(active.shape)}, {tuple(weights.shape)}")
    if spikes_flat.is_cuda:
        if policy.kernel_policy is None:
            raise ValueError(
                "this arbiter scheme registers no kernel_policy, so the "
                "CUDA sparse tick cannot run it")
        out = sparse_kernel.sparse_tick_cuda(
            spikes_flat, buf, counts, src_idx, active, weights, csr, n=n,
            policy=policy.kernel_policy, levels=policy.levels)
    else:
        out = ref.sparse_tick_ref(
            spikes_flat, buf, counts, src_idx, active, weights, csr, n=n,
            latency_fn=policy.latency_fn, encode_fn=policy.encode_fn)
    currents, latencies, enc_per_core, hits = out
    return currents, latencies, enc_per_core, hits.sum(-1)
