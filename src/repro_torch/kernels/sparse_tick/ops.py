"""Dispatch layer for the fused sparse event tick.

Port of `repro.kernels.sparse_tick.ops`.  `sparse_tick` validates shapes
and dispatches on where its operands lie: CPU tensors take the plain
torch version (`ref.sparse_tick_ref`), CUDA tensors launch the CUDA
kernel (`kernel.sparse_tick_cuda`) or raise.  There is no fallback from
the kernel to the plain version.

`sparse_run` is the port's own: every sparse tick of a session run, from
the bool frames to each tick's `StepStats` row and their sum in tick
order (from a caller's seed: a served lane's carried accumulator), in
one launch of `kernel.sparse_run_cuda` on the card.  Its plain
version (`sparse_run_ref`, CPU tensors) is the per-tick composition it
replaces: `compact_events` -> `sparse_tick_ref` -> `event_indices` ->
the interface's event-indexed accounting, then `ref.sum_in_tick_order`.

Capacity policy: the per-core event buffer holds ``capacity`` live
addresses (+1 pad slot).  `resolve_capacity` turns the user-facing
``sparse_capacity`` knob (``None`` = ``max(8, n // 8)``) into the
effective value, clamped to ``n - 1`` so a full-frame burst always
overflows into the dense fallback.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

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


class SparseRun(NamedTuple):
    """What `sparse_run` needs that depends only on (params, cfg), bound
    once by `bind_run`."""
    n: int
    capacity: int
    policy: SparsePolicy
    src_idx: torch.Tensor          # (cores, entries) routing operands
    active: torch.Tensor
    weights: torch.Tensor
    csr: ref.TargetCSR
    account: Callable              # the plain version's accounting tail
    kernel: Optional[sparse_kernel.RunOperands]   # None off the card


def bind_run(src_idx, active, weights, csr, *, n: int, capacity: int,
             policy: SparsePolicy, account: Callable, kernel_tables=None
             ) -> SparseRun:
    """Bind the whole-run op's operands once.

    Args:
      src_idx, active, weights, csr: the routing operands of `sparse_tick`.
      n, capacity: neurons per core and the event buffer's capacity.
      policy: the scheme's `SparsePolicy`.
      account: ``account(counts, ev_idx, ev_w, latencies, enc_per_core,
        hits_total)`` -> the tick's 12 (B,) `StepStats` fields, the
        plain version's event-indexed accounting.
      kernel_tables: on the card, ``(hops, depth, dest, swept, links,
        flood, floats, chip)``: the per-source NoC tables as int32 (links
        float32), whether the NoC floods every core (None: the scheme has
        no kernel form), the stats coefficients (see
        `kernel.RunOperands`), and the inter-chip tier's operands or None
        on one chip (`kernel.run_operands`).  Ignored for CPU operands.

    On the card the kernel's blocks are planned here, once
    (`kernel.plan_groups`): one block a (tick, lane), or G blocks of
    consecutive cores where the fabric does not fit one.

    Raises:
      ValueError: for CUDA operands whose arbiter or NoC scheme has no
        kernel form, or that the kernel does not take (over the JAX
        package's `kernel.MAX_FUSED_ELEMS` CAM operand elements).
    """
    kernel = None
    if src_idx.is_cuda:
        hops, depth, dest, swept, links, flood, floats, chip = kernel_tables
        if policy.kernel_policy is None or flood is None:
            raise ValueError(
                "this arbiter or NoC scheme registers no kernel form, so "
                "the CUDA sparse run cannot take it")
        entry = csr.entry.long()
        kernel = sparse_kernel.run_operands(
            csr.ptr, src_idx.reshape(-1)[entry].contiguous(),
            weights.reshape(-1)[entry].contiguous(), hops, depth, dest,
            swept, links, cores=src_idx.shape[0], n=n, capacity=capacity,
            policy=policy.kernel_policy, levels=policy.levels, flood=flood,
            floats=floats, chip=chip, entries=src_idx.shape[1])
    return SparseRun(n, capacity, policy, src_idx, active, weights, csr,
                     account, kernel)


def sparse_run(stream, ticks, run: SparseRun, currents, table, acc0=None,
               core=None):
    """Every listed tick of a stream through the sparse tick.

    Args:
      stream: (B, T, cores, n) bool frames.
      ticks: the ticks to compute, ascending (a list of ints), or None
        for all; no listed frame may have a core over the capacity.
      run: the plan's `SparseRun`.
      currents: (B, T, cores, n) float32; the listed ticks are written.
      table: (T, 12, B) float32 per-tick `StepStats` rows; the listed
        ticks' rows are written, every other row must hold its tick's
        stats already (the dense fallback's).
      acc0: optional (12, B) float32 seed of the sum, on the stream's
        device: a served lane's accumulator carried from its previous
        chunk.  None starts from 0.0.  It is read, never written.
      core: optional (2, T, B, cores) float32 output for per-core
        telemetry: the listed ticks' arbiter latency [0] and encode
        energy times events [1] of every core.

    Returns:
      (12, B) float32, a fresh tensor: the table summed in tick order,
      starting from ``acc0``.

    Raises:
      ValueError: on mismatched shapes, a tick outside the stream, or (on
        the card) a run bound without kernel operands.
    """
    lanes, total = stream.shape[:2]
    want = (lanes, total, run.src_idx.shape[0], run.n)
    if tuple(stream.shape) != want or tuple(currents.shape) != want:
        raise ValueError(f"stream {tuple(stream.shape)} and currents "
                         f"{tuple(currents.shape)} must both be {want}")
    if tuple(table.shape) != (total, sparse_kernel.FIELDS, lanes):
        raise ValueError(f"table shape {tuple(table.shape)} != "
                         f"({total}, {sparse_kernel.FIELDS}, {lanes})")
    if ticks is not None and any(not 0 <= t < total for t in ticks):
        raise ValueError(f"ticks must lie in [0, {total})")
    if acc0 is not None and (tuple(acc0.shape) != (sparse_kernel.FIELDS,
                                                   lanes)
                             or acc0.dtype != torch.float32):
        raise ValueError(f"acc0 must be float32 ({sparse_kernel.FIELDS}, "
                         f"{lanes}), got {acc0.dtype} {tuple(acc0.shape)}")
    if core is not None and tuple(core.shape) != (2, total, lanes, want[2]):
        raise ValueError(f"core shape {tuple(core.shape)} != "
                         f"(2, {total}, {lanes}, {want[2]})")
    if not stream.is_cuda:
        return sparse_run_ref(stream, ticks, run, currents, table, acc0, core)
    if run.kernel is None:
        raise ValueError("the sparse run was bound to CPU operands; "
                         "rebuild the plan on the card")
    index = None if ticks is None else torch.tensor(
        ticks, dtype=torch.int32, device=stream.device)
    return sparse_kernel.sparse_run_cuda(stream, index, run.kernel,
                                         currents, table, acc0, core)


def sparse_run_ref(stream, ticks, run: SparseRun, currents, table,
                   acc0=None, core=None):
    """`sparse_run` in plain torch: the per-tick composition, tick by
    tick, then the table summed in tick order from ``acc0``."""
    lanes = stream.shape[0]
    for t in range(stream.shape[1]) if ticks is None else ticks:
        frames = stream[:, t]
        buf, counts = ref.compact_events(frames, run.capacity)
        cur, latencies, enc_per_core, hits = ref.sparse_tick_ref(
            frames.reshape(lanes, -1), buf, counts, run.src_idx, run.active,
            run.weights, run.csr, n=run.n,
            latency_fn=run.policy.latency_fn,
            encode_fn=run.policy.encode_fn)
        ev_idx, ev_w = ref.event_indices(buf, run.n)
        stats = run.account(counts, ev_idx, ev_w, latencies, enc_per_core,
                            hits.sum(-1))
        currents[:, t] = cur
        table[t] = torch.stack(tuple(stats))
        if core is not None:
            core[0, t] = latencies
            core[1, t] = enc_per_core * counts.to(torch.float32)
    return ref.sum_in_tick_order(table, acc0)
