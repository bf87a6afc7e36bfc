"""Wrappers of the hand-written CUDA sparse tick kernels.

The source (``repro_torch/csrc/sparse_tick.cu``) replaces the TPU kernel
`repro.kernels.sparse_tick.kernel.sparse_tick_pallas` (kernel.py:65)
with two entry points; see it for their design and bound.

`sparse_tick_cuda` runs one tick from a caller's compacted event buffer:
one thread block per (core, batch lane) computes the scheme's sparse
arbiter latency and encode energy, the CAM gather, the deterministic CSR
scatter into currents, and the core's hit count.  It checks every
operand on each call.

`sparse_run_cuda` runs every sparse tick of a session run in one launch,
from the bool frames: compaction, the tick above, the event-indexed
accounting (with the inter-chip tier on a multi-chip fabric) and the
stats tail, one (T, 12, B) table row per (tick, lane), and the table
summed in tick order (from a caller's (12, B) seed, a served lane's
carried accumulator, or from 0.0); on request also each (tick, lane,
core)'s arbiter latency and encode energy (per-core telemetry).  Its plan-time
operands
(`RunOperands`, built by `run_operands`) are checked once when they are
bound; each call checks only the frames and the outputs.  One block
holds a (tick, lane) in shared memory where the fabric fits
`MAX_SHARED_BYTES`; a larger fabric is split into G groups of
consecutive cores, one block a (tick, lane, group) (`plan_groups`, once
at bind time).  Only a fabric over the JAX package's ceiling
(`MAX_FUSED_ELEMS` CAM operand elements) raises `ValueError`.

Both launch on the current CUDA stream and raise on a non-zero
``cudaError_t``.  ``launches`` counts `sparse_run_cuda`'s launches and
``tick_launches`` `sparse_tick_cuda`'s (one per call that launches);
nothing else adds to them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

SOURCE = "sparse_tick"
REPLACES = "src/repro/kernels/sparse_tick/kernel.py:65"

launches = 0
tick_launches = 0

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 +
             [ctypes.c_float] * 2 + [ctypes.c_void_p])
_RUN_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 23 +
                 [ctypes.c_ulonglong, ctypes.c_void_p])

FIELDS = 12                      # StepStats fields: a table row
RUN_THREADS = 512                # threads of a whole-run block
# a block's shared memory: 227 KB on Hopper, less a margin for the
# kernel's static shared variables
MAX_SHARED_BYTES = 232448 - 1024
MIN_SHARED_BYTES = 8192
# the JAX package's whole-problem ceiling (cores * entries CAM operand
# elements; repro.kernels.sparse_tick.kernel.MAX_FUSED_ELEMS), copied
MAX_FUSED_ELEMS = 1 << 22
# what a group block holds in shared memory (`GroupPlan.stage`); each
# part it does not hold it reads from, or keeps in, global memory
STAGE_FRAME = 1                  # its cores' frames, for the compaction
STAGE_CONTRIB = 2                # its live entries' contributions
STAGE_SEG = 4                    # its targets' CSR segment offsets
STAGE_EVENTS = 8                 # its cores' event buffers and list
STAGE_ALL = STAGE_FRAME | STAGE_CONTRIB | STAGE_SEG | STAGE_EVENTS
ITEM_WORDS = 12                  # a (tick, lane)'s partial sums, before
                                 # its link loads, in the group scratch


@functools.cache
def _lib():
    """The kernel's C entry point, built on first use, typed once."""
    lib = build.load(SOURCE)
    fn = lib.sparse_tick_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _run_lib():
    """The whole-run entry point, built on first use, typed once."""
    fn = build.load(SOURCE).sparse_run_launch
    fn.argtypes = _RUN_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sparse_tick_cuda(spikes_flat, buf, counts, src_idx, active, weights, csr,
                     *, n: int, policy: int, levels: int):
    """Launch the fused sparse tick on CUDA tensors.

    Same operands and results as `ref.sparse_tick_ref` (batch axis B
    leading the per-tick tensors); ``policy`` is the scheme's
    `ArbiterScheme.kernel_policy` and ``levels`` its HAT level count.

    Raises:
      ValueError: on an operand of the wrong device, dtype, shape or
        layout, or an unknown policy.
      RuntimeError: when the launch returns a CUDA error.
    """
    global tick_launches
    dev = spikes_flat.device
    if dev.type != "cuda":
        raise ValueError(f"sparse_tick_cuda needs CUDA tensors, got {dev}")
    if policy not in range(5):
        raise ValueError(f"unknown sparse tick kernel policy {policy!r}")
    lanes, slots = buf.shape[0], buf.shape[-1]
    cores, entries = src_idx.shape
    _check("spikes_flat", spikes_flat, torch.bool, (lanes, cores * n), dev)
    _check("buf", buf, torch.int32, (lanes, cores, slots), dev)
    _check("counts", counts, torch.int32, (lanes, cores), dev)
    _check("src_idx", src_idx, torch.int32, (cores, entries), dev)
    _check("active", active, torch.bool, (cores, entries), dev)
    _check("weights", weights, torch.float32, (cores, entries), dev)
    _check("csr.ptr", csr.ptr, torch.int32, (cores * n + 1,), dev)
    _check("csr.entry", csr.entry, torch.int32, csr.entry.shape, dev)
    sqrt_n = int(round(math.sqrt(n)))
    lg = math.log2(n)

    currents = torch.empty((lanes, cores, n), dtype=torch.float32, device=dev)
    lat = torch.empty((lanes, cores), dtype=torch.float32, device=dev)
    enc = torch.empty((lanes, cores), dtype=torch.float32, device=dev)
    hits = torch.empty((lanes, cores), dtype=torch.float32, device=dev)
    if lanes == 0:
        return currents, lat, enc, hits
    err = _lib()(
        policy, buf.data_ptr(), counts.data_ptr(), spikes_flat.data_ptr(),
        src_idx.data_ptr(), active.data_ptr(), weights.data_ptr(),
        csr.ptr.data_ptr(), csr.entry.data_ptr(), currents.data_ptr(),
        lat.data_ptr(), enc.data_ptr(), hits.data_ptr(), lanes, cores, n,
        entries, slots, levels, sqrt_n, int(math.log2(sqrt_n)),
        2.0 * (lg - 1.0), lg, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sparse_tick kernel launch failed: cudaError_t "
                           f"{err}")
    tick_launches += 1
    return currents, lat, enc, hits


class GroupPlan(NamedTuple):
    """How `sparse_run_cuda` spreads a (tick, lane) over blocks, chosen
    once by `plan_groups`."""
    grouped: bool            # False: one block holds the whole (tick, lane)
    groups: int              # G blocks a (tick, lane)
    starts: tuple            # G + 1 boundaries: group g is the cores
                             # [starts[g], starts[g + 1])
    stage: int               # the STAGE_* parts a block holds (STAGE_ALL
                             # in the one-block form)
    group_bytes: tuple       # each group's own shared memory, bytes
    smem: int                # dynamic shared memory of a block: the most


class RunOperands(NamedTuple):
    """`sparse_run_cuda`'s plan-time operands, checked once by
    `run_operands`.  Tensors lie on one CUDA device."""
    ptr: torch.Tensor        # (C * n + 1,) int32 CSR segment offsets
    src: torch.Tensor        # (nnz,) int32 flat source of each live entry
    weight: torch.Tensor     # (nnz,) float32 its weight, in CSR order
    hops: torch.Tensor       # (S,) int32 mesh links per event
    depth: torch.Tensor      # (S,) int32 deepest path per event
    dest: torch.Tensor       # (S,) int32 subscribed cores per event
    swept: torch.Tensor      # (S,) int32 CAM entries swept per event
    links: torch.Tensor      # (S, L + L_chip) float32 events per link per
                             # event: the local links, then the chip links
    chip_hops: torch.Tensor | None   # (S,) int32 inter-chip links per
                                     # event; None on one chip
    chip_depth: torch.Tensor | None  # (S,) int32 deepest inter-chip path
    done: torch.Tensor       # (1,) int32 finished items; 0 between launches
    cores: int
    n: int
    capacity: int
    policy: int              # ArbiterScheme.kernel_policy
    levels: int
    flood: bool              # every event searched in every core
    floats: tuple            # flood_eps, cam_cycle_ns, e_match, e_mm,
                             # e_fixed, hop_ns, link_ns, hop_energy,
                             # chip_hop_ns, chip_link_ns, chip_hop_energy
    noc_links: int           # L: the local links' columns of ``links``
    plan: GroupPlan          # the blocks a (tick, lane), their bytes
    starts: torch.Tensor | None      # (G + 1,) int32 ``plan.starts`` on
                                     # the card; None in the one-block form


def run_shared_bytes(cores: int, n: int, nnz: int, capacity: int,
                     links: int) -> int:
    """Dynamic shared memory of the one block that holds a whole (tick,
    lane): the frame, the contributions of the ``nnz`` live entries and
    the CSR offsets, the cores' event buffers, event list and per-core
    results, the hier_ring scratch, the link loads (``links``: the local
    and the chip links) and their groups' partials; at least
    `MIN_SHARED_BYTES`, where the last block stages the stats table to
    sum it."""
    sqrt_n = int(round(math.sqrt(n)))
    frame = -(-cores * n // 16) * 16
    return max(MIN_SHARED_BYTES,
               frame + 4 * nnz + 4 * (cores * n + 1) +
               4 * cores * (2 * capacity + 1) + 16 * cores +
               4 * (RUN_THREADS // 32) * sqrt_n + 4 * links +
               4 * max(RUN_THREADS, links))


def group_shared_bytes(cores: int, n: int, nnz: int, capacity: int,
                       stage: int) -> int:
    """Dynamic shared memory of a group block over ``cores`` consecutive
    cores with ``nnz`` live entries: the parts ``stage`` holds (their
    frames, the entries' contributions, the targets' CSR offsets, the
    event buffers and list), the per-core results and the hier_ring
    scratch; at least `MIN_SHARED_BYTES`.  The link loads and the sums
    across groups go to global memory."""
    sqrt_n = int(round(math.sqrt(n)))
    need = 16 * cores + 4 * (RUN_THREADS // 32) * sqrt_n
    if stage & STAGE_FRAME:
        need += -(-cores * n // 16) * 16
    if stage & STAGE_CONTRIB:
        need += 4 * nnz
    if stage & STAGE_SEG:
        need += 4 * (cores * n + 1)
    if stage & STAGE_EVENTS:
        need += 4 * cores * (2 * capacity + 1)
    return max(MIN_SHARED_BYTES, need)


def plan_groups(cores: int, n: int, entries: int, core_nnz, capacity: int,
                links: int) -> GroupPlan:
    """Spread a (tick, lane) of ``cores`` x ``n`` neurons with ``entries``
    CAM entries a core (``core_nnz[c]`` of core c live) over blocks.

    Where `run_shared_bytes` fits `MAX_SHARED_BYTES`, one block (G = 1).
    Else the group form: each block holds what it can of its own cores,
    dropping first the part the widest core needs most of until one core
    fits a block (`group_shared_bytes`), and reads the rest from global
    memory; the cores are cut into the fewest groups of consecutive
    cores that each fit, into groups of equal core counts where those
    fit too.

    Raises:
      ValueError: when ``cores * entries`` exceeds `MAX_FUSED_ELEMS`, in
        the JAX package's words.
    """
    if cores * entries > MAX_FUSED_ELEMS:
        raise ValueError(
            f"fabric too large for the single-program sparse_tick kernel "
            f"({cores * entries} CAM operand elements > {MAX_FUSED_ELEMS}); "
            f"use impl='xla'")
    core_nnz = [int(k) for k in core_nnz]
    if len(core_nnz) != cores:
        raise ValueError(f"core_nnz has {len(core_nnz)} cores, expected "
                         f"{cores}")
    one = run_shared_bytes(cores, n, sum(core_nnz), capacity, links)
    if one <= MAX_SHARED_BYTES:
        return GroupPlan(False, 1, (0, cores), STAGE_ALL, (one,), one)
    widest = max(core_nnz)
    stage = STAGE_ALL
    parts = sorted(((-(-n // 16) * 16, STAGE_FRAME),
                    (4 * widest, STAGE_CONTRIB), (4 * (n + 1), STAGE_SEG),
                    (4 * (2 * capacity + 1), STAGE_EVENTS)), reverse=True)
    for _, part in parts:
        if group_shared_bytes(1, n, widest, capacity,
                              stage) <= MAX_SHARED_BYTES:
            break
        stage &= ~part
    prefix = [0]
    for k in core_nnz:
        prefix.append(prefix[-1] + k)

    def need(lo, hi):
        return group_shared_bytes(hi - lo, n, prefix[hi] - prefix[lo],
                                  capacity, stage)
    starts = [0]
    for c in range(1, cores):
        if need(starts[-1], c + 1) > MAX_SHARED_BYTES:
            starts.append(c)
    starts.append(cores)
    groups = len(starts) - 1
    even = [g * cores // groups for g in range(groups + 1)]
    if all(need(lo, hi) <= MAX_SHARED_BYTES
           for lo, hi in zip(even, even[1:])):
        starts = even
    sizes = tuple(need(lo, hi) for lo, hi in zip(starts, starts[1:]))
    return GroupPlan(True, groups, tuple(starts), stage, sizes, max(sizes))


def run_operands(ptr, src, weight, hops, depth, dest, swept, links, *,
                 cores: int, n: int, capacity: int, policy: int,
                 levels: int, flood: bool, floats, entries: int,
                 chip=None) -> RunOperands:
    """Check and bind the whole-run kernel's plan-time operands, once, and
    plan its blocks (`plan_groups`).

    ``links`` (S, L) and ``floats`` (8) are the local tier's; ``chip``,
    on a multi-chip fabric, is ``(chip_hops, chip_depth, chip_links,
    chip_floats)``: (S,) int32, (S,) int32, (S, L_chip) float32 and the
    tier's (hop_ns, link_ns, hop_energy).  Without it the kernel writes
    0.0 in the chip fields, as on one chip.  ``entries`` is the CAM
    entries a core, for the JAX package's ceiling.

    Raises:
      ValueError: on an operand of the wrong device, dtype, shape or
        layout, an unknown policy, a capacity outside [1, n - 1], or a
        fabric over `MAX_FUSED_ELEMS`.
    """
    dev = ptr.device
    if dev.type != "cuda":
        raise ValueError(f"sparse_run_cuda needs CUDA tensors, got {dev}")
    if policy not in range(5):
        raise ValueError(f"unknown sparse tick kernel policy {policy!r}")
    if not 1 <= capacity < n:
        raise ValueError(f"capacity {capacity} must lie in [1, {n - 1}]")
    nnz, total = src.shape[0], cores * n
    _check("ptr", ptr, torch.int32, (total + 1,), dev)
    _check("src", src, torch.int32, (nnz,), dev)
    _check("weight", weight, torch.float32, (nnz,), dev)
    for name, t in (("hops", hops), ("depth", depth), ("dest", dest),
                    ("swept", swept)):
        _check(name, t, torch.int32, (total,), dev)
    _check("links", links, torch.float32, (total, links.shape[-1]), dev)
    if int(ptr[-1]) != nnz:
        raise ValueError(f"ptr ends at {int(ptr[-1])}, expected {nnz}")
    if len(floats) != 8:
        raise ValueError(f"expected 8 float coefficients, got {len(floats)}")
    noc_links = links.shape[-1]
    chip_hops = chip_depth = None
    chip_floats = (0.0, 0.0, 0.0)
    if chip is not None:
        chip_hops, chip_depth, chip_links, chip_floats = chip
        _check("chip_hops", chip_hops, torch.int32, (total,), dev)
        _check("chip_depth", chip_depth, torch.int32, (total,), dev)
        _check("chip_links", chip_links, torch.float32,
               (total, chip_links.shape[-1]), dev)
        if len(chip_floats) != 3:
            raise ValueError(f"expected 3 chip coefficients, got "
                             f"{len(chip_floats)}")
        links = torch.cat([links, chip_links], dim=-1).contiguous()
    core_nnz = ptr[::n].diff().tolist()
    plan = plan_groups(cores, n, entries, core_nnz, capacity,
                       links.shape[-1])
    starts = (torch.tensor(plan.starts, dtype=torch.int32, device=dev)
              if plan.grouped else None)
    return RunOperands(ptr, src, weight, hops, depth, dest, swept, links,
                       chip_hops, chip_depth,
                       torch.zeros(1, dtype=torch.int32, device=dev), cores,
                       n, capacity, policy, levels, bool(flood),
                       tuple(float(f) for f in (*floats, *chip_floats)),
                       noc_links, plan, starts)


def sparse_run_cuda(stream, ticks, ops: RunOperands, currents, table,
                    acc0=None, core=None):
    """Launch the whole-run kernel: one block a (tick, lane), or in the
    group form one a (tick, lane, group) with a zeroed scratch of each
    (tick, lane)'s partial sums and link loads (and, where the blocks do
    not hold them, of their event buffers), allocated here.

    Launches that share ``ops`` share its finished-items counter, so they
    must follow one another on one stream.

    Args:
      stream: (B, T, C, n) bool frames on the card, contiguous.
      ticks: (S,) int32 CUDA tensor of the ticks to compute, or None for
        every tick.  No listed frame may exceed the capacity.
      ops: the plan's `RunOperands`.
      currents: (B, T, C, n) float32 output; the listed ticks are written.
      table: (T, 12, B) float32 per-tick stats; the listed ticks' rows are
        written, every other row must hold its tick's stats already.
      acc0: optional (12, B) float32 seed of the sum (None: 0.0); read,
        never written.
      core: optional (2, T, B, C) float32 output: the listed ticks'
        per-core arbiter latency [0] and encode energy times events [1].

    Returns:
      (12, B) float32, a fresh tensor: the table summed over ticks in tick
      order, starting from ``acc0``.

    Raises:
      ValueError: on a tensor of the wrong device, dtype, shape or layout.
      RuntimeError: when the launch returns a CUDA error.
    """
    global launches
    dev = ops.ptr.device
    lanes, total = stream.shape[0], stream.shape[1]
    frame = (ops.cores, ops.n)
    _check("stream", stream, torch.bool, (lanes, total) + frame, dev)
    _check("currents", currents, torch.float32, (lanes, total) + frame, dev)
    _check("table", table, torch.float32, (total, FIELDS, lanes), dev)
    if table.data_ptr() % 16:
        raise ValueError("table must start on a 16-byte boundary")
    count = total
    if ticks is not None:
        _check("ticks", ticks, torch.int32, (ticks.shape[0],), dev)
        count = ticks.shape[0]
    if acc0 is not None:
        _check("acc0", acc0, torch.float32, (FIELDS, lanes), dev)
    if core is not None:
        _check("core", core, torch.float32, (2, total, lanes, ops.cores),
               dev)
    acc = torch.empty((FIELDS, lanes), dtype=torch.float32, device=dev)
    if lanes == 0 or total == 0:
        return acc.zero_() if acc0 is None else acc.copy_(acc0)
    sqrt_n = int(round(math.sqrt(ops.n)))
    lg = math.log2(ops.n)
    vec = int(ops.cores * ops.n % 16 == 0 and stream.data_ptr() % 16 == 0)
    plan, links = ops.plan, ops.links.shape[-1]
    items_acc = spill = None
    stride = group_cores = 0
    if plan.grouped:
        stride = -(-(ITEM_WORDS + links) // 4) * 4
        items_acc = torch.zeros((count * lanes, stride), dtype=torch.int32,
                                device=dev)
        group_cores = max(b - a for a, b in zip(plan.starts,
                                                plan.starts[1:]))
        if not plan.stage & STAGE_EVENTS:
            spill = torch.empty(count * lanes * plan.groups * group_cores *
                                (2 * ops.capacity + 1), dtype=torch.int32,
                                device=dev)
    ints = (ctypes.c_int * 19)(
        lanes, total, count * lanes, ops.cores, links,
        int(ops.flood), vec, ops.src.shape[0], ops.n, ops.capacity + 1,
        ops.levels, sqrt_n, int(math.log2(sqrt_n)), plan.smem // 4,
        ops.noc_links, plan.groups, group_cores, plan.stage, stride)
    floats = (ctypes.c_float * 13)(2.0 * (lg - 1.0), lg, *ops.floats)
    chip = ops.chip_hops is not None
    err = _run_lib()(
        ops.policy, stream.data_ptr(),
        None if ticks is None else ticks.data_ptr(), ops.ptr.data_ptr(),
        ops.src.data_ptr(), ops.weight.data_ptr(), ops.hops.data_ptr(),
        ops.depth.data_ptr(), ops.dest.data_ptr(), ops.swept.data_ptr(),
        ops.links.data_ptr(),
        ops.chip_hops.data_ptr() if chip else None,
        ops.chip_depth.data_ptr() if chip else None, currents.data_ptr(),
        table.data_ptr(), acc.data_ptr(),
        None if acc0 is None else acc0.data_ptr(), ops.done.data_ptr(),
        None if core is None else core.data_ptr(),
        None if ops.starts is None else ops.starts.data_ptr(),
        None if items_acc is None else items_acc.data_ptr(),
        None if spill is None else spill.data_ptr(), ctypes.addressof(ints),
        ctypes.addressof(floats), plan.smem,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sparse_run kernel launch failed: cudaError_t "
                           f"{err}")
    launches += 1
    return acc
