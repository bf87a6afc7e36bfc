"""Wrappers of the hand-written CUDA hierarchical address-event encoder.

The source (``repro_torch/csrc/hat_encode.cu``) replaces the TPU kernel
`repro.kernels.hat_encode.kernel.hat_encode_pallas` (kernel.py:50) with
two entry points; see it for their design and bound.

`hat_encode_cuda` encodes a caller's bitmaps: one thread block per
bitmap computes the service ranks, the per-cluster event counts and the
total with an integer scan, and, when asked, the AER stream that
`ref.compact_stream` makes of the ranks, in the same pass.  It checks
its operand on each call.

`hat_run_cuda` is the interface tick's use of B3, once per session run:
one warp per (tick, lane, core) bitmap of a (B, T, C, n) stream computes
the arbiter's tick latency, the AER encode energy and the event count,
without writing the stream.  Its scheme's static quantities (`run_args`)
are derived once, when a plan binds them; each call checks only the
frames, and the C entry point refuses an unknown policy or an n that is
not a multiple of `RUN_CHUNK` up to 2^16.

Both launch on the current CUDA stream and raise on a non-zero
``cudaError_t``.  ``launches`` counts `hat_run_cuda`'s launches and
``tick_launches`` `hat_encode_cuda`'s (one per call that launches);
nothing else adds to them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

SOURCE = "hat_encode"
REPLACES = "src/repro/kernels/hat_encode/kernel.py:50"

launches = 0
tick_launches = 0

RUN_CHUNK = 256              # neurons a warp reads at a time


@functools.cache
def _lib():
    """The kernel's C entry point, built on first use, typed once."""
    fn = build.load(SOURCE).hat_encode_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _run_lib():
    """The whole-run entry point, built on first use, typed once."""
    fn = build.load(SOURCE).hat_run_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2 +
                   [ctypes.c_int] * 6 + [ctypes.c_float] * 2 +
                   [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def hat_encode_cuda(spikes, *, row: int, stream: bool):
    """Encode (..., N) spike bitmaps on the card.

    Returns (ranks (..., N) int32, count (...) int32, cluster_counts
    (..., N // row) int32, AER stream (..., N) int32 or None), the stream
    only when ``stream`` is true.  Same results as `ref.hat_encode_ref`
    and `ref.compact_stream`.

    Raises:
      ValueError: on a tensor that is not on a CUDA device, or N that is
        not a multiple of ``row``.
      RuntimeError: when the launch returns a CUDA error.
    """
    global tick_launches
    dev = spikes.device
    if dev.type != "cuda":
        raise ValueError(f"hat_encode_cuda needs a CUDA tensor, got {dev}")
    n = spikes.shape[-1]
    if row < 1 or n % row:
        raise ValueError(f"N={n} must be a multiple of row={row}")
    lead = tuple(spikes.shape[:-1])
    flat = spikes.bool().reshape(-1, n).contiguous()
    bitmaps = flat.shape[0]
    ranks = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    clusters = torch.empty(lead + (n // row,), dtype=torch.int32, device=dev)
    totals = torch.empty(lead, dtype=torch.int32, device=dev)
    aer = (torch.empty(lead + (n,), dtype=torch.int32, device=dev)
           if stream else None)
    if bitmaps == 0:
        return ranks, totals, clusters, aer
    err = _lib()(flat.data_ptr(), ranks.data_ptr(), clusters.data_ptr(),
                 totals.data_ptr(), aer.data_ptr() if stream else None,
                 bitmaps, n, row, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hat_encode kernel launch failed: cudaError_t "
                           f"{err}")
    tick_launches += 1
    return ranks, totals, clusters, aer


class RunArgs(NamedTuple):
    """A scheme's static quantities as `hat_run_cuda` passes them."""
    policy: int              # ArbiterScheme.kernel_policy
    n: int                   # neurons per core
    levels: int              # HAT levels
    ring_shift: int          # log2(sqrt n); 0 off hier_ring
    per_grant: float         # 2 * (log2 n - 1)
    log2n: float


def run_args(policy: int, n: int, levels: int) -> RunArgs:
    """A scheme's static quantities as `hat_run_cuda` takes them: its
    ``kernel_policy``, n (a power of two, square for hier_ring, as
    `arbiter.ArbiterConfig` and its latency form require) and its HAT
    level count."""
    lg = math.log2(n)
    return RunArgs(policy, n, levels,
                   int(math.log2(math.isqrt(n))) if policy == 3 else 0,
                   2.0 * (lg - 1.0), lg)


def hat_run_cuda(stream, args: RunArgs):
    """The arbiter's tick terms of every bitmap of a run, on the card.

    Args:
      stream: (B, T, C, n) bool frames on a CUDA device, contiguous.
      args: the scheme's `RunArgs` (`run_args`).

    Returns:
      (latency (T, B, C) float32, encode energy (T, B, C) float32, events
      (T, B, C) int32), views of one buffer; each tick's (B, C) slice is
      contiguous.  The same bits as `ref.hat_run_ref` with the scheme's
      dense latency and encode energy.

    Raises:
      ValueError: on frames that are not bool, 4-d, n wide, contiguous
        or on a CUDA device.
      RuntimeError: when the launch returns a CUDA error.
    """
    global launches
    dev = stream.device
    if dev.type != "cuda":
        raise ValueError(f"hat_run_cuda needs a CUDA tensor, got {dev}")
    if stream.dtype != torch.bool or stream.ndim != 4 or \
            stream.shape[-1] != args.n or not stream.is_contiguous():
        raise ValueError(
            f"hat_run_cuda needs contiguous (B, T, C, {args.n}) bool frames, "
            f"got {stream.dtype} {tuple(stream.shape)}")
    if stream.data_ptr() % 8:            # a lane reads 8 bytes at a time
        stream = stream.clone()
    lanes, ticks, cores = stream.shape[:3]
    out = torch.empty((3, ticks, lanes, cores), dtype=torch.float32,
                      device=dev)
    lat, enc, count = out[0], out[1], out[2].view(torch.int32)
    if out.numel() == 0:
        return lat, enc, count
    err = _run_lib()(args.policy, stream.data_ptr(), out.data_ptr(), lanes,
                     ticks, cores, args.n, args.levels, args.ring_shift,
                     args.per_grant, args.log2n,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hat_run kernel launch failed: cudaError_t {err}")
    launches += 1
    return lat, enc, count
