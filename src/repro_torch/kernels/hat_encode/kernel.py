"""Wrapper of the hand-written CUDA hierarchical address-event encoder.

The kernel (``repro_torch/csrc/hat_encode.cu``) replaces the TPU kernel
`repro.kernels.hat_encode.kernel.hat_encode_pallas` (kernel.py:50): one
thread block per bitmap computes the service ranks, the per-cluster
event counts and the total with an integer scan, and, when asked, the
AER stream that `ref.compact_stream` makes of the ranks, in the same
pass.  The TPU kernel runs once per bitmap; this one takes every bitmap
of a tick (lanes x cores) in one launch.  See the source for the design
and bound.

`hat_encode_cuda` checks its operand, allocates the outputs with
``torch.empty``, launches on the current CUDA stream and raises on a
non-zero ``cudaError_t``.  ``launches`` counts its launches (one per
call that launches); nothing else adds to it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

SOURCE = "hat_encode"
REPLACES = "src/repro/kernels/hat_encode/kernel.py:50"

launches = 0


@functools.cache
def _lib():
    """The kernel's C entry point, built on first use, typed once."""
    fn = build.load(SOURCE).hat_encode_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
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
    global launches
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
    launches += 1
    return ranks, totals, clusters, aer
