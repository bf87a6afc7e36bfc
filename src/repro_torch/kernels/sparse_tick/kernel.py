"""Wrapper of the hand-written CUDA sparse tick kernel.

The kernel (``repro_torch/csrc/sparse_tick.cu``) replaces the TPU kernel
`repro.kernels.sparse_tick.kernel.sparse_tick_pallas` (kernel.py:65): one
thread block per (core, batch lane) computes the scheme's sparse arbiter
latency and encode energy, the CAM gather, the deterministic CSR scatter
into currents, and the core's hit count.  See the source for its design
and bound.

`sparse_tick_cuda` checks every operand, allocates the outputs with
``torch.empty``, launches on the current CUDA stream and raises on a
non-zero ``cudaError_t``.  ``launches`` counts its launches (one per
call); nothing else adds to it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

SOURCE = "sparse_tick"
REPLACES = "src/repro/kernels/sparse_tick/kernel.py:65"

launches = 0

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 +
             [ctypes.c_float] * 2 + [ctypes.c_void_p])


@functools.cache
def _lib():
    """The kernel's C entry point, built on first use, typed once."""
    lib = build.load(SOURCE)
    fn = lib.sparse_tick_launch
    fn.argtypes = _ARGTYPES
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
    global launches
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
    launches += 1
    return currents, lat, enc, hits
