"""Wrapper of the hand-written CUDA leaky-integrate-and-fire update.

The kernel (``repro_torch/csrc/lif_step.cu``) replaces the TPU kernel
`repro.kernels.lif_step.kernel.lif_step_pallas` (kernel.py:33): one
elementwise pass over the flat (B, N) state, ``__fmaf_rn`` for the
single-rounding ``v * decay + I``, float4 loads and stores where the
element count and the pointers allow, both outputs written in the same
pass; on bfloat16 the same pass rounds as `ref.mul_add_bf16` does, eight
values a 16-byte load.  See the source for the design and bound.

`lif_step_cuda` checks its operands, allocates the outputs with
``torch.empty``, launches on the current CUDA stream and raises on a
non-zero ``cudaError_t``.  ``launches`` counts its launches (one per
call that launches); nothing else adds to it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lif_step import ref

SOURCE = "lif_step"
REPLACES = "src/repro/kernels/lif_step/kernel.py:33"

launches = 0


ENTRY = {torch.float32: "lif_step_launch",
         torch.bfloat16: "lif_step_bf16_launch"}


@functools.cache
def _lib(dtype: torch.dtype):
    """The kernel's C entry point for ``dtype``, built on first use, typed
    once."""
    fn = getattr(build.load(SOURCE), ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [
        ctypes.c_float] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lif_step_cuda(v, current, decay: float, threshold: float,
                  v_reset: float = 0.0):
    """(B, N) float32 or bfloat16 membrane update on the card: (v_next,
    spikes) in the operands' type.

    Same results, bit for bit, as `ref.lif_step_ref`; the three scalars
    are rounded to the operands' type as they cross to the kernel.

    Raises:
      ValueError: on tensors that are not both float32 or both bfloat16,
        contiguous, of one shape and on one CUDA device.
      RuntimeError: on an operand that requires grad while grad mode is
        on (the kernel has no backward; the JAX package uses it for
        inference only), or when the launch returns a CUDA error.
    """
    global launches
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"lif_step_cuda needs CUDA tensors, got {dev}")
    if v.dtype not in ENTRY:
        raise ValueError(f"v must be float32 or bfloat16, got {v.dtype}")
    for name, x in (("v", v), ("current", current)):
        if x.device != dev or x.dtype != v.dtype:
            raise ValueError(f"{name} must be {v.dtype} on {dev}, got "
                             f"{x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if v.shape != current.shape:
        raise ValueError(f"v and current differ in shape: "
                         f"{tuple(v.shape)} vs {tuple(current.shape)}")
    if torch.is_grad_enabled() and (v.requires_grad or current.requires_grad):
        raise RuntimeError(
            "lif_step_cuda has no backward: call it under torch.no_grad() "
            "(the kernel path is for inference; train through impl='xla')")
    v_out = torch.empty_like(v)
    s_out = torch.empty_like(v)
    if v.numel() == 0:
        return v_out, s_out
    if v.dtype == torch.bfloat16:
        decay, threshold, v_reset = (ref.as_bfloat16(x)
                                     for x in (decay, threshold, v_reset))
    err = _lib(v.dtype)(v.data_ptr(), current.data_ptr(), v_out.data_ptr(),
                        s_out.data_ptr(), v.numel(), decay, threshold,
                        v_reset, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lif_step kernel launch failed: cudaError_t {err}")
    launches += 1
    return v_out, s_out
