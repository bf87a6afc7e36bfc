"""Wrapper of the hand-written CUDA MoE dispatch-position kernel.

The kernel (``repro_torch/csrc/moe_dispatch.cu``) replaces the TPU
kernel `repro.kernels.moe_dispatch.kernel.dispatch_positions_pallas`
(kernel.py:83): three integer passes over chunks of 256 events (a
shared-memory histogram per chunk, an exclusive scan over chunks per
expert, a warp-match rank inside each chunk) in place of the TPU grid's
sequential VMEM carry and float triangular matmul.  See the source for
the design and bound.

`dispatch_positions_cuda` checks its operand, allocates the outputs and
the (chunks, E) count table with ``torch.empty``, launches on the
current CUDA stream and raises on a non-zero ``cudaError_t``.
``launches`` counts its calls that launch (one per call, whose three
passes are three CUDA kernels); nothing else adds to it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

SOURCE = "moe_dispatch"
REPLACES = "src/repro/kernels/moe_dispatch/kernel.py:83"
CHUNK = 256
KERNEL_NAMES = ("moe_dispatch_count", "moe_dispatch_scan",
                "moe_dispatch_rank")
MAX_EXPERTS = 232448 // 4       # the per-chunk histogram in shared memory

launches = 0


@functools.cache
def _lib():
    """The kernel's C entry point, built on first use, typed once."""
    fn = build.load(SOURCE).moe_dispatch_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int] + [
        ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def dispatch_positions_cuda(expert_ids: torch.Tensor, num_experts: int):
    """(M,) int32 expert ids on the card -> (pos (M,), load (E,)) int32.

    Same results as `ref.dispatch_positions_ref`, integer for integer;
    ids outside ``[0, num_experts)`` get position 0 and no load.

    Raises:
      ValueError: on a tensor that is not a contiguous 1-D int32 CUDA
        tensor, or ``num_experts`` outside ``[1, MAX_EXPERTS]``.
      RuntimeError: when the launch returns a CUDA error.
    """
    global launches
    dev = expert_ids.device
    if dev.type != "cuda":
        raise ValueError(f"dispatch_positions_cuda needs a CUDA tensor, got "
                         f"{dev}")
    if expert_ids.dtype != torch.int32 or expert_ids.dim() != 1:
        raise ValueError(f"expert_ids must be 1-D int32, got "
                         f"{expert_ids.dtype} of shape "
                         f"{tuple(expert_ids.shape)}")
    if not expert_ids.is_contiguous():
        raise ValueError("expert_ids must be contiguous")
    if not 1 <= num_experts <= MAX_EXPERTS:
        raise ValueError(f"num_experts={num_experts} must lie in "
                         f"[1, {MAX_EXPERTS}]")
    m = expert_ids.numel()
    pos = torch.empty_like(expert_ids)
    load = torch.empty((num_experts,), dtype=torch.int32, device=dev)
    if m == 0:
        return pos, load.zero_()
    scratch = torch.empty(((m + CHUNK - 1) // CHUNK, num_experts),
                          dtype=torch.int32, device=dev)
    err = _lib()(expert_ids.data_ptr(), m, num_experts, scratch.data_ptr(),
                 pos.data_ptr(), load.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_dispatch kernel launch failed: cudaError_t "
                           f"{err}")
    launches += 1
    return pos, load
