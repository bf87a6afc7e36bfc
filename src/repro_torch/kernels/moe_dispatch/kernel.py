"""Wrapper of the hand-written CUDA MoE dispatch-position kernel.

The kernel (``repro_torch/csrc/moe_dispatch.cu``) replaces the TPU
kernel `repro.kernels.moe_dispatch.kernel.dispatch_positions_pallas`
(kernel.py:83) in one launch: a block walks its span of events in rounds
of 1024, in order, carrying per-expert running totals in shared memory
and ranking each round's events with shared-memory lane masks, in place
of the TPU grid's sequential VMEM carry and float triangular matmul.  A
stream longer than four rounds is split over a thread block cluster
whose blocks read the earlier blocks' counts through distributed shared
memory (`launch_geometry`).  See the source for the design and bound.

`dispatch_positions_cuda` checks its operand, allocates the two outputs
with ``torch.empty`` (and nothing else: the (chunks, E) count table the
first three-kernel version needed is gone, the kernel keeps its state in
shared memory), launches on the current CUDA stream and raises on a
non-zero ``cudaError_t``.  ``launches`` counts its calls that launch (one
CUDA kernel a call); nothing else adds to it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

SOURCE = "moe_dispatch"
REPLACES = "src/repro/kernels/moe_dispatch/kernel.py:83"
ROUND = 1024                    # events a block ranks at a time
SOLO_ROUNDS = 4                 # the most rounds one block takes alone
MAX_BLOCKS = 8                  # the largest portable cluster
KERNEL_NAMES = ("moe_dispatch_kernel",)
# a block's shared memory (227 KB) holds (2 + 32) E int32: running
# totals, its histogram and a round's per-warp counts
MAX_EXPERTS = 232448 // 4 // (2 + ROUND // 32)

launches = 0


@functools.cache
def _lib():
    """The kernel's C entry point, built on first use, typed once."""
    fn = build.load(SOURCE).moe_dispatch_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int64] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def launch_geometry(m: int) -> tuple[int, int]:
    """(blocks, span): the launch's block count and the events each block
    takes, block r the events ``[r * span, min(m, (r + 1) * span))``.

    One block up to `SOLO_ROUNDS` rounds (the served streams: no cluster
    barrier), else a cluster of as many blocks as rounds, up to
    `MAX_BLOCKS`; spans are whole rounds, and together they tile
    ``[0, m)`` for ``m >= 1``.  On an H100 (tools/time_moe_dispatch.py) a
    cluster of three one-round blocks lost to one block at 3,072 events,
    and eight blocks of two rounds beat four of four at 16,384.
    """
    rounds = -(-m // ROUND)
    blocks = 1 if rounds <= SOLO_ROUNDS else min(MAX_BLOCKS, rounds)
    span = -(-rounds // blocks) * ROUND
    return -(-m // span), span


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
    blocks, span = launch_geometry(m)
    err = _lib()(expert_ids.data_ptr(), m, num_experts, blocks, span,
                 pos.data_ptr(), load.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_dispatch kernel launch failed: cudaError_t "
                           f"{err}")
    launches += 1
    return pos, load
