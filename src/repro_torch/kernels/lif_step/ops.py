"""Public ops for the LIF neuron update.

Port of `repro.kernels.lif_step.ops`, with the same ``impl`` names:
``"xla"`` is the plain torch version (`ref`), ``"pallas"`` the kernel
path, which dispatches on where the state lies: CUDA tensors launch the
CUDA kernel (`kernel`), CPU tensors take the plain version.  There is no
fallback from the kernel to the plain version.  ``impl="pallas"`` keeps
the TPU kernel's block rule and raises its `ValueError`, so the same
calls fail in both packages, and refuses operands that require grad
(the JAX package runs the kernel for inference only).

Both impls take float32 and bfloat16, as the JAX op does, each rounding
as JAX rounds on that type (`ref`); ``v`` and ``current`` must share
it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.lif_step import kernel as lif_kernel
from repro_torch.kernels.lif_step import ref

DEFAULT_BLOCK_B = 8
DEFAULT_BLOCK_N = 512
IMPLS = ("xla", "pallas")
DTYPES = (torch.float32, torch.bfloat16)


def _check_blocks(v) -> None:
    """The TPU kernel's block rule (`lif_step_pallas`, kernel.py:37-40)."""
    b, n = v.shape
    bb, bn = min(DEFAULT_BLOCK_B, b), min(DEFAULT_BLOCK_N, n)
    if b % bb or n % bn:
        raise ValueError(f"shape ({b},{n}) must divide blocks ({bb},{bn})")


def lif_step(v, current, *, decay: float, threshold: float,
             v_reset: float = 0.0, impl: str = "xla"):
    """(B, N) float32 or bfloat16 membrane update; returns (v_next,
    spikes) in the operands' type.

    Raises:
      ValueError: on an unknown ``impl``, or ``impl="pallas"`` with a
        shape that does not divide the TPU kernel's (8, 512) blocks.
      NotImplementedError: on operands of two types, or of a type other
        than float32 and bfloat16.
      RuntimeError: ``impl="pallas"`` on an operand that requires grad
        while grad mode is on.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    if v.dtype != current.dtype or v.dtype not in DTYPES:
        raise NotImplementedError(
            f"lif_step on {v.dtype} and {current.dtype} is not ported to "
            f"repro_torch: v and current must both be float32 or both "
            f"bfloat16 - use the JAX package `repro` for other types")
    if impl == "xla":
        return ref.lif_step_ref(v, current, decay=decay, threshold=threshold,
                                v_reset=v_reset)
    _check_blocks(v)
    if v.is_cuda:
        return lif_kernel.lif_step_cuda(v, current, decay, threshold, v_reset)
    if torch.is_grad_enabled() and (v.requires_grad or current.requires_grad):
        raise RuntimeError(
            "lif_step(impl='pallas') has no backward: call it under "
            "torch.no_grad() (train through impl='xla')")
    return ref.lif_step_ref(v, current, decay=decay, threshold=threshold,
                            v_reset=v_reset)
