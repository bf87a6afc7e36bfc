"""Public ops for MoE dispatch positions.

Port of `repro.kernels.moe_dispatch.ops`, with the same ``impl`` names:
``"xla"`` is the plain torch version (`ref`), ``"pallas"`` the kernel
path, which dispatches on where the ids lie: CUDA tensors launch the
CUDA kernel (`kernel`), CPU tensors take the plain version.  There is no
fallback from the kernel to the plain version.  ``impl="pallas"`` keeps
the TPU kernel's row rule and raises its `ValueError`, so the same calls
fail in both packages.  ``row`` is the TPU kernel's tiling; the CUDA
kernel's chunks do not depend on it, nor do the results.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.moe_dispatch import kernel as moe_kernel
from repro_torch.kernels.moe_dispatch import ref

DEFAULT_ROW = 256
IMPLS = ("xla", "pallas")


def dispatch_positions(expert_ids, *, num_experts: int, impl: str = "xla",
                       row: int = DEFAULT_ROW):
    """Arrival-order position within expert + per-expert load.

    expert_ids: (M,) int -> (pos (M,) int32, load (E,) int32)

    Raises:
      ValueError: on an unknown ``impl``, or ``impl="pallas"`` with M not
        a multiple of ``row`` (the TPU kernel's rule).
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "xla":
        return ref.dispatch_positions_ref(expert_ids, num_experts)
    m = expert_ids.shape[0]
    if m % row:
        raise ValueError(f"M={m} must be a multiple of row={row}")
    if expert_ids.is_cuda:
        ids = expert_ids.to(torch.int32).contiguous()
        return moe_kernel.dispatch_positions_cuda(ids, num_experts)
    return ref.dispatch_positions_ref(expert_ids, num_experts)
