"""Public ops for hierarchical address-event encoding.

Port of `repro.kernels.hat_encode.ops`, over any leading batch axes, with
the same ``impl`` names: ``"xla"`` is the plain torch version (`ref`),
``"pallas"`` the kernel path, which dispatches on where the bitmaps lie:
CUDA tensors launch the CUDA kernel (`kernel`), CPU tensors take the
plain version.  There is no fallback from the kernel to the plain
version.  ``impl="pallas"`` keeps the JAX op's limits (N a multiple of
``row``, N <= `MAX_PALLAS_N`) and raises its `ValueError` outside them.
"""

from __future__ import annotations

from repro_torch.kernels.hat_encode import kernel as hat_kernel
from repro_torch.kernels.hat_encode import ref

MAX_PALLAS_N = 1 << 16


def _pallas_ok(n: int, row: int, impl: str) -> bool:
    """Take the kernel path?  Raises on an unknown impl or an N the
    ``"pallas"`` path does not take."""
    if impl == "pallas" and n <= MAX_PALLAS_N and n % row == 0:
        return True
    if impl == "pallas":
        raise ValueError(f"pallas hat_encode supports N % {row} == 0 and "
                         f"N <= {MAX_PALLAS_N}; got N={n}")
    if impl != "xla":
        raise ValueError(f"unknown impl {impl!r}")
    return False


def hat_encode(spikes, *, row: int = 256, impl: str = "xla"):
    """Service ranks + counts for spike bitmaps (..., N): (ranks (..., N),
    count (...), cluster_counts (..., N // row)), all int32."""
    n = spikes.shape[-1]
    if _pallas_ok(n, row, impl) and spikes.is_cuda:
        return hat_kernel.hat_encode_cuda(spikes, row=row, stream=False)[:3]
    return ref.hat_encode_ref(spikes, row=row if n % row == 0 else 1)


def encode_stream(spikes, *, row: int = 256, impl: str = "xla"):
    """Compacted AER streams: active addresses in service order, padded N.

    On CUDA tensors with ``impl="pallas"`` one kernel launch writes the
    streams with the ranks.
    """
    if _pallas_ok(spikes.shape[-1], row, impl) and spikes.is_cuda:
        _, count, _, stream = hat_kernel.hat_encode_cuda(spikes, row=row,
                                                         stream=True)
        return stream, count
    ranks, count, _ = hat_encode(spikes, row=row, impl=impl)
    return ref.compact_stream(ranks, count), count
