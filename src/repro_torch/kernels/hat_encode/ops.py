"""Public ops for hierarchical address-event encoding.

Port of `repro.kernels.hat_encode.ops`, over any leading batch axes, with
the same ``impl`` names: ``"xla"`` is the plain torch version (`ref`),
``"pallas"`` the kernel path, which dispatches on where the bitmaps lie:
CUDA tensors launch the CUDA kernel (`kernel`), CPU tensors take the
plain version.  There is no fallback from the kernel to the plain
version.  ``impl="pallas"`` keeps the JAX op's limits (N a multiple of
``row``, N <= `MAX_PALLAS_N`) and raises its `ValueError` outside them.

`hat_run` is the port's own: the interface tick's use of the encoder, the
arbiter's tick latency, the encode energy and the event count of every
(tick, lane, core) bitmap of a session run, in one launch of
`kernel.hat_run_cuda` on the card (N a multiple of 256).  Its plain
version (`ref.hat_run_ref`, CPU tensors) is the composition it replaces.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.kernels.hat_encode import kernel as hat_kernel
from repro_torch.kernels.hat_encode import ref

MAX_PALLAS_N = 1 << 16
RUN_ROW = hat_kernel.RUN_CHUNK


class HatPolicy(NamedTuple):
    """A scheme's arbiter terms, as plain torch callables and, where a
    plan on the card takes the kernel, as its `kernel.RunArgs`."""
    latency_fn: Callable         # dense (..., n) bool -> (...) float32
    encode_fn: Callable          # (..., n) int32 AER stream -> (...) float32
    n: int
    args: Optional[hat_kernel.RunArgs]   # None: plain version only


def bind_run(latency_fn, encode_fn, kernel_policy: Optional[int],
             levels: int, n: int, device) -> HatPolicy:
    """A scheme's `HatPolicy` for `hat_run` on ``device``, built once per
    plan.  On a CUDA device where the kernel takes n (`takes`), the
    kernel's static quantities are derived here, once.

    Raises:
      ValueError: on a CUDA device, at an n the kernel takes, for a scheme
        that registers no ``kernel_policy``.
    """
    args = None
    if torch.device(device).type == "cuda" and takes(n):
        if kernel_policy is None:
            raise ValueError(
                "this arbiter scheme registers no kernel_policy, so the "
                "CUDA hat_run cannot run it (use impl='xla')")
        args = hat_kernel.run_args(kernel_policy, n, levels)
    return HatPolicy(latency_fn, encode_fn, n, args)


def takes(n: int, row: int = RUN_ROW) -> bool:
    """The ``"pallas"`` path's size rule: N a multiple of ``row`` and at
    most `MAX_PALLAS_N`."""
    return n % row == 0 and n <= MAX_PALLAS_N


def _pallas_ok(n: int, row: int, impl: str) -> bool:
    """Take the kernel path?  Raises on an unknown impl or an N the
    ``"pallas"`` path does not take."""
    if impl == "pallas" and takes(n, row):
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


def hat_run(stream, policy: HatPolicy, impl: str = "xla"):
    """The arbiter's tick terms of every bitmap of a run.

    Args:
      stream: (B, T, C, n) bool frames.
      policy: the scheme's `HatPolicy` (`bind_run`).
      impl: ``"pallas"`` takes the kernel on CUDA frames (one launch) and
        raises for an n that is not a multiple of 256 or over
        `MAX_PALLAS_N`; ``"xla"`` and CPU frames take `ref.hat_run_ref`.

    Returns:
      (latency float32, encode energy float32, events int32), each
      (T, B, C).

    Raises:
      ValueError: on frames that are not n wide, an unknown impl, an n
        outside the kernel's limits, or CUDA frames under a policy bound
        for the CPU.
    """
    n = stream.shape[-1]
    if stream.ndim != 4 or n != policy.n:
        raise ValueError(f"hat_run needs (B, T, C, {policy.n}) frames, got "
                         f"{tuple(stream.shape)}")
    if _pallas_ok(n, RUN_ROW, impl) and stream.is_cuda:
        if policy.args is None:
            raise ValueError("this HatPolicy was bound for the CPU; bind "
                             "it on the frames' CUDA device")
        return hat_kernel.hat_run_cuda(stream.contiguous(), policy.args)
    return ref.hat_run_ref(stream, policy.latency_fn, policy.encode_fn)
