"""Public ops for CAM search: impl dispatch + speculative-sense variant.

Port of `repro.kernels.cam_search.ops`, with the same ``impl`` names:
``"xla"`` is the plain torch version (`ref`), ``"pallas"`` the kernel
path, which dispatches on where the operands lie: CUDA tensors launch the
CUDA kernel (`kernel`), CPU tensors take the plain version.  There is no
fallback from the kernel to the plain version.

`cam_search` with ``impl="pallas"`` keeps the TPU kernel's block rule and
raises its `ValueError` when B or E is not a multiple of its block, so the
same calls fail in both packages.  `cam_match_counts` needs no padding for
that: the CUDA kernel takes any B and E and counts without writing the
(B, E) matrix, so the JAX op's ``_pad_rows`` has no counterpart here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.cam_search import kernel as cam_kernel
from repro_torch.kernels.cam_search import ref

DEFAULT_BLOCK_B = 128
DEFAULT_BLOCK_E = 128
IMPLS = ("xla", "pallas")

pack_bits = ref.pack_bits


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")


def _check_blocks(q_packed, t_packed) -> None:
    """The TPU kernel's block rule (`cam_search_pallas`, kernel.py:50-51)."""
    b, e = q_packed.shape[0], t_packed.shape[0]
    bb, be = min(DEFAULT_BLOCK_B, b), min(DEFAULT_BLOCK_E, e)
    if b % bb or e % be:
        raise ValueError(f"B={b} and E={e} must divide block sizes ({bb},{be})")


def cam_search(q_packed, t_packed, valid, *, impl: str = "xla"):
    """Batched associative tag match: (B, W), (E, W), (E,) -> (B, E) int32.

    Raises:
      ValueError: on an unknown ``impl``, or ``impl="pallas"`` with a B
        or E that is not a multiple of the TPU kernel's block.
    """
    _check_impl(impl)
    if impl == "pallas":
        _check_blocks(q_packed, t_packed)
        if q_packed.is_cuda:
            return cam_kernel.cam_search_cuda(q_packed, t_packed, valid)
    return ref.cam_search_ref(q_packed, t_packed, valid)


def cam_first_match(q_packed, t_packed, valid, *, impl: str = "xla"):
    """(B,) int32 index of each query's lowest matching entry (E if none)."""
    return ref.first_match_ref(cam_search(q_packed, t_packed, valid,
                                          impl=impl))


def cam_match_counts(q_packed, t_packed, valid, *, impl: str = "xla"):
    """Per-query match count: (B, W), (E, W), (E,) -> (B,) int32.

    ``valid`` may carry a leading lane axis, (L, E) -> (L, B): the lanes of
    a batched run share the queries and tags and differ in their valid
    flags (the interface tick passes each lane's spikes), and one kernel
    launch counts them all.
    """
    _check_impl(impl)
    lanes = valid if valid.ndim == 2 else valid[None]
    if impl == "pallas" and q_packed.is_cuda:
        counts = cam_kernel.cam_match_counts_cuda(q_packed, t_packed, lanes)
    else:
        counts = ref.match_counts_ref(q_packed, t_packed, lanes)
    return counts if valid.ndim == 2 else counts[0]


def cam_search_speculative(q_packed, t_packed, valid, *, impl: str = "xla"):
    """Two-pass filtered search - the speculative-sense analogue.

    Pass 1 compares only the *last* packed word (the paper senses the last
    n cells nearest the MLSA); entries failing it are masked out of the
    full-width pass.  Bit-exact with `cam_search`.
    """
    last_q = q_packed[:, -1:].contiguous()
    last_t = t_packed[:, -1:].contiguous()
    prefilter = cam_search(last_q, last_t, valid, impl=impl)
    full = cam_search(q_packed, t_packed, valid, impl=impl)
    return torch.where(prefilter.bool(), full, 0)
