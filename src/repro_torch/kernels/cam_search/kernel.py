"""Wrappers of the hand-written CUDA CAM search kernels.

The kernels (``repro_torch/csrc/cam_search.cu``) replace the TPU kernel
`repro.kernels.cam_search.kernel.cam_search_pallas` (kernel.py:40):
`cam_search_cuda` writes the (B, E) match matrix as that kernel does, and
`cam_match_counts_cuda` counts the matches of every query over the
entries for L lanes of valid flags, without writing the matrix: each
block compacts a lane's live entries (valid flag set) into shared memory
and compares its query rows against those only.  Both take any B, E and
W: the kernels mask their ragged edges.  See the source for the design
and bound.

Each wrapper checks its operands, allocates the output with
``torch.empty``, launches on the current CUDA stream and raises on a
non-zero ``cudaError_t``.  ``launches`` counts the launches of both entry
points (one per call that launches); nothing else adds to it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

SOURCE = "cam_search"
REPLACES = "src/repro/kernels/cam_search/kernel.py:40"
MAX_GRID_Y = 65535

launches = 0


@functools.cache
def _lib():
    """The kernels' C entry points, built on first use, typed once."""
    lib = build.load(SOURCE)
    search = lib.cam_search_launch
    search.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    search.restype = ctypes.c_int
    counts = lib.cam_match_counts_launch
    counts.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    counts.restype = ctypes.c_int
    return search, counts


def _operands(q_packed, t_packed, valid, valid_ndim):
    """Check the operands and return (device, B, E, W, valid as bool)."""
    dev = q_packed.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA CAM search needs CUDA tensors, got {dev}")
    for name, x in (("q_packed", q_packed), ("t_packed", t_packed)):
        if x.device != dev or x.dtype != torch.int32 or x.ndim != 2:
            raise ValueError(f"{name} must be a 2-d int32 tensor on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    (b, w), (e, w2) = q_packed.shape, t_packed.shape
    if w != w2 or w < 1:
        raise ValueError(f"query and tag word counts differ or are empty: "
                         f"{w} vs {w2}")
    if valid.device != dev or valid.ndim != valid_ndim or valid.shape[-1] != e:
        raise ValueError(f"valid must be {valid_ndim}-d ending in E={e} on "
                         f"{dev}, got {tuple(valid.shape)} on {valid.device}")
    return dev, b, e, w, valid.bool().contiguous()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")


def cam_search_cuda(q_packed, t_packed, valid):
    """(B, W) int32 x (E, W) int32 x (E,) -> (B, E) int32 match matrix.

    Same result as `ref.cam_search_ref`.

    Raises:
      ValueError: on an operand of the wrong device, dtype, shape or
        layout, or a B too large for the launch grid.
      RuntimeError: when the launch returns a CUDA error.
    """
    global launches
    dev, b, e, w, valid = _operands(q_packed, t_packed, valid, 1)
    if -(-b // 8) > MAX_GRID_Y:
        raise ValueError(f"B={b} exceeds the launch grid ({MAX_GRID_Y * 8})")
    out = torch.empty((b, e), dtype=torch.int32, device=dev)
    if b == 0 or e == 0:
        return out
    _raise_on(_lib()[0](q_packed.data_ptr(), t_packed.data_ptr(),
                        valid.data_ptr(), out.data_ptr(), b, e, w,
                        torch.cuda.current_stream(dev).cuda_stream),
              "cam_search")
    launches += 1
    return out


def cam_match_counts_cuda(q_packed, t_packed, valid):
    """(B, W) int32 x (E, W) int32 x (L, E) -> (L, B) int32 match counts.

    Same result as `ref.match_counts_ref`.

    Raises:
      ValueError: on an operand of the wrong device, dtype, shape or
        layout, or more lanes than the launch grid holds.
      RuntimeError: when the launch returns a CUDA error.
    """
    global launches
    dev, b, e, w, valid = _operands(q_packed, t_packed, valid, 2)
    lanes = valid.shape[0]
    if lanes > MAX_GRID_Y:
        raise ValueError(f"{lanes} lanes exceed the launch grid "
                         f"({MAX_GRID_Y})")
    counts = torch.empty((lanes, b), dtype=torch.int32, device=dev)
    if lanes == 0 or b == 0:
        return counts
    if e == 0:
        return counts.zero_()
    _raise_on(_lib()[1](q_packed.data_ptr(), t_packed.data_ptr(),
                        valid.data_ptr(), counts.data_ptr(), lanes, b, e, w,
                        torch.cuda.current_stream(dev).cuda_stream),
              "cam_match_counts")
    launches += 1
    return counts
