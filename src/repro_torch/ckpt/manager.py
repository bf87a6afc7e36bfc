"""Checkpointing: atomic, keep-k, async.

Port of `repro.ckpt.manager`, in its on-disk format: one ``.npz`` per
checkpoint holding the flattened tree as ``leaf_0`` ... ``leaf_{k-1}``,
plus a JSON sidecar (``<path>.json``) with the step, the leaf count, the
tree's structure, the caller's ``extra`` and the wall time.  Writes go to
a temporary name and are ``os.replace``'d, so a crashed writer never
corrupts the latest checkpoint.

Leaves are in JAX's flatten order: dict keys sorted, tuple, list and
NamedTuple fields in order, ``None`` no leaf.  So a checkpoint that the
JAX package wrote for a tree restores into the same tree of tensors here
(e.g. the SNN's ``(params, AdamWState)``), and the other way round.

bfloat16: numpy has no bfloat16.  The JAX package's ``np.asarray`` of a
bfloat16 array saves its raw 2-byte patterns as a void (``|V2``) array;
the port writes the same bytes the same way and reads them back as
bfloat16 where the template leaf is bfloat16.  (The JAX package's own
`restore` cannot cast ``|V2`` back.)

`restore` returns tensors on the CUDA device unless the caller passes
``device="cpu"``; a missing card raises.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch

from repro_torch.interface.types import resolve_device


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> list:
    """Leaves of ``tree`` in JAX's flatten order (dict keys sorted,
    sequence and NamedTuple fields in order, ``None`` no leaf)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for t in tree for l in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves):
    """``like``'s structure with ``leaves`` (a sequence in flatten order,
    as `tree_leaves` lists them) as its leaves."""
    return _unflatten(like, iter(leaves))


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(t, leaves) for t in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(t, leaves) for t in like)
    return next(leaves)


def _treedef(tree) -> str:
    """The structure as JAX's ``str(treedef)`` writes it."""
    def walk(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if _is_namedtuple(t):
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(walk(c) for c in t) + "])")
        if isinstance(t, list):
            return "[" + ", ".join(walk(c) for c in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(walk(c) for c in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _to_host(leaf) -> np.ndarray:
    """A numpy copy of a leaf (bfloat16 as its ``|V2`` bit patterns)."""
    if not torch.is_tensor(leaf):
        return np.array(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2").copy()
    return t.numpy().copy()


def _from_host(arr: np.ndarray, like, device):
    """``arr`` as a leaf like ``like``: a tensor of its dtype on
    ``device``, or a numpy array of its dtype."""
    if not torch.is_tensor(like):
        return (np.asarray(arr, dtype=like.dtype) if hasattr(like, "dtype")
                else arr)
    if like.dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2 or arr.dtype.kind != "V":
            raise ValueError(f"cannot read a {arr.dtype} leaf as bfloat16")
        bits = np.array(arr, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, order="C")).to(like.dtype).to(
        device)


def save(path: str, tree, *, step: int, extra: dict | None = None):
    """Atomic checkpoint write."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = tree_leaves(tree)
    arrays = {f"leaf_{i}": _to_host(l) for i, l in enumerate(leaves)}
    meta = {"step": step, "num_leaves": len(leaves),
            "treedef": _treedef(tree), "extra": extra or {},
            "time": time.time()}
    tmp = path + ".tmp.npz"   # ends in .npz so np.savez keeps the name
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    with open(path + ".json.tmp", "w") as f:
        json.dump(meta, f)
    os.replace(path + ".json.tmp", path + ".json")


def restore(path: str, tree_like, *, device=None):
    """Restore into the structure of ``tree_like`` (values ignored).

    Tensor leaves come back as tensors of the template's dtype on
    ``device`` (the CUDA device when None; ``device="cpu"`` for the CPU),
    other leaves as numpy arrays.

    Raises:
      RuntimeError: ``device`` is None or CUDA and there is no GPU.
      KeyError: the file holds fewer leaves than the template.
    """
    device = resolve_device(device)
    leaves_like = tree_leaves(tree_like)
    with np.load(path) as z:
        arrays = [z[f"leaf_{i}"] for i in range(len(leaves_like))]
    leaves = [_from_host(a, ll, device) for a, ll in zip(arrays, leaves_like)]
    return _unflatten(tree_like, iter(leaves))


def load_meta(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f)


class CheckpointManager:
    """save-every-N, keep-last-k, optional async writer, auto-resume."""

    def __init__(self, directory: str, *, every: int = 100, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.every = every
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def _steps(self) -> list[int]:
        return sorted(int(f[5:13]) for f in os.listdir(self.dir)
                      if f.startswith("ckpt_") and f.endswith(".npz"))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def maybe_save(self, step: int, tree, extra: dict | None = None,
                   force: bool = False):
        if not force and (step == 0 or step % self.every):
            return False
        self.wait()
        # host copies on the caller thread (the tensors may change next step)
        host = _unflatten(tree, iter([_to_host(l)
                                      for l in tree_leaves(tree)]))

        def _do():
            save(self._path(step), host, step=step, extra=extra)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_do, daemon=True)
            self._thread.start()
        else:
            _do()
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, tree_like, *, device=None):
        self.wait()
        step = self.latest_step()
        if step is None:
            return None, None
        path = self._path(step)
        return restore(path, tree_like, device=device), load_meta(path)

    def _gc(self):
        for s in self._steps()[:-self.keep]:
            for suffix in (".npz", ".npz.json"):
                p = os.path.join(self.dir, f"ckpt_{s:08d}{suffix}")
                if os.path.exists(p):
                    os.remove(p)
