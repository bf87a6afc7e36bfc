"""Distributed-optimization collectives: compressed gradient all-reduce.

Port of `repro.parallel.collectives`: int8 block-quantized sums with
error feedback - the cross-pod gradient sync trick for multi-pod
training, where the pod-to-pod links are the scarce resource.  4x fewer
bytes on the wire; error feedback keeps the quantization noise from
biasing convergence (the residual is carried between steps).

Where the JAX functions take an axis name and run inside ``shard_map``,
these take a process group (``group``; None: the whole world) and run on
each rank's local tensor.  No kernel stands behind them: they are plain
torch, as the JAX package's are plain ``jnp``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

BLOCK = 256


def quantize_int8(x: torch.Tensor):
    """Per-block symmetric int8 quantization.  x: flat float32 (N,) ->
    (int8 (blocks, BLOCK), float32 scales (blocks, 1)), bit for bit the
    JAX package's (``max |x| / 127``, round half to even, clip)."""
    n = x.shape[0]
    pad = (-n) % BLOCK
    xp = torch.nn.functional.pad(x, (0, pad)).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(xp), dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(xp / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q, scale, n):
    x = q.to(torch.float32) * scale
    return x.reshape(-1)[:n]


def _size(group) -> int:
    return dist.get_world_size(group)


def compressed_psum(x: torch.Tensor, group=None):
    """int8-compressed sum over ``group``: int8 payloads summed in int32,
    dequantized with the mean of the ranks' block scales (an
    approximation: each rank contributed q_i * scale_i)."""
    n = x.numel()
    flat = x.reshape(-1).to(torch.float32)
    q, scale = quantize_int8(flat)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, group=group)
    ssum = scale.clone()
    dist.all_reduce(ssum, group=group)
    mean_scale = ssum / _size(group)
    return dequantize_int8(qsum, mean_scale, n).reshape(x.shape)


def compressed_psum_exact_scales(x: torch.Tensor, group=None):
    """All-gather each rank's int8 payload and block scales and
    dequantize exactly: the sum over ranks, in rank order, of
    ``q_r * scale_r`` - bit for bit the sum of the per-rank
    `quantize_int8` results in that order, the same on every rank."""
    n = x.numel()
    flat = x.reshape(-1).to(torch.float32)
    q, scale = quantize_int8(flat)
    size = _size(group)
    qg = [torch.empty_like(q) for _ in range(size)]
    sg = [torch.empty_like(scale) for _ in range(size)]
    dist.all_gather(qg, q, group=group)
    dist.all_gather(sg, scale, group=group)
    out = qg[0].to(torch.float32) * sg[0]
    for r in range(1, size):
        out = out + qg[r].to(torch.float32) * sg[r]
    return out.reshape(-1)[:n].reshape(x.shape)


def make_ef_sync(group=None, exact: bool = True):
    """Error-feedback compressed sync: (grad, residual) -> (synced,
    new_residual); ``synced`` is the mean over ``group``."""
    psum_fn = compressed_psum_exact_scales if exact else compressed_psum

    def sync(g: torch.Tensor, residual: torch.Tensor):
        corrected = g + residual
        synced = psum_fn(corrected, group) / _size(group)
        # local quantization error -> carried to the next step
        q, s = quantize_int8(corrected.reshape(-1).to(torch.float32))
        sent = dequantize_int8(q, s, corrected.numel()).reshape(
            corrected.shape)
        return synced, corrected - sent

    return sync


def pod_sync_grads(grads, residuals, group=None, exact: bool = True):
    """Compress-sync a gradient tree (dicts and lists of tensors) across
    ``group`` (the pod axis's group).  Returns (synced, new_residuals)."""
    sync = make_ef_sync(group, exact)

    def walk(g, r):
        if isinstance(g, dict):
            pairs = {k: walk(g[k], r[k]) for k in g}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        if isinstance(g, (list, tuple)):
            pairs = [walk(a, b) for a, b in zip(g, r)]
            return [p[0] for p in pairs], [p[1] for p in pairs]
        return sync(g, r)

    return walk(grads, residuals)
