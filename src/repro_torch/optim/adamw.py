"""AdamW with schedules, global-norm clipping and low-precision moments.

Port of `repro.optim.adamw`: plain functions on trees of tensors (dicts
and lists nested in any way, as the SNN's flat dict or the LM's
``params["groups"][gi][pos][...]``), not `torch.optim.AdamW`, so the
schedule, the clipping and the decay rule are the JAX package's.  Every
scalar of the rule (the schedule, ``b ** step``, the bias corrections,
the clip scale) is a float32 tensor, as it is in JAX, not a Python
float.  Leaves are visited in JAX's flatten order (dict keys sorted,
list items in order: `repro_torch.ckpt.manager.tree_leaves`), so
`global_norm` sums them as ``jax.tree.leaves`` lists them.
``moment_dtype="bfloat16"`` rounds the moments to nearest even, as
``astype`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.ckpt.manager import tree_leaves, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac (0-d float32)."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(cfg: AdamWConfig, params) -> AdamWState:
    """Zero moments in ``moment_dtype`` on each parameter's device (and
    in its placements, on a mesh: ZeRO falls out of the specs)."""
    mdt = getattr(torch, cfg.moment_dtype)
    leaves = tree_leaves(params)

    def zeros():
        return tree_unflatten(params, [torch.zeros_like(p, dtype=mdt)
                                       for p in leaves])

    step = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    return AdamWState(step=step, mu=zeros(), nu=zeros())


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in flatten order.  On
    DTensor leaves (a mesh) each rank sums the squares of its own blocks,
    a block that is replicated over mesh dims counted once among its
    copies, and one reduction over the mesh makes the total: the
    collectives are the same whichever way DTensor would combine the
    leaves' partial sums."""
    from torch.distributed.tensor import DTensor
    leaves = tree_leaves(tree)
    if leaves and isinstance(leaves[0], DTensor):
        return _global_norm_sharded(leaves)
    total = 0
    for g in leaves:
        total = total + g.to(torch.float32).square().sum()
    return torch.sqrt(total)


def _global_norm_sharded(leaves) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from repro_torch.parallel.regions import reduce_data
    mesh = leaves[0].device_mesh
    total = 0
    for g in leaves:
        if any(p.is_partial() for p in g.placements):
            g = reduce_data(g, [Replicate() if p.is_partial() else p
                                for p in g.placements])
        copies = math.prod(mesh.size(i) for i, p in enumerate(g.placements)
                           if p.is_replicate())
        total = total + g.to_local().to(torch.float32).square().sum() / copies
    total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim)
    return torch.sqrt(reduce_data(total, [Replicate()] * mesh.ndim)
                      .to_local())


def update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """Returns (new_params, new_state, metrics).  On DTensor trees (a
    mesh) every leaf stays in its placements and the scalars of the rule
    are plain tensors, replicated."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    if isinstance(tree_leaves(params)[0], DTensor):
        with implicit_replication():
            return _update(cfg, grads, state, params)
    return _update(cfg, grads, state, params)


def _update(cfg: AdamWConfig, grads, state: AdamWState, params):
    grads = [g.detach() for g in tree_leaves(grads)]
    gnorm = global_norm(grads)
    if hasattr(gnorm, "full_tensor"):
        gnorm = gnorm.full_tensor()
    scale = torch.minimum(_f32(1.0, gnorm), cfg.clip_norm / torch.maximum(
        gnorm, _f32(1e-9, gnorm)))
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - _f32(cfg.b1, stepf) ** stepf
    bc2 = 1.0 - _f32(cfg.b2, stepf) ** stepf
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(p, g, m, v):
        p = p.detach()
        g = g.to(torch.float32) * scale
        m32 = m.to(torch.float32) * cfg.b1 + g * (1 - cfg.b1)
        v32 = v.to(torch.float32) * cfg.b2 + g.square() * (1 - cfg.b2)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p = p.to(torch.float32) - lr * delta
        return new_p.to(p.dtype), m32.to(mdt), v32.to(mdt)

    flat = [upd(*a) for a in zip(tree_leaves(params), grads,
                                 tree_leaves(state.mu),
                                 tree_leaves(state.nu))]
    new_params, new_mu, new_nu = (tree_unflatten(params, [t[i] for t in flat])
                                  for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, AdamWState(step=step, mu=new_mu, nu=new_nu), metrics
