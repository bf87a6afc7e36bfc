"""AdamW with schedules, global-norm clipping and low-precision moments.

Port of `repro.optim.adamw`: plain functions on dicts of tensors, not
`torch.optim.AdamW`, so the schedule, the clipping and the decay rule are
the JAX package's.  Every scalar of the rule (the schedule, ``b ** step``,
the bias corrections, the clip scale) is a float32 tensor, as it is in
JAX, not a Python float.  Leaves are visited in sorted key order, JAX's
flatten order, so `global_norm` sums them as JAX does.
``moment_dtype="bfloat16"`` rounds the moments to nearest even, as
``astype`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


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


def init(cfg: AdamWConfig, params: dict) -> AdamWState:
    """Zero moments in ``moment_dtype`` on each parameter's device."""
    mdt = getattr(torch, cfg.moment_dtype)
    zeros = {k: torch.zeros(p.shape, dtype=mdt, device=p.device)
             for k, p in params.items()}
    step = torch.zeros((), dtype=torch.int32,
                       device=next(iter(params.values())).device)
    return AdamWState(step=step, mu=zeros,
                      nu={k: z.clone() for k, z in zeros.items()})


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in sorted key order."""
    total = 0
    for k in sorted(tree):
        total = total + tree[k].to(torch.float32).square().sum()
    return torch.sqrt(total)


def update(cfg: AdamWConfig, grads: dict, state: AdamWState, params: dict):
    """Returns (new_params, new_state, metrics)."""
    grads = {k: g.detach() for k, g in grads.items()}
    gnorm = global_norm(grads)
    scale = torch.minimum(_f32(1.0, gnorm), cfg.clip_norm / torch.maximum(
        gnorm, _f32(1e-9, gnorm)))
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - _f32(cfg.b1, stepf) ** stepf
    bc2 = 1.0 - _f32(cfg.b2, stepf) ** stepf
    mdt = getattr(torch, cfg.moment_dtype)

    new_params, new_mu, new_nu = {}, {}, {}
    for k in sorted(params):
        p = params[k].detach()
        g = grads[k].to(torch.float32) * scale
        m32 = state.mu[k].to(torch.float32) * cfg.b1 + g * (1 - cfg.b1)
        v32 = (state.nu[k].to(torch.float32) * cfg.b2
               + g.square() * (1 - cfg.b2))
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p = p.to(torch.float32) - lr * delta
        new_params[k] = new_p.to(p.dtype)
        new_mu[k], new_nu[k] = m32.to(mdt), v32.to(mdt)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, AdamWState(step=step, mu=new_mu, nu=new_nu), metrics
