"""Training step factory: loss, microbatch accumulation, optimizer update.

Port of `repro.train.step`.  `make_train_step(cfg, opt_cfg)` builds

    train_step(state, batch) -> (state, metrics)

on torch tensors: the loss through `repro_torch.models.lm.forward`
(activation checkpointing per layer-group repeat with ``remat``, the JAX
default), its gradient by `torch.autograd.grad` over the parameter
tree's leaves, and one `repro_torch.optim.adamw.update`.  With
``microbatch > 1`` the batch is split along axis 0 and the gradients
accumulate in float32, microbatch by microbatch, as the JAX package's
scan does.  The step runs where the state lies; `init_state` draws it on
the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
from repro_torch.models import lm
from repro_torch.models.blocks import LOCAL, ShardCtx
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: dict
    opt: adamw.AdamWState
    step: torch.Tensor       # 0-d int32


def init_state(generator: torch.Generator | None, cfg: ModelConfig,
               opt_cfg: adamw.AdamWConfig, device=None) -> TrainState:
    """Parameters drawn from ``generator`` (`lm.init_model`) on ``device``
    (the CUDA device when None), zero moments and step 0."""
    params = lm.init_model(generator, cfg, device=device)
    opt = adamw.init(opt_cfg, params)
    return TrainState(params=params, opt=opt,
                      step=torch.zeros((), dtype=torch.int32,
                                       device=opt.step.device))


def cross_entropy(logits, labels, mask=None):
    """Stable CE; labels -100 (or mask=0) positions are ignored."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    safe_labels = labels.clamp_min(0).long()
    gold = torch.gather(logits, -1, safe_labels[..., None])[..., 0]
    nll = lse - gold
    valid = labels >= 0
    if mask is not None:
        valid = valid & (mask > 0)
    nll = torch.where(valid, nll, 0.0)
    denom = valid.sum(dtype=torch.int32).clamp_min(1)
    return nll.sum() / denom


def loss_fn(params, batch, cfg: ModelConfig, ctx: ShardCtx = LOCAL,
            remat=True, remat_policy: str | None = None):
    """(loss + the aux losses, metrics {"ce_loss", aux...})."""
    out = lm.forward(params, batch, cfg, mode="train", ctx=ctx, remat=remat,
                     remat_policy=remat_policy)
    logits = out["logits"]
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:
        # vision prefix: logits cover [image; text] - score text only
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    loss = cross_entropy(logits, labels, batch.get("loss_mask"))
    aux_sum = sum(out["aux"].values()) if out["aux"] else 0.0
    metrics = {"ce_loss": loss, **out["aux"]}
    return loss + aux_sum, metrics


def value_and_grad(params, batch, cfg: ModelConfig, ctx: ShardCtx = LOCAL,
                   remat=True, remat_policy: str | None = None):
    """`loss_fn` and its gradient: (loss, metrics, the gradients as a
    list in the parameter tree's flatten order), all detached."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = loss_fn(tree_unflatten(params, leaves), batch, cfg,
                            ctx, remat, remat_policy)
    # a leaf the loss does not read (the token embedding of the audio
    # frontend, whose head is untied) gets a zero gradient, as in JAX
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    ctx: ShardCtx = LOCAL, microbatch: int = 1,
                    remat: bool = True, remat_policy: str | None = None):
    """``train_step(state, batch) -> (state, metrics)``: metrics hold
    0-d tensors ``ce_loss`` (the last microbatch's), the aux losses,
    ``grad_norm``, ``lr`` and ``loss`` (the mean over microbatches)."""
    def train_step(state: TrainState, batch):
        if microbatch == 1:
            loss, metrics, grads = value_and_grad(
                state.params, batch, cfg, ctx, remat, remat_policy)
        else:
            grads, loss = None, 0.0
            for i in range(microbatch):
                mb = {k: v.reshape(microbatch, v.shape[0] // microbatch,
                                   *v.shape[1:])[i]
                      for k, v in batch.items()}
                l, metrics, g = value_and_grad(
                    state.params, mb, cfg, ctx, remat, remat_policy)
                if grads is None:
                    grads = [torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device) for x in g]
                grads = [a + b.to(torch.float32) for a, b in zip(grads, g)]
                loss = loss + l
            grads = [g / microbatch for g in grads]
            loss = loss / microbatch
        new_params, new_opt, opt_metrics = adamw.update(
            opt_cfg, tree_unflatten(state.params, grads), state.opt,
            state.params)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return TrainState(params=new_params, opt=new_opt,
                          step=state.step + 1), metrics

    return train_step


def make_eval_step(cfg: ModelConfig, ctx: ShardCtx = LOCAL):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch, cfg, ctx, remat=False)
        return {"loss": loss, **metrics}
    return eval_step
