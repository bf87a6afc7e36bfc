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


class _VocabSplitNLL(torch.autograd.Function):
    """Per-position ``logsumexp(logits) - logits[label]`` of logits split
    along the vocab over the model axis, on this rank's block: the
    block's max, its sum of ``exp(logits - max)`` and its gold logit (0
    where the label lies in another rank's block) combine over the model
    axis.  The gradient of the block is its own part of ``softmax -
    one_hot``: no collective in the backward."""

    @staticmethod
    def forward(ctx_, logits, labels, first, rctx):
        from repro_torch.parallel import regions as R
        x = logits.float()
        v_loc = x.shape[-1]
        m = R.all_reduce(x.amax(dim=-1), "max", rctx)
        idx = labels.long() - first
        mine = (idx >= 0) & (idx < v_loc)
        gold = torch.gather(x, -1, idx.clamp(0, v_loc - 1)[..., None])[..., 0]
        sums = R.all_reduce(torch.stack(
            [(x - m[..., None]).exp_().sum(dim=-1),
             torch.where(mine, gold, 0.0)]), "sum", rctx)
        lse = m + torch.log(sums[0])
        ctx_.save_for_backward(logits, lse, idx, mine)
        return lse - sums[1]

    @staticmethod
    def backward(ctx_, g):
        logits, lse, idx, mine = ctx_.saved_tensors
        grad = (logits.float() - lse[..., None]).exp_()
        hit = torch.where(mine, -1.0, 0.0)
        grad.scatter_add_(-1, idx.clamp(0, grad.shape[-1] - 1)[..., None],
                          hit[..., None])
        return grad.mul_(g[..., None]).to(logits.dtype), None, None, None


def _cross_entropy_sharded(logits, labels, mask, ctx: ShardCtx):
    """`cross_entropy` of DTensor logits: each rank sums the NLL and
    counts the valid positions of its batch shard, and the two sums over
    the data axes make the mean.  Where the vocab divides the model axis
    the logits stay split along it, as `lm._head` places them and GSPMD
    partitions JAX's loss (`_VocabSplitNLL`: no rank holds the whole
    vocab); otherwise they are whole on each rank, as in JAX."""
    from repro_torch.models.blocks import _bspec_for
    from repro_torch.parallel import regions as R
    bspec = _bspec_for(ctx, logits.shape[0])
    part = R.grad_of_replicated((None,), ctx, bspec is not None)
    ops = [logits, labels] + ([mask] if mask is not None else [])
    split = logits.shape[-1] % ctx.model_size == 0

    def body(logits_, labels_, *mask_):
        if split:
            nll = _VocabSplitNLL.apply(
                logits_, labels_.clamp_min(0),
                R.model_index(ctx) * logits_.shape[-1], ctx)
        else:
            logits_ = logits_.float()
            gold = torch.gather(logits_, -1,
                                labels_.clamp_min(0).long()[..., None])
            nll = torch.logsumexp(logits_, dim=-1) - gold[..., 0]
        valid = labels_ >= 0
        if mask_:
            valid = valid & (mask_[0] > 0)
        nll = torch.where(valid, nll, 0.0)
        return nll.sum()[None], valid.sum(dtype=torch.float32)[None]

    specs = [(bspec, None, ctx.model_axis if split else None),
             (bspec, None)] + ([(bspec, None)] if mask is not None else [])
    nll, count = (R.reduce_data(a) for a in R.region(body, ctx, specs,
                                                     [part, part])(*ops))
    return (nll / count.clamp_min(1.0))[0]


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
    loss = (_cross_entropy_sharded(logits, labels, batch.get("loss_mask"),
                                   ctx) if ctx.enabled
            else cross_entropy(logits, labels, batch.get("loss_mask")))
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
    if ctx.enabled:       # the backward mixes DTensors and plain tensors
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        with implicit_replication():
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    else:
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    if ctx.enabled:       # partial sums reduced: each in its leaf's placement
        from repro_torch.parallel import regions as R
        grads = [R.reduce_data(g, p.placements)
                 for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _microbatches(batch: dict, m: int) -> list:
    """The ``m`` microbatches of ``batch``: rows ``[i b/m, (i+1) b/m)``,
    as the JAX step's reshape gives them.  A DTensor leaf is gathered
    whole once and each microbatch placed as the leaf was: DTensor cannot
    split a batch dim sharded over more ranks than ``m`` in place."""
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel import regions as R
    out = [{} for _ in range(m)]
    for k, v in batch.items():
        n = v.shape[0] // m
        whole = R.replicate(v)
        for i in range(m):
            part = whole[i * n:(i + 1) * n]
            if isinstance(v, DTensor):
                part = part.redistribute(v.device_mesh, v.placements)
            out[i][k] = part
    return out


def microbatch_value_and_grad(params, batch, cfg: ModelConfig,
                              ctx: ShardCtx = LOCAL, microbatch: int = 1,
                              remat: bool = True,
                              remat_policy: str | None = None):
    """`value_and_grad` of the mean over ``microbatch`` microbatches, as
    the JAX step's scan takes it: ``(loss, metrics, grads)``, the loss
    the mean of the microbatches', the metrics the last one's, the
    gradients summed in float32 in order and divided."""
    if microbatch == 1:
        return value_and_grad(params, batch, cfg, ctx, remat, remat_policy)
    grads, loss = None, 0.0
    for mb in _microbatches(batch, microbatch):
        l, metrics, g = value_and_grad(params, mb, cfg, ctx, remat,
                                       remat_policy)
        if grads is None:       # DTensors keep their placements
            grads = [torch.zeros_like(x, dtype=torch.float32) for x in g]
        grads = [a + b.to(torch.float32) for a, b in zip(grads, g)]
        loss = loss + l
    return (loss / microbatch, metrics,
            [g / microbatch for g in grads])


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    ctx: ShardCtx = LOCAL, microbatch: int = 1,
                    remat: bool = True, remat_policy: str | None = None):
    """``train_step(state, batch) -> (state, metrics)``: metrics hold
    0-d tensors ``ce_loss`` (the last microbatch's), the aux losses,
    ``grad_norm``, ``lr`` and ``loss`` (the mean over microbatches)."""
    def train_step(state: TrainState, batch):
        loss, metrics, grads = microbatch_value_and_grad(
            state.params, batch, cfg, ctx, microbatch, remat, remat_policy)
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
