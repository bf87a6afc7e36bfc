"""The language model of the PyTorch port: every family of the registry.

Port of `repro.models.lm`: dense GQA transformers (internlm2, llama3.2,
qwen3's qk-norm, gemma3's 5:1 banded-local : global pattern with
sandwich norms and tied heads), DeepSeek-V2's MLA attention with dense
MLP or event-routed MoE feed-forwards (int8 experts too), RWKV6
(`models.rwkv6`), Jamba's Mamba + attention + MoE hybrid
(`models.mamba`), and the frontend stubs: HuBERT's audio frames and
phi-3-vision's image patches enter through a projection.  Structure:
embed/frontend -> layer groups -> final norm -> lm head.  The parameter
tree is the JAX package's: layers are stacked over the repeats of each
homogeneous group of `ModelConfig.scan_groups` (``[(0, 1), (1, 26)]``
for DeepSeek-V2-Lite, ``[(0, 48)]`` of 8 repeats of 5 local + 1 global
layers for gemma3-12b, ``[(0, 72)]`` of 9 repeats of jamba's 8-layer
block), and the port walks the stack with a Python loop over views
where the JAX package scans.  Caches mirror the same stacking and are
updated in place: KV caches, Mamba's ``{"conv", "ssm"}`` and RWKV's
``{"prev_x_tm", "prev_x_cm", "wkv"}`` states.

Entry points, on torch tensors:

    params = init_model(torch.Generator("cuda").manual_seed(0), cfg)
    out = forward(params, {"tokens": tokens}, cfg, mode="train")

(``{"frames", "mask"}`` for the audio frontend, ``{"tokens",
"image_embeds"}`` for the vision one.)  Tensors go to the CUDA device
unless the caller passes ``device="cpu"`` (`init_model`,
`lm_params_from_numpy`, `init_cache`); `forward` runs where its operands
lie.  Parameter values differ from the JAX package's for the same seed;
`lm_params_from_numpy` carries the JAX tree across.

Modes:
  train   - causal (bidirectional for encoders), no cache, logits
  prefill - causal forward that also fills the decode cache
  decode  - tokens against the cache at ``cache_len`` (a Python int)

``remat`` (the JAX default, True) recomputes each repeat of a group in
the backward pass (`torch.utils.checkpoint`), which changes no value;
``remat_policy`` maps the JAX package's names (`REMAT_POLICIES`) and
the `jax.checkpoint_policies` policies' names (`JAX_POLICY_NAMES`).

Sharding: with ``ctx = parallel.sharding.make_shard_ctx(mesh, cfg)`` on
a `DeviceMesh` (`repro_torch.launch.mesh`) and the parameters, batch and
caches placed as DTensors by the port's specs (`sharding.shard_tree`),
`forward` runs every family on the mesh: the embedding on each rank's
batch shard, the recurrent mixers tensor-parallel as the JAX package's
specs place them (Mamba's d_inner, RWKV's channel mix and padded WKV
heads over the model axis), the activations between
layer groups constrained to the JAX package's specs (the sequence over
the model axis under ``attn_shard="sequence"``), the logits split over
the vocab, and the ``shard_map`` regions of `models.blocks` as
``local_map`` regions.  A mesh run computes the single-device values
(each data shard routes its own MoE tokens, as in the JAX package).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.interface.session import resolve_device
from repro_torch.models import blocks, mamba, rwkv6
from repro_torch.models.blocks import ITEM_12, LOCAL, Draw, ShardCtx
from repro_torch.models.config import ModelConfig

Params = dict

MODES = ("train", "prefill", "decode")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(draw: Draw, cfg: ModelConfig, idx: int) -> Params:
    kind = cfg.layer_kind(idx)
    p: Params = {"ln1": blocks.init_rmsnorm(draw, cfg.d_model, cfg)}
    if kind == "attn":
        p["mix"] = (blocks.init_mla(draw, cfg) if cfg.mla is not None
                    else blocks.init_attention(draw, cfg))
    elif kind == "mamba":
        p["mix"] = mamba.init_mamba(draw, cfg)
    else:  # rwkv
        p["mix"] = rwkv6.init_time_mix(draw, cfg)
    p["ln2"] = blocks.init_rmsnorm(draw, cfg.d_model, cfg)
    if kind == "rwkv":
        p["ffn"] = rwkv6.init_channel_mix(draw, cfg)
    elif cfg.layer_is_moe(idx):
        p["ffn"] = blocks.init_moe(draw, cfg)
    else:
        d_ff = cfg.d_ff
        if cfg.moe is not None and idx < cfg.moe.first_k_dense:
            d_ff = cfg.moe.d_ff_dense or cfg.d_ff
        p["ffn"] = blocks.init_mlp(draw, cfg.d_model, d_ff, cfg)
    if cfg.post_norms:
        p["post_ln1"] = blocks.init_rmsnorm(draw, cfg.d_model, cfg)
        p["post_ln2"] = blocks.init_rmsnorm(draw, cfg.d_model, cfg)
    return p


def init_model(generator: torch.Generator | None, cfg: ModelConfig,
               device=None) -> Params:
    """The parameter tree, drawn from ``generator`` on its device and
    placed on ``device`` (the CUDA device when None).  Draw on the card
    for the full model: DeepSeek-V2-Lite is 62.8 GB in float32.  Int8
    experts are drawn in float32 and quantized (`blocks.quantize_int8`).

    With ``generator=None`` and ``device="meta"`` it only shapes the tree.
    """
    device = resolve_device(device)
    pdt = blocks.dtype_of(cfg.param_dtype)
    draw = Draw(generator, pdt)
    p: Params = {"embed": draw.normal((cfg.vocab, cfg.d_model), 0.02)}
    if cfg.frontend.kind != "none":
        p["frontend_proj"] = blocks._dense_init(
            draw, (cfg.frontend.d_in, cfg.d_model), pdt)
        if cfg.frontend.kind == "audio":
            p["mask_embed"] = draw.normal((cfg.d_model,), 0.02)
    p["groups"] = []
    for start, length in cfg.scan_groups():
        g = cfg.scan_group
        stacked = draw.stacked(length // g)
        p["groups"].append([_init_layer(stacked, cfg, start + pos)
                            for pos in range(g)])
    p["final_norm"] = blocks.init_rmsnorm(draw, cfg.d_model, cfg)
    if not cfg.tie_embeddings:
        p["lm_head"] = blocks._dense_init(draw, (cfg.d_model, cfg.vocab), pdt)
    return _tree_map(lambda t: t.to(device), p)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def lm_params_from_numpy(cfg: ModelConfig, params, device=None) -> Params:
    """The parameter tree as torch tensors on ``device`` (the CUDA device
    when None) from the JAX package's tree with numpy leaves, e.g.
    ``jax.tree.map(np.asarray, repro.models.lm.init_model(key, cfg))``:
    the same nesting (``groups`` a list of lists of stacked layer dicts),
    each leaf of the shape `init_model` gives, int8 experts as int8 with
    their float32 ``*_scale`` leaves.

    Raises:
      ValueError: on a missing or extra key, a list of another length, or
        a leaf of another shape; the message names its path.
    """
    device = resolve_device(device)
    want = init_model(None, cfg, device="meta")

    def convert(w, p, path):
        if isinstance(w, dict):
            if not isinstance(p, dict) or set(p) != set(w):
                got = sorted(p) if isinstance(p, dict) else type(p).__name__
                raise ValueError(f"{path or '/'}: keys {got}, want "
                                 f"{sorted(w)}")
            return {k: convert(w[k], p[k], f"{path}/{k}") for k in w}
        if isinstance(w, list):
            if not isinstance(p, (list, tuple)) or len(p) != len(w):
                raise ValueError(f"{path}: want a list of {len(w)}")
            return [convert(a, b, f"{path}/{i}")
                    for i, (a, b) in enumerate(zip(w, p))]
        arr = np.asarray(p)
        if arr.shape != tuple(w.shape):
            raise ValueError(f"{path}: shape {arr.shape}, want "
                             f"{tuple(w.shape)}")
        # through float32: exact for float32, bfloat16 and int8 leaves
        return torch.from_numpy(arr.astype(np.float32)).to(device, w.dtype)

    return convert(want, params, "")


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _layer_cache(cfg: ModelConfig, idx: int, n_rep: int, b: int, s: int,
                 device):
    """Layer ``idx``'s cache, zeros stacked over the group's repeats: the
    MLA latent ``{"ckv", "kr"}`` or GQA's ``{"k", "v"}``, each (n_rep, B,
    S, ...) in the compute type; Mamba's ``{"conv"}`` (compute type) and
    ``{"ssm"}`` (float32); RWKV's ``{"prev_x_tm", "prev_x_cm"}`` (compute
    type) and ``{"wkv"}`` (float32)."""
    cdt = blocks.dtype_of(cfg.compute_dtype)
    f32 = torch.float32
    kind = cfg.layer_kind(idx)
    if kind == "attn":
        if cfg.mla is not None:
            kv = {"ckv": (cfg.mla.kv_lora,), "kr": (cfg.mla.qk_rope_dim,)}
        else:
            kv = dict.fromkeys(("k", "v"), (cfg.n_kv_heads, cfg.head_dim))
        shapes = {k: ((s,) + shape, cdt) for k, shape in kv.items()}
    elif kind == "mamba":
        di = mamba.d_inner(cfg)
        shapes = {"conv": ((cfg.mamba.d_conv - 1, di), cdt),
                  "ssm": ((di, cfg.mamba.d_state), f32)}
    else:
        hd = cfg.rwkv.head_dim
        shapes = {"prev_x_tm": ((1, cfg.d_model), cdt),
                  "prev_x_cm": ((1, cfg.d_model), cdt),
                  "wkv": ((cfg.d_model // hd, hd, hd), f32)}
    return {k: torch.zeros((n_rep, b) + shape, dtype=dt, device=device)
            for k, (shape, dt) in shapes.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Stacked cache tree matching the layer groups: per group, per body
    position, the layer's cache (`_layer_cache`) on ``device`` (the CUDA
    device when None)."""
    device = resolve_device(device)
    return [[_layer_cache(cfg, start + pos, length // cfg.scan_group, batch,
                          max_len, device) for pos in range(cfg.scan_group)]
            for start, length in cfg.scan_groups()]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _apply_layer(lp, x, cfg: ModelConfig, idx: int, *, mode: str, cache,
                 cache_len, positions, ctx: ShardCtx):
    """One layer.  Its cache, if any, is updated in place: attention
    writes its KV rows, the Mamba and RWKV mixers' new states are copied
    into their cache tensors."""
    kind = cfg.layer_kind(idx)
    aux = {}
    h = _grad_reduced(blocks.rms_norm(x, lp["ln1"], cfg.norm_eps))
    state = None
    if kind == "attn":
        if cfg.mla is not None:
            o, _ = blocks.mla_apply(lp["mix"], h, cfg, positions=positions,
                                    cache=cache, cache_len=cache_len,
                                    ctx=ctx)
        else:
            o, _ = blocks.attention_apply(
                lp["mix"], h, cfg, is_local=cfg.layer_is_local(idx),
                positions=positions, cache=cache, cache_len=cache_len,
                ctx=ctx, causal=not cfg.encoder_only)
    elif kind == "mamba":
        o, state = mamba.mamba_apply(lp["mix"], h, cfg, state=cache, ctx=ctx)
    else:
        o, state = rwkv6.time_mix_apply(lp["mix"], h, cfg, state=cache,
                                        chunked=(mode != "decode"), ctx=ctx)
    o = _reduced_like(o, x)
    if cfg.post_norms:
        o = blocks.rms_norm(o, lp["post_ln1"], cfg.norm_eps)
    x = x + o
    h = _grad_reduced(blocks.rms_norm(x, lp["ln2"], cfg.norm_eps))
    if kind == "rwkv":
        o, state2 = rwkv6.channel_mix_apply(lp["ffn"], h, cfg, state=state,
                                            ctx=ctx)
        state = state2 if state2 is not None else state
    elif cfg.layer_is_moe(idx):
        o, aux = blocks.moe_apply(lp["ffn"], h, cfg, ctx=ctx)
    else:
        o = blocks.mlp_apply(lp["ffn"], h, cfg)
    o = _reduced_like(o, x)
    if cfg.post_norms:
        o = blocks.rms_norm(o, lp["post_ln2"], cfg.norm_eps)
    x = x + o
    if state is not None:
        for k_, v_ in state.items():
            _write_state(cache[k_], v_)
    return x, aux


def _reduced_like(o, x):
    """A branch output that is a `Partial` sum (a row-parallel product's)
    reduced once, into the placements of the residual stream ``x`` it
    joins: an all-reduce where ``x`` is whole over the model axis, a
    reduce-scatter where it holds the tokens split there.  GSPMD reduces
    it so; DTensor left alone may keep the sum `Partial` through the add
    and reduce it again at each reader, as torch's versions differ.
    Where autograd records nothing, a sum over several mesh dims (a
    MoE's output at one sequence: over the data axes and ``model``) is
    one all-reduce over them together, as GSPMD makes it, not one a
    dim."""
    if isinstance(o, DTensor) and any(p.is_partial() for p in o.placements):
        from repro_torch.parallel import regions as R
        dims = [i for i, (p, q) in enumerate(zip(o.placements, x.placements))
                if p.is_partial() and q.is_replicate()]
        if len(dims) > 1 and not R.recorded(o):
            o = R.sum_partial(o, dims)
        return o.redistribute(x.device_mesh, x.placements)
    return o


class _GradReduced(torch.autograd.Function):
    """The identity, whose gradient is reduced once into the placements
    of its operand where it comes back a `Partial` sum."""

    @staticmethod
    def forward(ctx_, h):
        ctx_.mesh, ctx_.placements = h.device_mesh, h.placements
        return h.view_as(h)

    @staticmethod
    def backward(ctx_, g):
        if any(p.is_partial() for p in g.placements):
            from repro_torch.parallel import regions as R
            g = R.reduce_data(g, ctx_.placements)
        return g


def _grad_reduced(h):
    """A branch input ``h`` whose gradient is reduced once, where the
    branch's column-parallel products leave it a `Partial` sum over the
    model axis: GSPMD's one all-reduce of each branch input's gradient
    (the transpose of `_reduced_like`), on any torch version."""
    if isinstance(h, DTensor) and torch.is_grad_enabled():
        return _GradReduced.apply(h)
    return h


def _write_state(dst, new):
    """``dst.copy_(new)``; a DTensor cache leaf takes its own block of
    ``new`` (which the mixers' regions leave in the leaf's placements),
    in place."""
    if isinstance(dst, DTensor):
        dst.to_local().copy_(new.redistribute(dst.device_mesh,
                                              dst.placements).to_local())
    else:
        dst.copy_(new)


def _embed_sharded(params, batch, cfg: ModelConfig, ctx: ShardCtx):
    """`_embed` on a mesh.  Tokens are looked up vocab-parallel: each
    rank reads the rows of its own vocab slice (zeros elsewhere) and the
    slices sum over the model axis, exactly, since one rank holds each
    row.  Where autograd records nothing, the table's split over the
    data axes (its columns) takes `regions.product_plan`'s lookup rule:
    gathered, or left in place with each rank's columns looked up for
    every token, then the columns gathered (the tokens whole over the
    data axes) or the rows moved to their owners by one all-to-all (the
    tokens split there: decode's, as GSPMD looks them up).  The audio
    frontend runs on each rank's batch shard with its projection
    gathered, and the train step's lookup with the table's data split
    gathered (each in one call over the data axes together,
    `regions.gather_data`)."""
    from repro_torch.parallel import regions as R
    cdt = blocks.dtype_of(cfg.compute_dtype)
    keys = sorted(batch)
    bspec = blocks._bspec_for(ctx, batch[keys[0]].shape[0])
    batch = {k: _as_dtensor(v, bspec, ctx) for k, v in batch.items()}
    split = (lambda t: (bspec,) + (None,) * (t.ndim - 1))
    if cfg.frontend.kind == "audio":
        names = [k for k in ("frontend_proj", "mask_embed") if k in params]

        def body(*args):
            return _embed(dict(zip(names, args[:len(names)])),
                          dict(zip(keys, args[len(names):])), cfg)

        w_specs = [(None,) * params[k].ndim for k in names]
        ws = [R.gather_data(params[k]) if R.gathers_flat(params[k])
              else params[k] for k in names]
        return R.region(
            body, ctx, w_specs + [split(batch[k]) for k in keys],
            (bspec, None, None),
            in_grad=[R.grad_of_replicated(sp, ctx, bspec is not None)
                     for sp in w_specs] + [None] * len(keys))(
                *ws, *[batch[k] for k in keys])

    vocab_split = cfg.vocab % ctx.model_size == 0
    e_spec = (ctx.model_axis if vocab_split else None, None)
    embed = params["embed"]
    out = (R.partial_on_model((bspec, None, None), ctx) if vocab_split
           else R.placements((bspec, None, None), ctx))
    recorded = R.recorded(embed)
    tokens, t_spec = batch["tokens"], (bspec, None)
    # `blocks._linear`'s rule for the lookup (no gradient recorded)
    plan = R.product_plan(tokens, embed, lookup_dt=cdt)
    in_place = plan is not None and plan.kind in ("cols", "all_to_all")
    if in_place:
        # each rank reads its block of the table's columns for every
        # token, gathered after the lookup ("cols": the tokens whole over
        # the data axes) or its rows moved to their owners ("all_to_all":
        # the tokens split there, gathered first)
        from torch.distributed.tensor import Shard
        if plan.kind == "all_to_all":
            tokens, t_spec = R.gather_data(tokens, plan.dims), (None, None)
            out = (R.partial_on_model((None, None, None), ctx)
                   if vocab_split else R.placements((None, None, None), ctx))
        e_spec = tuple(embed.placements)
        out = tuple(Shard(2) if e.is_shard(1) else q
                    for q, e in zip(out, e_spec))
    elif plan is not None or R.gathers_flat(embed):
        embed = R.gather_data(embed, plan.dims if plan is not None else None)

    def lookup(e, tok):
        v_loc = e.shape[0]
        idx = tok.long() - (R.model_index(ctx) * v_loc if vocab_split else 0)
        mine = (idx >= 0) & (idx < v_loc)
        rows = e[idx.clamp(0, v_loc - 1)]
        return torch.where(mine[..., None], rows, 0.0).to(cdt)

    grads = ([R.grad_of_replicated(e_spec, ctx, bspec is not None), None]
             if recorded else None)
    tok = R.region(lookup, ctx, [e_spec, t_spec], out,
                   in_grad=grads)(embed, tokens)
    if in_place:
        # the vocab blocks' sum, then the columns or the rows
        tok = R.finish_product(R.sum_partial(tok, [
            ctx.mesh.mesh_dim_names.index(ctx.model_axis)]), plan)
    tok = R.constrain(tok, (bspec, None, None), ctx)
    if cfg.frontend.kind == "vision" and "image_embeds" in batch:
        img = blocks._linear(batch["image_embeds"].to(cdt),
                             params["frontend_proj"], cdt)
        return torch.cat([img, tok], dim=1)
    if cfg.family != "rwkv":
        scale = torch.sqrt(torch.tensor(float(cfg.d_model),
                                        dtype=torch.float32)).to(cdt)
        return tok * scale.to(tok.device)
    return tok


def _as_dtensor(t, bspec, ctx: ShardCtx):
    """A batch leaf as a DTensor: as it is, or (the same full tensor on
    every rank) placed with its batch dim over the data axes."""
    if isinstance(t, DTensor):
        return t
    from repro_torch.parallel import sharding
    return sharding.place(t, (bspec,) + (None,) * (t.ndim - 1), ctx.mesh)


def _embed(params, batch, cfg: ModelConfig):
    cdt = blocks.dtype_of(cfg.compute_dtype)
    if cfg.frontend.kind == "audio":
        x = batch["frames"].to(cdt) @ params["frontend_proj"].to(cdt)
        if "mask" in batch:
            x = torch.where(batch["mask"][..., None],
                            params["mask_embed"].to(cdt)[None, None], x)
        return x
    tok = params["embed"][batch["tokens"].long()].to(cdt)
    if cfg.frontend.kind == "vision" and "image_embeds" in batch:
        img = (batch["image_embeds"].to(cdt)
               @ params["frontend_proj"].to(cdt))
        return torch.cat([img, tok], dim=1)
    if cfg.family != "rwkv":
        scale = torch.sqrt(torch.tensor(float(cfg.d_model),
                                        dtype=torch.float32)).to(cdt)
        return tok * scale
    return tok


def _head(params, x, cfg: ModelConfig, ctx: ShardCtx = LOCAL):
    """Final norm and the lm head: (B, T, d) -> (B, T, vocab) logits;
    under an enabled ``ctx`` split over the model axis along the vocab
    when it divides (the JAX package's constraint).  There the normed
    activations are whole over the model axis first (gathered where
    ``attn_shard="sequence"`` splits the tokens), so that the head is
    column-parallel and its logits come out in that split, as GSPMD
    makes them, rather than its weight gathered and the logits moved."""
    x = blocks.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if ctx.enabled:
        from repro_torch.parallel import regions as R
        bspec = blocks._bspec_for(ctx, x.shape[0])
        x = _grad_reduced(R.constrain(x, (bspec, None, None), ctx))
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = blocks._linear(x, w, x.dtype)
    if ctx.enabled:
        vspec = ctx.model_axis if cfg.vocab % ctx.model_size == 0 else None
        logits = R.constrain(logits, (bspec, None, vspec), ctx)
    return logits


def _constrain_acts(x, cfg: ModelConfig, ctx: ShardCtx):
    """Activations between layer groups: the batch over the data axes,
    and under ``attn_shard="sequence"`` the tokens over the model axis
    when they divide it."""
    from repro_torch.parallel import regions as R
    bspec = blocks._bspec_for(ctx, x.shape[0])
    if (cfg.attn_shard == "sequence" and x.shape[1] > 1
            and x.shape[1] % ctx.model_size == 0):
        return R.constrain(x, (bspec, ctx.model_axis, None), ctx)
    return R.constrain(x, (bspec, None, None), ctx)


def _layer_view(tree, r: int):
    """Repeat ``r`` of a stacked layer tree, as views."""
    return _tree_map(lambda a: a[r], tree)


def _unstack(tree, n: int) -> list:
    """The ``n`` repeats of a stacked layer tree, as views.  One unbind a
    leaf: under autograd its backward stacks the repeats' gradients once,
    where a view a repeat would scatter each into a zero leaf."""
    parts = _tree_map(lambda a: a.unbind(0), tree)
    return [_pick(parts, r) for r in range(n)]


def _pick(tree, r: int):
    if isinstance(tree, dict):
        return {k: _pick(v, r) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, r) for v in tree]
    return tree[r]


# the JAX package's names: what jax.checkpoint saves under each, as torch
# ops the selective checkpoint keeps (None: recompute everything;
# "everything": save everything, i.e. no recomputation)
REMAT_POLICIES = {
    None: None,
    "none": None,
    "dots": ("mm", "addmm"),                 # dots_with_no_batch_dims_saveable
    "dots_batch": ("mm", "addmm", "bmm", "baddbmm"),     # dots_saveable
    "everything": "everything",              # everything_saveable
}
# the `jax.checkpoint_policies` attributes that are policies (not
# factories such as ``save_only_these_names``), by the short name above
# that JAX resolves to the same policy
JAX_POLICY_NAMES = {
    "nothing_saveable": "none",
    "dots_with_no_batch_dims_saveable": "dots",
    "checkpoint_dots_with_no_batch_dims": "dots",
    "dots_saveable": "dots_batch",
    "checkpoint_dots": "dots_batch",
    "everything_saveable": "everything",
}


def _remat_wrap(body, remat: bool, remat_policy):
    """``body`` under activation checkpointing as ``remat`` and
    ``remat_policy`` ask, when autograd records (no grad: nothing is
    saved, so nothing is recomputed).  As in JAX, ``remat_policy`` is
    read only with ``remat``."""
    if not remat:
        return body
    name = JAX_POLICY_NAMES.get(remat_policy, remat_policy)
    if name not in REMAT_POLICIES:
        raise NotImplementedError(
            f"remat_policy {remat_policy!r} has no counterpart in "
            f"repro_torch ({ITEM_12}); it maps "
            f"{sorted(map(str, REMAT_POLICIES))} and the "
            f"jax.checkpoint_policies names {sorted(JAX_POLICY_NAMES)}")
    saved = REMAT_POLICIES[name]
    if saved == "everything" or not torch.is_grad_enabled():
        return body
    from torch.utils import checkpoint as ckpt
    if saved is None:
        return lambda x: ckpt.checkpoint(body, x, use_reentrant=False)
    ops = {getattr(torch.ops.aten, name).default for name in saved}

    def policy(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in ops
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    return lambda x: ckpt.checkpoint(
        body, x, use_reentrant=False,
        context_fn=functools.partial(
            ckpt.create_selective_checkpoint_contexts, policy))


def _replicating(fn):
    """``fn`` with plain tensors taken as replicated DTensors."""
    def run(x):
        with implicit_replication():
            return fn(x)
    return run


def forward(params, batch, cfg: ModelConfig, *, mode: str = "train",
            cache=None, cache_len=None, ctx: ShardCtx = LOCAL,
            remat: bool = True, remat_policy: str | None = None):
    """Returns dict(logits, aux, cache); the cache is updated in place.

    ``remat`` checkpoints each repeat of a layer group (the JAX
    package's ``jax.checkpoint`` around its scan body) when autograd
    records; it changes no value.

    Raises:
      ValueError: on an unknown ``mode``, ``mode="decode"`` without a
        cache and ``cache_len``, or an enabled ``ctx`` without a mesh.
      NotImplementedError: on a ``remat_policy`` with no counterpart.
      RuntimeError: on CUDA tensors while TF32 is allowed.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; known: {MODES}")
    if mode == "decode" and (cache is None or cache_len is None):
        raise ValueError("mode='decode' needs a cache and cache_len")
    if ctx.enabled:
        if ctx.mesh is None:
            raise ValueError(
                "ShardCtx(enabled=True) needs its DeviceMesh: build it with "
                "repro_torch.parallel.sharding.make_shard_ctx(mesh)")
        with implicit_replication():
            return _forward(params, batch, cfg, mode, cache, cache_len, ctx,
                            remat, remat_policy)
    return _forward(params, batch, cfg, mode, cache, cache_len, ctx, remat,
                    remat_policy)


def _forward(params, batch, cfg: ModelConfig, mode, cache, cache_len,
             ctx: ShardCtx, remat, remat_policy):
    if ctx.enabled:
        x = _constrain_acts(_embed_sharded(params, batch, cfg, ctx), cfg,
                            ctx)
    else:
        x = _embed(params, batch, cfg)
    blocks.check_matmul_precision(x)
    _, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None, :]
    if mode == "decode":
        positions = positions + cache_len

    aux_total: dict = {}
    new_cache_groups = [] if cache is not None else None
    for gi, (start, length) in enumerate(cfg.scan_groups()):
        g = cfg.scan_group
        n_rep = length // g
        body_params = [_unstack(bp, n_rep) for bp in params["groups"][gi]]
        group_aux: dict = {}
        for r in range(n_rep):
            def group_body(x_, r=r, start=start, gi=gi,
                           body_params=body_params):
                """One repeat of the group: its g layers in order.  Bound
                to this group's parameters: remat runs it again in the
                backward pass, after the loop has moved on."""
                rep_aux: dict = {}
                for pos in range(g):
                    c = (_layer_view(cache[gi][pos], r) if cache is not None
                         else None)
                    x_, aux = _apply_layer(
                        body_params[pos][r], x_, cfg, start + pos, mode=mode,
                        cache=c, cache_len=cache_len, positions=positions,
                        ctx=ctx)
                    for k_, v_ in aux.items():
                        rep_aux[k_] = rep_aux.get(k_, 0.0) + v_
                if ctx.enabled:
                    x_ = _constrain_acts(x_, cfg, ctx)
                return x_, rep_aux

            if ctx.enabled:      # remat runs it again, outside forward
                group_body = _replicating(group_body)
            x, rep_aux = _remat_wrap(group_body, remat, remat_policy)(x)
            for k_, v_ in rep_aux.items():
                group_aux[k_] = group_aux.get(k_, 0.0) + v_
        if cache is not None:
            new_cache_groups.append(cache[gi])
        for k_, v_ in group_aux.items():
            aux_total[k_] = aux_total.get(k_, 0.0) + v_

    logits = _head(params, x, cfg, ctx)
    return {"logits": logits, "aux": aux_total, "cache": new_cache_groups}
