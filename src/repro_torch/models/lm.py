"""The language model of the PyTorch port: DeepSeek-V2's MLA + MoE stack.

Port of `repro.models.lm` for the families whose blocks are ported (MLA
attention with dense MLP or event-routed MoE feed-forwards).  Structure:
embed -> layer groups -> final norm -> lm head.  The parameter tree is
the JAX package's: layers are stacked over the repeats of each
homogeneous group of `ModelConfig.scan_groups` (``[(0, 1), (1, 26)]`` for
DeepSeek-V2-Lite), and the port walks the stack with a Python loop over
views where the JAX package scans.  KV caches mirror the same stacking
and are updated in place.

Entry points, on torch tensors:

    params = init_model(torch.Generator("cuda").manual_seed(0), cfg)
    out = forward(params, {"tokens": tokens}, cfg, mode="train")

Tensors go to the CUDA device unless the caller passes ``device="cpu"``
(`init_model`, `lm_params_from_numpy`, `init_cache`); `forward` runs
where its operands lie.  Parameter values differ from the JAX package's
for the same seed; `lm_params_from_numpy` carries the JAX tree across.

Modes:
  train   - causal, no cache, logits
  prefill - causal forward that also fills the decode cache
  decode  - tokens against the cache at ``cache_len`` (a Python int)

Not ported, each raising `NotImplementedError` that names its ROADMAP
item: Mamba, RWKV, GQA attention, modality frontends, sharding (all
item 12), and activation checkpointing (``remat``, a training option of
the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.interface.session import resolve_device
from repro_torch.models import blocks
from repro_torch.models.blocks import ITEM_12, LOCAL, Draw, ShardCtx
from repro_torch.models.config import ModelConfig

Params = dict

MODES = ("train", "prefill", "decode")


def _refuse(what: str, cfg: ModelConfig):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch ({ITEM_12}); use the JAX "
        f"package `repro` for {cfg.name}")


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.frontend.kind != "none":
        _refuse(f"the {cfg.frontend.kind} frontend", cfg)
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind != "attn":
            _refuse(f"the {kind} mixer", cfg)
    if cfg.mla is None:
        _refuse("GQA attention", cfg)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(draw: Draw, cfg: ModelConfig, idx: int) -> Params:
    p: Params = {"ln1": blocks.init_rmsnorm(draw, cfg.d_model, cfg),
                 "mix": blocks.init_mla(draw, cfg),
                 "ln2": blocks.init_rmsnorm(draw, cfg.d_model, cfg)}
    if cfg.layer_is_moe(idx):
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
    for the full model: DeepSeek-V2-Lite is 62.8 GB in float32.

    With ``generator=None`` and ``device="meta"`` it only shapes the tree.
    """
    _check_ported(cfg)
    device = resolve_device(device)
    pdt = blocks.dtype_of(cfg.param_dtype)
    draw = Draw(generator, pdt)
    p: Params = {"embed": draw.normal((cfg.vocab, cfg.d_model), 0.02)}
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
    each leaf of the shape `init_model` gives.

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
        # through float32: exact for float32 and bfloat16 leaves
        return torch.from_numpy(arr.astype(np.float32)).to(device, w.dtype)

    return convert(want, params, "")


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Stacked cache tree matching the layer groups: per group, per body
    position, ``{"ckv": (n_rep, B, S, kv_lora), "kr": (n_rep, B, S,
    rope_dim)}`` zeros in the compute type, on ``device`` (the CUDA
    device when None)."""
    _check_ported(cfg)
    device = resolve_device(device)
    cdt = blocks.dtype_of(cfg.compute_dtype)
    m = cfg.mla
    groups = []
    for _, length in cfg.scan_groups():
        n_rep = length // cfg.scan_group
        groups.append([
            {"ckv": torch.zeros((n_rep, batch, max_len, m.kv_lora), dtype=cdt,
                                device=device),
             "kr": torch.zeros((n_rep, batch, max_len, m.qk_rope_dim),
                               dtype=cdt, device=device)}
            for _ in range(cfg.scan_group)])
    return groups


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _apply_layer(lp, x, cfg: ModelConfig, idx: int, *, cache, cache_len,
                 positions, ctx: ShardCtx):
    aux = {}
    h = blocks.rms_norm(x, lp["ln1"], cfg.norm_eps)
    o, new_cache = blocks.mla_apply(lp["mix"], h, cfg, positions=positions,
                                    cache=cache, cache_len=cache_len, ctx=ctx)
    if cfg.post_norms:
        o = blocks.rms_norm(o, lp["post_ln1"], cfg.norm_eps)
    x = x + o
    h = blocks.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.layer_is_moe(idx):
        o, aux = blocks.moe_apply(lp["ffn"], h, cfg, ctx=ctx)
    else:
        o = blocks.mlp_apply(lp["ffn"], h, cfg)
    if cfg.post_norms:
        o = blocks.rms_norm(o, lp["post_ln2"], cfg.norm_eps)
    x = x + o
    return x, new_cache, aux


def _embed(params, batch, cfg: ModelConfig):
    cdt = blocks.dtype_of(cfg.compute_dtype)
    tok = params["embed"][batch["tokens"].long()].to(cdt)
    if cfg.family != "rwkv":
        scale = torch.sqrt(torch.tensor(float(cfg.d_model),
                                        dtype=torch.float32)).to(cdt)
        return tok * scale
    return tok


def _head(params, x, cfg: ModelConfig):
    """Final norm and the lm head: (B, T, d) -> (B, T, vocab) logits."""
    x = blocks.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(x.dtype)
    return x @ head


def _layer_view(tree, r: int):
    """Repeat ``r`` of a stacked layer tree, as views."""
    return _tree_map(lambda a: a[r], tree)


def forward(params, batch, cfg: ModelConfig, *, mode: str = "train",
            cache=None, cache_len=None, ctx: ShardCtx = LOCAL):
    """Returns dict(logits, aux, cache); the cache is updated in place.

    Raises:
      ValueError: on an unknown ``mode``, or ``mode="decode"`` without a
        cache and ``cache_len``.
      NotImplementedError: on what the port does not run (module doc).
      RuntimeError: on CUDA tensors while TF32 is allowed.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; known: {MODES}")
    if mode == "decode" and (cache is None or cache_len is None):
        raise ValueError("mode='decode' needs a cache and cache_len")
    _check_ported(cfg)
    blocks.refuse_sharded(ctx)
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
        body_params = params["groups"][gi]
        group_aux: dict = {}
        for r in range(length // g):
            for pos in range(g):
                c = (_layer_view(cache[gi][pos], r) if cache is not None
                     else None)
                x, _, aux = _apply_layer(
                    _layer_view(body_params[pos], r), x, cfg, start + pos,
                    cache=c, cache_len=cache_len, positions=positions,
                    ctx=ctx)
                for k_, v_ in aux.items():
                    group_aux[k_] = group_aux.get(k_, 0.0) + v_
        if cache is not None:
            new_cache_groups.append(cache[gi])
        for k_, v_ in group_aux.items():
            aux_total[k_] = aux_total.get(k_, 0.0) + v_

    logits = _head(params, x, cfg)
    return {"logits": logits, "aux": aux_total, "cache": new_cache_groups}
