"""Logical-axis sharding rules: parameter/batch/cache partition specs per
arch, and their DTensor placements.

Port of `repro.parallel.sharding`.  A spec is a plain tuple with one
entry per tensor dim, as a `jax.sharding.PartitionSpec` holds them:
None (replicated), an axis name, or a tuple of axis names (one dim split
over several axes, major to minor).  `to_placements` turns a spec into
the DTensor placements of one `DeviceMesh`, and `shard_tree` places a
full tree by them, each rank keeping only its slice.

Mesh contract (`repro_torch.launch.mesh`):
  single-pod  (data=16, model=16)            - 256 chips
  multi-pod   (pod=2, data=16, model=16)     - 512 chips; `pod` is pure DP

Parameter placement = TP over `model` + FSDP over `data`; AdamW's
moments take their parameters' placements, so ZeRO falls out of the
specs.  Per-family rules:

  dense/moe/hybrid attention   column-TP wq/wk/wv, row-TP wo over `model`
  attn_shard == "sequence"     weights replicated over `model`; activations
                               sequence-sharded (llama3.2: 24 heads % 16)
  MoE experts                  EP: leading expert dim over `model`
  mamba                        d_inner over `model`
  rwkv time-mix                weights replicated over `model` (40
                               heads), FSDP over `data`; at
                               rwkv_pad_heads a serve step may run it on
                               each rank's heads (`rwkv6.own_heads`:
                               their column blocks gathered, `wo`
                               row-parallel); channel-mix FFN + vocab TP
  embed / lm_head              vocab over `model`, d_model over `data`

Caches: KV/latent caches are sequence-sharded over `model`; SSM states
shard d_inner, RWKV states replicate their heads, but split them over
`model` where the WKV runs on a head split (``rwkv_pad_heads``; the
JAX package replicates them there too, and GSPMD returns them split).
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.blocks import ShardCtx
from repro_torch.models.config import ModelConfig


def make_shard_ctx(mesh, cfg: ModelConfig | None = None) -> ShardCtx:
    """The `ShardCtx` of a `DeviceMesh` (its mesh rides along for the
    ``local_map`` regions) or of a `MeshSpec` (specs only)."""
    sizes = axis_sizes(mesh)
    data_axes = ("pod", "data") if "pod" in sizes else ("data",)
    return ShardCtx(data_axes=data_axes, model_axis="model",
                    model_size=sizes["model"], enabled=True,
                    axis_sizes=tuple(sizes.items()),
                    mesh=None if hasattr(mesh, "sizes") else mesh)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def sanitize_spec(spec: tuple, shape, ctx: ShardCtx) -> tuple:
    """Drop axis assignments whose size doesn't divide the dimension.

    Keeps the rules table simple: hubert's 504-entry unit vocabulary, tiny
    smoke dims, etc. silently fall back to replication per-dimension."""
    sizes = dict(ctx.axis_sizes)
    new = []
    for d, ax in enumerate(spec):
        prod = 1
        for a in _axes(ax):
            prod *= sizes.get(a, 1)
        new.append(ax if ax is not None and shape[d] % prod == 0 else None)
    return tuple(new)


def param_spec(path_s: str, ndim: int, cfg: ModelConfig, dp) -> tuple:
    """Spec of one parameter (without the layer-stack dim)."""
    seq = cfg.attn_shard == "sequence"
    name = path_s.rsplit("/", 1)[-1]
    in_mix = "/mix/" in path_s or path_s.endswith("mix")
    in_ffn = "/ffn/" in path_s
    rwkv_tm = cfg.family == "rwkv" and in_mix
    rwkv_cm = cfg.family == "rwkv" and in_ffn

    # ---- top-level ---------------------------------------------------------
    if name == "embed":
        return ("model", dp)
    if name == "lm_head":
        return (dp, "model")
    if name in ("frontend_proj", "mask_embed"):
        return (dp, None) if ndim == 2 else (None,)

    # ---- rwkv --------------------------------------------------------------
    if rwkv_tm:
        if ndim == 2 and name in ("wr", "wk", "wv", "wg", "wo"):
            return (dp, None)
        if name in ("maa_w1", "decay_w1"):
            return (dp, None)
        if name == "maa_w2":
            return (None, None, None)
        if name == "decay_w2":
            return (None, dp)
        return (None,) * ndim
    if rwkv_cm:
        if name == "wk":
            return (dp, "model")
        if name == "wv":
            return ("model", dp)
        if name == "wr":
            return (dp, None)
        return (None,) * ndim

    # ---- mamba -------------------------------------------------------------
    if name == "w_in":
        return (dp, "model")
    if name == "conv_w":
        return (None, "model")
    if name in ("conv_b", "dt_bias", "d_skip"):
        return ("model",)
    if name in ("w_bc", "w_dt_a"):
        return ("model", None)
    if name == "w_dt_b":
        return (None, "model")
    if name == "a_log":
        return ("model", None)
    if name == "w_out":
        return ("model", dp)

    # ---- MoE (3D expert weights; 2D shared/dense fall through to MLP) ------
    if name == "router":
        return (dp, None)
    if name.endswith("_scale"):
        return ("model", None, None)
    if ndim == 3 and name in ("w_gate", "w_up"):
        return ("model", dp, None)
    if ndim == 3 and name == "w_down":
        return ("model", None, dp)

    # ---- MLP ----------------------------------------------------------------
    if name in ("w_gate", "w_up"):
        return (dp, None) if seq else (dp, "model")
    if name == "w_down":
        return (None, dp) if seq else ("model", dp)

    # ---- attention / MLA ----------------------------------------------------
    if name in ("wq", "wk", "wv", "wq_b", "wk_b", "wv_b"):
        return (dp, None) if seq else (dp, "model")
    if name in ("wq_a", "wkv_a"):
        return (dp, None)
    if name == "wo":
        return (None, dp) if seq else ("model", dp)

    # ---- norms & everything small ------------------------------------------
    return (None,) * ndim


def map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists (a tuple is a
    leaf: a spec); the path joins dict keys and list indices with "/" as
    the JAX package's ``_path_str`` does (``groups/1/0/mix/wq``)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def params_pspecs(params, cfg: ModelConfig, ctx: ShardCtx):
    """Tree of specs matching ``params`` (layer-stacked aware)."""
    dp = ctx.batch_spec

    def one(s, leaf):
        stacked = s.startswith("groups/")
        ndim = leaf.ndim - (1 if stacked else 0)
        spec = param_spec(s, ndim, cfg, dp)
        if cfg.serve_tp_only:
            # serving: drop the FSDP (data) dimension from weight specs so
            # no per-step weight all-gathers are needed
            spec = tuple(None if a == dp else a for a in spec)
        if stacked:
            spec = (None,) + spec
        return sanitize_spec(spec, leaf.shape, ctx)

    return map_with_path(one, params)


def batch_pspecs(batch_shapes: dict, cfg: ModelConfig, ctx: ShardCtx):
    """Input batch specs (tokens/labels/frames/...): the batch dim over
    the data axes."""
    dp = ctx.batch_spec
    return {k: (dp,) + (None,) * ((v.ndim if hasattr(v, "ndim") else len(v))
                                  - 1)
            for k, v in batch_shapes.items()}


def cache_pspecs(cache, cfg: ModelConfig, ctx: ShardCtx):
    """Decode-cache specs: sequence-sharded KV, sharded SSM state.  The
    WKV state's heads split over ``model`` where the WKV runs on a head
    split (`repro_torch.models.rwkv6.head_split`), in DTensor's blocks
    of heads whether or not the model size divides H (`block`), so that
    each rank reads and writes its own heads (the JAX package's spec
    keeps them whole, and its decode step leaves the state's placement
    to XLA)."""
    from repro_torch.models.rwkv6 import head_split
    dp = ctx.batch_spec

    def one(s, leaf):
        name = s.rsplit("/", 1)[-1]
        if name == "wkv" and head_split(cfg, ctx):
            spec = sanitize_spec((None, dp, None, None, None), leaf.shape,
                                 ctx)
            return spec[:2] + ("model",) + spec[3:]
        # leading dim is the layer stack
        if name in ("k", "v"):          # (L, B, S, KH, D) -> shard S
            spec = (None, dp, "model", None, None)
        elif name in ("ckv", "kr"):     # (L, B, S, d) -> shard S
            spec = (None, dp, "model", None)
        elif name == "ssm":             # (L, B, di, N) -> shard di
            spec = (None, dp, "model", None)
        elif name == "conv":            # (L, B, K-1, di) -> shard di
            spec = (None, dp, None, "model")
        elif name == "wkv":             # (L, B, H, D, D) - replicate heads
            spec = (None, dp, None, None, None)
        else:
            spec = (None, dp) + (None,) * (leaf.ndim - 2)
        return sanitize_spec(spec, leaf.shape, ctx)

    return map_with_path(one, cache)


def leading_axis_specs(tree, axis: str):
    """Spec tree sharding every leaf's leading dim over ``axis``.

    The shard-by-leading-dim rule of the interface session's chip
    sharding (`InterfaceSession.run(shard="chips")`): every per-chip
    operand is stacked ``(chips, ...)`` and split across the 1D chip
    mesh."""
    return map_with_path(lambda _, leaf: (axis,), tree)


def to_placements(spec: tuple, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    `Shard(d)` on each mesh dim that names an axis of tensor dim d,
    `Replicate` elsewhere.  Several axes on one dim split it major to
    minor in mesh order, as JAX splits ``("pod", "data")``.

    Raises:
      ValueError: on an axis the mesh lacks, an axis used twice, or
        several axes on one dim out of mesh order.
    """
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"axis {a!r} of spec {spec} is not on the "
                                 f"mesh {tuple(names)}")
            i = names.index(a)
            if placements[i] != Replicate():
                raise ValueError(f"axis {a!r} used twice in spec {spec}")
            placements[i] = Shard(d)
            idx.append(i)
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of spec {spec} are not in mesh "
                             f"order {tuple(names)}")
    return placements


def block(n: int, parts: int, index: int) -> tuple:
    """(start, length) of block ``index`` of ``parts`` of a dim of ``n``,
    as DTensor splits it: ceil(n / parts) long, the last ones shorter or
    empty where ``parts`` does not divide ``n``."""
    size = -(-n // parts)
    start = min(index * size, n)
    return start, min(size, n - start)


def local_slice(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a view; `block`)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    out = full
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        parts, idx = 1, 0
        for a in axes:                       # major to minor
            idx = idx * sizes[a] + coord[a]
            parts *= sizes[a]
        out = out.narrow(d, *block(full.shape[d], parts, idx))
    return out


def place(full: torch.Tensor, spec: tuple, mesh):
    """``full`` as a DTensor under ``spec``, built from this rank's slice
    alone: no collective, and the rank keeps only its block."""
    from torch.distributed.tensor import DTensor
    local = local_slice(full, spec, mesh).contiguous().clone()
    return DTensor.from_local(local, mesh, to_placements(spec, mesh),
                              run_check=False, shape=full.shape,
                              stride=full.contiguous().stride())


def shard_tree(tree, specs, mesh):
    """Distribute a full tree (the same values on every rank) by its spec
    tree: each leaf becomes a DTensor holding this rank's slice."""
    flat_specs = {}
    map_with_path(lambda p, s: flat_specs.__setitem__(p, s), specs)
    return map_with_path(lambda p, leaf: place(leaf, flat_specs[p], mesh),
                         tree)
