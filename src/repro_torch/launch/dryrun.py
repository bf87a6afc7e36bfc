"""Shape, memory and per-device cost dry run of every (arch x shape x
mesh) cell, on one host, with no allocation.

Port of `repro.launch.dryrun`.  Per cell it:
  1. takes the production mesh's axes (16x16 or 2x16x16, or a variant's
     override) as a `MeshSpec`;
  2. shapes the parameters with ``init_model(None, cfg)`` on the meta
     device, and the batch, the AdamW moments (with the arch's
     ``train_overrides``) and the decode caches likewise;
  3. places them by the port's specs (`repro_torch.parallel.sharding`)
     and records each one's per-device bytes and whether their sum fits
     one 80 GB card;
  4. counts the global FLOPs of the cell's step (train: forward and
     backward, with the variant's microbatching and remat; prefill and
     decode: one forward) with `torch.utils.flop_counter.FlopCounterMode`
     over meta tensors (``flops``);
  5. runs the step again as rank 0 of a ``fake`` process group of the
     mesh's world size (`repro_torch.launch.mesh.fake_mesh`: 256 ranks,
     512 for 2x16x16), its operands DTensors placed by the same specs
     whose local shards are meta tensors, and records what that rank
     does, under the JAX record's names (`per_device_costs`):
     - ``cost.flops``: the FLOPs of every local op the rank runs
       (`CostMode`).  A DTensor op is handed to DTensor, which runs it as
       local ops on the shards after any redistribution; those are
       counted.  For a product that is its global count times the local
       over the global output's elements, divided by the size of each
       mesh dim on which the output is `Partial`; work DTensor
       replicates is charged to every rank, as GSPMD charges it.
       DTensor's shape propagation (ops on fake tensors of the global
       shapes) runs out of sight of the counting: it is not the rank's
       work.
     - ``cost["bytes accessed"]``: the bytes of every local op's tensor
       inputs and outputs, views and bare allocations left out.  That is
       XLA's per-op figure with no fusion, so it lies at or above what
       XLA's cost analysis reports for the fused program.
     - ``collectives``: the bytes of each ``_c10d_functional`` collective
       by op (coalesced ones tensor by tensor) in
       `repro.launch.dryrun.collective_bytes`'s convention: all-gather
       its gathered result, all-reduce, all-to-all and
       collective-permute (the port's
       ``repro_torch::collective_permute``) their operand,
       reduce-scatter its operand (the result times the group size);
       ``total`` their sum.  ``collective_counts``: the calls by op.
     - ``memory.peak_bytes``: the rank's peak from
       `torch.distributed._tools.mem_tracker.MemTracker` over the step,
       the placed operands included; ``memory.temp_bytes`` the peak less
       those operands.  This is eager allocation op by op, not XLA's
       buffer assignment: a tensor lives until its last Python reference
       goes, and nothing is fused away.  A collective's result wrapped
       for autograd is held once, as on a real rank (the wrapper is an
       alias; its meta kernel would copy).
     The pass runs at two and three repeats of the layer pattern
     (``first_k_dense + k * scan_group`` layers) and each field is
     extrapolated affinely to the real depth (`calibrated_costs`, the
     counterpart of the JAX dry run's): the record's ``cost``,
     ``collectives``, ``collective_counts`` and ``memory`` fields are
     that extrapolation, and ``cost_calibrated`` holds it under the JAX
     record's name with each pass's seconds.  JAX lowers one and two
     repeats; the port's step is affine in the repeats only from two on:
     a MoE model's running aux-loss sum becomes a DTensor sum that
     DTensor reduces once, at the first repeat that adds to it, so one
     repeat lacks a few scalar all-reduces every deeper model makes.
     The port's layer loops are Python loops, so a pass at the real
     depth would count the same (`tests/test_torch_dryrun_calibration.py`
     holds that); three layers are walked instead of up to 94.  The peak
     is an estimate: eager peak is a maximum over the step, affine in
     depth only once the same moment sets it.
     A cell whose step reaches an op with no meta kernel (a
     data-dependent shape, a host copy) records ``status: "error"`` and
     the reason, its bytes kept.

Attention.  The global count (4.) computes attention in one (q, kv)
chunk (`_one_attention_chunk`): the port computes every chunk pair of
its chunked attention (the causal mask hides work, it does not skip
it), so where the sequence fills whole 1024-token chunks the FLOPs are
the same, and a 32k-token prefill walks one pair a layer instead of
1,024.  Where it does not (phi-3-vision's 576-token image prefix), the
port pads the last chunk and computes more than one chunk does.  The
per-device pass (5.) runs the port's own chunks, so its FLOPs, bytes
and peak are the program's: one chunk would read Q, K and V once and
hold a layer's whole score matrix, which the chunked program never
allocates.

``compat.py`` (JAX-version shims) and ``models/calibrate.py`` (it
unrolls ``lax.scan`` so that XLA's cost analysis visits every iteration)
have no counterpart: the port's layer and chunk loops are Python loops.

Output: one JSON a cell under ``build/dryrun_torch/`` (``--out``).

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes [--skip-done]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as shd

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "../../../build/dryrun_torch")
HBM_BYTES = 80 * 10**9


def _v_serve_tp32(cfg):
    moe = dataclasses.replace(cfg.moe, quant_int8=True) if cfg.moe else None
    return dataclasses.replace(cfg, serve_tp_only=True, moe=moe)


def _v_serve_tp32_bf16(cfg):
    return dataclasses.replace(cfg, serve_tp_only=True)


def _v_rwkv48(cfg):
    return dataclasses.replace(cfg, rwkv_pad_heads=48)


def _v_rwkv48_c64(cfg):
    return dataclasses.replace(cfg, rwkv_pad_heads=48,
                               rwkv=dataclasses.replace(cfg.rwkv, chunk=64))


VARIANTS = {
    "baseline": {},
    "serve_tp32": {"cfg_fn": _v_serve_tp32, "mesh_shape": (8, 32)},
    "serve_tp32_bf16": {"cfg_fn": _v_serve_tp32_bf16, "mesh_shape": (8, 32)},
    "mb8": {"train_kwargs": {"microbatch": 8}},
    "remat_dots": {"train_kwargs": {"remat_policy": "dots"}},
    "mb8_dots": {"train_kwargs": {"microbatch": 8, "remat_policy": "dots"}},
    "rwkv48": {"cfg_fn": _v_rwkv48},
    "rwkv48_c64": {"cfg_fn": _v_rwkv48_c64},
}

META = torch.device("meta")


def _batch_shapes(cfg: ModelConfig, shape: configs.Shape) -> dict:
    """Meta tensors of the cell's batch."""
    b, s = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    if shape.kind == "decode":
        return {"tokens": torch.empty((b, 1), dtype=i32, device=META)}
    if cfg.frontend.kind == "audio":
        d = {"frames": torch.empty((b, s, cfg.frontend.d_in), dtype=f32,
                                   device=META),
             "mask": torch.empty((b, s), dtype=torch.bool, device=META)}
    else:
        d = {"tokens": torch.empty((b, s), dtype=i32, device=META)}
        if cfg.frontend.kind == "vision":
            d["image_embeds"] = torch.empty(
                (b, cfg.frontend.max_prefix, cfg.frontend.d_in), dtype=f32,
                device=META)
    if shape.kind == "train":
        d["labels"] = torch.empty((b, s), dtype=i32, device=META)
    return d


def _cache_len(cfg: ModelConfig, shape: configs.Shape) -> int:
    extra = cfg.frontend.max_prefix if cfg.frontend.kind == "vision" else 0
    return shape.seq_len + extra


def _flat(tree) -> list:
    out = []
    shd.map_with_path(lambda p, leaf: out.append((p, leaf)), tree)
    return out


def per_device_bytes(tree, specs, sizes: dict, itemsize=None) -> int:
    """Bytes the first device holds of ``tree`` placed by ``specs``: each
    leaf's bytes over the product of the axes that split it, a dim that
    they do not divide taking its first block (`sharding.block`)."""
    spec_of = dict(_flat(specs))
    total = 0
    for path, leaf in _flat(tree):
        numel = 1
        for d, n in enumerate(leaf.shape):
            parts = 1
            if d < len(spec_of[path]):
                for a in shd._axes(spec_of[path][d]):
                    parts *= sizes[a]
            numel *= shd.block(n, parts, 0)[1]
        size = itemsize if itemsize is not None else leaf.element_size()
        total += numel * size
    return total


class _one_attention_chunk:
    """Context: exact attention in one (q, kv) chunk.  The port computes
    every chunk pair of its chunked attention (the causal mask hides
    work, it does not skip it), so the count is the same where the
    sequence fills whole chunks (not its padding of a last partial one),
    and a 32k-token prefill walks one pair a layer instead of 1,024."""

    def __enter__(self):
        from repro_torch.models import blocks
        self._saved = blocks.DEFAULT_Q_CHUNK, blocks.DEFAULT_KV_CHUNK
        blocks.DEFAULT_Q_CHUNK = blocks.DEFAULT_KV_CHUNK = 1 << 40
        return self

    def __exit__(self, *exc):
        from repro_torch.models import blocks
        blocks.DEFAULT_Q_CHUNK, blocks.DEFAULT_KV_CHUNK = self._saved
        return False


def count_flops(cfg: ModelConfig, shape: configs.Shape, train_kwargs: dict,
                opt_overrides: dict) -> float:
    """Global FLOPs of the cell's step (`cell_step`, no mesh) on meta
    tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models.blocks import LOCAL
    cache = None
    if shape.kind != "train":
        cache = lm.init_cache(cfg, shape.global_batch, _cache_len(cfg, shape),
                              device="meta")
    step, _ = cell_step(cfg, shape.kind, LOCAL,
                        lm.init_model(None, cfg, device="meta"),
                        _batch_shapes(cfg, shape), cache,
                        train_kwargs=train_kwargs,
                        opt_overrides=opt_overrides,
                        decode_len=shape.seq_len - 1)
    counter = FlopCounterMode(display=False)
    with counter, _one_attention_chunk():
        step()
    return float(counter.get_total_flops())


def _operands(cfg: ModelConfig, shape: configs.Shape, ctx,
              cache_len: int | None = None):
    """Meta trees of the cell's step and their specs: (params, p_specs,
    batch, b_specs, cache, c_specs); no cache for a train step."""
    sizes = dict(ctx.axis_sizes)
    dp_total = sizes.get("data", 1) * sizes.get("pod", 1)
    params = lm.init_model(None, cfg, device="meta")
    p_specs = shd.params_pspecs(params, cfg, ctx)
    batch = _batch_shapes(cfg, shape)
    bspec = ctx.batch_spec if shape.global_batch >= dp_total else None
    b_specs = {k: shd.sanitize_spec((bspec,) + (None,) * (v.ndim - 1),
                                    v.shape, ctx) for k, v in batch.items()}
    cache = c_specs = None
    if shape.kind != "train":
        cache = lm.init_cache(cfg, shape.global_batch,
                              cache_len or _cache_len(cfg, shape),
                              device="meta")
        c_specs = shd.cache_pspecs(cache, cfg, ctx)
        if bspec is None:      # batch too small for DP: replicate batch dims
            c_specs = shd.map_with_path(lambda _, s: (None, None) + s[2:],
                                        c_specs)
    return params, p_specs, batch, b_specs, cache, c_specs


def cell_step(cfg: ModelConfig, kind: str, ctx, params, batch, cache=None,
              *, train_kwargs: dict | None = None,
              opt_overrides: dict | None = None, decode_len: int = 0):
    """``(step, operands)``: a thunk running the cell's step once on the
    placed trees (train: `make_train_step` from fresh AdamW moments;
    prefill: `make_prefill_step`; decode: `make_decode_step` at cache
    length ``decode_len``), and the list of every tensor it takes,
    the moments included, built here, outside any counting window."""
    from repro_torch.ckpt.manager import tree_leaves
    from repro_torch.serve.lm_engine import make_decode_step, make_prefill_step
    operands = tree_leaves(params) + tree_leaves(batch)
    if kind == "train":
        from repro_torch.optim import adamw
        from repro_torch.train import step as ts
        opt_cfg = adamw.AdamWConfig(**(opt_overrides or {}))
        device = operands[0].device
        state = ts.TrainState(params=params, opt=adamw.init(opt_cfg, params),
                              step=torch.zeros((), dtype=torch.int32,
                                               device=device))
        fn = ts.make_train_step(cfg, opt_cfg, ctx=ctx, **(train_kwargs or {}))
        operands += tree_leaves(state.opt.mu) + tree_leaves(state.opt.nu)
        return lambda: fn(state, batch), operands
    operands += tree_leaves(cache)
    if kind == "prefill":
        fn = make_prefill_step(cfg, ctx)

        def step():
            with torch.no_grad():
                return fn(params, batch, cache)
        return step, operands
    fn = make_decode_step(cfg, ctx)

    def step():
        with torch.no_grad():
            return fn(params, cache, batch["tokens"], decode_len)
    return step, operands


# the JAX record's names of the functional collectives
COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
    # repro_torch::collective_permute (`parallel.regions.permute_op`)
    "collective_permute": "collective-permute",
}
COLLECTIVE_NAMESPACES = ("_c10d_functional", "repro_torch")
# allocations: they move no bytes (MemTracker sees their storage)
_ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty",
           "new_empty_strided"}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _cost_mode():
    """`CostMode`, a dispatch mode made on first use (torch's dispatch
    mode base class is imported inside, as every private API here)."""
    from torch.distributed._functional_collectives import AsyncCollectiveTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry
    wrappers = (DTensor, AsyncCollectiveTensor)
    # a collective's result wrapped for autograd is its input (an alias);
    # the op's meta kernel allocates a copy, which no real rank holds
    wrap = getattr(torch.ops._c10d_functional, "_wrap_tensor_autograd",
                   None)

    class CostMode(TorchDispatchMode):
        """Counts the local ops of one rank: FLOPs (torch's flop
        registry), bytes of each op's tensor inputs and outputs (views
        and allocations left out), and each functional collective's
        bytes and calls (`COLLECTIVE_OPS`).  A DTensor op is handed back
        (NotImplemented): DTensor runs it as local ops, which come back
        here."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.coll_bytes: dict = {}
            self.coll_counts: dict = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, wrappers) for t in types):
                return NotImplemented
            if wrap is not None and func._overloadpacket is wrap:
                return args[0]
            out = func(*args, **kwargs)
            ins, outs = _tensors((args, kwargs)), _tensors(out)
            name = func._schema.name.split("::")[-1]
            if func.namespace in COLLECTIVE_NAMESPACES:
                op = COLLECTIVE_OPS.get(name)
                if op is not None:
                    moved = (_nbytes(outs) if op == "all-gather"
                             else _nbytes(_tensors(args[0])))
                    self.coll_bytes[op] = self.coll_bytes.get(op, 0) + moved
                    n = len(_tensors(args[0]))
                    self.coll_counts[op] = self.coll_counts.get(op, 0) + n
                    self.bytes += _nbytes(ins) + _nbytes(outs)
                return out
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += int(flop_registry[packet](*args, **kwargs,
                                                        out_val=out))
            if not func.is_view and name not in _ALLOCS:
                self.bytes += _nbytes(ins) + _nbytes(outs)
            return out

    return CostMode()


@contextlib.contextmanager
def _propagation_unseen():
    """DTensor's shape propagation (an op on fake tensors of the global
    shapes, to learn the result's shape) run with the dispatch modes
    off: it is not the rank's work, and `MemTracker` of older torch
    counts its fake tensors' storage."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    inner = ShardingPropagator._propagate_tensor_meta_non_cached

    def unseen(self, op_schema):
        with _disable_current_modes():
            return inner(self, op_schema)
    ShardingPropagator._propagate_tensor_meta_non_cached = unseen
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = inner


def _tracker_total(tracker, kind: str) -> int:
    return sum(snap.get("Total", 0)
               for snap in tracker.get_tracker_snapshot(kind).values())


def measure(step, operands) -> dict:
    """Run ``step()`` once and record what this rank did (`CostMode`
    under `MemTracker`, which tracks ``operands``, the step's placed
    tensors, from the start): ``cost`` (``flops``, ``bytes accessed``),
    ``collectives`` (bytes by op and ``total``), ``collective_counts``
    (calls by op and ``total``) and ``memory`` (``peak_bytes``,
    ``temp_bytes`` = peak less ``placed_bytes``)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    mode, tracker = _cost_mode(), MemTracker()
    tracker.track_external(*operands)
    placed = _tracker_total(tracker, "current")
    with _propagation_unseen(), tracker, mode:
        step()
    peak = _tracker_total(tracker, "peak")
    coll = dict(sorted(mode.coll_bytes.items()))
    coll["total"] = sum(mode.coll_bytes.values())
    counts = dict(sorted(mode.coll_counts.items()))
    counts["total"] = sum(mode.coll_counts.values())
    return {"cost": {"flops": mode.flops, "bytes accessed": mode.bytes},
            "collectives": coll, "collective_counts": counts,
            "memory": {"peak_bytes": peak, "temp_bytes": peak - placed,
                       "placed_bytes": placed}}


def per_device_costs(cfg: ModelConfig, shape: configs.Shape, mesh_spec, *,
                     train_kwargs: dict | None = None,
                     opt_overrides: dict | None = None, rank: int = 0,
                     cache_len: int | None = None) -> dict:
    """`measure` of the cell's step as rank ``rank`` of a fake process
    group on ``mesh_spec`` (`repro_torch.launch.mesh.fake_mesh`), its
    operands DTensors placed by the port's specs with meta local shards
    (placed before counting starts; nothing is allocated).
    ``cache_len`` overrides the prefill or decode cache's length."""
    from repro_torch.launch.mesh import fake_mesh
    with fake_mesh(mesh_spec, rank) as mesh:
        ctx = shd.make_shard_ctx(mesh, cfg)
        params, p_specs, batch, b_specs, cache, c_specs = _operands(
            cfg, shape, ctx, cache_len)
        params = shd.shard_tree(params, p_specs, mesh)
        batch = shd.shard_tree(batch, b_specs, mesh)
        if cache is not None:
            cache = shd.shard_tree(cache, c_specs, mesh)
        step, operands = cell_step(cfg, shape.kind, ctx, params, batch, cache,
                                   train_kwargs=train_kwargs,
                                   opt_overrides=opt_overrides,
                                   decode_len=shape.seq_len - 1)
        return measure(step, operands)


def _unrolled_variant(cfg: ModelConfig, k: int) -> ModelConfig:
    """k repeats of the layer pattern (``first_k_dense + k * scan_group``
    layers); the port's layers are a Python loop, nothing to unroll."""
    base = cfg.moe.first_k_dense if cfg.moe is not None else 0
    return dataclasses.replace(cfg, n_layers=base + k * max(cfg.scan_group, 1))


CALIBRATION_REPEATS = (2, 3)


def _affine(c1, c2, reps):
    """The value at ``reps`` repeats of a cost that is ``c1`` and ``c2``
    at `CALIBRATION_REPEATS` (one repeat apart): affine through the
    two."""
    v = c1 + (c2 - c1) * (reps - CALIBRATION_REPEATS[0])
    return int(v) if float(v).is_integer() else v


def calibrated_costs(cfg: ModelConfig, shape: configs.Shape, mesh_spec,
                     **kwargs) -> dict:
    """Per-device costs at the real depth, from `per_device_costs` at
    `CALIBRATION_REPEATS` of the layer pattern, each field extrapolated
    affinely: ``flops``, ``bytes accessed``, ``collectives`` and
    ``collective_counts`` by op, ``peak_bytes``, ``placed_bytes`` and
    ``temp_bytes``; ``calib_s`` the two passes' seconds."""
    g = max(cfg.scan_group, 1)
    base = cfg.moe.first_k_dense if cfg.moe is not None else 0
    reps = (cfg.n_layers - base) / g
    recs, secs = [], []
    for k in CALIBRATION_REPEATS:
        t0 = time.time()
        recs.append(per_device_costs(_unrolled_variant(cfg, k), shape,
                                     mesh_spec, **kwargs))
        secs.append(round(time.time() - t0, 2))
    a, b = recs
    out = {key: _affine(a["cost"][key], b["cost"][key], reps)
           for key in ("flops", "bytes accessed")}
    for field in ("collectives", "collective_counts"):
        out[field] = {op: _affine(a[field].get(op, 0), b[field].get(op, 0),
                                  reps)
                      for op in sorted(set(a[field]) | set(b[field]))}
    for key in ("peak_bytes", "placed_bytes", "temp_bytes"):
        out[key] = _affine(a["memory"][key], b["memory"][key], reps)
    out["calib_s"] = secs
    return out


def dry_cell(arch: str, shape_name: str, *, multi_pod: bool,
             variant: str = "baseline", flops_cache: dict | None = None,
             count: bool = True):
    """One runnable cell's record; ``count=False`` places the operands
    and skips the FLOP count and the per-device pass (``"flops":
    None``)."""
    spec = VARIANTS[variant]
    cfg = configs.get_config(arch)
    if "cfg_fn" in spec:
        cfg = spec["cfg_fn"](cfg)
    train_kwargs = spec.get("train_kwargs", {})
    shape = configs.SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod,
                                shape=spec.get("mesh_shape"))
    sizes = mesh.sizes
    ctx = shd.make_shard_ctx(mesh, cfg)
    opt_overrides = configs.train_overrides(arch)
    record = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
              "variant": variant, "mesh": sizes, "kind": shape.kind,
              "seq_len": shape.seq_len, "global_batch": shape.global_batch}

    params, p_specs, batch, b_specs, cache, c_specs = _operands(cfg, shape,
                                                                ctx)
    mem = {"param_bytes": per_device_bytes(params, p_specs, sizes)}
    mem["batch_bytes"] = per_device_bytes(batch, b_specs, sizes)
    if shape.kind == "train":
        mdt = getattr(torch, opt_overrides.get("moment_dtype", "float32"))
        item = torch.empty((), dtype=mdt).element_size()
        mem["opt_bytes"] = 2 * per_device_bytes(params, p_specs, sizes,
                                                itemsize=item)
    else:
        mem["cache_bytes"] = per_device_bytes(cache, c_specs, sizes)
    mem["total_bytes"] = sum(mem.values())
    mem["fits_80gb"] = mem["total_bytes"] <= HBM_BYTES
    record["memory"] = mem

    key = (arch, shape_name, variant)
    t0 = time.time()
    if not count:
        record.update(status="ok", flops=None)
        return record
    try:
        if flops_cache is not None and key in flops_cache:
            record["flops"] = flops_cache[key]
        else:
            record["flops"] = count_flops(cfg, shape, train_kwargs,
                                          opt_overrides)
            if flops_cache is not None:
                flops_cache[key] = record["flops"]
        record["flops_s"] = round(time.time() - t0, 2)
        cal = calibrated_costs(cfg, shape, mesh, train_kwargs=train_kwargs,
                               opt_overrides=opt_overrides)
        mem["peak_bytes"] = cal["peak_bytes"]
        mem["temp_bytes"] = cal["temp_bytes"]
        record.update(cost={k: cal[k] for k in ("flops", "bytes accessed")},
                      collectives=cal["collectives"],
                      collective_counts=cal["collective_counts"],
                      cost_calibrated=cal, status="ok")
    except Exception as e:  # noqa: BLE001 - record the failure, keep going
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"[:2000]
        record["traceback"] = traceback.format_exc()[-4000:]
    return record


def run_cell(arch, shape_name, multi_pod, out_dir, skip_done=False,
             variant="baseline", flops_cache=None, count=True,
             verbose=True) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape_name}__{'multipod' if multi_pod else 'singlepod'}"
    if variant != "baseline":
        tag += f"__{variant}"
    path = os.path.join(out_dir, tag + ".json")
    if skip_done and os.path.exists(path):
        print(f"[dryrun] skip (done): {tag}")
        with open(path) as f:
            return json.load(f)
    ok, why = configs.cell_status(arch, shape_name)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
               "status": "skipped", "reason": why, "variant": variant}
        if verbose:
            print(f"[dryrun] SKIP {tag}: {why}")
    else:
        rec = dry_cell(arch, shape_name, multi_pod=multi_pod,
                       variant=variant, flops_cache=flops_cache, count=count)
        mem = rec["memory"]
        flops = rec["flops"] if rec["flops"] is not None else float("nan")
        if verbose:
            print(f"[dryrun] {rec['status'].upper()} {tag}: "
                  f"{mem['total_bytes'] / 1e9:.2f} GB/device "
                  f"(fits 80 GB: {mem['fits_80gb']}) "
                  f"flops={flops:.3e}"
                  + (f" per-device: flops={rec['cost']['flops']:.3e} "
                     f"coll={rec['collectives']['total']:.3e}B "
                     f"peak={mem['peak_bytes'] / 1e9:.2f} GB"
                     if "cost" in rec else "")
                  + (f" error={rec['error'][:120]}" if "error" in rec
                     else ""), flush=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def summarize(records) -> dict:
    """Counts of ok / skipped / error cells and the largest per-device
    bytes of the placed cells."""
    out = {"ok": 0, "skipped": 0, "error": 0}
    for r in records:
        out[r["status"]] += 1
    placed = [r for r in records if "memory" in r]
    if placed:
        big = max(placed, key=lambda r: r["memory"]["total_bytes"])
        out["max_bytes"] = big["memory"]["total_bytes"]
        out["max_cell"] = (f"{big['arch']}__{big['shape']}__"
                           f"{'multipod' if big['multi_pod'] else 'singlepod'}"
                           f"__{big['variant']}")
        out["max_fits_80gb"] = big["memory"]["fits_80gb"]
        out["fit"] = sum(r["memory"]["fits_80gb"] for r in placed)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    ap.add_argument("--out", default=os.path.abspath(RESULTS_DIR))
    ap.add_argument("--no-flops", action="store_true",
                    help="place the operands only (seconds for --all)")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in configs.ARCHS for s in configs.SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    flops_cache: dict = {}
    records = [run_cell(arch, shape, mp, args.out, skip_done=args.skip_done,
                        variant=args.variant, flops_cache=flops_cache,
                        count=not args.no_flops)
               for arch, shape in cells for mp in meshes]
    summary = summarize(records)
    print(f"[dryrun] done: {json.dumps(summary)}")
    raise SystemExit(1 if summary["error"] else 0)


if __name__ == "__main__":
    main()
