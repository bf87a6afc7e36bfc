"""Shape and memory dry run of every (arch x shape x mesh) cell, on one
host, with no allocation.

Port of `repro.launch.dryrun`.  Per cell it:
  1. takes the production mesh's axes (16x16 or 2x16x16, or a variant's
     override) as a `MeshSpec` - no process group, no device;
  2. shapes the parameters with ``init_model(None, cfg)`` on the meta
     device, and the batch, the AdamW moments (with the arch's
     ``train_overrides``) and the decode caches likewise;
  3. places them by the port's specs (`repro_torch.parallel.sharding`)
     and records each one's per-device bytes and whether their sum fits
     one 80 GB card;
  4. counts the global FLOPs of the cell's step (train: forward and
     backward, with the variant's microbatching and remat; prefill and
     decode: one forward) with `torch.utils.flop_counter.FlopCounterMode`
     over meta tensors.  A cell whose step reaches an op with no meta
     kernel (a data-dependent shape, a host copy) records
     ``status: "error"`` and the reason, its bytes kept.

The JAX dry run also records XLA's memory analysis and the per-device
collective bytes it parses from the post-SPMD HLO.  Neither has a
counterpart without a compiler, and this dry run does not estimate them:
its bytes are the placed operands' (parameters, moments, batch, caches),
not a program's peak.  ``compat.py`` (JAX-version shims) and
``models/calibrate.py`` (it unrolls ``lax.scan`` so that XLA's cost
analysis visits every iteration) have no counterpart either: the port's
layer and chunk loops are Python loops, so the FLOP counter sees every
iteration.

Output: one JSON a cell under ``build/dryrun_torch/`` (``--out``).

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes [--skip-done]
"""

from __future__ import annotations

import argparse
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
    """Bytes one device holds of ``tree`` placed by ``specs``: each leaf's
    bytes over the product of the axes that split it."""
    spec_of = dict(_flat(specs))
    total = 0
    for path, leaf in _flat(tree):
        parts = 1
        for entry in spec_of[path]:
            for a in shd._axes(entry):
                parts *= sizes[a]
        size = itemsize if itemsize is not None else leaf.element_size()
        total += leaf.numel() * size // parts
    return total


class _one_attention_chunk:
    """Context: exact attention in one (q, kv) chunk.  The port computes
    every chunk pair of its chunked attention (the causal mask hides
    work, it does not skip it), so the count is the same, and a 32k-token
    prefill walks one pair a layer instead of 1,024."""

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
    """Global FLOPs of the cell's step on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.optim import adamw
    from repro_torch.serve.lm_engine import make_decode_step, make_prefill_step
    from repro_torch.train import step as ts
    params = lm.init_model(None, cfg, device="meta")
    batch = _batch_shapes(cfg, shape)
    counter = FlopCounterMode(display=False)
    with counter, _one_attention_chunk():
        if shape.kind == "train":
            opt_cfg = adamw.AdamWConfig(**opt_overrides)
            state = ts.TrainState(params=params,
                                  opt=adamw.init(opt_cfg, params),
                                  step=torch.zeros((), dtype=torch.int32,
                                                   device=META))
            ts.make_train_step(cfg, opt_cfg, **train_kwargs)(state, batch)
        else:
            cache = lm.init_cache(cfg, shape.global_batch,
                                  _cache_len(cfg, shape), device="meta")
            with torch.no_grad():
                if shape.kind == "prefill":
                    make_prefill_step(cfg)(params, batch, cache)
                else:
                    make_decode_step(cfg)(params, cache, batch["tokens"],
                                          shape.seq_len - 1)
    return float(counter.get_total_flops())


def dry_cell(arch: str, shape_name: str, *, multi_pod: bool,
             variant: str = "baseline", flops_cache: dict | None = None,
             count: bool = True):
    """One runnable cell's record; ``count=False`` places the operands
    and skips the FLOP count (``"flops": None``)."""
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
    dp_total = sizes.get("data", 1) * sizes.get("pod", 1)
    opt_overrides = configs.train_overrides(arch)
    record = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
              "variant": variant, "mesh": sizes, "kind": shape.kind,
              "seq_len": shape.seq_len, "global_batch": shape.global_batch}

    params = lm.init_model(None, cfg, device="meta")
    p_specs = shd.params_pspecs(params, cfg, ctx)
    mem = {"param_bytes": per_device_bytes(params, p_specs, sizes)}
    batch = _batch_shapes(cfg, shape)
    bspec = ctx.batch_spec if shape.global_batch >= dp_total else None
    b_specs = {k: shd.sanitize_spec((bspec,) + (None,) * (v.ndim - 1),
                                    v.shape, ctx) for k, v in batch.items()}
    mem["batch_bytes"] = per_device_bytes(batch, b_specs, sizes)
    if shape.kind == "train":
        mdt = getattr(torch, opt_overrides.get("moment_dtype", "float32"))
        item = torch.empty((), dtype=mdt).element_size()
        mem["opt_bytes"] = 2 * per_device_bytes(params, p_specs, sizes,
                                                itemsize=item)
    else:
        cache = lm.init_cache(cfg, shape.global_batch, _cache_len(cfg, shape),
                              device="meta")
        c_specs = shd.cache_pspecs(cache, cfg, ctx)
        if bspec is None:      # batch too small for DP: replicate batch dims
            c_specs = shd.map_with_path(lambda _, s: (None, None) + s[2:],
                                        c_specs)
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
        record["status"] = "ok"
    except Exception as e:  # noqa: BLE001 - record the failure, keep going
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"[:2000]
        record["traceback"] = traceback.format_exc()[-4000:]
    record["flops_s"] = round(time.time() - t0, 2)
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
