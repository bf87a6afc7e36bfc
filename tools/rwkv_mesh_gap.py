"""rwkv6-3b's prefill logits on a 2 x 2 mesh against float64.

    python tools/rwkv_mesh_gap.py [--seed 11] [--batch 4] [--prompt 128]

Draws rwkv6-3b at full width and depth (float32 parameters, seed
``--seed``) on the card and a ``--batch`` x ``--prompt`` prompt, then
takes the last position's prefill logits (`make_prefill_step`) four
ways: one device in float64 (the parameters cast, every float32 cast of
the forward taken to float64), the reference; one device in float32; the
2 x 2 mesh (4 gloo ranks sharing the card, ``serve_tp_only``) in float32
at ``rwkv_pad_heads`` 0 and 48.  Prints the largest gap of each float32
set to the reference, the reference's largest magnitude, and the card's
name and power limit.  A mesh gap within twice the one device's is
summation order; a larger one points at the mesh.  Needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

ARCH = "rwkv6-3b"
PADS = (0, 48)


def _setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _draw(seed, **over):
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = dataclasses.replace(configs.get_config(ARCH),
                              compute_dtype="float32", **over)
    gen = torch.Generator("cuda").manual_seed(seed)
    return cfg, lm.init_model(gen, cfg, device="cuda")


def _prefill(cfg, params, prompts, ctx=None):
    from repro_torch.models import lm
    from repro_torch.models.blocks import LOCAL
    from repro_torch.parallel import regions as R, sharding as shd
    from repro_torch.serve.lm_engine import make_prefill_step
    ctx = ctx or LOCAL
    cache = lm.init_cache(cfg, prompts.shape[0], prompts.shape[1],
                          device="cuda")
    if ctx.enabled:
        cache = shd.shard_tree(cache, shd.cache_pspecs(cache, cfg, ctx),
                               ctx.mesh)
    with torch.no_grad():
        logits, _ = make_prefill_step(cfg, ctx)(params, {"tokens": prompts},
                                                 cache)
    return R.full(logits).double().cpu()


class _float64:
    """Context: the forward in float64.  The port's float32 casts
    (``Tensor.float``) go to float64, and ``"float64"`` is a dtype name
    the configs may use."""

    def __enter__(self):
        from repro_torch.models import blocks
        self._float = torch.Tensor.float
        torch.Tensor.float = lambda t, *a, **k: t.to(torch.float64)
        blocks.DTYPES["float64"] = torch.float64
        return self

    def __exit__(self, *exc):
        from repro_torch.models import blocks
        torch.Tensor.float = self._float
        blocks.DTYPES.pop("float64", None)
        return False


def one_device(seed, prompts):
    """(float64 logits, float32 logits, seconds of each) on one device."""
    from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
    cfg, params = _draw(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f32 = _prefill(cfg, params, prompts)
    s32 = time.perf_counter() - t0
    params = tree_unflatten(params, [x.double() for x in tree_leaves(params)])
    cfg64 = dataclasses.replace(cfg, param_dtype="float64",
                                compute_dtype="float64")
    with _float64():
        t0 = time.perf_counter()
        f64 = _prefill(cfg64, params, prompts)
        s64 = time.perf_counter() - t0
    return f64, f32, s64, s32


def _rank(rank, world, seed, prompts):
    """The 2 x 2 mesh's float32 logits at each pad; the ranks draw the
    full tree one at a time."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    from repro_torch.parallel import sharding as shd
    _setup()
    mesh = M.make_host_mesh(2, 2, device="cuda")
    placed = None
    for r in range(world):
        if r == rank:
            cfg, full = _draw(seed, serve_tp_only=True)
            ctx = shd.make_shard_ctx(mesh, cfg)
            placed = cfg, shd.shard_tree(full, shd.params_pspecs(
                full, cfg, ctx), mesh)
            del full
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    cfg, params = placed
    out = {}
    for pad in PADS:
        c = dataclasses.replace(cfg, rwkv_pad_heads=pad)
        out[pad] = _prefill(c, params, prompts.cuda(),
                            shd.make_shard_ctx(mesh, c))
    return out if rank == 0 else None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rwkv_mesh_gap needs a CUDA device")
    from repro_torch import configs
    from repro_torch.launch.spawn import spawn
    _setup()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    vocab = configs.get_config(ARCH).vocab
    gen = torch.Generator("cuda").manual_seed(args.seed + 5)
    prompts = torch.randint(0, vocab, (args.batch, args.prompt),
                            generator=gen, device="cuda", dtype=torch.int32)
    f64, f32, s64, s32 = one_device(args.seed, prompts)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh = spawn(_rank, 4, backend="gloo", device_id=0, timeout=1200,
                 args=(args.seed, prompts.cpu()))[0]
    spawn_s = time.perf_counter() - t0
    gaps = {"one device float32": float((f32 - f64).abs().max())}
    for pad in PADS:
        gaps[f"mesh 2x2 float32 pad {pad}"] = float(
            (mesh[pad] - f64).abs().max())
    one = gaps["one device float32"]
    mesh_max = max(v for k, v in gaps.items() if k.startswith("mesh"))
    rec = {"card": card, "arch": ARCH, "prompt": [args.batch, args.prompt],
           "largest_logit": float(f64.abs().max()), "gaps_to_float64": gaps,
           "mesh_over_one_device": mesh_max / one,
           "verdict": ("summation order" if mesh_max <= 2 * one
                       else "mesh gap beyond twice the one device's"),
           "seconds": {"float64": s64, "float32": s32, "mesh": spawn_s},
           "mesh_vs_one_device_float32": float(
               max((mesh[p] - f32).abs().max() for p in PADS))}
    print(card)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
