"""Time a served rwkv6-3b generate on a 2 x 2 mesh of gloo ranks on one
card, with the collectives the ranks stage through the host.

    python tools/time_mesh_generate.py [--root CHECKOUT] [--label NAME]
        [--layers N] [--tp-only] [--pad H] [--new N] [--runs N]
        [--device cpu]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout),
so two checkouts (say a commit and its parent, unpacked with
``git archive``) can be timed one after the other in one machine.  Four
ranks (`repro_torch.launch.spawn`, gloo, all on CUDA device 0) build a
2 x 2 (data x model) mesh and draw rwkv6-3b at full width (float32
compute; ``--layers`` cuts its depth, 0 keeps it) from a seed, one rank
at a time, placed by the port's specs: FSDP x TP, or with ``--tp-only``
the serving placement (``serve_tp_only``: no data split); ``--pad``
sets ``rwkv_pad_heads`` (48: the WKV on 24 padded heads a rank).  After a
one-token warm-up, ``--runs`` generates of 4 x 128 prompt tokens and
``--new`` new ones are timed (host clock around a synchronized
``ServeEngine.generate``).  Prints one JSON line: the seconds of each
run (the slowest rank's), rank 0's staged calls and bytes by op in the
first (`repro_torch.launch.staging`), whether every rank's tokens agree,
and the card's name and power limit.  ``--device cpu`` runs the same at
the smoke config on CPU ranks (a rehearsal: nothing is staged there).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

BATCH, PROMPT, SEED = 4, 128, 7


def _rank(rank, world, root, layers, tp_only, pad, new, runs, device):
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import mesh as M, staging
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve.lm_engine import ServeEngine
    torch.set_float32_matmul_precision("highest")
    cuda = device == "cuda"
    cfg = (configs.get_config if cuda else configs.get_smoke_config)(
        "rwkv6-3b")
    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              serve_tp_only=tp_only, rwkv_pad_heads=pad)
    if layers and cuda:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    mesh = M.make_host_mesh(2, 2, device=device)
    ctx = shd.make_shard_ctx(mesh, cfg)
    params = None
    for r in range(world):            # one whole tree at a time
        if r == rank:
            full = lm.init_model(torch.Generator(device).manual_seed(SEED),
                                 cfg, device=device)
            params = shd.shard_tree(full, shd.params_pspecs(full, cfg, ctx),
                                    mesh)
            del full
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
        dist.barrier()
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), device=device,
                            generator=torch.Generator(device).manual_seed(1),
                            dtype=torch.int32)
    engine = ServeEngine(cfg, params, max_len=PROMPT + new, ctx=ctx)
    engine.generate(prompts, 1)
    out = []
    for _ in range(runs):
        if cuda:
            torch.cuda.synchronize()
        counts, nbytes = dict(staging.COUNTS), dict(staging.BYTES)
        t0 = time.perf_counter()
        tokens = engine.generate(prompts, new)
        if cuda:
            torch.cuda.synchronize()
        out.append({"s": time.perf_counter() - t0, "tokens": tokens.cpu(),
                    "staged": {op: (n - counts.get(op, 0),
                                    staging.BYTES[op] - nbytes.get(op, 0))
                               for op, n in staging.COUNTS.items()
                               if n - counts.get(op, 0)}})
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--label", default="this checkout")
    parser.add_argument("--layers", type=int, default=0)
    parser.add_argument("--tp-only", action="store_true")
    parser.add_argument("--pad", type=int, default=0)
    parser.add_argument("--new", type=int, default=8)
    parser.add_argument("--runs", type=int, default=2)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.launch.spawn import spawn
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    res = spawn(_rank, 4, device_id=0 if args.device == "cuda" else None,
                timeout=1800,
                args=(root, args.layers, args.tp_only, args.pad, args.new,
                      args.runs, args.device))
    card = (subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
            if args.device == "cuda" else "cpu")
    print(json.dumps({
        "label": args.label, "root": root, "layers": args.layers,
        "tp_only": args.tp_only, "pad": args.pad, "new": args.new,
        "card": card,
        "s": [max(r[i]["s"] for r in res) for i in range(args.runs)],
        "staged_rank0": res[0][0]["staged"],
        "tokens_equal": all(torch.equal(r[i]["tokens"], res[0][0]["tokens"])
                            for r in res for i in range(args.runs)),
        "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
