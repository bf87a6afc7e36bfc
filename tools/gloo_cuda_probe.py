"""Which gloo collectives run on CUDA tensors of ranks sharing one card.

    python tools/gloo_cuda_probe.py [--ranks 4] [--out build/gloo_probe]

Starts ``--ranks`` gloo ranks, each with cuda:0 as its device, and runs
each collective on CPU and then on CUDA tensors: the direct c10d ops
(``all_reduce``, ``broadcast``, ``all_gather``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``) and the functional ones DTensor calls
(``torch.distributed._functional_collectives``: ``all_reduce``,
``all_gather_tensor``, ``reduce_scatter_tensor``), without the port's
host staging.  Each rank writes a line before and after each op to
``<out>/rank<r>.log``, so an op that ends the ranks (no Python error, no
result) shows as a ``start`` without its ``ok``; the logs are printed at
the end.  Then one NCCL rank runs an all-reduce.  Needs a card.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))
from repro_torch.launch.spawn import free_port  # noqa: E402


def _rank(rank, world, port, out):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    log = open(os.path.join(out, f"rank{rank}.log"), "w", buffering=1)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=20))
    import torch.distributed._functional_collectives as fc
    group = dist.group.WORLD
    for kind in ("cpu", "cuda"):
        dev = torch.device(kind)
        x = torch.arange(8.0, device=dev) + rank
        ops = [
            ("all_reduce", lambda: dist.all_reduce(x.clone())),
            ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
            ("all_gather", lambda: dist.all_gather(
                [torch.empty(8, device=dev) for _ in range(world)], x)),
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                torch.empty(8 * world, device=dev), x)),
            ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                torch.empty(8 // world, device=dev), x)),
            ("all_to_all_single", lambda: dist.all_to_all_single(
                torch.empty(8, device=dev), x)),
            ("functional all_reduce",
             lambda: fc.all_reduce(x, "sum", group).sum().item()),
            ("functional all_gather_tensor",
             lambda: fc.all_gather_tensor(x, 0, group).sum().item()),
            ("functional reduce_scatter_tensor",
             lambda: fc.reduce_scatter_tensor(x, "sum", 0, group).sum().item()),
        ]
        for name, fn in ops:
            log.write(f"{kind} {name} start\n")
            t0 = time.perf_counter()
            try:
                fn()
                if kind == "cuda":
                    torch.cuda.synchronize()
                log.write(f"{kind} {name} ok {time.perf_counter() - t0:.3f} s\n")
            except Exception as e:  # noqa: BLE001 - the probe reports it
                log.write(f"{kind} {name} FAIL {type(e).__name__}: "
                          f"{str(e)[:300]}\n")
    log.write("done\n")
    dist.destroy_process_group()


def _nccl(port, out):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    with open(os.path.join(out, "nccl.log"), "w") as log:
        dist.init_process_group("nccl", rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        x = torch.ones(4, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        log.write(f"nccl all_reduce ok {float(x.sum())}\n")
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--out", default=os.path.join("build",
                                                  "gloo_probe"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank, args=(r, args.ranks, port, args.out))
             for r in range(args.ranks)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=200)
        if p.is_alive():
            p.kill()
    p = ctx.Process(target=_nccl, args=(free_port(), args.out))
    p.start()
    p.join(timeout=60)
    if p.is_alive():
        p.kill()
    for name in sorted(os.listdir(args.out)):
        print(f"== {name}")
        with open(os.path.join(args.out, name)) as f:
            print(f.read())
    return 0


if __name__ == "__main__":
    sys.exit(main())
