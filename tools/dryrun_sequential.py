"""The DTensor redistributions of a dry-run cell's step that run as
several collectives one after the other (DTensor gathers or sums each
mesh dim in turn where it cannot take them together: 1.5 times the
bytes of one gather over ``("pod", "data")``).

    python tools/dryrun_sequential.py [--shape train_4k,decode_32k]
        [--arch rwkv6-3b,...] [--variant rwkv48] [--repeats 2]

For each runnable cell of the shapes and archs given (all archs by
default) on both production meshes, runs the step as rank 0 of the fake
process group (`repro_torch.launch.dryrun.per_device_costs`, meta
tensors) at ``--repeats`` repeats of the layer pattern, and prints one
line a cell: each such redistribution (source and target placements,
the collectives it runs, the local tensor's shape and bytes) and how
many times it ran, or ``none``.  `recording` gives the same record to
other code (the dry-run tests load this file).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import inspect
import os
import sys

SHAPES = "train_4k,decode_32k,long_500k,prefill_32k"


@contextlib.contextmanager
def recording():
    """A counter of the redistributions run as sequential collectives
    while the context is open, keyed (source placements, target
    placements, collectives, their kind, the local tensor's shape, its
    bytes).  DTensor calls the function it replaces where it plans one
    collective a mesh dim (it warns once a process; this records every
    time)."""
    import torch
    import torch.distributed.tensor._redistribute as rd
    seen: collections.Counter = collections.Counter()

    def record(device_mesh, mesh_dims, src, dst, num_ops, comm_type,
               reason):
        local = next((f.frame.f_locals["local_tensor"]
                      for f in inspect.stack()[1:8]
                      if isinstance(f.frame.f_locals.get("local_tensor"),
                                    torch.Tensor)), None)
        shape = None if local is None else tuple(local.shape)
        nbytes = (None if local is None
                  else local.numel() * local.element_size())
        seen[(str(src), str(dst), num_ops, comm_type, shape, nbytes)] += 1

    inner = rd._warn_flatten_optimization_not_possible
    rd._warn_flatten_optimization_not_possible = record
    try:
        yield seen
    finally:
        rd._warn_flatten_optimization_not_possible = inner


def describe(seen) -> str:
    """One line of a `recording` counter: each redistribution and its
    count, or ``none``."""
    return "; ".join(
        f"{src} -> {dst}: {n} x {ops} {comm} of {shape} ({nbytes} B)"
        for (src, dst, ops, comm, shape, nbytes), n in
        sorted(seen.items(), key=str)) or "none"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default=SHAPES)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    spec = dryrun.VARIANTS[args.variant]
    archs = args.arch.split(",") if args.arch else list(configs.ARCHS)
    for shape in args.shape.split(","):
        for arch in archs:
            if not configs.cell_status(arch, shape)[0]:
                continue
            cfg = configs.get_config(arch)
            if "cfg_fn" in spec:
                cfg = spec["cfg_fn"](cfg)
            for multi_pod in (False, True):
                with recording() as seen:
                    dryrun.per_device_costs(
                        dryrun._unrolled_variant(cfg, args.repeats),
                        configs.SHAPES[shape],
                        make_production_mesh(multi_pod=multi_pod,
                                             shape=spec.get("mesh_shape")),
                        train_kwargs=spec.get("train_kwargs", {}),
                        opt_overrides=configs.train_overrides(arch))
                mesh = "2 x 16 x 16" if multi_pod else "16 x 16"
                print(f"{arch} {shape} {args.variant} {mesh}: "
                      f"{describe(seen)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
