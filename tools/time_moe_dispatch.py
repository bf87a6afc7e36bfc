"""Time the PyTorch port's moe_dispatch CUDA kernel on one card.

    python tools/time_moe_dispatch.py [--root CHECKOUT] [--label NAME]
        [--shapes 256x64,3072x64,16384x160,65536x160]
        [--solo-rounds N] [--max-blocks N]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout),
so two checkouts (say a commit and its parent, unpacked with
``git archive``) can be timed one after the other in one machine.  For
each ``MxE`` shape it draws uniform expert ids from a seed on the card,
holds ``dispatch_positions_cuda`` exactly to the plain
``dispatch_positions_ref``, and prints one JSON line: the device us per
call (the profiler's time of the kernels named in ``KERNEL_NAMES``), the
wrapper's us per call as a caller waits (CUDA events over back-to-back
calls), and the card's name and power limit.  ``--solo-rounds`` and
``--max-blocks`` override the wrapper's launch geometry, where it has one
(``--solo-rounds`` larger than the stream's rounds runs one block).
Exits nonzero on a mismatch or without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=pathlib.Path,
                        default=pathlib.Path(__file__).resolve().parents[1])
    parser.add_argument("--label", default="this checkout")
    parser.add_argument("--shapes", default="256x64,3072x64,16384x160,"
                                            "65536x160")
    parser.add_argument("--solo-rounds", type=int)
    parser.add_argument("--max-blocks", type=int)
    parser.add_argument("--reps", type=int, default=200)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.kernels.moe_dispatch import kernel, ref
    for flag, attr in ((args.solo_rounds, "SOLO_ROUNDS"),
                       (args.max_blocks, "MAX_BLOCKS")):
        if flag is not None:
            if not hasattr(kernel, attr):
                raise SystemExit(f"{args.root} has no {attr} to override")
            setattr(kernel, attr, flag)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    gen = torch.Generator("cuda").manual_seed(args.seed)
    for shape in args.shapes.split(","):
        m, e = (int(x) for x in shape.split("x"))
        ids = torch.randint(0, e, (m,), generator=gen, device="cuda",
                            dtype=torch.int32)
        call = lambda: kernel.dispatch_positions_cuda(ids, e)  # noqa: E731
        got, want = call(), ref.dispatch_positions_ref(ids, e)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"{args.label}: moe_dispatch {m}x{e} differs "
                             f"from its plain version")

        for _ in range(10):
            call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            call()
        stop.record()
        torch.cuda.synchronize()
        wrapper_us = start.elapsed_time(stop) * 1e3 / args.reps

        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                call()
            torch.cuda.synchronize()
        device = [ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA
                  and any(n in ev.name for n in kernel.KERNEL_NAMES)]
        if not device:
            raise SystemExit("the profiler recorded no moe_dispatch kernel")
        device_us = sum(ev.device_time_total for ev in device) / args.reps
        geometry = (kernel.launch_geometry(m)
                    if hasattr(kernel, "launch_geometry") else None)
        print(json.dumps({
            "label": args.label, "m": m, "e": e, "device_us": device_us,
            "wrapper_us": wrapper_us,
            "kernels_per_call": len(device) / args.reps,
            "geometry": geometry, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
