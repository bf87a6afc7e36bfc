"""How many device records a `torch.profiler` capture loses on one card.

    python tools/profiler_loss.py [--busy SECONDS]

On the paper's scaled DYNAPs fabric as ``chip_smoke.py`` drives it (16
cores x 256 neurons x 512 CAM entries, hier_tree, connectivity from a
seed), it profiles windows of `CALLS` whole-run B1 launches
(``sparse_run_cuda``, 256 Bernoulli 0.05 ticks), each alone and each
after `LEAD` small kernels launched in the same capture, once at the
start of the process and again after ``--busy`` seconds of matrix
products.  Per phase and form it prints the kernels recorded of each
window's launches and the positions, in launch order, of the launches
whose device record is missing (their host records are all there), and
the card's name and power limit.  Exits nonzero without a CUDA card.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

CALLS = 40
LEAD = 64
WINDOWS = 8
SEED = 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--busy", type=float, default=150.0)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profiler_loss: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "src"))
    from repro_torch.interface import Interface, InterfaceConfig
    from repro_torch.interface.stats import StepStats
    from repro_torch.interface.types import random_connectivity
    from repro_torch.kernels import build
    from repro_torch.kernels.sparse_tick import kernel as sparse_kernel

    dev = torch.device("cuda")
    build.ensure_built("sparse_tick")
    cfg = InterfaceConfig(cores=16, neurons_per_core=256,
                          cam_entries_per_core=512, scheme="hier_tree",
                          impl="pallas_sparse")
    params = random_connectivity(torch.Generator(dev).manual_seed(SEED), cfg)
    run = Interface(cfg).compile(params, device=dev).plan.run
    frames = torch.rand((1, 256, 16, 256),
                        generator=torch.Generator(dev).manual_seed(SEED + 1),
                        device=dev) < 0.05
    frames &= frames.to(torch.int32).cumsum(-1) <= run.capacity
    out = (torch.empty(tuple(frames.shape), device=dev),
           torch.empty((256, len(StepStats._fields), 1), device=dev))
    pad = torch.zeros(16, device=dev)
    cuda = torch.autograd.DeviceType.CUDA

    def call():
        sparse_kernel.sparse_run_cuda(frames, None, run.kernel, *out)

    def capture(lead):
        call()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                pad.add_(1)
            for _ in range(CALLS):
                call()
            torch.cuda.synchronize()
        events = prof.events()
        recorded = {e.id for e in events if e.device_type == cuda}
        launches = sorted(e.id for e in events if e.device_type != cuda
                          and "aunch" in e.name)
        named = sum(e.device_type == cuda and "sparse_run_kernel" in e.name
                    for e in events)
        lost = [i for i, c in enumerate(launches) if c not in recorded]
        return named, len(launches), lost

    def phase(label):
        for lead in (0, LEAD):
            rows = [capture(lead) for _ in range(WINDOWS)]
            print(f"{label}, lead {lead}: B1 kernels recorded of {CALLS} a "
                  f"window {[r[0] for r in rows]}; launches a window "
                  f"{sorted({r[1] for r in rows})}; launch positions "
                  f"without a device record "
                  f"{sorted({tuple(r[2]) for r in rows})}", flush=True)

    start = time.perf_counter()
    phase(f"at {time.perf_counter() - start:.0f} s")
    a = torch.randn(8192, 8192, device=dev)
    end = time.perf_counter() + args.busy
    while time.perf_counter() < end:
        for _ in range(50):
            a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()
    phase(f"at {time.perf_counter() - start:.0f} s")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
