"""Time the PyTorch port's interface sessions on one card.

    python tools/time_session.py [--root CHECKOUT] [--label NAME]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout),
so two checkouts (say a commit and its parent, unpacked with
``git archive``) can be timed one after the other in one machine.  On
the paper's scaled DYNAPs fabric as ``chip_smoke.py`` drives it (16
cores x 256 neurons x 512 CAM entries, hier_tree arbiter, multicast_tree
NoC, connectivity from a seed), it compiles one session per impl and
runs each on two `TICKS`-tick streams drawn on the card from the seed:
Bernoulli 0.05 and the same with every 16th frame a full burst.  Per
(impl, stream) it prints one JSON line: the median and quartiles of host
ms per tick over `SESSION_RUNS` runs interleaved with the other impls
(host clock around a synchronized ``run``), the device ops per tick and
the idle share of a profiled `PROFILE_TICKS`-tick run, and the card's
name and power limit.  The counts and the seed are chip_smoke.py's
phase 5.  Every session's currents must equal the first impl's bit for
bit.  Exits nonzero on a mismatch or without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

IMPLS = ("pallas", "xla")
TICKS = 256
SESSION_RUNS = 7
PROFILE_TICKS = 32
SEED = 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=pathlib.Path,
                        default=pathlib.Path(__file__).resolve().parents[1])
    parser.add_argument("--label", default="this checkout")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.interface import Interface, InterfaceConfig
    from repro_torch.interface.types import random_connectivity
    from repro_torch.noc.topology import NocConfig
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    configs = {impl: InterfaceConfig(
        cores=16, neurons_per_core=256, cam_entries_per_core=512,
        scheme="hier_tree", noc=NocConfig("multicast_tree"), impl=impl)
        for impl in IMPLS}
    params = random_connectivity(torch.Generator("cuda").manual_seed(SEED),
                                 configs[IMPLS[0]])
    sessions = {impl: Interface(cfg).compile(params)
                for impl, cfg in configs.items()}
    gen = torch.Generator("cuda").manual_seed(SEED + 2)
    bernoulli = torch.rand((TICKS, 16, 256), generator=gen,
                           device="cuda") < 0.05
    burst = bernoulli.clone()
    burst[::16] = True

    for name, stream in (("bernoulli_0.05", bernoulli),
                         ("burst_every_16", burst)):
        want = sessions[IMPLS[0]].run(stream)[0]
        for impl, session in sessions.items():
            if not torch.equal(session.run(stream)[0], want):
                raise SystemExit(f"{args.label}: {impl} currents differ from "
                                 f"{IMPLS[0]}'s on {name}")
        ms = {impl: [] for impl in IMPLS}
        for _ in range(SESSION_RUNS):
            for impl, session in sessions.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                session.run(stream)
                torch.cuda.synchronize()
                ms[impl].append((time.perf_counter() - t) * 1e3 / TICKS)
        for impl, session in sessions.items():
            head = stream[:PROFILE_TICKS]
            session.run(head)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                session.run(head)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t) * 1e6
            device = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            if not device:
                raise SystemExit(f"{args.label}: the profiler recorded no "
                                 f"device op in the {impl} session")
            busy_us = sum(e.device_time_total for e in device)
            q1, med, q3 = statistics.quantiles(ms[impl], n=4)
            print(json.dumps({
                "label": args.label, "impl": impl, "stream": name,
                "ms_per_tick_median": med, "ms_per_tick_quartiles": [q1, q3],
                "runs": SESSION_RUNS, "ticks": TICKS,
                "device_ops_per_tick": len(device) / PROFILE_TICKS,
                "idle_share": 1 - busy_us / wall_us,
                "profiled_ticks": PROFILE_TICKS, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
