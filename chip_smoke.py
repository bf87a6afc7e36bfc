"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits nonzero; no phase catches its own failure):

 1. the card: name and power limit (nvidia-smi) and torch's device name;
    no CUDA device exits 1 before anything else runs;
 2. the build: the port's CUDA source, compiled by nvcc, with build time
    and the ptxas register/shared-memory report;
 3. each kernel against its plain torch version on the card, at the main
    path's shapes: the sparse tick at 16 cores x 256 neurons x 512 CAM
    entries for all five arbiter schemes (plus 64 cores for many blocks),
    currents bitwise and latency/energy/hits exactly equal;
 4. the main path: `Interface(cfg).compile(params).run(spikes)` with
    impl="pallas_sparse" on the paper's scaled DYNAPs fabric (16 x 256 x
    512, hier_tree arbiter, multicast_tree NoC), over two 256-tick
    streams - Bernoulli 0.05, and the same stream with every 16th frame a
    full burst (forcing the dense fallback) - held to the impl="xla"
    session (currents bitwise, stats under the conformance contract), to
    the CPU plain path on a 16-tick prefix, and the kernel's launch count
    to the number of non-overflowing ticks;
 5. times, each printed beside the card's name and power limit: session
    ms per tick as the median and quartiles of interleaved runs, and the
    kernel's and plain version's device time per call from the profiler;
 6. a ``kernels`` JSON line, then the card line, then the ok line.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
EXACT_FIELDS = ("events", "cam_searches", "noc_hops", "chip_hops")
REL_TOL = 1e-6
SCHEMES = ("binary_tree", "greedy_tree", "token_ring", "hier_ring",
           "hier_tree")
TICKS = 256
SESSION_RUNS = 7
BURST_EVERY = 16
RATE = 0.05
SEED = 0
DEVICE = "cuda"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def check_stats(label: str, got, want) -> None:
    """Hold two StepStats to the conformance contract: EXACT_FIELDS
    exactly, the rest within REL_TOL, every value finite."""
    for field in want._fields:
        a, b = float(getattr(got, field)), float(getattr(want, field))
        ok = a == b if field in EXACT_FIELDS else math.isclose(
            a, b, rel_tol=REL_TOL)
        check(ok and math.isfinite(a), f"{label}: {field} {a} vs {b}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` back-to-back calls by CUDA events,
    after warm-up: what a caller waits, host overhead included."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_events(fn):
    """Run ``fn`` under the profiler; return (host wall us, the device-side
    events: kernels, copies and sets, each with its duration in us)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall_us, device


def device_ms_per_call(fn, calls: int, name: str | None = None):
    """Device busy ms per call over ``calls`` calls, from the profiler's
    device events (only those whose name holds ``name``, when given).
    Returns None when the profiler recorded no such event."""
    def many():
        for _ in range(calls):
            fn()
    _, events = device_events(many)
    if name is not None:
        events = [e for e in events if name in e.name]
    if not events:
        return None
    return sum(e.device_time_total for e in events) / 1e3 / calls


def host_breakdown(fn, stages):
    """Host seconds spent in each stage while ``fn`` runs, and in all.

    ``stages`` holds ``(label, owner, attribute)``: each attribute is
    replaced by a timed wrapper for the run and restored after, so the
    real path is measured, not a copy of it.  Stages may nest.
    """
    spent = {label: 0.0 for label, _, _ in stages}

    def timed(label, fn_):
        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn_(*args, **kwargs)
            finally:
                spent[label] += time.perf_counter() - t
        return wrapper

    saved = [(owner, attr, getattr(owner, attr)) for _, owner, attr in stages]
    for (label, owner, attr), (_, _, orig) in zip(stages, saved):
        setattr(owner, attr, timed(label, orig))
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total = time.perf_counter() - t
    finally:
        for owner, attr, orig in saved:
            setattr(owner, attr, orig)
    return total, spent


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.core import arbiter as arb
    from repro_torch.interface import Interface, InterfaceConfig, pipeline
    from repro_torch.interface import session as session_mod
    from repro_torch.interface.types import random_connectivity
    from repro_torch.kernels import build
    from repro_torch.kernels.sparse_tick import kernel as sparse_kernel
    from repro_torch.kernels.sparse_tick import ops as sparse_ops
    from repro_torch.kernels.sparse_tick import ref as sparse_ref
    from repro_torch.noc import router as noc_router
    from repro_torch.noc.topology import NocConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = card_line()
    tag = f"[{card}]"
    print(f"card: {card}; torch device: {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__} CUDA {torch.version.cuda}")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    nvcc_s = build.ensure_built(sparse_kernel.SOURCE)
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc "
          f"{'already built' if nvcc_s is None else f'{nvcc_s:.3f} s'})")
    for line in build.ptxas_report(sparse_kernel.SOURCE).splitlines():
        if "Used" in line or "spill" in line:
            print(f"ptxas {sparse_kernel.SOURCE}: {line.strip()}")

    def config(scheme, cores, impl="pallas_sparse"):
        return InterfaceConfig(cores=cores, neurons_per_core=256,
                               cam_entries_per_core=512, scheme=scheme,
                               noc=NocConfig("multicast_tree"), impl=impl)

    def operands(cfg, spikes, seed):
        params = random_connectivity(
            torch.Generator(dev).manual_seed(seed), cfg)
        routing = pipeline.build_routing_index(params, cfg)
        policy, _, capacity = pipeline.resolve_sparse_plan(
            cfg, arb.ArbiterConfig(cfg.scheme, cfg.neurons_per_core))
        spikes = spikes & (spikes.to(torch.int32).cumsum(-1) <= capacity)
        buf, counts = sparse_ops.compact_events(spikes, capacity)
        args = (spikes.reshape(spikes.shape[0], -1), buf, counts,
                routing.src_idx, routing.active, params.weights, routing.csr)
        return args, policy, params

    def kernel_call(args, policy, n=256):
        return sparse_kernel.sparse_tick_cuda(
            *args, n=n, policy=policy.kernel_policy, levels=policy.levels)

    def plain_call(args, policy, n=256):
        return sparse_ref.sparse_tick_ref(*args, n=n,
                                          latency_fn=policy.latency_fn,
                                          encode_fn=policy.encode_fn)

    # ---- 3. kernel against plain, on the card ----------------------------
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    max_err = 0.0
    cases = [(s, 16) for s in SCHEMES] + [("hier_tree", 64)]
    for scheme, cores in cases:
        frame = torch.rand((1, cores, 256), generator=gen, device=dev) < RATE
        args, policy, _ = operands(config(scheme, cores), frame,
                                   SEED + cores)
        got, want = kernel_call(args, policy), plain_call(args, policy)
        torch.cuda.synchronize()
        for name, g, w in zip(("currents", "latency", "encode", "hits"),
                              got, want):
            check(torch.equal(g, w), f"{scheme}/{cores} cores: {name} differ")
            max_err = max(max_err, float((g - w).abs().max()))
        print(f"kernel == plain: sparse_tick {scheme} {cores}x256x512 "
              f"(currents bitwise, latency/energy/hits exact)")

    # ---- 4. the main path ------------------------------------------------
    cfg = config("hier_tree", 16)
    params = random_connectivity(torch.Generator(dev).manual_seed(SEED), cfg)
    sparse_session = Interface(cfg).compile(params)
    xla_session = Interface(config("hier_tree", 16, "xla")).compile(params)
    check(sparse_session.device == xla_session.device == dev,
          "sessions not on the card")
    capacity = sparse_session.plan.sparse[2]
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    sparse_stream = torch.rand((TICKS, 16, 256), generator=gen,
                               device=dev) < RATE
    burst_stream = sparse_stream.clone()
    burst_stream[::BURST_EVERY] = True
    streams = {"bernoulli_0.05": sparse_stream, "burst_every_16": burst_stream}
    fits = {k: int((s.sum(-1).amax(-1) <= capacity).sum())
            for k, s in streams.items()}

    sparse_kernel.launches = 0
    results = {k: sparse_session.run(s) for k, s in streams.items()}
    torch.cuda.synchronize()
    main_launches = sparse_kernel.launches
    check(main_launches == sum(fits.values()),
          f"sparse_tick launches {main_launches} != non-overflowing ticks "
          f"{sum(fits.values())}")
    check(main_launches > 0, "the main path never launched sparse_tick")
    print(f"main path: sparse_tick launched {main_launches} times over "
          f"{len(streams) * TICKS} ticks (non-overflowing ticks: {fits}; "
          f"capacity {capacity})")

    for name, stream in streams.items():
        cur, st = results[name]
        ref_cur, ref_st = xla_session.run(stream)
        check(cur.shape == (TICKS, 16, 256) and bool(cur.isfinite().all()),
              f"{name}: currents shape/finite")
        check(torch.equal(cur, ref_cur), f"{name}: currents != xla session")
        check_stats(name, st, ref_st)
        print(f"{name}: pallas_sparse == xla on the card (currents bitwise, "
              f"stats under the conformance contract); per-tick means "
              f"{json.dumps(st.summary(ticks=TICKS))}")

    # the card against the CPU plain path, on a short prefix
    cpu_session = Interface(config("hier_tree", 16, "xla")).compile(
        params, device="cpu")
    prefix = burst_stream[:16]
    cpu_cur, cpu_st = cpu_session.run(prefix.cpu())
    gpu_cur, gpu_st = sparse_session.run(prefix)
    check(torch.equal(gpu_cur.cpu(), cpu_cur), "card currents != CPU plain")
    check_stats("card vs CPU", gpu_st, cpu_st)
    print("card pallas_sparse == CPU plain xla on a 16-tick burst prefix")

    # ---- 5. times --------------------------------------------------------
    def session_ms(session, stream):
        torch.cuda.synchronize()
        t = time.perf_counter()
        session.run(stream)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / stream.shape[0]

    sessions = (("pallas_sparse", sparse_session), ("xla", xla_session))
    for name, stream in streams.items():
        for _, session in sessions:
            session.run(stream)                  # warm-up
        samples = {label: [] for label, _ in sessions}
        for _ in range(SESSION_RUNS):            # interleaved runs
            for label, session in sessions:
                samples[label].append(session_ms(session, stream))
        for label, ms in samples.items():
            q1, med, q3 = statistics.quantiles(ms, n=4)
            print(f"{tag} session {label} {name}: median {med:.4f} ms/tick "
                  f"(quartiles {q1:.4f}-{q3:.4f}; host clock, "
                  f"{SESSION_RUNS} runs of {TICKS} ticks interleaved with "
                  f"the other session, synchronized)")

    stages = (("overflow precheck (once per run)",
               session_mod.InterfaceSession, "_overflow"),
              ("compact_events", sparse_ops, "compact_events"),
              ("sparse_tick (kernel wrapper)", sparse_ops, "sparse_tick"),
              ("event_indices", sparse_ops, "event_indices"),
              ("event-indexed accounting", pipeline,
               "sparse_accounting_stats"),
              ("  of it NoC costs", noc_router, "noc_step_costs_events"),
              ("dense fallback tick", pipeline, "dense_tick"))
    for name, stream in streams.items():
        total, spent = host_breakdown(lambda: sparse_session.run(stream),
                                      stages)
        top = sum(v for k, v in spent.items() if not k.startswith(" "))
        parts = "; ".join(f"{k.strip()} {v / TICKS * 1e6:.1f}"
                          for k, v in spent.items())
        print(f"{tag} host time per tick, pallas_sparse {name}: total "
              f"{total / TICKS * 1e6:.1f} us = {parts}; rest of the loop "
              f"(stats stack and accumulate, currents) "
              f"{(total - top) / TICKS * 1e6:.1f} us")

    frame = sparse_stream[:1]
    args, policy, params = operands(cfg, frame, SEED)
    kernel_call_ms = cuda_ms(lambda: kernel_call(args, policy), 2000)
    plain_call_ms = cuda_ms(lambda: plain_call(args, policy), 200)
    kernel_ms = device_ms_per_call(lambda: kernel_call(args, policy), 200,
                                   "sparse_tick_kernel")
    plain_ms = device_ms_per_call(lambda: plain_call(args, policy), 50)
    check(kernel_ms is not None,
          "the profiler recorded no sparse_tick_kernel device time")
    check(plain_ms is not None,
          "the profiler recorded no device time for the plain version")
    # The bound counts what B1 itself reads and writes: its inputs
    # (spikes, event buffer, counts, and the CAM entries' source index,
    # active flag, weight and int32 target) and its four outputs, each
    # once.  The port's CSR is a layout of the targets, not extra work.
    outs = kernel_call(args, policy)
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*args[:6], params.targets, *outs))
    ops = int(args[4].sum()) + args[3].numel()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"{tag} sparse_tick kernel: {kernel_ms * 1e3:.3f} us/launch; "
          f"plain torch version: {plain_ms * 1e3:.3f} us/call (profiler "
          f"device time); "
          f"bound {bound_ms * 1e3:.4f} us ({nbytes} bytes at 3.35 TB/s; "
          f"{ops} fp32 ops at 67 TFLOP/s)")
    print(f"{tag} sparse_tick per call as a caller waits (CUDA events, "
          f"back-to-back, host overhead included): wrapper "
          f"{kernel_call_ms * 1e3:.3f} us (2000 calls), plain torch "
          f"{plain_call_ms * 1e3:.3f} us (200 calls)")

    ticks = 32
    wall_us, events = device_events(
        lambda: sparse_session.run(sparse_stream[:ticks]))
    busy_us = sum(e.device_time_total for e in events)
    by_name = {}
    for e in events:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.device_time_total, count + 1)
    if not events:
        print(f"{tag} profile: device time not measured (the profiler "
              f"recorded no device op)")
    else:
        print(f"{tag} profile pallas_sparse bernoulli_0.05, {ticks} ticks: "
              f"wall {wall_us:.1f} us (host clock, profiler on), device "
              f"busy {busy_us:.1f} us in {len(events)} device ops, idle "
              f"share {1 - busy_us / wall_us:.4f}; device ops per tick "
              f"{len(events) / ticks:.1f}")
    for key, (us, count) in sorted(by_name.items(), key=lambda r: -r[1][0])[:8]:
        print(f"{tag}   {us:10.1f} us  x{count:5d}  {key[:90]}")

    # ---- 6. result lines -------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "sparse_tick", "route": "cuda",
        "source": "src/repro_torch/csrc/sparse_tick.cu",
        "replaces": sparse_kernel.REPLACES, "launches": main_launches,
        "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
