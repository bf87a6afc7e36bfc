"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases (any failure exits nonzero; no phase catches its own failure):

 1. the card: name and power limit (nvidia-smi) and torch's device name;
    no CUDA device exits 1 before anything else runs;
 2. the build: the port's five CUDA sources (sparse_tick, cam_search,
    hat_encode, lif_step, moe_dispatch) and the empty launch_floor kernel,
    one nvcc each, started together, with build times and the ptxas
    register/shared-memory report;
 3. each kernel against its plain torch version on the card, at the main
    paths' shapes, exactly equal: the one-tick sparse tick at 16 cores x
    256 neurons x 512 CAM entries for all five arbiter schemes (plus 64
    cores); the whole-run sparse tick (sparse_run) for the five arbiter
    schemes x three NoC schemes at 16 and 64 cores on two lanes of a
    stream with overflowing ticks, each unseeded and seeded by a
    non-zero acc0 (currents bitwise, whole-number stats exact, the rest
    within 1e-6 relative, the largest gap printed; seeded sums bitwise),
    and seeded at the serve path's shape (4 lanes x 16 ticks of the
    pallas_sparse group's scenario streams, ragged, one lane at rest); the
    whole run with the inter-chip tier inside at 16 x 256 x 512 as 2 and
    4 chips, every arbiter x NoC pair, currents and all 12 stats bitwise
    (its largest gap printed on its own line);
    cam_search's match counts at 8192 queries x 4096 sources x 1
    and 5 words, one lane at valid densities 0, one live source, 0.05,
    0.5 and 1, and three lanes at (0.05, 0.5, 1) and (1, 0, one live
    source), and its match matrix, first match and speculative search at
    odd shapes with 1-3 words; hat_encode's one-tick op at N in {256,
    512, 65536} and spike rates 0, 0.05, 0.5 and 1 (its largest gap
    printed on its own), and its whole-run form (hat_run:
    the arbiter's tick latency, encode energy and event count of every
    bitmap of a run) bitwise for the five arbiter schemes at 16 x 256 on
    two lanes of a 256-tick burst stream with the AER stream's edges
    (an event at address 0, one at n - 1, an empty and a full core);
    lif_step bitwise at (128, 4096), (8, 512) and (32, 128), with values
    exactly at the threshold and one ulp below it; moe_dispatch exactly
    at the JAX sweep's (M, E) = (256, 16), (2048, 160), (512, 64),
    (4096, 128), at the served streams
    (decode: 4 x 6 events padded to 256, prefill: M = 3072, E = 64) and
    at M = 65536 and 1048576 with E = 64 and 160 (a cluster of blocks),
    each uniform, all on one expert, with pad and stray ids, and only
    pads;
 4. the main paths: `Interface(cfg).compile(params).run(spikes)` on the
    paper's scaled DYNAPs fabric (16 x 256 x 512, hier_tree arbiter,
    multicast_tree NoC), over two 256-tick streams - Bernoulli 0.05, and
    the same stream with every 16th frame a full burst - first with
    impl="pallas_sparse" (the sparse kernel, the dense fallback on the
    burst ticks; one sparse_run launch a run), then with impl="pallas"
    (cam_search on every tick, hat_encode's hat_run once a run, neither
    one-tick op ever), each
    driven with every launch count set to 0 just before and read just
    after; each held to the impl="xla" session (currents bitwise, stats
    under the conformance contract) and to the CPU plain path on a
    16-tick prefix; then the paper's SNN workload,
    `snn_forward` at `paper_dynaps.scaled_config()` (16 x 256 neurons,
    512 CAM entries, 32 steps) on a batch of 128 rasters, impl="pallas"
    (lif_step once per step) against impl="xla" (spikes, rates and
    logits bitwise), the card against the CPU port on an 8-sample
    prefix, and account=True on 32 samples (1024 ticks); then the SNN
    trained through the port's example (examples/snn_multicore_torch.py)
    at scaled_config: 40 AdamW steps at batch 32, the accounted
    evaluation on 128 samples with lif_step once per step and the
    whole-run sparse tick once (the fabric at impl="pallas_sparse"),
    both held to impl="xla" (spikes, rates, logits and the replay's
    currents bitwise, stats under the conformance contract), one
    training step on the card against the CPU port on the samples of a
    batch without a flipped spike (loss, gradients and updated
    parameters, the largest gaps printed), two uninterrupted 10-step
    runs bitwise equal and run_with_restarts (a failure injected at step
    7, checkpoints every 2 steps) bitwise equal to them; then the served
    LM: DeepSeek-V2-Lite at full width and depth (15.71 B float32
    parameters drawn on the card), `ServeEngine.generate` greedy on 4
    requests of 128 prompt tokens and 32 new tokens, moe_dispatch once per
    MoE layer per forward (26 x 33); the route of every MoE layer of one
    prefill on the card against `hat_route` on the CPU; and the model at
    full width cut to its dense layer and one MoE layer, in float32,
    teacher-forced on the card and on the CPU from the same parameters;
    then the fabric serving tier (served_fabric): 8 tenants in a
    pallas_sparse and a pallas group of the scaled fabric, flush_ticks
    16, ragged rounds; each group's probe tenant bitwise against its solo
    session.run under the drain, the background pump and a chaos run,
    the accounting identity, and B1 once, B3 once and B2 16 times a
    flush, with its events/s, tick ms, host split (transfer, step,
    wait, record) and a flush's device profile; then the multi-chip fabric (multichip_fabric): the scaled
    fabric as 4 chips x 4 cores on the same params and streams, the
    pallas_sparse (B1 once a run, the chip tier inside), pallas (B3 once
    a run, B2 once a tick) and xla sessions and xla and pallas_sparse
    with shard="chips" (no launch), each bitwise in currents to the
    chips=1 session, stats under the conformance contract; "ticks" and
    "cores" telemetry under pallas_sparse and pallas bitwise "off" and
    summing back, inter-chip hops attributed only at chips > 1; a
    FaultModel (dead core 3, drop rate 0.1, 64 corrupted CAM slots)
    under all three impls, a stream in 4 chunks with fault_tick0 bitwise
    one run, the drop mask on the card bitwise the CPU's; two faulted
    tenants and a shard="chips" tenant served by ServeEngine, each
    bitwise its solo run; the oracle tick (arbiter simulator, dense tag
    sweep) on 8 ticks at chips 1 and 4 equal to xla;
 5. times, each printed beside the card's name and power limit: session
    ms per tick as the median and quartiles of interleaved runs, the host
    time per tick split by stage, a device profile of each tick, the SNN
    forward's ms per batch, host split and device profile, host ms per
    training step (median and quartiles of the example's 40 steps), its
    forward/backward/update split, one step's device profile and the
    placement optimizer's host seconds at 4096 neurons, the served
    LM's prefill ms, decode ms per step, tokens/s, host split and device
    profile, and every kernel's, plain version's and library call's time
    per call (the whole-run sparse tick per launch and per tick, seeded
    by acc0 beside unseeded, and at 64 cores; the whole-run hat_encode per launch and per tick, with the
    one-tick kernel and torch.cumsum on lines of their own; cam_search at
    the Bernoulli 0.05 and all-ones frames, with its bound over all pairs and
    over (query, live source) pairs; lif_step with L2 flushed before
    each launch; moe_dispatch at the served prefill and decode streams
    and at benchmarks/kernel_bench.py's 16384 x 160 and 65536 x 160),
    beside the launch floor: an empty kernel's time; the multi-chip
    sessions' host ms per tick beside their chips=1 twins, "cores"
    telemetry beside "off", faulted runs beside clean ones, the oracle's
    ms a tick, and B1 with and without the chip tier;
 6. a ``kernels`` JSON line, then the card line, then the ok line.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
# int32 on the CUDA cores: 64 INT32 lanes per SM against 128 FP32 lanes
# (Hopper white paper), so half the data sheet's float32 rate
INT32_OPS_PER_S = FP32_OPS_PER_S / 2
EXACT_FIELDS = ("events", "cam_searches", "noc_hops", "chip_hops")
# StepStats fields whose values are whole numbers, held exactly between
# the whole-run kernel and its plain version
WHOLE_FIELDS = EXACT_FIELDS + ("encode_latency", "noc_energy",
                               "chip_latency", "chip_energy")
REL_TOL = 1e-6
SCHEMES = ("binary_tree", "greedy_tree", "token_ring", "hier_ring",
           "hier_tree")
NOC_SCHEMES = ("broadcast", "unicast", "multicast_tree")
CORES, NEURONS, ENTRIES = 16, 256, 512
RUN_LANES, RUN_TICKS, RUN_BURST = 2, 8, (2, 5)
TICKS = 256
PREFIX = 16
SESSION_RUNS = 7
BURST_EVERY = 16
RATE = 0.05
SEED = 0
DEVICE = "cuda"
LIF_SHAPES = ((128, 4096), (8, 512), (32, 128))
SNN_BATCH = 128                 # examples/snn_multicore.py's EVAL_BATCH
SNN_PREFIX = 8
ACCOUNT_BATCH = 32
MOE_SWEEP = ((256, 16), (2048, 160), (512, 64), (4096, 128))
MOE_LONG = ((65536, 64), (65536, 160), (1048576, 64), (1048576, 160))
MOE_BENCH = ((16384, 160), (65536, 160))   # benchmarks/kernel_bench.py times
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 128, 32
LM_CHECK_BATCH, LM_CHECK_TOKENS = 2, 32
LM_RUNS = 3
SERVE_TENANTS = 8               # benchmarks/noc_bench.py --serve's default
SERVE_FLUSH = 16
SERVE_TICKS = 64                # tenant i submits 64 - 8 (i % 4) a round
SERVE_ROUNDS = 3                # measured, after one warm-up round
MC_CHIPS = 4                    # the DYNAP-SE board: 4 chips x 4 cores
MC_CHUNKS = 4                   # a faulted stream in chunks
MC_SERVE_TICKS = 64             # each multichip tenant, 4 flushes
MC_ORACLE_TICKS = 8
MC_RUNS = 7                     # interleaved timing runs of the multichip
TIER_PAIRS = 10                 # B1 with the chip tier against without
MC_INVARIANT_FIELDS = ("events", "encode_latency", "encode_energy",
                       "cam_searches", "cam_energy", "cam_time_ns")
TRAIN_STEPS = 40                # examples/snn_multicore.py's SNN_STEPS
TRAIN_EVAL_BATCH = 128          # and its SNN_EVAL_BATCH
DRILL_STEPS = 10                # two uninterrupted runs and the drill
DRILL_FAIL_AT = 7
DRILL_EVERY = 2
TRAIN_SPLIT_STEPS = 10          # steps timed by stage
# one training step, card against CPU, on samples without a flipped
# spike: the loss as the forward's logits; gradients within GRAD_RTOL of
# each element plus GRAD_ATOL of the leaf's largest (tol); the updated
# parameters within 1e-6 of the leaf's largest plus what that gradient
# gap can move them: AdamW's first step moves an element by lr * g /
# (|g| + eps), so a gap of tol moves it by at most 2 lr min(1, tol / |g|).
# That bound says nothing where |g| <= tol, so the card's parameters are
# also held, element by element within 1e-6 of the leaf's largest, to
# the CPU port's adamw.update of the card's own gradient.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# card against CPU on the same inputs, float32 softmax and sums in
# another order: route weights, aux and z losses (an H100 read 1.9e-6),
# and the logits of the 2-layer full-width float32 cut (an H100 read
# 8.9e-6 with logits up to 5.4)
ROUTE_RTOL, ROUTE_ATOL = 1e-5, 1e-6
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-4


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def check_field(label: str, field: str, got, want) -> None:
    """One StepStats field under the conformance contract: EXACT_FIELDS
    exactly, the rest within REL_TOL, finite."""
    a, b = float(got), float(want)
    ok = a == b if field in EXACT_FIELDS else math.isclose(
        a, b, rel_tol=REL_TOL)
    check(ok and math.isfinite(a), f"{label}: {field} {a} vs {b}")


def check_stats(label: str, got, want) -> None:
    """Hold two StepStats to the conformance contract: EXACT_FIELDS
    exactly, the rest within REL_TOL, every value finite."""
    for field in want._fields:
        check_field(label, field, getattr(got, field), getattr(want, field))


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


def device_events(fn, captures: int = 3):
    """Run ``fn`` under the profiler; return (host wall us, the device-side
    events: kernels, copies and sets, each with its duration in us).

    A capture of a short window with a handful of device ops now and then
    comes back with no device event at all although the ops ran; such a
    capture is taken again, at most ``captures`` times in all, and each
    retry is printed.  The callers still fail when every capture came
    back empty.
    """
    fn()
    torch.cuda.synchronize()
    for attempt in range(captures):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if device:
            break
        print(f"profiler capture {attempt + 1} of {captures} recorded no "
              f"device event; capturing again" if attempt + 1 < captures
              else f"profiler: none of {captures} captures recorded a "
              f"device event")
    return wall_us, device


def device_ms_per_call(fn, calls: int, name: str | None = None) -> float:
    """Device busy ms per call over ``calls`` calls, from the profiler's
    device events (only those whose name holds ``name``, when given).
    Fails when the profiler recorded no such event."""
    def many():
        for _ in range(calls):
            fn()
    _, events = device_events(many)
    if name is not None:
        events = [e for e in events if name in e.name]
    check(bool(events), f"the profiler recorded no device time for "
          f"{name or 'the call'}")
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


def bound(nbytes: int, ops: int, ops_per_s: float):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over their peak rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else \
        "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Capture:
    """Record every call of ``owner.attribute`` (its arguments and result)
    while the block runs; the real function still does the work."""

    def __init__(self, owner, attribute):
        self.owner, self.attribute = owner, attribute
        self.calls = []

    def __enter__(self):
        orig = self.orig = getattr(self.owner, self.attribute)

        def wrapper(*args, **kwargs):
            out = orig(*args, **kwargs)
            self.calls.append((args, kwargs, out))
            return out
        setattr(self.owner, self.attribute, wrapper)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.owner, self.attribute, self.orig)


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def route_gap(card, cpu, label):
    """Hold a route from the card to one from the CPU on the same logits:
    integer fields exactly, float fields within ROUTE_RTOL / ROUTE_ATOL.
    Returns the largest gap of a float field."""
    gap = 0.0
    for field in card._fields:
        a, b = getattr(card, field).cpu(), getattr(cpu, field)
        if a.is_floating_point():
            check(torch.allclose(a, b, rtol=ROUTE_RTOL, atol=ROUTE_ATOL),
                  f"{label}: route {field} beyond rtol {ROUTE_RTOL} / atol "
                  f"{ROUTE_ATOL}: max {float((a - b).abs().max())}")
            gap = max(gap, float((a - b).abs().max()))
        else:
            check(torch.equal(a, b), f"{label}: route {field} differs")
    return gap


def served_lm(dev, tag, reset_launches, read_launches, no_launch):
    """The served DeepSeek-V2-Lite: the model cut to two layers at full
    width, card against CPU; then the full model served on the card,
    its launches, routes, times and device profile.  Returns the B5
    launches of the served run and one MoE layer's padded prefill
    event stream."""
    from repro_torch.configs import deepseek_v2_lite_16b
    from repro_torch.core import event_router
    from repro_torch.kernels.moe_dispatch import kernel as moe_kernel
    from repro_torch.kernels.moe_dispatch import ops as moe_ops
    from repro_torch.models import blocks, lm
    from repro_torch.serve.lm_engine import ServeEngine

    cfg = deepseek_v2_lite_16b.config()
    gen = torch.Generator(dev).manual_seed(SEED + 4)

    # ---- the model cut to its dense layer and one MoE layer, float32,
    # teacher-forced on the card and on the CPU from the same parameters.
    # Layer 1's router sees layer 0's output, which the card sums in
    # another order: a token whose top-k gates are nearly tied may choose
    # another expert there (a flip, counted), and through the shared
    # capacity a later token of that expert may be kept on one side and
    # dropped on the other.  Every other token must agree.
    small = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    params = lm.init_model(torch.Generator(dev).manual_seed(SEED), small)
    cpu_params = tree_to(params, "cpu")
    tokens = torch.randint(0, cfg.vocab, (LM_CHECK_BATCH, LM_CHECK_TOKENS),
                           generator=gen, device=dev, dtype=torch.int32)
    with Capture(event_router, "hat_route") as card_routes:
        card = lm.forward(params, {"tokens": tokens}, small)
    with Capture(event_router, "hat_route") as cpu_routes:
        cpu = lm.forward(cpu_params, {"tokens": tokens.cpu()}, small)
    check(len(card_routes) == len(cpu_routes) == 1, "one MoE layer routes")
    (c_args, _, rc), (p_args, _, rp) = card_routes[0], cpu_routes[0]
    k = cfg.moe.top_k
    logit_in_gap = float((c_args[0].cpu() - p_args[0]).abs().max())
    gates_c = torch.softmax(c_args[0].cpu().float(), -1)
    gates_p = torch.softmax(p_args[0].float(), -1)
    flips = (rc.expert_ids.cpu() != rp.expert_ids).any(-1)
    cascade = ~flips & (rc.kept.cpu() != rp.kept).any(-1)
    top = torch.sort(gates_p, -1, descending=True).values[:, :k + 1]
    tie_gap = (top[:, :-1] - top[:, 1:]).min(-1).values
    drift = (gates_c - gates_p).abs().amax(-1)
    for t in flips.nonzero()[:, 0].tolist():
        check(float(tie_gap[t]) <= 2 * float(drift[t]) + 1e-7,
              f"token {t} chose other experts on the card without a near "
              f"tie: top-{k + 1} gate gap {float(tie_gap[t])}, gates "
              f"differ by {float(drift[t])}")
    if bool(cascade.any()):
        check(bool(flips.any()) and int(flips.nonzero()[0]) <
              int(cascade.nonzero()[0]), "a kept/dropped event differs "
              "with no earlier flip to explain it")
    same = ~(flips | cascade)
    check(bool(same.any()), "every token's route differs")
    lc = card["logits"].cpu().reshape(-1, cfg.vocab)[same]
    lp = cpu["logits"].reshape(-1, cfg.vocab)[same]
    logit_gap = float((lc - lp).abs().max())
    check(bool(card["logits"].isfinite().all())
          and card["logits"].shape == (LM_CHECK_BATCH, LM_CHECK_TOKENS,
                                       cfg.vocab), "reduced logits shape")
    check(torch.allclose(lc, lp, rtol=LOGIT_RTOL, atol=LOGIT_ATOL),
          f"reduced-depth logits card vs CPU beyond rtol {LOGIT_RTOL} / atol "
          f"{LOGIT_ATOL}: max {logit_gap}")
    weight_gap = float((rc.weights.cpu() - rp.weights)[same].abs().max())
    check(torch.allclose(rc.weights.cpu()[same], rp.weights[same],
                         rtol=ROUTE_RTOL, atol=ROUTE_ATOL),
          f"reduced-depth route weights beyond tolerance: {weight_gap}")
    check(torch.equal(rc.event_slot.cpu()[same] >= 0, rp.kept[same]),
          "reduced-depth kept events differ")
    if not bool(flips.any()):
        route_gap(rc, rp, "reduced-depth layer 1")
    print(f"LM card vs CPU port, full width cut to 2 layers (dense layer 0, "
          f"MoE layer 1), float32, teacher-forced on {LM_CHECK_BATCH} x "
          f"{LM_CHECK_TOKENS} tokens: layer 1 gate logits differ by at most "
          f"{logit_in_gap:.3e}; route flips from near ties "
          f"{int(flips.sum())} of {flips.numel()} tokens, kept/dropped "
          f"changes they cascade into {int(cascade.sum())}; on the "
          f"{int(same.sum())} other tokens logits max abs diff "
          f"{logit_gap:.3e} (within rtol {LOGIT_RTOL} / atol {LOGIT_ATOL}; "
          f"largest logit {float(lp.abs().max()):.3f}) and route weights "
          f"{weight_gap:.3e} (within rtol {ROUTE_RTOL} / atol {ROUTE_ATOL})")
    del params, cpu_params, card, cpu, card_routes, cpu_routes
    torch.cuda.empty_cache()

    # ---- the full model on the card ----------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm.init_model(torch.Generator(dev).manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"served LM {cfg.name}: {n_params} parameters "
          f"({n_params * 4 / 1e9:.2f} GB float32) drawn on the card in "
          f"{init_s:.3f} s; groups {cfg.scan_groups()}; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=dev, dtype=torch.int32)
    engine = ServeEngine(cfg, params)
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    want_ops = n_moe * (1 + LM_STEPS)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = engine.generate(prompts, LM_STEPS)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(launches == {**no_launch, "moe_dispatch": want_ops},
          f"served LM launches {launches}: want moe_dispatch once per MoE "
          f"layer per forward ({n_moe} x {1 + LM_STEPS}) and nothing else")
    check(out.shape == (LM_BATCH, LM_STEPS) and out.dtype == torch.int32
          and int(out.min()) >= 0 and int(out.max()) < cfg.vocab,
          "served tokens shape/range")
    print(f"main path ServeEngine.generate: {LM_BATCH} requests x "
          f"{LM_PROMPT} prompt tokens, {LM_STEPS} new tokens greedy; "
          f"launches {launches}; peak {peak:.2f} GiB allocated")

    # the route of every MoE layer of one prefill: card against CPU
    cache = lm.init_cache(cfg, LM_BATCH, engine.max_len)
    with Capture(event_router, "hat_route") as routes:
        logits, _ = engine._prefill(params, {"tokens": prompts}, cache)
    check(len(routes) == n_moe and bool(logits.isfinite().all()),
          "prefill: one route per MoE layer, finite logits")
    gap = 0.0
    kept = dropped = 0
    for layer, (args, kwargs, card_route) in enumerate(routes, start=1):
        cpu_route = event_router.hat_route(args[0].cpu(), *args[1:], **kwargs)
        gap = max(gap, route_gap(card_route, cpu_route, f"prefill layer "
                                                        f"{layer}"))
        kept += int(cpu_route.kept.sum())
        dropped += int((~cpu_route.kept).sum())
    stream = routes[0][2].expert_ids.reshape(-1)
    capacity = routes[0][0][2]
    print(f"served prefill routes, {n_moe} MoE layers: the card (B5) == the "
          f"CPU (plain version) on the same bfloat16 gate logits - "
          f"expert ids, buffer rows, slots, kept and loads exact, weights "
          f"and losses within {gap:.3e}; {kept} events kept and {dropped} "
          f"dropped at capacity {capacity} ({stream.numel()} events a layer)")

    # times: prefill ms and decode ms per step (each call synchronized),
    # then whole generate calls for tokens/s
    step_ms = {"prefill": [], "decode": []}

    def timed(label, fn):
        def wrapper(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*args)
            torch.cuda.synchronize()
            step_ms[label].append((time.perf_counter() - t) * 1e3)
            return res
        return wrapper
    engine._prefill = timed("prefill", engine._prefill)
    engine._decode = timed("decode", engine._decode)
    timed_out = engine.generate(prompts, LM_STEPS)
    engine.__post_init__()
    check(torch.equal(timed_out, out), "greedy generate is not deterministic")
    gen_s = []
    for _ in range(LM_RUNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.generate(prompts, LM_STEPS)
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t)
    dq1, dmed, dq3 = statistics.quantiles(step_ms["decode"], n=4)
    med_s = statistics.median(gen_s)
    print(f"{tag} served LM {cfg.name}, {LM_BATCH} requests: prefill "
          f"{step_ms['prefill'][0]:.3f} ms ({LM_BATCH} x {LM_PROMPT} tokens); "
          f"decode median {dmed:.3f} ms/step (quartiles {dq1:.3f}-{dq3:.3f}, "
          f"{LM_STEPS} steps); generate median {med_s * 1e3:.3f} ms of "
          f"{LM_RUNS} runs = {LM_BATCH * LM_STEPS / med_s:.3f} new tokens/s "
          f"(host clock, synchronized)")

    # host split of one generate
    total, spent = host_breakdown(lambda: engine.generate(prompts, LM_STEPS), (
        ("attention (mla_apply)", blocks, "mla_apply"),
        ("router and hat_route (route_tokens)", blocks, "route_tokens"),
        ("  of it hat_route", event_router, "hat_route"),
        ("  of it the dispatch_positions op (B5)", moe_ops,
         "dispatch_positions"),
        ("expert weight casts (_moe_weight)", blocks, "_moe_weight"),
        ("expert FFN (_expert_ffn)", blocks, "_expert_ffn"),
        ("dense and shared MLPs (mlp_apply)", blocks, "mlp_apply"),
        ("final norm and head (_head)", lm, "_head")))
    top = sum(v for k_, v in spent.items() if not k_.startswith(" "))
    parts = "; ".join(f"{k_.strip()} {v * 1e3:.3f}" for k_, v in spent.items())
    print(f"{tag} host ms per generate ({1 + LM_STEPS} forwards): total "
          f"{total * 1e3:.3f} = {parts}; embedding, norms, MoE gather and "
          f"combine, sampling and the wait for the device "
          f"{(total - top) * 1e3:.3f}")

    # device profile of one generate
    wall_us, events = device_events(lambda: engine.generate(prompts,
                                                            LM_STEPS))
    check(bool(events), "the profiler recorded no device op in generate")
    busy_us = sum(e.device_time_total for e in events)
    by_name = {}
    for e in events:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.device_time_total, count + 1)
    b5 = {kernel: sum(c for n, (_, c) in by_name.items() if kernel in n)
          for kernel in moe_kernel.KERNEL_NAMES}
    check(all(c == want_ops for c in b5.values()),
          f"profile: B5 kernels {b5}, want {want_ops} of each")
    print(f"{tag} profile generate: wall {wall_us:.1f} us (host clock, "
          f"profiler on), device busy {busy_us:.1f} us in {len(events)} "
          f"device ops, idle share {1 - busy_us / wall_us:.4f}; B5 kernels "
          f"counted {b5} against {n_moe} x {1 + LM_STEPS} = {want_ops} ops")
    for key, (us, count) in sorted(by_name.items(),
                                   key=lambda r: -r[1][0])[:14]:
        print(f"{tag}   {us:10.1f} us  x{count:5d}  {key[:90]}")
    del params, engine
    torch.cuda.empty_cache()
    return launches["moe_dispatch"], stream


def served_fabric(dev, tag, reset_launches, read_launches, no_launch):
    """The fabric serving tier on the card: `repro_torch.serve.ServeEngine`
    with SERVE_TENANTS tenants in two groups of the scaled fabric, one
    ``pallas_sparse`` (B1) and one ``pallas`` (B2, B3).  Checks each
    group's probe tenant bitwise against its solo ``session.run`` under
    the synchronous drain, the background pump and a chaos run with
    transfer and execute faults, the accounting identity, and the
    launches per flush; prints the serving metrics.  Returns the
    launches per flush of B1, B2 and B3."""
    from repro_torch import traffic
    from repro_torch.configs import paper_dynaps
    from repro_torch.ft import ChaosInjector, FaultEvent, FaultPlan
    from repro_torch.ft import RetriesExhaustedError
    from repro_torch.interface import Interface
    from repro_torch.kernels.cam_search import kernel as cam_kernel
    from repro_torch.kernels.hat_encode import kernel as hat_kernel
    from repro_torch.kernels.sparse_tick import kernel as sparse_kernel
    from repro_torch.serve import RetryPolicy, ServeEngine, TenantSpec
    from repro_torch.serve import default_connectivity
    from repro_torch.serve import engine as engine_mod

    fabric = paper_dynaps.scaled_config().fabric
    cfgs = {impl: dataclasses.replace(fabric, impl=impl)
            for impl in ("pallas_sparse", "pallas")}
    names = traffic.scenario_names()
    per_group = SERVE_TENANTS // 2
    specs = [TenantSpec(f"tenant{i}", cfgs["pallas_sparse" if i < per_group
                                           else "pallas"],
                        scenario=names[i % len(names)], seed=i)
             for i in range(SERVE_TENANTS)]
    ticks = {s.name: SERVE_TICKS - 8 * (i % 4) for i, s in enumerate(specs)}
    probes = {"pallas_sparse": specs[0], "pallas": specs[per_group]}
    print(f"serve: {SERVE_TENANTS} tenants on {fabric.cores} x "
          f"{fabric.neurons_per_core} x {fabric.cam.entries} "
          f"({fabric.scheme}, {fabric.noc.scheme}), scenarios "
          f"{[s.scenario for s in specs]}, groups pallas_sparse "
          f"{[s.name for s in specs[:per_group]]} and pallas "
          f"{[s.name for s in specs[per_group:]]}; flush_ticks {SERVE_FLUSH}; "
          f"ticks a round {list(ticks.values())}")

    def make_engine(**kw):
        engine = ServeEngine(flush_ticks=SERVE_FLUSH, flush_deadline_s=0.0,
                             keep_currents=True, device=dev, **kw)
        for spec in specs:
            engine.register(spec)
        check(len(engine.groups) == 2, "serve: want two tenant groups")
        return engine

    def submit_round(engine):
        for spec in specs:
            engine.submit_scenario(spec.name, ticks[spec.name])

    # each probe's solo run on the card, over the stream of the rounds it
    # is served, rebuilt from its CPU generator
    solo = {}
    for impl, spec in probes.items():
        stream = torch.cat([spec.stream(ticks[spec.name], round=r)
                            for r in range(1 + SERVE_ROUNDS)]).to(dev)
        session = Interface(cfgs[impl]).compile(default_connectivity(
            cfgs[impl], spec.connectivity_seed), device=dev)
        cur, st = session.run(stream)
        solo[impl] = (cur.cpu().numpy(), [float(f) for f in st])

    def check_probes(engine, label, warmed=False):
        """Each probe's currents (kept since the warm-up round's reset,
        when ``warmed``) and stats bitwise equal to its solo run."""
        for impl, spec in probes.items():
            cur, st = solo[impl]
            served_from = ticks[spec.name] if warmed else 0
            got = engine.currents(spec.name)
            check(got.shape == cur[served_from:].shape
                  and bool(np.isfinite(got).all())
                  and np.array_equal(got, cur[served_from:]),
                  f"serve {label}: {spec.name} ({impl}) currents differ "
                  f"from its solo run")
            mine = [float(f) for f in engine.tenant_stats(spec.name)]
            check(mine == st, f"serve {label}: {spec.name} ({impl}) stats "
                  f"{mine} differ from its solo run's {st}")
        check(engine.accounting()["closes"],
              f"serve {label}: accounting does not close: "
              f"{engine.accounting()}")

    # ---- the synchronous drain: one warm-up round, then the measured ones
    engine = make_engine()
    submit_round(engine)
    engine.drain()
    engine.reset_metrics()
    flushes = {impl: 0 for impl in cfgs}
    step = engine_mod.ServeEngine._step

    def counted_step(self, group, staged):
        out = step(self, group, staged)
        flushes[group.config.impl] += 1
        return out

    engine_mod.ServeEngine._step = counted_step
    try:
        reset_launches()
        for _ in range(SERVE_ROUNDS):
            submit_round(engine)
            engine.drain()
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        engine_mod.ServeEngine._step = step
    check_probes(engine, "sync drain", warmed=True)
    per_flush = {"sparse_tick": launches["sparse_tick"]
                 / flushes["pallas_sparse"],
                 "hat_encode": launches["hat_encode"] / flushes["pallas"],
                 "cam_search": launches["cam_search"] / flushes["pallas"]}
    print(f"serve sync drain: {SERVE_ROUNDS} rounds, flushes {flushes}, "
          f"launches {launches}; per flush {per_flush}")
    check(launches == {**no_launch,
                       "sparse_tick": flushes["pallas_sparse"],
                       "hat_encode": flushes["pallas"],
                       "cam_search": SERVE_FLUSH * flushes["pallas"]},
          f"serve launches {launches} for flushes {flushes}: want B1 once "
          f"a pallas_sparse flush, B3 once and B2 {SERVE_FLUSH} times a "
          f"pallas flush, nothing else")
    check(min(flushes.values()) > 0, "serve: a group never flushed")
    report = engine.serve_report()
    fleet = report[-1]
    served = engine.ticks_served()
    n_flush = int(engine.registry.counter("serve.flushes").value)
    check(served == SERVE_ROUNDS * sum(ticks.values())
          and math.isfinite(fleet["events_per_sec"])
          and fleet["events_per_sec"] > 0, f"serve fleet record {fleet}")
    print(f"serve probes {[s.name for s in probes.values()]} == their solo "
          f"session.run on the card ({1 + SERVE_ROUNDS} rounds: currents "
          f"and stats bitwise); accounting closes; {served} ticks served")
    print(f"{tag} serve sync drain: {fleet['events_per_sec']:.1f} events/s "
          f"sustained ({fleet['events']:.0f} events in {fleet['busy_s']:.6f} "
          f"s of step wall clock); tick ms p50 {fleet['tick_ms_p50']:.6f}, "
          f"p95 {fleet['tick_ms_p95']:.6f}, p99 {fleet['tick_ms_p99']:.6f} "
          f"(engine histograms, a flush's wall clock over its "
          f"{SERVE_FLUSH} ticks); {fleet['busy_s'] * 1e3 / n_flush:.4f} ms "
          f"per flush over {n_flush} flushes")
    by_tenant = {r["tenant"]: r for r in report[:-1]}
    for impl, spec in probes.items():
        rec = by_tenant[spec.name]
        print(f"{tag} serve {impl} group (its tenants' tick ms, probe "
              f"{spec.name}): p50 {rec['tick_ms_p50']:.6f}, p99 "
              f"{rec['tick_ms_p99']:.6f}, so {SERVE_FLUSH * rec['tick_ms_p50']:.4f}"
              f" ms a flush at the median")

    # the host split of one more round, per flush, and each group's device
    # profile of one flush (16 ticks a tenant of that group only)
    stages = (("transfer", engine_mod.ServeEngine, "_transfer"),
              ("step", engine_mod.ServeEngine, "_step"),
              ("wait", engine_mod.ServeEngine, "_wait"),
              ("record", engine_mod.ServeEngine, "_record"))
    before = engine.registry.counter("serve.flushes").value

    def one_round():
        submit_round(engine)
        engine.drain()
    total, spent = host_breakdown(one_round, stages)
    n = engine.registry.counter("serve.flushes").value - before
    parts = "; ".join(f"{k} {v * 1e3 / n:.4f}" for k, v in spent.items())
    print(f"{tag} serve host ms per flush ({int(n)} flushes of one round): "
          f"total {total * 1e3 / n:.4f} = {parts}; the rest (queue, "
          f"staging, chunk packing, submit) "
          f"{(total - sum(spent.values())) * 1e3 / n:.4f}")

    for impl in cfgs:
        group = [s for s in specs if s.config.impl == impl]
        frames = {s.name: s.stream(SERVE_FLUSH, round=100).numpy()
                  for s in group}

        def one_flush():
            for name, f in frames.items():
                engine.submit(name, f)
            engine.pump(force=True)
        wall_us, events = device_events(one_flush)
        check(bool(events), f"serve: the profiler recorded no device op in "
              f"a {impl} flush")
        busy_us = sum(e.device_time_total for e in events)
        by_name = {}
        for e in events:
            us, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.device_time_total, count + 1)
        print(f"{tag} serve profile, one {impl} flush ({len(group)} lanes x "
              f"{SERVE_FLUSH} ticks): wall {wall_us:.1f} us (host clock, "
              f"profiler on), device busy {busy_us:.1f} us in {len(events)} "
              f"device ops, idle share {1 - busy_us / wall_us:.4f}")
        for key, (us, count) in sorted(by_name.items(),
                                       key=lambda r: -r[1][0])[:8]:
            print(f"{tag}   {us:10.1f} us  x{count:5d}  {key[:90]}")
    check(engine.accounting()["closes"], "serve: accounting after profiles")

    # ---- the same fleet drained by the background pump
    pumped = make_engine()
    submit_round(pumped)
    pumped.drain()
    pumped.reset_metrics()
    for _ in range(SERVE_ROUNDS):
        submit_round(pumped)
    pumped.start(poll_interval_s=1e-4)
    deadline = time.monotonic() + 300.0
    while (pumped.queue_depth()
           or any(g.backlog_ticks() for g in pumped.groups.values())):
        check(time.monotonic() < deadline and pumped.running,
              "serve: the background pump did not drain the fleet")
        time.sleep(0.002)
    pumped.stop(drain=True)
    check(not pumped.running and pumped.pump_errors() == [],
          f"serve pump errors {pumped.pump_errors()}")
    check_probes(pumped, "background pump", warmed=True)
    async_fleet = pumped.serve_report()[-1]
    print(f"{tag} serve background pump: {async_fleet['events_per_sec']:.1f} "
          f"events/s, tick ms p50 {async_fleet['tick_ms_p50']:.6f}, p99 "
          f"{async_fleet['tick_ms_p99']:.6f}; async/sync events/s "
          f"{async_fleet['events_per_sec'] / fleet['events_per_sec']:.4f}; "
          f"probes bitwise, accounting closes")

    # ---- chaos: transfer and execute faults, retried
    plan = FaultPlan(events=(
        FaultEvent(round=1, kind="transfer_fail", times=2),
        FaultEvent(round=2, kind="execute_fail", times=2),
        FaultEvent(round=3, kind="transfer_fail", times=1),
        FaultEvent(round=3, kind="execute_fail", times=3)))
    injector = ChaosInjector(plan, sleep=lambda s: None)
    chaotic = make_engine(chaos=injector,
                          retry=RetryPolicy(max_retries=3, backoff_base_s=0.0),
                          sleep=lambda s: None)
    hard = 0
    for _ in range(1 + SERVE_ROUNDS):
        submit_round(chaotic)
        try:
            chaotic.pump(force=True)
        except RetriesExhaustedError:
            hard += 1
    while True:
        try:
            chaotic.drain()
            break
        except RetriesExhaustedError:
            hard += 1
    faults = chaotic.serve_report()[-1].get("faults", {})
    check(injector.exhausted() and faults.get("retries") ==
          plan.total_charges(), f"serve chaos: plan not delivered: {faults}")
    check_probes(chaotic, "chaos run")
    print(f"serve chaos: {plan.total_charges()} transfer/execute charges "
          f"fired and retried ({faults}), {hard} exhausted; probes bitwise, "
          f"accounting closes")
    return per_flush


def multichip_fabric(dev, tag, reset_launches, read_launches, no_launch,
                     params, flat_sessions, streams):
    """The multi-chip fabric on the card: `paper_dynaps.scaled_config()`'s
    fabric at chips = MC_CHIPS (16 cores as 4 chips x 4 cores x 256
    neurons x 512 CAM entries, the DYNAP-SE board), on the phase-4 params
    and streams.  Checks, each against the chips=1 sessions of phase 4:
    the ``pallas_sparse`` (B1 once a run, the chip tier inside), ``pallas``
    (B3 once a run, B2 once a tick), ``xla`` and ``xla`` with
    ``shard="chips"`` (no launch) sessions' currents bitwise, their stats
    under the conformance contract; ``"ticks"`` and ``"cores"`` telemetry
    under ``pallas_sparse`` and ``pallas``, bitwise the ``"off"`` run and
    summing back, with inter-chip hops attributed only at chips > 1; a
    `FaultModel` under all three impls, a stream in MC_CHUNKS chunks with
    ``fault_tick0`` bitwise one run, the drop mask on the card bitwise the
    CPU's; two faulted tenants and a ``shard="chips"`` tenant served by
    `ServeEngine`, each bitwise its solo run; the oracle tick on
    MC_ORACLE_TICKS ticks at chips 1 and MC_CHIPS equal to ``xla``.
    Prints host ms per tick of each session beside its chips=1 twin, the
    ``"cores"`` run beside ``"off"``, the faulted run beside the clean one
    and the oracle's ms a tick.  Returns the chips=MC_CHIPS sessions."""
    from repro_torch import traffic
    from repro_torch.ft import FaultModel
    from repro_torch.interface import Interface, pipeline
    from repro_torch.interface.stats import StepStats
    from repro_torch.serve import ServeEngine, TenantSpec
    from repro_torch.serve import default_connectivity

    flat_cfg = flat_sessions["xla"].config
    cfgs = {impl: dataclasses.replace(flat_cfg, impl=impl, chips=MC_CHIPS)
            for impl in ("pallas_sparse", "pallas", "xla")}
    check(cfgs["xla"].cores_per_chip * MC_CHIPS == flat_cfg.cores,
          f"chips={MC_CHIPS}: cores_per_chip {cfgs['xla'].cores_per_chip}")
    sessions = {impl: Interface(c).compile(params, device=dev)
                for impl, c in cfgs.items()}
    tables = sessions["xla"].tables
    check(type(tables).__name__ == "HierTables"
          and tuple(tables.chip_link_table.shape) == (
              flat_cfg.cores * flat_cfg.neurons_per_core, 4),
          f"chips={MC_CHIPS}: tables {type(tables).__name__}")
    ticks = next(iter(streams.values())).shape[0]
    print(f"multichip: {flat_cfg.cores} cores as {MC_CHIPS} chips x "
          f"{cfgs['xla'].cores_per_chip} cores x {flat_cfg.neurons_per_core} "
          f"neurons x {flat_cfg.cam.entries} entries ({flat_cfg.scheme}, "
          f"{flat_cfg.noc.scheme}); link_table "
          f"{tuple(tables.link_table.shape)}, chip_link_table "
          f"{tuple(tables.chip_link_table.shape)}; {int(params.valid.sum())} "
          f"valid CAM entries")

    # ---- sessions: every path bitwise, launches counted
    paths = (("pallas_sparse", sessions["pallas_sparse"], {}),
             ("pallas", sessions["pallas"], {}),
             ("xla", sessions["xla"], {}),
             ("xla shard=chips", sessions["xla"], {"shard": "chips"}),
             ("pallas_sparse shard=chips", sessions["pallas_sparse"],
              {"shard": "chips"}))
    want_launches = {"pallas_sparse": {**no_launch, "sparse_tick": 1},
                     "pallas": {**no_launch, "cam_search": ticks,
                                "hat_encode": 1}}
    results = {}
    for name, stream in streams.items():
        flat_cur, flat_st = flat_sessions["xla"].run(stream)
        for label, session, kw in paths:
            reset_launches()
            cur, st = session.run(stream, **kw)
            torch.cuda.synchronize()
            got = read_launches()
            check(got == want_launches.get(label, no_launch),
                  f"chips={MC_CHIPS} {label} {name}: launches {got}")
            check(torch.equal(cur, flat_cur),
                  f"chips={MC_CHIPS} {label} {name}: currents differ from "
                  f"the chips=1 xla session")
            for field in MC_INVARIANT_FIELDS:
                check_field(f"chips={MC_CHIPS} {label} {name} vs chips=1",
                            field, getattr(st, field), getattr(flat_st, field))
            results[(name, label)] = st
        ref = results[(name, "xla")]
        check(float(ref.chip_hops) > 0 and float(flat_st.chip_hops) == 0,
              f"{name}: chip_hops {float(ref.chip_hops)} at chips="
              f"{MC_CHIPS}, {float(flat_st.chip_hops)} at one chip")
        for label, _, _ in paths:
            check_stats(f"chips={MC_CHIPS} {label} {name} vs xla",
                        results[(name, label)], ref)
        print(f"chips={MC_CHIPS} {name}: pallas_sparse (1 sparse_run launch), "
              f"pallas (1 hat_run, {ticks} cam_search), xla, and xla and "
              f"pallas_sparse with shard='chips' (no launch) == the chips=1 "
              f"xla session's currents bitwise, the partition-invariant "
              f"stats under the contract, the transport stats among "
              f"themselves; per-tick means {json.dumps(ref.summary(ticks=ticks))}")

    # ---- telemetry under pallas_sparse and pallas at chips > 1
    burst = streams["burst_every_16"]
    cores_by_impl = {}
    for impl in ("pallas_sparse", "pallas"):
        session = sessions[impl]
        cur_off, st_off = session.run(burst)
        for mode in ("ticks", "cores"):
            reset_launches()
            cur, st, tel = session.run(burst, telemetry=mode)
            torch.cuda.synchronize()
            got = read_launches()
            check(got == want_launches[impl],
                  f"telemetry {mode} {impl}: launches {got}")
            check(torch.equal(cur, cur_off) and all(
                torch.equal(a, b) for a, b in zip(st, st_off)),
                f"telemetry {mode} {impl}: currents or stats differ from "
                f"telemetry='off'")
            for field in StepStats._fields:
                series = getattr(tel.per_tick, field)
                total = torch.zeros((), device=dev)
                for t in range(series.shape[0]):
                    total = total + series[t]
                check(torch.equal(total, getattr(st, field)),
                      f"telemetry {mode} {impl}: {field} series does not sum "
                      f"back in tick order")
            if mode == "cores":
                pc, pt = tel.per_core, tel.per_tick
                check(pc.events.shape == (ticks, flat_cfg.cores)
                      and torch.equal(pc.events.sum(-1), pt.events)
                      and torch.equal(pc.noc_hops.sum(-1), pt.noc_hops)
                      and torch.equal(pc.chip_hops.sum(-1), pt.chip_hops)
                      and torch.equal(pc.encode_latency.amax(-1),
                                      pt.encode_latency)
                      and torch.allclose(pc.encode_energy.sum(-1),
                                         pt.encode_energy, rtol=REL_TOL,
                                         atol=0)
                      and float(pc.chip_hops.sum()) > 0,
                      f"telemetry cores {impl}: the breakdown does not sum "
                      f"back to the per-tick totals")
                cores_by_impl[impl] = pc
    for field in cores_by_impl["pallas"]._fields:
        a = getattr(cores_by_impl["pallas_sparse"], field)
        b = getattr(cores_by_impl["pallas"], field)
        check(torch.allclose(a, b, rtol=REL_TOL, atol=0),
              f"telemetry cores: pallas_sparse {field} differs from pallas")
    flat_tel = flat_sessions["pallas_sparse"].run(burst, telemetry="cores")[2]
    check(float(flat_tel.per_core.chip_hops.abs().sum()) == 0.0,
          "telemetry cores at one chip attributes inter-chip hops")
    print(f"telemetry ticks and cores at chips={MC_CHIPS} on {ticks} burst "
          f"ticks, pallas_sparse (B1's rows and per-core output) and pallas "
          f"(B3's terms): currents and stats bitwise telemetry='off', series "
          f"summed in tick order bitwise the accumulated stats, per-core "
          f"breakdowns summing back, chip_hops attributed "
          f"({float(cores_by_impl['pallas'].chip_hops.sum()):.0f}) and 0 at "
          f"one chip; the two impls' breakdowns agree")

    # ---- faults under all three impls
    fault = FaultModel(dead_cores=(3,), drop_rate=0.1,
                       corrupt_cam_entries=64, seed=7)
    faulted = {impl: Interface(c).compile(params, device=dev, fault=fault)
               for impl, c in cfgs.items()}
    stream = streams["bernoulli_0.05"]
    live = np.ones(ticks, bool)
    whole = {}
    for impl, session in faulted.items():
        cur, st = session.run(stream, mask=live)
        acc, parts = None, []
        for lo in range(0, ticks, ticks // MC_CHUNKS):
            hi = lo + ticks // MC_CHUNKS
            # each chunk's offset a tensor kept on the card
            c, acc = session.run(stream[lo:hi],
                                 fault_tick0=torch.tensor(lo, device=dev),
                                 mask=live[lo:hi], stats0=acc)
            parts.append(c)
        check(torch.equal(torch.cat(parts), cur) and all(
            torch.equal(a, b) for a, b in zip(acc, st)),
            f"fault {impl}: {MC_CHUNKS} chunks with fault_tick0 differ from "
            f"one run")
        check(float(cur[:, 3].abs().max()) == 0.0,
              f"fault {impl}: dead core 3 received current")
        whole[impl] = (cur, st)
    for impl in ("pallas_sparse", "pallas"):
        check(torch.equal(whole[impl][0], whole["xla"][0]),
              f"fault: {impl} currents differ from xla")
        check_stats(f"fault {impl} vs xla", whole[impl][1], whole["xla"][1])
    lanes = torch.stack([stream, streams["burst_every_16"]])
    tick0 = torch.tensor([0, 1000], device=dev)
    lane = torch.arange(2, device=dev)
    on_card = fault.apply_spikes(lanes, tick0=tick0, lane=lane)
    on_cpu = fault.apply_spikes(lanes.cpu(), tick0=tick0.cpu(),
                                lane=lane.cpu())
    check(torch.equal(on_card.cpu(), on_cpu),
          "fault: the drop mask on the card differs from the CPU's")
    clean_events = float(sessions["xla"].run(stream)[1].events)
    print(f"fault {fault.describe()} at chips={MC_CHIPS}: xla, pallas, "
          f"pallas_sparse currents bitwise (stats under the contract); "
          f"{MC_CHUNKS} chunks with fault_tick0 bitwise one run; dead core "
          f"silent; events {float(whole['xla'][1].events):.0f} of "
          f"{clean_events:.0f}; the drop mask of 2 lanes x {ticks} ticks on "
          f"the card bitwise the CPU's")

    # ---- faulted and sharded tenants, served
    names = traffic.scenario_names()
    specs = [TenantSpec("faulted_sparse", cfgs["pallas_sparse"],
                        scenario=names[0], seed=0, fault=fault),
             TenantSpec("faulted_pallas", cfgs["pallas"], scenario=names[3],
                        seed=1, fault=FaultModel(dead_cores=(5,),
                                                 drop_rate=0.05, seed=11)),
             TenantSpec("sharded", cfgs["xla"], scenario=names[2], seed=2,
                        shard="chips")]
    engine = ServeEngine(flush_ticks=SERVE_FLUSH, flush_deadline_s=0.0,
                         keep_currents=True, device=dev)
    for spec in specs:
        engine.register(spec)
    check(len(engine.groups) == len(specs), "multichip serve: groups")
    for spec in specs:
        engine.submit_scenario(spec.name, MC_SERVE_TICKS)
    engine.drain()
    for spec in specs:
        solo = Interface(spec.config).compile(
            default_connectivity(spec.config, spec.connectivity_seed),
            device=dev, fault=spec.fault)
        kw = ({"shard": "chips"} if spec.shard else {"fault_tick0": 0})
        cur, st = solo.run(spec.stream(MC_SERVE_TICKS, round=0).to(dev), **kw)
        check(np.array_equal(engine.currents(spec.name), cur.cpu().numpy()),
              f"multichip serve: {spec.name} currents differ from its solo "
              f"run")
        mine = [float(f) for f in engine.tenant_stats(spec.name)]
        check(mine == [float(f) for f in st],
              f"multichip serve: {spec.name} stats differ from its solo run")
    check(engine.accounting()["closes"], "multichip serve: accounting")
    print(f"multichip serve: tenants {[s.name for s in specs]} "
          f"({[s.scenario for s in specs]}; two with a FaultModel, one with "
          f"shard='chips'), {MC_SERVE_TICKS} ticks each in flushes of "
          f"{SERVE_FLUSH}: each bitwise its solo run (currents and stats); "
          f"accounting closes")

    # ---- the oracle: the simulator and the dense tag sweep
    oracle_ms = {}
    frames = burst[:MC_ORACLE_TICKS]
    for chips in (1, MC_CHIPS):
        cfg = dataclasses.replace(flat_cfg, impl="xla", chips=chips)
        ref = (flat_sessions["xla"] if chips == 1 else sessions["xla"]).run(
            frames)
        tables = pipeline.build_tables(params, cfg)
        acc, cur = StepStats.zeros(device=dev), []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for frame in frames:
            c, st = pipeline.interface_tick(params, frame, cfg, tables,
                                            oracle=True)
            acc, cur = acc.accumulate(st), cur + [c]
        torch.cuda.synchronize()
        oracle_ms[chips] = (time.perf_counter() - t) * 1e3 / len(frames)
        check(torch.equal(torch.stack(cur), ref[0]),
              f"oracle chips={chips}: currents differ from xla")
        check_stats(f"oracle chips={chips} vs xla", acc, ref[1])
    print(f"oracle (arbiter simulator + dense packed-tag sweep) on "
          f"{MC_ORACLE_TICKS} burst ticks at chips 1 and {MC_CHIPS}: currents "
          f"bitwise xla, stats under the contract")

    # ---- times
    def host_ms(fn, stream):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(stream)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / stream.shape[0]

    def interleaved(label, runs, stream):
        for fn in runs.values():
            fn(stream)                              # warm-up
        samples = {k: [] for k in runs}
        for _ in range(MC_RUNS):
            for k, fn in runs.items():
                samples[k].append(host_ms(fn, stream))
        for k, ms in samples.items():
            q1, med, q3 = statistics.quantiles(ms, n=4)
            print(f"{tag} {label} {k}: median {med:.4f} ms/tick (quartiles "
                  f"{q1:.4f}-{q3:.4f}; host clock, {MC_RUNS} runs of "
                  f"{stream.shape[0]} Bernoulli {RATE} ticks interleaved, "
                  f"synchronized)")

    interleaved("session", {
        **{f"{impl} chips=1": flat_sessions[impl].run
           for impl in ("pallas_sparse", "pallas", "xla")},
        **{f"{impl} chips={MC_CHIPS}": sessions[impl].run
           for impl in ("pallas_sparse", "pallas", "xla")},
        f"xla shard=chips chips={MC_CHIPS}":
            lambda s: sessions["xla"].run(s, shard="chips")}, stream)
    interleaved(f"telemetry chips={MC_CHIPS}", {
        f"{impl} {mode}": (lambda s, impl=impl, mode=mode:
                           sessions[impl].run(s, telemetry=mode))
        for impl in ("pallas_sparse", "pallas") for mode in ("off", "cores")},
        stream)
    interleaved(f"fault chips={MC_CHIPS}", {
        **{f"{impl} clean": sessions[impl].run for impl in cfgs},
        **{f"{impl} faulted": faulted[impl].run for impl in cfgs}}, stream)
    print(f"{tag} oracle: " + ", ".join(
        f"chips={c} {ms:.3f} ms/tick" for c, ms in oracle_ms.items())
          + f" (host clock, {MC_ORACLE_TICKS} ticks, synchronized)")
    return sessions


def trained_snn(dev, tag, reset_launches, read_launches, no_launch, root):
    """The paper's SNN trained on the card at `paper_dynaps.scaled_config`
    through the port's example (examples/snn_multicore_torch.py): its
    40 AdamW steps at batch 32 (TF32 refused), the accounted evaluation
    on 128 samples through B4 (lif_step, once a step) and B1 (sparse_tick,
    once a run), each held to ``impl="xla"``; one step on the card
    against the CPU port; two uninterrupted runs bitwise equal, and the
    restart drill (a failure injected at step 7, checkpoints every 2
    steps) bitwise equal to them; then host ms per step, its split, one
    step's device profile and the placement optimizer's host time.
    Returns the launches of B4 and B1 in the example's run."""
    import tempfile

    sys.path.insert(0, os.path.join(root, "examples"))
    import snn_multicore_torch as example
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.ckpt.manager import tree_leaves
    from repro_torch.configs import paper_dynaps
    from repro_torch.data.pipeline import SNNPipeline
    from repro_torch.ft import FailureInjector, run_with_restarts
    from repro_torch.interface import Interface
    from repro_torch.models import snn
    from repro_torch.noc import placement
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.optim import adamw

    cfg = paper_dynaps.scaled_config()
    eval_cfg = example.eval_config(cfg)
    opt_cfg = example.OPT_CFG
    fabric = cfg.fabric

    def fresh(device):
        params, topo = snn.init_snn(torch.Generator().manual_seed(0), cfg,
                                    device=device)
        return (params, adamw.init(opt_cfg, params)), topo

    def bitwise(a, b):
        return all(x.dtype == y.dtype and torch.equal(x, y)
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    state0, topo = fresh(dev)
    step = functools.partial(snn.train_step, topology=topo, cfg=cfg,
                             opt_cfg=opt_cfg)
    pipe = SNNPipeline(cfg, example.TRAIN_BATCH, seed=1, device=dev)
    step(state0, pipe.batch(0))      # warm-up, its result dropped
    torch.cuda.synchronize()

    # the example: train, then the accounted evaluation
    reset_launches()
    out = example.main(cfg, TRAIN_STEPS, dev, eval_batch=TRAIN_EVAL_BATCH)
    torch.cuda.synchronize()
    launches = read_launches()
    want = {**no_launch, "lif_step": cfg.t_steps, "sparse_tick": 1}
    check(launches == want, f"trained snn example launches {launches}: "
          f"want lif_step once per step and sparse_tick once (the "
          f"accounted run), nothing else")
    losses = out["losses"]
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"training losses not finite: {losses}")
    logits, rates = out["logits"], out["rates"]
    check(logits.shape == (TRAIN_EVAL_BATCH, cfg.d_out) and
          bool(logits.isfinite().all()) and 0 < float(rates.mean()) < 1,
          "trained snn evaluation: shapes, finite, rates in (0, 1)")
    print(f"main path train snn (examples/snn_multicore_torch.py) at "
          f"scaled_config ({cfg.n_total} neurons, {cfg.t_steps} steps): "
          f"{TRAIN_STEPS} steps at batch {example.TRAIN_BATCH}, loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}, accuracy "
          f"{out['accuracy']:.4f} on {TRAIN_EVAL_BATCH} samples; launches "
          f"over the example's run {launches}")

    # the accounted evaluation against impl="xla": spikes, rates, logits
    # bitwise; the replay's currents bitwise, stats under the contract
    params, topo_ = out["params"], out["topology"]
    x = out["eval_batch"]["x"]
    with torch.no_grad():
        xla_logits, xla_rates, xla_stats = snn.snn_forward(
            params, topo_, x, cfg, impl="xla", account=True)
        r_mat = snn.routing_matrix(snn.fabric_params(params, topo_), fabric)
        raster = {impl: snn.spike_raster(params, r_mat, x, cfg, impl=impl)
                  for impl in ("pallas", "xla")}
    for name, a, b in (("spikes", *raster.values()),
                       ("rates", rates, xla_rates),
                       ("logits", logits, xla_logits)):
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              f"trained snn pallas {name} != xla on the card")
    check_stats("trained snn account pallas_sparse vs xla", out["stats"],
                xla_stats)
    ticks = TRAIN_EVAL_BATCH * cfg.t_steps
    frames = raster["pallas"].reshape(ticks, fabric.cores,
                                      fabric.neurons_per_core) > 0.5
    fab = snn.fabric_params(params, topo_)
    sessions = {c.impl: Interface(c).compile(fab, device=dev)
                for c in (eval_cfg.fabric, fabric)}
    replay = {impl: s_.run(frames) for impl, s_ in sessions.items()}
    capacity = sessions["pallas_sparse"].plan.run.capacity
    check(torch.equal(replay["pallas_sparse"][0], replay["xla"][0]),
          "trained snn replay: pallas_sparse currents != xla")
    check_stats("trained snn replay pallas_sparse vs xla",
                replay["pallas_sparse"][1], replay["xla"][1])
    overflow = int((frames.sum(-1) > capacity).any(-1).sum())
    print(f"trained snn evaluation: impl=pallas == xla on the card "
          f"(spikes, rates, logits bitwise); the {ticks}-tick replay "
          f"through pallas_sparse == xla (currents bitwise, stats under "
          f"the conformance contract; {overflow} ticks past capacity "
          f"{capacity} "
          f"take the dense fallback); per-tick means "
          f"{json.dumps(out['stats'].summary())}")

    # one step on the card against the CPU port, from the same parameters
    # and batch, on the samples whose rasters flip no spike
    batch = pipe.batch(0)
    cpu_state, cpu_topo = fresh("cpu")
    with torch.no_grad():
        card_r = snn.routing_matrix(snn.fabric_params(state0[0], topo),
                                    fabric)
        cpu_r = snn.routing_matrix(snn.fabric_params(cpu_state[0],
                                                     cpu_topo), fabric)
        flips = (snn.spike_raster(state0[0], card_r, batch["x"], cfg).cpu()
                 != snn.spike_raster(cpu_state[0], cpu_r,
                                     batch["x"].cpu(), cfg))
    flipped = flips.flatten(1).sum(1)
    same = flipped == 0
    check(int(same.sum()) >= 2, f"fewer than 2 of {len(same)} samples "
          f"without a flipped spike: {flipped.tolist()}")
    sub = {k: v[same.to(dev)] for k, v in batch.items()}
    sub_cpu = {k: v.cpu() for k, v in sub.items()}
    grads = {}
    for label, state, topo_x, b in (("card", state0, topo, sub),
                                    ("cpu", cpu_state, cpu_topo, sub_cpu)):
        p = {k: v.detach().requires_grad_() for k, v in state[0].items()}
        loss = snn.snn_loss(p, topo_x, b, cfg)
        grads[label] = (loss.detach().cpu(),
                        {k: g.cpu() for k, g in
                         snn.loss_gradients(loss, p).items()})
    (card_new, _), card_m = step(state0, sub)
    (cpu_new, _), cpu_m = snn.train_step(cpu_state, sub_cpu, cpu_topo, cfg,
                                         opt_cfg)
    lr = float(cpu_m["lr"])
    card_rule, _, _ = adamw.update(opt_cfg, grads["card"][1], cpu_state[1],
                                   cpu_state[0])
    loss_gap = abs(float(grads["card"][0]) - float(grads["cpu"][0]))
    check(torch.allclose(grads["card"][0], grads["cpu"][0], rtol=1e-5,
                         atol=1e-6) and torch.equal(card_m["loss"].cpu(),
                                                    grads["card"][0]),
          f"train step loss card vs CPU beyond rtol 1e-5 / atol 1e-6: "
          f"{loss_gap}")
    gaps = []
    for k in sorted(card_new):
        gc, gp = grads["card"][1][k], grads["cpu"][1][k]
        tol = GRAD_ATOL * float(gp.abs().max()) + GRAD_RTOL * gp.abs()
        g_gap = (gc - gp).abs()
        check(bool((g_gap <= tol).all()), f"train step gradient {k} card "
              f"vs CPU: max gap {float(g_gap.max())} beyond rtol "
              f"{GRAD_RTOL} + {GRAD_ATOL} of the leaf's largest")
        p_gap = (card_new[k].cpu() - cpu_new[k]).abs()
        p_tol = 1e-6 * float(cpu_new[k].abs().max())
        moved = 2 * lr * (tol / gp.abs()).nan_to_num(1.0).clamp(max=1.0)
        check(bool((p_gap <= p_tol + moved).all()),
              f"train step params {k} card vs CPU: max gap "
              f"{float(p_gap.max())}")
        r_gap = (card_new[k].cpu() - card_rule[k]).abs()
        check(bool((r_gap <= p_tol).all()),
              f"train step params {k}: the card's update of its own "
              f"gradient vs the CPU port's adamw.update of it: max gap "
              f"{float(r_gap.max())} beyond {p_tol}")
        gaps.append(f"{k}: grad {float(g_gap.max()):.3e} (largest "
                    f"{float(gp.abs().max()):.3e}), params "
                    f"{float(p_gap.max()):.3e}, {int((p_gap > p_tol).sum())}"
                    f" of {p_gap.numel()} beyond 1e-6 of the largest, "
                    f"{int((moved >= 2 * lr).sum())} with |g| <= tol "
                    f"(allowed the full 2 lr); update of the card's "
                    f"gradient {float(r_gap.max()):.3e}")
    print(f"train step card vs CPU port at scaled_config on the "
          f"{int(same.sum())} of {len(same)} samples of batch 0 without a "
          f"flipped spike (flips per sample {flipped.tolist()}): loss gap "
          f"{loss_gap:.3e} (rtol 1e-5 / atol 1e-6); largest gaps " +
          "; ".join(gaps))

    # determinism and the restart drill
    def run(steps):
        state = state0
        for i in range(steps):
            state, _ = step(state, pipe.batch(i))
        return state
    first, second = run(DRILL_STEPS), run(DRILL_STEPS)
    check(bitwise(first, second), f"two uninterrupted {DRILL_STEPS}-step "
          f"runs on the card differ")
    registry, logs = MetricsRegistry(), []
    with tempfile.TemporaryDirectory() as d:
        manager = CheckpointManager(d, every=DRILL_EVERY, keep=5)
        injector = FailureInjector(fail_at_steps=(DRILL_FAIL_AT,),
                                   registry=registry)
        drilled, history = run_with_restarts(
            lambda: fresh(dev)[0], step, pipe, num_steps=DRILL_STEPS,
            manager=manager, injector=injector, logger=logs.append)
        saved = sorted(os.listdir(d))
    resumed = DRILL_FAIL_AT - DRILL_FAIL_AT % DRILL_EVERY
    check(any(f"resumed from step {resumed}" in line for line in logs)
          and registry.counters["ft.injected_failures"].value == 1
          and len(history) == DRILL_STEPS - resumed,
          f"restart drill: {logs}")
    check(drilled[0]["w_in"].device == first[0]["w_in"].device
          and bitwise(drilled, first),
          "restart drill's final state != the uninterrupted run's")
    print(f"train snn on the card: two uninterrupted {DRILL_STEPS}-step "
          f"runs bitwise equal; run_with_restarts with a failure at step "
          f"{DRILL_FAIL_AT}, checkpoints every {DRILL_EVERY} steps (async "
          f"writer; {len(saved)} files kept), resumed from step {resumed}, "
          f"final state bitwise the uninterrupted run's")

    # times
    q1, med, q3 = statistics.quantiles(out["step_ms"], n=4)
    print(f"{tag} train snn scaled_config batch {example.TRAIN_BATCH}: "
          f"median {med:.4f} ms/step (quartiles {q1:.4f}-{q3:.4f}; host "
          f"clock, the example's {TRAIN_STEPS} steps after one warm-up "
          f"step, each ending in a synchronize)")
    stages = (("forward (snn_loss)", snn, "snn_loss"),
              ("  of it routing_matrix", snn, "routing_matrix"),
              ("  of it the step loop (spike_raster)", snn, "spike_raster"),
              ("backward (loss_gradients)", snn, "loss_gradients"),
              ("update (adamw.update)", adamw, "update"))
    total, spent = host_breakdown(lambda: run(TRAIN_SPLIT_STEPS), stages)
    top = sum(v for k, v in spent.items() if not k.startswith(" "))
    parts = "; ".join(f"{k.strip()} {v * 1e3 / TRAIN_SPLIT_STEPS:.3f}"
                      for k, v in spent.items())
    print(f"{tag} host ms per train step (mean of {TRAIN_SPLIT_STEPS}): "
          f"total {total * 1e3 / TRAIN_SPLIT_STEPS:.3f} = {parts}; batch "
          f"and the rest {(total - top) * 1e3 / TRAIN_SPLIT_STEPS:.3f}")
    wall_us, events = device_events(lambda: step(state0, batch))
    check(bool(events), "the profiler recorded no device op in a train step")
    busy_us = sum(e.device_time_total for e in events)
    by_name = {}
    for e in events:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.device_time_total, count + 1)
    print(f"{tag} profile train step: wall {wall_us:.1f} us (host clock, "
          f"profiler on), device busy {busy_us:.1f} us in {len(events)} "
          f"device ops, idle share {1 - busy_us / wall_us:.4f}")
    for key, (us, count) in sorted(by_name.items(),
                                   key=lambda r: -r[1][0])[:8]:
        print(f"{tag}   {us:10.1f} us  x{count:5d}  {key[:90]}")
    a = placement.fanout_adjacency(fab, fabric)
    t = time.perf_counter()
    perm = placement.greedy_overlap_placement(a, fabric.cores,
                                              fabric.neurons_per_core)
    place_s = time.perf_counter() - t
    costs = {name: placement.traffic_cost(a, p_, fabric.cores,
                                          fabric.neurons_per_core)
             for name, p_ in (("identity", placement.identity_placement(
                 cfg.n_total)), ("greedy", perm))}
    print(f"{tag} greedy_overlap_placement at {cfg.n_total} neurons: "
          f"{place_s:.4f} s host (numpy); traffic_cost identity "
          f"{costs['identity']:.0f} -> greedy {costs['greedy']:.0f}")
    return {name: launches[name] for name in ("lif_step", "sparse_tick")}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.configs import deepseek_v2_lite_16b, paper_dynaps
    from repro_torch.core import arbiter as arb
    from repro_torch.data.pipeline import snn_batch
    from repro_torch.interface import Interface, InterfaceConfig, pipeline
    from repro_torch.interface import session as session_mod
    from repro_torch.interface.stats import StepStats
    from repro_torch.interface.types import random_connectivity
    from repro_torch.kernels import build
    from repro_torch.kernels.cam_search import kernel as cam_kernel
    from repro_torch.kernels.cam_search import ops as cam_ops
    from repro_torch.kernels.cam_search import ref as cam_ref
    from repro_torch.kernels.hat_encode import kernel as hat_kernel
    from repro_torch.kernels.hat_encode import ops as hat_ops
    from repro_torch.kernels.hat_encode import ref as hat_ref
    from repro_torch.kernels.lif_step import kernel as lif_kernel
    from repro_torch.kernels.lif_step import ops as lif_ops
    from repro_torch.kernels.lif_step import ref as lif_ref
    from repro_torch.kernels.moe_dispatch import kernel as moe_kernel
    from repro_torch.kernels.moe_dispatch import ref as moe_ref
    from repro_torch.kernels.sparse_tick import kernel as sparse_kernel
    from repro_torch.kernels.sparse_tick import ops as sparse_ops
    from repro_torch.kernels.sparse_tick import ref as sparse_ref
    from repro_torch.models import snn
    from repro_torch.noc import router as noc_router
    from repro_torch.noc.topology import NocConfig

    kernel_modules = {"sparse_tick": sparse_kernel, "cam_search": cam_kernel,
                      "hat_encode": hat_kernel, "lif_step": lif_kernel,
                      "moe_dispatch": moe_kernel}
    # the one-tick sparse and hat_encode ops keep their own counts: no path
    # launches them
    no_launch = dict.fromkeys((*kernel_modules, "sparse_tick_one_tick",
                               "hat_encode_one_tick"), 0)
    lm_cfg = deepseek_v2_lite_16b.config()

    def reset_launches():
        for module in kernel_modules.values():
            module.launches = 0
        sparse_kernel.tick_launches = 0
        hat_kernel.tick_launches = 0

    def read_launches():
        return {**{name: m.launches for name, m in kernel_modules.items()},
                "sparse_tick_one_tick": sparse_kernel.tick_launches,
                "hat_encode_one_tick": hat_kernel.tick_launches}

    torch.backends.cuda.matmul.allow_tf32 = False
    # bfloat16 products sum in float32 and round once, as the JAX package's
    # preferred_element_type=float32 asks
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = card_line()
    tag = f"[{card}]"
    print(f"card: {card}; torch device: {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__} CUDA {torch.version.cuda}")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    nvcc_s = build.ensure_built(*kernel_modules, "launch_floor")
    print(f"build: {time.perf_counter() - t0:.3f} s for {len(nvcc_s)} "
          f"sources in parallel (nvcc " + ", ".join(
              f"{k} {'already built' if v is None else f'{v:.3f} s'}"
              for k, v in nvcc_s.items()) + ")")
    for name in nvcc_s:
        for line in build.ptxas_report(name).splitlines():
            if "Used" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    def config(scheme, cores=CORES, impl="pallas_sparse",
               noc="multicast_tree"):
        return InterfaceConfig(cores=cores, neurons_per_core=NEURONS,
                               cam_entries_per_core=ENTRIES, scheme=scheme,
                               noc=NocConfig(noc), impl=impl)

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

    def kernel_call(args, policy):
        return sparse_kernel.sparse_tick_cuda(
            *args, n=NEURONS, policy=policy.kernel_policy,
            levels=policy.levels)

    def plain_call(args, policy):
        return sparse_ref.sparse_tick_ref(*args, n=NEURONS,
                                          latency_fn=policy.latency_fn,
                                          encode_fn=policy.encode_fn)

    # ---- 3. kernels against their plain versions, on the card -------------
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    max_err = dict.fromkeys(kernel_modules, 0.0)
    # the one-tick op's largest gap, printed on its own: the kernels line's
    # B1 row is the whole-run kernel (run_gap)
    tick_err = 0.0
    cases = [(s, CORES) for s in SCHEMES] + [("hier_tree", 4 * CORES)]
    for scheme, cores in cases:
        frame = torch.rand((1, cores, NEURONS), generator=gen,
                           device=dev) < RATE
        args, policy, _ = operands(config(scheme, cores), frame,
                                   SEED + cores)
        got, want = kernel_call(args, policy), plain_call(args, policy)
        torch.cuda.synchronize()
        for name, g, w in zip(("currents", "latency", "encode", "hits"),
                              got, want):
            check(torch.equal(g, w), f"{scheme}/{cores} cores: {name} differ")
            tick_err = max(tick_err, float((g - w).abs().max()))
        print(f"kernel == plain: sparse_tick {scheme} "
              f"{cores}x{NEURONS}x{ENTRIES} (currents bitwise, "
              f"latency/energy/hits exact)")
    print(f"kernel vs plain: sparse_tick one-tick op (sparse_tick_kernel), "
          f"largest absolute gap {tick_err}")

    def run_both(plan, params, stream, overflow, acc0=None):
        """The whole-run kernel and its plain version on the same frames,
        the dense fallback's rows written alike first, both sums seeded by
        ``acc0`` when given."""
        lanes, ticks = stream.shape[:2]
        cur = torch.full(tuple(stream.shape), math.nan, device=dev)
        table = torch.full((ticks, len(StepStats._fields), lanes), math.nan,
                           device=dev)
        for t in range(ticks):
            if overflow[t]:
                c, st = pipeline.dense_tick(plan, params, stream[:, t])
                cur[:, t], table[t] = c, torch.stack(tuple(st))
        plain = (cur.clone(), table.clone())
        sparse = [t for t in range(ticks) if not overflow[t]]
        index = None if len(sparse) == ticks else torch.tensor(
            sparse, dtype=torch.int32, device=dev)
        acc = sparse_kernel.sparse_run_cuda(stream, index, plan.run.kernel,
                                            cur, table, acc0)
        want = sparse_ops.sparse_run_ref(stream, sparse, plan.run, *plain,
                                         acc0)
        torch.cuda.synchronize()
        return (cur, table, acc), (*plain, want)

    whole = [StepStats._fields.index(f) for f in WHOLE_FIELDS]

    def seed_acc(lanes):
        """A (12, B) accumulator seed as a served lane carries it: whole
        numbers in the whole-number fields, fractions in the rest."""
        acc0 = torch.rand((len(StepStats._fields), lanes), generator=gen,
                          device=dev) * 1000
        acc0[whole] = acc0[whole].round()
        return acc0

    def seeded_gap(label, plan, params, stream, overflow):
        """`run_gap` of the kernel and its plain version seeded by one
        non-zero seed; the seeded sums also bitwise, each the kernel's own
        table summed in tick order from the seed, and the seed unwritten.
        Returns (the kernel's outputs, the seed, `run_gap`'s result)."""
        acc0 = seed_acc(stream.shape[0])
        kept = acc0.clone()
        got, want = run_both(plan, params, stream, overflow, acc0)
        out = run_gap(label, got, want)
        check(torch.equal(got[2], want[2]),
              f"{label}: seeded sums differ from the plain version's")
        check(torch.equal(got[2], sparse_ref.sum_in_tick_order(got[1], acc0)),
              f"{label}: the seeded sum is not its table's, in tick order "
              f"from the seed")
        check(torch.equal(acc0, kept) and got[2].data_ptr() != acc0.data_ptr(),
              f"{label}: the kernel wrote its seed")
        return got, acc0, out

    def run_gap(label, got, want):
        """Currents bitwise, whole-number stats exact, the rest within
        REL_TOL; returns (largest relative gap, every stat bitwise).  The
        largest absolute gap of currents and stats goes to the kernels
        line's B1 row."""
        check(torch.equal(got[0], want[0]), f"{label}: currents differ")
        gap, bitwise = 0.0, True
        for g, w in zip(got, want):
            max_err["sparse_tick"] = max(max_err["sparse_tick"],
                                         float((g - w).abs().max()))
        for g, w in zip(got[1:], want[1:]):
            g, w = g.movedim(-2, 0), w.movedim(-2, 0)    # fields first
            check(bool(g.isfinite().all()), f"{label}: stats not finite")
            for f, field in enumerate(StepStats._fields):
                diff = (g[f] - w[f]).abs()
                if field in WHOLE_FIELDS:
                    check(torch.equal(g[f], w[f]), f"{label}: {field}")
                else:
                    rel = torch.where(w[f] == 0, diff, diff / w[f].abs())
                    gap = max(gap, float(rel.max()))
            bitwise = bitwise and torch.equal(g, w)
        check(gap <= REL_TOL, f"{label}: stats beyond {REL_TOL}: {gap}")
        return gap, bitwise

    # the whole-run sparse tick: every arbiter x NoC pair at 16 and 64
    # cores, two lanes of a stream whose RUN_BURST ticks overflow
    for cores in (CORES, 4 * CORES):
        params = random_connectivity(
            torch.Generator(dev).manual_seed(SEED + cores), config(
                "hier_tree", cores))
        routing = pipeline.build_routing_index(params, config("hier_tree",
                                                              cores))
        frames = torch.rand((RUN_LANES, RUN_TICKS, cores, NEURONS),
                            generator=gen, device=dev) < RATE
        gap, bitwise, pairs = 0.0, True, 0
        for noc in NOC_SCHEMES:
            tables = pipeline.build_tables(params, config("hier_tree", cores,
                                                          noc=noc))
            for scheme in SCHEMES:
                cfg = config(scheme, cores, noc=noc)
                plan = pipeline.make_plan(params, cfg, tables=tables,
                                          routing=routing)
                stream = frames & (frames.to(torch.int32).cumsum(-1)
                                   <= plan.run.capacity)
                stream[:, list(RUN_BURST)] = True
                overflow = [t in RUN_BURST for t in range(RUN_TICKS)]
                g, b = run_gap(f"sparse_run {scheme}/{noc}/{cores}",
                               *run_both(plan, params, stream, overflow))
                _, _, (g2, b2) = seeded_gap(
                    f"seeded sparse_run {scheme}/{noc}/{cores}", plan,
                    params, stream, overflow)
                gap, bitwise = max(gap, g, g2), bitwise and b and b2
                pairs += 1
        print(f"kernel vs plain: sparse_run, {pairs} arbiter x NoC pairs at "
              f"{cores}x{NEURONS}x{ENTRIES}, {RUN_LANES} lanes x {RUN_TICKS} "
              f"ticks (ticks {RUN_BURST} overflow), each unseeded and seeded "
              f"by a non-zero acc0 (seeded sums bitwise, seed unwritten): "
              f"currents bitwise, whole-number stats exact, largest relative "
              f"gap of the rest {gap:.3e} (limit {REL_TOL}); every stat "
              f"bitwise: {bitwise}")

    # the whole-run sparse tick with the inter-chip tier inside: every
    # arbiter x NoC pair at the scaled fabric split into 2 and MC_CHIPS
    # chips, two lanes of a stream whose RUN_BURST ticks overflow; every
    # output bitwise its plain version's, and the chip fields non-zero
    chip_gap, chip_pairs = 0.0, 0
    params = random_connectivity(torch.Generator(dev).manual_seed(SEED),
                                 config("hier_tree"))
    routing = pipeline.build_routing_index(params, config("hier_tree"))
    frames = torch.rand((RUN_LANES, RUN_TICKS, CORES, NEURONS),
                        generator=gen, device=dev) < RATE
    for chips in (2, MC_CHIPS):
        for noc in NOC_SCHEMES:
            tables = pipeline.build_tables(params, dataclasses.replace(
                config("hier_tree", noc=noc), chips=chips))
            for scheme in SCHEMES:
                cfg = dataclasses.replace(config(scheme, noc=noc),
                                          chips=chips)
                plan = pipeline.make_plan(params, cfg, tables=tables,
                                          routing=routing)
                check(plan.run.kernel.chip_hops is not None,
                      f"chips={chips}: the plan has no chip tier")
                stream = frames & (frames.to(torch.int32).cumsum(-1)
                                   <= plan.run.capacity)
                stream[:, list(RUN_BURST)] = True
                overflow = [t in RUN_BURST for t in range(RUN_TICKS)]
                got, want = run_both(plan, params, stream, overflow)
                label = f"sparse_run chip tier {scheme}/{noc}/chips={chips}"
                for g, w in zip(got, want):
                    check(torch.equal(g, w), f"{label}: differs from the "
                          f"plain version")
                    chip_gap = max(chip_gap, float((g - w).abs().max()))
                sparse_rows = [t for t in range(RUN_TICKS) if not overflow[t]]
                check(float(got[1][sparse_rows, 9].sum()) > 0,
                      f"{label}: the kernel's ticks have no inter-chip hop")
                chip_pairs += 1
    print(f"kernel == plain: sparse_run with the inter-chip tier, "
          f"{chip_pairs} arbiter x NoC x chips (2, {MC_CHIPS}) cases at "
          f"{CORES}x{NEURONS}x{ENTRIES}, {RUN_LANES} lanes x {RUN_TICKS} ticks "
          f"(ticks {RUN_BURST} overflow): currents and all 12 stats bitwise")
    print(f"kernel vs plain: sparse_run with the inter-chip tier, largest "
          f"absolute gap {chip_gap}")

    # the seeded whole run at the serve path's shape: one pallas_sparse
    # group's SERVE_TENANTS // 2 lanes x SERVE_FLUSH ticks on the scaled
    # fabric, each lane its tenant's scenario stream, right-padded with
    # all-False frames as the engine masks a ragged flush; the last lane is
    # at rest and returns its seed row.  The served frames overflow at
    # every tick (clustered and hotspot_core), so the kernel only sums the
    # dense rows; the same frames cut to the capacity but at one tick give
    # it sparse ticks to compute as well.
    from repro_torch import traffic
    from repro_torch.serve import TenantSpec, default_connectivity
    serve_cfg = dataclasses.replace(paper_dynaps.scaled_config().fabric,
                                    impl="pallas_sparse")
    serve_session = Interface(serve_cfg).compile(
        default_connectivity(serve_cfg, 0), device=dev)
    capacity = serve_session.plan.run.capacity
    names = traffic.scenario_names()
    lanes = SERVE_TENANTS // 2
    live = [SERVE_FLUSH >> i if i < lanes - 1 else 0 for i in range(lanes)]
    served = torch.stack([
        TenantSpec(f"tenant{i}", serve_cfg, scenario=names[i % len(names)],
                   seed=i).stream(SERVE_FLUSH, round=0)
        for i in range(lanes)]).to(dev)
    for i, n in enumerate(live):
        served[i, n:] = False
    cut = served & (served.to(torch.int32).cumsum(-1) <= capacity)
    cut[:, 3] = served[:, 3]
    for label, stream in (("served frames", served),
                          ("frames cut to the capacity but at tick 3", cut)):
        stream = stream.contiguous()
        overflow = (stream.sum(-1).amax((0, 2)) > capacity).tolist()
        check(any(overflow), f"serve-shape sparse_run ({label}): no tick "
              f"overflows")
        got, acc0, (g, b) = seeded_gap(
            f"seeded sparse_run at the serve shape ({label})",
            serve_session.plan, serve_session.params, stream, overflow)
        check(bool((got[0][lanes - 1] == 0).all())
              and torch.equal(got[2][:, lanes - 1], acc0[:, lanes - 1]),
              f"serve-shape sparse_run ({label}): the lane at rest has "
              f"currents or moved from its seed")
        print(f"kernel vs plain: seeded sparse_run at the serve path's "
              f"shape, {label}: {serve_cfg.cores}x"
              f"{serve_cfg.neurons_per_core}x{serve_cfg.cam.entries} "
              f"({serve_cfg.scheme}, {serve_cfg.noc.scheme}), {lanes} lanes "
              f"x {SERVE_FLUSH} ticks of scenarios "
              f"{[names[i % len(names)] for i in range(lanes)]}, live ticks "
              f"{live}, {sum(overflow)} of {SERVE_FLUSH} ticks overflow: "
              f"currents bitwise, whole-number stats exact, largest "
              f"relative gap of the rest {g:.3e} (limit {REL_TOL}), seeded "
              f"sums bitwise, the lane at rest returns its seed; every stat "
              f"bitwise: {b}")

    # cam_search counts at the path's shapes: the fabric's own packed tags
    # against every source address, valid = the lanes' spike frames, at
    # every density the kernel's live-source compaction meets (none, one
    # live source, a frame's 0.05, half, all), one lane, three lanes of one
    # frame rate and three of mixed densities; then W = 5 tags (the
    # kernel's runtime-W path) at the same shapes
    cfg = config("hier_tree", impl="pallas")
    params = random_connectivity(torch.Generator(dev).manual_seed(SEED), cfg)
    routing = pipeline.build_routing_index(params, cfg)
    q_words, src_words = routing.q_words, routing.src_words

    def frame(densities, e):
        rows = []
        for d in densities:
            if d == "one":
                row = torch.zeros(e, dtype=torch.bool, device=dev)
                row[int(torch.randint(e, (1,), generator=gen,
                                      device=dev))] = True
            else:
                row = torch.rand(e, generator=gen, device=dev) < d
            rows.append(row)
        return torch.stack(rows)

    wide_src = torch.randint(-4, 4, (src_words.shape[0], 5), generator=gen,
                             device=dev, dtype=torch.int32)
    wide_src[:, 0] = src_words[:, 0]
    wide_q = torch.randint(-4, 4, (q_words.shape[0], 5), generator=gen,
                           device=dev, dtype=torch.int32)
    pick = torch.randint(0, src_words.shape[0], (q_words.shape[0] // 2,),
                         generator=gen, device=dev)
    wide_q[: q_words.shape[0] // 2] = wide_src[pick]
    for qw, sw in ((q_words, src_words), (wide_q, wide_src)):
        for densities in ((0.0,), ("one",), (RATE,), (0.5,), (1.0,),
                          (RATE, 0.5, 1.0), (1.0, 0.0, "one")):
            valid = frame(densities, sw.shape[0])
            got = cam_kernel.cam_match_counts_cuda(qw, sw, valid)
            want = cam_ref.match_counts_ref(qw, sw, valid)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"cam_match_counts differ at "
                  f"{tuple(qw.shape)} x {tuple(valid.shape)}, densities "
                  f"{densities}")
            if any(d not in (0.0, "one") for d in densities):
                check(int(want.sum()) > 0, "cam_match_counts check saw no "
                      "match")
            max_err["cam_search"] = max(max_err["cam_search"], float(
                (got - want).abs().max()))
        print(f"kernel == plain: cam_match_counts {qw.shape[0]} queries x "
              f"{sw.shape[0]} sources x W={qw.shape[1]}, one lane each at "
              f"densities 0, one live source, {RATE}, 0.5, 1; three lanes at "
              f"({RATE}, 0.5, 1) and (1, 0, one live source) (exact)")

    # cam_search matrix, first match and speculative search at odd shapes
    for words in (1, 2, 3):
        bits = 32 * words - 5
        for b, e in ((1000, 777), (96, 100), (1024, 640)):
            tags = cam_ref.pack_bits(torch.rand((e, bits), generator=gen,
                                                device=dev) < 0.5)
            q = cam_ref.pack_bits(torch.rand((b, bits), generator=gen,
                                             device=dev) < 0.5)
            q[: min(b, e) // 2] = tags[: min(b, e) // 2]
            valid = torch.rand(e, generator=gen, device=dev) < 0.9
            want = cam_ref.cam_search_ref(q, tags, valid)
            got = cam_kernel.cam_search_cuda(q, tags, valid)
            torch.cuda.synchronize()
            check(torch.equal(got, want) and int(want.sum()) > 0,
                  f"cam_search matrix differs at B={b} E={e} W={words}")
            check(torch.equal(cam_ref.first_match_ref(got),
                              cam_ref.first_match_ref(want)),
                  f"first match differs at B={b} E={e} W={words}")
            if b % min(128, b) == 0 and e % min(128, e) == 0:
                check(torch.equal(
                    cam_ops.cam_first_match(q, tags, valid, impl="pallas"),
                    cam_ref.first_match_ref(want)),
                    f"cam_first_match differs at B={b} E={e} W={words}")
                check(torch.equal(cam_ops.cam_search_speculative(
                    q, tags, valid, impl="pallas"), want),
                    f"cam_search_speculative differs at B={b} E={e} "
                    f"W={words}")
        print(f"kernel == plain: cam_search matrix and first match at "
              f"(1000, 777), (96, 100), (1024, 640), W={words}; "
              f"cam_first_match and cam_search_speculative through the ops "
              f"where the block rule admits them (exact)")

    # hat_encode's one-tick op, with the AER stream it writes in the same
    # pass; its largest gap is printed on its own: the kernels line's B3
    # row is the whole-run kernel
    tick_err = 0.0
    for n, rows in ((256, CORES), (512, 8), (65536, 2)):
        for rate in (0.0, RATE, 0.5, 1.0):
            spikes = torch.rand((rows, n), generator=gen, device=dev) < rate
            ranks, count, clusters, stream = hat_kernel.hat_encode_cuda(
                spikes, row=256, stream=True)
            want = hat_ref.hat_encode_ref(spikes, row=256)
            want = (*want, hat_ref.compact_stream(*want[:2]))
            torch.cuda.synchronize()
            for name, g, w in zip(("ranks", "count", "cluster counts",
                                   "stream"),
                                  (ranks, count, clusters, stream), want):
                check(torch.equal(g, w), f"hat_encode {name} differ at "
                      f"N={n} rate={rate}")
                tick_err = max(tick_err, float((g - w).abs().max()))
        print(f"kernel == plain: hat_encode {rows} bitmaps of N={n} at rates "
              f"0, {RATE}, 0.5, 1 (ranks, counts, clusters, stream exact)")
    print(f"kernel vs plain: hat_encode one-tick op (hat_encode_kernel), "
          f"largest absolute gap {tick_err}")

    # hat_encode's whole-run form, through each scheme's plan as the pallas
    # session binds it: two lanes of a burst stream, the AER stream's edges
    # in tick 1 (an event at address 0, one at n - 1, an empty and a full
    # core)
    hat_frames = torch.rand((RUN_LANES, TICKS, CORES, NEURONS),
                            generator=gen, device=dev) < RATE
    hat_frames[:, ::BURST_EVERY] = True
    hat_frames[:, 1, :4] = False
    hat_frames[:, 1, 0, 0] = hat_frames[:, 1, 1, NEURONS - 1] = True
    hat_frames[:, 1, 3] = True
    tables = pipeline.build_tables(params, cfg)
    for scheme in SCHEMES:
        policy = pipeline.make_plan(params, config(scheme, impl="pallas"),
                                    tables=tables, routing=routing).hat
        check(policy.args is not None, f"{scheme} pallas plan bound no "
              f"hat_run kernel arguments on the card")
        got = hat_kernel.hat_run_cuda(hat_frames, policy.args)
        want = hat_ref.hat_run_ref(hat_frames, policy.latency_fn,
                                   policy.encode_fn)
        torch.cuda.synchronize()
        for name, g, w in zip(("latency", "energy", "count"), got, want):
            check(g.dtype == w.dtype and torch.equal(
                g.view(torch.int32), w.view(torch.int32)),
                f"hat_run {scheme} {name} differs")
            max_err["hat_encode"] = max(max_err["hat_encode"], float(
                (g.double() - w.double()).abs().max()))
        check(int(want[2][1, 0, 3]) == NEURONS and int(want[2][1, 0, 2]) == 0,
              "hat_run check frames lost their full and empty cores")
    print(f"kernel == plain: hat_run (hat_encode whole run) {RUN_LANES} lanes "
          f"x {TICKS} ticks x {CORES}x{NEURONS}, every {BURST_EVERY}th tick a "
          f"burst, the stream's edges in tick 1, for {len(SCHEMES)} arbiter "
          f"schemes (latency, energy, count bitwise)")

    # lif_step, bitwise: a sixty-fourth of the elements land exactly on the
    # threshold (v = 0, I = threshold), as many one float32 ulp below it
    snn_cfg = paper_dynaps.scaled_config()
    lif_args = dict(decay=snn_cfg.decay, threshold=snn_cfg.threshold)
    below = torch.nextafter(torch.tensor(snn_cfg.threshold),
                            torch.tensor(0.0)).item()
    for shape in LIF_SHAPES:
        v = torch.randn(shape, generator=gen, device=dev) * 3
        i = torch.randn(shape, generator=gen, device=dev) * 3
        pick = torch.rand(shape, generator=gen, device=dev)
        at, under = pick < 1 / 64, (pick >= 1 / 64) & (pick < 1 / 32)
        v[at | under] = 0.0
        i[at], i[under] = snn_cfg.threshold, below
        got = lif_kernel.lif_step_cuda(v, i, snn_cfg.decay,
                                       snn_cfg.threshold, 0.0)
        want = lif_ref.lif_step_ref(v, i, **lif_args)
        torch.cuda.synchronize()
        for name, g, w in zip(("v_next", "spikes"), got, want):
            check(torch.equal(g.view(torch.int32), w.view(torch.int32)),
                  f"lif_step {name} differ at {shape}")
            max_err["lif_step"] = max(max_err["lif_step"],
                                      float((g - w).abs().max()))
        check(bool(got[1][at].eq(1).all()) and not bool(got[1][under].any())
              and 0 < int(got[1].sum()) < got[1].numel(),
              f"lif_step at {shape}: threshold values must fire, values an "
              f"ulp below must not")
        print(f"kernel == plain: lif_step {shape} float32, decay "
              f"{snn_cfg.decay}, threshold {snn_cfg.threshold}, "
              f"{int(at.sum())} values at the threshold and {int(under.sum())}"
              f" an ulp below (v_next and spikes bitwise)")

    # moe_dispatch: the JAX sweep's shapes and the served streams, each
    # uniform, on one expert, and with the router's pad id E and stray ids
    moe_cases = [(f"{m}x{e}", torch.randint(0, e, (m,), generator=gen,
                                             device=dev, dtype=torch.int32),
                  e) for m, e in MOE_SWEEP]
    experts, top_k = lm_cfg.moe.num_experts, lm_cfg.moe.top_k
    decode_ids = torch.full((256,), experts, dtype=torch.int32, device=dev)
    decode_ids[:LM_BATCH * top_k] = torch.randint(
        0, experts, (LM_BATCH * top_k,), generator=gen, device=dev)
    prefill_m = LM_BATCH * LM_PROMPT * top_k
    moe_cases += [(f"decode {LM_BATCH * top_k} events + pads", decode_ids,
                   experts),
                  (f"prefill {prefill_m}", torch.randint(
                      0, experts, (prefill_m,), generator=gen, device=dev,
                      dtype=torch.int32), experts)]
    # longer streams: a cluster of blocks, each walking many rounds
    moe_cases += [(f"{m}", torch.randint(0, e, (m,), generator=gen,
                                         device=dev, dtype=torch.int32), e)
                  for m, e in MOE_LONG]
    for label, ids, e in moe_cases:
        one = torch.full_like(ids, e - 1)
        stray = ids.clone()
        stray[ids.numel() // 2:] = e
        stray[::29] = -3
        for kind, x in (("uniform", ids), ("one expert", one),
                        ("pad and stray ids", stray),
                        ("only pads", torch.full_like(ids, e))):
            got = moe_kernel.dispatch_positions_cuda(x, e)
            want = moe_ref.dispatch_positions_ref(x, e)
            torch.cuda.synchronize()
            for name, g, w in zip(("pos", "load"), got, want):
                check(torch.equal(g, w), f"moe_dispatch {name} differ at "
                      f"{label} E={e} ({kind})")
                max_err["moe_dispatch"] = max(max_err["moe_dispatch"], float(
                    (g - w).abs().max()))
        check(torch.equal(moe_kernel.dispatch_positions_cuda(one, e)[0],
                          torch.arange(one.numel(), device=dev,
                                       dtype=torch.int32)),
              f"moe_dispatch on one expert at {label}: positions not 0..M-1")
        print(f"kernel == plain: moe_dispatch {label} E={e}, uniform, one "
              f"expert, pad and stray ids, only pads (positions and loads "
              f"exact; {moe_kernel.launch_geometry(ids.numel())[0]} "
              f"block(s))")

    # ---- 4. the main paths -----------------------------------------------
    sparse_session = Interface(config("hier_tree")).compile(params)
    pallas_session = Interface(cfg).compile(params)
    xla_session = Interface(config("hier_tree", impl="xla")).compile(params)
    sessions = (("pallas", pallas_session), ("pallas_sparse", sparse_session),
                ("xla", xla_session))
    check(all(s.device == dev for _, s in sessions), "sessions not on the card")
    capacity = sparse_session.plan.run.capacity
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    sparse_stream = torch.rand((TICKS, CORES, NEURONS), generator=gen,
                               device=dev) < RATE
    burst_stream = sparse_stream.clone()
    burst_stream[::BURST_EVERY] = True
    streams = {"bernoulli_0.05": sparse_stream, "burst_every_16": burst_stream}
    fits = {k: int((s.sum(-1).amax(-1) <= capacity).sum())
            for k, s in streams.items()}
    ticks_all = len(streams) * TICKS

    launches = {}
    results = {}
    for label, session in (("pallas_sparse", sparse_session),
                           ("pallas", pallas_session)):
        reset_launches()
        results[label] = {k: session.run(s) for k, s in streams.items()}
        torch.cuda.synchronize()
        launches[label] = read_launches()
        print(f"main path {label}: launches over {ticks_all} ticks "
              f"{launches[label]} (non-overflowing ticks: {fits}; "
              f"capacity {capacity})")
    check(launches["pallas_sparse"] == {
        **no_launch, "sparse_tick": len(streams)},
        f"pallas_sparse launches {launches['pallas_sparse']}: want one "
        f"sparse_run launch per run, no cam_search or hat_encode")
    check(launches["pallas"] == {**no_launch, "cam_search": ticks_all,
                                 "hat_encode": len(streams)},
          f"pallas launches {launches['pallas']}: want cam_search once per "
          f"tick and hat_encode (hat_run) once per run")
    path_launches = {"sparse_tick": launches["pallas_sparse"]["sparse_tick"],
                     "cam_search": launches["pallas"]["cam_search"],
                     "hat_encode": launches["pallas"]["hat_encode"]}

    for name, stream in streams.items():
        ref_cur, ref_st = xla_session.run(stream)
        for label in ("pallas_sparse", "pallas"):
            cur, st = results[label][name]
            check(cur.shape == (TICKS, CORES, NEURONS)
                  and bool(cur.isfinite().all()),
                  f"{label} {name}: currents shape/finite")
            check(torch.equal(cur, ref_cur),
                  f"{label} {name}: currents != xla session")
            check_stats(f"{label} {name}", st, ref_st)
            print(f"{name}: {label} == xla on the card (currents bitwise, "
                  f"stats under the conformance contract); per-tick means "
                  f"{json.dumps(st.summary(ticks=TICKS))}")

    # the card against the CPU plain paths, on a short prefix
    prefix = burst_stream[:PREFIX]
    cpu_params = params.to("cpu")
    for label, session, cpu_impl in (
            ("pallas_sparse", sparse_session, "xla"),
            ("pallas", pallas_session, "pallas")):
        cpu_session = Interface(config("hier_tree", impl=cpu_impl)).compile(
            cpu_params, device="cpu")
        cpu_cur, cpu_st = cpu_session.run(prefix.cpu())
        gpu_cur, gpu_st = session.run(prefix)
        check(torch.equal(gpu_cur.cpu(), cpu_cur),
              f"card {label} currents != CPU plain {cpu_impl}")
        check_stats(f"card {label} vs CPU {cpu_impl}", gpu_st, cpu_st)
        print(f"card {label} == CPU plain {cpu_impl} on a {PREFIX}-tick "
              f"burst prefix")

    # the paper's SNN workload at scaled_config, batch 128: pallas runs
    # the lif_step kernel once per step, xla the surrogate-gradient step
    snn_params, snn_topo = snn.init_snn(
        torch.Generator(dev).manual_seed(SEED), snn_cfg)
    x = snn_batch(torch.Generator(dev).manual_seed(SEED + 3), SNN_BATCH,
                  snn_cfg.t_steps, snn_cfg.d_in, snn_cfg.d_out)["x"]
    n_total, steps = snn_cfg.n_total, snn_cfg.t_steps

    def forward(impl, inputs=x, account=False):
        return snn.snn_forward(snn_params, snn_topo, inputs, snn_cfg,
                               impl=impl, account=account)

    snn_out, snn_launches = {}, {}
    for impl in ("pallas", "xla"):
        reset_launches()
        snn_out[impl] = forward(impl)
        torch.cuda.synchronize()
        snn_launches[impl] = read_launches()
        print(f"main path snn_forward impl={impl}: launches over one "
              f"forward of {SNN_BATCH} x {steps} steps {snn_launches[impl]}")
    check(snn_launches["pallas"] == {**no_launch, "lif_step": steps},
          f"snn pallas launches {snn_launches['pallas']}: want lif_step "
          f"once per step and nothing else")
    check(snn_launches["xla"] == no_launch,
          f"snn xla launches {snn_launches['xla']}: want none")
    path_launches["lif_step"] = snn_launches["pallas"]["lif_step"]
    check(all(v > 0 for v in path_launches.values()),
          f"a kernel never launched on its path: {path_launches}")

    r_mat = snn.routing_matrix(snn.fabric_params(snn_params, snn_topo),
                               snn_cfg.fabric)
    rasters = {impl: snn.spike_raster(snn_params, r_mat, x, snn_cfg,
                                      impl=impl) for impl in ("pallas", "xla")}
    logits, rates, _ = snn_out["pallas"]
    check(logits.shape == (SNN_BATCH, snn_cfg.d_out)
          and rates.shape == (SNN_BATCH, n_total)
          and bool(logits.isfinite().all()), "snn forward shapes/finite")
    check(0 < float(rates.mean()) < 1, "snn forward: no neuron fires, or all")
    for name, a, b in (("spikes", *rasters.values()),
                       ("logits", logits, snn_out["xla"][0]),
                       ("rates", rates, snn_out["xla"][1])):
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              f"snn pallas {name} != xla on the card")
    check(torch.equal(rasters["pallas"].mean(1), rates),
          "snn spike_raster does not give the forward's rates")
    print(f"snn_forward scaled_config ({n_total} neurons, {steps} steps, "
          f"batch {SNN_BATCH}): pallas == xla on the card (spikes, rates, "
          f"logits bitwise); mean rate {float(rates.mean()):.6f}; "
          f"nonzero routing weights {int((r_mat != 0).sum())}")

    # the card against the CPU port on a prefix.  The step's matrix
    # products sum in another order on the card than on the CPU (a few
    # float32 ulps), and the network is chaotic: a membrane value within
    # those ulps of the threshold flips a spike on one side, and the flip
    # spreads through that sample's later steps.  So (1) a sample whose
    # free-running raster has no flipped spike must agree exactly (rates)
    # and within rtol 1e-5 / atol 1e-6 (logits), and so must the account
    # stats of those samples; (2) every step of the card, redone on the
    # CPU from the card's own state, must give currents within that
    # tolerance, and every spike that differs must come from a membrane
    # value no farther from the threshold than the two currents differ.
    x8 = x[:SNN_PREFIX]
    cpu_params = {k: t.cpu() for k, t in snn_params.items()}
    cpu_topo = {k: t.cpu() for k, t in snn_topo.items()}
    cpu_r = snn.routing_matrix(snn.fabric_params(cpu_params, cpu_topo),
                               snn_cfg.fabric)
    check(torch.equal(cpu_r, r_mat.cpu()), "routing_matrix card != CPU")
    flips = (snn.spike_raster(snn_params, r_mat, x8, snn_cfg,
                              impl="pallas").cpu()
             != snn.spike_raster(cpu_params, cpu_r, x8.cpu(), snn_cfg,
                                 impl="pallas"))          # (B, T, N)
    flipped = flips.flatten(1).sum(1)
    first_flip = [int(f.any(1).nonzero()[0]) for f in flips if f.any()]
    same = flipped == 0
    check(bool(same.any()), f"every prefix sample flipped a spike: "
          f"{flipped.tolist()}")
    xs = x8[same.to(dev)]
    card_s = forward("pallas", xs, account=True)
    cpu_s = snn.snn_forward(cpu_params, cpu_topo, xs.cpu(), snn_cfg,
                            impl="pallas", account=True)
    logit_gap = float((card_s[0].cpu() - cpu_s[0]).abs().max())
    check(torch.equal(card_s[1].cpu(), cpu_s[1]),
          "snn rates card != CPU on samples without a flipped spike")
    check(torch.allclose(card_s[0].cpu(), cpu_s[0], rtol=1e-5, atol=1e-6),
          f"snn logits card vs CPU beyond rtol 1e-5 / atol 1e-6: max "
          f"{logit_gap}")
    check_stats("snn account card vs CPU", card_s[2], cpu_s[2])

    v = torch.zeros((SNN_PREFIX, n_total), device=dev)
    s = torch.zeros_like(v)
    current_gap, differ, unequal = 0.0, 0, 0
    two_ulps = 2.0 ** -22 * snn_cfg.threshold
    for t in range(steps):
        cur = x8[:, t] @ snn_params["w_in"] + s @ r_mat
        cur_cpu = x8[:, t].cpu() @ cpu_params["w_in"] + s.cpu() @ cpu_r
        gap = (cur.cpu() - cur_cpu).abs()
        check(torch.allclose(cur.cpu(), cur_cpu, rtol=1e-5, atol=1e-6),
              f"snn step {t}: card currents vs CPU beyond rtol 1e-5 / "
              f"atol 1e-6: max {float(gap.max())}")
        current_gap = max(current_gap, float(gap.max()))
        unequal += int((gap > 0).sum())
        v_cpu = lif_ref.mul_add_once(v.cpu(), snn_cfg.decay, cur_cpu)
        v, s = lif_ops.lif_step(v, cur, impl="pallas", **lif_args)
        miss = s.cpu() != (v_cpu >= snn_cfg.threshold).to(torch.float32)
        margin = (v_cpu - snn_cfg.threshold).abs()
        check(bool((margin <= gap + two_ulps)[miss].all()),
              f"snn step {t}: a spike differs from the CPU's farther from "
              f"the threshold than the currents differ")
        differ += int(miss.sum())
    print(f"snn_forward card vs CPU port on a {SNN_PREFIX}-sample prefix: "
          f"routing matrix bitwise; free runs: flipped spikes per sample "
          f"{flipped.tolist()} of {steps * n_total} each, first at step "
          f"{first_flip}; the {int(same.sum())} samples without a flip "
          f"agree (rates bitwise, logits max abs diff {logit_gap:.3e} "
          f"within rtol 1e-5 / atol 1e-6, account stats under the "
          f"conformance contract); step by step from the card's state: "
          f"currents differ from the CPU's (summation order) in {unequal} "
          f"of {steps * x8.shape[0] * n_total} values, max abs diff "
          f"{current_gap:.3e} (within rtol 1e-5 / atol 1e-6); {differ} "
          f"spikes differ, each within that of the threshold")

    reset_launches()
    _, acc_rates, acc_stats = forward("pallas", x[:ACCOUNT_BATCH],
                                      account=True)
    torch.cuda.synchronize()
    acc_launches = read_launches()
    check(acc_launches == {**no_launch, "lif_step": steps},
          f"snn account launches {acc_launches}")
    acc_summary = acc_stats.summary()
    check(all(math.isfinite(v) for v in acc_summary.values()),
          "snn account stats not finite")
    check(math.isclose(acc_summary["events"],
                       float(acc_rates.sum()) / ACCOUNT_BATCH,
                       rel_tol=REL_TOL),
          f"snn account: events per tick {acc_summary['events']} != spikes "
          f"per step {float(acc_rates.sum()) / ACCOUNT_BATCH}")
    print(f"snn_forward account=True, {ACCOUNT_BATCH} samples "
          f"({ACCOUNT_BATCH * steps} ticks, fabric impl "
          f"{snn_cfg.fabric.impl!r}): per-tick means {json.dumps(acc_summary)}")

    # ---- 5. times --------------------------------------------------------
    def session_ms(session, stream):
        torch.cuda.synchronize()
        t = time.perf_counter()
        session.run(stream)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / stream.shape[0]

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
                  f"the other sessions, synchronized)")

    def print_breakdown(label, session, stages, rest):
        for name, stream in streams.items():
            total, spent = host_breakdown(lambda: session.run(stream),
                                          stages)
            top = sum(v for k, v in spent.items() if not k.startswith(" "))
            parts = "; ".join(f"{k.strip()} {v / TICKS * 1e6:.1f}"
                              for k, v in spent.items())
            print(f"{tag} host time per tick, {label} {name}: total "
                  f"{total / TICKS * 1e6:.1f} us = {parts}; {rest} "
                  f"{(total - top) / TICKS * 1e6:.1f} us")

    print_breakdown("pallas_sparse", sparse_session, (
        ("overflow precheck (once per run)", session_mod.InterfaceSession,
         "_overflow"),
        ("dense fallback ticks", pipeline, "dense_tick"),
        ("sparse_run op (once per run)", sparse_ops, "sparse_run"),
        ("  of it the kernel wrapper", sparse_kernel, "sparse_run_cuda")),
        "rest (input checks, allocations, the fallback rows' copies)")
    print_breakdown("pallas", pallas_session, (
        ("_entry_drive", pipeline, "_entry_drive"),
        ("  of it the cam_match_counts op", cam_ops, "cam_match_counts"),
        ("hat_run op (once per run)", hat_ops, "hat_run"),
        ("  of it the kernel wrapper", hat_kernel, "hat_run_cuda"),
        ("accounting_stats", pipeline, "accounting_stats"),
        ("  of it NoC costs", noc_router, "noc_step_costs")),
        "rest (CSR scatter, stats accumulate, currents)")

    for label, session in sessions[:2]:
        ticks = 32
        wall_us, events = device_events(
            lambda: session.run(sparse_stream[:ticks]))
        busy_us = sum(e.device_time_total for e in events)
        by_name = {}
        for e in events:
            us, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.device_time_total, count + 1)
        check(bool(events), f"the profiler recorded no device op in the "
              f"{label} session")
        print(f"{tag} profile {label} bernoulli_0.05, {ticks} ticks: "
              f"wall {wall_us:.1f} us (host clock, profiler on), device "
              f"busy {busy_us:.1f} us in {len(events)} device ops, idle "
              f"share {1 - busy_us / wall_us:.4f}; device ops per tick "
              f"{len(events) / ticks:.1f}")
        for key, (us, count) in sorted(by_name.items(),
                                       key=lambda r: -r[1][0])[:8]:
            print(f"{tag}   {us:10.1f} us  x{count:5d}  {key[:90]}")

    # the SNN forward: ms per batch, host split, device profile
    for impl in ("pallas", "xla"):
        forward(impl)                            # warm-up
    fwd_ms = {"pallas": [], "xla": []}
    for _ in range(SESSION_RUNS):                # interleaved runs
        for impl, ms in fwd_ms.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            forward(impl)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
    for impl, ms in fwd_ms.items():
        q1, med, q3 = statistics.quantiles(ms, n=4)
        print(f"{tag} snn_forward {impl} scaled_config batch {SNN_BATCH}: "
              f"median {med:.4f} ms/batch (quartiles {q1:.4f}-{q3:.4f}; "
              f"host clock, {SESSION_RUNS} runs interleaved with the other "
              f"impl, synchronized)")
    snn_stages = (
        ("routing_matrix", snn, "routing_matrix"),
        ("step loop (spike_raster)", snn, "spike_raster"),
        ("  of it the lif_step op", lif_ops, "lif_step"),
        ("  of it mul_add_once", lif_ref, "mul_add_once"))
    for impl in ("pallas", "xla"):
        total, spent = host_breakdown(lambda: forward(impl), snn_stages)
        top = sum(v for k, v in spent.items() if not k.startswith(" "))
        parts = "; ".join(f"{k.strip()} {v * 1e3:.3f}"
                          for k, v in spent.items())
        print(f"{tag} host ms per snn_forward {impl}: total "
              f"{total * 1e3:.3f} = {parts}; readout (rates, logits) and "
              f"the rest {(total - top) * 1e3:.3f}")
    for impl in ("pallas", "xla"):
        wall_us, events = device_events(lambda: forward(impl))
        check(bool(events), f"the profiler recorded no device op in the "
              f"snn {impl} forward")
        busy_us = sum(e.device_time_total for e in events)
        by_name = {}
        for e in events:
            us, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.device_time_total, count + 1)
        print(f"{tag} profile snn_forward {impl}: wall {wall_us:.1f} us "
              f"(host clock, profiler on), device busy {busy_us:.1f} us in "
              f"{len(events)} device ops, idle share "
              f"{1 - busy_us / wall_us:.4f}")
        for key, (us, count) in sorted(by_name.items(),
                                       key=lambda r: -r[1][0])[:8]:
            print(f"{tag}   {us:10.1f} us  x{count:5d}  {key[:90]}")

    # the SNN trained through the port's example, before the served LM's
    # parameters are drawn
    train_launches = trained_snn(dev, tag, reset_launches, read_launches,
                                 no_launch, root)

    # the served LM: its checks, times and profile (moe_dispatch's path)
    path_launches["moe_dispatch"], moe_ids = served_lm(
        dev, tag, reset_launches, read_launches, no_launch)

    # the fabric serving tier: its checks, launches per flush and times
    serve_per_flush = served_fabric(dev, tag, reset_launches, read_launches,
                                    no_launch)

    # the multi-chip fabric: the chip tier, shard="chips", telemetry,
    # faults, faulted and sharded tenants, the oracle
    chip_sessions = multichip_fabric(
        dev, tag, reset_launches, read_launches, no_launch, params,
        {label: s for label, s in sessions}, streams)

    rows = []

    # the launch floor: an empty sm_90a kernel, one block of 32 threads
    empty = build.load("launch_floor").launch_floor_launch
    empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int
    cuda_stream = torch.cuda.current_stream(dev).cuda_stream

    def empty_launch():
        check(empty(cuda_stream) == 0, "empty kernel launch failed")
    floor_ms = device_ms_per_call(empty_launch, 200, "empty_kernel")
    floor_call_ms = cuda_ms(empty_launch, 2000)
    floor_note = f"launch floor {floor_ms * 1e3:.3f} us (empty kernel)"
    print(f"{tag} launch floor: an empty sm_90a kernel (one block of 32 "
          f"threads, src/repro_torch/csrc/launch_floor.cu) takes "
          f"{floor_ms * 1e3:.3f} us on the device (profiler, 200 launches) "
          f"and {floor_call_ms * 1e3:.3f} us per launch back to back as a "
          f"caller waits (CUDA events, 2000 launches through ctypes)")
    l2_flush = torch.zeros((32 << 20,), dtype=torch.float32, device=dev)

    def report(name, kernel_fn, kernel_name, plain_fn, library_fn, nbytes_,
               ops, ops_per_s, ops_note, reps, label=None, row=True,
               plain_reps=None, cold=False):
        """Time one kernel beside its plain version and library call on
        the same inputs; print its line and, with ``row``, add its
        kernels-line row.  ``cold`` times the kernel with L2 flushed
        before each launch: a 128 MB read, which leaves L2 holding clean
        lines of another buffer (a write would leave dirty lines whose
        write-back the kernel would pay).  Returns (device ms per call,
        bound ms)."""
        plain_reps = reps // 10 if plain_reps is None else plain_reps
        call_ms = cuda_ms(kernel_fn, reps)
        plain_call_ms = cuda_ms(plain_fn, plain_reps)
        warm_ms = device_ms_per_call(kernel_fn, reps // 10, kernel_name)
        ms = warm_ms if not cold else device_ms_per_call(
            lambda: (l2_flush.sum(), kernel_fn()), reps // 10, kernel_name)
        plain_ms = device_ms_per_call(plain_fn, max(1, plain_reps // 4))
        library_ms = (device_ms_per_call(library_fn, reps // 10)
                      if library_fn is not None else None)
        bound_ms, bound_by = bound(nbytes_, ops, ops_per_s)
        lib = ("none" if library_ms is None
               else f"{library_ms * 1e3:.3f} us/call")
        what = name if label is None else f"{name} ({label})"
        temp = (f"{ms * 1e3:.3f} us/launch with L2 flushed before each "
                f"launch ({warm_ms * 1e3:.3f} back to back)" if cold else
                f"{ms * 1e3:.3f} us/launch")
        floor = (f"; {floor_note}" if name in ("sparse_tick", "hat_encode",
                                              "moe_dispatch") else "")
        print(f"{tag} {what} kernel: {temp}; plain torch version: "
              f"{plain_ms * 1e3:.3f} us/call; library call: {lib} (profiler "
              f"device time); bound {bound_ms * 1e3:.4f} us by {bound_by} "
              f"({nbytes_} bytes at 3.35 TB/s; {ops} {ops_note}); launches "
              f"on its path {path_launches[name]}{floor}")
        print(f"{tag} {what} per call as a caller waits (CUDA events, "
              f"back-to-back, host overhead included): wrapper "
              f"{call_ms * 1e3:.3f} us ({reps} calls), plain torch "
              f"{plain_call_ms * 1e3:.3f} us ({plain_reps} calls)")
        if row:
            rows.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": kernel_modules[name].REPLACES,
                "launches": path_launches[name], "max_abs_err": max_err[name],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms})
        return ms, bound_ms

    # B1 on the path: one sparse_run launch over the Bernoulli stream's 256
    # ticks (one lane), with the session's own plan.  The bound counts the
    # routing operands once (CSR offsets, sources and weights of the live
    # entries), the frames, the currents, the NoC table rows of every
    # source that spikes in the run (hops, depth, subscribed cores, swept
    # entries: 4 B each; the link row: 4 B a link), and the stats table and
    # its sum; the operations are the scatter adds of the driven entries,
    # each event's link-load adds, each flag's scan, each event's integer
    # sums, and the stats (22 a tick).
    kops = sparse_session.plan.run.kernel
    run_frames = sparse_stream[None].contiguous()
    run_out = (torch.empty((1, TICKS, CORES, NEURONS), device=dev),
               torch.empty((TICKS, len(StepStats._fields), 1), device=dev))
    plain_out = tuple(t.clone() for t in run_out)
    run_acc = sparse_kernel.sparse_run_cuda(run_frames, None, kops, *run_out)
    flat = run_frames.reshape(TICKS, -1)
    src_idx = sparse_session.routing.src_idx.reshape(-1).long()
    hits = int((flat[:, src_idx] &
                sparse_session.routing.active.reshape(-1)).sum())
    events = int(flat.sum())
    sources = int(flat.any(0).sum())
    links = kops.links.shape[-1]
    fops = hits + events * links + 22 * TICKS
    iops = flat.numel() + 4 * events
    b1_ms, _ = report(
        "sparse_tick",
        lambda: sparse_kernel.sparse_run_cuda(run_frames, None, kops,
                                              *run_out),
        "sparse_run_kernel",
        lambda: sparse_ops.sparse_run_ref(run_frames, None,
                                          sparse_session.plan.run,
                                          *plain_out), None,
        nbytes(kops.ptr, kops.src, kops.weight, run_frames, *run_out,
               run_acc) + sources * (16 + 4 * links),
        fops + 2 * iops, FP32_OPS_PER_S,
        f"fp32 ops at 67 TFLOP/s, int32 ops counted twice: {hits} scatter "
        f"adds, {events} events x {links} link-load adds, {flat.numel()} "
        f"flags scanned, 4 integer ops an event", 400, plain_reps=2,
        label=f"whole run: {TICKS} Bernoulli {RATE} ticks in one launch")
    rows[-1].update(ticks_per_launch=TICKS, us_per_tick=b1_ms * 1e3 / TICKS,
                    launches_per_512_ticks=path_launches["sparse_tick"],
                    serve_launches_per_flush=serve_per_flush["sparse_tick"],
                    train_eval_launches=train_launches["sparse_tick"])
    print(f"{tag} sparse_tick whole run: {b1_ms * 1e3 / TICKS:.4f} us per "
          f"tick; {path_launches['sparse_tick']} launches in the 512 "
          f"pallas_sparse ticks of phase 4 ({sources} sources spiked)")

    # the seed's cost: the same launch seeded by a (12, 1) acc0, as every
    # served flush launches it, timed beside the unseeded one in the order
    # unseeded, seeded, seeded, unseeded (profiler, 40 launches each)
    run_seed = seed_acc(1)
    b1_pair = {"unseeded": [], "seeded": []}
    for which in ("unseeded", "seeded", "seeded", "unseeded"):
        acc0 = run_seed if which == "seeded" else None
        b1_pair[which].append(device_ms_per_call(
            lambda: sparse_kernel.sparse_run_cuda(run_frames, None, kops,
                                                  *run_out, acc0), 40,
            "sparse_run_kernel"))
    seed_us = (statistics.mean(b1_pair["seeded"])
               - statistics.mean(b1_pair["unseeded"])) * 1e3
    print(f"{tag} sparse_tick whole run seeded by acc0 (the serve path's "
          f"launch): " + "; ".join(
              f"{k} " + ", ".join(f"{v * 1e3:.3f}" for v in vs) + " us"
              for k, vs in b1_pair.items()) + f" per launch (profiler, 40 "
          f"launches each, order unseeded, seeded, seeded, unseeded); "
          f"seeded - unseeded {seed_us:.3f} us")

    # B1 with the inter-chip tier (the chips=MC_CHIPS plan) against the
    # chips=1 plan on the same frames: TIER_PAIRS pairs of 40-launch
    # windows, each pair's order alternating
    chip_ops = chip_sessions["pallas_sparse"].plan.run.kernel
    b1_tier = {"chips=1": [], f"chips={MC_CHIPS}": []}
    for pair in range(TIER_PAIRS):
        order = list(b1_tier) if pair % 2 == 0 else list(b1_tier)[::-1]
        for which in order:
            ops_ = kops if which == "chips=1" else chip_ops
            b1_tier[which].append(device_ms_per_call(
                lambda: sparse_kernel.sparse_run_cuda(run_frames, None, ops_,
                                                      *run_out), 40,
                "sparse_run_kernel"))
    tier_wins = sum(a < b for a, b in zip(b1_tier[f"chips={MC_CHIPS}"],
                                          b1_tier["chips=1"]))
    print(f"{tag} sparse_tick whole run with the inter-chip tier against "
          f"without ({TICKS} Bernoulli {RATE} ticks; profiler, {TIER_PAIRS} "
          f"pairs of 40-launch windows, order alternating; median "
          f"(quartiles) us per launch): " + "; ".join(
              f"{k} {statistics.median(v) * 1e3:.3f} ("
              + "-".join(f"{q * 1e3:.3f}" for q in statistics.quantiles(
                  v, n=4)[::2]) + ")" for k, v in b1_tier.items())
          + f"; chips={MC_CHIPS} faster in {tier_wins} of {TIER_PAIRS} pairs")

    # the same run at 64 cores: one block a tick holds the fabric there too
    wide = config("hier_tree", 4 * CORES)
    wide_params = random_connectivity(torch.Generator(dev).manual_seed(SEED),
                                      wide)
    wide_plan = pipeline.make_plan(wide_params, wide)
    wide_frames = torch.rand((1, TICKS, 4 * CORES, NEURONS), generator=gen,
                             device=dev) < RATE
    wide_frames &= (wide_frames.to(torch.int32).cumsum(-1)
                    <= wide_plan.run.capacity)
    wide_out = (torch.empty(tuple(wide_frames.shape), device=dev),
                torch.empty((TICKS, len(StepStats._fields), 1), device=dev))
    ms = device_ms_per_call(
        lambda: sparse_kernel.sparse_run_cuda(
            wide_frames, None, wide_plan.run.kernel, *wide_out), 40,
        "sparse_run_kernel")
    print(f"{tag} sparse_run at 64 cores, {TICKS} ticks: {ms * 1e3:.3f} us "
          f"per launch, {ms * 1e3 / TICKS:.4f} us per tick (profiler, 40 "
          f"launches; {wide_plan.run.kernel.smem} B of shared memory a "
          f"block)")

    # the one-tick op (not on the path any more): its time, for reference
    args, policy, _ = operands(config("hier_tree"), sparse_stream[:1], SEED)
    tick_ms = device_ms_per_call(lambda: kernel_call(args, policy), 200,
                                 "sparse_tick_kernel")
    print(f"{tag} sparse_tick one-tick op (sparse_tick_kernel, the op "
          f"kernels.sparse_tick.ops.sparse_tick): {tick_ms * 1e3:.3f} us "
          f"per launch at one Bernoulli {RATE} tick (profiler, 200 launches)")

    # B2 on the path: one tick's match counts, one lane, at the Bernoulli
    # 0.05 frame (the kernels-line row) and at an all-ones frame (the burst
    # ticks); about 2W + 1 integer operations per (query, source) pair
    # (compares, ANDs, add).  The kernel compares against live sources
    # only, so the bound counts the (query, live source) pairs these inputs
    # need; the bound over every pair, the first port's, is printed beside
    # it for reference.
    b, w = q_words.shape
    for label, valid in (("Bernoulli 0.05 frame", sparse_stream[:1].reshape(
            1, -1)), ("all-ones frame", burst_stream[:1].reshape(1, -1))):
        counts = cam_kernel.cam_match_counts_cuda(q_words, src_words, valid)
        live = int(valid.sum())
        ms, live_ms = report(
            "cam_search",
            lambda: cam_kernel.cam_match_counts_cuda(q_words, src_words,
                                                     valid),
            "cam_match_counts_kernel",
            lambda: cam_ref.match_counts_ref(q_words, src_words, valid), None,
            nbytes(q_words, src_words, valid, counts),
            valid.shape[0] * b * live * (2 * w + 1), INT32_OPS_PER_S,
            f"int32 ops at 33.5 TOP/s over {b} x {live} (query, live source) "
            f"pairs", 2000, label=label, row=label.startswith("Bernoulli"))
        all_pairs_ms, all_by = bound(
            nbytes(q_words, src_words, valid, counts),
            valid.shape[0] * b * src_words.shape[0] * (2 * w + 1),
            INT32_OPS_PER_S)
        print(f"{tag} cam_search ({label}) bounds: {live_ms * 1e3:.4f} us "
              f"over the {b} x {live} (query, live source) pairs these "
              f"inputs need (the row's), {all_pairs_ms * 1e3:.4f} us by "
              f"{all_by} over all {b} x {src_words.shape[0]} pairs; kernel "
              f"at {live_ms / ms:.4f} of the first, {all_pairs_ms / ms:.4f} "
              f"of the second")
    next(r for r in rows if r["name"] == "cam_search").update(
        serve_launches_per_flush=serve_per_flush["cam_search"])

    # B3 on the path: one hat_run launch over the Bernoulli stream's 256
    # ticks (one lane), with the pallas session's own policy.  The bound
    # counts each frame byte read once and the three 4-byte results of each
    # bitmap written once, and one int32 operation a neuron.  No one
    # PyTorch call computes the latency or the energy.
    policy = pallas_session.plan.hat
    run_frames = sparse_stream[None].contiguous()
    hat_args = policy.args
    hat_outs = hat_kernel.hat_run_cuda(run_frames, hat_args)
    b3_ms, _ = report(
        "hat_encode", lambda: hat_kernel.hat_run_cuda(run_frames, hat_args),
        "hat_run_kernel",
        lambda: hat_ref.hat_run_ref(run_frames, policy.latency_fn,
                                    policy.encode_fn), None,
        nbytes(run_frames, *hat_outs), run_frames.numel(), INT32_OPS_PER_S,
        "int32 ops at 33.5 TOP/s, one a neuron", 2000, plain_reps=40,
        label=f"whole run: {TICKS} Bernoulli {RATE} ticks in one launch")
    rows[-1].update(ticks_per_launch=TICKS, us_per_tick=b3_ms * 1e3 / TICKS,
                    launches_per_512_ticks=path_launches["hat_encode"],
                    serve_launches_per_flush=serve_per_flush["hat_encode"])
    print(f"{tag} hat_encode whole run: {b3_ms * 1e3 / TICKS:.4f} us per "
          f"tick; {path_launches['hat_encode']} launches in the 512 pallas "
          f"ticks of phase 4")

    # the one-tick kernel (the ops hat_encode and encode_stream; not on the
    # path any more) at one tick's bitmaps, with the AER stream, and
    # torch.cumsum over the same bitmaps as int32, which gives its ranks up
    # to the where, then over the whole run's
    bitmaps = sparse_stream[0]
    as_int, run_int = bitmaps.to(torch.int32), run_frames.to(torch.int32)
    one_ms = device_ms_per_call(
        lambda: hat_kernel.hat_encode_cuda(bitmaps, row=256, stream=True),
        200, "hat_encode_kernel")
    one_call_ms = cuda_ms(
        lambda: hat_kernel.hat_encode_cuda(bitmaps, row=256, stream=True),
        2000)
    print(f"{tag} hat_encode one-tick op (hat_encode_kernel, the ops "
          f"hat_encode and encode_stream): {one_ms * 1e3:.3f} us per launch "
          f"at one Bernoulli {RATE} tick ({CORES} bitmaps; profiler, 200 "
          f"launches), {one_call_ms * 1e3:.3f} us a call as a caller waits "
          f"(CUDA events)")
    for label, x in ((f"one tick's ({CORES}, {NEURONS})", as_int),
                     (f"the whole run's (1, {TICKS}, {CORES}, {NEURONS})",
                      run_int)):
        ms = device_ms_per_call(lambda: torch.cumsum(x, -1), 200)
        print(f"{tag} torch.cumsum over {label} int32 bitmaps: "
              f"{ms * 1e3:.3f} us per call (profiler, 200 calls)")

    # B4 on the path: one step's (128, 4096) float32 state; v and I in,
    # v' and s out; three float32 operations an element (the FMA as two,
    # the compare).  Back to back its 8 MB of inputs stay in the 50 MB L2
    # and it reads faster than the HBM bound, so the row times it with L2
    # flushed before each launch.  No one PyTorch call computes the LIF
    # update.
    v = torch.randn((SNN_BATCH, n_total), generator=gen, device=dev) * 3
    i = torch.randn((SNN_BATCH, n_total), generator=gen, device=dev) * 3
    lif_outs = lif_kernel.lif_step_cuda(v, i, snn_cfg.decay,
                                        snn_cfg.threshold, 0.0)
    report("lif_step",
           lambda: lif_kernel.lif_step_cuda(v, i, snn_cfg.decay,
                                            snn_cfg.threshold, 0.0),
           "lif_step", lambda: lif_ref.lif_step_ref(v, i, **lif_args), None,
           nbytes(v, i, *lif_outs), 3 * v.numel(), FP32_OPS_PER_S,
           "fp32 ops at 67 TFLOP/s", 2000, cold=True)
    rows[-1].update(train_eval_launches=train_launches["lif_step"])

    # B5 on the path: the first MoE layer's prefill stream (4 x 128 tokens x
    # top-6 = 3072 events, E = 64; the kernels-line row), then a decode
    # stream of the served shape (4 x 6 events padded with the id E to 256);
    # ids in, positions and loads out; about two integer operations an
    # event (its count, its rank).  No one PyTorch call computes
    # arrival-order positions.
    # Then the longer streams benchmarks/kernel_bench.py times (a cluster of
    # blocks): uniform ids from the seed.
    bench_ids = [(f"{m} x {e} stream", e, torch.randint(
        0, e, (m,), generator=gen, device=dev, dtype=torch.int32))
        for m, e in MOE_BENCH]
    for label, experts_, ids in (("served prefill stream", experts, moe_ids),
                                 ("served decode stream", experts,
                                  decode_ids), *bench_ids):
        moe_outs = moe_kernel.dispatch_positions_cuda(ids, experts_)
        report("moe_dispatch",
               lambda: moe_kernel.dispatch_positions_cuda(ids, experts_),
               "moe_dispatch",
               lambda: moe_ref.dispatch_positions_ref(ids, experts_), None,
               nbytes(ids, *moe_outs), 2 * ids.numel(), INT32_OPS_PER_S,
               "int32 ops at 33.5 TOP/s", 2000, label=label,
               row=label.endswith("prefill stream"))

    # ---- 6. result lines -------------------------------------------------
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
