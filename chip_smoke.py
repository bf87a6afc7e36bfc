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
    (its largest gap printed on its own line); the whole run's group
    form (fabrics over one block's shared memory, G blocks a (tick,
    lane)) at 128 x 256 x 512 on one chip for every arbiter x NoC pair
    and at 256 x 256 x 512 as 16 chips x 16 cores at hier_tree for the
    three NoC schemes, unseeded and seeded, with the per-core output
    (currents, table, sums and per-core terms bitwise), each
    pallas_sparse session's currents bitwise its xla twin's with one
    launch a run, and G, the shared bytes a block and the device us a
    launch over 256 Bernoulli 0.05 ticks beside the bound by bytes;
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
    exactly at the threshold and one ulp below it, and on bfloat16 at
    (128, 4096) and tests/test_kernels.py's four shapes; moe_dispatch exactly
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
    sweep) on 8 ticks at chips 1 and 4 equal to xla; impl="pallas" at
    hier_ring, 16 x 512 (no closed-form latency), on both streams
    widened to 512 neurons: B3's stream form once a run (hat_encode_cuda)
    and cam_search once a tick, currents bitwise the xla session's and
    stats under the conformance contract; the dense GQA LMs: each of
    internlm2-1.8b, llama3.2-3b, qwen3-32b and gemma3-12b at full width
    cut to one layer group (2 layers; gemma3-12b 6) in float32,
    teacher-forced card against CPU; banded against masked flash
    attention at gemma3-12b's heads, T 2048; internlm2-1.8b (4 x 128
    prompt tokens) and gemma3-12b (2 x 2048, past its window) served at
    full width and depth, 32 new tokens greedy, every step's logits
    finite, two generates equal; internlm2-1.8b trained at full width
    and depth (seq_len 4096, batch 2, remat), a finite loss; its restart
    drill bitwise at a 2-layer cut and one step card against CPU at the
    2-layer float32 cut, both under deterministic algorithms; no kernel
    launches on the dense paths; the rest of the registry (hybrid_lms):
    rwkv6-3b, jamba-1.5-large-398b (layers 0-1: Mamba + MoE, Mamba +
    dense), hubert-xlarge (masked frames), phi-3-vision-4.2b (with its
    576 image patches) and deepseek-v2-236b (bfloat16 and int8 experts)
    at full width cut to 2 layers, float32 compute, card against CPU
    (route flips from near ties counted, every B5 launch held to its
    plain version, int8 against bfloat16 logits within 0.15 relative);
    one rwkv6-3b training step card against CPU at its cut; rwkv6-3b (4
    x 128 prompt tokens, 32 new) and jamba's first four layers (B5 once
    per MoE layer per forward, 66 a generate) served at full width;
    phi-3-vision-4.2b served through make_prefill_step with 4 x (576
    patches + 128 tokens) and 32 greedy make_decode_steps; hubert-xlarge
    encoding 4 x 1024 frames and its loss on a Pipeline audio batch;
    rwkv6-3b trained at full width and depth (seq_len 4096, batch 2,
    remat, bfloat16 AdamW moments); the mesh (sharded): 4 gloo ranks
    sharing the card (NCCL refuses two ranks on one device), B5 built
    before they start - gloo's collectives on CUDA tensors and the
    functional ones through the port's host staging, exact;
    run(shard="chips") at chips=4 over the multi-chip fabric, each rank
    its own chip, currents bitwise the chips=1 xla session on both
    streams, stats bitwise the one-process sharded body; internlm2-1.8b
    at full width and depth (float32 compute, serve_tp_only) served on a
    2 x 2 mesh, 4 x 128 prompt tokens and 8 new, greedy tokens equal to
    the one-device generate; llama3.2-3b (sequence-parallel) and
    deepseek-v2-lite-16b (MLA, expert parallelism: B5 once a rank a MoE
    layer a forward, each launch held to its plain version) at full
    width cut to 2 layers, float32, against the one-device run, each rank
    its own block; one internlm2-1.8b training step at its 2-layer cut
    (batch 4, seq 512, FSDP x TP): loss and gradients against one device;
    NCCL on one rank (a 1 x 1 mesh); the dry run's per-device bytes of
    all 80 cells (no FLOP count); the dry run's per-device pass (rank 0
    of a fake process group, on the CPU) of the served prefill, whose
    collective calls by op must equal rank 0's staged calls in that
    prefill and whose bytes must match the staged bytes op by op (its
    peak printed beside the rank's), of the internlm2-1.8b cut's train
    step, held the same way to rank 0's staged calls in that step and
    its peak within 10 % of the rank's, of internlm2-1.8b train_4k on
    16 x 16 (calibrated), whose calls by op must be the CPU tests'
    torch's, and of the smoke prefill the CPU tests hold against JAX,
    whose all-reduces must be the JAX dry run's 5 and 81,920 B; the
    cut's train step again in 2 microbatches, held to the one-device
    gradients;
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
    ms a tick, and B1 with and without the chip tier; the mesh's host
    ms a tick by rank beside the one-process sharded twin, generate
    seconds and peak memory by rank beside one device's, the parameter
    bytes a rank holds; the hier_ring
    pallas and xla sessions' ms a tick and the stream form's launch; the
    dense LMs' prefill ms, decode ms a step, tokens/s, host split,
    device profile and peak memory, and the trained LM's ms a step
    (median and quartiles of 3), its forward/backward/update split,
    profile and peak memory; the same for the served rwkv6-3b, jamba cut
    and phi-3-vision, the hubert-xlarge encoder's ms a forward, and the
    trained rwkv6-3b (2 timed steps); lif_step on bfloat16 with L2
    flushed, beside its bound by bytes;
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
LM_RUNS = 2                     # timed generates
# the dense GQA LMs: the four architectures' 2-layer full-width checks
# (gemma3-12b: its 6-layer group), the served models and the trained one
DENSE_ARCHS = ("internlm2-1.8b", "llama3.2-3b", "qwen3-32b", "gemma3-12b")
# teacher-forced tokens of the 2-layer cuts' card-vs-CPU checks, dense
# and hybrid (at 128 the CPU's references took ~160 s of the script's
# 1,200)
DENSE_CHECK_TOKENS = 64
DENSE_SERVE = {"internlm2-1.8b": (LM_BATCH, LM_PROMPT),
               "gemma3-12b": (2, 2048)}   # prompt > gemma3's 1024 window
DENSE_NEW_TOKENS = 32
DENSE_PROFILE_STEPS = 4
BANDED_TOKENS = 2048
DENSE_TRAIN_SEQ, DENSE_TRAIN_BATCH = 4096, 2    # train_4k's seq_len
DENSE_TRAIN_STEPS = 3           # timed steps, after a warm-up
DENSE_DRILL_STEPS, DENSE_DRILL_FAIL, DENSE_DRILL_EVERY = 3, 2, 2
DENSE_DRILL_SEQ, DENSE_DRILL_BATCH = 256, 2
# the rest of the registry: RWKV6, the Jamba hybrid, the audio and vision
# frontends and deepseek-v2-236b with int8 experts, each at full width cut
# to 2 layers in float32, card against CPU; rwkv6-3b served and trained,
# jamba's first JAMBA_LAYERS layers served, phi-3-vision served after its
# image prefix, hubert-xlarge encoding
HYBRID_CUTS = ("rwkv6-3b", "jamba-1.5-large-398b", "hubert-xlarge",
               "phi-3-vision-4.2b", "deepseek-v2-236b")
JAMBA_LAYERS = 4                # Mamba + MoE, Mamba, Mamba + MoE, attention
VISION_PROMPT = 128             # text tokens after phi-3-vision's patches
AUDIO_BATCH, AUDIO_FRAMES = 4, 1024
AUDIO_RUNS = 3
RWKV_TRAIN_SEQ, RWKV_TRAIN_BATCH = 4096, 2      # train_4k's seq_len
RWKV_TRAIN_STEPS = 2            # timed steps, after a warm-up
INT8_REL = 0.15                 # tests/test_perf_variants.py's bound
LIF_BF16_SHAPES = ((128, 4096), (8, 512), (16, 1024), (8, 4096), (32, 128))
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
# RWKV6's chunked WKV factors its decay as exp(lw_before) and
# exp(-lw_cum), |lw_cum| up to 64: the two factors' gradients are large
# and nearly cancel, so float32 summation order moves every gradient by
# ~3e-4 of its norm (the CPU port against JAX at rwkv6-3b's smoke config:
# 4.05e-4 of the leaf's largest at worst); its training step is held to
# ten times that
RWKV_GRAD_RTOL, RWKV_GRAD_ATOL = 1e-3, 1e-3
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


# the profiler on the card drops the device records of the first launches
# of a capture, more the longer the process has run and the more the
# capture holds (an H100 under torch 2.11 lost none 20 s in, the first
# 12 of a capture 160 s in, 17 at 220 s, and 263 of a 16,460-launch
# capture some 500 s in; the launches' host records all there): each
# capture first launches this many small kernels, which take the loss,
# and the count doubles whenever one of the window's own launches still
# left no device record
PROFILE_LEAD = [1024]


def device_events(fn, captures: int = 6):
    """Run ``fn`` under the profiler; return (host wall us, the device-side
    events of ``fn``'s window: kernels, copies and sets, each with its
    duration in us).

    Each capture launches `PROFILE_LEAD` small kernels before the window
    and leaves their records out.  A capture in which any kernel launch of
    the window has no device record is taken again with twice the lead,
    at most ``captures`` times in all, each retry printed; it fails when
    no capture kept every launch's record, since a window with records
    missing reads low.
    """
    cuda = torch.autograd.DeviceType.CUDA
    fn()
    torch.cuda.synchronize()
    pad = torch.zeros(1, device=torch.cuda.current_device())
    for attempt in range(captures):
        lead = PROFILE_LEAD[0]
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                pad.add_(1)
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
        events = prof.events()
        launches = sorted(e.id for e in events if e.device_type != cuda
                          and "aunch" in e.name and "HostFunc" not in e.name)
        ours, theirs = set(launches[:lead]), launches[lead:]
        device = [e for e in events
                  if e.device_type == cuda and e.id not in ours]
        recorded = {e.id for e in device}
        lost = sum(i not in recorded for i in theirs)
        if len(launches) >= lead and not lost and (device or not theirs):
            break
        PROFILE_LEAD[0] = 2 * lead
        what = (f"lost the device records of {lost} of the window's "
                f"{len(theirs)} launches (lead {lead})")
        check(attempt + 1 < captures, f"the profiler {what} in each of "
              f"{captures} captures")
        print(f"profiler capture {attempt + 1} of {captures} {what}; "
              f"capturing again with a lead of {2 * lead}")
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


def routed_card_vs_cpu(label, k, card_route, cpu_route, card_logits,
                       cpu_logits):
    """Hold teacher-forced logits of a model with one MoE layer, card
    against CPU from the same parameters, and that layer's routes.

    The MoE layer's router sees the layers before it, which the card sums
    in another order: a token whose top-k gates are nearly tied may choose
    another expert there (a flip, counted), and through the shared
    capacity a later token of that expert may be kept on one side and
    dropped on the other.  Every other token must agree: logits within
    LOGIT_RTOL / LOGIT_ATOL, route weights within ROUTE_RTOL /
    ROUTE_ATOL, kept events equal.  Returns what was read, as text."""
    (c_args, _, rc), (p_args, _, rp) = card_route, cpu_route
    vocab = card_logits.shape[-1]
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
              f"{label}: token {t} chose other experts on the card without "
              f"a near tie: top-{k + 1} gate gap {float(tie_gap[t])}, gates "
              f"differ by {float(drift[t])}")
    if bool(cascade.any()):
        check(bool(flips.any()) and int(flips.nonzero()[0]) <
              int(cascade.nonzero()[0]), f"{label}: a kept/dropped event "
              f"differs with no earlier flip to explain it")
    same = ~(flips | cascade)
    check(bool(same.any()), f"{label}: every token's route differs")
    lc = card_logits.cpu().reshape(-1, vocab)[same]
    lp = cpu_logits.reshape(-1, vocab)[same]
    logit_gap = float((lc - lp).abs().max())
    check(torch.allclose(lc, lp, rtol=LOGIT_RTOL, atol=LOGIT_ATOL),
          f"{label}: logits card vs CPU beyond rtol {LOGIT_RTOL} / atol "
          f"{LOGIT_ATOL}: max {logit_gap}")
    weight_gap = float((rc.weights.cpu() - rp.weights)[same].abs().max())
    check(torch.allclose(rc.weights.cpu()[same], rp.weights[same],
                         rtol=ROUTE_RTOL, atol=ROUTE_ATOL),
          f"{label}: route weights beyond tolerance: {weight_gap}")
    check(torch.equal(rc.event_slot.cpu()[same] >= 0, rp.kept[same]),
          f"{label}: kept events differ")
    if not bool(flips.any()):
        route_gap(rc, rp, label)
    return (f"the MoE layer's gate logits differ by at most "
            f"{logit_in_gap:.3e}; route flips from near ties "
            f"{int(flips.sum())} of {flips.numel()} tokens, kept/dropped "
            f"changes they cascade into {int(cascade.sum())}; on the "
            f"{int(same.sum())} other tokens logits max abs diff "
            f"{logit_gap:.3e} (within rtol {LOGIT_RTOL} / atol {LOGIT_ATOL}; "
            f"largest logit {float(lp.abs().max()):.3f}) and route weights "
            f"{weight_gap:.3e} (within rtol {ROUTE_RTOL} / atol {ROUTE_ATOL})")


# B1's group form: fabrics over one block's shared memory, of the paper's
# core (256 neurons, 512 CAM entries): 128 cores on one chip under every
# arbiter x NoC pair, and 256 cores as 16 chips x 16 cores at hier_tree
# under the three NoC schemes
GROUP_FABRICS = ((128, 1, SCHEMES), (256, 16, ("hier_tree",)))
GROUP_LAUNCHES = 40             # launches a profiled window


def grouped_fabric(dev, tag, max_err):
    """Phase 3's group form of B1 (`sparse_run_cuda` with G > 1 blocks a
    (tick, lane)) on each of `GROUP_FABRICS`: the kernel bitwise its plain
    version on two lanes of a stream whose RUN_BURST ticks overflow,
    unseeded and seeded by a non-zero acc0, with the per-core output
    (currents, table, sums, per-core terms); each pallas_sparse session's
    currents bitwise its xla twin's, one B1 launch a run; then G, the
    shared bytes a block and the device us a launch over TICKS Bernoulli
    RATE ticks, beside the bound by bytes.  Returns each fabric's numbers
    for the kernels line's B1 row."""
    from repro_torch.interface import Interface, InterfaceConfig, pipeline
    from repro_torch.interface.stats import StepStats
    from repro_torch.interface.types import random_connectivity
    from repro_torch.kernels.sparse_tick import kernel as sparse_kernel
    from repro_torch.kernels.sparse_tick import ops as sparse_ops
    from repro_torch.noc.topology import NocConfig

    start = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(SEED + 7)
    fields = len(StepStats._fields)
    whole = [StepStats._fields.index(f) for f in WHOLE_FIELDS]
    overflow = [t in RUN_BURST for t in range(RUN_TICKS)]
    sparse = [t for t in range(RUN_TICKS) if not overflow[t]]
    index = torch.tensor(sparse, dtype=torch.int32, device=dev)
    results = {}
    for cores, chips, schemes in GROUP_FABRICS:
        def config(scheme, noc, impl="pallas_sparse"):
            return InterfaceConfig(cores=cores, neurons_per_core=NEURONS,
                                   cam_entries_per_core=ENTRIES,
                                   scheme=scheme, noc=NocConfig(noc),
                                   impl=impl, chips=chips)
        fabric = f"{cores}x{NEURONS}x{ENTRIES} ({chips} chips)"
        base = config("hier_tree", "multicast_tree")
        params = random_connectivity(
            torch.Generator(dev).manual_seed(SEED + cores), base)
        routing = pipeline.build_routing_index(params, base)
        frames = torch.rand((RUN_LANES, RUN_TICKS, cores, NEURONS),
                            generator=gen, device=dev) < RATE
        cases = 0
        for noc in NOC_SCHEMES:
            tables = pipeline.build_tables(params, config("hier_tree", noc))
            for scheme in schemes:
                cfg = config(scheme, noc)
                label = f"group form {fabric} {scheme}/{noc}"
                plan = pipeline.make_plan(params, cfg, tables=tables,
                                          routing=routing)
                kplan = plan.run.kernel.plan
                check(kplan.grouped and kplan.groups > 1 and
                      kplan.smem <= sparse_kernel.MAX_SHARED_BYTES,
                      f"{label}: planned {kplan}")
                stream = frames & (frames.to(torch.int32).cumsum(-1)
                                   <= plan.run.capacity)
                stream[:, list(RUN_BURST)] = True
                acc0 = torch.rand((fields, RUN_LANES), generator=gen,
                                  device=dev) * 1000
                acc0[whole] = acc0[whole].round()
                for seed in (None, acc0):
                    cur = torch.full(tuple(stream.shape), math.nan,
                                     device=dev)
                    table = torch.full((RUN_TICKS, fields, RUN_LANES),
                                       math.nan, device=dev)
                    core = torch.full((2, RUN_TICKS, RUN_LANES, cores),
                                      math.nan, device=dev)
                    for t in RUN_BURST:
                        c, st = pipeline.dense_tick(plan, params,
                                                    stream[:, t])
                        cur[:, t], table[t] = c, torch.stack(tuple(st))
                    plain = (cur.clone(), table.clone(), core.clone())
                    acc = sparse_kernel.sparse_run_cuda(
                        stream, index, plan.run.kernel, cur, table, seed,
                        core)
                    want = sparse_ops.sparse_run_ref(
                        stream, sparse, plan.run, plain[0], plain[1], seed,
                        plain[2])
                    torch.cuda.synchronize()
                    for name, g, w in zip(
                            ("currents", "table", "sums", "per-core output"),
                            (cur, table, acc, core),
                            (plain[0], plain[1], want, plain[2])):
                        check(torch.equal(g.nan_to_num(-1.0),
                                          w.nan_to_num(-1.0)),
                              f"{label}{'' if seed is None else ' seeded'}: "
                              f"{name} differ from the plain version")
                        max_err["sparse_tick"] = max(
                            max_err["sparse_tick"],
                            float((g - w).nan_to_num(0.0).abs().max()))
                session = Interface(cfg).compile(params, device=dev)
                xla = Interface(dataclasses.replace(cfg, impl="xla")).compile(
                    params, device=dev)
                before = sparse_kernel.launches
                got = session.run_batched(stream)
                check(sparse_kernel.launches == before + 1,
                      f"{label}: {sparse_kernel.launches - before} B1 "
                      f"launches in a session run")
                check(torch.equal(got[0], xla.run_batched(stream)[0]),
                      f"{label}: session currents differ from the xla "
                      f"session's")
                cases += 1
        one = sparse_kernel.run_shared_bytes(
            cores, NEURONS, plan.run.kernel.src.shape[0], plan.run.capacity,
            plan.run.kernel.links.shape[-1])
        print(f"kernel == plain: sparse_run group form at {fabric}, G = "
              f"{kplan.groups} blocks a (tick, lane) of {kplan.smem} B of "
              f"shared memory (one block would need {one} B), "
              f"{cases} arbiter x NoC pairs, {RUN_LANES} lanes x {RUN_TICKS} "
              f"ticks (ticks {RUN_BURST} overflow), unseeded and seeded, "
              f"with the per-core output: currents, table, sums and "
              f"per-core terms bitwise; each pallas_sparse session's "
              f"currents bitwise the xla session's, 1 launch a run")

        # its time: one lane of TICKS Bernoulli RATE ticks at hier_tree /
        # multicast_tree, the bound counted as for the 16-core row
        kops = pipeline.make_plan(params, base, routing=routing).run.kernel
        run_frames = torch.rand((1, TICKS, cores, NEURONS), generator=gen,
                                device=dev) < RATE
        run_frames &= (run_frames.to(torch.int32).cumsum(-1)
                       <= kops.capacity)
        out = (torch.empty(tuple(run_frames.shape), device=dev),
               torch.empty((TICKS, fields, 1), device=dev))
        acc = sparse_kernel.sparse_run_cuda(run_frames, None, kops, *out)
        us = device_ms_per_call(
            lambda: sparse_kernel.sparse_run_cuda(run_frames, None, kops,
                                                  *out), GROUP_LAUNCHES,
            "sparse_run_kernel") * 1e3
        all_us = device_ms_per_call(
            lambda: sparse_kernel.sparse_run_cuda(run_frames, None, kops,
                                                  *out), GROUP_LAUNCHES) * 1e3
        flat = run_frames.reshape(TICKS, -1)
        hits = int((flat[:, routing.src_idx.reshape(-1).long()]
                    & routing.active.reshape(-1)).sum())
        events = int(flat.sum())
        sources = int(flat.any(0).sum())
        links = kops.links.shape[-1]
        moved = nbytes(kops.ptr, kops.src, kops.weight, run_frames, *out,
                       acc) + sources * (16 + 4 * links +
                                         (8 if chips > 1 else 0))
        ops = hits + events * links + 22 * TICKS + 2 * (flat.numel() +
                                                         4 * events)
        bound_ms, bound_by = bound(moved, ops, FP32_OPS_PER_S)
        print(f"{tag} sparse_run group form at {fabric} (hier_tree, "
              f"multicast_tree): G = {kops.plan.groups}, {kops.plan.smem} B "
              f"of shared memory a block, {us:.3f} us a launch for {TICKS} "
              f"Bernoulli {RATE} ticks = {us / TICKS:.4f} us a tick "
              f"(profiler, {GROUP_LAUNCHES} launches; {all_us:.3f} us of "
              f"device time a call with the scratch's zeroing); bound "
              f"{bound_ms * 1e3:.4f} us by {bound_by} ({moved} bytes at "
              f"3.35 TB/s; {ops} ops), kernel at "
              f"{bound_ms * 1e3 / us:.4f} of it")
        results[f"{cores}x{NEURONS}x{ENTRIES}_chips{chips}"] = {
            "groups": kops.plan.groups, "smem": kops.plan.smem, "us": us,
            "us_with_scratch": all_us, "bound_us": bound_ms * 1e3,
            "bound_by": bound_by}
    print(f"{tag} group form phase: {time.perf_counter() - start:.1f} s "
          f"(host clock)")
    return results


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
    # teacher-forced on the card and on the CPU from the same parameters
    # (route flips from near ties: `routed_card_vs_cpu`)
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
    check(bool(card["logits"].isfinite().all())
          and card["logits"].shape == (LM_CHECK_BATCH, LM_CHECK_TOKENS,
                                       cfg.vocab), "reduced logits shape")
    held = routed_card_vs_cpu("reduced-depth layer 1", cfg.moe.top_k,
                              card_routes[0], cpu_routes[0], card["logits"],
                              cpu["logits"])
    print(f"LM card vs CPU port, full width cut to 2 layers (dense layer 0, "
          f"MoE layer 1), float32, teacher-forced on {LM_CHECK_BATCH} x "
          f"{LM_CHECK_TOKENS} tokens: {held}")
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

    # device profile of a shorter generate (the prefill and
    # DENSE_PROFILE_STEPS decode steps): the profiler's event list of the
    # whole generate (170,000 device ops) took ~80 s to build
    wall_us, events = device_events(lambda: engine.generate(
        prompts, DENSE_PROFILE_STEPS))
    check(bool(events), "the profiler recorded no device op in generate")
    profile_ops = n_moe * (1 + DENSE_PROFILE_STEPS)
    busy_us = sum(e.device_time_total for e in events)
    by_name = {}
    for e in events:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.device_time_total, count + 1)
    b5 = {kernel: sum(c for n, (_, c) in by_name.items() if kernel in n)
          for kernel in moe_kernel.KERNEL_NAMES}
    check(all(c == profile_ops for c in b5.values()),
          f"profile: B5 kernels {b5}, want {profile_ops} of each")
    print(f"{tag} profile generate (prefill and {DENSE_PROFILE_STEPS} decode "
          f"steps): wall {wall_us:.1f} us (host clock, profiler on), device "
          f"busy {busy_us:.1f} us in {len(events)} device ops, idle share "
          f"{1 - busy_us / wall_us:.4f}; B5 kernels counted {b5} against "
          f"{n_moe} x {1 + DENSE_PROFILE_STEPS} = {profile_ops} ops")
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
    check(tree_bitwise(first, second), f"two uninterrupted {DRILL_STEPS}-step "
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
          and tree_bitwise(drilled, first),
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


def pallas_stream_form(dev, tag, reset_launches, read_launches, no_launch,
                       streams):
    """impl="pallas" at a scheme the whole-run hat kernel has no branch
    for: hier_ring at 16 x 512 (a non-square n, so no closed-form tick
    latency).  B3's stream form (`hat_encode_cuda` over every (tick,
    lane, core) bitmap of a run, one launch) writes the AER streams, the
    simulator gives the latency; currents bitwise the xla session's,
    stats under the conformance contract, on both streams widened to 512
    neurons.  Returns B3's stream-form launches."""
    from repro_torch.interface import Interface, InterfaceConfig
    from repro_torch.interface.types import random_connectivity
    from repro_torch.kernels.hat_encode import kernel as hat_kernel
    from repro_torch.kernels.hat_encode import ref as hat_ref
    from repro_torch.noc.topology import NocConfig

    n = 2 * NEURONS
    cfg = InterfaceConfig(cores=CORES, neurons_per_core=n,
                          cam_entries_per_core=ENTRIES, scheme="hier_ring",
                          noc=NocConfig("multicast_tree"), impl="pallas")
    params = random_connectivity(torch.Generator(dev).manual_seed(SEED + 7),
                                 cfg)
    pallas = Interface(cfg).compile(params)
    xla = Interface(dataclasses.replace(cfg, impl="xla")).compile(params)
    check(pallas.plan.hat.stream_form and pallas.plan.hat.args is None,
          "hier_ring at n=512: the pallas plan did not bind B3's stream form")
    # each stream's frames side by side: (T, C, 256) -> (T, C, 512)
    wide = {k: torch.cat([s, s.roll(1, dims=1)], dim=-1)
            for k, s in streams.items()}
    reset_launches()
    t0 = time.perf_counter()
    got = {k: pallas.run(s) for k, s in wide.items()}
    torch.cuda.synchronize()
    pallas_s = time.perf_counter() - t0
    launches = read_launches()
    ticks_all = sum(s.shape[0] for s in wide.values())
    check(launches == {**no_launch, "cam_search": ticks_all,
                       "hat_encode_one_tick": len(wide)},
          f"pallas at hier_ring n={n} launches {launches}: want cam_search "
          f"once a tick and B3's stream form once a run")
    t0 = time.perf_counter()
    want = {k: xla.run(s) for k, s in wide.items()}
    torch.cuda.synchronize()
    xla_s = time.perf_counter() - t0
    for name in wide:
        (cur, st), (ref_cur, ref_st) = got[name], want[name]
        check(cur.shape == ref_cur.shape and bool(cur.isfinite().all()),
              f"hier_ring {name}: currents shape/finite")
        check(torch.equal(cur, ref_cur),
              f"pallas hier_ring n={n} {name}: currents != xla session")
        check_stats(f"pallas hier_ring n={n} {name}", st, ref_st)
        print(f"{name} at hier_ring, {CORES} x {n}: pallas (B3 stream "
              f"form) == xla on the card (currents bitwise, stats under "
              f"the conformance contract); per-tick means "
              f"{json.dumps(st.summary(ticks=cur.shape[0]))}")
    print(f"main path pallas at hier_ring {CORES} x {n} (no closed-form "
          f"latency, B3's stream form): launches over {ticks_all} ticks "
          f"{launches}")
    # the stream form's one launch a run, on the first stream's frames:
    # device time against its plain version (ranks, then compact_stream)
    # and the bytes bound (each frame byte read once; ranks, stream,
    # counts and cluster counts written once)
    first = next(iter(wide))
    frames = wide[first][:, None]
    outs = hat_kernel.hat_encode_cuda(frames, row=256, stream=True)
    kernel_ms = device_ms_per_call(
        lambda: hat_kernel.hat_encode_cuda(frames, row=256, stream=True), 40,
        "hat_encode_kernel")

    def plain():
        ranks, count, _ = hat_ref.hat_encode_ref(frames, row=256)
        return hat_ref.compact_stream(ranks, count)
    plain_ms = device_ms_per_call(plain, 10)
    want = hat_ref.hat_encode_ref(frames, row=256)
    check(all(torch.equal(a, b) for a, b in zip(outs[:2], want[:2]))
          and torch.equal(outs[3], hat_ref.compact_stream(*want[:2])),
          "the stream form's ranks, counts or AER streams != plain")
    bound_ms, by = bound(nbytes(frames, *(o for o in outs if o is not None)),
                         frames.numel(), INT32_OPS_PER_S)
    print(f"{tag} hat_encode stream form (hat_encode_kernel) at hier_ring "
          f"{CORES} x {n}, {frames.shape[0]} {first} ticks in one launch: "
          f"{kernel_ms * 1e3:.3f} us per launch (profiler, 40 launches); "
          f"plain version {plain_ms * 1e3:.3f} us; bound "
          f"{bound_ms * 1e3:.4f} us by {by}; outputs bitwise the plain "
          f"version's")
    print(f"{tag} session pallas hier_ring {CORES} x {n}: "
          f"{pallas_s * 1e3 / ticks_all:.4f} ms/tick over both streams "
          f"(one run each, host clock, synchronized); xla "
          f"{xla_s * 1e3 / ticks_all:.4f} ms/tick (the simulator's latency "
          f"tick by tick)")
    return launches["hat_encode_one_tick"]


def lm_tree_gap(card, cpu, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    """The largest |card - cpu| over two trees of tensors, and whether
    every leaf is within ``rtol`` of each element plus ``atol`` of the
    CPU leaf's largest magnitude."""
    gap, ok = 0.0, True
    for a, b in zip(_leaves(card), _leaves(cpu)):
        a = a.detach().cpu().float()
        b = b.detach().float()
        d = (a - b).abs()
        gap = max(gap, float(d.max()))
        ok &= bool((d <= rtol * b.abs() + atol
                    * float(b.abs().max())).all())
    return gap, ok


def dense_lms(dev, tag, reset_launches, read_launches, no_launch):
    """The dense GQA LMs on the card: each of the four architectures at
    full width cut to one layer group (2 layers; gemma3-12b 6) in
    float32, card against the CPU port; banded against masked full
    attention at gemma3's head shapes; internlm2-1.8b and gemma3-12b
    served at full width and depth; internlm2-1.8b trained at full width
    and depth (train_4k's seq_len 4096, batch DENSE_TRAIN_BATCH, remat),
    its restart drill bitwise at a 2-layer cut and one step card against
    CPU at the 2-layer float32 cut.  No kernel launches on these paths."""
    import tempfile

    from repro_torch import configs
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.ft import FailureInjector, run_training, \
        run_with_restarts
    from repro_torch.models import blocks, lm
    from repro_torch.optim import adamw
    from repro_torch.train import step as train_step

    gen = torch.Generator(dev).manual_seed(SEED + 5)
    clock = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"dense LM phase {what}: {now - clock[0]:.1f} s (host clock)")
        clock[0] = now

    # ---- each architecture at full width, one layer group, float32 ------
    for arch in DENSE_ARCHS:
        cfg = configs.get_config(arch)
        small = dataclasses.replace(
            cfg, n_layers=2 if cfg.scan_group == 1 else cfg.scan_group,
            compute_dtype="float32")
        params = lm.init_model(torch.Generator(dev).manual_seed(SEED), small)
        cpu_params = tree_to(params, "cpu")
        tokens = torch.randint(0, cfg.vocab, (LM_CHECK_BATCH,
                                              DENSE_CHECK_TOKENS),
                               generator=gen, device=dev, dtype=torch.int32)
        reset_launches()
        with torch.no_grad():
            card = lm.forward(params, {"tokens": tokens}, small)["logits"]
            torch.cuda.synchronize()
            launches = read_launches()
            cpu = lm.forward(cpu_params, {"tokens": tokens.cpu()},
                             small)["logits"]
        check(launches == no_launch, f"{arch} forward launched {launches}")
        check(card.shape == (LM_CHECK_BATCH, DENSE_CHECK_TOKENS, cfg.vocab)
              and bool(card.isfinite().all()), f"{arch} logits shape/finite")
        gap = float((card.cpu() - cpu).abs().max())
        check(torch.allclose(card.cpu(), cpu, rtol=LOGIT_RTOL,
                             atol=LOGIT_ATOL),
              f"{arch} 2-layer full-width logits card vs CPU beyond rtol "
              f"{LOGIT_RTOL} / atol {LOGIT_ATOL}: max {gap}")
        n_params = sum(t.numel() for t in _leaves(params))
        print(f"LM {arch} card vs CPU port, full width cut to "
              f"{small.n_layers} layers ({n_params} float32 parameters), "
              f"teacher-forced on {LM_CHECK_BATCH} x {DENSE_CHECK_TOKENS} "
              f"tokens: logits max abs diff {gap:.3e} (within rtol "
              f"{LOGIT_RTOL} / atol {LOGIT_ATOL}; largest logit "
              f"{float(cpu.abs().max()):.3f})")
        del params, cpu_params, card, cpu
        torch.cuda.empty_cache()
    lap("2-layer cuts card vs CPU")

    # ---- banded attention against masked full attention, gemma3's heads ---
    g3 = configs.get_config("gemma3-12b")
    kh, rep, dh = g3.n_kv_heads, g3.n_rep, g3.head_dim
    t = BANDED_TOKENS
    q = torch.randn((1, t, kh, rep, dh), generator=gen, device=dev)
    k = torch.randn((1, t, kh, dh), generator=gen, device=dev)
    v = torch.randn((1, t, kh, dh), generator=gen, device=dev)
    with torch.no_grad():
        banded = blocks.banded_attention(q, k, v, window=g3.sliding_window)
        full = blocks.flash_attention(q, k, v, causal=True,
                                      window=g3.sliding_window)
        gap = float((banded - full).abs().max())
        check(torch.allclose(banded, full, rtol=1e-5, atol=1e-6),
              f"banded vs masked flash attention beyond rtol 1e-5 / atol "
              f"1e-6: max {gap}")
        band_ms = cuda_ms(lambda: blocks.banded_attention(
            q, k, v, window=g3.sliding_window), 20)
        full_ms = cuda_ms(lambda: blocks.flash_attention(
            q, k, v, causal=True, window=g3.sliding_window), 20)
    print(f"banded_attention vs masked flash_attention on the card at "
          f"gemma3-12b's heads (T {t}, window {g3.sliding_window}, {kh} x "
          f"{rep} heads of {dh}, float32): max abs diff {gap:.3e} (within "
          f"rtol 1e-5 / atol 1e-6)")
    print(f"{tag} attention at T {t}: banded {band_ms:.3f} ms, masked full "
          f"(flash, every chunk pair) {full_ms:.3f} ms a call (CUDA events, "
          f"20 calls)")
    del q, k, v, banded, full
    lap("banded vs masked attention")

    # ---- served at full width and depth ---------------------------------
    for arch, (batch, prompt) in DENSE_SERVE.items():
        serve_dense(dev, tag, reset_launches, read_launches, no_launch,
                    configs.get_config(arch), batch, prompt, gen)
        lap(f"served {arch}")

    # ---- internlm2-1.8b trained at full width and depth --------------------
    cfg = configs.get_config("internlm2-1.8b")
    opt = adamw.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100)
    train_lm_full(dev, tag, reset_launches, read_launches, no_launch, cfg,
                  opt, DENSE_TRAIN_SEQ, DENSE_TRAIN_BATCH, DENSE_TRAIN_STEPS)
    lap("trained internlm2-1.8b")

    # ---- the restart drill at a 2-layer cut (bitwise) ----------------------
    cut = dataclasses.replace(cfg, n_layers=2)
    dpipe = Pipeline(cut, DataConfig(global_batch=DENSE_DRILL_BATCH,
                                     seq_len=DENSE_DRILL_SEQ, seed=SEED),
                     device=dev)
    dstep = train_step.make_train_step(cut, opt, remat=True)

    def fresh():
        return train_step.init_state(torch.Generator(dev).manual_seed(SEED),
                                     cut, opt)

    # both the drill and the card-vs-CPU step hold the card to itself
    # bitwise: the embedding's backward accumulates repeated tokens, which
    # needs the deterministic kernels
    torch.use_deterministic_algorithms(True, warn_only=True)
    logs = []
    try:
        with tempfile.TemporaryDirectory() as d:
            # the uninterrupted run keeps only its final checkpoint (6 GB
            # a checkpoint at this cut)
            clean, _ = run_training(
                dstep, fresh(), dpipe, num_steps=DENSE_DRILL_STEPS,
                manager=CheckpointManager(os.path.join(d, "clean"),
                                          every=DENSE_DRILL_STEPS, keep=1),
                logger=logs.append)
            drilled, history = run_with_restarts(
                fresh, dstep, dpipe, num_steps=DENSE_DRILL_STEPS,
                manager=CheckpointManager(os.path.join(d, "drill"),
                                          every=DENSE_DRILL_EVERY, keep=1),
                injector=FailureInjector(fail_at_steps=(DENSE_DRILL_FAIL,)),
                logger=logs.append)
        resumed = DENSE_DRILL_FAIL - DENSE_DRILL_FAIL % DENSE_DRILL_EVERY
        lap("restart drill")
        dense_step_card_vs_cpu(dev, cut, opt)
        lap("one step card vs CPU")
    finally:
        torch.use_deterministic_algorithms(False)
    check(any(f"resumed from step {resumed}" in line for line in logs)
          and len(history) == DENSE_DRILL_STEPS - resumed,
          f"LM restart drill: {logs}")
    check(tree_bitwise(drilled, clean), "LM restart drill's final state != "
          "the uninterrupted run's")
    print(f"train LM {cut.name} cut to 2 layers at full width on the card "
          f"(deterministic algorithms on): {DENSE_DRILL_STEPS} steps at "
          f"seq_len {DENSE_DRILL_SEQ}, batch {DENSE_DRILL_BATCH}; "
          f"run_with_restarts with a failure at step {DENSE_DRILL_FAIL}, "
          f"checkpoints every {DENSE_DRILL_EVERY}, resumed from step "
          f"{resumed}: final state bitwise the uninterrupted run's")
    del clean, drilled
    torch.cuda.empty_cache()


def train_lm_full(dev, tag, reset_launches, read_launches, no_launch, cfg,
                  opt, seq, batch_size, steps):
    """``cfg`` trained on the card from parameters drawn there: one
    warm-up step and ``steps`` timed ones at ``seq`` x ``batch_size``
    tokens, remat on; finite losses, no kernel launched; ms a step
    (median and quartiles), tokens/s, one step split into forward,
    backward and update (each stage synchronized), a step's device
    profile and peak memory."""
    from repro_torch.ckpt.manager import tree_leaves
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import step as train_step

    torch.cuda.reset_peak_memory_stats()
    state = train_step.init_state(torch.Generator(dev).manual_seed(SEED),
                                  cfg, opt)
    pipe = Pipeline(cfg, DataConfig(global_batch=batch_size, seq_len=seq,
                                    seed=SEED), device=dev)
    step = train_step.make_train_step(cfg, opt, remat=True)
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    reset_launches()
    state, m = step(state, pipe.batch(0))            # warm-up
    torch.cuda.synchronize()
    check(read_launches() == no_launch, f"{cfg.name} training launched a "
          f"kernel")
    check(math.isfinite(float(m["loss"])), f"{cfg.name} training loss "
          f"{m['loss']}")
    step_ms, losses = [], [float(m["loss"])]
    for i in range(1, 1 + steps):
        batch = pipe.batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    check(all(math.isfinite(x) for x in losses), f"LM losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    q1, med, q3 = statistics.quantiles(step_ms, n=4)
    tokens = batch_size * seq
    print(f"trained LM {cfg.name} at full width and depth ({n_params} "
          f"{cfg.param_dtype} parameters, AdamW {opt.moment_dtype} moments), "
          f"seq_len {seq}, batch {batch_size}, remat=True: losses "
          f"{[round(x, 4) for x in losses]}; peak {peak:.2f} GiB allocated")
    print(f"{tag} trained LM {cfg.name}: median {med:.3f} ms/step "
          f"(quartiles {q1:.3f}-{q3:.3f}; {steps} steps after a warm-up, "
          f"host clock, synchronized) = {tokens / med * 1e3:.1f} tokens/s")

    # the split: each stage synchronized at its ends
    spent = {}

    def synced(label, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[label] = spent.get(label, 0.0) + time.perf_counter() - t
            return out
        return wrapper

    stages = (("forward (lm.forward)", lm, "forward"),
              ("backward (torch.autograd.grad, remat's recompute in it)",
               torch.autograd, "grad"),
              ("update (adamw.update)", adamw, "update"))
    saved = [(o, a, getattr(o, a)) for _, o, a in stages]
    batch = pipe.batch(steps + 1)
    for label, owner, attr in stages:
        setattr(owner, attr, synced(label, getattr(owner, attr)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for owner, attr, orig in saved:
            setattr(owner, attr, orig)
    parts = "; ".join(f"{k} {v * 1e3:.3f}" for k, v in spent.items())
    print(f"{tag} trained LM {cfg.name} step split (each stage synchronized):"
          f" total {total * 1e3:.3f} ms = {parts}; the rest (loss, tree "
          f"walks) {(total - sum(spent.values())) * 1e3:.3f}")
    wall_us, events = device_events(lambda: step(state, batch), captures=4)
    check(bool(events), "the profiler recorded no device op in a step")
    busy_us = sum(e.device_time_total for e in events)
    print(f"{tag} profile trained LM {cfg.name} step: wall {wall_us:.1f} us "
          f"(host clock, profiler on), device busy {busy_us:.1f} us in "
          f"{len(events)} device ops, idle share "
          f"{1 - busy_us / wall_us:.4f}")
    print_top(tag, events, 10)
    del state, step, m, batch
    torch.cuda.empty_cache()


def tree_bitwise(a, b) -> bool:
    """Two trees of tensors equal leaf by leaf, types and bits."""
    from repro_torch.ckpt.manager import tree_leaves
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def dense_step_card_vs_cpu(dev, cut, opt, grad_rtol=GRAD_RTOL,
                           grad_atol=GRAD_ATOL):
    """One training step of ``cut`` in float32 on the card and on the CPU
    port from the same parameters and batch: the loss within 1e-5
    relative, gradients within ``grad_rtol`` of each element plus
    ``grad_atol`` of each leaf's largest, parameters within what that gap
    can move them (AdamW's first step moves an element by about lr g /
    (|g| + eps), so a gap of tol by at most 2 lr min(1, tol / |g|)); and
    the card's step bitwise `adamw.update` of the card's own gradient."""
    from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models import blocks
    from repro_torch.optim import adamw
    from repro_torch.train import step as train_step

    cut32 = dataclasses.replace(cut, compute_dtype="float32")
    card_state = train_step.init_state(
        torch.Generator(dev).manual_seed(SEED), cut32, opt)
    cpu_state = train_step.TrainState(
        tree_to(card_state.params, "cpu"), adamw.AdamWState(
            card_state.opt.step.cpu(), tree_to(card_state.opt.mu, "cpu"),
            tree_to(card_state.opt.nu, "cpu")), card_state.step.cpu())
    cbatch = Pipeline(cut32, DataConfig(global_batch=LM_CHECK_BATCH,
                                        seq_len=DENSE_CHECK_TOKENS,
                                        seed=SEED), device="cpu").batch(0)
    grads = {}
    for where, st, b in (("card", card_state, tree_to(cbatch, dev)),
                         ("cpu", cpu_state, cbatch)):
        loss, _, g = train_step.value_and_grad(st.params, b, cut32,
                                                blocks.LOCAL, True, None)
        grads[where] = (loss, g)
    loss_gap = abs(float(grads["card"][0]) - float(grads["cpu"][0]))
    check(math.isclose(float(grads["card"][0]), float(grads["cpu"][0]),
                       rel_tol=1e-5), f"LM step loss card vs CPU: {loss_gap}")
    grad_gap, ok = lm_tree_gap(grads["card"][1], grads["cpu"][1], grad_rtol,
                               grad_atol)
    check(ok, f"LM step gradients card vs CPU beyond rtol {grad_rtol} / "
          f"atol {grad_atol} of each leaf's largest: max {grad_gap}")
    new_card, mc = train_step.make_train_step(cut32, opt)(
        card_state, tree_to(cbatch, dev))
    own, _, _ = adamw.update(
        opt, tree_unflatten(card_state.params, grads["card"][1]),
        card_state.opt, card_state.params)
    check(tree_bitwise(new_card.params, own), "the card's step != "
          "adamw.update of the card's own gradient")
    new_cpu, _ = train_step.make_train_step(cut32, opt)(cpu_state, cbatch)
    lr = float(mc["lr"])
    param_gap = 0.0
    for a, b, g in zip(tree_leaves(new_card.params),
                       tree_leaves(new_cpu.params),
                       tree_leaves(grads["cpu"][1])):
        a, b, g = a.cpu(), b, g.abs()
        tol = grad_rtol * g + grad_atol * float(g.max())
        bound = (2 * lr * torch.clamp(tol / g.clamp_min(1e-30), max=1.0)
                 + 1e-6 * float(b.abs().max()))
        param_gap = max(param_gap, float((a - b).abs().max()))
        check(bool(((a - b).abs() <= bound).all()),
              "LM step parameters card vs CPU beyond what the gradient gap "
              "moves them")
    print(f"train LM {cut32.name} one step at the 2-layer float32 cut, card "
          f"vs CPU port on {LM_CHECK_BATCH} x {DENSE_CHECK_TOKENS} tokens: "
          f"loss {float(grads['cpu'][0]):.6f}, diff {loss_gap:.3e} (rtol "
          f"1e-5); gradients max abs diff {grad_gap:.3e} (within rtol "
          f"{grad_rtol} / atol {grad_atol} of each leaf's largest); "
          f"parameters max abs diff {param_gap:.3e} (within 2 lr min(1, "
          f"gradient tolerance / |g|) + 1e-6 of each leaf's largest); the "
          f"card's step bitwise adamw.update of its own gradient")
    del card_state, cpu_state, new_card, new_cpu, own, grads
    torch.cuda.empty_cache()


def hybrid_lms(dev, tag, reset_launches, read_launches, no_launch):
    """The rest of the registry on the card: each of rwkv6-3b, jamba (its
    Mamba + MoE and Mamba + dense layers), hubert-xlarge, phi-3-vision
    (with its image prefix) and deepseek-v2-236b (bfloat16 and int8
    experts) at full width cut to 2 layers, float32 compute, card against
    the CPU port (int8 against bfloat16 logits within INT8_REL); one
    training step card against CPU at rwkv6-3b's cut; rwkv6-3b served at
    full width and depth; jamba's first JAMBA_LAYERS layers served at
    full width (B5 once per MoE layer per forward, every launch held to
    its plain version); phi-3-vision served after its image prefix;
    hubert-xlarge encoding; rwkv6-3b trained at full width and depth.
    Returns the B5 launches of one served jamba generate."""
    from repro_torch import configs
    from repro_torch.core import event_router
    from repro_torch.data.pipeline import AUDIO_MASK_RATE
    from repro_torch.kernels.moe_dispatch import kernel as moe_kernel
    from repro_torch.kernels.moe_dispatch import ref as moe_ref
    from repro_torch.models import blocks, lm, mamba, rwkv6
    from repro_torch.optim import adamw

    gen = torch.Generator(dev).manual_seed(SEED + 6)
    clock = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"hybrid LM phase {what}: {now - clock[0]:.1f} s (host clock)")
        clock[0] = now

    def hold_b5(calls, label):
        """Every captured B5 launch against its plain version on the same
        expert ids, integer for integer."""
        for args, _, (pos, load) in calls:
            want_pos, want_load = moe_ref.dispatch_positions_ref(*args)
            check(torch.equal(pos, want_pos) and torch.equal(load, want_load),
                  f"{label}: B5 differs from its plain version at "
                  f"{args[0].numel()} events x {args[1]} experts")
        return len(calls)

    def inputs(cfg, batch, tokens):
        """A batch of ``cfg``'s family on the card: tokens, audio frames
        with a mask, or tokens after the full image prefix."""
        fe = cfg.frontend
        if fe.kind == "audio":
            return {"frames": torch.randn((batch, tokens, fe.d_in),
                                          generator=gen, device=dev),
                    "mask": torch.rand((batch, tokens), generator=gen,
                                       device=dev) < AUDIO_MASK_RATE}
        out = {"tokens": torch.randint(0, cfg.vocab, (batch, tokens),
                                       generator=gen, device=dev,
                                       dtype=torch.int32)}
        if fe.kind == "vision":
            out["image_embeds"] = torch.randn((batch, fe.max_prefix,
                                               fe.d_in), generator=gen,
                                              device=dev)
        return out

    # ---- each architecture at full width cut to 2 layers, float32 -------
    def card_vs_cpu(label, cut, batch):
        """``cut`` drawn on the card and copied to the CPU, teacher-forced
        on ``batch`` on both; returns the card's logits."""
        params = lm.init_model(torch.Generator(dev).manual_seed(SEED), cut)
        note = param_note(params)
        cpu_params = tree_to(params, "cpu")
        n_moe = sum(cut.layer_is_moe(i) for i in range(cut.n_layers))
        reset_launches()
        with torch.no_grad():
            with Capture(event_router, "hat_route") as card_routes, \
                    Capture(moe_kernel, "dispatch_positions_cuda") as b5:
                card = lm.forward(params, batch, cut)["logits"]
            torch.cuda.synchronize()
            launches = read_launches()
            with Capture(event_router, "hat_route") as cpu_routes:
                cpu = lm.forward(cpu_params, tree_to(batch, "cpu"),
                                 cut)["logits"]
        check(launches == {**no_launch, "moe_dispatch": n_moe},
              f"{label} forward launched {launches}")
        held_b5 = hold_b5(b5, label)
        t = DENSE_CHECK_TOKENS + (cut.frontend.max_prefix
                                  if cut.frontend.kind == "vision" else 0)
        check(card.shape == (LM_CHECK_BATCH, t, cut.vocab)
              and bool(card.isfinite().all()), f"{label} logits "
              f"shape/finite")
        if n_moe:
            check(len(card_routes) == len(cpu_routes) == 1,
                  f"{label}: one MoE layer routes")
            held = routed_card_vs_cpu(label, cut.moe.top_k, card_routes[0],
                                      cpu_routes[0], card, cpu)
        else:
            gap = float((card.cpu() - cpu).abs().max())
            check(torch.allclose(card.cpu(), cpu, rtol=LOGIT_RTOL,
                                 atol=LOGIT_ATOL),
                  f"{label} 2-layer full-width logits card vs CPU beyond "
                  f"rtol {LOGIT_RTOL} / atol {LOGIT_ATOL}: max {gap}")
            held = (f"logits max abs diff {gap:.3e} (within rtol "
                    f"{LOGIT_RTOL} / atol {LOGIT_ATOL}; largest logit "
                    f"{float(cpu.abs().max()):.3f})")
        print(f"LM {label} card vs CPU port, full width cut to 2 layers "
              f"({note}), float32 compute, teacher-forced on "
              f"{LM_CHECK_BATCH} x {t} positions: {held}; B5 launches "
              f"{held_b5}, each == its plain version")
        del params, cpu_params, cpu
        torch.cuda.empty_cache()
        return card

    for arch in HYBRID_CUTS:
        cfg = configs.get_config(arch)
        cut = dataclasses.replace(cfg, n_layers=2,
                                  scan_group=min(cfg.scan_group, 2),
                                  compute_dtype="float32")
        if cfg.family == "hybrid":      # float32 weights: no per-use casts
            cut = dataclasses.replace(cut, param_dtype="float32")
        batch = inputs(cut, LM_CHECK_BATCH, DENSE_CHECK_TOKENS)
        card = card_vs_cpu(arch, cut, batch)
        if cfg.moe is not None and cfg.family == "moe":
            int8 = dataclasses.replace(cut, moe=dataclasses.replace(
                cut.moe, quant_int8=True))
            card_q = card_vs_cpu(f"{arch} int8 experts", int8, batch)
            rel = float((card_q - card).abs().max() / card.abs().max())
            check(0 < rel < INT8_REL, f"{arch}: int8 against bfloat16 "
                  f"experts, relative logit gap {rel}")
            print(f"LM {arch} int8 against bfloat16 experts on the card "
                  f"(the same float32 draws): largest logit gap over the "
                  f"largest logit {rel:.4f} (under {INT8_REL})")
            del card_q
        del card
        torch.cuda.empty_cache()
        lap(f"{arch} 2-layer cut card vs CPU")

    rwkv = configs.get_config("rwkv6-3b")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        dense_step_card_vs_cpu(dev, dataclasses.replace(rwkv, n_layers=2),
                               adamw.AdamWConfig(lr=3e-4, warmup_steps=2,
                                                 total_steps=100),
                               RWKV_GRAD_RTOL, RWKV_GRAD_ATOL)
    finally:
        torch.use_deterministic_algorithms(False)
    lap("rwkv6-3b one step card vs CPU")

    # ---- served at full width ---------------------------------------------
    serve_dense(dev, tag, reset_launches, read_launches, no_launch, rwkv,
                LM_BATCH, LM_PROMPT, gen, stages=(
                    ("time mix (time_mix_apply)", rwkv6, "time_mix_apply"),
                    ("  of it wkv_chunked", rwkv6, "wkv_chunked"),
                    ("  of it wkv_recurrent", rwkv6, "wkv_recurrent"),
                    ("channel mix (channel_mix_apply)", rwkv6,
                     "channel_mix_apply"),
                    ("final norm and head (_head)", lm, "_head")))
    lap("served rwkv6-3b")

    jamba = configs.get_config("jamba-1.5-large-398b")
    jcut = dataclasses.replace(jamba, n_layers=JAMBA_LAYERS,
                               scan_group=JAMBA_LAYERS)
    pattern = [(jcut.layer_kind(i), jcut.layer_is_moe(i))
               for i in range(JAMBA_LAYERS)]
    check(pattern == [("mamba", True), ("mamba", False), ("mamba", True),
                      ("attn", False)], f"jamba's first block: {pattern}")
    n_moe = sum(moe for _, moe in pattern)
    want = {**no_launch, "moe_dispatch": n_moe * (1 + DENSE_NEW_TOKENS)}
    launches, b5 = serve_dense(
        dev, tag, reset_launches, read_launches, no_launch, jcut, LM_BATCH,
        LM_PROMPT, gen, want_launches=want, stages=(
            ("Mamba (mamba_apply)", mamba, "mamba_apply"),
            ("  of it _ssm_scan_chunked", mamba, "_ssm_scan_chunked"),
            ("attention (attention_apply)", blocks, "attention_apply"),
            ("MoE (moe_apply)", blocks, "moe_apply"),
            ("  of it hat_route", event_router, "hat_route"),
            ("  of it _expert_ffn", blocks, "_expert_ffn"),
            ("dense MLP (mlp_apply)", blocks, "mlp_apply"),
            ("final norm and head (_head)", lm, "_head")))
    held = hold_b5(b5, "served jamba")
    print(f"served jamba-1.5-large-398b cut to its first {JAMBA_LAYERS} layers "
          f"({pattern}): B5 {launches['moe_dispatch']} launches a generate "
          f"({n_moe} MoE layers x {1 + DENSE_NEW_TOKENS} forwards, "
          f"{jcut.moe.num_experts} experts, top-{jcut.moe.top_k}), each of "
          f"the {held} == its plain version")
    lap("served jamba 4-layer cut")

    serve_vision(dev, tag, reset_launches, read_launches, no_launch,
                 configs.get_config("phi-3-vision-4.2b"), gen, inputs)
    lap("served phi-3-vision-4.2b")
    encode_audio(dev, tag, reset_launches, read_launches, no_launch,
                 configs.get_config("hubert-xlarge"), inputs)
    lap("hubert-xlarge encoding")

    # ---- rwkv6-3b trained at full width and depth ---------------------------
    # bfloat16 moments, the registry's override for jamba and
    # deepseek-v2-236b: the functional AdamW update holds the old and the
    # new trees at once, and seven float32 trees of 12.4 GB are more than
    # the card holds
    train_lm_full(dev, tag, reset_launches, read_launches, no_launch, rwkv,
                  adamw.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100,
                                    moment_dtype="bfloat16"),
                  RWKV_TRAIN_SEQ, RWKV_TRAIN_BATCH, RWKV_TRAIN_STEPS)
    lap("trained rwkv6-3b")
    return launches["moe_dispatch"]


def serve_vision(dev, tag, reset_launches, read_launches, no_launch, cfg,
                 gen, inputs):
    """``cfg`` (a vision LM) at full width and depth drawn on the card:
    `make_prefill_step` on LM_BATCH x (the image prefix + VISION_PROMPT
    tokens), then DENSE_NEW_TOKENS greedy `make_decode_step`s from
    cache_len = prefix + prompt; every step's logits finite, two runs
    equal; prefill ms, decode ms a step, tokens/s, the device profile and
    peak memory."""
    from repro_torch.models import lm
    from repro_torch.serve.lm_engine import make_decode_step, \
        make_prefill_step

    params = lm.init_model(torch.Generator(dev).manual_seed(SEED), cfg)
    prefix, steps = cfg.frontend.max_prefix, DENSE_NEW_TOKENS
    batch = inputs(cfg, LM_BATCH, VISION_PROMPT)
    start = prefix + VISION_PROMPT
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)

    @torch.no_grad()
    def run(n, times=None):
        cache = lm.init_cache(cfg, LM_BATCH, start + steps)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = prefill(params, batch, cache)
        torch.cuda.synchronize()
        spent = [(time.perf_counter() - t) * 1e3]
        finite, out = [bool(logits.isfinite().all())], []
        for i in range(n):
            t = time.perf_counter()
            nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
            out.append(nxt)
            logits, cache = decode(params, cache, nxt, start + i)
            torch.cuda.synchronize()
            spent.append((time.perf_counter() - t) * 1e3)
            finite.append(bool(logits.isfinite().all()))
        return torch.cat(out, 1), spent, finite

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out, _, finite = run(steps)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(launches == no_launch, f"served {cfg.name} launched {launches}")
    again, spent, finite2 = run(steps)
    check(all(finite + finite2), f"served {cfg.name}: a step's logits are "
          f"not finite")
    check(torch.equal(again, out) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab, f"served {cfg.name}: two greedy "
          f"runs differ or a token is out of range")
    dq1, dmed, dq3 = statistics.quantiles(spent[1:], n=4)
    total_s = sum(spent) / 1e3
    print(f"main path make_prefill_step + make_decode_step {cfg.name}: "
          f"{param_note(params)}; {LM_BATCH} requests x ({prefix} image "
          f"patches of {cfg.frontend.d_in} + {VISION_PROMPT} prompt tokens), "
          f"{steps} new tokens greedy from cache_len {start}; every step's "
          f"logits finite, two runs equal; launches {launches}; peak "
          f"{peak:.2f} GiB allocated")
    print(f"{tag} served LM {cfg.name}, {LM_BATCH} requests: prefill "
          f"{spent[0]:.3f} ms ({LM_BATCH} x {start} positions); decode "
          f"median {dmed:.3f} ms/step (quartiles {dq1:.3f}-{dq3:.3f}, "
          f"{steps} steps); {total_s * 1e3:.3f} ms in all = "
          f"{LM_BATCH * steps / total_s:.3f} new tokens/s (host clock, each "
          f"step synchronized); peak {peak:.2f} GiB")
    wall_us, events = device_events(lambda: run(DENSE_PROFILE_STEPS),
                                    captures=4)
    check(bool(events), f"the profiler recorded no device op in "
          f"{cfg.name}'s run")
    busy_us = sum(e.device_time_total for e in events)
    print(f"{tag} profile serve {cfg.name} (prefill and "
          f"{DENSE_PROFILE_STEPS} decode steps): wall {wall_us:.1f} us (host "
          f"clock, profiler on), device busy {busy_us:.1f} us in "
          f"{len(events)} device ops, idle share "
          f"{1 - busy_us / wall_us:.4f}")
    print_top(tag, events, 8)
    del params
    torch.cuda.empty_cache()


def encode_audio(dev, tag, reset_launches, read_launches, no_launch, cfg,
                 inputs):
    """``cfg`` (an audio encoder) at full width and depth drawn on the
    card: forwards on AUDIO_BATCH x AUDIO_FRAMES masked frames, logits
    finite over its units; ms a forward (median of AUDIO_RUNS), the device
    profile and peak memory; `loss_fn` on a `Pipeline` audio batch,
    finite."""
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models import lm
    from repro_torch.train import step as train_step

    params = lm.init_model(torch.Generator(dev).manual_seed(SEED), cfg)
    batch = inputs(cfg, AUDIO_BATCH, AUDIO_FRAMES)

    @torch.no_grad()
    def encode():
        return lm.forward(params, batch, cfg)["logits"]

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    logits = encode()
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(launches == no_launch, f"{cfg.name} launched {launches}")
    check(logits.shape == (AUDIO_BATCH, AUDIO_FRAMES, cfg.vocab)
          and bool(logits.isfinite().all()), f"{cfg.name} logits "
          f"shape/finite")
    spent = []
    for _ in range(AUDIO_RUNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        encode()
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t) * 1e3)
    pipe = Pipeline(cfg, DataConfig(global_batch=AUDIO_BATCH,
                                    seq_len=AUDIO_FRAMES, seed=SEED),
                    device=dev)
    with torch.no_grad():
        loss, _ = train_step.loss_fn(params, pipe.batch(0), cfg)
    check(math.isfinite(float(loss)), f"{cfg.name} loss {loss}")
    print(f"main path lm.forward {cfg.name} (encoder only, no decode): "
          f"{param_note(params)}, {cfg.compute_dtype} compute; "
          f"{AUDIO_BATCH} x {AUDIO_FRAMES} frames of {cfg.frontend.d_in} "
          f"features, {int(batch['mask'].sum())} masked; logits finite over "
          f"{cfg.vocab} units; launches {launches}; loss_fn on a Pipeline "
          f"audio batch {float(loss):.4f}; peak {peak:.2f} GiB allocated")
    med = statistics.median(spent)
    print(f"{tag} encode {cfg.name}: median {med:.3f} ms a forward of "
          f"{AUDIO_BATCH} x {AUDIO_FRAMES} frames (runs "
          f"{', '.join(f'{x:.3f}' for x in spent)}; host clock, "
          f"synchronized) = {AUDIO_BATCH * AUDIO_FRAMES / med * 1e3:.1f} "
          f"frames/s; peak {peak:.2f} GiB")
    wall_us, events = device_events(encode, captures=4)
    check(bool(events), f"the profiler recorded no device op in "
          f"{cfg.name}'s forward")
    busy_us = sum(e.device_time_total for e in events)
    print(f"{tag} profile encode {cfg.name}: wall {wall_us:.1f} us (host "
          f"clock, profiler on), device busy {busy_us:.1f} us in "
          f"{len(events)} device ops, idle share "
          f"{1 - busy_us / wall_us:.4f}")
    print_top(tag, events, 8)
    del params, logits
    torch.cuda.empty_cache()


def print_top(tag, events, count):
    by_name = {}
    for e in events:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.device_time_total, n + 1)
    for key, (us, n) in sorted(by_name.items(),
                               key=lambda r: -r[1][0])[:count]:
        print(f"{tag}   {us:10.1f} us  x{n:5d}  {key[:90]}")


def param_note(params) -> str:
    """The parameter count and bytes of a tree, by type."""
    by_type = {}
    for t in _leaves(params):
        n, b = by_type.get(t.dtype, (0, 0))
        by_type[t.dtype] = (n + t.numel(), b + t.numel() * t.element_size())
    count = sum(n for n, _ in by_type.values())
    return f"{count} parameters (" + ", ".join(
        f"{b / 1e9:.2f} GB {str(d).split('.')[-1]}"
        for d, (_, b) in by_type.items()) + ")"


def serve_dense(dev, tag, reset_launches, read_launches, no_launch, cfg,
                batch, prompt, gen, stages=None, want_launches=None):
    """``cfg`` at full width drawn on the card, served greedy: ``batch``
    requests of ``prompt`` tokens, DENSE_NEW_TOKENS new ones; every
    step's logits finite, two generates equal, the launches of the first
    ``want_launches`` (none when None); prefill ms, decode ms a step,
    tokens/s, the host split over ``stages`` (``(label, owner,
    attribute)``; the GQA attention and MLP when None), the device profile
    and peak memory.  Returns the launches of one generate and the B5
    calls it made (``Capture`` records)."""
    from repro_torch.kernels.moe_dispatch import kernel as moe_kernel
    from repro_torch.models import blocks, lm
    from repro_torch.serve.lm_engine import ServeEngine

    want_launches = no_launch if want_launches is None else want_launches
    if stages is None:
        stages = (("attention (attention_apply)", blocks, "attention_apply"),
                  ("  of it banded_attention", blocks, "banded_attention"),
                  ("  of it flash_attention", blocks, "flash_attention"),
                  ("  of it decode_attention", blocks, "decode_attention"),
                  ("MLP (mlp_apply)", blocks, "mlp_apply"),
                  ("final norm and head (_head)", lm, "_head"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm.init_model(torch.Generator(dev).manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"served LM {cfg.name}: {param_note(params)}, {cfg.compute_dtype} "
          f"compute, drawn on the card in {init_s:.3f} s; groups "
          f"{cfg.scan_groups()}; {torch.cuda.memory_allocated() / 2 ** 30:.2f}"
          f" GiB allocated")
    prompts = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen,
                            device=dev, dtype=torch.int32)
    steps = DENSE_NEW_TOKENS
    engine = ServeEngine(cfg, params, max_len=prompt + steps)
    step_ms = {"prefill": [], "decode": []}
    finite = []

    def timed(label, fn):
        def wrapper(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = fn(*args)
            torch.cuda.synchronize()
            step_ms[label].append((time.perf_counter() - t) * 1e3)
            finite.append(bool(logits.isfinite().all()))
            return logits, cache
        return wrapper

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with Capture(moe_kernel, "dispatch_positions_cuda") as b5_calls:
        out = engine.generate(prompts, steps)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(launches == want_launches, f"served {cfg.name} launched "
          f"{launches}, want {want_launches}")
    check(out.shape == (batch, steps) and out.dtype == torch.int32
          and int(out.min()) >= 0 and int(out.max()) < cfg.vocab,
          f"served {cfg.name} tokens shape/range")
    engine._prefill = timed("prefill", engine._prefill)
    engine._decode = timed("decode", engine._decode)
    torch.cuda.synchronize()
    t = time.perf_counter()
    again = engine.generate(prompts, steps)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    engine.__post_init__()
    check(all(finite) and len(finite) == 1 + steps,
          f"served {cfg.name}: a step's logits are not finite")
    check(torch.equal(again, out), f"served {cfg.name}: two greedy "
          f"generates differ")
    dq1, dmed, dq3 = statistics.quantiles(step_ms["decode"], n=4)
    print(f"main path ServeEngine.generate {cfg.name}: {batch} requests x "
          f"{prompt} prompt tokens, {steps} new tokens greedy; every step's "
          f"logits finite, two generates equal; launches {launches}; peak "
          f"{peak:.2f} GiB allocated")
    print(f"{tag} served LM {cfg.name}, {batch} requests: prefill "
          f"{step_ms['prefill'][0]:.3f} ms ({batch} x {prompt} tokens); "
          f"decode median {dmed:.3f} ms/step (quartiles {dq1:.3f}-{dq3:.3f}, "
          f"{steps} steps); generate {gen_s * 1e3:.3f} ms (that run, each "
          f"step synchronized) = {batch * steps / gen_s:.3f} new tokens/s "
          f"(host clock); peak {peak:.2f} GiB")
    total, spent = host_breakdown(lambda: engine.generate(prompts, steps),
                                  stages)
    top = sum(v for k_, v in spent.items() if not k_.startswith(" "))
    parts = "; ".join(f"{k_.strip()} {v * 1e3:.3f}" for k_, v in spent.items())
    print(f"{tag} host ms per generate {cfg.name} ({1 + steps} forwards): "
          f"total {total * 1e3:.3f} = {parts}; embedding, norms, sampling "
          f"and the wait for the device {(total - top) * 1e3:.3f}")
    # the profile of a shorter generate (the prefill and DENSE_PROFILE_STEPS
    # decode steps): the profiler's own processing grows with its events
    wall_us, events = device_events(
        lambda: engine.generate(prompts, DENSE_PROFILE_STEPS), captures=4)
    check(bool(events), f"the profiler recorded no device op in "
          f"{cfg.name}'s generate")
    busy_us = sum(e.device_time_total for e in events)
    print(f"{tag} profile generate {cfg.name} (prefill and "
          f"{DENSE_PROFILE_STEPS} decode steps): wall {wall_us:.1f} us (host "
          f"clock, profiler on), device busy {busy_us:.1f} us in "
          f"{len(events)} device ops, idle share "
          f"{1 - busy_us / wall_us:.4f}")
    print_top(tag, events, 8)
    del params, engine
    torch.cuda.empty_cache()
    return launches, b5_calls


# ---- the mesh (the sharded phase) ----------------------------------------

SHARD_RANKS = 4                 # a 2 x 2 (data, model) mesh, gloo, one card
SHARD_MESH = (2, 2)
SHARD_SERVE = ("internlm2-1.8b", 4, 128, 8)   # arch, batch, prompt, new
SHARD_CUT_TOKENS = 128          # the 2-layer float32 cuts: 4 x 128 tokens
SHARD_MLA_STEPS = 2             # deepseek's cut: decode steps after prefill
SHARD_TRAIN = (4, 512)          # internlm2-1.8b's 2-layer cut: batch, seq
SHARD_MICROBATCH = 2            # ... and its step again in 2 microbatches
# rwkv6-3b at full width and depth on the 2 x 2 mesh: batch, prompt, new
# tokens, and the rwkv_pad_heads served (0: the 40 heads whole on every
# model rank, as in the JAX package; 48: 24 padded heads a rank)
SHARD_RWKV = (4, 128, 8, (0, 48))
SHARD_RWKV_TRAIN = (4, 512, 48)     # its 2-layer cut: batch, seq, pad heads
# its 2-layer cut served on the 2 x 2 mesh with the production placement
# (the time mix's FSDP split kept: decode permutes each block to the
# model ranks, `models.blocks._linear`): layers, new tokens (the prompts
# of SHARD_RWKV)
SHARD_RWKV_FSDP = (2, 2)
# jamba-1.5-large-398b's first two layers (Mamba + MoE, Mamba + dense MLP)
# at full width, bfloat16 parameters (24.3 GB), float32 compute, on a
# 1 x 2 (data x model) mesh of ranks 0 and 1: layers, batch, prompt,
# decode steps
SHARD_JAMBA = (2, 4, 128, 2)
# where the ranks run and at which size: the card and the registry's
# configs; a CPU rehearsal sets {"device": "cpu", "smoke": True} (the
# ranks receive it from the parent)
SHARD_OPTS = {"device": "cuda", "smoke": False}


def _dev() -> torch.device:
    return torch.device(SHARD_OPTS["device"], 0) if SHARD_OPTS[
        "device"] == "cuda" else torch.device("cpu")


def _sync():
    if _dev().type == "cuda":
        torch.cuda.synchronize()


def _peak_reset() -> int:
    """Empty the cache, reset the peak; the bytes allocated now."""
    if _dev().type != "cuda":
        return 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak() -> int:
    if _dev().type != "cuda":
        return 0
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def _rank_setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False


def _rank_mesh():
    from repro_torch.launch import mesh as M
    from repro_torch.parallel import sharding as shd
    mesh = M.make_host_mesh(*SHARD_MESH, device=_dev().type)
    return mesh, shd.make_shard_ctx(mesh)


def _local_bytes(tree) -> tuple:
    """(this rank's bytes of a DTensor tree, the tree's full bytes)."""
    loc = full = 0
    for t in _leaves(tree):
        loc += t.to_local().numel() * t.element_size()
        full += t.numel() * t.element_size()
    return loc, full


class Widths:
    """While the block runs, record the width each call inside the mixers
    runs on, this rank: Mamba's scan its d_inner channels, the WKV and
    attention their heads (shapes only)."""

    SITES = (("mamba", "_ssm_scan_chunked", "Mamba d_inner", -1),
             ("rwkv6", "wkv_chunked", "WKV heads", 2),
             ("rwkv6", "wkv_recurrent", "WKV heads", 2),
             ("blocks", "flash_attention", "attention heads", 2))

    def __enter__(self):
        from repro_torch.models import blocks, mamba, rwkv6
        mods = {"mamba": mamba, "rwkv6": rwkv6, "blocks": blocks}
        self.seen, self.saved = set(), []
        for mod, name, tag, dim in self.SITES:
            inner = getattr(mods[mod], name)
            self.saved.append((mods[mod], name, inner))

            def run(a, *rest, _inner=inner, _tag=tag, _dim=dim, **kw):
                self.seen.add((_tag, a.shape[_dim]))
                return _inner(a, *rest, **kw)
            setattr(mods[mod], name, run)
        return self.seen

    def __exit__(self, *exc):
        for mod, name, inner in self.saved:
            setattr(mod, name, inner)


def _staged_since(before):
    """{op: (staged calls, bytes)} since ``before`` (`_staged_now`)."""
    from repro_torch.launch import staging
    return {op: (n - before[0].get(op, 0),
                 staging.BYTES[op] - before[1].get(op, 0))
            for op, n in staging.COUNTS.items()
            if n - before[0].get(op, 0)}


def _gathered_since(before):
    """{result shape: staged all-gathers} since ``before``
    (`_staged_now`)."""
    from repro_torch.launch import staging
    return {shape: n - before[2].get((op, shape), 0)
            for (op, shape), n in staging.SHAPES.items()
            if op == "all_gather_into_tensor"
            and n - before[2].get((op, shape), 0)}


def _staged_now():
    from repro_torch.launch import staging
    return dict(staging.COUNTS), dict(staging.BYTES), dict(staging.SHAPES)


def _in_turn(fn, order):
    """``fn()`` on the ranks in ``order``, one at a time, with a barrier
    of every rank after each turn, so that one full parameter tree at a
    time is on the card; this rank's result (None without a turn)."""
    import torch.distributed as dist
    out = None
    for r in order:
        if r == dist.get_rank():
            out = fn()
            if _dev().type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
        dist.barrier()
    return out


def _rank_probe(rank, world):
    """gloo collectives on CUDA tensors of this rank, each direct c10d op
    (gloo stages them through the host itself), then the functional ops
    DTensor uses, through the port's host staging (`launch/staging.py`),
    counted.  Returns {op: "ok" | error} and the staged counts."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.launch import mesh as M, staging
    dev = _dev()
    out = {}
    x = torch.arange(8, dtype=torch.float32, device=dev) + rank
    want_sum = sum(torch.arange(8.0) + r for r in range(world))
    ops = {
        "all_reduce": lambda: (dist.all_reduce(y := x.clone()), y)[1],
        "all_gather_into_tensor": lambda: (dist.all_gather_into_tensor(
            y := torch.empty(8 * world, device=dev), x), y)[1],
        "reduce_scatter_tensor": lambda: (dist.reduce_scatter_tensor(
            y := torch.empty(8 // world, device=dev), x), y)[1],
        "all_gather": lambda: (dist.all_gather(
            y := [torch.empty(8, device=dev) for _ in range(world)], x),
            torch.cat(y))[1],
        "all_to_all_single": lambda: (dist.all_to_all_single(
            y := torch.empty(8, device=dev), x), y)[1],
    }
    wants = {"all_reduce": want_sum,
             "all_gather_into_tensor": torch.cat(
                 [torch.arange(8.0) + r for r in range(world)]),
             "reduce_scatter_tensor": want_sum[rank * 2:rank * 2 + 2],
             "all_to_all_single": torch.cat(
                 [torch.arange(8.0)[rank * 2:rank * 2 + 2] + r
                  for r in range(world)])}
    wants["all_gather"] = wants["all_gather_into_tensor"]
    for name, fn in ops.items():
        try:
            got = fn().cpu()
            _sync()
            out[name] = "ok" if torch.equal(got, wants[name]) else "wrong"
        except Exception as e:  # noqa: BLE001 - the probe reports refusals
            out[name] = f"{type(e).__name__}: {str(e)[:200]}"
    mesh, _ = _rank_mesh()
    if dev.type == "cpu":               # the rehearsal runs the same code
        staging.install("CPU")
    staging.COUNTS.clear()
    d = DTensor.from_local(x[None], mesh, [Shard(0), Shard(0)],
                           run_check=False)
    full = d.full_tensor()                           # all_gather_into_tensor
    part = DTensor.from_local(x, mesh, [Partial(), Partial()],
                              run_check=False)
    summed = part.redistribute(mesh, [Replicate(), Replicate()])  # all_reduce
    scat = DTensor.from_local(x, mesh, [Partial(), Replicate()],
                              run_check=False).redistribute(
        mesh, [Shard(0), Replicate()])                # reduce_scatter_tensor
    _sync()
    want_full = torch.stack([torch.arange(8.0) + r for r in range(world)])
    out["staged_gather"] = torch.equal(full.cpu(), want_full)
    out["staged_all_reduce"] = torch.equal(summed.to_local().cpu(), want_sum)
    # the partial sum over data of ranks (data, model): rank r = 2 data +
    # model holds arange(8) + r; this rank keeps its data row's half
    data, model = divmod(rank, SHARD_MESH[1])
    pair = sum(torch.arange(8.0) + d * SHARD_MESH[1] + model
               for d in range(SHARD_MESH[0]))
    out["staged_reduce_scatter"] = torch.equal(
        scat.to_local().cpu(), pair[data * 4:(data + 1) * 4])
    out["staged"] = dict(staging.COUNTS)
    return out


def _rank_chips(rank, world, cfg, params, streams):
    """``run(shard="chips")`` of each stream at chips=world on this rank's
    chip: currents, stats, which body ran and host ms a tick (the run
    timed after one warm-up run)."""
    from repro_torch.interface import Interface
    from repro_torch.interface.types import InterfaceParams
    from repro_torch.launch import staging
    dev = _dev()
    session = Interface(cfg).compile(
        InterfaceParams(*(t.to(dev) for t in params)), device=dev)
    out = {}
    for name, spikes in streams.items():
        spikes = spikes.to(dev)
        session.run(spikes, shard="chips")
        _sync()
        before = sum(staging.COUNTS.values())
        t0 = time.perf_counter()
        cur, st = session.run(spikes, shard="chips")
        _sync()
        ms = (time.perf_counter() - t0) * 1e3 / spikes.shape[0]
        out[name] = (cur.cpu(), {k: v.cpu() for k, v in st._asdict().items()},
                     session.last_shard_body, ms,
                     sum(staging.COUNTS.values()) - before)
    return out


def _config(arch):
    from repro_torch import configs
    return (configs.get_smoke_config(arch) if SHARD_OPTS["smoke"]
            else configs.get_config(arch))


def _draw(arch, seed, layers=None, f32=False, **over):
    from repro_torch.models import lm
    cfg = _config(arch)
    if layers is not None and not SHARD_OPTS["smoke"]:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if f32:
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    cfg = dataclasses.replace(cfg, **over)
    return cfg, lm.init_model(torch.Generator(_dev()).manual_seed(seed), cfg,
                              device=_dev())


def _rank_serve(rank, world, seed, prompts):
    """internlm2-1.8b at full width and depth, float32 compute, on the
    2 x 2 mesh with the JAX package's serving placement (``serve_tp_only``:
    weights split over ``model`` only, so no step gathers weights):
    `_generate_on_mesh`, and this rank's parameter bytes."""
    from repro_torch.parallel import sharding as shd
    _rank_setup()
    arch, batch, prompt, new = SHARD_SERVE
    cfg, full = _draw(arch, seed, f32=True, serve_tp_only=True)
    mesh, _ = _rank_mesh()
    ctx = shd.make_shard_ctx(mesh, cfg)
    params = shd.shard_tree(full, shd.params_pspecs(full, cfg, ctx), mesh)
    del full
    out = _generate_on_mesh(cfg, params, mesh, prompts, new)
    out["param_bytes"] = _local_bytes(params)
    return out


def _generate_on_mesh(cfg, params, mesh, prompts, new):
    """``ServeEngine(..., ctx=ctx).generate`` on ``mesh`` (timed; the
    staged collectives it made, by op with their bytes, and its staged
    all-gathers by result shape; the widths the mixers ran on), then one
    prefill for its logits (rank 0 returns them), its own staged
    collectives (the gather of its logits left out) and peak memory,
    then one decode step at the cache's next position, its staged
    collectives and all-gathers by result shape, and the plans of its
    embedding lookups (`regions.product_plan` by kind; rank 0 returns
    its logits); the generate's peak memory above the parameters."""
    from repro_torch.models import lm
    from repro_torch.parallel import regions as R, sharding as shd
    from repro_torch.serve.lm_engine import (ServeEngine, make_decode_step,
                                             make_prefill_step)
    ctx = shd.make_shard_ctx(mesh, cfg)
    batch, prompt = prompts.shape
    base = _peak_reset()
    prompts = prompts.to(_dev())
    before = _staged_now()
    with Widths() as widths:
        t0 = time.perf_counter()
        tokens = ServeEngine(cfg, params, max_len=prompt + new,
                             ctx=ctx).generate(prompts, new)
        _sync()
        secs = time.perf_counter() - t0
    staged, gathered = _staged_since(before), _gathered_since(before)
    peak = _peak() - base
    cache = lm.init_cache(cfg, batch, prompt + new, device=_dev())
    cache = shd.shard_tree(cache, shd.cache_pspecs(cache, cfg, ctx), mesh)
    _peak_reset()
    before = _staged_now()
    logits, _ = make_prefill_step(cfg, ctx)(params, {"tokens": prompts},
                                            cache)
    _sync()
    prefill_staged = _staged_since(before)
    prefill_peak = _peak()
    before = _staged_now()
    with Capture(R, "product_plan") as plans:
        step, _ = make_decode_step(cfg, ctx)(params, cache, prompts[:, -1:],
                                             prompt)
    _sync()
    decode_staged = _staged_since(before)
    decode_gathered = _gathered_since(before)
    logits, step = R.full(logits), R.full(step)
    first = torch.distributed.get_rank() == 0
    return {"tokens": tokens.cpu(), "decode_staged": decode_staged,
            "decode_gathered": decode_gathered,
            "decode_lookup": sorted(out.kind for _, kw, out in plans
                                    if "lookup_dt" in kw and out is not None),
            "prefill": logits.float().cpu() if first else None,
            "decode": step.float().cpu() if first else None,
            "peak": peak, "s": secs, "staged": staged, "gathered": gathered,
            "prefill_staged": prefill_staged, "prefill_peak": prefill_peak,
            "widths": sorted(widths)}


def _gap_local(got, want_full, spec, mesh):
    """|this rank's block of ``got`` - the same block of the one-device
    ``want_full``|: largest, and ``want_full``'s largest."""
    from repro_torch.parallel import sharding as shd
    want = shd.local_slice(want_full, spec, mesh)
    return (float((got.to_local().float() - want.float()).abs().max()),
            float(want_full.float().abs().max()))


def _rank_cuts(rank, world, seed):
    """The 2-layer float32 cuts at full width on the 2 x 2 mesh against
    the one-device run on the card (each rank computes it for its own
    block): llama3.2-3b's sequence-parallel forward, deepseek-v2-lite's
    MLA prefill + decode with expert parallelism (each data shard routed
    alone, as on the mesh; B5 counted and every launch held to its plain
    version), and one internlm2-1.8b training step (batch 4, seq 512)
    with FSDP x TP placement: loss and gradient gaps, peak memory beside
    the one-device step's, this rank's parameter bytes."""
    from repro_torch.kernels.moe_dispatch import kernel as moe_kernel
    from repro_torch.kernels.moe_dispatch import ref as moe_ref
    from repro_torch.models import lm
    from repro_torch.ckpt.manager import tree_leaves
    from repro_torch.models.blocks import LOCAL, _bspec_for
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve.lm_engine import make_decode_step, make_prefill_step
    from repro_torch.train import step as ts
    _rank_setup()
    mesh, _ = _rank_mesh()
    data = mesh.get_local_rank("data")
    out = {}
    g = torch.Generator(_dev()).manual_seed(seed + 1)

    # llama3.2-3b: sequence-parallel attention
    cfg, full = _draw("llama3.2-3b", seed, layers=2, f32=True)
    ctx = shd.make_shard_ctx(mesh, cfg)
    toks = torch.randint(0, cfg.vocab, (SHARD_TRAIN[0], SHARD_CUT_TOKENS),
                         generator=g, device=_dev(), dtype=torch.int32)
    with torch.no_grad():
        want = lm.forward(full, {"tokens": toks}, cfg, remat=False)["logits"]
        params = shd.shard_tree(full, shd.params_pspecs(full, cfg, ctx), mesh)
        del full
        got = lm.forward(params, {"tokens": toks}, cfg, ctx=ctx,
                         remat=False)["logits"]
    bspec = _bspec_for(ctx, toks.shape[0])
    out["llama_sp"] = _gap_local(got, want, (bspec, None, "model"), mesh)
    del params, got, want
    _peak_reset()

    # deepseek-v2-lite-16b: MLA and expert parallelism
    cfg, full = _draw("deepseek-v2-lite-16b", seed, layers=2, f32=True)
    ctx = shd.make_shard_ctx(mesh, cfg)
    toks = torch.randint(0, cfg.vocab, (SHARD_TRAIN[0], SHARD_CUT_TOKENS),
                         generator=g, device=_dev(), dtype=torch.int32)
    n = toks.shape[0] // SHARD_MESH[0]
    mine = toks[data * n:(data + 1) * n]
    max_len = SHARD_CUT_TOKENS + SHARD_MLA_STEPS

    def serve(params, tokens, ctx_, cache):
        steps = []
        logits, _ = make_prefill_step(cfg, ctx_)(params, {"tokens": tokens},
                                                  cache)
        steps.append(logits)
        decode = make_decode_step(cfg, ctx_)
        nxt = toks[:, :1] if ctx_.enabled else tokens[:, :1]
        for i in range(SHARD_MLA_STEPS):
            logits, _ = decode(params, cache, nxt, SHARD_CUT_TOKENS + i)
            steps.append(logits)
        return steps

    with torch.no_grad():
        want = serve(full, mine, LOCAL,
                     lm.init_cache(cfg, n, max_len, device=_dev()))
        params = shd.shard_tree(full, shd.params_pspecs(full, cfg, ctx), mesh)
        del full
        cache = lm.init_cache(cfg, toks.shape[0], max_len, device=_dev())
        cache = shd.shard_tree(cache, shd.cache_pspecs(cache, cfg, ctx), mesh)
        moe_kernel.launches = 0
        with Capture(moe_kernel, "dispatch_positions_cuda") as b5, \
                Widths() as widths:
            got = serve(params, toks, ctx, cache)
        launches = moe_kernel.launches
    held = all(torch.equal(pos, moe_ref.dispatch_positions_ref(*args)[0])
               and torch.equal(load, moe_ref.dispatch_positions_ref(*args)[1])
               for args, _, (pos, load) in b5)
    gaps = []
    for gl, wl in zip(got, want):
        block = gl.to_local().float()
        v = block.shape[-1]
        cols = slice(mesh.get_local_rank("model") * v,
                     (mesh.get_local_rank("model") + 1) * v)
        gaps.append(float((block - wl[..., cols].float()).abs().max()))
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    out["deepseek_ep"] = {"gap": max(gaps),
                          "scale": max(float(w.abs().max()) for w in want),
                          "b5_launches": launches, "b5_calls": len(b5),
                          "b5_held": held, "widths": sorted(widths),
                          "b5_want": n_moe * (1 + SHARD_MLA_STEPS)}
    del params, cache, got, want, b5
    _peak_reset()

    # internlm2-1.8b: one training step's loss and gradients, and the
    # step again in SHARD_MICROBATCH microbatches
    cfg, full = _draw("internlm2-1.8b", seed, layers=2, f32=True)
    out["train"] = _train_cut(cfg, full, mesh, SHARD_TRAIN, g,
                              microbatch=SHARD_MICROBATCH)
    return out


def _train_cut(cfg, full, mesh, shape, g, microbatch=1):
    """`value_and_grad` of one step of the cut ``full`` on one device and
    on ``mesh`` (FSDP x TP), at ``shape`` (batch, seq) of random tokens
    from ``g``: losses, the widest gradient gap (this rank's blocks) of
    its leaf's largest, peak memory of each, seconds of the mesh step,
    this rank's parameter bytes and the tree's, and the widths the mixers
    ran on in the mesh step; the mesh step's staged collectives and its
    peak as the dry run counts it (this rank's blocks of the parameters
    and batch, plus the most the step allocated above what was resident
    before it).  With ``microbatch`` > 1, the mesh step again in that
    many microbatches (`train.step.microbatch_value_and_grad`): its loss
    and widest gradient gap to the one-device step."""
    from repro_torch.ckpt.manager import tree_leaves
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import step as ts
    ctx = shd.make_shard_ctx(mesh, cfg)
    b, t = shape
    tt = torch.randint(0, cfg.vocab, (b, t + 1), generator=g, device=_dev(),
                       dtype=torch.int32)
    batch = {"tokens": tt[:, :-1], "labels": tt[:, 1:]}
    base = _peak_reset()
    loss_ref, _, grads_ref = ts.value_and_grad(full, batch, cfg)
    peak_single = _peak() - base
    specs = shd.params_pspecs(full, cfg, ctx)
    params = shd.shard_tree(full, specs, mesh)
    sbatch = shd.shard_tree(batch, shd.batch_pspecs(batch, cfg, ctx), mesh)
    full_bytes = sum(x.numel() * x.element_size() for x in _leaves(full))
    base = _peak_reset()
    before = _staged_now()
    with Widths() as widths:
        t0 = time.perf_counter()
        loss, _, grads = ts.value_and_grad(params, sbatch, cfg, ctx)
        _sync()
        step_s = time.perf_counter() - t0
    staged = _staged_since(before)
    peak_mesh = _peak() - base
    operands = _local_bytes(params)[0] + _local_bytes(sbatch)[0]
    # the specs in the gradients' order (tree_leaves: keys sorted)
    order = tree_leaves(shd.map_with_path(lambda _, sp: _Spec(sp), specs))
    paths = tree_leaves(shd.map_with_path(lambda p, _: p, specs))

    def widest(got_grads):
        worst, where = 0.0, None
        for got, want, sp, path in zip(got_grads, grads_ref, order, paths):
            gap, top = _gap_local(got, want, sp.spec, mesh)
            if gap / max(top, 1e-30) > worst:
                worst, where = gap / max(top, 1e-30), path
        return worst, where

    worst, where = widest(grads)
    out = {"loss": float(loss.full_tensor()), "loss_ref": float(loss_ref),
           "grad_rel_gap": worst, "grad_worst": where,
           "peak_mesh": peak_mesh, "peak_step": operands + peak_mesh,
           "staged": staged,
           "peak_single": peak_single, "step_s": step_s,
           "param_bytes": _local_bytes(params), "full_bytes": full_bytes,
           "widths": sorted(widths)}
    if microbatch > 1:
        del grads
        t0 = time.perf_counter()
        loss, _, grads = ts.microbatch_value_and_grad(
            params, sbatch, cfg, ctx, microbatch=microbatch)
        _sync()
        out["mb"] = (microbatch, float(loss.full_tensor()), *widest(grads),
                     time.perf_counter() - t0)
    return out


def _jamba_serve(cfg, params, tokens, ctx, cache):
    """Prefill ``tokens`` then SHARD_JAMBA's decode steps (each feeding
    the prompts' first tokens): the logits of every step, full."""
    from repro_torch.parallel import regions as R
    from repro_torch.serve.lm_engine import make_decode_step, make_prefill_step
    logits, _ = make_prefill_step(cfg, ctx)(params, {"tokens": tokens},
                                            cache)
    steps = [R.full(logits).float().cpu()]
    decode = make_decode_step(cfg, ctx)
    for i in range(SHARD_JAMBA[3]):
        logits, _ = decode(params, cache, tokens[:, :1],
                           tokens.shape[1] + i)
        steps.append(R.full(logits).float().cpu())
    return steps


def _rank_mixers(rank, world, seed, rwkv_prompts, jamba_tokens):
    """The recurrent mixers on their tensor-parallel layout.

    rwkv6-3b at full width and depth (``serve_tp_only``, float32) on the
    2 x 2 mesh, drawn one rank at a time (`_in_turn`), served at each
    ``rwkv_pad_heads`` of SHARD_RWKV (`_generate_on_mesh`); its 2-layer
    cut served with the time mix's FSDP split kept (SHARD_RWKV_FSDP), and
    its 2-layer cut's training step at SHARD_RWKV_TRAIN (`_train_cut`);
    jamba's first two layers at full width on a 1 x 2 mesh of ranks 0
    and 1 (rank 1 draws first), prefill + decode (`_jamba_serve`), its
    routes and B5 counted, every launch held to its plain version."""
    from repro_torch.kernels.moe_dispatch import kernel as moe_kernel
    from repro_torch.kernels.moe_dispatch import ref as moe_ref
    from repro_torch.launch import mesh as M
    from repro_torch.models import blocks, lm
    from repro_torch.parallel import sharding as shd
    _rank_setup()
    mesh, _ = _rank_mesh()
    out = {"rwkv": {}}

    def place_rwkv():
        cfg, full = _draw("rwkv6-3b", seed, f32=True, serve_tp_only=True)
        ctx = shd.make_shard_ctx(mesh, cfg)
        return cfg, shd.shard_tree(full, shd.params_pspecs(full, cfg, ctx),
                                   mesh)
    cfg, params = _in_turn(place_rwkv, range(world))
    out["param_bytes"] = _local_bytes(params)
    batch, prompt, new, pads = SHARD_RWKV
    for pad in pads:
        out["rwkv"][pad] = _generate_on_mesh(
            dataclasses.replace(cfg, rwkv_pad_heads=pad), params, mesh,
            rwkv_prompts, new)
    del params
    _peak_reset()

    layers, new = SHARD_RWKV_FSDP
    cfg, full = _draw("rwkv6-3b", seed + 3, layers=layers, f32=True)
    ctx = shd.make_shard_ctx(mesh, cfg)
    params = shd.shard_tree(full, shd.params_pspecs(full, cfg, ctx), mesh)
    del full
    out["rwkv_fsdp"] = _generate_on_mesh(cfg, params, mesh, rwkv_prompts,
                                         new)
    out["rwkv_fsdp"]["param_bytes"] = _local_bytes(params)
    del params
    _peak_reset()

    b, t, pad = SHARD_RWKV_TRAIN
    cfg, full = _draw("rwkv6-3b", seed + 1, layers=2, f32=True,
                      rwkv_pad_heads=pad)
    out["rwkv_train"] = _train_cut(
        cfg, full, mesh, (b, t), torch.Generator(_dev()).manual_seed(seed))
    del full
    _peak_reset()

    layers = SHARD_JAMBA[0]
    jmesh = M.make_mesh((1, 2), ("data", "model"), device=_dev().type,
                        ranks=[0, 1])

    def place_jamba():
        cfg, full = _draw("jamba-1.5-large-398b", seed + 2, f32=True,
                          n_layers=layers, scan_group=layers,
                          serve_tp_only=True)
        ctx = shd.make_shard_ctx(jmesh, cfg)
        return cfg, shd.shard_tree(full, shd.params_pspecs(full, cfg, ctx),
                                   jmesh)
    placed = _in_turn(place_jamba, (1, 0))
    if placed is None:                       # ranks 2 and 3: not on it
        return out
    cfg, params = placed
    ctx = shd.make_shard_ctx(jmesh, cfg)
    tokens = jamba_tokens.to(_dev())
    cache = lm.init_cache(cfg, tokens.shape[0],
                          tokens.shape[1] + SHARD_JAMBA[3], device=_dev())
    cache = shd.shard_tree(cache, shd.cache_pspecs(cache, cfg, ctx), jmesh)
    base = _peak_reset()
    before = _staged_now()
    moe_kernel.launches = 0
    with torch.no_grad(), Widths() as widths, \
            Capture(moe_kernel, "dispatch_positions_cuda") as b5, \
            Capture(blocks, "route_tokens") as routes:
        t0 = time.perf_counter()
        steps = _jamba_serve(cfg, params, tokens, ctx, cache)
        secs = time.perf_counter() - t0
    held = all(torch.equal(pos, moe_ref.dispatch_positions_ref(*args)[0])
               and torch.equal(load,
                               moe_ref.dispatch_positions_ref(*args)[1])
               for args, _, (pos, load) in b5)
    n_moe = sum(map(cfg.layer_is_moe, range(cfg.n_layers)))
    out["jamba"] = {
        "logits": steps if rank == 0 else None,
        "routes": [tuple(getattr(r, f).cpu() for f in
                         ("expert_ids", "event_slot", "kept"))
                   for _, _, r in routes],
        "b5_launches": moe_kernel.launches, "b5_calls": len(b5),
        "b5_held": held, "b5_want": n_moe * (1 + SHARD_JAMBA[3]),
        "s": secs, "peak": _peak() - base, "staged": _staged_since(before),
        "widths": sorted(widths), "param_bytes": _local_bytes(params)}
    return out


class _Spec:
    """A spec as one leaf of `tree_leaves` (which opens tuples)."""

    def __init__(self, spec):
        self.spec = spec


def _rank_nccl(rank, world, opts, seed):
    """NCCL on one rank: the 2-layer float32 internlm2 cut's forward on a
    1 x 1 mesh against the one-device forward."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M, staging
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as shd
    SHARD_OPTS.update(opts)
    _rank_setup()
    mesh = M.make_host_mesh(1, 1, device=_dev().type)
    cfg, full = _draw("internlm2-1.8b", seed, layers=2, f32=True)
    ctx = shd.make_shard_ctx(mesh, cfg)
    toks = torch.randint(0, cfg.vocab, (2, 64), device=_dev(),
                         generator=torch.Generator(_dev()).manual_seed(seed),
                         dtype=torch.int32)
    with torch.no_grad():
        want = lm.forward(full, {"tokens": toks}, cfg, remat=False)["logits"]
        params = shd.shard_tree(full, shd.params_pspecs(full, cfg, ctx), mesh)
        got = lm.forward(params, {"tokens": toks}, cfg, ctx=ctx,
                         remat=False)["logits"].full_tensor()
    _sync()
    return {"backend": dist.get_backend(), "staged": staging.installed(),
            "gap": float((got - want).abs().max())}


def sharded(dev, tag, flat_xla, chip_xla, streams):
    """The mesh on the one card, as SHARD_RANKS gloo ranks (NCCL refuses
    two ranks on one device): the collective probe; ``run(shard="chips")``
    at chips=SHARD_RANKS over the phase-4 fabric and both streams, each
    rank its own chip, bitwise the chips=1 xla session (``flat_xla``),
    host ms a tick beside the one-process sharded twin (``chip_xla``);
    internlm2-1.8b served at full width and depth on the 2 x 2 mesh,
    greedy tokens equal to the one-device generate; the float32 2-layer
    cuts (llama3.2-3b sequence-parallel, deepseek-v2-lite's MLA and expert
    parallelism with B5 once a rank a MoE layer a forward, internlm2's
    training step, and the step again in microbatches); NCCL on one
    rank; the dry run's summary and its per-device pass of the served
    prefill and of internlm2's cut's training step (each held to rank
    0's staged collectives, the step's peak to the rank's), of
    internlm2-1.8b train_4k (its calls by op held to the CPU tests'
    torch's) and of the smoke prefill the CPU tests hold against JAX.
    Returns B5's launches a rank on the mesh path."""
    from repro_torch import configs
    from repro_torch.interface.types import InterfaceParams
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshSpec, make_production_mesh
    from repro_torch.launch.spawn import spawn
    from repro_torch.models import lm
    from repro_torch.serve.lm_engine import ServeEngine, make_prefill_step

    t_phase = time.perf_counter()
    # build B5 here: four ranks would race four nvcc runs
    build.ensure_built("moe_dispatch")
    mib = 2 ** 20

    # the one-device references the ranks do not compute themselves
    arch, batch, prompt, new = SHARD_SERVE
    cfg = dataclasses.replace(configs.get_config(arch),
                              compute_dtype="float32")
    params = lm.init_model(torch.Generator(dev).manual_seed(SEED + 9), cfg)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt), device=dev,
                            generator=torch.Generator(dev).manual_seed(SEED),
                            dtype=torch.int32)
    engine = ServeEngine(cfg, params, max_len=prompt + new)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    want_tokens = engine.generate(prompts, new).cpu()
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    single_peak = torch.cuda.max_memory_allocated() - base
    cache = lm.init_cache(cfg, batch, prompt + new)
    with torch.no_grad():
        logits, _ = make_prefill_step(cfg)(params, {"tokens": prompts}, cache)
    want_prefill = logits.float().cpu()
    del params, engine, cache, logits
    torch.cuda.empty_cache()
    mixer_refs = _mixer_references(dev)

    fabric = {k: v.cpu() for k, v in streams.items()}
    fparams = InterfaceParams(*(t.cpu() for t in flat_xla.params))
    chips_cfg = dataclasses.replace(flat_xla.config, chips=SHARD_RANKS)
    twin_ms = {}
    for name, spikes in streams.items():
        chip_xla.run(spikes, shard="chips")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chip_xla.run(spikes, shard="chips")
        torch.cuda.synchronize()
        twin_ms[name] = (time.perf_counter() - t0) * 1e3 / spikes.shape[0]
        check(chip_xla.last_shard_body == "single",
              "the one-process twin did not run the single-device body")

    t0 = time.perf_counter()
    on_card = SHARD_OPTS["device"] == "cuda"
    results = spawn(_rank_all, SHARD_RANKS, device_id=0 if on_card else None,
                    timeout=900, args=(SHARD_OPTS, chips_cfg, tuple(fparams),
                                       fabric, SEED, prompts.cpu(),
                                       mixer_refs["rwkv_prompts"],
                                       mixer_refs["jamba_tokens"]))
    spawn_s = time.perf_counter() - t0

    # ---- the probe
    probe = results[0]["probe"]
    for r, res in enumerate(results):
        p = res["probe"]
        for op in ("all_reduce", "all_gather_into_tensor",
                   "reduce_scatter_tensor", "all_gather", "all_to_all_single"):
            check(p[op] == "ok", f"rank {r}: gloo {op} on CUDA: {p[op]}")
        for op in ("staged_gather", "staged_all_reduce",
                   "staged_reduce_scatter"):
            check(p[op] is True, f"rank {r}: {op} wrong")
    print(f"{tag} sharded probe: gloo on CUDA tensors across {SHARD_RANKS} "
          f"ranks on cuda:0, direct c10d ops: " + ", ".join(
              f"{k} {v}" for k, v in probe.items()
              if not k.startswith("staged")) +
          f"; the functional ops DTensor calls go through host staging "
          f"(launch/staging.py; all_gather_into_tensor through gloo's "
          f"coalesced entry ended the ranks on torch 2.11): staged calls "
          f"{probe['staged']} for one gather, one all-reduce and one "
          f"reduce-scatter, each exact")

    # ---- shard="chips" across ranks
    for name, spikes in streams.items():
        want_cur, want_st = flat_xla.run(spikes)
        one_cur, one_st = chip_xla.run(spikes, shard="chips")
        for r, res in enumerate(results):
            cur, st, body, ms, staged = res["chips"][name]
            check(body == "mesh", f"rank {r}: shard=chips ran {body}")
            check(torch.equal(cur, want_cur.cpu()),
                  f"rank {r} {name}: mesh currents differ from chips=1 xla")
            for f, v in st.items():
                check(torch.equal(v, getattr(one_st, f).cpu()),
                      f"rank {r} {name}: {f} differs from the sharded twin")
            for f in MC_INVARIANT_FIELDS:
                check_field(f"rank {r} {name} vs chips=1", f, st[f],
                            getattr(want_st, f))
        ms = [res["chips"][name][3] for res in results]
        print(f"{tag} sharded shard=chips {name}: {SHARD_RANKS} ranks x 1 "
              f"chip, currents bitwise the chips=1 xla session, stats bitwise"
              f" the one-process sharded body; host ms/tick by rank "
              f"{', '.join(f'{m:.4f}' for m in ms)} (one gather of the run, "
              f"{results[0]['chips'][name][4]} staged collective(s)) beside "
              f"the one-process sharded twin {twin_ms[name]:.4f}; 4 ranks "
              f"share one H100")

    # ---- internlm2-1.8b served on the 2 x 2 mesh
    same = [int((res["serve"]["tokens"] == want_tokens).sum())
            for res in results]
    gap = float((results[0]["serve"]["prefill"] - want_prefill).abs().max())
    loc, full = results[0]["serve"]["param_bytes"]
    print(f"{tag} sharded serve {arch} (full width and depth, "
          f"serve_tp_only: weights split over model only) on a 2 x 2 mesh, "
          f"{batch} x {prompt} prompt tokens + {new} new, greedy, against "
          f"the one-device generate on the card (ServeEngine, ctx=): "
          f"prefill logit gap "
          f"{gap:.4e} (float32 compute: in bfloat16 the split products "
          f"round otherwise and flip near-tied tokens); generate {max(res['serve']['s'] for res in results):.2f} s "
          f"on the mesh against {single_s:.2f} s on one device; peak "
          f"memory by rank "
          f"{', '.join(str(res['serve']['peak'] // mib) for res in results)}"
          f" MiB against {single_peak // mib} MiB (one device, cache and "
          f"activations); parameter bytes a rank {loc // mib} of "
          f"{full // mib} MiB; tokens equal by rank {same} of "
          f"{want_tokens.numel()}; staged a generate, rank 0, by op (calls, "
          f"bytes): {results[0]['serve']['staged']}")
    for r, res in enumerate(results):
        check(torch.equal(res["serve"]["tokens"], want_tokens),
              f"rank {r}: mesh greedy tokens differ from one device")
    _dry_prefill_vs_staged(tag, results, prompt, batch, new)

    # ---- the float32 cuts
    c0 = results[0]["cuts"]
    tr = c0["train"]
    print(f"{tag} sharded cuts (2 layers, full width, float32, 2 x 2 mesh "
          f"against one device on the card, each rank its own block): "
          f"llama3.2-3b sequence-parallel logits gap "
          f"{max(res['cuts']['llama_sp'][0] for res in results):.3e}; "
          f"deepseek-v2-lite MLA (prefill on {c0['deepseek_ep']['widths']} "
          f"a rank) + expert parallel, prefill + "
          f"{SHARD_MLA_STEPS} decode steps, logits gap "
          f"{max(res['cuts']['deepseek_ep']['gap'] for res in results):.3e}"
          f", B5 {c0['deepseek_ep']['b5_launches']} launches a rank (one a "
          f"rank a MoE layer a forward), each == its plain version; "
          f"internlm2-1.8b train step (batch {SHARD_TRAIN[0]}, seq "
          f"{SHARD_TRAIN[1]}, FSDP x TP) loss {tr['loss']:.6f} vs "
          f"{tr['loss_ref']:.6f}, largest gradient gap "
          f"{max(res['cuts']['train']['grad_rel_gap'] for res in results):.3e}"
          f" of its leaf's largest, {tr['step_s']:.2f} s; peak memory by rank "
          f"{', '.join(str(res['cuts']['train']['peak_mesh'] // mib) for res in results)}"
          f" MiB against {tr['peak_single'] // mib} MiB on one device; "
          f"parameter bytes a rank {tr['param_bytes'][0] // mib} of "
          f"{tr['param_bytes'][1] // mib} MiB "
          f"({tr['param_bytes'][0] / tr['param_bytes'][1]:.3f}); the step "
          f"in {tr['mb'][0]} microbatches loss {tr['mb'][1]:.6f}, largest "
          f"gradient gap "
          f"{max(res['cuts']['train']['mb'][2] for res in results):.3e} of "
          f"its leaf's largest to the one-device step ({tr['mb'][3]}), "
          f"{tr['mb'][4]:.2f} s")

    for r, res in enumerate(results):
        g, top = res["cuts"]["llama_sp"]
        check(g <= LOGIT_ATOL + LOGIT_RTOL * top,
              f"rank {r}: llama3.2-3b SP logits gap {g}")
        ep = res["cuts"]["deepseek_ep"]
        check(ep["gap"] <= LOGIT_ATOL + LOGIT_RTOL * ep["scale"],
              f"rank {r}: deepseek EP logits gap {ep['gap']}")
        check(ep["b5_launches"] == ep["b5_want"] == ep["b5_calls"],
              f"rank {r}: B5 launches {ep['b5_launches']}, calls "
              f"{ep['b5_calls']}, want {ep['b5_want']}")
        check(ep["b5_held"], f"rank {r}: a B5 launch differs from plain")
        heads = _config("deepseek-v2-lite-16b").n_heads // SHARD_MESH[1]
        check(ep["widths"] == [("attention heads", heads)],
              f"rank {r}: MLA prefill ran on {ep['widths']}")
        tr = res["cuts"]["train"]
        check(abs(tr["loss"] - tr["loss_ref"]) <= 1e-4 * abs(tr["loss_ref"]),
              f"rank {r}: train loss {tr['loss']} vs {tr['loss_ref']}")
        check(tr["grad_rel_gap"] <= GRAD_RTOL,
              f"rank {r}: gradient gap {tr['grad_rel_gap']}")
        _, mb_loss, mb_gap, _, _ = tr["mb"]
        check(abs(mb_loss - tr["loss_ref"]) <= 1e-4 * abs(tr["loss_ref"]),
              f"rank {r}: microbatched train loss {mb_loss} vs "
              f"{tr['loss_ref']}")
        check(mb_gap <= GRAD_RTOL,
              f"rank {r}: microbatched gradient gap {mb_gap}")
    _dry_train_vs_staged(tag, results)

    _mixers_report(tag, results, mixer_refs)

    # ---- NCCL, one rank
    nccl = spawn(_rank_nccl, 1, backend="nccl" if on_card else "gloo",
                 device_id=0 if on_card else None, timeout=300,
                 args=(SHARD_OPTS, SEED))[0]
    check(nccl["backend"] == ("nccl" if on_card else "gloo")
          and not nccl["staged"], f"the NCCL rank ran {nccl}")
    check(nccl["gap"] <= 1e-4, f"NCCL 1 x 1 mesh logits gap {nccl['gap']}")
    print(f"{tag} sharded nccl: one rank, backend nccl, 1 x 1 mesh, "
          f"internlm2-1.8b 2-layer float32 forward gap {nccl['gap']:.3e} "
          f"against one device; no host staging")

    # ---- the dry run: bytes of every cell; the per-device pass of one
    t0 = time.perf_counter()
    recs = [dryrun.run_cell(a, sh, mp, os.path.join("build", "dryrun_torch"),
                            count=False, verbose=False)
            for a in configs.ARCHS for sh in configs.SHAPES
            for mp in (False, True)]
    summary = dryrun.summarize(recs)
    check(summary["error"] == 0, f"dry run errors: {summary}")
    print(f"{tag} sharded dry run (per-device bytes by the port's specs, no "
          f"FLOP count, {time.perf_counter() - t0:.1f} s): {summary}")
    t0 = time.perf_counter()
    arch = "internlm2-1.8b"
    mesh = make_production_mesh()
    rec = dryrun.calibrated_costs(
        configs.get_config(arch), configs.SHAPES["train_4k"], mesh,
        opt_overrides=configs.train_overrides(arch))
    print(f"{tag} sharded dry run per-device ({arch} train_4k, rank 0 of a "
          f"fake {mesh.sizes} process group, meta shards, 2 and 3 layers "
          f"extrapolated to {configs.get_config(arch).n_layers}, "
          f"{time.perf_counter() - t0:.1f} s): {rec}")
    check(rec["collective_counts"] == TRAIN_4K_CALLS,
          f"train_4k calls {rec['collective_counts']}, torch 2.13's "
          f"{TRAIN_4K_CALLS}")
    # the cell tests/test_torch_dryrun_costs.py holds against the JAX dry
    # run, whose GSPMD program makes 5 all-reduces of one (4, 16, 64)
    # float32 operand there: the port on this card's torch makes the same
    smoke = dataclasses.replace(configs.get_smoke_config("internlm2-1.8b"),
                                serve_tp_only=True)
    low = dryrun.calibrated_costs(smoke, configs.Shape("prefill_t", 16, 4,
                                                       "prefill"),
                                  MeshSpec((1, 2), ("data", "model")))
    jax_calls, jax_bytes = 5, 5 * 4 * 16 * smoke.d_model * 4
    print(f"{tag} sharded dry run, internlm2-1.8b smoke 4 x 16 prefill on "
          f"1 x 2, serve_tp_only, torch {torch.__version__}: calls "
          f"{low['collective_counts']}, bytes {low['collectives']}, flops "
          f"{low['flops']}, bytes accessed {low['bytes accessed']}; the JAX "
          f"dry run's all-reduces {jax_calls}, {jax_bytes} B")
    check(low["collective_counts"].get("all-reduce") == jax_calls
          and low["collectives"].get("all-reduce") == jax_bytes,
          f"smoke prefill all-reduces {low['collective_counts']} "
          f"{low['collectives']}, the JAX dry run's {jax_calls}, "
          f"{jax_bytes} B")
    print(f"{tag} sharded phase: {time.perf_counter() - t_phase:.1f} s "
          f"(ranks {spawn_s:.1f} s)")
    return {"deepseek": c0["deepseek_ep"]["b5_launches"],
            "jamba": results[0]["mixers"]["jamba"]["b5_launches"]}


# staged bytes are the operand down plus the result back; the dry run
# counts (collective_bytes's convention) the gathered result of an
# all-gather and the operand of the others.  On a group of g ranks:
# staged * g == dry * STAGED_OVER_DRY[op] (all-to-all: equal splits)
STAGED_OVER_DRY = {"all-reduce": lambda g: 2 * g,
                   "all-gather": lambda g: g + 1,
                   "reduce-scatter": lambda g: g + 1,
                   "all-to-all": lambda g: 2 * g,
                   "collective-permute": lambda g: 2 * g}
# the dry run's peak of the cut's train step against rank 0's measured one
DRY_PEAK_RTOL = 0.10
# the collective calls by op of internlm2-1.8b train_4k's per-device pass
# on 16 x 16 as torch 2.13 counts them (`python -m
# repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k` on a
# CPU): the card machine's torch must count the same
# rank 0's staged all-gather bytes (operand down + result back) in a
# generate of SHARD_RWKV at rwkv_pad_heads 48 when the WKV's output heads
# were gathered over ``model`` before the norm, the gate and ``wo`` (an
# H100 run: 306 gathers, 288 of them the heads')
PAD48_GATHERED_BEFORE = 181_665_792
TRAIN_4K_CALLS = {"all-gather": 434, "all-reduce": 131,
                  "reduce-scatter": 218, "total": 783}
STAGED_NAMES = {"all-reduce": "all_reduce",
                "all-gather": "all_gather_into_tensor",
                "reduce-scatter": "reduce_scatter_tensor",
                "all-to-all": "all_to_all_single",
                "collective-permute": "collective_permute"}


def _check_staged(dry, staged):
    """The dry run's collectives by op (calls, and bytes by
    `STAGED_OVER_DRY`) against a rank's staged ones in the same step."""
    g = SHARD_MESH[1]
    check(SHARD_MESH[0] == g, "the staged relation takes one group size")
    calls = {STAGED_NAMES[op]: n for op, n in dry["collective_counts"].items()
             if op != "total"}
    check(calls == {op: n for op, (n, _) in staged.items()},
          f"dry run calls {calls} against staged {staged}")
    for op, moved in dry["collectives"].items():
        if op == "total":
            continue
        got = staged.get(STAGED_NAMES[op], (0, 0))[1]
        check(got * g == moved * STAGED_OVER_DRY[op](g),
              f"{op}: staged {got} B against the dry run's {moved} B")


def _dry_train_vs_staged(tag, results):
    """The dry run's per-device pass of the mesh step of internlm2-1.8b's
    2-layer float32 cut (`_rank_cuts`: `train.step.value_and_grad` at
    SHARD_TRAIN on the 2 x 2 mesh, rank 0 of a fake process group, meta
    shards): its calls by op == rank 0's staged calls in that step, bytes
    by `STAGED_OVER_DRY`, its peak within `DRY_PEAK_RTOL` of rank 0's
    (`_train_cut`'s ``peak_step``)."""
    from repro_torch.ckpt.manager import tree_leaves
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshSpec, fake_mesh
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import step as ts
    cfg = _config("internlm2-1.8b")
    if not SHARD_OPTS["smoke"]:
        cfg = dataclasses.replace(cfg, n_layers=2)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    b, t = SHARD_TRAIN
    t0 = time.perf_counter()
    with fake_mesh(MeshSpec(SHARD_MESH, ("data", "model"))) as mesh:
        ctx = shd.make_shard_ctx(mesh, cfg)
        params = lm.init_model(None, cfg, device="meta")
        params = shd.shard_tree(params, shd.params_pspecs(params, cfg, ctx),
                                mesh)
        batch = {k: torch.empty((b, t), dtype=torch.int32, device="meta")
                 for k in ("tokens", "labels")}
        batch = shd.shard_tree(batch, shd.batch_pspecs(batch, cfg, ctx), mesh)
        dry = dryrun.measure(
            lambda: ts.value_and_grad(params, batch, cfg, ctx),
            tree_leaves(params) + tree_leaves(batch))
    dry_s = time.perf_counter() - t0
    tr = results[0]["cuts"]["train"]
    mem = dry["memory"]
    print(f"{tag} sharded dry run of the cut's train step (internlm2-1.8b, "
          f"2 layers at full width, float32, {b} x {t}, "
          f"{SHARD_MESH[0]} x {SHARD_MESH[1]}; fake rank 0, {dry_s:.1f} s): "
          f"calls {dry['collective_counts']} against rank 0's staged "
          f"{tr['staged']}; bytes {dry['collectives']}; flops "
          f"{dry['cost']['flops']}, bytes accessed "
          f"{dry['cost']['bytes accessed']}; peak {mem['peak_bytes']} B "
          f"(placed {mem['placed_bytes']}, temp {mem['temp_bytes']}) against "
          f"rank 0's {tr['peak_step']} B (its blocks of the operands plus "
          f"max_memory_allocated over the step above what was resident "
          f"before it: gap {tr['peak_step'] - mem['peak_bytes']} B)")
    _check_staged(dry, tr["staged"])
    if _dev().type == "cuda":
        check(abs(mem["peak_bytes"] - tr["peak_step"])
              <= DRY_PEAK_RTOL * tr["peak_step"],
              f"dry run peak {mem['peak_bytes']} B against rank 0's "
              f"{tr['peak_step']} B")


def _dry_prefill_vs_staged(tag, results, prompt, batch, new):
    """The dry run's per-device pass of the served prefill (internlm2-1.8b
    at full width, float32, ``serve_tp_only``, the 2 x 2 mesh, its cache
    of prompt + new), against the collectives rank 0 staged in that
    prefill: the same calls by op, bytes by `STAGED_OVER_DRY`; the dry
    run's peak printed beside the rank's."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshSpec
    arch = SHARD_SERVE[0]
    cfg = dataclasses.replace(_config(arch), compute_dtype="float32",
                              serve_tp_only=True)
    t0 = time.perf_counter()
    dry = dryrun.per_device_costs(
        cfg, configs.Shape("serve_prefill", prompt, batch, "prefill"),
        MeshSpec(SHARD_MESH, ("data", "model")), cache_len=prompt + new)
    dry_s = time.perf_counter() - t0
    staged = results[0]["serve"]["prefill_staged"]
    _check_staged(dry, staged)
    peak = results[0]["serve"]["prefill_peak"]
    mem = dry["memory"]
    print(f"{tag} sharded dry run of the served prefill ({arch} full width, "
          f"{batch} x {prompt}, cache {prompt + new}, float32, "
          f"serve_tp_only, {SHARD_MESH[0]} x {SHARD_MESH[1]}; fake rank 0, "
          f"{dry_s:.1f} s): calls {dry['collective_counts']} == rank 0's "
          f"staged calls in that prefill; bytes {dry['collectives']} "
          f"(staged, operand down + result back: {staged}); flops "
          f"{dry['cost']['flops']}, bytes accessed "
          f"{dry['cost']['bytes accessed']}; peak {mem['peak_bytes']} B "
          f"(placed {mem['placed_bytes']}, temp {mem['temp_bytes']}) against "
          f"rank 0's measured {peak} B (max_memory_allocated over the "
          f"prefill: gap {peak - mem['peak_bytes']} B)")


def _dry_decode_vs_staged(tag, results):
    """The dry run's per-device pass of one decode step of the served
    rwkv6-3b (full width and depth, float32, ``serve_tp_only``) at each
    ``rwkv_pad_heads`` of SHARD_RWKV, and of its FSDP-placed cut
    (SHARD_RWKV_FSDP), on the 2 x 2 mesh with a cache of prompt + new,
    against the collectives rank 0 staged in one decode step
    (`_generate_on_mesh`): the same calls by op, bytes by
    `STAGED_OVER_DRY`."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshSpec
    batch, prompt, new, pads = SHARD_RWKV
    layers, new_fsdp = SHARD_RWKV_FSDP
    rwkv = dataclasses.replace(_config("rwkv6-3b"), compute_dtype="float32")
    cut = rwkv if SHARD_OPTS["smoke"] else dataclasses.replace(
        rwkv, n_layers=layers)
    cells = [(f"serve_tp_only, rwkv_pad_heads {pad}",
              dataclasses.replace(rwkv, serve_tp_only=True,
                                  rwkv_pad_heads=pad),
              prompt + new, results[0]["mixers"]["rwkv"][pad])
             for pad in pads]
    cells.append((f"{layers}-layer cut, FSDP x TP", cut, prompt + new_fsdp,
                  results[0]["mixers"]["rwkv_fsdp"]))
    for name, cfg, cache, run in cells:
        t0 = time.perf_counter()
        dry = dryrun.per_device_costs(
            cfg, configs.Shape("serve_decode", cache, batch, "decode"),
            MeshSpec(SHARD_MESH, ("data", "model")), cache_len=cache)
        dry_s = time.perf_counter() - t0
        staged = run["decode_staged"]
        print(f"{tag} sharded dry run of the served rwkv6-3b decode step "
              f"({name}, float32, {batch} sequences, cache {cache}, "
              f"{SHARD_MESH[0]} x {SHARD_MESH[1]}; fake rank 0, "
              f"{dry_s:.1f} s): calls {dry['collective_counts']} against "
              f"rank 0's staged calls in that step; bytes "
              f"{dry['collectives']} (staged, operand down + result back: "
              f"{staged}); flops {dry['cost']['flops']}")
        _check_staged(dry, staged)


def _mixer_references(dev):
    """The one-device runs the mixer jobs of the sharded phase are held
    to, on the card, each model freed after: rwkv6-3b at full width and
    depth (float32) served SHARD_RWKV's prompts (greedy tokens, seconds,
    prefill logits), its 2-layer cut the same and the logits of one
    decode step after the prefill (SHARD_RWKV_FSDP), and
    jamba's first two layers (bfloat16 parameters,
    float32 compute) through `_jamba_serve` with their routes.  The
    ranks draw the same parameters from the same seeds."""
    from repro_torch.models import blocks, lm
    from repro_torch.models.blocks import LOCAL
    from repro_torch.serve.lm_engine import (ServeEngine, make_decode_step,
                                             make_prefill_step)
    out = {}
    batch, prompt, new, _ = SHARD_RWKV
    cfg, params = _draw("rwkv6-3b", SEED + 11, f32=True)
    gen = torch.Generator(dev).manual_seed(SEED + 5)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt), device=dev,
                            generator=gen, dtype=torch.int32)
    engine = ServeEngine(cfg, params, max_len=prompt + new)
    _sync()
    t0 = time.perf_counter()
    out["rwkv_tokens"] = engine.generate(prompts, new).cpu()
    _sync()
    out["rwkv_s"] = time.perf_counter() - t0
    cache = lm.init_cache(cfg, batch, prompt + new, device=dev)
    with torch.no_grad():
        logits, _ = make_prefill_step(cfg)(params, {"tokens": prompts},
                                           cache)
    out["rwkv_prefill"] = logits.float().cpu()
    out["rwkv_prompts"] = prompts.cpu()
    out["rwkv_bytes"] = sum(x.numel() * x.element_size()
                            for x in _leaves(params))
    del params, engine, cache, logits
    _peak_reset()

    layers, new = SHARD_RWKV_FSDP
    cfg, params = _draw("rwkv6-3b", SEED + 14, layers=layers, f32=True)
    engine = ServeEngine(cfg, params, max_len=prompt + new)
    _sync()
    t0 = time.perf_counter()
    out["fsdp_tokens"] = engine.generate(prompts, new).cpu()
    _sync()
    out["fsdp_s"] = time.perf_counter() - t0
    cache = lm.init_cache(cfg, batch, prompt + new, device=dev)
    with torch.no_grad():
        logits, _ = make_prefill_step(cfg)(params, {"tokens": prompts},
                                           cache)
        # the mesh's decode step after its prefill (`_generate_on_mesh`)
        step, _ = make_decode_step(cfg)(params, cache, prompts[:, -1:],
                                        prompt)
    out["fsdp_prefill"] = logits.float().cpu()
    out["fsdp_decode"] = step.float().cpu()
    del params, engine, cache, logits, step
    _peak_reset()

    layers, batch, prompt, steps = SHARD_JAMBA
    cfg, params = _draw("jamba-1.5-large-398b", SEED + 13, f32=True,
                        n_layers=layers, scan_group=layers)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), device=dev,
                           generator=gen, dtype=torch.int32)
    cache = lm.init_cache(cfg, batch, prompt + steps, device=dev)
    with torch.no_grad(), Capture(blocks, "route_tokens") as routes:
        _sync()
        t0 = time.perf_counter()
        out["jamba_logits"] = _jamba_serve(cfg, params, tokens, LOCAL, cache)
        out["jamba_s"] = time.perf_counter() - t0
    out["jamba_routes"] = [tuple(getattr(r, f).cpu() for f in
                                 ("expert_ids", "event_slot", "kept"))
                           for _, _, r in routes]
    out["jamba_tokens"] = tokens.cpu()
    out["jamba_bytes"] = sum(x.numel() * x.element_size()
                             for x in _leaves(params))
    del params, cache, routes
    _peak_reset()
    return out


def _mixers_report(tag, results, refs):
    """Print and check the mixer jobs of the sharded phase against their
    one-device references (`_mixer_references`)."""
    from repro_torch.models import mamba
    mib = 2 ** 20
    model = SHARD_MESH[1]
    rwkv = _config("rwkv6-3b")
    heads = rwkv.d_model // rwkv.rwkv.head_dim

    def rwkv_heads(pad):
        """The WKV's heads a rank: H' / model when padded, H otherwise."""
        return pad // model if pad > heads and pad % model == 0 else heads

    batch, prompt, new, pads = SHARD_RWKV
    scale = float(refs["rwkv_prefill"].abs().max())
    for pad in pads:
        runs = [res["mixers"]["rwkv"][pad] for res in results]
        gap = float((runs[0]["prefill"] - refs["rwkv_prefill"]).abs().max())
        same = [int((r["tokens"] == refs["rwkv_tokens"]).sum()) for r in runs]
        print(f"{tag} sharded rwkv6-3b (full width and depth, float32, "
              f"serve_tp_only) at rwkv_pad_heads {pad} on 2 x 2, {batch} x "
              f"{prompt} + {new} greedy: widths a rank {runs[0]['widths']}; "
              f"prefill logit gap {gap:.4e} to one device (largest logit "
              f"{scale:.3f}); tokens equal by "
              f"rank {same} of {refs['rwkv_tokens'].numel()}; generate "
              f"{max(r['s'] for r in runs):.2f} s on the mesh against "
              f"{refs['rwkv_s']:.2f} s on one device; peak by rank "
              f"{', '.join(str(r['peak'] // mib) for r in runs)} MiB above "
              f"the parameters ({results[0]['mixers']['param_bytes'][0] // mib}"
              f" of {refs['rwkv_bytes'] // mib} MiB a rank); staged a "
              f"generate, rank 0, by op (calls, bytes): {runs[0]['staged']};"
              f" its all-gathers by result shape {runs[0]['gathered']}")
        hd = rwkv.rwkv.head_dim
        for r, run in enumerate(runs):
            check(torch.equal(run["tokens"], refs["rwkv_tokens"]),
                  f"rank {r}: rwkv6-3b pad {pad} tokens differ from one "
                  f"device")
            # the WKV state stays where the cache holds it: no staged
            # all-gather returns it, (heads, batch / data, D, D)
            state = {sh: n for sh, n in run["gathered"].items()
                     if len(sh) == 4 and sh[2:] == (hd, hd)}
            check(not state, f"rank {r}: rwkv6-3b pad {pad} gathered the "
                  f"WKV state: {state}")
            # on a head split the time mix runs on the rank's heads: no
            # staged all-gather returns the WKV's output heads, (H',
            # batch / data, tokens, D)
            heads_back = {sh: n for sh, n in run["gathered"].items()
                          if len(sh) == 4 and sh[0] == pad and sh[3] == hd}
            check(not heads_back, f"rank {r}: rwkv6-3b pad {pad} gathered "
                  f"the output heads: {heads_back}")
            check(run["widths"] == [("WKV heads", rwkv_heads(pad))],
                  f"rank {r}: rwkv6-3b pad {pad} ran on {run['widths']}")
        if pad > heads:
            print(f"{tag} sharded rwkv6-3b pad {pad}: rank 0's staged "
                  f"all-gathers a generate "
                  f"{runs[0]['staged'].get('all_gather_into_tensor')} "
                  f"(calls, bytes) against {PAD48_GATHERED_BEFORE:,} B when "
                  f"the output heads were gathered")
        check(gap <= LOGIT_ATOL + LOGIT_RTOL * scale,
              f"rwkv6-3b pad {pad} prefill logits gap {gap}")
    layers, new_fsdp = SHARD_RWKV_FSDP
    runs = [res["mixers"]["rwkv_fsdp"] for res in results]
    scale = float(refs["fsdp_prefill"].abs().max())
    gap = float((runs[0]["prefill"] - refs["fsdp_prefill"]).abs().max())
    # the decode step's products run row-parallel on the permuted blocks
    d_scale = float(refs["fsdp_decode"].abs().max())
    d_gap = float((runs[0]["decode"] - refs["fsdp_decode"]).abs().max())
    loc, full = runs[0]["param_bytes"]
    print(f"{tag} sharded rwkv6-3b {layers}-layer cut (full width, float32, "
          f"FSDP x TP: the time mix split over data, as the production "
          f"decode cells) on 2 x 2, {batch} x {prompt} + {new_fsdp} greedy: "
          f"prefill logit gap {gap:.4e} to one device (largest logit "
          f"{scale:.3f}), a decode step's {d_gap:.4e} (largest "
          f"{d_scale:.3f}); tokens equal by rank "
          f"{[int((r['tokens'] == refs['fsdp_tokens']).sum()) for r in runs]}"
          f" of {refs['fsdp_tokens'].numel()}; generate "
          f"{max(r['s'] for r in runs):.2f} s on the mesh against "
          f"{refs['fsdp_s']:.2f} s on one device; parameter bytes a rank "
          f"{loc // mib} of {full // mib} MiB; staged a generate, rank 0, by "
          f"op (calls, bytes): {runs[0]['staged']}; a decode step: "
          f"{runs[0]['decode_staged']}, its all-gathers by result shape "
          f"{runs[0]['decode_gathered']}, its lookup's plan "
          f"{runs[0]['decode_lookup']}")
    for r, run in enumerate(runs):
        check(torch.equal(run["tokens"], refs["fsdp_tokens"]),
              f"rank {r}: rwkv6-3b FSDP cut tokens differ from one device")
        # the decode lookup in place: the table's blocks stay, the rows
        # move by one all-to-all
        check(run["decode_lookup"] == ["all_to_all"]
              and run["decode_staged"].get("all_to_all_single",
                                           (0, 0))[0] == 1,
              f"rank {r}: the FSDP cut's decode lookup took "
              f"{run['decode_lookup']}, staged {run['decode_staged']}")
        check(run["decode_staged"].get("collective_permute", (0, 0))[0] > 0,
              f"rank {r}: the FSDP cut's decode step permuted no block: "
              f"{run['decode_staged']}")
    check(gap <= LOGIT_ATOL + LOGIT_RTOL * scale,
          f"rwkv6-3b FSDP cut prefill logits gap {gap}")
    check(d_gap <= LOGIT_ATOL + LOGIT_RTOL * d_scale,
          f"rwkv6-3b FSDP cut decode step logits gap {d_gap}")
    _dry_decode_vs_staged(tag, results)
    tr = [res["mixers"]["rwkv_train"] for res in results]
    print(f"{tag} sharded rwkv6-3b 2-layer cut, one step (batch "
          f"{SHARD_RWKV_TRAIN[0]}, seq {SHARD_RWKV_TRAIN[1]}, rwkv_pad_heads "
          f"{SHARD_RWKV_TRAIN[2]}, FSDP x TP) on 2 x 2 against one device: "
          f"widths a rank {tr[0]['widths']}; loss {tr[0]['loss']:.6f} vs "
          f"{tr[0]['loss_ref']:.6f}; largest gradient gap "
          f"{max(t['grad_rel_gap'] for t in tr):.3e} of its leaf's largest "
          f"({max(tr, key=lambda t: t['grad_rel_gap'])['grad_worst']}); "
          f"{tr[0]['step_s']:.2f} s; peak by rank "
          f"{', '.join(str(t['peak_mesh'] // mib) for t in tr)} MiB against "
          f"{tr[0]['peak_single'] // mib} MiB on one device")
    # RWKV's bound, as its one-device step card vs CPU: the factored WKV's
    # nearly cancelling decay factors move gradients with summation order
    # (an H100 read 1.5e-4 of the leaf's largest here)
    for r, t in enumerate(tr):
        check(t["widths"] == [("WKV heads",
                               rwkv_heads(SHARD_RWKV_TRAIN[2]))],
              f"rank {r}: rwkv6-3b step ran on {t['widths']}")
        check(abs(t["loss"] - t["loss_ref"]) <= 1e-5 * abs(t["loss_ref"]),
              f"rank {r}: rwkv6-3b step loss {t['loss']} vs {t['loss_ref']}")
        check(t["grad_rel_gap"] <= RWKV_GRAD_RTOL,
              f"rank {r}: rwkv6-3b gradient gap {t['grad_rel_gap']}")
    jr = [res["mixers"]["jamba"] for res in results[:2]]
    gaps = [float((g - w).abs().max()) for g, w in
            zip(jr[0]["logits"], refs["jamba_logits"])]
    scale = max(float(w.abs().max()) for w in refs["jamba_logits"])
    print(f"{tag} sharded jamba-1.5-large-398b first {SHARD_JAMBA[0]} layers "
          f"(full width, bfloat16 parameters, float32 compute, "
          f"serve_tp_only) on a 1 x 2 mesh, {SHARD_JAMBA[1]} x "
          f"{SHARD_JAMBA[2]} prefill + {SHARD_JAMBA[3]} decode steps: "
          f"widths a rank {jr[0]['widths']}; logit gaps by step "
          f"{', '.join(f'{g:.3e}' for g in gaps)} (largest {scale:.3f}); "
          f"routes {len(jr[0]['routes'])} calls; B5 {jr[0]['b5_launches']} "
          f"launches a rank, each == its plain version; {jr[0]['s']:.2f} s "
          f"on the mesh against {refs['jamba_s']:.2f} s on one device; peak "
          f"by rank {', '.join(str(j['peak'] // mib) for j in jr)} MiB above "
          f"{jr[0]['param_bytes'][0] // mib} of {refs['jamba_bytes'] // mib} "
          f"MiB of parameters a rank; staged, rank 0, by op (calls, bytes): "
          f"{jr[0]['staged']}")
    check(all(g <= LOGIT_ATOL + LOGIT_RTOL * scale for g in gaps),
          f"jamba mesh logit gaps {gaps}")
    d_inner = mamba.d_inner(_config("jamba-1.5-large-398b"))
    for r, j in enumerate(jr):
        check(j["widths"] == [("Mamba d_inner", d_inner // 2)],
              f"rank {r}: jamba ran on {j['widths']}")
        check(len(j["routes"]) == len(refs["jamba_routes"]) and all(
            all(torch.equal(a, b) for a, b in zip(x, y))
            for x, y in zip(j["routes"], refs["jamba_routes"])),
            f"rank {r}: jamba routes differ from one device")
        check(j["b5_launches"] == j["b5_want"] == j["b5_calls"],
              f"rank {r}: jamba B5 launches {j['b5_launches']}, calls "
              f"{j['b5_calls']}, want {j['b5_want']}")
        check(j["b5_held"], f"rank {r}: a jamba B5 launch differs from plain")


def _rank_all(rank, world, opts, chips_cfg, fparams, streams, seed, prompts,
              rwkv_prompts, jamba_tokens):
    """Every job of the sharded phase on one rank, in one spawn."""
    SHARD_OPTS.update(opts)
    return {"probe": _rank_probe(rank, world),
            "chips": _rank_chips(rank, world, chips_cfg, fparams, streams),
            "serve": _rank_serve(rank, world, seed + 9, prompts),
            "cuts": _rank_cuts(rank, world, seed),
            "mixers": _rank_mixers(rank, world, seed + 11, rwkv_prompts,
                                   jamba_tokens)}


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
    # the phases draw and free models of 5-65 GB one after the other: let
    # the allocator grow and shrink its segments instead of keeping blocks
    # that a later phase's tensors cannot reuse (rwkv6-3b's training step,
    # 65 GiB at its peak, ran out of memory behind 15 GiB of such blocks);
    # read when CUDA is first initialised
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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

    # cuBLAS's deterministic workspace, for the LM training phases that run
    # under torch.use_deterministic_algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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

    # each section's and phase's wall time, on the host clock: where the
    # script's 1,200 s go
    lap_at = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"{tag} section {what}: {now - lap_at[0]:.1f} s (host clock)")
        lap_at[0] = now

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

    lap("build")

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

    # B1's group form: fabrics over one block's shared memory
    group_times = grouped_fabric(dev, tag, max_err)

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

    # lif_step on bfloat16, bitwise, at the SNN's shape and the JAX test's
    # (tests/test_kernels.py::test_lif_step_sweep), with values exactly at
    # the threshold: the kernel rounds the product and then the float32 sum
    # to bfloat16, as the plain version and JAX do
    for shape in LIF_BF16_SHAPES:
        v = (torch.randn(shape, generator=gen, device=dev) * 3).to(
            torch.bfloat16)
        i = (torch.randn(shape, generator=gen, device=dev) * 3).to(
            torch.bfloat16)
        at = torch.rand(shape, generator=gen, device=dev) < 1 / 64
        v[at], i[at] = 0.0, snn_cfg.threshold
        got = lif_kernel.lif_step_cuda(v, i, snn_cfg.decay,
                                       snn_cfg.threshold, 0.0)
        want = lif_ref.lif_step_ref(v, i, **lif_args)
        torch.cuda.synchronize()
        for name, g, w in zip(("v_next", "spikes"), got, want):
            check(g.dtype == torch.bfloat16 and torch.equal(
                g.view(torch.int16), w.view(torch.int16)),
                f"lif_step bfloat16 {name} differ at {shape}")
        check(bool(got[1][at].eq(1).all())
              and 0 < int(got[1].float().sum()) < got[1].numel(),
              f"lif_step bfloat16 at {shape}: threshold values must fire")
        print(f"kernel == plain: lif_step {shape} bfloat16, decay "
              f"{snn_cfg.decay} (bfloat16 {lif_ref.as_bfloat16(snn_cfg.decay)})"
              f", {int(at.sum())} values at the threshold (v_next and spikes "
              f"bitwise)")

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

    lap("kernels against their plain versions")

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

    # impl="pallas" where the whole-run hat kernel has no branch (hier_ring
    # at a non-square n): B3's stream form, held to the xla session
    stream_form_launches = pallas_stream_form(
        dev, tag, reset_launches, read_launches, no_launch, streams)

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

    lap("main paths")

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

    lap("times")

    # the SNN trained through the port's example, before the served LM's
    # parameters are drawn
    train_launches = trained_snn(dev, tag, reset_launches, read_launches,
                                 no_launch, root)
    lap("trained SNN")

    # the served LM: its checks, times and profile (moe_dispatch's path)
    path_launches["moe_dispatch"], moe_ids = served_lm(
        dev, tag, reset_launches, read_launches, no_launch)
    lap("served DeepSeek-V2-Lite")

    # the dense GQA LMs: 2-layer full-width checks, banded attention,
    # internlm2-1.8b and gemma3-12b served, internlm2-1.8b trained (no
    # kernel on these paths), after the DeepSeek phase freed its 62.8 GB
    dense_lms(dev, tag, reset_launches, read_launches, no_launch)
    lap("dense LMs")

    # the rest of the registry: RWKV6, the Jamba hybrid (B5 on its two MoE
    # layers), the audio and vision frontends, deepseek-v2-236b's cut with
    # bfloat16 and int8 experts (B5 at 160 experts); rwkv6-3b trained
    jamba_b5 = hybrid_lms(dev, tag, reset_launches, read_launches, no_launch)
    lap("hybrid LMs")

    # the fabric serving tier: its checks, launches per flush and times
    serve_per_flush = served_fabric(dev, tag, reset_launches, read_launches,
                                    no_launch)
    lap("served fabric")

    # the multi-chip fabric: the chip tier, shard="chips", telemetry,
    # faults, faulted and sharded tenants, the oracle
    chip_sessions = multichip_fabric(
        dev, tag, reset_launches, read_launches, no_launch, params,
        {label: s for label, s in sessions}, streams)
    lap("multi-chip fabric")

    # the mesh: 4 gloo ranks on the card (probe, shard="chips", the LM
    # paths with B5 a rank, a train step), NCCL on one rank, the dry run
    mesh_b5 = sharded(dev, tag, xla_session, chip_sessions["xla"], streams)
    lap("sharded")

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
                    train_eval_launches=train_launches["sparse_tick"],
                    group_form=group_times)
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
          f"launches; {wide_plan.run.kernel.plan.smem} B of shared memory a "
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
                    serve_launches_per_flush=serve_per_flush["hat_encode"],
                    stream_form_launches_hier_ring_512=stream_form_launches)
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
    # the same state in bfloat16: 8 bytes an element, the bound by bytes;
    # cold as the float32 row, beside the plain version
    vb, ib = v.to(torch.bfloat16), i.to(torch.bfloat16)
    bf16_outs = lif_kernel.lif_step_cuda(vb, ib, snn_cfg.decay,
                                         snn_cfg.threshold, 0.0)
    bf16_ms, bf16_bound = report(
        "lif_step",
        lambda: lif_kernel.lif_step_cuda(vb, ib, snn_cfg.decay,
                                         snn_cfg.threshold, 0.0),
        "lif_step", lambda: lif_ref.lif_step_ref(vb, ib, **lif_args), None,
        nbytes(vb, ib, *bf16_outs), 3 * vb.numel(), FP32_OPS_PER_S,
        "fp32 ops at 67 TFLOP/s: product, sum, compare",
        2000, cold=True, row=False, label="bfloat16")
    rows[-1].update(bf16_ms=bf16_ms, bf16_bound_ms=bf16_bound)

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
    next(r for r in rows if r["name"] == "moe_dispatch").update(
        jamba_launches_per_generate=jamba_b5,
        mesh_launches_per_rank=mesh_b5["deepseek"],
        mesh_jamba_launches_per_rank=mesh_b5["jamba"])

    lap("kernel times")

    # ---- 6. result lines -------------------------------------------------
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
