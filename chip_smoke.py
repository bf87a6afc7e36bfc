"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases (any failure exits nonzero; no phase catches its own failure):

 1. the card: name and power limit (nvidia-smi) and torch's device name;
    no CUDA device exits 1 before anything else runs;
 2. the build: the port's five CUDA sources (sparse_tick, cam_search,
    hat_encode, lif_step, moe_dispatch), one nvcc each, started together,
    with build times and the ptxas register/shared-memory report;
 3. each kernel against its plain torch version on the card, at the main
    paths' shapes, exactly equal: the sparse tick at 16 cores x 256
    neurons x 512 CAM entries for all five arbiter schemes (plus 64
    cores); cam_search's match counts at 8192 queries x 4096 sources x 1
    word with 1 and 3 lanes, and its match matrix, first match and
    speculative search at odd shapes with 1-3 words; hat_encode at N in
    {256, 512, 65536} and spike rates 0, 0.05, 0.5 and 1; lif_step
    bitwise at (128, 4096), (8, 512) and (32, 128), with values exactly
    at the threshold and one ulp below it; moe_dispatch exactly at the
    JAX sweep's (M, E) = (256, 16), (2048, 160), (512, 64), (4096, 128)
    and at the served streams (decode: 4 x 6 events padded to 256,
    prefill: M = 3072, E = 64), each uniform, all on one expert, and
    with pad and stray ids;
 4. the main paths: `Interface(cfg).compile(params).run(spikes)` on the
    paper's scaled DYNAPs fabric (16 x 256 x 512, hier_tree arbiter,
    multicast_tree NoC), over two 256-tick streams - Bernoulli 0.05, and
    the same stream with every 16th frame a full burst - first with
    impl="pallas_sparse" (the sparse kernel, the dense fallback on the
    burst ticks), then with impl="pallas" (cam_search and hat_encode on
    every tick), each driven with every launch count set to 0 just before
    and read just after; each held to the impl="xla" session (currents
    bitwise, stats under the conformance contract) and to the CPU plain
    path on a 16-tick prefix; then the paper's SNN workload,
    `snn_forward` at `paper_dynaps.scaled_config()` (16 x 256 neurons,
    512 CAM entries, 32 steps) on a batch of 128 rasters, impl="pallas"
    (lif_step once per step) against impl="xla" (spikes, rates and
    logits bitwise), the card against the CPU port on an 8-sample
    prefix, and account=True on 32 samples (1024 ticks); then the served
    LM: DeepSeek-V2-Lite at full width and depth (15.71 B float32
    parameters drawn on the card), `ServeEngine.generate` greedy on 4
    requests of 128 prompt tokens and 32 new tokens, moe_dispatch once per
    MoE layer per forward (26 x 33); the route of every MoE layer of one
    prefill on the card against `hat_route` on the CPU; and the model at
    full width cut to its dense layer and one MoE layer, in float32,
    teacher-forced on the card and on the CPU from the same parameters;
 5. times, each printed beside the card's name and power limit: session
    ms per tick as the median and quartiles of interleaved runs, the host
    time per tick split by stage, a device profile of each tick, the SNN
    forward's ms per batch, host split and device profile, the served
    LM's prefill ms, decode ms per step, tokens/s, host split and device
    profile, and every kernel's, plain version's and library call's time
    per call;
 6. a ``kernels`` JSON line, then the card line, then the ok line.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
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
# int32 on the CUDA cores: 64 INT32 lanes per SM against 128 FP32 lanes
# (Hopper white paper), so half the data sheet's float32 rate
INT32_OPS_PER_S = FP32_OPS_PER_S / 2
EXACT_FIELDS = ("events", "cam_searches", "noc_hops", "chip_hops")
REL_TOL = 1e-6
SCHEMES = ("binary_tree", "greedy_tree", "token_ring", "hier_ring",
           "hier_tree")
CORES, NEURONS, ENTRIES = 16, 256, 512
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
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 128, 32
LM_CHECK_BATCH, LM_CHECK_TOKENS = 2, 32
LM_RUNS = 3
# card against CPU on the same inputs, float32 softmax and sums in
# another order: route weights, aux and z losses (an H100 read 1.9e-6),
# and the logits of the 2-layer full-width float32 cut (an H100 read
# 8.9e-6 with logits up to 5.4)
ROUTE_RTOL, ROUTE_ATOL = 1e-5, 1e-6
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-4


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
    no_launch = dict.fromkeys(kernel_modules, 0)
    lm_cfg = deepseek_v2_lite_16b.config()

    def reset_launches():
        for module in kernel_modules.values():
            module.launches = 0

    def read_launches():
        return {name: m.launches for name, m in kernel_modules.items()}

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
    nvcc_s = build.ensure_built(*kernel_modules)
    print(f"build: {time.perf_counter() - t0:.3f} s for {len(nvcc_s)} "
          f"sources in parallel (nvcc " + ", ".join(
              f"{k} {'already built' if v is None else f'{v:.3f} s'}"
              for k, v in nvcc_s.items()) + ")")
    for name in kernel_modules:
        for line in build.ptxas_report(name).splitlines():
            if "Used" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    def config(scheme, cores=CORES, impl="pallas_sparse"):
        return InterfaceConfig(cores=cores, neurons_per_core=NEURONS,
                               cam_entries_per_core=ENTRIES, scheme=scheme,
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
            max_err["sparse_tick"] = max(max_err["sparse_tick"],
                                         float((g - w).abs().max()))
        print(f"kernel == plain: sparse_tick {scheme} "
              f"{cores}x{NEURONS}x{ENTRIES} (currents bitwise, "
              f"latency/energy/hits exact)")

    # cam_search counts at the path's shapes: the fabric's own packed tags
    # against every source address, valid = the lanes' spike frames
    cfg = config("hier_tree", impl="pallas")
    params = random_connectivity(torch.Generator(dev).manual_seed(SEED), cfg)
    routing = pipeline.build_routing_index(params, cfg)
    q_words, src_words = routing.q_words, routing.src_words
    for rates in ((RATE,), (RATE, 0.5, 1.0)):
        valid = torch.rand((len(rates), src_words.shape[0]), generator=gen,
                           device=dev) < torch.tensor(rates, device=dev)[:, None]
        got = cam_kernel.cam_match_counts_cuda(q_words, src_words, valid)
        want = cam_ref.match_counts_ref(q_words, src_words, valid)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"cam_match_counts differ at "
              f"{tuple(q_words.shape)} x {tuple(valid.shape)}")
        check(int(want.sum()) > 0, "cam_match_counts check saw no match")
        max_err["cam_search"] = max(max_err["cam_search"], float(
            (got - want).abs().max()))
        print(f"kernel == plain: cam_match_counts {q_words.shape[0]} queries "
              f"x {src_words.shape[0]} sources x W={q_words.shape[1]}, "
              f"{len(rates)} lane(s) at rates {rates} (exact)")

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

    # hat_encode, with the AER stream it writes in the same pass
    for n, rows in ((256, CORES), (512, 8), (65536, 2)):
        for rate in (0.0, RATE, 0.5, 1.0):
            spikes = torch.rand((rows, n), generator=gen, device=dev) < rate
            ranks, count, clusters, stream = hat_kernel.hat_encode_cuda(
                spikes, row=256, stream=True)
            want = hat_ref.hat_encode_ref(spikes, row=256)
            torch.cuda.synchronize()
            for name, g, w in zip(("ranks", "count", "cluster counts"),
                                  (ranks, count, clusters), want):
                check(torch.equal(g, w), f"hat_encode {name} differ at "
                      f"N={n} rate={rate}")
            check(torch.equal(stream, hat_ref.compact_stream(*want[:2])),
                  f"hat_encode stream differs at N={n} rate={rate}")
        print(f"kernel == plain: hat_encode {rows} bitmaps of N={n} at rates "
              f"0, {RATE}, 0.5, 1 (ranks, counts, clusters, stream exact)")

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
    for label, ids, e in moe_cases:
        one = torch.full_like(ids, e - 1)
        stray = ids.clone()
        stray[ids.numel() // 2:] = e
        stray[::29] = -3
        for kind, x in (("uniform", ids), ("one expert", one),
                        ("pad and stray ids", stray)):
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
              f"expert, pad and stray ids (positions and loads exact)")

    # ---- 4. the main paths -----------------------------------------------
    sparse_session = Interface(config("hier_tree")).compile(params)
    pallas_session = Interface(cfg).compile(params)
    xla_session = Interface(config("hier_tree", impl="xla")).compile(params)
    sessions = (("pallas", pallas_session), ("pallas_sparse", sparse_session),
                ("xla", xla_session))
    check(all(s.device == dev for _, s in sessions), "sessions not on the card")
    capacity = sparse_session.plan.sparse[2]
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
        **no_launch, "sparse_tick": sum(fits.values())},
        f"pallas_sparse launches {launches['pallas_sparse']}: want "
        f"sparse_tick once per non-overflowing tick, no cam_search or "
        f"hat_encode")
    check(launches["pallas"] == {**no_launch, "cam_search": ticks_all,
                                 "hat_encode": ticks_all},
          f"pallas launches {launches['pallas']}: want cam_search and "
          f"hat_encode once per tick")
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
        ("compact_events", sparse_ops, "compact_events"),
        ("sparse_tick (kernel wrapper)", sparse_ops, "sparse_tick"),
        ("event_indices", sparse_ops, "event_indices"),
        ("event-indexed accounting", pipeline, "sparse_accounting_stats"),
        ("  of it NoC costs", noc_router, "noc_step_costs_events"),
        ("dense fallback tick", pipeline, "dense_tick")),
        "rest of the loop (stats stack and accumulate, currents)")
    print_breakdown("pallas", pallas_session, (
        ("_entry_drive", pipeline, "_entry_drive"),
        ("  of it the cam_match_counts op", cam_ops, "cam_match_counts"),
        ("_addr_streams", pipeline, "_addr_streams"),
        ("  of it the encode_stream op", hat_ops, "encode_stream"),
        ("accounting_stats", pipeline, "accounting_stats"),
        ("  of it NoC costs", noc_router, "noc_step_costs")),
        "rest (arbiter latency, CSR scatter, encode energy, stats "
        "accumulate, currents)")

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

    # the served LM: its checks, times and profile (moe_dispatch's path)
    path_launches["moe_dispatch"], moe_ids = served_lm(
        dev, tag, reset_launches, read_launches, no_launch)

    rows = []

    def report(name, kernel_fn, kernel_name, plain_fn, library_fn, nbytes_,
               ops, ops_per_s, ops_note, reps):
        """Time one kernel beside its plain version and library call on
        the same inputs; print its line and add its kernels-line row."""
        call_ms = cuda_ms(kernel_fn, reps)
        plain_call_ms = cuda_ms(plain_fn, reps // 10)
        ms = device_ms_per_call(kernel_fn, reps // 10, kernel_name)
        plain_ms = device_ms_per_call(plain_fn, reps // 40)
        library_ms = (device_ms_per_call(library_fn, reps // 10)
                      if library_fn is not None else None)
        bound_ms, bound_by = bound(nbytes_, ops, ops_per_s)
        lib = ("none" if library_ms is None
               else f"{library_ms * 1e3:.3f} us/call")
        print(f"{tag} {name} kernel: {ms * 1e3:.3f} us/launch; plain torch "
              f"version: {plain_ms * 1e3:.3f} us/call; library call: {lib} "
              f"(profiler device time); bound {bound_ms * 1e3:.4f} us by "
              f"{bound_by} ({nbytes_} bytes at 3.35 TB/s; {ops} {ops_note})")
        print(f"{tag} {name} per call as a caller waits (CUDA events, "
              f"back-to-back, host overhead included): wrapper "
              f"{call_ms * 1e3:.3f} us ({reps} calls), plain torch "
              f"{plain_call_ms * 1e3:.3f} us ({reps // 10} calls)")
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": kernel_modules[name].REPLACES,
            "launches": path_launches[name], "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms})

    # B1: the bound counts what it reads and writes (its inputs, the CAM
    # entries' int32 targets among them, and its four outputs), each once;
    # the port's CSR is a layout of the targets, not extra work.
    args, policy, sparse_params = operands(config("hier_tree"),
                                           sparse_stream[:1], SEED)
    outs = kernel_call(args, policy)
    report("sparse_tick", lambda: kernel_call(args, policy),
           "sparse_tick_kernel", lambda: plain_call(args, policy), None,
           nbytes(*args[:6], sparse_params.targets, *outs),
           int(args[4].sum()) + args[3].numel(), FP32_OPS_PER_S,
           "fp32 ops at 67 TFLOP/s", 2000)

    # B2 on the path: one tick's match counts, one lane; about 2W + 1
    # integer operations per (query, source) pair (compares, ANDs, add)
    valid = sparse_stream[:1].reshape(1, -1)
    counts = cam_kernel.cam_match_counts_cuda(q_words, src_words, valid)
    b, w = q_words.shape
    report("cam_search",
           lambda: cam_kernel.cam_match_counts_cuda(q_words, src_words,
                                                    valid),
           "cam_match_counts_kernel",
           lambda: cam_ref.match_counts_ref(q_words, src_words, valid), None,
           nbytes(q_words, src_words, valid, counts),
           valid.shape[0] * b * src_words.shape[0] * (2 * w + 1),
           INT32_OPS_PER_S, "int32 ops at 33.5 TOP/s", 2000)

    # B3 on the path: one tick's bitmaps (every core of one lane), with
    # the AER stream; its library call is torch.cumsum over the same
    # bitmaps as int32, which gives the ranks up to the where.
    bitmaps = sparse_stream[0]
    hat_outs = hat_kernel.hat_encode_cuda(bitmaps, row=256, stream=True)
    as_int = bitmaps.to(torch.int32)
    report("hat_encode",
           lambda: hat_kernel.hat_encode_cuda(bitmaps, row=256, stream=True),
           "hat_encode_kernel",
           lambda: hat_ops.encode_stream(bitmaps, row=256, impl="xla"),
           lambda: torch.cumsum(as_int, -1),
           nbytes(bitmaps, *hat_outs), bitmaps.numel(), INT32_OPS_PER_S,
           "int32 adds at 33.5 TOP/s", 2000)

    # B4 on the path: one step's (128, 4096) float32 state; v and I in,
    # v' and s out; three float32 operations an element (the FMA as two,
    # the compare).  No one PyTorch call computes the LIF update.
    v = torch.randn((SNN_BATCH, n_total), generator=gen, device=dev) * 3
    i = torch.randn((SNN_BATCH, n_total), generator=gen, device=dev) * 3
    lif_outs = lif_kernel.lif_step_cuda(v, i, snn_cfg.decay,
                                        snn_cfg.threshold, 0.0)
    report("lif_step",
           lambda: lif_kernel.lif_step_cuda(v, i, snn_cfg.decay,
                                            snn_cfg.threshold, 0.0),
           "lif_step", lambda: lif_ref.lif_step_ref(v, i, **lif_args), None,
           nbytes(v, i, *lif_outs), 3 * v.numel(), FP32_OPS_PER_S,
           "fp32 ops at 67 TFLOP/s", 2000)

    # B5 on the path: the first MoE layer's prefill stream (4 x 128 tokens x
    # top-6 = 3072 events, E = 64); ids in, positions and loads out; about
    # two integer operations an event (its count, its rank).  No one
    # PyTorch call computes arrival-order positions.
    moe_outs = moe_kernel.dispatch_positions_cuda(moe_ids, experts)
    report("moe_dispatch",
           lambda: moe_kernel.dispatch_positions_cuda(moe_ids, experts),
           "moe_dispatch",
           lambda: moe_ref.dispatch_positions_ref(moe_ids, experts), None, nbytes(moe_ids, *moe_outs), 2 * moe_ids.numel(),
           INT32_OPS_PER_S, "int32 ops at 33.5 TOP/s", 2000)

    # ---- 6. result lines -------------------------------------------------
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
