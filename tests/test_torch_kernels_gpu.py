"""The CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: each test decides inside itself whether there is a CUDA
device and skips with a reason when there is none.  Run on a machine
with the card (no JAX needed there, so the JAX conftest is left out):

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import arbiter as arb
from repro_torch.interface import Interface, InterfaceConfig, pipeline
from repro_torch.interface import registry as interface_registry
from repro_torch.interface.types import random_connectivity
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
from repro_torch.kernels.moe_dispatch import ops as moe_ops
from repro_torch.kernels.moe_dispatch import ref as moe_ref
from repro_torch.kernels.sparse_tick import kernel as sparse_kernel
from repro_torch.kernels.sparse_tick import ops as sparse_ops
from repro_torch.kernels.sparse_tick import ref as sparse_ref
from repro_torch.noc.topology import NocConfig

SCHEMES = ("binary_tree", "greedy_tree", "token_ring", "hier_ring",
           "hier_tree")
NOC_SCHEMES = ("broadcast", "unicast", "multicast_tree")
INT_FIELDS = (0, 1, 3, 6, 8, 9, 10, 11)   # StepStats fields of whole numbers


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _operands(scheme, cores, n, entries, lanes, p, seed, device):
    cfg = InterfaceConfig(cores=cores, neurons_per_core=n,
                          cam_entries_per_core=entries, scheme=scheme,
                          impl="pallas_sparse")
    gen = torch.Generator().manual_seed(seed)
    params = random_connectivity(gen, cfg).to(device)
    routing = pipeline.build_routing_index(params, cfg)
    policy, _, capacity = pipeline.resolve_sparse_plan(
        cfg, arb.ArbiterConfig(scheme, n))
    rng = np.random.default_rng(seed)
    spikes = torch.from_numpy(rng.random((lanes, cores, n)) < p).to(device)
    # keep every core within capacity, as the session guarantees
    keep = spikes.to(torch.int32).cumsum(-1) <= capacity
    spikes = spikes & keep
    buf, counts = sparse_ops.compact_events(spikes, capacity)
    args = (spikes.reshape(lanes, -1), buf, counts, routing.src_idx,
            routing.active, params.weights, routing.csr)
    return args, policy, n


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("cores,lanes", [(16, 1), (64, 1), (16, 3)])
def test_kernel_matches_plain_version(scheme, cores, lanes):
    device = _cuda()
    args, policy, n = _operands(scheme, cores, 256, 512, lanes, 0.05, 7,
                                device)
    before = sparse_kernel.tick_launches
    got = sparse_kernel.sparse_tick_cuda(
        *args, n=n, policy=policy.kernel_policy, levels=policy.levels)
    torch.cuda.synchronize()
    assert sparse_kernel.tick_launches == before + 1
    want = sparse_ref.sparse_tick_ref(*args, n=n,
                                      latency_fn=policy.latency_fn,
                                      encode_fn=policy.encode_fn)
    for name, g, w in zip(("currents", "latency", "encode", "hits"), got,
                          want):
        assert torch.equal(g, w), name


@pytest.mark.gpu
def test_cuda_dispatch_launches_kernel_and_never_falls_back():
    device = _cuda()
    args, policy, n = _operands("hier_tree", 16, 256, 512, 1, 0.05, 3,
                                device)
    before = sparse_kernel.tick_launches, sparse_kernel.launches
    sparse_ops.sparse_tick(*args, n=n, policy=policy)
    assert (sparse_kernel.tick_launches,
            sparse_kernel.launches) == (before[0] + 1, before[1])
    with pytest.raises(ValueError):
        sparse_ops.sparse_tick(*args, n=n,
                               policy=policy._replace(kernel_policy=None))


# ---- the whole-run sparse tick (B1, sparse_run) ------------------------------


def _run_case(scheme, noc, cores, n, entries, lanes, ticks, seed, device,
              burst=(1,), fan_in=0.9, chips=1):
    """A pallas_sparse plan on the card and a (B, T, C, n) stream whose
    ticks in ``burst`` overflow (full frames); the other frames are cut
    to the capacity."""
    cfg = InterfaceConfig(cores=cores, neurons_per_core=n,
                          cam_entries_per_core=entries, scheme=scheme,
                          noc=NocConfig(noc), impl="pallas_sparse",
                          chips=chips)
    params = random_connectivity(torch.Generator().manual_seed(seed), cfg,
                                 fan_in=fan_in).to(device)
    plan = pipeline.make_plan(params, cfg)
    rng = np.random.default_rng(seed)
    frames = rng.random((lanes, ticks, cores, n)) < 0.05
    frames &= np.cumsum(frames, -1) <= plan.run.capacity
    frames[:, [t for t in burst if t < ticks]] = True
    stream = torch.from_numpy(frames).to(device)
    overflow = [t in burst for t in range(ticks)]
    return plan, params, stream, overflow


def _kernel_and_plain(plan, params, stream, overflow, acc0=None, core=False):
    """The fused kernel and its plain version on the same card inputs, the
    dense fallback's rows written alike first, both sums seeded by
    ``acc0`` when given; with ``core`` also both per-core outputs (their
    dense rows NaN alike), last."""
    lanes, ticks = stream.shape[:2]
    cur = torch.full((lanes, ticks) + tuple(stream.shape[2:]), np.nan,
                     device=stream.device)
    table = torch.full((ticks, 12, lanes), np.nan, device=stream.device)
    for t in range(ticks):
        if overflow[t]:
            c, st = pipeline.dense_tick(plan, params, stream[:, t])
            cur[:, t], table[t] = c, torch.stack(tuple(st))
    plain = (cur.clone(), table.clone())
    sparse = [t for t in range(ticks) if not overflow[t]]
    index = torch.tensor(sparse, dtype=torch.int32, device=stream.device)
    cores = (torch.full((2, ticks, lanes, stream.shape[2]), np.nan,
                        device=stream.device) if core else None)
    plain_cores = cores.clone() if core else None
    before = sparse_kernel.launches
    acc = sparse_kernel.sparse_run_cuda(
        stream, None if len(sparse) == ticks else index, plan.run.kernel,
        cur, table, acc0, cores)
    torch.cuda.synchronize()
    assert sparse_kernel.launches == before + 1
    assert int(plan.run.kernel.done) == 0       # ready for the next launch
    want = sparse_ops.sparse_run_ref(stream, sparse, plan.run, *plain, acc0,
                                     plain_cores)
    if core:
        return (cur, table, acc, cores), (*plain, want, plain_cores)
    return (cur, table, acc), (*plain, want)


def _assert_run_equal(got, want):
    """Currents bitwise; stats rows and sums: whole-number fields exact,
    the rest within 1e-6 relative."""
    assert torch.equal(got[0], want[0]), "currents"
    for g, w in zip(got[1:], want[1:]):
        g, w = g.movedim(-2, 0), w.movedim(-2, 0)       # fields first
        assert bool(g.isfinite().all())
        for f in range(12):
            if f in INT_FIELDS:
                assert torch.equal(g[f], w[f]), f
            else:
                torch.testing.assert_close(g[f], w[f], rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("noc", NOC_SCHEMES)
def test_sparse_run_matches_plain_version(scheme, noc):
    device = _cuda()
    case = _run_case(scheme, noc, 4, 16, 32, 3, 7, 11, device, burst=(2, 5))
    _assert_run_equal(*_kernel_and_plain(*case))


@pytest.mark.gpu
@pytest.mark.parametrize("noc", NOC_SCHEMES)
@pytest.mark.parametrize("cores", [16, 64])
def test_sparse_run_at_full_width(noc, cores):
    device = _cuda()
    case = _run_case("hier_tree", noc, cores, 256, 512, 2, 9, cores, device,
                     burst=(0, 4))
    _assert_run_equal(*_kernel_and_plain(*case))


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", SCHEMES)
def test_sparse_run_every_scheme_at_16_cores(scheme):
    device = _cuda()
    case = _run_case(scheme, "multicast_tree", 16, 256, 512, 1, 16, 5,
                     device, burst=())
    _assert_run_equal(*_kernel_and_plain(*case))


@pytest.mark.gpu
@pytest.mark.parametrize("lanes,ticks", [(48, 3), (3, 200)])
def test_sparse_run_sums_tables_larger_than_a_chunk(lanes, ticks):
    """More than 42 lanes (over 512 (field, lane) sums) and more rows than
    the last block stages at once: the tick-order sum in chunks."""
    device = _cuda()
    case = _run_case("hier_tree", "unicast", 4, 16, 32, lanes, ticks, 6,
                     device, burst=(1,))
    _assert_run_equal(*_kernel_and_plain(*case))


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["binary_tree", "hier_tree"])
def test_sparse_run_frames_off_16_byte_boundaries(scheme):
    """3 cores x 8 neurons: 24-byte frames, staged without cp.async."""
    device = _cuda()
    case = _run_case(scheme, "multicast_tree", 3, 8, 16, 2, 5, 9, device,
                     burst=(3,))
    _assert_run_equal(*_kernel_and_plain(*case))


@pytest.mark.gpu
def test_sparse_run_without_sparse_ticks_still_sums():
    device = _cuda()
    plan, params, stream, _ = _run_case("hier_tree", "unicast", 4, 16, 32, 2,
                                        3, 2, device, burst=(0, 1, 2))
    _assert_run_equal(*_kernel_and_plain(plan, params, stream, [True] * 3))


@pytest.mark.gpu
def test_sparse_run_refuses_what_it_cannot_hold():
    device = _cuda()
    plan, _, stream, _ = _run_case("hier_tree", "multicast_tree", 16, 256,
                                   512, 1, 2, 3, device, burst=())
    ops = plan.run.kernel
    with pytest.raises(ValueError, match="MAX_SHARED_BYTES"):
        _run_case("hier_tree", "multicast_tree", 64, 256, 512, 1, 2, 3,
                  device, fan_in=1.0)     # every CAM entry of 64 cores live
    table = torch.empty((2, 12, 1), device=device)
    cur = torch.empty((1, 2, 16, 256), device=device)
    before = sparse_kernel.launches
    with pytest.raises(ValueError):
        sparse_kernel.sparse_run_cuda(stream.to(torch.uint8), None, ops, cur,
                                      table)
    with pytest.raises(ValueError):
        sparse_kernel.sparse_run_cuda(stream, None, ops, cur[:, :1], table)
    assert sparse_kernel.launches == before


def _seed(lanes, seed, device):
    """A (12, B) accumulator seed as a served lane carries it: whole
    numbers in the whole-number fields, fractions in the rest."""
    rng = np.random.default_rng(seed)
    acc0 = rng.random((12, lanes)).astype(np.float32) * 1000
    acc0[list(INT_FIELDS)] = np.round(acc0[list(INT_FIELDS)])
    return torch.from_numpy(acc0).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("noc", NOC_SCHEMES)
def test_sparse_run_seeded_by_acc0_matches_plain_version(scheme, noc):
    """The tick-order sum starts at the seed, as its plain version's does:
    the sums bitwise, the seed untouched, with overflow ticks and a lane
    at rest (all-False frames) that returns its seed row unchanged."""
    device = _cuda()
    plan, params, stream, overflow = _run_case(scheme, noc, 4, 16, 32, 3, 7,
                                               11, device, burst=(2, 5))
    stream[2] = False                    # lane 2 at rest: every frame empty
    acc0 = _seed(3, 5, device)
    kept = acc0.clone()
    got, want = _kernel_and_plain(plan, params, stream, overflow, acc0)
    _assert_run_equal(got, want)
    assert torch.equal(got[2], want[2]), "seeded sums differ from the plain"
    assert torch.equal(acc0, kept), "the kernel wrote its seed"
    assert torch.equal(got[2][:, 2], kept[:, 2]), "a lane at rest moved"
    assert got[2].data_ptr() != acc0.data_ptr()


@pytest.mark.gpu
def test_sparse_run_chunked_by_acc0_equals_one_run():
    """A stream cut into chunks, each seeded with the previous chunk's
    sums, gives the one run's sums bit for bit."""
    device = _cuda()
    plan, params, stream, overflow = _run_case(
        "hier_tree", "multicast_tree", 16, 256, 512, 2, 12, 4, device,
        burst=(3, 8))
    _, one = _kernel_and_plain(plan, params, stream, overflow)
    acc = None
    for lo in (0, 5, 9):
        hi = {0: 5, 5: 9, 9: 12}[lo]
        got, _ = _kernel_and_plain(plan, params,
                                   stream[:, lo:hi].contiguous(),
                                   overflow[lo:hi], acc)
        acc = got[2]
    assert torch.equal(acc, one[2])


@pytest.mark.gpu
def test_sparse_run_of_no_ticks_returns_a_copy_of_its_seed():
    device = _cuda()
    plan, _, stream, _ = _run_case("hier_tree", "unicast", 4, 16, 32, 2, 3,
                                   2, device)
    acc0 = _seed(2, 1, device)
    empty = stream[:, :0].contiguous()
    before = sparse_kernel.launches
    acc = sparse_kernel.sparse_run_cuda(
        empty, None, plan.run.kernel, torch.empty((2, 0, 4, 16),
                                                  device=device),
        torch.empty((0, 12, 2), device=device), acc0)
    assert torch.equal(acc, acc0) and acc.data_ptr() != acc0.data_ptr()
    assert sparse_kernel.launches == before
    with pytest.raises(ValueError, match="acc0"):
        sparse_kernel.sparse_run_cuda(
            stream, None, plan.run.kernel,
            torch.empty(tuple(stream.shape), device=device),
            torch.empty((3, 12, 2), device=device), acc0[:, :1])


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["pallas_sparse", "pallas"])
def test_masked_session_on_the_card_equals_solo_runs(impl):
    """Ragged lanes of a masked run_batched, chunked through stats0, give
    each lane its solo run's currents and stats bit for bit, with one B1
    launch a chunk (pallas_sparse) or one B3 launch and one B2 launch a
    tick (pallas)."""
    device = _cuda()
    plan, params, stream, _ = _run_case(
        "hier_tree", "multicast_tree", 16, 256, 512, 3, 12, 4, device,
        burst=(3, 8))
    cfg = dataclasses.replace(plan.cfg, impl=impl)
    session = Interface(cfg).compile(params)
    lengths = (12, 7, 0)
    mask = torch.zeros((3, 12), dtype=torch.bool, device=device)
    for lane, t in enumerate(lengths):
        mask[lane, :t] = True
    counts = (sparse_kernel, hat_kernel, cam_kernel)
    before = [m.launches for m in counts]
    acc, parts = None, []
    for lo, hi in ((0, 6), (6, 12)):
        cur, acc = session.run_batched(stream[:, lo:hi], mask=mask[:, lo:hi],
                                       stats0=acc)
        parts.append(cur)
    torch.cuda.synchronize()
    grew = [m.launches - b for m, b in zip(counts, before)]
    assert grew == ([2, 0, 0] if impl == "pallas_sparse" else [0, 2, 12])
    cur = torch.cat(parts, 1)
    for lane, t in enumerate(lengths):
        assert not bool(cur[lane, t:].any()), lane
        if t == 0:                       # all padding: exact zeros
            assert all(float(a[lane]) == 0.0 for a in acc), lane
            continue
        solo_cur, solo = session.run(stream[lane, :t])
        assert torch.equal(cur[lane, :t], solo_cur), lane
        for f, (a, b) in enumerate(zip(acc, solo)):
            assert torch.equal(a[lane], b), (lane, f)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["pallas_sparse", "pallas"])
def test_all_false_frame_gives_exact_zeros_on_the_card(impl):
    """Every arbiter x NoC scheme: an empty tick adds exactly +0.0 to each
    stat (an empty core's encode toggles times zero events), through B1's
    stats tail and B3's terms, so a masked lane keeps its seed."""
    device = _cuda()
    for scheme in SCHEMES:
        for noc in NOC_SCHEMES:
            cfg = InterfaceConfig(cores=4, neurons_per_core=256,
                                  cam_entries_per_core=64, scheme=scheme,
                                  noc=NocConfig(noc), impl=impl)
            params = random_connectivity(torch.Generator().manual_seed(2),
                                         cfg).to(device)
            session = Interface(cfg).compile(params)
            frames = torch.zeros((2, 3, 4, 256), dtype=torch.bool,
                                 device=device)
            seed = _seed(2, 3, device)
            cur, acc = session.run_batched(
                frames, mask=torch.ones((2, 3), dtype=torch.bool,
                                        device=device),
                stats0=tuple(seed))
            assert not bool(cur.any()), (scheme, noc)
            assert torch.equal(torch.stack(tuple(acc)), seed), (scheme, noc)
            _, st = session.step(frames[0, 0])
            for v in st:
                assert float(v) == 0.0 and not bool(torch.signbit(v)), (
                    scheme, noc)


@pytest.mark.gpu
def test_serve_engine_on_the_card_equals_solo_runs():
    """Two groups (pallas_sparse, pallas) on the card: each tenant bitwise
    its solo run, under the drain and the background pump; B1 once a
    pallas_sparse flush, B3 once and B2 flush_ticks times a pallas flush;
    the chunks copied to the card on the compute stream."""
    from repro_torch.serve import ServeEngine, TenantSpec
    from repro_torch.serve import default_connectivity

    device = _cuda()
    base = InterfaceConfig(cores=4, neurons_per_core=256,
                           cam_entries_per_core=64, scheme="hier_tree")
    cfgs = {impl: dataclasses.replace(base, impl=impl)
            for impl in ("pallas_sparse", "pallas")}
    specs = [TenantSpec(f"t{i}", cfgs[impl], scenario=sc, seed=i)
             for i, (impl, sc) in enumerate([
                 ("pallas_sparse", "hotspot_core"),
                 ("pallas_sparse", "sparse_poisson"),
                 ("pallas", "clustered"), ("pallas", "mixture")])]
    ticks = {"t0": 20, "t1": 9, "t2": 17, "t3": 8}
    for pumped in (False, True):
        engine = ServeEngine(flush_ticks=8, flush_deadline_s=0.0,
                             keep_currents=True, device=device)
        for spec in specs:
            engine.register(spec)
        before = [m.launches for m in (sparse_kernel, hat_kernel,
                                       cam_kernel)]
        if pumped:
            engine.start(poll_interval_s=1e-4)
        for spec in specs:
            engine.submit_scenario(spec.name, ticks[spec.name])
        if pumped:
            engine.stop(drain=True)
        else:
            assert engine.drain() == sum(ticks.values())
        torch.cuda.synchronize()
        grew = [m.launches - b for m, b in zip(
            (sparse_kernel, hat_kernel, cam_kernel), before)]
        flushes = int(engine.registry.counter("serve.flushes").value)
        if not pumped:    # 3 flushes a group: 20 and 17 ticks over 8
            assert flushes == 6 and grew == [3, 3, 24], grew
        assert engine.accounting()["closes"]
        for spec in specs:
            session = Interface(spec.config).compile(
                default_connectivity(spec.config, 0), device=device)
            cur, st = session.run(spec.stream(ticks[spec.name]).to(device))
            assert np.array_equal(engine.currents(spec.name),
                                  cur.cpu().numpy()), spec.name
            assert [float(f) for f in engine.tenant_stats(spec.name)] == [
                float(f) for f in st], spec.name


@pytest.mark.gpu
def test_session_makes_one_launch_per_run():
    device = _cuda()
    plan, params, stream, overflow = _run_case(
        "hier_tree", "multicast_tree", 16, 256, 512, 2, 12, 4, device,
        burst=(3, 8))
    session = Interface(plan.cfg).compile(params)
    xla = Interface(dataclasses.replace(plan.cfg, impl="xla")).compile(params)
    before = sparse_kernel.launches
    cur, st = session.run_batched(stream)
    torch.cuda.synchronize()
    assert sparse_kernel.launches == before + 1
    want_cur, want_st = xla.run_batched(stream)
    assert torch.equal(cur, want_cur)
    for f, (a, b) in enumerate(zip(st, want_st)):
        if f in INT_FIELDS:
            assert torch.equal(a, b), f
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    step_cur, _ = session.step(stream[0, 0])
    assert sparse_kernel.launches == before + 2
    assert torch.equal(step_cur, cur[0, 0])


# ---- cam_search (B2) ----------------------------------------------------------


def _tags(rng, rows, bits, device):
    return cam_ref.pack_bits(torch.from_numpy(
        rng.random((rows, bits)) < 0.5)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("b,e,bits", [(1000, 777, 12), (96, 100, 40),
                                      (256, 384, 70), (33, 5, 200)])
def test_cam_search_kernel_matches_plain_version(b, e, bits):
    device = _cuda()
    rng = np.random.default_rng(b + e)
    t = _tags(rng, e, bits, device)
    q = _tags(rng, b, bits, device)
    q[: min(b, e) // 2] = t[: min(b, e) // 2]           # force matches
    valid = torch.from_numpy(rng.random(e) < 0.9).to(device)
    before = cam_kernel.launches
    got = cam_kernel.cam_search_cuda(q, t, valid)
    torch.cuda.synchronize()
    assert cam_kernel.launches == before + 1
    want = cam_ref.cam_search_ref(q, t, valid)
    assert torch.equal(got, want) and int(want.sum()) > 0
    assert torch.equal(cam_ref.first_match_ref(got),
                       cam_ref.first_match_ref(want))


@pytest.mark.gpu
@pytest.mark.parametrize("b,e,bits,lanes", [(8192, 4096, 12, 1),
                                            (8192, 4096, 12, 3),
                                            (1000, 777, 40, 2),
                                            (64, 3000, 150, 1)])
def test_cam_match_counts_kernel_matches_plain_version(b, e, bits, lanes):
    device = _cuda()
    rng = np.random.default_rng(b * lanes)
    t = _tags(rng, e, bits, device)
    q = torch.cat([t, _tags(rng, b, bits, device)])[:b].contiguous()
    valid = torch.from_numpy(rng.random((lanes, e)) < 0.3).to(device)
    before = cam_kernel.launches
    got = cam_ops.cam_match_counts(q, t, valid, impl="pallas")
    torch.cuda.synchronize()
    assert cam_kernel.launches == before + 1
    want = cam_ref.match_counts_ref(q, t, valid)
    assert torch.equal(got, want) and int(want.sum()) > 0


def _cam_frame(rng, lanes, e, density, device):
    """(lanes, e) valid flags: a density per lane, "one" for a single live
    source."""
    rows = []
    for d in density:
        if d == "one":
            row = np.zeros(e, dtype=bool)
            row[rng.integers(e)] = True
        else:
            row = rng.random(e) < d
        rows.append(row)
    return torch.from_numpy(np.stack(rows)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("density", [(0.0,), ("one",), (0.05,), (0.5,),
                                     (1.0,), (0.05, 0.5, 1.0),
                                     (1.0, 0.0, "one")])
@pytest.mark.parametrize("w", [1, 5])
def test_cam_match_counts_at_every_density(density, w):
    """The interface path's shapes (8192 CAM entries x 4096 sources) with
    no live source, one, a spike frame's 0.05, half, all, and lanes of
    mixed density; W = 5 takes the kernel's runtime-W path."""
    device = _cuda()
    rng = np.random.default_rng(len(density) * 10 + w)
    b, e = 8192, 4096
    t = torch.from_numpy(rng.integers(-4, 4, (e, w), dtype=np.int32)).to(
        device)
    t[:, 0] = torch.arange(e, dtype=torch.int32, device=device)
    q = torch.from_numpy(rng.integers(-4, 4, (b, w), dtype=np.int32)).to(
        device)
    q[: b // 2] = t[torch.from_numpy(rng.integers(0, e, b // 2)).to(device)]
    q[-8:] = 0                              # all-zero query rows
    valid = _cam_frame(rng, len(density), e, density, device)
    before = cam_kernel.launches
    got = cam_kernel.cam_match_counts_cuda(q, t, valid)
    torch.cuda.synchronize()
    assert cam_kernel.launches == before + 1
    want = cam_ref.match_counts_ref(q, t, valid)
    assert torch.equal(got, want)
    if all(d == 0.0 for d in density):
        assert int(want.sum()) == 0
    elif any(d not in (0.0, "one") for d in density):
        assert int(want.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("b,e", [(8192, 4097), (8191, 1023), (65, 5),
                                 (1, 1), (300, 9000)])
def test_cam_match_counts_ragged_edges(b, e):
    """B not a multiple of a block's 64 rows, E not a multiple of a warp's
    32 sources or of a group of four live tags, E above one staged tile."""
    device = _cuda()
    rng = np.random.default_rng(b + e)
    t = _tags(rng, e, 12, device)
    q = torch.cat([t, _tags(rng, b, 12, device)])[:b].contiguous()
    valid = _cam_frame(rng, 2, e, (0.3, 1.0), device)
    got = cam_kernel.cam_match_counts_cuda(q, t, valid)
    want = cam_ref.match_counts_ref(q, t, valid)
    assert torch.equal(got, want) and int(want.sum()) > 0


@pytest.mark.gpu
def test_cam_ops_on_cuda_launch_and_keep_the_block_rule():
    device = _cuda()
    rng = np.random.default_rng(0)
    t = _tags(rng, 256, 44, device)
    q = t[:128].contiguous()
    valid = torch.ones(256, dtype=torch.bool, device=device)
    before = cam_kernel.launches
    first = cam_ops.cam_first_match(q, t, valid, impl="pallas")
    spec = cam_ops.cam_search_speculative(q, t, valid, impl="pallas")
    assert cam_kernel.launches == before + 3
    assert torch.equal(first, cam_ref.first_match_ref(
        cam_ref.cam_search_ref(q, t, valid)))
    assert torch.equal(spec, cam_ref.cam_search_ref(q, t, valid))
    with pytest.raises(ValueError, match="must divide block sizes"):
        cam_ops.cam_search(q, t[:200].contiguous(), valid[:200],
                           impl="pallas")


# ---- hat_encode (B3) ----------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n,row", [(16, 256, 256), (48, 256, 256),
                                        (4, 512, 256), (2, 65536, 256),
                                        (3, 4096, 128), (5, 300, 1)])
@pytest.mark.parametrize("rate", [0.0, 0.05, 0.5, 1.0])
def test_hat_encode_kernel_matches_plain_version(rows, n, row, rate):
    device = _cuda()
    rng = np.random.default_rng(rows + n)
    spikes = torch.from_numpy(rng.random((rows, n)) < rate).to(device)
    before = hat_kernel.tick_launches
    ranks, count, clusters, stream = hat_kernel.hat_encode_cuda(
        spikes, row=row, stream=True)
    torch.cuda.synchronize()
    assert hat_kernel.tick_launches == before + 1
    want = hat_ref.hat_encode_ref(spikes, row=row)
    for g, w in zip((ranks, count, clusters), want):
        assert torch.equal(g, w)
    assert torch.equal(stream, hat_ref.compact_stream(*want[:2]))


@pytest.mark.gpu
def test_hat_ops_on_cuda_launch_once_per_call():
    device = _cuda()
    spikes = torch.rand((2, 16, 256), device=device) < 0.05
    before = hat_kernel.tick_launches
    stream, count = hat_ops.encode_stream(spikes, impl="pallas")
    ranks, _, _ = hat_ops.hat_encode(spikes, impl="pallas")
    assert hat_kernel.tick_launches == before + 2
    want = hat_ref.hat_encode_ref(spikes)
    assert torch.equal(ranks, want[0]) and torch.equal(count, want[1])
    assert torch.equal(stream, hat_ref.compact_stream(*want[:2]))
    with pytest.raises(ValueError, match="N % 256 == 0"):
        hat_ops.hat_encode(spikes[..., :100], impl="pallas")


def _hat_policy(scheme, n, kernel_policy=-1):
    """The scheme's `HatPolicy` bound for the card (``kernel_policy``
    overrides the registered branch)."""
    cfg = arb.ArbiterConfig(scheme, n)
    if kernel_policy == -1:
        kernel_policy = interface_registry.get_arbiter(scheme).kernel_policy
    return hat_ops.bind_run(
        arb.tick_latency_fn(cfg),
        lambda aer: arb.encode_energy_units(scheme, n, aer), kernel_policy,
        cfg.levels, n, "cuda")


def _hat_stream(lanes, ticks, cores, n, rate, seed, device):
    """Bernoulli frames with the AER stream's edges in the last (lane,
    tick): one event at address 0, one at n - 1, an empty core and a full
    core, as many as there are cores."""
    s = np.random.default_rng(seed).random((lanes, ticks, cores, n)) < rate
    last = s[-1, -1]
    last[:4] = False
    last[0, 0] = True
    last[1:2, n - 1] = True
    last[3:4] = True
    return torch.from_numpy(s).to(device)


def _assert_hat_run_equal(stream, policy):
    before = hat_kernel.launches
    got = hat_kernel.hat_run_cuda(stream, policy.args)
    torch.cuda.synchronize()
    assert hat_kernel.launches == before + 1
    want = hat_ref.hat_run_ref(stream, policy.latency_fn, policy.encode_fn)
    for name, g, w in zip(("latency", "energy", "count"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name


@pytest.mark.gpu
@pytest.mark.parametrize("ticks,lanes", [(1, 1), (256, 1), (7, 3)])
@pytest.mark.parametrize("rate", [0.0, 0.05, 0.5, 1.0])
@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_hat_run_kernel_matches_plain_version(scheme, n, rate, ticks, lanes):
    device = _cuda()
    stream = _hat_stream(lanes, ticks, 16, n, rate, n + ticks, device)
    _assert_hat_run_equal(stream, _hat_policy(scheme, n))


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", SCHEMES)
def test_hat_run_kernel_at_65536_neurons(scheme):
    device = _cuda()
    for rate in (0.0, 0.05, 0.5, 1.0):
        stream = _hat_stream(1, 1, 6, 65536, rate, 5, device)
        _assert_hat_run_equal(stream, _hat_policy(scheme, 65536))


@pytest.mark.gpu
def test_hat_run_op_on_cuda_launches_and_never_falls_back():
    device = _cuda()
    stream = _hat_stream(2, 5, 16, 256, 0.05, 1, device)
    policy = _hat_policy("hier_tree", 256)
    before = hat_kernel.launches
    got = hat_ops.hat_run(stream[:, 1:], policy, impl="pallas")
    assert hat_kernel.launches == before + 1
    want = hat_ref.hat_run_ref(stream[:, 1:], policy.latency_fn,
                               policy.encode_fn)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    streams = _hat_policy("hier_tree", 256, kernel_policy=None)
    assert streams.stream_form and streams.args is None
    with pytest.raises(ValueError, match="bound for the CPU"):
        hat_ops.hat_run(stream, policy._replace(args=None), impl="pallas")
    with pytest.raises(RuntimeError, match="cudaError_t"):
        hat_kernel.hat_run_cuda(stream[..., :128].contiguous(),
                                hat_kernel.run_args(4, 128, 4))
    assert hat_kernel.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["hier_ring", "hier_tree"])
def test_hat_run_stream_form_matches_plain_version(scheme):
    """A plan with no whole-run branch, bound as make_plan binds it
    (kernel_policy None; hier_ring at n = 512 has no closed form, so its
    latency is the simulator's): one hat_encode_cuda launch a run writes
    the AER streams, and the terms are the plain version's bit for bit."""
    device = _cuda()
    stream = _hat_stream(2, 9, 16, 512, 0.05, 4, device)
    policy = _hat_policy(scheme, 512, None)
    assert policy.stream_form and policy.args is None
    before = (hat_kernel.launches, hat_kernel.tick_launches)
    got = hat_ops.hat_run(stream, policy, impl="pallas")
    torch.cuda.synchronize()
    assert (hat_kernel.launches, hat_kernel.tick_launches) == (
        before[0], before[1] + 1)
    want = hat_ref.hat_run_ref(stream, policy.latency_fn, policy.encode_fn)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.gpu
def test_pallas_session_at_hier_ring_512_matches_xla():
    """impl="pallas" at hier_ring, 16 x 512: B3's stream form once a run,
    cam_search once a tick, currents bitwise the xla session's."""
    device = _cuda()
    cfg = InterfaceConfig(cores=16, neurons_per_core=512,
                          cam_entries_per_core=512, scheme="hier_ring",
                          noc=NocConfig("multicast_tree"), impl="pallas")
    params = random_connectivity(torch.Generator().manual_seed(5),
                                 cfg).to(device)
    session = Interface(cfg).compile(params)
    assert session.plan.hat.stream_form
    xla = Interface(dataclasses.replace(cfg, impl="xla")).compile(params)
    stream = _hat_stream(1, 12, 16, 512, 0.05, 6, device)[0]
    stream[5] = True
    before = (hat_kernel.launches, hat_kernel.tick_launches)
    cur, st = session.run(stream)
    torch.cuda.synchronize()
    assert (hat_kernel.launches, hat_kernel.tick_launches) == (
        before[0], before[1] + 1)
    want_cur, want_st = xla.run(stream)
    assert torch.equal(cur, want_cur)
    for name, a, b in zip(st._fields, st, want_st):
        if name in ("events", "cam_searches", "noc_hops", "chip_hops"):
            assert torch.equal(a, b), name
        else:
            assert torch.allclose(a, b, rtol=1e-6, atol=0), name
    with pytest.raises(ValueError, match="pallas_sparse' is unsupported"):
        Interface(dataclasses.replace(cfg, impl="pallas_sparse")).compile(
            params)


@pytest.mark.gpu
def test_pallas_session_makes_one_hat_launch_per_run():
    device = _cuda()
    cfg = InterfaceConfig(cores=16, neurons_per_core=256,
                          cam_entries_per_core=512, scheme="hier_tree",
                          noc=NocConfig("multicast_tree"), impl="pallas")
    params = random_connectivity(torch.Generator().manual_seed(3),
                                 cfg).to(device)
    session = Interface(cfg).compile(params)
    xla = Interface(dataclasses.replace(cfg, impl="xla")).compile(params)
    stream = _hat_stream(2, 9, 16, 256, 0.05, 2, device)
    stream[:, 4] = True
    before = (hat_kernel.launches, cam_kernel.launches,
              hat_kernel.tick_launches)
    cur, st = session.run_batched(stream)
    torch.cuda.synchronize()
    assert (hat_kernel.launches, cam_kernel.launches,
            hat_kernel.tick_launches) == (before[0] + 1, before[1] + 9,
                                          before[2])
    want_cur, want_st = xla.run_batched(stream)
    assert torch.equal(cur, want_cur)
    for f, (a, b) in enumerate(zip(st, want_st)):
        if f in INT_FIELDS:
            assert torch.equal(a, b), f
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    session.run(stream[0])
    assert hat_kernel.launches == before[0] + 2
    step_cur, _ = session.step(stream[1, 4])
    assert hat_kernel.launches == before[0] + 3
    assert torch.equal(step_cur, cur[1, 4])


# ---- lif_step (B4) ------------------------------------------------------------


def _lif_state(shape, seed, threshold, device):
    """N(0, 3^2) v and I; a sixty-fourth of the elements land exactly on
    the threshold (v = 0, I = threshold)."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(shape) * 3).astype(np.float32)
    i = (rng.standard_normal(shape) * 3).astype(np.float32)
    at = rng.random(shape) < 1 / 64
    v[at], i[at] = 0.0, np.float32(threshold)
    return torch.from_numpy(v).to(device), torch.from_numpy(i).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(128, 4096), (8, 512), (32, 128),
                                   (3, 5), (1, 4099)])
@pytest.mark.parametrize("decay,threshold,v_reset", [(0.9, 1.0, 0.0),
                                                     (0.7, 0.3, -0.25)])
def test_lif_step_kernel_matches_plain_version(shape, decay, threshold,
                                               v_reset):
    device = _cuda()
    v, i = _lif_state(shape, sum(shape), threshold, device)
    before = lif_kernel.launches
    got = lif_kernel.lif_step_cuda(v, i, decay, threshold, v_reset)
    torch.cuda.synchronize()
    assert lif_kernel.launches == before + 1
    want = lif_ref.lif_step_ref(v, i, decay=decay, threshold=threshold,
                                v_reset=v_reset)
    for g, w in zip(got, want):                    # bitwise
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert 0 < int(got[1].sum()) < got[1].numel()
    # the unaligned scalar path: a view one float past a 16-byte boundary
    flat_v, flat_i = v.reshape(-1)[1:], i.reshape(-1)[1:]
    got = lif_kernel.lif_step_cuda(flat_v, flat_i, decay, threshold, v_reset)
    want = lif_ref.lif_step_ref(flat_v, flat_i, decay=decay,
                                threshold=threshold, v_reset=v_reset)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(128, 4096), (8, 512), (16, 1024),
                                   (8, 4096), (32, 128), (3, 5), (1, 4099)])
@pytest.mark.parametrize("decay,threshold,v_reset", [(0.9, 1.0, 0.0),
                                                     (0.7, 0.3, -0.25)])
def test_lif_step_bfloat16_kernel_matches_plain_version(shape, decay,
                                                        threshold, v_reset):
    device = _cuda()
    v, i = (x.to(torch.bfloat16) for x in _lif_state(shape, sum(shape),
                                                      threshold, device))
    before = lif_kernel.launches
    got = lif_kernel.lif_step_cuda(v, i, decay, threshold, v_reset)
    torch.cuda.synchronize()
    assert lif_kernel.launches == before + 1
    want = lif_ref.lif_step_ref(v, i, decay=decay, threshold=threshold,
                                v_reset=v_reset)
    for g, w in zip(got, want):                    # bitwise
        assert g.dtype == torch.bfloat16
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))
    # the unaligned scalar path: a view one value past a 16-byte boundary
    flat_v, flat_i = v.reshape(-1)[1:], i.reshape(-1)[1:]
    got = lif_kernel.lif_step_cuda(flat_v, flat_i, decay, threshold, v_reset)
    want = lif_ref.lif_step_ref(flat_v, flat_i, decay=decay,
                                threshold=threshold, v_reset=v_reset)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))


@pytest.mark.gpu
def test_lif_ops_on_cuda_launch_and_keep_the_block_rule():
    device = _cuda()
    v, i = _lif_state((16, 1024), 3, 1.0, device)
    before = lif_kernel.launches
    got = lif_ops.lif_step(v, i, decay=0.9, threshold=1.0, impl="pallas")
    assert lif_kernel.launches == before + 1
    want = lif_ops.lif_step(v, i, decay=0.9, threshold=1.0, impl="xla")
    assert lif_kernel.launches == before + 1       # xla: the plain version
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="must divide blocks"):
        lif_ops.lif_step(v[:12], i[:12], decay=0.9, threshold=1.0,
                         impl="pallas")
    with pytest.raises(RuntimeError, match="no backward"):
        lif_kernel.lif_step_cuda(v.requires_grad_(), i, 0.9, 1.0)
    assert lif_kernel.launches == before + 1


# ---- moe_dispatch (B5) --------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("m,e", [(256, 16), (2048, 160), (512, 64),
                                 (4096, 128), (3072, 64), (256, 64),
                                 (1000, 7), (70000, 64),
                                 (4096, moe_kernel.MAX_EXPERTS),
                                 (70000, moe_kernel.MAX_EXPERTS)])
@pytest.mark.parametrize("stream", ["uniform", "one_expert", "padded"])
def test_moe_dispatch_kernel_matches_plain_version(m, e, stream):
    device = _cuda()
    rng = np.random.default_rng(m + e)
    ids = rng.integers(0, e, m).astype(np.int32)
    if stream == "one_expert":
        ids[:] = e - 1
    elif stream == "padded":             # the router's pad, and stray ids
        ids[m // 2:] = e
        ids[::29] = -3
    ids = torch.from_numpy(ids).to(device)
    before = moe_kernel.launches
    got = moe_kernel.dispatch_positions_cuda(ids, e)
    torch.cuda.synchronize()
    assert moe_kernel.launches == before + 1
    want = moe_ref.dispatch_positions_ref(ids, e)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_moe_dispatch_ops_on_cuda_launch_and_keep_the_row_rule():
    device = _cuda()
    ids = torch.randint(0, 64, (3072,), device=device, dtype=torch.int32)
    before = moe_kernel.launches
    got = moe_ops.dispatch_positions(ids, num_experts=64, impl="pallas")
    assert moe_kernel.launches == before + 1
    want = moe_ops.dispatch_positions(ids, num_experts=64, impl="xla")
    assert moe_kernel.launches == before + 1       # xla: the plain version
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="multiple of row=256"):
        moe_ops.dispatch_positions(ids[:300], num_experts=64, impl="pallas")
    with pytest.raises(ValueError, match="must lie in"):
        moe_kernel.dispatch_positions_cuda(ids, 0)
    with pytest.raises(ValueError, match="must lie in"):
        moe_kernel.dispatch_positions_cuda(ids, 20000)
    with pytest.raises(ValueError, match="must lie in"):
        moe_kernel.dispatch_positions_cuda(ids, moe_kernel.MAX_EXPERTS + 1)
    assert moe_kernel.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("m", [256, 3072, 65536, 1_048_576])
@pytest.mark.parametrize("e", [1, 64, 160])
@pytest.mark.parametrize("stream", ["uniform", "only_pad", "one_expert",
                                    "padded"])
def test_moe_dispatch_one_launch_at_every_length(m, e, stream):
    """The served streams' lengths (256, 3072: one block) and longer ones
    (65,536 and 1,048,576: a cluster whose blocks take many rounds each),
    with a stream of only pad ids and one where one expert takes every
    event."""
    device = _cuda()
    rng = np.random.default_rng(m + 7 * e)
    ids = rng.integers(0, e, m).astype(np.int32)
    if stream == "only_pad":
        ids[:] = e
    elif stream == "one_expert":
        ids[:] = rng.integers(e)
    elif stream == "padded":
        ids[m // 3:] = e
        ids[::31] = -1
    ids = torch.from_numpy(ids).to(device)
    before = moe_kernel.launches
    pos, load = moe_kernel.dispatch_positions_cuda(ids, e)
    torch.cuda.synchronize()
    assert moe_kernel.launches == before + 1
    want_pos, want_load = moe_ref.dispatch_positions_ref(ids, e)
    assert torch.equal(pos, want_pos) and torch.equal(load, want_load)
    if stream == "only_pad":
        assert int(pos.abs().sum()) == 0 and int(load.sum()) == 0
    if stream == "one_expert":
        assert torch.equal(pos, torch.arange(m, dtype=torch.int32,
                                             device=device))


# ---- the chip tier and per-core output of B1, the fault drop mask -------------


@pytest.mark.gpu
@pytest.mark.parametrize("chips", [2, 4])
@pytest.mark.parametrize("noc", NOC_SCHEMES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_sparse_run_chip_tier_matches_plain_version(scheme, noc, chips):
    """B1 with the inter-chip tier inside: every stat bitwise, the chip
    fields among them (whole numbers, and float32 products rounded as
    torch rounds them)."""
    device = _cuda()
    case = _run_case(scheme, noc, 8, 16, 32, 3, 7, 13, device, burst=(2,),
                     chips=chips)
    assert case[0].run.kernel.chip_hops is not None
    got, want = _kernel_and_plain(*case)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert float(got[1][:, 9].sum()) > 0, "no inter-chip hop in the run"


@pytest.mark.gpu
@pytest.mark.parametrize("chips", [1, 2, 4])
@pytest.mark.parametrize("noc", NOC_SCHEMES)
def test_sparse_run_chip_tier_at_full_width(noc, chips):
    device = _cuda()
    case = _run_case("hier_tree", noc, 16, 256, 512, 2, 9, 21, device,
                     burst=(0, 4), chips=chips)
    got, want = _kernel_and_plain(*case)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    chip_rows = got[1][:, 9:]
    assert bool((chip_rows == 0).all()) == (chips == 1)


@pytest.mark.gpu
@pytest.mark.parametrize("chips", [1, 4])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_sparse_run_per_core_output_matches_plain_version(scheme, chips):
    """B1's optional per-core output (each core's arbiter latency and
    encode energy x events) equals the plain terms, and the pallas_sparse
    session's "cores" telemetry built on it equals the xla session's."""
    device = _cuda()
    plan, params, stream, overflow = _run_case(
        scheme, "multicast_tree", 8, 16, 32, 2, 6, 17, device, burst=(3,),
        chips=chips)
    got, want = _kernel_and_plain(plan, params, stream, overflow, core=True)
    for g, w in zip(got, want):
        assert torch.equal(g.nan_to_num(-1.0), w.nan_to_num(-1.0))
    cfg = plan.cfg
    sparse = Interface(cfg).compile(params, device=device)
    xla = Interface(dataclasses.replace(cfg, impl="xla")).compile(
        params, device=device)
    a, b = (s.run_batched(stream, telemetry="cores") for s in (sparse, xla))
    assert torch.equal(a[0], b[0])
    for f, g, w in zip(a[2].per_core._fields, a[2].per_core, b[2].per_core):
        assert torch.equal(g, w), f


@pytest.mark.gpu
def test_fault_drop_mask_on_the_card_equals_the_cpu():
    from repro_torch.ft import FaultModel
    device = _cuda()
    fault = FaultModel(dead_cores=(3,), drop_rate=0.1, seed=7)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.random((3, 40, 16, 256)) < 0.3)
    tick0 = torch.tensor([0, 17, 1 << 20])
    lane = torch.arange(3)
    got = fault.apply_spikes(frames.to(device), tick0=tick0.to(device),
                             lane=lane.to(device))
    want = fault.apply_spikes(frames, tick0=tick0, lane=lane)
    assert torch.equal(got.cpu(), want)
    assert 0 < int(want.sum()) < int(frames.sum())


@pytest.mark.gpu
def test_fault_tick0_kept_on_the_card_equals_a_host_offset():
    from repro_torch.ft import FaultModel
    device = _cuda()
    cfg = InterfaceConfig(cores=4, neurons_per_core=64,
                          cam_entries_per_core=32, impl="xla")
    params = random_connectivity(torch.Generator().manual_seed(0), cfg)
    session = Interface(cfg).compile(
        params.to(device), device=device,
        fault=FaultModel(dead_cores=(1,), drop_rate=0.2, seed=3))
    rng = np.random.default_rng(0)
    stream = torch.from_numpy(rng.random((2, 6, 4, 64)) < 0.3).to(device)
    want = session.run_batched(stream, fault_tick0=np.array([5, 9]))
    got = session.run_batched(
        stream, fault_tick0=torch.tensor([5, 9], device=device))
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    one = session.run(stream[0], fault_tick0=torch.tensor(5, device=device))
    assert torch.equal(one[0], want[0][0])


@pytest.mark.gpu
def test_arbiter_simulates_on_the_card_by_default():
    _cuda()
    sim = arb.Arbiter(arb.ArbiterConfig("hier_tree", 64))
    assert sim.device.type == "cuda"
    burst = sim.burst_latency()
    assert burst.device.type == "cuda"
    cpu = arb.Arbiter(arb.ArbiterConfig("hier_tree", 64), device="cpu")
    assert float(burst) == float(cpu.burst_latency())
    req = np.full((3, 64), np.inf, np.float32)
    req[:, :5] = np.arange(5)
    got = sim.simulate(req)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), cpu.simulate(req))
