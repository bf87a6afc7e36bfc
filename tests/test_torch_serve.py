"""The PyTorch port's serving tier and masked sessions against the JAX package.

Masked, ragged and chunked (`stats0`) `run_batched` of the port's
session, under impl="xla", "pallas" and "pallas_sparse", on a sample of
the 5 x 3 arbiter x NoC grid at `tests/conformance/paths.small_config`
(4 x 16 x 32): against the JAX package's masked `run_batched` on the same
numpy params and frames (currents bitwise, stats under the conformance
contract: `EXACT_FIELDS` exact, the rest within `REL_TOL`), and against
the port's own solo `run` (bitwise).  An all-False frame gives exact
zeros on every scheme and impl.

`repro_torch.serve`: the queue triggers, admission bounds, token bucket
and health transitions with the expected values of `tests/test_serve.py`;
two tenants served by the port's engine and by the JAX engine on the same
frames and params; the engine against its own solo runs, the background
pump, autoscale, chaos retries, quarantine and shedding (injected clocks,
no sleeps), and the surfaces it still refuses.
"""

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fabric
from repro.interface import Interface as JInterface
from repro.serve import ServeEngine as JServeEngine
from repro.serve import TenantSpec as JTenantSpec
from repro_torch.ft import (
    ChaosInjector,
    FaultEvent,
    FaultModel,
    FaultPlan,
    RetriesExhaustedError,
    TransientFaultError,
)
from repro_torch.interface import Interface, StepStats
from repro_torch.interface import config as tconfig
from repro_torch.interface.session import CompositionError
from repro_torch.interface.types import params_from_numpy
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import report as obs_report
from repro_torch.serve import (
    AdmissionController,
    AdmissionError,
    AdmissionPolicy,
    AutoscalePolicy,
    DeadlineExceededError,
    FrameValidationError,
    HealthPolicy,
    HealthTracker,
    IngestQueue,
    LaneState,
    QueueOverflowError,
    RateLimitedError,
    RetryPolicy,
    ServeEngine,
    ServeError,
    TenantSpec,
    TokenBucket,
    compat_key,
    default_connectivity,
    group_key,
)
from tests.conformance import paths

TICKS = 6
IMPLS = ("xla", "pallas", "pallas_sparse")
# every arbiter scheme and every NoC scheme at least twice
SAMPLED_GRID = (("binary_tree", "broadcast"), ("greedy_tree", "unicast"),
                ("token_ring", "multicast_tree"), ("hier_ring", "broadcast"),
                ("hier_tree", "unicast"), ("hier_tree", "multicast_tree"))


def _cfg(arb="binary_tree", noc="multicast_tree", impl="xla", **shape):
    return dataclasses.replace(paths.small_config(arb, noc, **shape),
                               impl=impl)


def _both(jcfg, seed=3):
    """The JAX session and the port's, on the JAX package's params."""
    jparams = fabric.random_connectivity(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(*(np.asarray(x) for x in jparams),
                                device="cpu")
    tcfg = tconfig.as_interface_config(jcfg)
    return (JInterface(jcfg).compile(jparams),
            Interface(tcfg).compile(tparams, device="cpu"), tcfg, tparams)


def _frames(seed, lead, ticks=TICKS, cores=4, n=16, p=0.2):
    """Sparse frames, a full burst at tick 2 and a core past the
    capacity (8) at tick 4 of lane 0: both pallas_sparse branches."""
    rng = np.random.default_rng(seed)
    s = rng.random(lead + (ticks, cores, n)) < p
    s[(0,) * len(lead) + (2,)] = True
    s[(0,) * len(lead) + (4, 1, slice(0, 12))] = True
    return s


def _ragged_mask(lengths, ticks=TICKS):
    mask = np.zeros((len(lengths), ticks), bool)
    for lane, t in enumerate(lengths):
        mask[lane, :t] = True
    return mask


def _assert_conformant(st, jst, label):
    """Port stats against JAX stats: the conformance contract."""
    for field in StepStats._fields:
        a = np.asarray(getattr(st, field))
        b = np.asarray(getattr(jst, field))
        assert a.shape == b.shape, (label, field)
        if field in paths.EXACT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f"{label}: {field}")
        else:
            np.testing.assert_allclose(a, b, rtol=paths.REL_TOL, atol=0,
                                       err_msg=f"{label}: {field}")


def _assert_bitwise(st, want, label):
    for field in StepStats._fields:
        a, b = np.asarray(getattr(st, field)), np.asarray(getattr(want, field))
        assert np.array_equal(a, b), f"{label}: {field} {a} != {b}"


def _lane(stats, lane):
    return StepStats(*(f[lane] for f in stats))


# ---- masked / ragged / chunked run_batched -----------------------------------


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arb,noc", SAMPLED_GRID)
def test_masked_ragged_run_batched_matches_jax_and_solo(arb, noc, impl):
    jsession, session, _, _ = _both(_cfg(arb, noc, impl))
    lengths = (TICKS, TICKS // 2, 0)      # full, ragged, all padding
    spikes = _frames(1, (len(lengths),))
    mask = _ragged_mask(lengths)
    cur, st = session.run_batched(spikes, mask=mask)
    jcur, jst = jsession.run_batched(jnp.asarray(spikes),
                                     mask=jnp.asarray(mask))
    label = f"{arb}/{noc}/{impl}"
    np.testing.assert_array_equal(cur.numpy(), np.asarray(jcur),
                                  err_msg=f"{label}: currents")
    _assert_conformant(st, jst, label)
    for lane, t in enumerate(lengths):
        if t == 0:
            _assert_bitwise(_lane(st, lane), StepStats.zeros(), label)
            assert not bool(cur[lane].any()), f"{label}: currents leaked"
            continue
        solo_cur, solo = session.run(spikes[lane, :t])
        assert torch.equal(cur[lane, :t], solo_cur), f"{label} lane {lane}"
        assert not bool(cur[lane, t:].any())
        _assert_bitwise(_lane(st, lane), solo, f"{label} lane {lane}")


@pytest.mark.parametrize("impl", IMPLS)
def test_stats0_chunked_equals_one_run(impl):
    """A stream served in chunks, each seeded by the previous chunk's
    stats, sums bit for bit as one uninterrupted run; the JAX chunked
    carry agrees under the conformance contract."""
    jsession, session, _, _ = _both(_cfg("greedy_tree", "unicast", impl))
    spikes = _frames(2, (2,), ticks=8)
    full = np.ones((2, 8), bool)
    cur_full, acc_full = session.run_batched(spikes, mask=full)
    acc = jacc = None
    parts = []
    for lo in (0, 3, 5):
        hi = {0: 3, 3: 5, 5: 8}[lo]
        cur, acc = session.run_batched(spikes[:, lo:hi], mask=full[:, lo:hi],
                                       stats0=acc)
        _, jacc = jsession.run_batched(jnp.asarray(spikes[:, lo:hi]),
                                       mask=jnp.asarray(full[:, lo:hi]),
                                       stats0=jacc)
        parts.append(cur)
    assert torch.equal(torch.cat(parts, 1), cur_full)
    _assert_bitwise(acc, acc_full, f"{impl} chunked")
    _assert_conformant(acc, jacc, f"{impl} chunked vs JAX")
    solo_cur, solo = session.run(spikes[1])
    _assert_bitwise(_lane(acc, 1), solo, f"{impl} chunked vs solo")


@pytest.mark.parametrize("impl", IMPLS)
def test_masked_solo_run_matches_truncated_and_seed(impl):
    session = _both(_cfg("binary_tree", "multicast_tree", impl))[1]
    spikes = _frames(4, ())
    mask = np.arange(TICKS) < 4
    cur_m, acc_m = session.run(spikes, mask=mask)
    cur_t, acc_t = session.run(spikes[:4])
    assert torch.equal(cur_m[:4], cur_t) and not bool(cur_m[4:].any())
    _assert_bitwise(acc_m, acc_t, "masked solo vs truncated")
    # a seeded solo run over the rest continues the truncated one's sums
    rest = np.arange(TICKS) >= 4
    _, acc_s = session.run(spikes & rest[:, None, None], mask=rest,
                           stats0=acc_t)
    _, acc_one = session.run(spikes)
    _assert_bitwise(acc_s, acc_one, "seeded solo vs one run")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("noc", paths.NOC_SCHEMES)
@pytest.mark.parametrize("arb", paths.ARBITER_SCHEMES)
def test_all_false_frame_gives_exact_zeros(arb, noc, impl):
    """An all-False tick contributes exactly +0.0 to every stat and every
    current (no NaN, no -0.0), so a lane at rest keeps its seed."""
    cfg = tconfig.as_interface_config(_cfg(arb, noc, impl))
    params = default_connectivity(cfg, 0)
    session = Interface(cfg).compile(params, device="cpu")
    cur, st = session.step(torch.zeros((4, 16), dtype=torch.bool))
    assert not bool(cur.any()) and not bool(torch.signbit(cur).any())
    for field in StepStats._fields:
        v = getattr(st, field)
        assert float(v) == 0.0 and not bool(torch.signbit(v)), field
    seed = StepStats(*(torch.tensor([1.5, 7.0]) for _ in StepStats._fields))
    _, acc = session.run_batched(np.zeros((2, 3, 4, 16), bool),
                                 mask=np.ones((2, 3), bool), stats0=seed)
    _assert_bitwise(acc, seed, f"{arb}/{noc}/{impl} lanes at rest")


def test_mask_and_stats0_validation():
    session = _both(_cfg("binary_tree", "broadcast"))[1]
    spikes = _frames(5, (2,))
    good = np.ones((2, TICKS), bool)
    with pytest.raises(ValueError, match="mask"):
        session.run_batched(spikes, mask=np.ones((2, TICKS + 1), bool))
    with pytest.raises(ValueError, match="stats0"):
        session.run(spikes[0], stats0=StepStats.zeros())
    with pytest.raises(ValueError, match="stats0"):
        session.run_batched(spikes, stats0=StepStats.zeros((2,)))
    with pytest.raises(ValueError, match="stats0"):
        session.run_batched(spikes, mask=good, stats0=StepStats.zeros((3,)))
    with pytest.raises(ValueError, match="shard"):
        session.run_batched(spikes, mask=good, shard="dies")
    with pytest.raises(CompositionError, match="telemetry"):
        session.run_batched(spikes, mask=good, telemetry="ticks")
    # a one-chip session's shard="chips" is its flat masked run
    flat = session.run_batched(spikes, mask=good)
    sharded = session.run_batched(spikes, mask=good, shard="chips")
    assert torch.equal(flat[0], sharded[0])
    # a float mask counts > 0 as live, like the JAX package's
    cur, _ = session.run_batched(spikes, mask=good.astype(np.float32))
    assert torch.equal(cur, session.run_batched(spikes, mask=good)[0])


# ---- queue, admission, token bucket, health, autoscale ----------------------


class _FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _zeros(n, cfg):
    return np.zeros((n, cfg.cores, cfg.neurons_per_core), bool)


def test_queue_size_and_deadline_triggers():
    cfg = _cfg()
    q = IngestQueue(flush_frames=8, flush_deadline_s=60.0, clock=_FakeClock())
    q.submit("a", _zeros(5, cfg))
    assert not q.ready() and q.poll() == []
    q.submit("b", _zeros(3, cfg))  # 8 frames total: size trigger fires
    assert q.ready() and q.pending_frames() == 8
    assert q.pending_by_tenant() == {"a": 5, "b": 3}
    assert [r.tenant for r in q.poll()] == ["a", "b"]
    assert q.depth() == 0 and q.pending_frames() == 0
    clock = _FakeClock()
    q = IngestQueue(flush_frames=100, flush_deadline_s=0.5, clock=clock,
                    max_pending_frames=4)
    q.submit("a", _zeros(2, cfg))
    clock.now = 0.4
    assert not q.ready()
    clock.now = 0.5  # oldest request hits its latency deadline
    assert q.ready() and len(q.poll()) == 1
    q.submit("b", _zeros(1, cfg))
    assert len(q.poll(force=True)) == 1  # drain semantics ignore triggers
    with pytest.raises(ValueError, match="frames"):
        q.submit("c", _zeros(0, cfg))
    q.submit("c", _zeros(3, cfg))
    with pytest.raises(QueueOverflowError, match="max_pending_frames"):
        q.submit("c", _zeros(2, cfg))


def test_admission_bounds():
    cfg = tconfig.as_interface_config(_cfg())
    ctrl = AdmissionController(AdmissionPolicy(max_tenants_per_group=2,
                                               max_groups=1))
    spec = TenantSpec("t0", cfg)
    key = ctrl.admit(spec, {})
    assert key == compat_key(spec) == group_key(spec)
    with pytest.raises(AdmissionError, match="capacity"):
        ctrl.admit(spec, {key: 2})
    other = TenantSpec("t1", cfg, connectivity_seed=9)  # needs a new group
    with pytest.raises(AdmissionError, match="max_groups"):
        ctrl.admit(other, {key: 1})
    with pytest.raises(AdmissionError, match="max_frames_per_request"):
        ctrl.validate_request("t0", 5000)
    with pytest.raises(QueueOverflowError):
        AdmissionController(AdmissionPolicy(max_pending_frames=4)
                            ).validate_request("t0", 3, pending_frames=2)
    with pytest.raises(ValueError, match=">= 1"):
        AdmissionPolicy(max_groups=0)
    assert issubclass(FrameValidationError, ValueError)
    assert issubclass(DeadlineExceededError, AdmissionError)
    assert issubclass(AdmissionError, ServeError)


def test_token_bucket_semantics():
    clock = _FakeClock()
    bucket = TokenBucket(rate=10.0, capacity=5.0, clock=clock)
    assert bucket.take(5) and not bucket.take(1)  # starts full; all-or-nothing
    clock.now += 0.25
    assert bucket.tokens() == pytest.approx(2.5)
    assert not bucket.take(3) and bucket.take(2.5)
    clock.now += 100.0
    assert bucket.tokens() == pytest.approx(5.0)  # capped at capacity
    with pytest.raises(ValueError, match="rate"):
        TokenBucket(rate=0.0, capacity=5.0)
    with pytest.raises(ValueError, match="burst"):
        AdmissionPolicy(rate_limit_burst=4.0)  # burst without a rate


def test_health_transitions():
    clock = _FakeClock()
    registry = obs_metrics.MetricsRegistry()
    health = HealthTracker(HealthPolicy(quarantine_after=2,
                                        quarantine_rounds=2,
                                        recover_after=1),
                           registry=registry, clock=clock)
    health.add("t")
    assert health.record_failure("t") is LaneState.DEGRADED
    assert health.usable("t")
    assert health.record_failure("t") is LaneState.QUARANTINED
    assert not health.usable("t") and health.quarantined() == {"t"}
    assert health.record_success("t") is LaneState.QUARANTINED  # masked
    health.advance()
    assert health.state("t") is LaneState.QUARANTINED
    health.advance()  # cooldown over: probation
    assert health.state("t") is LaneState.DEGRADED
    clock.now = 2.5
    assert health.record_success("t") is LaneState.HEALTHY
    assert health.snapshot() == {"t": "healthy"}
    counts = {k: c.value for k, c in registry.counters.items()}
    assert counts == {"serve.degraded": 1, "serve.quarantines": 1,
                      "serve.probes": 1, "serve.recoveries": 1}
    assert registry.histograms["serve.recovery_ms"].total == 2500.0
    health.remove("t")
    assert health.snapshot() == {}
    with pytest.raises(ValueError, match="max_retries"):
        RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError, match="quarantine_after"):
        HealthPolicy(quarantine_after=0)


def test_autoscale_policy_targets():
    exact = AutoscalePolicy()
    assert exact.target(3, 8) == 3 and exact.target(0, 0) == 1
    geo = AutoscalePolicy(grow_factor=2.0, shrink_at=0.5)
    assert geo.target(3, 2) == 4 and geo.target(5, 4) == 8
    assert geo.target(3, 8) == 4  # 3 > 4 * 0.5: hysteresis holds at 4
    assert geo.target(2, 8) == 2  # 2 <= 4 * 0.5: shrinks through to the floor
    assert AutoscalePolicy(min_lanes=4).target(1, 0) == 4
    with pytest.raises(ValueError, match="grow_factor"):
        AutoscalePolicy(grow_factor=0.5)
    with pytest.raises(ValueError, match="shrink_at"):
        AutoscalePolicy(shrink_at=0.0)


def test_tenant_spec_validation_streams_and_refusals():
    cfg = tconfig.as_interface_config(_cfg())
    with pytest.raises(ValueError, match="non-empty"):
        TenantSpec("", cfg)
    with pytest.raises(ValueError, match="unknown scenario parameter"):
        TenantSpec("t", cfg, scenario_params={"nope": 1})
    with pytest.raises(KeyError):
        TenantSpec("t", cfg, scenario="nope")
    spec = TenantSpec("t", cfg, scenario="sparse_poisson", seed=5)
    a, b = spec.stream(4, round=0), spec.stream(4, round=0)
    assert torch.equal(a, b), "streams must be deterministic"
    assert a.shape == (4, 4, 16) and a.dtype == torch.bool
    assert not torch.equal(a, spec.stream(4, round=1)), "rounds draw fresh"
    assert 0.0 < spec.expected_rate() < 1.0
    with pytest.raises(CompositionError, match="one-chip"):
        TenantSpec("bad", cfg, shard="chips")
    with pytest.raises(ValueError, match="unknown shard"):
        TenantSpec("bad", cfg, shard="dies")
    two = TenantSpec("two", dataclasses.replace(cfg, chips=2), shard="chips")
    assert two.shard == "chips" and compat_key(two)[-1] == "chips"
    with pytest.raises(ValueError, match="FaultModel"):
        TenantSpec("bad", cfg, fault=object())
    faulted = TenantSpec("f", cfg, fault=FaultModel(dead_cores=(0,)))
    assert compat_key(faulted) != compat_key(spec)


# ---- the engine ---------------------------------------------------------------


def _engine(cfg, scenarios, **kw):
    kw.setdefault("flush_ticks", 4)
    kw.setdefault("flush_deadline_s", 0.0)
    kw.setdefault("device", "cpu")
    engine = ServeEngine(**kw)
    specs = [TenantSpec(f"t{i}", cfg, scenario=sc, seed=i)
             for i, sc in enumerate(scenarios)]
    for spec in specs:
        engine.register(spec)
    return engine, specs


def _solo(cfg):
    return Interface(cfg).compile(default_connectivity(cfg, 0), device="cpu")


def _assert_solo(engine, spec, stream, session, label=""):
    cur, acc = session.run(stream)
    assert np.array_equal(engine.currents(spec.name), cur.numpy()), \
        f"{label}{spec.name}: currents"
    _assert_bitwise(engine.tenant_stats(spec.name), acc,
                    f"{label}{spec.name}")


@pytest.mark.parametrize("impl", IMPLS)
def test_engine_matches_the_jax_engine(impl):
    """Two tenants on the same frames and params through both engines:
    per-tenant currents bitwise, stats under the conformance contract."""
    jcfg = _cfg("hier_tree", "multicast_tree", impl)
    jparams = fabric.random_connectivity(jax.random.PRNGKey(7), jcfg)
    tcfg = tconfig.as_interface_config(jcfg)
    jeng = JServeEngine(flush_ticks=4, flush_deadline_s=0.0,
                        keep_currents=True)
    teng = ServeEngine(flush_ticks=4, flush_deadline_s=0.0,
                       keep_currents=True, device="cpu")
    jeng.register(JTenantSpec("a", jcfg), params=jparams)
    jeng.register(JTenantSpec("b", jcfg))
    teng.register(TenantSpec("a", tcfg), params=params_from_numpy(
        *(np.asarray(x) for x in jparams), device="cpu"))
    teng.register(TenantSpec("b", tcfg))
    streams = {"a": _frames(8, (), ticks=7), "b": _frames(9, (), ticks=5)}
    for engine in (jeng, teng):
        for name, frames in streams.items():
            engine.submit(name, frames)
        assert engine.drain() == 12
    for name in streams:
        np.testing.assert_array_equal(teng.currents(name),
                                      jeng.currents(name), err_msg=name)
        _assert_conformant(teng.tenant_stats(name), jeng.tenant_stats(name),
                           name)
        assert teng.ticks_served(name) == jeng.ticks_served(name)
    assert teng.accounting() == jeng.accounting()


@pytest.mark.parametrize("impl", IMPLS)
def test_engine_serves_bit_identical_to_solo(impl):
    cfg = tconfig.as_interface_config(_cfg("binary_tree", "multicast_tree",
                                           impl))
    engine, specs = _engine(
        cfg, ["sparse_poisson", "hotspot_core", "synchronized_burst"],
        keep_currents=True)
    assert len(engine.groups) == 1, "same (config, connectivity) share one"
    ticks = (7, 4, 9)  # ragged across tenants, none a flush multiple
    for spec, t in zip(specs, ticks):
        engine.submit_scenario(spec.name, t)
    assert engine.drain() == sum(ticks)
    session = _solo(cfg)
    for spec, t in zip(specs, ticks):
        _assert_solo(engine, spec, spec.stream(t, round=0), session)
        assert engine.ticks_served(spec.name) == t
    group = next(iter(engine.groups.values()))
    assert group.jit_cache_entries() == 1
    assert engine.accounting()["closes"]


def test_engine_report_records_metrics_and_report_cli(tmp_path, capsys):
    cfg = tconfig.as_interface_config(_cfg("binary_tree", "broadcast"))
    path = tmp_path / "serve.jsonl"
    sink = obs_metrics.JsonlSink(str(path))
    engine, specs = _engine(cfg, ["sparse_poisson", "mixture"], sink=sink)
    for spec in specs:
        engine.submit_scenario(spec.name, 6)
    engine.drain()
    records = engine.emit_report()
    sink.close()
    assert [r["tenant"] for r in records] == ["t0", "t1", "__fleet__"]
    for rec in records[:-1]:
        assert rec["ticks"] == 6
        assert {"tick_ms_p50", "tick_ms_p95", "tick_ms_p99",
                "stats_per_tick"} <= set(rec)
        assert rec["stats_per_tick"]["events"] > 0
    fleet = records[-1]
    assert fleet["tenants"] == 2 and fleet["ticks"] == 12
    assert fleet["events_per_sec"] > 0
    assert fleet["tick_ms_p99"] >= fleet["tick_ms_p50"] > 0
    assert engine.registry.counter("serve.ticks").value == 12
    snapshot = engine.registry.snapshot()
    assert "tenant.t0.tick_ms" in snapshot and "serve.queue_depth" in snapshot
    assert "serve.step_ms" in snapshot          # the watchdog's histogram
    loaded = obs_report.load_records(str(path))
    assert json.loads(json.dumps(records)) == loaded
    assert obs_report.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "sparse_poisson" in out and "arbiter" in out


def test_engine_grouping_and_errors():
    cfg_a = tconfig.as_interface_config(_cfg("binary_tree", "broadcast"))
    cfg_b = tconfig.as_interface_config(_cfg("binary_tree", "broadcast",
                                             cores=8))
    engine = ServeEngine(flush_ticks=4, policy=AdmissionPolicy(max_groups=2),
                         device="cpu")
    engine.register(TenantSpec("a0", cfg_a))
    engine.register(TenantSpec("b0", cfg_b))  # incompatible shape: new group
    assert len(engine.groups) == 2
    with pytest.raises(ValueError, match="already registered"):
        engine.register(TenantSpec("a0", cfg_a))
    with pytest.raises(ValueError, match="conflict"):
        engine.register(TenantSpec("a1", cfg_a),
                        params=default_connectivity(cfg_a, 0))
    with pytest.raises(KeyError, match="unknown tenant"):
        engine.submit("ghost", _zeros(1, cfg_a))
    with pytest.raises(ValueError, match="do not match"):
        engine.submit("a0", _zeros(1, cfg_b))
    with pytest.raises(FrameValidationError, match="non-finite"):
        engine.submit("a0", np.full((1, 4, 16), np.nan, np.float32))
    with pytest.raises(ValueError, match="keep_currents"):
        engine.currents("a0")
    with pytest.raises(ValueError, match="flush_ticks"):
        ServeEngine(flush_ticks=0, device="cpu")


def test_engine_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine()


def test_engine_deadline_holds_partial_batches():
    cfg = tconfig.as_interface_config(_cfg("binary_tree", "broadcast"))
    clock = _FakeClock()
    engine = ServeEngine(flush_ticks=8, flush_deadline_s=1.0, clock=clock,
                         device="cpu")
    engine.register(TenantSpec("t0", cfg))
    engine.submit_scenario("t0", 3)  # 3 < 8 frames and inside the deadline
    assert engine.pump() == 0 and engine.queue_depth() == 1
    clock.now = 1.0
    assert engine.pump() == 3  # deadline trigger fires the partial flush
    engine.submit_scenario("t0", 2)
    clock.now = 1.5
    assert engine.drain() == 2  # force path ignores triggers entirely


def _await_drained(engine, names, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while True:
        acct = engine.accounting()
        if all(acct["tenants"][n]["pending"] == 0 for n in names):
            return
        assert time.monotonic() < deadline, f"pump never drained: {acct}"
        time.sleep(0.002)


def test_background_pump_serves_bit_identical_to_solo():
    cfg = tconfig.as_interface_config(_cfg("binary_tree", "broadcast",
                                           "pallas_sparse"))
    engine, specs = _engine(cfg, ["sparse_poisson", "hotspot_core"],
                            keep_currents=True)
    streams = {s.name: s.stream(9, round=0).numpy() for s in specs}
    engine.start(poll_interval_s=0.001)
    assert engine.running
    for name, frames in streams.items():
        engine.submit(name, frames)
    _await_drained(engine, streams)
    engine.stop(drain=True)
    assert not engine.running and engine.pump_errors() == []
    assert engine.accounting()["closes"]
    session = _solo(cfg)
    for spec in specs:
        _assert_solo(engine, spec, streams[spec.name], session, "async ")
    with engine:          # restartable: the context manager runs a burst
        engine.submit_scenario("t0", 5)
        _await_drained(engine, ["t0"])
    assert engine.ticks_served("t0") == 14
    with pytest.raises(ValueError, match="poll_interval_s"):
        engine.start(poll_interval_s=0)


def test_pump_fatal_error_surfaces_and_retries_exhausted_survive(
        monkeypatch):
    cfg = tconfig.as_interface_config(_cfg("binary_tree", "broadcast"))
    engine, _ = _engine(cfg, ["sparse_poisson"])

    def boom(force=False):
        raise RuntimeError("pump exploded")

    monkeypatch.setattr(engine, "pump", boom)
    engine.start(poll_interval_s=0.001)
    deadline = time.monotonic() + 30
    while engine.running:
        assert time.monotonic() < deadline
        time.sleep(0.002)
    with pytest.raises(ServeError, match="pump exploded"):
        engine.submit_scenario("t0", 2)
    assert engine.registry.counter("serve.pump.fatal").value == 1
    engine.stop()  # fatal already surfaced; stop is a clean no-op join

    engine, _ = _engine(cfg, ["sparse_poisson"])
    real_pump, tripped = engine.pump, []

    def flaky(force=False):
        if not tripped:
            tripped.append(1)
            raise RetriesExhaustedError("transfer still failing")
        return real_pump(force=force)

    monkeypatch.setattr(engine, "pump", flaky)
    engine.start(poll_interval_s=0.001)
    engine.submit_scenario("t0", 6)
    _await_drained(engine, ["t0"])
    engine.stop(drain=True)
    errors = engine.pump_errors()
    assert len(errors) == 1 and isinstance(errors[0], RetriesExhaustedError)
    assert engine.ticks_served("t0") == 6 and engine.accounting()["closes"]


def test_autoscale_grow_shrink_preserves_solo_bit_identity():
    cfg = tconfig.as_interface_config(_cfg("binary_tree", "multicast_tree",
                                           "pallas_sparse"))
    engine = ServeEngine(flush_ticks=4, flush_deadline_s=0.0,
                         keep_currents=True, device="cpu")
    engine.register(TenantSpec("t0", cfg, scenario="sparse_poisson", seed=0))
    engine.submit_scenario("t0", 6)
    assert engine.drain() == 6
    engine.register(TenantSpec("t1", cfg, scenario="hotspot_core", seed=1))
    group = engine._tenant_group["t0"]
    assert group.capacity == 2 and group.capacities_seen == {1, 2}
    engine.submit_scenario("t0", 5)
    engine.submit_scenario("t1", 7)
    assert engine.drain() == 12
    assert engine.accounting()["closes"]
    engine.submit_scenario("t1", 3)
    with pytest.raises(ServeError, match="pending"):
        engine.deregister("t1")  # a lane with queued work cannot retire
    assert engine.drain() == 3
    spec0 = group.specs["t0"]
    engine.deregister("t1")
    assert group.capacity == 1 and "t1" not in group.lanes
    engine.submit_scenario("t0", 4)
    assert engine.drain() == 4
    full = torch.cat([spec0.stream(t, round=r)
                      for r, t in enumerate((6, 5, 4))])
    _assert_solo(engine, spec0, full, _solo(cfg), "across resizes ")
    acct = engine.accounting()
    assert acct["closes"] and acct["tenants"]["t1"]["pending"] == 0
    assert engine.registry.counter("serve.autoscale.grow").value == 2
    assert engine.registry.counter("serve.autoscale.shrink").value == 1
    assert engine.serve_report()[-1]["lane_capacity"] == 1
    assert group.jit_cache_entries() <= len(group.capacities_seen)


def test_removed_lane_moves_its_mover_row_and_reuses_slots():
    """Swap-with-last: the last tenant takes the freed lane with its
    accumulator row; a tenant joining a freed slot starts from zero."""
    cfg = tconfig.as_interface_config(_cfg())
    engine, specs = _engine(cfg, ["sparse_poisson", "clustered", "dvs_trace"],
                            autoscale=AutoscalePolicy(min_lanes=3))
    for spec in specs:
        engine.submit_scenario(spec.name, 5)
    engine.drain()
    before = engine.tenant_stats("t2")
    engine.deregister("t0")
    group = engine._tenant_group["t2"]
    assert group.lanes == {"t1": 1, "t2": 0} and group.capacity == 3
    _assert_bitwise(engine.tenant_stats("t2"), before, "mover row")
    engine.register(TenantSpec("t3", cfg))
    assert group.lanes["t3"] == 2
    assert all(float(f) == 0.0 for f in engine.tenant_stats("t3"))
    assert group.lane_names() == ["t2", "t1", "t3"]


def test_retried_faults_stay_bit_identical_to_calm_engine():
    cfg = tconfig.as_interface_config(_cfg("binary_tree", "multicast_tree",
                                           "pallas_sparse"))
    plan = FaultPlan(events=(
        FaultEvent(round=1, kind="transfer_fail", times=2),
        FaultEvent(round=2, kind="execute_fail", times=2),
        FaultEvent(round=2, kind="slow_device", times=1, delay_s=0.0)))
    scen = ["sparse_poisson", "hotspot_core"]
    chaotic, specs = _engine(cfg, scen, flush_ticks=8, keep_currents=True,
                             chaos=ChaosInjector(plan, sleep=lambda s: None),
                             retry=RetryPolicy(max_retries=3,
                                               backoff_base_s=0.0),
                             sleep=lambda s: None)
    calm, _ = _engine(cfg, scen, flush_ticks=8, keep_currents=True)
    for _ in range(3):
        for engine in (chaotic, calm):
            for spec in specs:
                engine.submit_scenario(spec.name, 8)
            engine.pump(force=True)
    assert chaotic.chaos.exhausted()
    assert chaotic.registry.counter("serve.retries").value == 4
    assert chaotic.registry.counter("serve.retry_recoveries").value == 2
    for spec in specs:
        assert np.array_equal(chaotic.currents(spec.name),
                              calm.currents(spec.name)), spec.name
        _assert_bitwise(chaotic.tenant_stats(spec.name),
                        calm.tenant_stats(spec.name), spec.name)
    assert chaotic.accounting()["closes"]


def test_retries_exhausted_restages_then_recovers():
    cfg = tconfig.as_interface_config(_cfg("binary_tree", "broadcast"))
    plan = FaultPlan(events=(FaultEvent(round=1, kind="transfer_fail",
                                        times=6),))
    engine = ServeEngine(flush_ticks=8, flush_deadline_s=0.0,
                         chaos=ChaosInjector(plan, sleep=lambda s: None),
                         retry=RetryPolicy(max_retries=1, backoff_base_s=0.0),
                         sleep=lambda s: None, device="cpu")
    engine.register(TenantSpec("t0", cfg))
    engine.submit("t0", np.ones((8, 4, 16), bool))
    hard = 0
    while True:  # 6 charges / 2 attempts per pump: fails thrice, then heals
        try:
            engine.drain()
            break
        except RetriesExhaustedError:
            hard += 1
            acct = engine.accounting()
            assert acct["closes"], "ledger must close at every failure point"
            assert acct["tenants"]["t0"]["pending"] == 8, "work restaged"
    assert hard == 3 and engine.chaos.exhausted()
    assert engine.ticks_served("t0") == 8
    assert engine.registry.counter("serve.retries_exhausted").value == 3
    assert engine.accounting()["closes"]


def test_retry_recovery_clock_starts_at_first_attempt():
    clock = _FakeClock()
    engine = ServeEngine(flush_ticks=4, clock=clock, sleep=lambda s: None,
                         device="cpu")
    tripped = []

    def flaky():
        if not tripped:
            tripped.append(1)
            clock.now += 2.0  # the failing attempt itself takes 2s
            raise TransientFaultError("transient")
        clock.now += 1.0
        return "ok"

    assert engine._with_retries("execute", flaky) == "ok"
    hist = engine.registry.histograms["serve.recovery_ms"]
    assert hist.count == 1 and hist.total == pytest.approx(3000.0)


def test_quarantine_masks_lane_without_new_shapes_then_recovers():
    cfg = tconfig.as_interface_config(_cfg("binary_tree", "multicast_tree"))
    plan = FaultPlan(events=(FaultEvent(round=1, kind="lane_fault",
                                        tenant="t1", times=2),))
    engine, specs = _engine(
        cfg, ["sparse_poisson", "hotspot_core", "mixture"], flush_ticks=8,
        chaos=ChaosInjector(plan, sleep=lambda s: None),
        health=HealthPolicy(quarantine_after=2, quarantine_rounds=2,
                            recover_after=1), sleep=lambda s: None)
    group = next(iter(engine.groups.values()))
    states = []
    for _ in range(6):
        for spec in specs:
            engine.submit_scenario(spec.name, 8)
        engine.pump(force=True)
        states.append(engine.lane_health("t1"))
        assert engine.ticks_served("t0") == engine.ticks_submitted("t0")
    assert states == ["degraded", "quarantined", "quarantined", "healthy",
                      "healthy", "healthy"]
    assert engine.registry.counter("serve.quarantines").value == 1
    assert engine.registry.counter("serve.probes").value == 1
    assert engine.registry.counter("serve.recoveries").value == 1
    engine.drain()  # quarantine-era backlog finally served
    assert engine.ticks_served("t1") == engine.ticks_submitted("t1")
    assert engine.accounting()["closes"]
    assert group.jit_cache_entries() == 1, "masking must not change shapes"
    fleet = engine.serve_report()[-1]
    assert fleet["faults"]["quarantines"] == 1
    assert fleet["faults"]["injected"] >= 2 and "recovery_ms_p50" in fleet
    plan = FaultPlan(events=(FaultEvent(round=1, kind="lane_fault",
                                        tenant="ghost"),))
    engine, _ = _engine(cfg, ["sparse_poisson"],
                        chaos=ChaosInjector(plan, sleep=lambda s: None))
    engine.submit_scenario("t0", 4)
    assert engine.drain() == 4
    assert engine.registry.counter("serve.faults.unknown_lane").value == 1
    with pytest.raises(KeyError, match="unknown tenant"):
        engine.lane_health("ghost")


def test_rate_limit_and_backlog_shedding():
    cfg = tconfig.as_interface_config(_cfg("binary_tree", "broadcast"))
    clock = _FakeClock()
    engine = ServeEngine(flush_ticks=4, flush_deadline_s=0.0, clock=clock,
                         policy=AdmissionPolicy(rate_limit_per_s=8.0,
                                                rate_limit_burst=8.0),
                         device="cpu")
    engine.register(TenantSpec("t0", cfg))
    engine.submit("t0", _zeros(8, cfg))  # drains the full burst
    with pytest.raises(RateLimitedError, match="rate-limited"):
        engine.submit("t0", _zeros(1, cfg))
    assert engine.ticks_submitted("t0") == 8
    clock.now += 0.5  # refills 4 tokens
    engine.submit("t0", _zeros(4, cfg))
    with pytest.raises(RateLimitedError, match="never be admitted"):
        engine.submit("t0", _zeros(9, cfg))  # larger than the burst
    assert engine.drain() == 12 and engine.accounting()["closes"]
    assert engine.serve_report()[-1]["faults"]["rate_limited"] == 2

    clock = _FakeClock()
    engine = ServeEngine(flush_ticks=4, flush_deadline_s=0.0, clock=clock,
                         policy=AdmissionPolicy(shed_deadline_s=1.0,
                                                max_pending_frames=16),
                         device="cpu")
    engine.register(TenantSpec("t0", cfg))
    engine.submit_scenario("t0", 6)
    with pytest.raises(QueueOverflowError):
        engine.submit_scenario("t0", 11)
    for _ in range(engine.health.policy.quarantine_after):
        engine.health.record_failure("t0")
    assert engine.lane_health("t0") == "quarantined"
    assert engine.pump(force=True) == 0  # staged but skipped, age 0: kept
    group = engine._tenant_group["t0"]
    assert group.backlog_ticks_of("t0") == 6
    clock.now = 5.0
    assert engine.pump(force=True) == 0  # aged out: shed, not served
    assert group.backlog_ticks_of("t0") == 0 and engine.ticks_shed("t0") == 6
    acct = engine.accounting()
    assert acct["closes"] and acct["tenants"]["t0"]["pending"] == 0
    assert any("backlog" in str(e) for e in engine.shed_errors())
    engine.submit_scenario("t0", 2)
    clock.now = 10.0
    assert engine.pump(force=True) == 0
    assert engine.ticks_shed("t0") == 8
    assert isinstance(engine.shed_errors()[-1], DeadlineExceededError)
    engine.reset_metrics()
    assert engine.ticks_submitted() == 0 and engine.accounting()["closes"]
