"""The port's observability and chaos layers against the JAX package's.

`repro_torch.obs.metrics`, `repro_torch.obs.report`,
`repro_torch.ft.chaos` and `repro_torch.ft.runner.Watchdog` are pure
Python copies: on the same inputs and seeds their numbers (histogram
percentiles and merges, exact percentiles, registry snapshots, rendered
reports, `FaultPlan.mixed` draws, injector firings, straggler flags)
equal the JAX package's exactly.  `repro_torch.obs.trace` records the
JAX package's span events, opens a `torch.profiler.record_function`
range per span, and the serve engine's spans land in an active tracer.
"""

import dataclasses
import json
import random

import numpy as np
import pytest
import torch

from repro.ft import chaos as jchaos
from repro.ft import runner as jrunner
from repro.obs import metrics as jmetrics
from repro.obs import report as jreport
from repro_torch.ft import chaos
from repro_torch.ft.runner import Watchdog
from repro_torch.interface import config as tconfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import report as obs_report
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import ServeEngine, TenantSpec
from tests.conformance import paths


def _samples(seed, n=500):
    rng = random.Random(seed)
    return [rng.lognormvariate(0.0, 2.0) for _ in range(n)] + [
        0.0, -1.0, 1e-9, 5e7, float("nan"), float("inf")]


# ---- metrics ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bins", [64, 16])
def test_histogram_equals_the_jax_package(seed, bins):
    values = _samples(seed)
    mine, theirs = (m.Histogram("h", bins_per_decade=bins)
                    for m in (obs_metrics, jmetrics))
    for v in values:
        mine.add(v)
        theirs.add(v)
    qs = (0, 1, 25, 50, 90, 95, 99, 99.9, 100)
    assert mine.summary(qs) == theirs.summary(qs)
    assert mine.nonfinite == theirs.nonfinite == 2
    other_m, other_t = (m.Histogram("o", bins_per_decade=bins)
                        for m in (obs_metrics, jmetrics))
    for v in _samples(seed + 10, 50):
        other_m.add(v)
        other_t.add(v)
    assert mine.merge(other_m).summary(qs) == theirs.merge(other_t).summary(qs)
    with pytest.raises(ValueError, match="different bucketing"):
        mine.merge(obs_metrics.Histogram("x", bins_per_decade=bins + 1))
    with pytest.raises(ValueError, match="empty"):
        obs_metrics.Histogram("e").percentile(50)


def test_exact_percentiles_and_registry_equal_the_jax_package():
    values = [v for v in _samples(3, 101) if v == v and abs(v) != float("inf")]
    qs = (0, 50, 95, 99, 100)
    assert obs_metrics.percentiles(values, qs) == jmetrics.percentiles(values,
                                                                       qs)
    with pytest.raises(ValueError):
        obs_metrics.percentiles([])
    mine, theirs = obs_metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for reg in (mine, theirs):
        reg.counter("a").inc(3)
        reg.counter("a").inc()
        for v in values[:40]:
            reg.histogram("lat").add(v)
        reg.histogram("unused")
    assert mine.snapshot() == theirs.snapshot()
    assert "unused" not in mine.snapshot()


def test_jsonl_sink_roundtrip_and_report_equal_the_jax_package(tmp_path,
                                                               capsys):
    stats = {"events": 84.5, "encode_latency": 18.4, "encode_energy": 16.0,
             "cam_searches": 41.0, "cam_energy": 23193.4,
             "cam_time_ns": 103.9, "noc_hops": 91.4, "noc_latency": 12.7,
             "noc_energy": 3198.1, "chip_hops": 0.0, "chip_latency": 0.0,
             "chip_energy": 0.0}
    records = [
        {"tenant": "t0", "scenario": "sparse_poisson", "cores": 16,
         "neurons_per_core": 256, "ticks": 64, "tick_ms_p50": 0.8,
         "tick_ms_p95": 0.9, "tick_ms_p99": 1.1, "stats_per_tick": stats,
         "health": "degraded"},
        {"tenant": "__fleet__", "tenants": 1, "ticks": 64,
         "faults": {"retries": 2, "injected": 3}, "recovery_ms_p50": 1.5,
         "recovery_ms_p99": 4.0},
    ]
    path = tmp_path / "serve.jsonl"
    with obs_metrics.JsonlSink(str(path)) as sink:
        for rec in records:
            sink.write(rec)
    assert obs_report.load_records(str(path)) == records
    assert obs_report.load_records(str(path)) == jreport.load_records(
        str(path))
    for scenario in (None, "sparse_poisson", "nope"):
        assert obs_report.format_report(records, scenario) == \
            jreport.format_report(records, scenario)
    assert obs_report.tier_rows(stats) == jreport.tier_rows(stats)
    assert obs_report.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "faults: injected 3, retries 2" in out and "health: degraded" in out
    bad = tmp_path / "bad.txt"
    bad.write_text("definitely { not json\nnor jsonl ]")
    assert obs_report.main([str(bad)]) == 1
    assert "error:" in capsys.readouterr().out


# ---- trace -----------------------------------------------------------------


def test_tracer_records_nested_spans_and_profiler_ranges(tmp_path):
    tracer = obs_trace.Tracer("test-proc")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracer:
            with obs_trace.span("outer", cores=4):
                with obs_trace.span("inner"):
                    torch.ones(4).sum()
            tracer.instant("marker", tick=7)
    names = [e["name"] for e in tracer.events]
    assert names == ["inner", "outer", "marker"]  # completion order
    by_name = {e["name"]: e for e in tracer.events}
    assert by_name["outer"]["args"] == {"cores": 4, "depth": 0}
    assert by_name["inner"]["args"] == {"depth": 1}
    assert by_name["outer"]["dur"] >= by_name["inner"]["dur"]
    ranges = {e.name for e in prof.events()}
    assert {"outer", "inner"} <= ranges, "spans open profiler ranges"
    path = tmp_path / "trace.json"
    tracer.save(str(path))
    payload = json.loads(path.read_text())
    assert payload["traceEvents"][0]["args"]["name"] == "test-proc"
    assert {e["name"] for e in payload["traceEvents"][1:]} == {
        "outer", "inner", "marker"}


def test_span_is_noop_without_active_tracer():
    assert obs_trace.active_tracer() is None
    with obs_trace.span("nobody-listening") as t:
        assert t is None
    tracer = obs_trace.Tracer()
    with tracer:
        assert obs_trace.active_tracer() is tracer
    assert obs_trace.active_tracer() is None
    with obs_trace.span("after"):
        pass
    assert tracer.events == []


def test_serve_engine_emits_spans():
    cfg = tconfig.as_interface_config(paths.small_config("binary_tree",
                                                         "broadcast"))
    tracer = obs_trace.Tracer()
    with tracer:
        engine = ServeEngine(flush_ticks=4, flush_deadline_s=0.0,
                             device="cpu")
        engine.register(TenantSpec("t0", cfg))
        engine.submit_scenario("t0", 9)
        engine.drain()
    names = [e["name"] for e in tracer.events]
    assert names.count("serve.group_compile") == 1
    assert names.count("serve.step") == 3
    assert names.count("serve.device_transfer") == 3


# ---- chaos and the watchdog ------------------------------------------------


def _plan_rows(plan):
    return [dataclasses.astuple(ev) for ev in plan.events]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("rounds,intensity", [(4, 0.3), (12, 0.3),
                                              (30, 0.8)])
def test_fault_plan_draws_equal_the_jax_package(seed, rounds, intensity):
    tenants = ["a", "b", "c"]
    mine = chaos.FaultPlan.mixed(tenants, rounds, seed=seed,
                                 intensity=intensity)
    theirs = jchaos.FaultPlan.mixed(tenants, rounds, seed=seed,
                                    intensity=intensity)
    assert _plan_rows(mine) == _plan_rows(theirs)
    assert mine.kinds() == theirs.kinds()
    assert mine.total_charges() == theirs.total_charges()
    assert set(mine.kinds()) == set(chaos.FAULT_KINDS)


def test_chaos_injector_fires_as_the_jax_package():
    events = (("transfer_fail", None, 2), ("execute_fail", None, 1),
              ("slow_device", None, 1), ("lane_fault", "t1", 2))
    plans = [m.FaultPlan(events=tuple(
        m.FaultEvent(round=1 + i, kind=k, tenant=t, times=n, delay_s=0.5)
        for i, (k, t, n) in enumerate(events))) for m in (chaos, jchaos)]
    logs = []
    for m, plan in zip((chaos, jchaos), plans):
        slept, log = [], []
        inj = m.ChaosInjector(plan, sleep=slept.append)
        for round_ in range(1, 7):
            for hook in (inj.on_transfer, inj.on_execute):
                try:
                    hook(round_)
                    log.append((round_, hook.__name__, "ok"))
                except m.TransientFaultError as e:
                    log.append((round_, hook.__name__, type(e).__name__))
            log.append((round_, [ev.tenant for ev in inj.lane_faults(round_)]))
        log.append((slept, inj.exhausted(), dict(inj.injected)))
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[0][-1][1] is True
    with pytest.raises(ValueError, match="unknown fault kind"):
        chaos.FaultEvent(round=1, kind="nope")
    with pytest.raises(ValueError, match="tenant is required"):
        chaos.FaultEvent(round=1, kind="lane_fault")
    assert issubclass(chaos.TransferFault, chaos.TransientFaultError)
    assert not issubclass(chaos.RetriesExhaustedError,
                          chaos.TransientFaultError)


def test_watchdog_flags_stragglers_as_the_jax_package():
    rng = np.random.default_rng(0)
    times = list(rng.random(40) * 0.01) + [0.5, 0.004, 0.9]
    mine, theirs = Watchdog(prefix="serve"), jrunner.Watchdog(prefix="serve")
    flags = [(mine.observe(t), theirs.observe(t)) for t in times]
    assert all(a == b for a, b in flags)
    assert mine.stragglers == theirs.stragglers >= 2
    assert mine.registry.snapshot() == theirs.registry.snapshot()
