"""The port's traffic scenarios (`repro_torch.traffic`) against the JAX package.

The port draws from `torch.Generator`s, so its streams are not
`jax.random`'s bit for bit (ROADMAP queue A item 9).  What holds both
packages to one contract: the registry (names, defaults, parameter
validation), `expected_rate` (pure Python arithmetic: exactly equal),
every scenario's shape and dtype, determinism per (seed, round), and the
empirical spike rate of a large draw against `expected_rate` within five
binomial standard deviations (inflated by the scenarios' correlated
structure where the draws are not independent).
"""

import math

import numpy as np
import pytest
import torch

from repro import traffic as jtraffic
from repro_torch import traffic
from repro_torch.interface import InterfaceConfig

NAMES = ("clustered", "dvs_trace", "hotspot_core", "mixture",
         "sparse_poisson", "synchronized_burst")

# a parameter set beside the defaults, one per scenario
OVERRIDES = {
    "sparse_poisson": {"rate": 0.1},
    "synchronized_burst": {"period": 8, "duty": 3, "burst_rate": 0.5},
    "hotspot_core": {"hot_cores": 3, "hot_rate": 0.7, "cold_rate": 0.02},
    "clustered": {"cluster_size": 8, "active_prob": 0.5, "rate": 0.3},
    "dvs_trace": {"edge_frac": 0.2, "drift": 0.1, "thin": 0.8},
    "mixture": {"components": (("hotspot_core", 1.0), ("clustered", 3.0))},
}


def test_registry_matches_the_jax_package():
    assert traffic.scenario_names() == jtraffic.scenario_names() == NAMES
    for name in NAMES:
        spec, jspec = traffic.get_scenario(name), jtraffic.get_scenario(name)
        assert dict(spec.defaults) == dict(jspec.defaults), name
        assert spec.description == jspec.description, name
    with pytest.raises(KeyError):
        traffic.get_scenario("nope")
    with pytest.raises(ValueError, match="unknown parameter"):
        traffic.generate("sparse_poisson", 0, 2, (4, 16), nope=1)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", [(4, 16), (16, 256), (5, 7)])
@pytest.mark.parametrize("overridden", [False, True])
def test_expected_rate_equals_the_jax_package(name, shape, overridden):
    kw = OVERRIDES[name] if overridden else {}
    assert traffic.expected_rate(name, *shape, **kw) == \
        jtraffic.expected_rate(name, *shape, **kw)


@pytest.mark.parametrize("name", NAMES)
def test_scenario_shapes_determinism_and_rounds(name):
    cfg = InterfaceConfig(cores=4, neurons_per_core=16,
                          cam_entries_per_core=32)
    a = traffic.generate(name, 3, 10, cfg)
    assert a.shape == (10, 4, 16) and a.dtype == torch.bool
    assert a.device.type == "cpu"
    assert torch.equal(a, traffic.generate(name, 3, 10, (4, 16)))
    gen = torch.Generator().manual_seed(traffic.stream_seed(3))
    assert torch.equal(a, traffic.generate(name, gen, 10, cfg))
    draws = [traffic.generate(name, s, 10, cfg) for s in (4, 5, 6)]
    assert any(not torch.equal(a, b) for b in draws), "seeds must differ"
    jshape = tuple(jtraffic.generate(name, 3, 10, (4, 16)).shape)
    assert jshape == tuple(a.shape)


@pytest.mark.parametrize("name", NAMES)
def test_empirical_rate_tracks_expected_rate(name):
    cores, n, ticks = 16, 256, 64
    x = traffic.generate(name, 11, ticks, (cores, n))
    want = traffic.expected_rate(name, cores, n)
    # independent draws: the binomial spread; the scenarios that gate
    # many neurons together (a hot core, a cluster, a burst tick, the
    # mixture's per-tick choice) get the spread of their gating units
    units = {"hotspot_core": cores, "clustered": ticks * cores * n / 16,
             "synchronized_burst": ticks, "mixture": ticks,
             "dvs_trace": ticks * cores * n}.get(name, ticks * cores * n)
    sd = math.sqrt(want * (1 - want) / units)
    got = float(x.float().mean())
    assert abs(got - want) <= 5 * sd + 1e-3, (name, got, want, sd)


def test_scenario_specifics():
    burst = traffic.generate("synchronized_burst", 0, 16, (8, 64),
                             background=0.0, burst_rate=1.0)
    assert burst[::4].all() and not burst[1::4].any()
    hot = traffic.generate("hotspot_core", 1, 8, (8, 64), hot_cores=2,
                           hot_rate=1.0, cold_rate=0.0)
    assert int(hot.all(-1).all(0).sum()) == 2 and not bool(
        hot[:, ~hot.all(-1).all(0)].any())
    clus = traffic.generate("clustered", 2, 8, (4, 16), cluster_size=8,
                            rate=1.0, active_prob=0.5)
    blocks = clus.reshape(8, -1, 8)
    assert bool((blocks.all(-1) | ~blocks.any(-1)).all())
    dvs = traffic.generate("dvs_trace", 3, 4, (4, 64), edge_frac=0.25,
                           drift=0.25, edge_rate=1.0, noise_rate=0.0,
                           thin=1.0)
    want = np.zeros((4, 256), bool)
    for t in range(4):
        want[t, 64 * t:64 * t + 64] = True
    assert np.array_equal(dvs.reshape(4, -1).numpy(), want)
    with pytest.raises(ValueError, match="duty"):
        traffic.generate("synchronized_burst", 0, 2, (2, 4), duty=5)
    with pytest.raises(ValueError, match="hot_cores"):
        traffic.generate("hotspot_core", 0, 2, (2, 4), hot_cores=3)
    with pytest.raises(ValueError, match="leaf"):
        traffic.generate("mixture", 0, 2, (2, 4),
                         components=(("mixture", 1.0),))
    with pytest.raises(ValueError, match="weight"):
        traffic.generate("mixture", 0, 2, (2, 4),
                         components=(("sparse_poisson", 0.0),))


def test_stream_seed_separates_rounds_and_seeds():
    seeds = {traffic.stream_seed(s, r) for s in range(20) for r in range(20)}
    assert len(seeds) == 400 and all(0 <= v < 2 ** 63 for v in seeds)
    assert traffic.stream_seed(1, 2) == traffic.stream_seed(1, 2)


def test_register_scenario_plugs_in_and_validates():
    spec = traffic.ScenarioSpec(
        name="all_on",
        generate=lambda g, t, c, n, *, level=1: torch.ones(
            (t, c, n), dtype=torch.bool),
        expected_rate=lambda p, c, n: 1.0, defaults={"level": 1})
    with pytest.raises(ValueError, match="does not match"):
        traffic.register_scenario("other", spec)
    with pytest.raises(TypeError):
        traffic.register_scenario("all_on", object())
    traffic.register_scenario("all_on", spec)
    try:
        assert "all_on" in traffic.scenario_names()
        assert bool(traffic.generate("all_on", 0, 2, (2, 4)).all())
        assert traffic.expected_rate("all_on", 2, 4) == 1.0
        with pytest.raises(ValueError, match="already registered"):
            traffic.register_scenario("all_on", spec)
        bad = traffic.ScenarioSpec(
            name="bad", generate=lambda g, t, c, n: torch.zeros((t, c)),
            expected_rate=lambda p, c, n: 0.0, defaults={})
        traffic.register_scenario("bad", bad)
        with pytest.raises(ValueError, match="expected bool"):
            traffic.generate("bad", 0, 2, (2, 4))
    finally:
        traffic.SCENARIOS.unregister("all_on")
        traffic.SCENARIOS.unregister("bad")
