"""Registered spike-traffic scenarios for driving the core-interface fabric.

Port of `repro.traffic.scenarios`: the same registry, the same six
built-in generators with the same parameters and defaults, and the same
analytic ``expected_rate``.  A scenario is a generator ``(generator,
ticks, cores, neurons_per_core, **params) -> (ticks, cores,
neurons_per_core) bool`` drawing from an explicit `torch.Generator`,
plus expected-rate metadata, bundled in a :class:`ScenarioSpec` and
registered under a name:

    from repro_torch import traffic

    spikes = traffic.generate("sparse_poisson", seed=0, ticks=64, shape=cfg)
    traffic.expected_rate("sparse_poisson", cfg.cores, cfg.neurons_per_core)

Built-ins (registered at import):

  sparse_poisson      i.i.d. low-rate Bernoulli - the paper's sparse mode
  synchronized_burst  near-silent frames punctuated by full-fabric bursts
  hotspot_core        a few hot cores against a cold background
  clustered           rate-coded cluster gating over the flat neuron space
  dvs_trace           thinned DVS-like replay: a moving edge sweeping the
                      flat neuron space over sensor background noise
  mixture             per-tick categorical mix of registered scenarios

`generate` with an integer seed draws on the CPU from a generator seeded
by `stream_seed`, so a stream is the same whatever device its consumer
computes on; a caller moves it to the card.  The numbers differ from
`jax.random`'s for the same seed (threefry); the distributions and
``expected_rate`` are the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

from repro_torch.interface.registry import SchemeRegistry

SCENARIOS = SchemeRegistry("traffic scenario")

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One registered traffic scenario.

    generate:      ``(generator, ticks, cores, neurons_per_core, **params)``
                   -> (ticks, cores, neurons_per_core) bool spike raster,
                   drawn from the `torch.Generator` on its device.
    expected_rate: ``(params, cores, neurons_per_core)`` -> analytic mean
                   spike probability of the raster those params produce.
    defaults:      full parameter set; `generate(...)` overrides merge
                   into (and are validated against) these keys.
    """

    name: str
    generate: Callable[..., torch.Tensor]
    expected_rate: Callable[[Mapping[str, Any], int, int], float]
    defaults: Mapping[str, Any]
    description: str = ""


def register_scenario(name: str, spec: ScenarioSpec, *,
                      overwrite: bool = False) -> ScenarioSpec:
    """Register a traffic scenario (see :class:`ScenarioSpec`)."""
    if not isinstance(spec, ScenarioSpec):
        raise TypeError(f"expected a ScenarioSpec, got {type(spec).__name__}")
    if spec.name != name:
        raise ValueError(f"spec.name {spec.name!r} does not match "
                         f"registration name {name!r}")
    return SCENARIOS.register(name, spec, overwrite=overwrite)


def get_scenario(name: str) -> ScenarioSpec:
    """Resolve a scenario name (KeyError lists the registered names)."""
    return SCENARIOS.get(name)


def scenario_names() -> tuple[str, ...]:
    """All registered scenario names, sorted."""
    return SCENARIOS.names()


def stream_seed(seed: int, round: int = 0) -> int:
    """The 64-bit generator seed of stream ``round`` of ``seed``: a
    splitmix64 mix of the pair, so successive rounds (and neighbouring
    seeds) draw unrelated streams, as ``jax.random.fold_in`` does."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(round) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1          # manual_seed takes < 2**63 here


def _shape_of(shape) -> tuple[int, int]:
    """Accept (cores, neurons_per_core) or any config exposing those fields."""
    if hasattr(shape, "cores") and hasattr(shape, "neurons_per_core"):
        return int(shape.cores), int(shape.neurons_per_core)
    cores, n = shape
    return int(cores), int(n)


def _resolve_params(spec: ScenarioSpec, overrides: Mapping[str, Any]) -> dict:
    unknown = sorted(set(overrides) - set(spec.defaults))
    if unknown:
        raise ValueError(
            f"unknown parameter(s) {', '.join(unknown)} for scenario "
            f"{spec.name!r}; valid: {', '.join(sorted(spec.defaults))}")
    return {**spec.defaults, **overrides}


def generate(name: str, seed, ticks: int, shape, **overrides) -> torch.Tensor:
    """Generate a (ticks, cores, neurons_per_core) bool spike raster.

    seed:  an int (a CPU generator seeded by ``stream_seed(seed)``) or a
           `torch.Generator`, drawn from on its own device.
    shape: (cores, neurons_per_core) or a config exposing those fields.
    """
    spec = get_scenario(name)
    params = _resolve_params(spec, overrides)
    cores, n = _shape_of(shape)
    gen = (seed if isinstance(seed, torch.Generator)
           else torch.Generator().manual_seed(stream_seed(seed)))
    out = spec.generate(gen, int(ticks), cores, n, **params)
    if tuple(out.shape) != (ticks, cores, n) or out.dtype != torch.bool:
        raise ValueError(
            f"scenario {name!r} produced {out.dtype} tensor of shape "
            f"{tuple(out.shape)}; expected bool ({ticks}, {cores}, {n})")
    return out


def expected_rate(name: str, cores: int, neurons_per_core: int,
                  **overrides) -> float:
    """Analytic mean spike probability for the merged parameters."""
    spec = get_scenario(name)
    params = _resolve_params(spec, overrides)
    return float(spec.expected_rate(params, int(cores), int(neurons_per_core)))


# ---------------------------------------------------------------------------
# Built-in generators
# ---------------------------------------------------------------------------


def _uniform(gen, shape):
    return torch.rand(shape, generator=gen, device=gen.device)


def sparse_poisson(gen, ticks, cores, neurons_per_core, *, rate=0.02):
    """i.i.d. Bernoulli(rate): the paper's sparse-event operating mode."""
    return _uniform(gen, (ticks, cores, neurons_per_core)) < rate


def synchronized_burst(gen, ticks, cores, neurons_per_core, *, period=4,
                       duty=1, burst_rate=0.9, background=0.005):
    """Near-silent frames punctuated by fabric-wide synchronized bursts.

    Every ``period`` ticks, ``duty`` consecutive ticks are burst frames in
    which each neuron fires with ``burst_rate``; the remaining frames fire
    at ``background``.
    """
    if not 1 <= duty <= period:
        raise ValueError(f"duty={duty} must be in [1, period={period}]")
    bursting = (torch.arange(ticks, device=gen.device) % period) < duty
    p = torch.where(bursting, burst_rate, background)[:, None, None]
    return _uniform(gen, (ticks, cores, neurons_per_core)) < p


def hotspot_core(gen, ticks, cores, neurons_per_core, *, hot_cores=1,
                 hot_rate=0.5, cold_rate=0.01):
    """A few saturated cores against a cold fabric (seed-chosen hot set)."""
    if not 1 <= hot_cores <= cores:
        raise ValueError(f"hot_cores={hot_cores} must be in [1, cores={cores}]")
    hot_idx = torch.randperm(cores, generator=gen, device=gen.device)
    hot = torch.zeros(cores, dtype=torch.bool, device=gen.device)
    hot[hot_idx[:hot_cores]] = True
    p = torch.where(hot, hot_rate, cold_rate)[None, :, None]
    return _uniform(gen, (ticks, cores, neurons_per_core)) < p


def clustered(gen, ticks, cores, neurons_per_core, *, cluster_size=16,
              active_prob=0.25, rate=0.5):
    """Rate-coded cluster gating over the flat global neuron space.

    Neurons form contiguous clusters of ``cluster_size`` global ids; each
    tick every cluster is independently gated on with ``active_prob``;
    neurons in an active cluster fire with ``rate``.
    """
    if cluster_size < 1:
        raise ValueError(f"cluster_size={cluster_size} must be >= 1")
    total = cores * neurons_per_core
    num_clusters = -(-total // cluster_size)  # ceil
    gates = _uniform(gen, (ticks, num_clusters)) < active_prob
    cluster_of = torch.arange(total, device=gen.device) // cluster_size
    fire = _uniform(gen, (ticks, total)) < rate
    return (gates[:, cluster_of] & fire).reshape(ticks, cores,
                                                 neurons_per_core)


def dvs_trace(gen, ticks, cores, neurons_per_core, *, edge_frac=0.08,
              drift=0.05, edge_rate=0.8, noise_rate=0.005, thin=0.5):
    """Thinned DVS-like trace replay: a moving edge over sensor noise.

    A contiguous window of ``edge_frac`` of the flat neuron space sweeps
    ``drift`` of the space per tick, firing at ``edge_rate``; everything
    else emits ``noise_rate`` background events; every event is kept with
    probability ``thin``.
    """
    total = cores * neurons_per_core
    width = max(1, int(round(edge_frac * total)))
    stride = max(1, int(round(drift * total)))
    dev = gen.device
    start = (torch.arange(ticks, device=dev) * stride) % total
    offset = (torch.arange(total, device=dev)[None, :] - start[:, None]) % total
    p = torch.where(offset < width, edge_rate, noise_rate) * thin
    raw = _uniform(gen, (ticks, total)) < p
    return raw.reshape(ticks, cores, neurons_per_core)


def _burst_expected_rate(params, cores, neurons_per_core):
    frac = params["duty"] / params["period"]
    return frac * params["burst_rate"] + (1.0 - frac) * params["background"]


def _hotspot_expected_rate(params, cores, neurons_per_core):
    hot = params["hot_cores"]
    return (hot * params["hot_rate"] + (cores - hot) * params["cold_rate"]) / cores


def _dvs_expected_rate(params, cores, neurons_per_core):
    total = cores * neurons_per_core
    w = max(1, int(round(params["edge_frac"] * total))) / total
    return params["thin"] * (w * params["edge_rate"]
                             + (1.0 - w) * params["noise_rate"])


def mixture(gen, ticks, cores, neurons_per_core, *,
            components=(("sparse_poisson", 0.7), ("synchronized_burst", 0.3))):
    """Per-tick categorical mixture of registered scenarios.

    components: ((name, weight), ...) - each tick is drawn from one
    component (chosen with probability proportional to its weight) using
    that component's registered defaults.  Nested mixtures are rejected.
    """
    names, weights = _mixture_components(components)
    frames = torch.stack([
        get_scenario(name).generate(gen, ticks, cores, neurons_per_core,
                                    **get_scenario(name).defaults)
        for name in names])
    p = torch.tensor(weights, dtype=torch.float64, device=gen.device)
    choice = torch.multinomial(p / p.sum(), ticks, replacement=True,
                               generator=gen)
    return frames[choice, torch.arange(ticks, device=gen.device)]


def _mixture_components(components):
    if not components:
        raise ValueError("mixture needs at least one (name, weight) component")
    names, weights = [], []
    for name, weight in components:
        if name == "mixture":
            raise ValueError("mixture components must be leaf scenarios, "
                             "not 'mixture'")
        get_scenario(name)  # raises with the registered list on unknown names
        if not weight > 0:
            raise ValueError(f"component {name!r} weight must be > 0, got "
                             f"{weight}")
        names.append(name)
        weights.append(float(weight))
    return tuple(names), tuple(weights)


def _mixture_expected_rate(params, cores, neurons_per_core):
    names, weights = _mixture_components(params["components"])
    total_w = sum(weights)
    return sum(w / total_w * expected_rate(name, cores, neurons_per_core)
               for name, w in zip(names, weights))


# ---------------------------------------------------------------------------
# Registration (at import, like the arbiter/CAM/NoC built-ins)
# ---------------------------------------------------------------------------

register_scenario("sparse_poisson", ScenarioSpec(
    name="sparse_poisson", generate=sparse_poisson,
    expected_rate=lambda p, c, n: p["rate"], defaults={"rate": 0.02},
    description="i.i.d. low-rate Bernoulli (the paper's sparse-event mode)"))

register_scenario("synchronized_burst", ScenarioSpec(
    name="synchronized_burst", generate=synchronized_burst,
    expected_rate=_burst_expected_rate,
    defaults={"period": 4, "duty": 1, "burst_rate": 0.9,
              "background": 0.005},
    description="near-silent frames punctuated by fabric-wide bursts"))

register_scenario("hotspot_core", ScenarioSpec(
    name="hotspot_core", generate=hotspot_core,
    expected_rate=_hotspot_expected_rate,
    defaults={"hot_cores": 1, "hot_rate": 0.5, "cold_rate": 0.01},
    description="a few saturated cores against a cold fabric"))

register_scenario("clustered", ScenarioSpec(
    name="clustered", generate=clustered,
    expected_rate=lambda p, c, n: p["active_prob"] * p["rate"],
    defaults={"cluster_size": 16, "active_prob": 0.25, "rate": 0.5},
    description="rate-coded cluster gating aligned with noc.placement "
                "clusters"))

register_scenario("dvs_trace", ScenarioSpec(
    name="dvs_trace", generate=dvs_trace, expected_rate=_dvs_expected_rate,
    defaults={"edge_frac": 0.08, "drift": 0.05, "edge_rate": 0.8,
              "noise_rate": 0.005, "thin": 0.5},
    description="thinned DVS-like replay: a moving edge over sensor noise"))

register_scenario("mixture", ScenarioSpec(
    name="mixture", generate=mixture, expected_rate=_mixture_expected_rate,
    defaults={"components": (("sparse_poisson", 0.7),
                             ("synchronized_burst", 0.3))},
    description="per-tick categorical mixture of registered scenarios"))
