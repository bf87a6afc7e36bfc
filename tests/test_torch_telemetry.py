"""The port's session telemetry (`repro_torch.obs.telemetry`) against the
JAX package's.

The port's counterparts of `tests/test_obs.py`'s telemetry tests, on the
port's sessions under all three impls (``xla``, ``pallas`` - the plain
versions of B2 and B3 here - and ``pallas_sparse``, whose per-tick rows
and per-core terms come from B1's whole run), at one and at several
chips:

* ``"off"`` is unchanged: currents and accumulated stats are bitwise the
  same in every mode;
* the ``"ticks"`` series sums back to the accumulated record, and the
  ``"cores"`` breakdown to the per-tick totals (max for latency), with
  inter-chip hops attributed only at chips > 1;
* the series and breakdowns equal the JAX package's under the
  conformance contract (currents bitwise, `EXACT_FIELDS` exact, the rest
  within `REL_TOL`), for `run`, `run_batched` and
  ``interface_tick(telemetry="cores")``;
* unknown modes and telemetry with a multi-chip ``shard`` raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fabric as jfabric
from repro.interface import Interface as JInterface
from repro.interface import pipeline as jpipeline
from repro_torch.interface import Interface, StepStats
from repro_torch.interface import pipeline as tpipeline
from repro_torch.interface.config import as_interface_config
from repro_torch.interface.session import CompositionError
from repro_torch.interface.types import params_from_numpy
from repro_torch.obs import telemetry as obs_telemetry
from tests.conformance.paths import (ARBITER_SCHEMES, EXACT_FIELDS, GRID,
                                     NOC_SCHEMES, REL_TOL, small_config)

TICKS = 5
IMPLS = ("xla", "pallas", "pallas_sparse")


def _fabric(cfg, seed=0):
    jparams = jfabric.random_connectivity(jax.random.PRNGKey(seed), cfg)
    tparams = params_from_numpy(*(np.asarray(x) for x in jparams),
                                device="cpu")
    return jparams, tparams


def _session(cfg, seed=0):
    return Interface(as_interface_config(cfg)).compile(_fabric(cfg, seed)[1],
                                                       device="cpu")


def _spikes(cfg, ticks=TICKS, seed=3, lead=(), p=0.25):
    shape = lead + (ticks, cfg.cores, cfg.neurons_per_core)
    return np.array(jax.random.bernoulli(jax.random.PRNGKey(seed), p, shape))


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_stats_equal(a, b, label):
    for field in StepStats._fields:
        assert torch.equal(getattr(a, field), getattr(b, field)), \
            f"{label}: {field} differs"


def _assert_sums_back(acc, series, label):
    """Summing the tick axis in order gives the accumulated record."""
    for field in StepStats._fields:
        total = getattr(acc, field)
        s = getattr(series, field)
        summed = torch.zeros_like(total)
        for t in range(s.shape[-1]):
            summed = summed + s[..., t]
        if field in EXACT_FIELDS:
            assert torch.equal(summed, total), f"{label}: {field}"
        else:
            torch.testing.assert_close(summed, total, rtol=REL_TOL, atol=0)


def _assert_like_jax(got, want, label):
    """A port record (StepStats or CoreStats) against the JAX one."""
    for field in want._fields:
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert a.shape == b.shape, f"{label}: {field} {a.shape} {b.shape}"
        if field in EXACT_FIELDS or field == "events":
            np.testing.assert_array_equal(a, b, err_msg=f"{label}: {field}")
        else:
            np.testing.assert_allclose(a, b, rtol=REL_TOL, atol=0,
                                       err_msg=f"{label}: {field}")


# ---- "off" unchanged, series sum back ----------------------------------------


@pytest.mark.parametrize("arb_scheme,noc_scheme", GRID)
def test_telemetry_preserves_off_path_across_grid(arb_scheme, noc_scheme):
    cfg = small_config(arb_scheme, noc_scheme)
    session = _session(cfg)
    spikes = _t(_spikes(cfg))
    cur_off, acc_off = session.run(spikes)
    cur_t, acc_t, telem = session.run(spikes, telemetry="ticks")
    assert torch.equal(cur_off, cur_t)
    _assert_stats_equal(acc_off, acc_t, f"{arb_scheme}/{noc_scheme}")
    _assert_sums_back(acc_off, telem.per_tick, f"{arb_scheme}/{noc_scheme}")
    assert telem.ticks == TICKS


@pytest.mark.parametrize("variant", ["pallas", "pallas_sparse", "chips2",
                                     "chips4_sparse"])
def test_telemetry_preserves_off_path_on_alt_paths(variant):
    cfg = small_config(ARBITER_SCHEMES[0], NOC_SCHEMES[1], cores=8)
    impl = {"pallas": "pallas", "chips2": "xla"}.get(variant, "pallas_sparse")
    chips = {"chips2": 2, "chips4_sparse": 4}.get(variant, 1)
    cfg = dataclasses.replace(cfg, impl=impl, chips=chips)
    session = _session(cfg)
    # bursts overflow the sparse capacity: both of B1's branches run
    spikes = _t(_spikes(cfg, p=0.05))
    spikes[1] = True
    cur_off, acc_off = session.run(spikes)
    for mode in ("ticks", "cores"):
        cur_t, acc_t, telem = session.run(spikes, telemetry=mode)
        assert torch.equal(cur_off, cur_t), f"{variant}/{mode}: currents"
        _assert_stats_equal(acc_off, acc_t, f"{variant}/{mode}")
        _assert_sums_back(acc_off, telem.per_tick, f"{variant}/{mode}")


def test_tick_series_percentiles_and_records():
    cfg = small_config(ARBITER_SCHEMES[0], NOC_SCHEMES[0])
    _, _, telem = _session(cfg).run(_t(_spikes(cfg)), telemetry="ticks")
    series = telem.series("events").numpy()
    pcts = telem.percentiles("events")
    assert pcts["p50"] == pytest.approx(float(np.percentile(series, 50)))
    assert pcts["p99"] == pytest.approx(float(np.percentile(series, 99)))
    records = telem.to_records()
    assert len(records) == TICKS
    assert records[0]["events"] == float(series[0])
    assert set(records[0]) == set(StepStats._fields)


# ---- per-core attribution --------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arb_scheme", ARBITER_SCHEMES)
def test_core_breakdowns_sum_to_tick_totals(arb_scheme, impl):
    cfg = dataclasses.replace(small_config(arb_scheme, "unicast"), impl=impl)
    _, _, telem = _session(cfg).run(_t(_spikes(cfg, p=0.1)),
                                    telemetry="cores")
    per_tick, per_core = telem.per_tick, telem.per_core
    assert per_core.events.shape == (TICKS, cfg.cores)
    assert torch.equal(per_core.events.sum(-1), per_tick.events)
    assert torch.equal(per_core.noc_hops.sum(-1), per_tick.noc_hops)
    assert torch.equal(per_core.encode_latency.amax(-1),
                       per_tick.encode_latency)
    torch.testing.assert_close(per_core.encode_energy.sum(-1),
                               per_tick.encode_energy, rtol=REL_TOL, atol=0)
    totals = telem.core_totals()
    assert totals.events.shape == (cfg.cores,)
    assert float(totals.events.sum()) == float(per_tick.events.sum())


@pytest.mark.parametrize("impl", IMPLS)
def test_chip_hops_attributed_only_on_multichip(impl):
    flat = dataclasses.replace(small_config(ARBITER_SCHEMES[0], "unicast"),
                               impl=impl)
    chips = dataclasses.replace(flat, chips=2)
    spikes = _t(_spikes(flat, p=0.1))
    _, _, telem_flat = _session(flat).run(spikes, telemetry="cores")
    _, acc, telem_chips = _session(chips).run(spikes, telemetry="cores")
    assert float(telem_flat.per_core.chip_hops.sum()) == 0.0
    assert torch.equal(telem_chips.per_core.chip_hops.sum(-1),
                       telem_chips.per_tick.chip_hops)
    assert float(acc.chip_hops) > 0, "a 2-chip random fabric crosses chips"
    assert float(telem_chips.per_core.chip_hops.sum()) == float(acc.chip_hops)


@pytest.mark.parametrize("impl", IMPLS)
def test_run_batched_telemetry_shapes_and_sums(impl):
    cfg = dataclasses.replace(small_config(ARBITER_SCHEMES[1],
                                           NOC_SCHEMES[2]), impl=impl)
    session = _session(cfg)
    spikes = _t(_spikes(cfg, lead=(3,), p=0.1))
    cur, acc, telem = session.run_batched(spikes, telemetry="ticks")
    assert cur.shape == spikes.shape
    assert telem.per_tick.events.shape == (3, TICKS)
    assert acc.events.shape == (3,)
    _assert_sums_back(acc, telem.per_tick, "batched")
    _, _, core = session.run_batched(spikes, telemetry="cores")
    assert core.per_core.events.shape == (3, TICKS, cfg.cores)
    assert torch.equal(core.per_core.events.sum(-1), core.per_tick.events)


# ---- against the JAX package ------------------------------------------------------


@pytest.mark.parametrize("chips", [1, 2])
@pytest.mark.parametrize("impl", IMPLS)
def test_telemetry_series_match_jax(impl, chips):
    cfg = dataclasses.replace(small_config("hier_tree", "multicast_tree",
                                           cores=4), impl=impl, chips=chips)
    jparams, tparams = _fabric(cfg, seed=4)
    spikes = _spikes(cfg, lead=(2,), p=0.08)
    spikes[:, 2] = True                      # an overflowing burst
    jsession = JInterface(cfg).compile(jparams)
    session = Interface(as_interface_config(cfg)).compile(tparams,
                                                          device="cpu")
    for mode in ("ticks", "cores"):
        jcur, jacc, jtel = jsession.run_batched(spikes, telemetry=mode)
        cur, acc, tel = session.run_batched(_t(spikes), telemetry=mode)
        assert (cur.numpy() == np.asarray(jcur)).all()
        _assert_like_jax(acc, jacc, f"{mode} accumulated")
        _assert_like_jax(tel.per_tick, jtel.per_tick, f"{mode} per tick")
        if mode == "cores":
            _assert_like_jax(tel.per_core, jtel.per_core, "per core")
        # one lane through run, the solo form
        jsolo = jsession.run(spikes[1], telemetry=mode)[2]
        solo = session.run(_t(spikes[1]), telemetry=mode)[2]
        _assert_like_jax(solo.per_tick, jsolo.per_tick, f"{mode} solo")


@pytest.mark.parametrize("impl", IMPLS)
def test_interface_tick_cores_matches_jax(impl):
    cfg = dataclasses.replace(small_config("token_ring", "broadcast"),
                              impl=impl, chips=2)
    jparams, tparams = _fabric(cfg, seed=2)
    spikes = _spikes(cfg, ticks=2, p=0.1)
    spikes[1] = True
    for t in range(2):
        jcur, jst, jcore = jpipeline.interface_tick(
            jparams, jnp.asarray(spikes[t]), cfg, telemetry="cores")
        cur, st, core = tpipeline.interface_tick(
            tparams, _t(spikes[t]), cfg, telemetry="cores")
        assert (cur.numpy() == np.asarray(jcur)).all()
        _assert_like_jax(st, jst, f"tick {t}")
        _assert_like_jax(core, jcore, f"tick {t} cores")
        assert isinstance(core, obs_telemetry.CoreStats)


# ---- validation -------------------------------------------------------------------


def test_unknown_telemetry_mode_raises():
    cfg = small_config(ARBITER_SCHEMES[0], NOC_SCHEMES[0])
    with pytest.raises(ValueError, match="unknown telemetry mode"):
        _session(cfg).run(_t(_spikes(cfg)), telemetry="bogus")
    with pytest.raises(ValueError, match="unknown telemetry mode"):
        obs_telemetry.validate_mode("per_neuron")
    with pytest.raises(ValueError, match="'off' or 'cores'"):
        tpipeline.interface_tick(_fabric(cfg)[1], _t(_spikes(cfg)[0]), cfg,
                                 telemetry="ticks")


def test_telemetry_rejects_sharded_runs():
    cfg = dataclasses.replace(small_config(ARBITER_SCHEMES[0], "unicast"),
                              chips=2)
    session = _session(cfg)
    with pytest.raises(CompositionError, match="shard"):
        session.run(_t(_spikes(cfg)), shard="chips", telemetry="ticks")
    assert issubclass(CompositionError, ValueError)
