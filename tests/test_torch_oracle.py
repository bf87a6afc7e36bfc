"""The port's oracle tick, arbiter simulator and AER codec against the
JAX package's.

* `core.arbiter`'s discrete-event simulator (`Arbiter.simulate`): grant
  times equal the JAX package's for the five schemes at n in {2, 4, 16,
  64, 256} on random, full-burst and empty request vectors, and for
  ``hier_ring`` at the non-square n = 32; its tick latency, the fallback
  where no closed form applies (``greedy_tree`` at n <= 2, ``hier_ring``
  at n = 32), equals the JAX `batched_tick_latency`, and an ``xla``
  session there equals the JAX session; ``pallas_sparse`` keeps the JAX
  package's refusal; the experiments of the `Arbiter` class;
* ``interface_tick(oracle=True)``, the dense tag sweep and the simulated
  arbiters, equals the JAX oracle on a sampled grid at chips 1 and 2
  (currents bitwise, `EXACT_FIELDS` exact, the rest within `REL_TOL`),
  with its per-core telemetry;
* `core.aer`: packed fields, the kernel's ordering oracle, encode and
  decode equal the JAX package's and round-trip.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aer as jaer
from repro.core import arbiter as jarb
from repro.core import fabric as jfabric
from repro.interface import Interface as JInterface
from repro.interface import pipeline as jpipeline
from repro_torch.core import aer as taer
from repro_torch.core import arbiter as tarb
from repro_torch.interface import Interface, InterfaceConfig, StepStats
from repro_torch.interface import pipeline as tpipeline
from repro_torch.interface.config import as_interface_config
from repro_torch.interface.types import params_from_numpy, random_connectivity
from tests.conformance.paths import (ARBITER_SCHEMES, EXACT_FIELDS, GRID,
                                     REL_TOL, small_config)


def _requests(n, seed):
    rng = np.random.default_rng(seed)
    times = np.floor(rng.random(n) * 2 * n).astype(np.float32)
    sparse = np.where(rng.random(n) < 0.4, times, np.inf).astype(np.float32)
    return (sparse, np.zeros(n, np.float32), np.full(n, np.inf, np.float32),
            np.where(rng.random(n) < 0.1, 0.0, np.inf).astype(np.float32))


def _assert_stats(got, want, label):
    for field in StepStats._fields:
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        if field in EXACT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f"{label}: {field}")
        else:
            np.testing.assert_allclose(a, b, rtol=REL_TOL, atol=0,
                                       err_msg=f"{label}: {field}")


# ---- the simulator -------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4, 16, 64, 256])
@pytest.mark.parametrize("scheme", ARBITER_SCHEMES)
def test_simulate_matches_jax(scheme, n):
    jsim = jarb.Arbiter(jarb.ArbiterConfig(scheme, n))
    sim = tarb.Arbiter(tarb.ArbiterConfig(scheme, n), device="cpu")
    reqs = _requests(n, n)
    for req in reqs:
        want = np.asarray(jsim.simulate(req))
        got = sim.simulate(torch.from_numpy(req.copy())).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{scheme}/{n}")
    # leading axes: every request vector in one call
    batch = sim.simulate(torch.from_numpy(np.stack(reqs)))
    for row, req in zip(batch.numpy(), reqs):
        np.testing.assert_array_equal(row, np.asarray(jsim.simulate(req)))
    assert float(sim.burst_latency()) == float(jsim.burst_latency())


@pytest.mark.parametrize("scheme", ARBITER_SCHEMES)
def test_simulate_at_a_non_square_n(scheme):
    jsim = jarb.Arbiter(jarb.ArbiterConfig(scheme, 32))
    sim = tarb.Arbiter(tarb.ArbiterConfig(scheme, 32), device="cpu")
    for req in _requests(32, 5):
        np.testing.assert_array_equal(
            sim.simulate(torch.from_numpy(req.copy())).numpy(),
            np.asarray(jsim.simulate(req)))


@pytest.mark.parametrize("scheme,n", [("greedy_tree", 2), ("hier_ring", 32),
                                      ("greedy_tree", 16)])
def test_tick_latency_fallback_matches_jax(scheme, n):
    cfg, jcfg = tarb.ArbiterConfig(scheme, n), jarb.ArbiterConfig(scheme, n)
    frames = np.random.default_rng(n).random((6, n)) < 0.4
    frames[1] = True
    frames[2] = False
    want = np.asarray(jarb.batched_tick_latency(jcfg, jnp.asarray(frames)))
    got = tarb.batched_tick_latency(cfg, torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(got, want)
    assert tarb.has_closed_form(cfg) == (n == 16)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_session_without_a_closed_form_runs_the_simulator(impl):
    cfg = InterfaceConfig(cores=2, neurons_per_core=32, cam_entries_per_core=8,
                          scheme="hier_ring", impl=impl)
    jcfg = jfabric.FabricConfig(cores=2, neurons_per_core=32,
                                cam_entries_per_core=8, scheme="hier_ring",
                                impl=impl)
    jparams = jfabric.random_connectivity(jax.random.PRNGKey(0), jcfg)
    spikes = np.random.default_rng(1).random((4, 2, 32)) < 0.3
    want = JInterface(jcfg).compile(jparams).run(spikes)
    got = Interface(cfg).compile(params_from_numpy(
        *(np.array(x) for x in jparams), device="cpu"),
        device="cpu").run(torch.from_numpy(spikes))
    assert (got[0].numpy() == np.asarray(want[0])).all()
    _assert_stats(got[1], want[1], "hier_ring n=32")
    with pytest.raises(ValueError, match="pallas_sparse"):
        Interface(dataclasses.replace(cfg, impl="pallas_sparse")).compile(
            random_connectivity(torch.Generator().manual_seed(0), cfg),
            device="cpu")


def test_arbiter_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    config = tarb.ArbiterConfig("hier_tree", 16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tarb.Arbiter(config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tarb.Arbiter(config, device="cuda")
    sim = tarb.Arbiter(config, device="cpu")
    assert sim.simulate(np.zeros(16, np.float32)).device.type == "cpu"
    assert sim.burst_latency().device.type == "cpu"


def test_sparse_event_latency_experiment():
    sim = tarb.Arbiter(tarb.ArbiterConfig("hier_tree", 64), device="cpu")
    gen = torch.Generator().manual_seed(3)
    a = sim.sparse_event_latency(gen, num_trials=16)
    b = sim.sparse_event_latency(torch.Generator().manual_seed(3),
                                 num_trials=16)
    assert float(a) == float(b)
    # an isolated event on an idle pipeline pays the sparse closed form
    assert float(a) == sim.theoretical_sparse_units()
    assert sim.theoretical_burst_units() == jarb.Arbiter(
        jarb.ArbiterConfig("hier_tree", 64)).theoretical_burst_units()


# ---- the oracle tick -------------------------------------------------------------


@pytest.mark.parametrize("chips", [1, 2])
@pytest.mark.parametrize("arb_scheme,noc_scheme", GRID[::3])
def test_oracle_tick_matches_jax(arb_scheme, noc_scheme, chips):
    cfg = dataclasses.replace(small_config(arb_scheme, noc_scheme),
                              chips=chips)
    jparams = jfabric.random_connectivity(jax.random.PRNGKey(11), cfg)
    params = params_from_numpy(*(np.array(x) for x in jparams), device="cpu")
    frames = np.random.default_rng(2).random((3, 4, 16)) < 0.25
    frames[1] = True
    for t, frame in enumerate(frames):
        jcur, jst, jcore = jpipeline.interface_tick(
            jparams, jnp.asarray(frame), cfg, oracle=True, telemetry="cores")
        cur, st, core = tpipeline.interface_tick(
            params, torch.from_numpy(frame), cfg, oracle=True,
            telemetry="cores")
        assert (cur.numpy() == np.asarray(jcur)).all(), f"tick {t}"
        _assert_stats(st, jst, f"tick {t}")
        for field in jcore._fields:
            np.testing.assert_allclose(getattr(core, field).numpy(),
                                       np.asarray(getattr(jcore, field)),
                                       rtol=REL_TOL, atol=0)
        # and the event tick of the port, bit for bit in currents
        ev_cur, ev_st = tpipeline.interface_tick(params,
                                                 torch.from_numpy(frame), cfg)
        assert torch.equal(ev_cur, cur)


def test_oracle_sweep_ignores_tags_outside_the_address_space():
    cfg = InterfaceConfig(cores=3, neurons_per_core=16, cam_entries_per_core=8)
    params = random_connectivity(torch.Generator().manual_seed(5), cfg)
    tags = params.tags.clone()
    tags[:, :2] = 1                         # 63 > 3 x 16 sources
    params = params._replace(tags=tags)
    frame = torch.ones((3, 16), dtype=torch.bool)
    cur, st = tpipeline.interface_tick(params, frame, cfg, oracle=True)
    ev_cur, ev_st = tpipeline.interface_tick(params, frame, cfg)
    assert torch.equal(cur, ev_cur)
    for a, b in zip(st, ev_st):
        assert float(a) == pytest.approx(float(b), rel=REL_TOL)


# ---- AER -------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ARBITER_SCHEMES)
def test_aer_encode_decode_matches_jax(scheme):
    raster = np.random.default_rng(4).random((5, 64)) < 0.2
    raster[2] = True
    raster[3] = False
    want = jaer.encode_raster(jnp.asarray(raster), scheme=scheme, tick_ns=250.0)
    got = taer.encode_raster(torch.from_numpy(raster), scheme=scheme,
                             tick_ns=250.0)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    back = taer.decode_events(got["addresses"], got["counts"], 64)
    np.testing.assert_array_equal(back.numpy(), raster)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jaer.decode_events(
        want["addresses"], want["counts"], 64)))


@pytest.mark.parametrize("n", [4, 16, 256, 1024])
def test_aer_addresses_round_trip_like_jax(n):
    addr = np.arange(n)
    want = np.asarray(jaer.pack_address(jnp.asarray(addr), n))
    got = taer.pack_address(torch.from_numpy(addr), n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(taer.unpack_address(got).numpy(), addr)
    spikes = np.random.default_rng(n).random(n) < 0.3
    w_order, w_count = jaer.hat_event_order(jnp.asarray(spikes))
    order, count = taer.hat_event_order(torch.from_numpy(spikes))
    np.testing.assert_array_equal(order.numpy(), np.asarray(w_order))
    assert int(count) == int(w_count)
