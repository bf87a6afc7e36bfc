"""The port's fabric `FaultModel` (`repro_torch.ft.faults`) against the JAX
package's.

torch cannot reproduce ``jax.random``'s threefry bits, so the port draws
its corrupted slots from a seeded `torch.Generator` and its drop masks
from a counter-based hash.  What is held to the JAX package:

* a model with dead cores only (no random draw) gives the JAX package's
  faulted session end to end under all three impls and at chips 1 and 2:
  currents bitwise, `EXACT_FIELDS` exact, the rest within `REL_TOL`;
* params perturbed by the JAX model (`apply_params`) and streams faulted
  by it (`apply_spikes`), fed to the port's clean session, give the JAX
  faulted session: the port's session runs any faulted fabric;
* the validation errors, `describe`, `is_null` and `perturbs_spikes`.

What the port's own model keeps, as the JAX one does: a stream run in
chunks with ``fault_tick0`` gives one run's bits; lanes draw independent
drops; exactly ``corrupt_cam_entries`` distinct slots; corruption before
dead-core invalidation ("dead means dead"); ``drop_rate=1`` silence; and
a drop share within a binomial bound.  Faulted tenants get their own
serving group and equal their faulted solo runs, under both engines.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fabric as jfabric
from repro.ft import FaultModel as JFaultModel
from repro.interface import Interface as JInterface
from repro.serve import ServeEngine as JServeEngine
from repro.serve import TenantSpec as JTenantSpec
from repro_torch.ft import FaultModel
from repro_torch.ft import faults as tfaults
from repro_torch.interface import Interface, StepStats
from repro_torch.interface.config import as_interface_config
from repro_torch.interface.types import params_from_numpy
from repro_torch.serve import ServeEngine, TenantSpec
from tests.conformance.paths import EXACT_FIELDS, REL_TOL, small_config

TICKS = 12
IMPLS = ("xla", "pallas", "pallas_sparse")


def _fabric(cfg, seed=0):
    jparams = jfabric.random_connectivity(jax.random.PRNGKey(seed), cfg)
    return jparams, _to_port(jparams)


def _to_port(jparams):
    return params_from_numpy(*(np.array(x) for x in jparams), device="cpu")


def _spikes(cfg, ticks=TICKS, seed=3, lead=(), p=0.3):
    shape = lead + (ticks, cfg.cores, cfg.neurons_per_core)
    return np.array(jax.random.bernoulli(jax.random.PRNGKey(seed), p, shape))


def _session(cfg, params, fault=None):
    return Interface(as_interface_config(cfg)).compile(params, device="cpu",
                                                       fault=fault)


def _assert_like_jax(got, want, label):
    cur, st = got
    jcur, jst = want
    assert (cur.numpy() == np.asarray(jcur)).all(), f"{label}: currents"
    for field in StepStats._fields:
        a, b = getattr(st, field).numpy(), np.asarray(getattr(jst, field))
        if field in EXACT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f"{label}: {field}")
        else:
            np.testing.assert_allclose(a, b, rtol=REL_TOL, atol=0,
                                       err_msg=f"{label}: {field}")


# ---- validation ----------------------------------------------------------------


@pytest.mark.parametrize("kwargs,match", [
    ({"drop_rate": 1.5}, "drop_rate"),
    ({"dead_cores": (1, 1)}, "duplicates"),
    ({"dead_cores": (-1,)}, "non-negative"),
    ({"corrupt_cam_entries": -2}, "corrupt_cam_entries"),
])
def test_fault_model_validation_matches_jax(kwargs, match):
    with pytest.raises(ValueError) as want:
        JFaultModel(**kwargs)
    with pytest.raises(ValueError, match=match) as got:
        FaultModel(**kwargs)
    assert str(got.value) == str(want.value)


def test_fault_model_fits_config_like_jax():
    cfg = small_config("binary_tree", "broadcast")
    for kwargs in ({"dead_cores": (cfg.cores,)},
                   {"corrupt_cam_entries": 10 ** 6}):
        with pytest.raises(ValueError) as want:
            JFaultModel(**kwargs).validate(cfg)
        with pytest.raises(ValueError) as got:
            FaultModel(**kwargs).validate(as_interface_config(cfg))
        assert str(got.value) == str(want.value)
    kwargs = dict(dead_cores=(2, 0), drop_rate=0.25, corrupt_cam_entries=2,
                  seed=4)
    model, jmodel = FaultModel(**kwargs), JFaultModel(**kwargs)
    model.validate(cfg)
    assert model.describe() == jmodel.describe()
    assert (model.is_null, model.perturbs_spikes) == (jmodel.is_null,
                                                      jmodel.perturbs_spikes)
    assert FaultModel().is_null and not FaultModel().perturbs_spikes
    assert not FaultModel(corrupt_cam_entries=3).perturbs_spikes


def test_null_fault_compiles_as_fault_free():
    cfg = small_config("binary_tree", "multicast_tree")
    _, params = _fabric(cfg)
    sp = torch.from_numpy(_spikes(cfg))
    clean = _session(cfg, params)
    nulled = _session(cfg, params, FaultModel())
    assert nulled.fault is None
    a, b = clean.run(sp), nulled.run(sp)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    with pytest.raises(ValueError, match="fault_tick0"):
        nulled.run(sp, fault_tick0=4)


# ---- against the JAX package ----------------------------------------------------


@pytest.mark.parametrize("chips", [1, 2])
@pytest.mark.parametrize("impl", IMPLS)
def test_dead_cores_match_jax(impl, chips):
    cfg = dataclasses.replace(small_config("hier_tree", "unicast"),
                              impl=impl, chips=chips)
    jparams, params = _fabric(cfg, seed=1)
    sp = _spikes(cfg, lead=(2,), p=0.1)
    sp[:, 3] = True
    kwargs = dict(dead_cores=(1, 2))
    jsession = JInterface(cfg).compile(jparams, fault=JFaultModel(**kwargs))
    session = _session(cfg, params, FaultModel(**kwargs))
    _assert_like_jax(session.run(torch.from_numpy(sp[0]), fault_tick0=5),
                     jsession.run(sp[0], fault_tick0=5), "run")
    _assert_like_jax(session.run_batched(torch.from_numpy(sp)),
                     jsession.run_batched(sp), "run_batched")
    for field in ("tags", "valid"):
        np.testing.assert_array_equal(
            getattr(session.params, field).numpy(),
            np.asarray(getattr(jsession.params, field)))


@pytest.mark.parametrize("impl", IMPLS)
def test_jax_faulted_inputs_through_the_clean_port_match_jax(impl):
    """The JAX model's perturbed params and faulted stream, fed to the
    port's clean session, give the JAX faulted session."""
    cfg = dataclasses.replace(small_config("token_ring", "multicast_tree"),
                              impl=impl)
    jparams, _ = _fabric(cfg, seed=2)
    fault = JFaultModel(dead_cores=(3,), drop_rate=0.2,
                        corrupt_cam_entries=9, seed=7)
    sp = _spikes(cfg)
    want = JInterface(cfg).compile(jparams, fault=fault).run(sp,
                                                             fault_tick0=4)
    perturbed = _to_port(fault.apply_params(jparams, cfg))
    faulted = np.array(fault.apply_spikes(jnp.asarray(sp), tick0=4,
                                            lane=0))
    got = _session(cfg, perturbed).run(torch.from_numpy(faulted))
    _assert_like_jax(got, want, "faulted inputs")


# ---- the port's own model ----------------------------------------------------------


def test_dead_core_emits_and_receives_nothing():
    cfg = small_config("binary_tree", "multicast_tree")
    _, params = _fabric(cfg)
    sp = torch.from_numpy(_spikes(cfg))
    cur_clean, acc_clean = _session(cfg, params).run(sp)
    cur, acc = _session(cfg, params, FaultModel(dead_cores=(1,))).run(sp)
    assert float(cur[:, 1].abs().max()) == 0.0, "dead core received current"
    assert float(acc.events) <= float(acc_clean.events)
    assert bool(cur.isfinite().all())


@pytest.mark.parametrize("impl", IMPLS)
def test_drop_rate_one_silences_the_fabric(impl):
    cfg = dataclasses.replace(small_config("binary_tree", "broadcast"),
                              impl=impl)
    session = _session(cfg, _fabric(cfg)[1], FaultModel(drop_rate=1.0))
    cur, acc = session.run(torch.from_numpy(_spikes(cfg)))
    assert float(cur.abs().max()) == 0.0
    assert all(float(f) == 0.0 for f in acc)


@pytest.mark.parametrize("impl", IMPLS)
def test_chunked_faults_give_one_run(impl):
    cfg = dataclasses.replace(small_config("hier_tree", "multicast_tree"),
                              impl=impl)
    _, params = _fabric(cfg)
    fault = FaultModel(dead_cores=(3,), drop_rate=0.4,
                       corrupt_cam_entries=5, seed=5)
    session = _session(cfg, params, fault)
    sp = torch.from_numpy(_spikes(cfg))
    cur_full, acc_full = session.run(sp, mask=np.ones(TICKS, bool))
    acc, parts = None, []
    for lo, hi in ((0, 5), (5, 6), (6, TICKS)):
        cur, acc = session.run(sp[lo:hi], fault_tick0=lo,
                               mask=np.ones(hi - lo, bool), stats0=acc)
        parts.append(cur)
    assert torch.equal(torch.cat(parts), cur_full)
    assert all(torch.equal(a, b) for a, b in zip(acc, acc_full))
    _, acc_clean = _session(cfg, params).run(sp)
    assert float(acc_full.events) < float(acc_clean.events)


def test_lanes_draw_independent_drop_streams():
    cfg = small_config("binary_tree", "broadcast")
    session = _session(cfg, _fabric(cfg)[1], FaultModel(drop_rate=0.5,
                                                        seed=2))
    one = torch.from_numpy(_spikes(cfg, seed=7))
    cur, acc = session.run_batched(torch.stack([one, one, one]))
    assert len({float(e) for e in acc.events}) > 1, \
        "identical lanes drew identical faults"
    cur_solo, _ = session.run(one, fault_tick0=0)
    assert torch.equal(cur[0], cur_solo)
    # per-lane offsets: lane 1 at offset 7 is lane 1 of a batch at 7
    shifted, _ = session.run_batched(torch.stack([one, one]),
                                     fault_tick0=np.array([0, 7]))
    again, _ = session.run_batched(torch.stack([one, one]), fault_tick0=7)
    assert torch.equal(shifted[1], again[1])
    assert not torch.equal(shifted[0], again[0])


def test_fault_tick0_rejected_on_clean_sessions():
    cfg = small_config("binary_tree", "broadcast")
    _, params = _fabric(cfg)
    sp = torch.from_numpy(_spikes(cfg))
    with pytest.raises(ValueError, match="fault_tick0"):
        _session(cfg, params).run(sp, fault_tick0=0)
    corrupted = _session(cfg, params, FaultModel(corrupt_cam_entries=4))
    with pytest.raises(ValueError, match="fault_tick0"):
        corrupted.run(sp, fault_tick0=0)


def test_corrupted_slots_exact_distinct_and_deterministic():
    cfg = small_config("binary_tree", "multicast_tree")
    _, params = _fabric(cfg)
    tcfg = as_interface_config(cfg)
    fault = FaultModel(corrupt_cam_entries=40, seed=9)
    a = fault.apply_params(params, tcfg)
    b = fault.apply_params(params, tcfg)
    assert torch.equal(a.tags, b.tags)
    changed = (a.tags != params.tags).any(-1)
    # a redrawn tag may equal the old one; never more than the count
    assert 0 < int(changed.sum()) <= 40
    gen = torch.Generator().manual_seed(9)
    slots = torch.randperm(params.valid.numel(), generator=gen)[:40]
    assert len(set(slots.tolist())) == 40
    assert set(changed.reshape(-1).nonzero()[:, 0].tolist()) <= set(
        slots.tolist())
    assert torch.equal(a.valid, params.valid)
    cur, _ = _session(cfg, params, fault).run(torch.from_numpy(_spikes(cfg)))
    assert bool(cur.isfinite().all())


def test_corruption_comes_before_dead_core_invalidation():
    """Dead means dead: a corrupted slot on a dead core stays invalid."""
    cfg = small_config("binary_tree", "multicast_tree")
    _, params = _fabric(cfg)
    tcfg = as_interface_config(cfg)
    every = cfg.cores * cfg.cam_entries_per_core
    both = FaultModel(dead_cores=(2,), corrupt_cam_entries=every, seed=1)
    out = both.apply_params(params, tcfg)
    assert not bool(out.valid[2].any())
    assert torch.equal(out.tags, FaultModel(
        corrupt_cam_entries=every, seed=1).apply_params(params, tcfg).tags)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_drop_share_within_binomial_bound(rate):
    """Over n = 64 x 4 x 256 draws the kept share lies within 5 standard
    deviations of 1 - rate, and keeps the hash's granularity of 2^-24."""
    frames = torch.ones((64, 4, 256), dtype=torch.bool)
    kept = FaultModel(drop_rate=rate, seed=3).apply_spikes(frames, tick0=11)
    n = frames.numel()
    share = float(kept.sum()) / n
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(share - (1 - rate)) < 5 * sigma, (share, sigma)
    assert tfaults.keep_threshold(rate) == round((1 - rate) * 2 ** 24)
    # the draw is the same for any split of the ticks
    parts = [FaultModel(drop_rate=rate, seed=3).apply_spikes(
        frames[lo:hi], tick0=11 + lo) for lo, hi in ((0, 10), (10, 64))]
    assert torch.equal(torch.cat(parts), kept)


# ---- the serving tier ----------------------------------------------------------------


def test_faulted_tenants_get_their_own_groups_in_both_engines():
    cfg = small_config("binary_tree", "multicast_tree")
    jparams = jfabric.random_connectivity(jax.random.PRNGKey(0), cfg)
    dead = dict(dead_cores=(1,))
    lossy = FaultModel(drop_rate=0.3, seed=7)
    flush = 4
    jengine = JServeEngine(flush_ticks=flush, flush_deadline_s=0.0,
                           keep_currents=True)
    engine = ServeEngine(flush_ticks=flush, flush_deadline_s=0.0,
                         keep_currents=True, device="cpu")
    streams = {"clean": _spikes(cfg, ticks=8, seed=1),
               "dead": _spikes(cfg, ticks=8, seed=2)}
    for i, name in enumerate(streams):
        jfault = JFaultModel(**dead) if name == "dead" else None
        fault = FaultModel(**dead) if name == "dead" else None
        jengine.register(JTenantSpec(name, cfg, seed=i, fault=jfault),
                         params=jparams)
        engine.register(TenantSpec(name, cfg, seed=i, fault=fault),
                        params=_to_port(jparams))
    engine.register(TenantSpec("lossy", cfg, seed=5, fault=lossy),
                    params=_to_port(jparams))
    assert len(engine.groups) == 3, "the fault is part of the compat key"
    streams["lossy"] = _spikes(cfg, ticks=8, seed=3)
    for name, f in streams.items():
        if name != "lossy":
            jengine.submit(name, f)
        engine.submit(name, f)
    jengine.drain()
    engine.drain()
    for name in ("clean", "dead"):
        np.testing.assert_array_equal(engine.currents(name),
                                      np.asarray(jengine.currents(name)))
        got, want = engine.tenant_stats(name), jengine.tenant_stats(name)
        for field in StepStats._fields:
            np.testing.assert_allclose(float(getattr(got, field)),
                                       float(getattr(want, field)),
                                       rtol=REL_TOL, atol=0)
    solo = _session(cfg, _to_port(jparams), lossy)
    cur, acc = solo.run(torch.from_numpy(streams["lossy"]), fault_tick0=0)
    np.testing.assert_array_equal(engine.currents("lossy"), cur.numpy())
    group = engine._group_of("lossy")
    np.testing.assert_array_equal(group.fault_tick0()[:1], [8])
    rec = next(r for r in engine.serve_report() if r.get("tenant") == "lossy")
    assert rec["fault"] == lossy.describe()
    with pytest.raises(ValueError, match="FaultModel"):
        TenantSpec("bad", cfg, fault=object())
