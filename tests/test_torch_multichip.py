"""The port's multi-chip fabric against the JAX package's.

Both packages get the JAX package's `random_connectivity` (carried with
`params_from_numpy`) and the same numpy spike streams.  Held here:

* every `HierTables` field equals the JAX one (dtype, shape, values) at
  chips = 2 and 4 under every NoC scheme;
* the port's six paths of the conformance contract (oracle, event,
  pallas, pallas_sparse, chips2, chips2_sharded) equal the JAX package's
  six on `tests/conformance/test_grid.py`'s sampled grid (two cells for
  each of the six traffic scenarios): currents bitwise,
  `EXACT_FIELDS` exact, the rest within `REL_TOL`, and among themselves
  under `paths.assert_conformant`'s rules;
* ``shard="chips"`` `run` / `run_batched`, masked and ``stats0``-seeded,
  equal the JAX package's, and a sharded stream in chunks gives the bits
  of one run;
* `ppa_report`'s hierarchy block equals the JAX package's at chips > 1;
* the legacy `core.fabric` shim and `InterfaceConfig.from_fabric` /
  ``fabric()``;
* ``TenantSpec(shard="chips")`` tenants served by both engines agree.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import traffic
from repro.core import fabric as jfabric
from repro.interface import Interface as JInterface
from repro.interface import pipeline as jpipeline
from repro.interface import report as jreport
from repro.serve import ServeEngine as JServeEngine
from repro.serve import TenantSpec as JTenantSpec
from repro_torch.core import fabric as tfabric
from repro_torch.interface import Interface, InterfaceConfig, StepStats
from repro_torch.interface import pipeline as tpipeline
from repro_torch.interface import report as treport
from repro_torch.interface.config import as_interface_config
from repro_torch.interface.session import CompositionError
from repro_torch.interface.types import params_from_numpy
from repro_torch.serve import ServeEngine, TenantSpec
from tests.conformance import paths

SEED = 17
SCENARIOS = traffic.scenario_names()


def _params(jparams):
    return params_from_numpy(*(np.asarray(x) for x in jparams), device="cpu")


def _setup(arb_scheme, noc_scheme, scenario="sparse_poisson", ticks=3,
           cores=4, chips=1, lead=()):
    jcfg = dataclasses.replace(
        paths.small_config(arb_scheme, noc_scheme, cores=cores), chips=chips)
    jparams = jfabric.random_connectivity(jax.random.PRNGKey(SEED), jcfg)
    key = jax.random.PRNGKey(SEED + 1)
    if lead:
        spikes = np.stack([np.asarray(traffic.generate(
            scenario, jax.random.fold_in(key, i), ticks, jcfg))
            for i in range(lead[0])])
    else:
        spikes = np.asarray(traffic.generate(scenario, SEED + 1, ticks, jcfg))
    return jcfg, jparams, spikes, as_interface_config(jcfg), _params(jparams)


def _assert_equal(got, want, label):
    """Port result against JAX under the conformance contract."""
    cur, st = got
    jcur, jst = want
    assert (cur.numpy() == np.asarray(jcur)).all(), f"{label}: currents"
    for field in StepStats._fields:
        a, b = getattr(st, field).numpy(), np.asarray(getattr(jst, field))
        if field in paths.EXACT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f"{label}: {field}")
        else:
            np.testing.assert_allclose(a, b, rtol=paths.REL_TOL, atol=0,
                                       err_msg=f"{label}: {field}")


# ---- the two-tier tables ---------------------------------------------------------


@pytest.mark.parametrize("noc", paths.NOC_SCHEMES)
@pytest.mark.parametrize("chips", [2, 4])
def test_hier_tables_equal_jax(chips, noc):
    jcfg, jparams, _, tcfg, tparams = _setup("hier_tree", noc, cores=8,
                                             chips=chips)
    want = jpipeline.build_tables(jparams, jcfg)
    got = tpipeline.build_tables(tparams, tcfg)
    assert type(got).__name__ == "HierTables"
    assert got._fields == want._fields
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        if isinstance(b, (str, int)):
            assert a == b, field
            continue
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a.numpy(), b, err_msg=field)
    assert int(got.chip_hops.sum()) > 0


def test_stale_tables_raise():
    _, _, spikes, tcfg, tparams = _setup("hier_tree", "unicast")
    two = dataclasses.replace(tcfg, chips=2)
    frame = torch.from_numpy(spikes[0].copy())
    flat = tpipeline.build_tables(tparams, tcfg)
    hier = tpipeline.build_tables(tparams, two)
    with pytest.raises(ValueError, match="chips=1"):
        tpipeline.interface_tick(tparams, frame, two, tables=flat)
    with pytest.raises(ValueError, match="chips=2"):
        tpipeline.interface_tick(tparams, frame, tcfg, tables=hier)
    with pytest.raises(ValueError, match="chips=1"):
        tpipeline.interface_tick(tparams, frame, two, tables=flat,
                                 oracle=True)


# ---- the six paths --------------------------------------------------------------


def _port_paths(tcfg, tparams, spikes):
    out = {}
    tables = tpipeline.build_tables(tparams, tcfg)
    acc, cur = StepStats.zeros(), []
    for t in range(spikes.shape[0]):
        c, st = tpipeline.interface_tick(tparams, spikes[t], tcfg, tables,
                                         oracle=True)
        acc, cur = acc.accumulate(st), cur + [c]
    out["oracle"] = torch.stack(cur), acc
    for name, impl in (("event", "xla"), ("pallas", "pallas"),
                       ("pallas_sparse", "pallas_sparse")):
        session = Interface(dataclasses.replace(tcfg, impl=impl)).compile(
            tparams, device="cpu")
        out[name] = session.run(spikes)
    session = Interface(dataclasses.replace(tcfg, chips=2)).compile(
        tparams, device="cpu")
    out["chips2"] = session.run(spikes)
    out["chips2_sharded"] = session.run(spikes, shard="chips")
    return out


def _sampled_cells(index, count=2):
    """`tests/conformance/test_grid.py`'s cells for a scenario."""
    return [paths.GRID[(count * index + 7 * k) % len(paths.GRID)]
            for k in range(count)]


@pytest.mark.parametrize("cell", [0, 1])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_six_paths_match_jax(scenario, cell):
    arb_scheme, noc_scheme = _sampled_cells(SCENARIOS.index(scenario))[cell]
    jcfg, jparams, spikes, tcfg, tparams = _setup(arb_scheme, noc_scheme,
                                                  scenario)
    want = paths.run_paths(jcfg, jparams, spikes)
    got = _port_paths(tcfg, tparams, torch.from_numpy(spikes.copy()))
    label = f"{scenario}/{arb_scheme}/{noc_scheme}"
    for name in paths.PATHS:
        _assert_equal(got[name], want[name], f"{label}[{name}]")
    # the port's paths among themselves, under the contract's own rules
    ref_cur, ref_st = got["oracle"]
    for name, (cur, st) in got.items():
        assert torch.equal(cur, ref_cur), f"{label}: {name} currents"
        for field in paths.PATH_INVARIANT_FIELDS:
            a, b = float(getattr(st, field)), float(getattr(ref_st, field))
            assert a == pytest.approx(b, rel=paths.REL_TOL), (name, field)
    for group in (paths.FLAT_PATHS, paths.CHIP_PATHS):
        for name in group[1:]:
            for field in paths.TRANSPORT_FIELDS:
                a = float(getattr(got[name][1], field))
                b = float(getattr(got[group[0]][1], field))
                assert a == pytest.approx(b, rel=paths.REL_TOL), (name, field)


# ---- shard="chips" ---------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_sparse"])
def test_sharded_runs_match_jax(impl):
    jcfg, jparams, spikes, tcfg, tparams = _setup(
        "token_ring", "multicast_tree", "hotspot_core", ticks=4, cores=8,
        chips=4, lead=(3,))
    jcfg = dataclasses.replace(jcfg, impl=impl)
    tcfg = dataclasses.replace(tcfg, impl=impl)
    jsession = JInterface(jcfg).compile(jparams)
    session = Interface(tcfg).compile(tparams, device="cpu")
    tspikes = torch.from_numpy(spikes.copy())
    _assert_equal(session.run(tspikes[0], shard="chips"),
                  jsession.run(spikes[0], shard="chips"), "run")
    _assert_equal(session.run_batched(tspikes, shard="chips"),
                  jsession.run_batched(spikes, shard="chips"), "run_batched")
    mask = np.ones(spikes.shape[:2], bool)
    mask[1, 2:] = False
    mask[2] = False
    seed = jsession.run_batched(spikes, mask=mask)[1]
    _assert_equal(
        session.run_batched(tspikes, shard="chips", mask=mask,
                            stats0=StepStats(*(torch.from_numpy(
                                np.array(f)) for f in seed))),
        jsession.run_batched(spikes, shard="chips", mask=mask, stats0=seed),
        "masked, seeded")
    # the sharded body equals the unsharded session bit for bit here
    flat = session.run_batched(tspikes)
    sharded = session.run_batched(tspikes, shard="chips")
    assert torch.equal(flat[0], sharded[0])
    for a, b in zip(flat[1], sharded[1]):
        assert torch.equal(a, b)


def test_sharded_stream_in_chunks_gives_one_run():
    _, _, spikes, tcfg, tparams = _setup("hier_tree", "unicast",
                                         "synchronized_burst", ticks=6,
                                         cores=8, chips=2)
    session = Interface(tcfg).compile(tparams, device="cpu")
    tspikes = torch.from_numpy(spikes.copy())
    whole_cur, whole = session.run(tspikes, shard="chips",
                                   mask=np.ones(6, bool))
    acc, parts = None, []
    for lo in (0, 2, 5):
        hi = {0: 2, 2: 5, 5: 6}[lo]
        cur, acc = session.run(tspikes[lo:hi], shard="chips",
                               mask=np.ones(hi - lo, bool), stats0=acc)
        parts.append(cur)
    assert torch.equal(torch.cat(parts), whole_cur)
    for a, b in zip(acc, whole):
        assert torch.equal(a, b)


def test_shard_modes_and_compositions():
    _, _, spikes, tcfg, tparams = _setup("hier_tree", "unicast")
    tspikes = torch.from_numpy(spikes.copy())
    one = Interface(tcfg).compile(tparams, device="cpu")
    # at one chip shard="chips" is the flat run, telemetry included
    assert torch.equal(one.run(tspikes, shard="chips")[0], one.run(tspikes)[0])
    assert len(one.run(tspikes, shard="chips", telemetry="ticks")) == 3
    two = Interface(dataclasses.replace(tcfg, chips=2)).compile(
        tparams, device="cpu")
    with pytest.raises(CompositionError, match="shard"):
        two.run(tspikes, shard="chips", telemetry="ticks")
    with pytest.raises(CompositionError, match="telemetry"):
        two.run(tspikes, shard="chips", telemetry="ticks",
                mask=np.ones(3, bool))
    with pytest.raises(ValueError, match="unknown shard"):
        two.run(tspikes, shard="dies")


# ---- report, legacy shim -------------------------------------------------------


@pytest.mark.parametrize("chips", [2, 4])
def test_ppa_report_hierarchy_matches_jax(chips):
    jcfg = dataclasses.replace(paths.small_config("hier_ring", "unicast",
                                                  cores=8), chips=chips)
    want = jreport.ppa_report(jcfg)
    got = treport.ppa_report(as_interface_config(jcfg))
    assert set(got) == set(want)
    for block in ("config", "noc", "hierarchy"):
        for key, value in want[block].items():
            b = tuple(value) if isinstance(value, (list, tuple)) else value
            a = got[block][key]
            a = tuple(a) if isinstance(a, (list, tuple)) else a
            assert a == pytest.approx(b), (block, key)
    assert got["hierarchy"]["chips"] == chips


def test_fabric_shim_and_config_lift():
    jcfg, jparams, spikes, _, tparams = _setup("hier_tree", "multicast_tree",
                                               cores=8, chips=2)
    cfg = tfabric.FabricConfig(cores=8, neurons_per_core=16,
                               cam_entries_per_core=32, chips=2,
                               noc=as_interface_config(jcfg).noc)
    lifted = InterfaceConfig.from_fabric(cfg)
    assert lifted == as_interface_config(jcfg)
    assert lifted.fabric() == cfg and lifted.fabric().tag_bits == cfg.tag_bits
    with pytest.raises(ValueError, match="conflicts"):
        tfabric.FabricConfig(cores=4, cam_entries_per_core=8,
                             cam=lifted.cam)
    tables = tfabric.noc_tables(tparams, cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jfabric.step(jparams, spikes[0], jcfg)
        with pytest.warns(DeprecationWarning):
            got = tfabric.step(tparams, torch.from_numpy(spikes[0].copy()),
                               cfg, tables)
    _assert_equal(got, want, "fabric.step")
    assert tfabric.interface_area_um2(cfg) == pytest.approx(
        jfabric.interface_area_um2(jcfg))


# ---- the serving tier: shard="chips" tenants ------------------------------------


def test_sharded_tenants_served_by_both_engines_agree():
    cfg = dataclasses.replace(paths.small_config("hier_tree", "unicast",
                                                 cores=8), chips=2)
    jengine = JServeEngine(flush_ticks=4, keep_currents=True)
    engine = ServeEngine(flush_ticks=4, keep_currents=True, device="cpu")
    jparams = jfabric.random_connectivity(jax.random.PRNGKey(3), cfg)
    frames = {f"t{i}": np.asarray(traffic.generate(
        name, 40 + i, 6 + i, cfg)) for i, name in enumerate(
            ("sparse_poisson", "hotspot_core"))}
    for i, name in enumerate(frames):
        jspec = JTenantSpec(name, cfg, seed=i, shard="chips")
        spec = TenantSpec(name, cfg, seed=i, shard="chips")
        jengine.register(jspec, params=jparams if i == 0 else None)
        engine.register(spec, params=_params(jparams) if i == 0 else None)
    assert len(engine.groups) == 1
    group = next(iter(engine.groups.values()))
    assert group.shard == "chips" and group.key[-1] == "chips"
    for name, f in frames.items():
        jengine.submit(name, f)
        engine.submit(name, f)
    jengine.drain()
    engine.drain()
    for name, f in frames.items():
        np.testing.assert_array_equal(engine.currents(name),
                                      np.asarray(jengine.currents(name)))
        got, want = engine.tenant_stats(name), jengine.tenant_stats(name)
        for field in StepStats._fields:
            np.testing.assert_allclose(
                float(getattr(got, field)), float(getattr(want, field)),
                rtol=paths.REL_TOL, atol=0, err_msg=f"{name}: {field}")
        # and the port's solo sharded run, bit for bit
        solo = Interface(as_interface_config(cfg)).compile(
            _params(jparams), device="cpu").run(torch.from_numpy(f.copy()),
                                                shard="chips")
        np.testing.assert_array_equal(engine.currents(name), solo[0].numpy())
