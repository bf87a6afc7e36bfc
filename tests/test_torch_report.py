"""The port's CAM functional half, `ppa_report` and neuron placement
against the JAX package's.

Routing state comes from the JAX package's `random_connectivity` (or its
`clustered_connectivity`), carried across as numpy arrays; queries are
numpy arrays made from a seed.  Tolerances, stated where they are used:

- `search`, `first_match`, `mismatch_bit_counts`, `CamArray`: exact;
- `search_energy_for_queries`: within 1e-6 relative (float32 sums in
  another order); `search_energy`, `area_um2`, `energy_saving`,
  `cycle_improvement`: Python floats, exact;
- `ppa_report`: key by key, floats within 1e-6 relative, the rest exact;
- placement (permutations, `traffic_cost`, `cam_search_count`, the
  tables of `apply_placement` and `clustered_connectivity`): exact.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cam as jcam
from repro.core import fabric
from repro.interface import Interface as JInterface
from repro.interface import report as jreport
from repro.noc import placement as jplace
from repro_torch.core import cam as tcam
from repro_torch.core import ppa
from repro_torch.interface import Interface, InterfaceConfig, ppa_report
from repro_torch.interface import config as tconfig
from repro_torch.interface import report as treport
from repro_torch.interface.types import params_from_numpy
from repro_torch.noc import placement as tplace
from tests.conformance import paths

VARIANTS = ("conventional", "cscd", "cscd+fb", "cscd+ss", "cscd+fb+ss")
SAMPLED_GRID = (("binary_tree", "broadcast"), ("greedy_tree", "unicast"),
                ("token_ring", "multicast_tree"), ("hier_ring", "broadcast"),
                ("hier_tree", "unicast"), ("hier_tree", "multicast_tree"))


def _setup(arb_scheme, noc_scheme, seed=3, **shape):
    jcfg = paths.small_config(arb_scheme, noc_scheme, **shape)
    jparams = fabric.random_connectivity(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(*(np.asarray(x) for x in jparams),
                                device="cpu")
    return jcfg, jparams, tconfig.as_interface_config(jcfg), tparams


def _queries(jcfg, jparams, seed):
    """(Q, bits) int32 queries: each core's own stored tags (matches,
    duplicates included), random addresses and non-address digits."""
    rng = np.random.default_rng(seed)
    tags = np.asarray(jparams.tags).reshape(-1, jcfg.tag_bits)
    own = tags[rng.integers(0, len(tags), 12)]
    rand = rng.integers(0, 2, (12, jcfg.tag_bits))
    odd = rand.copy()
    odd[:3, 0] = 2
    return np.concatenate([own, rand, odd[:3]]).astype(np.int32)


# ---- the CAM's functional half ------------------------------------------------


@pytest.mark.parametrize("arb_scheme,noc_scheme", SAMPLED_GRID)
def test_cam_search_matches_jax(arb_scheme, noc_scheme):
    index = SAMPLED_GRID.index((arb_scheme, noc_scheme))
    jcfg, jparams, _, tparams = _setup(arb_scheme, noc_scheme, seed=index)
    queries = _queries(jcfg, jparams, seed=index)
    for core in range(jcfg.cores):
        jtags, jvalid = jparams.tags[core], jparams.valid[core]
        ttags, tvalid = tparams.tags[core], tparams.valid[core]
        for q in (queries, queries[0], queries[-1]):
            args = (jnp.asarray(q), torch.from_numpy(q))
            for fn in ("search", "first_match"):
                want = np.asarray(getattr(jcam, fn)(jtags, jvalid, args[0]))
                got = getattr(tcam, fn)(ttags, tvalid, args[1]).numpy()
                assert got.shape == want.shape, fn
                np.testing.assert_array_equal(got, want, err_msg=fn)
            np.testing.assert_array_equal(
                tcam.mismatch_bit_counts(ttags, args[1]).numpy(),
                np.asarray(jcam.mismatch_bit_counts(jtags, args[0])))
        for variant in VARIANTS:
            jc = jcam.CamConfig(jcfg.cam.entries, variant_name=variant)
            tc = tcam.CamConfig(jcfg.cam.entries, variant_name=variant)
            want = float(jcam.search_energy_for_queries(
                jc, jtags, jvalid, jnp.asarray(queries)))
            got = tcam.search_energy_for_queries(tc, ttags, tvalid,
                                                 torch.from_numpy(queries))
            assert got.dtype == torch.float32 and got.ndim == 0
            assert float(got) == pytest.approx(want, rel=1e-6, abs=0)
    # the searches found something and missed something
    m = tcam.search(tparams.tags[0], tparams.valid[0],
                    torch.from_numpy(queries))
    assert bool(m.any()) and not bool(m.all())


def test_cam_array_matches_jax():
    bits, entries = 11, 16
    rng = np.random.default_rng(5)
    jarr = jcam.CamArray(jcam.CamConfig(entries))
    tarr = tcam.CamArray(tcam.CamConfig(entries), device="cpu")
    writes = [(int(e), rng.integers(0, 2, bits)) for e in
              rng.integers(0, entries, 9)]
    writes.append((writes[0][0] + 1 if writes[0][0] + 1 < entries else 0,
                   writes[1][1]))                  # one tag in two entries
    for entry, tag in writes:
        before = tarr.tags.clone()
        jarr, tarr = jarr.write(entry, tag), tarr.write(entry, tag)
        assert not torch.equal(before, tarr.tags) or bool(
            (before[entry] == torch.from_numpy(tag)).all())
    np.testing.assert_array_equal(tarr.tags.numpy(), np.asarray(jarr.tags))
    np.testing.assert_array_equal(tarr.valid.numpy(), np.asarray(jarr.valid))
    queries = np.stack([t for _, t in writes]
                       + [rng.integers(0, 2, bits) for _ in range(4)])
    np.testing.assert_array_equal(
        tarr.search(torch.from_numpy(queries)).numpy(),
        np.asarray(jarr.search(jnp.asarray(queries))))
    np.testing.assert_array_equal(
        tarr.first_match(torch.from_numpy(queries)).numpy(),
        np.asarray(jarr.first_match(jnp.asarray(queries))))
    # write returns a new array and leaves the old one as it was
    empty = tcam.CamArray(tcam.CamConfig(entries), device="cpu")
    empty.write(3, np.ones(bits, np.int32))
    assert not bool(empty.valid.any())


def test_cam_array_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcam.CamArray(tcam.CamConfig(16))


@pytest.mark.parametrize("entries", [16, 64, 512])
@pytest.mark.parametrize("variant", VARIANTS)
def test_cam_ppa_numbers_match_jax(variant, entries):
    jc = jcam.CamConfig(entries, variant_name=variant)
    tc = tcam.CamConfig(entries, variant_name=variant)
    for comp in ((1.0, 511.0), (float(entries), 0.0), (0.0, float(entries)),
                 (2.5, 7.25)):
        assert tcam.search_energy(tc, *comp) == jcam.search_energy(jc, *comp)
    assert tcam.area_um2(tc) == jcam.area_um2(jc)
    assert tcam.cycle_improvement(entries) == jcam.cycle_improvement(entries)
    for case in ("all_match", "all_mismatch", "random"):
        assert (tcam.energy_saving(case, entries)
                == jcam.energy_saving(case, entries))


def test_cam_model_errors_match_jax():
    for mod in (jcam, tcam):
        bad = mod.CamConfig(16, cscd=False, feedback=True, speculative=False)
        with pytest.raises(ValueError, match="require the CSCD"):
            mod.search_energy(bad, 1.0, 15.0)
        with pytest.raises(ValueError, match="sideways"):
            mod.energy_saving("sideways")
    # the paper's savings, as the JAX package's model states them
    assert tcam.energy_saving("all_match") == pytest.approx(0.358, abs=1e-6)
    assert tcam.cycle_improvement(512) == pytest.approx(0.404, abs=1e-6)


# ---- ppa_report ----------------------------------------------------------------


def _assert_report_equal(got, want, label):
    assert got.keys() == want.keys(), label
    for section in want:
        assert got[section].keys() == want[section].keys(), (label, section)
        for key, b in want[section].items():
            a = got[section][key]
            where = f"{label}: {section}.{key}"
            if isinstance(b, float):
                assert isinstance(a, float), where
                assert math.isclose(a, b, rel_tol=1e-6, abs_tol=0), where
            else:
                assert type(a) is type(b) and a == b, where


@pytest.mark.parametrize("shape", [dict(), dict(cores=16, n=256,
                                                 entries=512),
                                   dict(cores=6, n=64, entries=24)])
@pytest.mark.parametrize("arb_scheme,noc_scheme", paths.GRID)
def test_ppa_report_matches_jax(arb_scheme, noc_scheme, shape):
    jcfg = paths.small_config(arb_scheme, noc_scheme, **shape)
    tcfg = tconfig.as_interface_config(jcfg)
    if arb_scheme == "greedy_tree":
        # the paper gives no greedy-tree burst ns: both packages refuse
        with pytest.raises(ValueError) as jerr:
            jreport.ppa_report(jcfg)
        with pytest.raises(ValueError) as terr:
            ppa_report(tcfg)
        assert str(terr.value) == str(jerr.value)
        return
    want = jreport.ppa_report(jcfg)
    _assert_report_equal(ppa_report(tcfg), want, f"{arb_scheme}/{noc_scheme}")
    _assert_report_equal({"area": treport.interface_area_um2(tcfg)},
                         {"area": jreport.interface_area_um2(jcfg)}, "area")
    _assert_report_equal(Interface(tcfg).ppa_report(), want, "Interface")


def test_session_ppa_report_and_refusals():
    jcfg, jparams, tcfg, tparams = _setup("hier_tree", "multicast_tree")
    session = Interface(tcfg).compile(tparams, device="cpu")
    _assert_report_equal(session.ppa_report(),
                         JInterface(jcfg).compile(jparams).ppa_report(),
                         "session")
    # an arbiter without closed forms reports None, as in JAX
    assert treport._closed_form(ppa.area_units, "custom", 16) is None
    assert jreport._closed_form(ppa.area_units, "custom", 16) is None
    # at chips > 1 the report covers each chip's mesh and the chip tier
    two = dataclasses.replace(paths.small_config("hier_tree", "multicast_tree",
                                                 cores=8), chips=2)
    _assert_report_equal(ppa_report(tconfig.as_interface_config(two)),
                         jreport.ppa_report(two), "chips=2")


# ---- placement -----------------------------------------------------------------


def _assert_params_equal(got, want):
    for name, a, b in zip(("tags", "valid", "weights", "targets"), got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def _placements(mod, a, cfg, seed):
    total = cfg.cores * cfg.neurons_per_core
    return {"identity": mod.identity_placement(total),
            "random": mod.random_placement(seed, total),
            "greedy": mod.greedy_overlap_placement(a, cfg.cores,
                                                   cfg.neurons_per_core)}


@pytest.mark.parametrize("wiring", ["random", "clustered"])
def test_placement_matches_jax(wiring):
    jcfg = paths.small_config("hier_tree", "multicast_tree", cores=4, n=16,
                              entries=32)
    tcfg = tconfig.as_interface_config(jcfg)
    if wiring == "random":
        jparams = fabric.random_connectivity(jax.random.PRNGKey(4), jcfg)
        tparams = params_from_numpy(*(np.asarray(x) for x in jparams),
                                    device="cpu")
    else:
        jparams = jplace.clustered_connectivity(11, jcfg, cluster_size=8)
        tparams = tplace.clustered_connectivity(11, tcfg, cluster_size=8,
                                                device="cpu")
        _assert_params_equal(tparams, jparams)
    ja = jplace.fanout_adjacency(jparams, jcfg)
    ta = tplace.fanout_adjacency(tparams, tcfg)
    np.testing.assert_array_equal(ta, ja)
    assert ta.any()
    rates = np.random.default_rng(2).random(ta.shape[0])
    jperms, tperms = (_placements(jplace, ja, jcfg, 5),
                      _placements(tplace, ta, tcfg, 5))
    for name, want in jperms.items():
        got = tperms[name]
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert got.dtype == want.dtype, name
        for fn, extra in (("traffic_cost", {}),
                          ("traffic_cost", {"rates": rates}),
                          ("cam_search_count", {})):
            assert getattr(tplace, fn)(ta, got, 4, 16, **extra) == getattr(
                jplace, fn)(ja, want, 4, 16, **extra), (name, fn)
        np.testing.assert_array_equal(
            tplace.placement_dest_cores(ta, got, 16, 4),
            jplace.placement_dest_cores(ja, want, 16, 4))
        jnew, jnew_cfg = jplace.apply_placement(jparams, jcfg, want)
        tnew, tnew_cfg = tplace.apply_placement(tparams, tcfg, got,
                                                device="cpu")
        _assert_params_equal(tnew, jnew)
        assert tnew_cfg.cam_entries_per_core == jnew_cfg.cam_entries_per_core
        assert tnew_cfg.cam.entries == jnew_cfg.cam.entries
        assert isinstance(tnew_cfg, InterfaceConfig)
    # the optimizer recovers locality the scrambled layout hides
    if wiring == "clustered":
        assert (tplace.traffic_cost(ta, tperms["greedy"], 4, 16)
                < tplace.traffic_cost(ta, tperms["identity"], 4, 16))


def test_placed_tables_run_a_session():
    """apply_placement's output compiles and routes the same currents as
    the JAX session on the placed tables."""
    jcfg = paths.small_config("hier_tree", "multicast_tree")
    tcfg = tconfig.as_interface_config(jcfg)
    jparams = jplace.clustered_connectivity(3, jcfg, cluster_size=16)
    tparams = tplace.clustered_connectivity(3, tcfg, cluster_size=16,
                                            device="cpu")
    a = tplace.fanout_adjacency(tparams, tcfg)
    perm = tplace.greedy_overlap_placement(a, 4, 16)
    jnew, jnew_cfg = jplace.apply_placement(jparams, jcfg, perm)
    tnew, tnew_cfg = tplace.apply_placement(tparams, tcfg, perm,
                                            device="cpu")
    spikes = np.random.default_rng(1).random((3, 4, 16)) < 0.2
    jcur, jst = JInterface(jnew_cfg).compile(jnew).run(jnp.asarray(spikes))
    tcur, tst = Interface(tnew_cfg).compile(tnew, device="cpu").run(
        torch.from_numpy(spikes))
    np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur))
    for field in paths.EXACT_FIELDS:
        assert float(getattr(tst, field)) == float(getattr(jst, field))


def test_placement_outputs_default_to_cuda(monkeypatch):
    cfg = InterfaceConfig(cores=4, neurons_per_core=16,
                          cam_entries_per_core=32)
    params = tplace.clustered_connectivity(0, cfg, 8, device="cpu")
    perm = tplace.identity_placement(64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tplace.clustered_connectivity(0, cfg, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tplace.apply_placement(params, cfg, perm)
