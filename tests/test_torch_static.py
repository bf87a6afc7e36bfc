"""The PyTorch port's static layer and compile-time tables against JAX.

Same inputs to both packages (numpy arrays made from a seed, or the JAX
package's own `random_connectivity` carried across with
`params_from_numpy`): configs raise the same errors, constants and the
CAM PPA model agree, every `NocTables` and `RoutingIndex` field is equal
across the three NoC schemes, and the arbiter policies - dense and
sparse, latency and encode energy - give the same float32 values.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arbiter as jarb
from repro.core import cam as jcam
from repro.core import fabric
from repro.core import ppa as jppa
from repro.interface import config as jconfig
from repro.interface import pipeline as jpipeline
from repro.interface import registry as jregistry
from repro.interface import types as jtypes
from repro.kernels.sparse_tick import ops as jsparse_ops
from repro.noc import multicast as jmulticast
from repro.noc import router as jrouter
from repro.noc import topology as jtopology
from repro_torch.core import arbiter as tarb
from repro_torch.core import cam as tcam
from repro_torch.core import ppa as tppa
from repro_torch.interface import config as tconfig
from repro_torch.interface import pipeline as tpipeline
from repro_torch.interface import registry as tregistry
from repro_torch.interface.types import int_to_bits, params_from_numpy
from repro_torch.kernels.sparse_tick import ops as tsparse_ops
from repro_torch.noc import multicast as tmulticast
from repro_torch.noc import topology as ttopology
from tests.conformance import paths

SCHEMES = paths.ARBITER_SCHEMES


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(a, b, label=""):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, f"{label}: shape {a.shape} != {b.shape}"
    np.testing.assert_array_equal(a, b, err_msg=label)


# ---- configs -----------------------------------------------------------------

CONFIG_CASES = {
    "cores_not_divisible_by_chips": dict(cores=6, chips=4),
    "chips_zero": dict(chips=0),
    "stale_cores_per_chip": dict(cores=8, chips=2, cores_per_chip=3),
    "cam_entries_conflict": dict(cam_entries_per_core=16, cam=("cam", 32)),
    "unknown_impl": dict(impl="cuda"),
    "zero_capacity": dict(sparse_capacity=0),
    "unknown_arbiter": dict(scheme="round_robin"),
    "unknown_cam_variant": dict(cam=("variant", "nope")),
    "unknown_noc": dict(noc="mesh"),
}


def _build_config(pkg_config, pkg_cam, pkg_topology, kw):
    kw = dict(kw)
    if "cam" in kw:
        kind, val = kw["cam"]
        kw["cam"] = (pkg_cam.CamConfig(entries=val) if kind == "cam" else
                     pkg_cam.CamConfig(entries=32, variant_name=val))
    if "noc" in kw:
        kw["noc"] = pkg_topology.NocConfig(kw["noc"])
    return pkg_config.InterfaceConfig(**kw)


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_configs_raise_the_same_errors(case):
    kw = CONFIG_CASES[case]
    with pytest.raises(ValueError) as want:
        _build_config(jconfig, jcam, jtopology, kw)
    with pytest.raises(ValueError) as got:
        _build_config(tconfig, tcam, ttopology, kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(), dict(cores=16, neurons_per_core=256),
                                dict(cores=3, neurons_per_core=32,
                                     cam_entries_per_core=8, chips=3),
                                dict(cores_per_chip=4, chips=2)])
def test_valid_configs_resolve_alike(kw):
    j, t = jconfig.InterfaceConfig(**kw), tconfig.InterfaceConfig(**kw)
    for field in ("cores", "cores_per_chip", "cam_entries_per_core",
                  "neurons_per_core", "scheme", "impl", "chips",
                  "sparse_capacity", "tag_bits"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.cam.variant == j.cam.variant and t.noc.scheme == j.noc.scheme
    # a JAX config is accepted field by field
    lifted = tconfig.as_interface_config(j)
    assert lifted == t


def test_ppa_constants_and_closed_forms_are_equal():
    names = [k for k in dir(tppa) if k.isupper()]
    assert "TPU_HBM_BW" not in names and "TPU_ICI_BW" not in names
    for k in names:
        assert getattr(tppa, k) == getattr(jppa, k), k
    for scheme in SCHEMES:
        for n in (16, 64, 256, 1024):
            for fn in ("sparse_latency_units", "burst_latency_units",
                       "area_units", "sparse_latency_ns", "area_normalized"):
                assert getattr(tppa, fn)(scheme, n) == getattr(jppa, fn)(
                    scheme, n), (fn, scheme, n)


@pytest.mark.parametrize("variant", ["conventional", "cscd", "cscd+fb",
                                     "cscd+ss", "cscd+fb+ss"])
def test_cam_cycle_time_and_energy_are_equal(variant):
    for entries in (16, 32, 512, 4096):
        jc = jcam.CamConfig(entries, variant_name=variant)
        tc = tcam.CamConfig(entries, variant_name=variant)
        assert tcam.cycle_time_ns(tc) == jcam.cycle_time_ns(jc)
        assert tcam.dummy_charge_ns(entries) == jcam.dummy_charge_ns(entries)
    rng = np.random.default_rng(0)
    nm = rng.integers(0, 40, 64).astype(np.float32)
    nmm = (rng.random(64) * 100).astype(np.float32)
    want = jcam._energy_jnp(jc, jnp.asarray(nm), jnp.asarray(nmm))
    got = tcam.energy(tc, torch.from_numpy(nm), torch.from_numpy(nmm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_capacity_policy_is_equal():
    for n in (4, 16, 64, 256, 1024):
        assert tsparse_ops.default_capacity(n) == jsparse_ops.default_capacity(n)
        for req in (None, 1, 3, 8, 500):
            assert (tsparse_ops.resolve_capacity(req, n) ==
                    jsparse_ops.resolve_capacity(req, n))


# ---- topology and compile-time tables -----------------------------------------

def test_topology_is_equal():
    for cores in (1, 2, 3, 4, 5, 6, 9, 12, 16):
        assert ttopology.mesh_dims(cores) == jtopology.mesh_dims(cores)
        assert ttopology.num_links(cores) == jtopology.num_links(cores)
        _equal(ttopology.core_coords(cores), jtopology.core_coords(cores))
        _equal(ttopology.hop_matrix(cores), jtopology.hop_matrix(cores))


def test_int_to_bits_is_equal():
    x = np.arange(0, 300, 7, dtype=np.int32)
    _equal(int_to_bits(torch.from_numpy(x), 9),
           jtypes.int_to_bits(jnp.asarray(x), 9))


def test_multicast_hops_are_equal():
    rng = np.random.default_rng(1)
    for cores in (4, 6, 16):
        mask = rng.random((40, cores)) < 0.3
        src = rng.integers(0, cores, 40).astype(np.int32)
        tm, ts = torch.from_numpy(mask), torch.from_numpy(src)
        jm, js = jnp.asarray(mask), jnp.asarray(src)
        _equal(tmulticast.unicast_hops(tm, ts, cores),
               jmulticast.unicast_hops(jm, js, cores))
        _equal(tmulticast.multicast_tree_hops(tm, ts, cores),
               jmulticast.multicast_tree_hops(jm, js, cores))
        _equal(tmulticast.broadcast_tree_hops(ts, cores),
               jmulticast.broadcast_tree_hops(js, cores))


def _both_params(cfg, seed):
    jparams = fabric.random_connectivity(jax.random.PRNGKey(seed), cfg)
    return jparams, params_from_numpy(*(np.asarray(x) for x in jparams),
                                      device="cpu")


@pytest.mark.parametrize("noc", paths.NOC_SCHEMES)
@pytest.mark.parametrize("shape", [(4, 16, 32), (6, 32, 24), (9, 16, 8)])
def test_compile_time_tables_are_equal(noc, shape):
    cores, n, entries = shape
    jcfg = paths.small_config("hier_tree", noc, cores=cores, n=n,
                              entries=entries)
    tcfg = tconfig.as_interface_config(jcfg)
    jparams, tparams = _both_params(jcfg, seed=cores + n)
    jt = jpipeline.build_tables(jparams, jcfg)
    tt = tpipeline.build_tables(tparams, tcfg)
    assert tt.scheme == jt.scheme
    for field in jt._fields[1:]:
        _equal(getattr(tt, field), getattr(jt, field), field)
    jr = jpipeline.build_routing_index(jparams, jcfg)
    tr = tpipeline.build_routing_index(tparams, tcfg)
    for field in jr._fields:
        _equal(getattr(tr, field), getattr(jr, field), field)


def test_link_loads_are_equal_for_every_scheme():
    rng = np.random.default_rng(2)
    for cores in (6, 16):
        mask = rng.random((30, cores)) < 0.4
        src = rng.integers(0, cores, 30).astype(np.int32)
        for scheme in paths.NOC_SCHEMES:
            want = jrouter.link_loads(jnp.asarray(mask), jnp.asarray(src),
                                      cores, scheme)
            got = tregistry.get_noc_scheme(scheme).link_loads(torch.from_numpy(mask),
                                   torch.from_numpy(src), cores)
            _equal(got, want, f"{scheme}/{cores}")


# ---- arbiter policies ------------------------------------------------------------

def _frames(n, seed, count=24):
    """Frames from empty to full: sparse, clustered, bursts and edge cases."""
    rng = np.random.default_rng(seed)
    rates = np.linspace(0.0, 1.0, count)
    frames = rng.random((count, n)) < rates[:, None]
    frames[1] = False
    frames[1, n - 1] = True
    frames[2] = False
    frames[2, : n // 4] = True
    return frames


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("n", [4, 16, 32, 64, 256])
def test_dense_policies_are_equal(scheme, n):
    jcfg, tcfg = jarb.ArbiterConfig(scheme, n), tarb.ArbiterConfig(scheme, n)
    assert tcfg.levels == jcfg.levels
    jentry = jregistry.get_arbiter(scheme)
    jfn = jentry.tick_latency(jarb.make_context(jcfg))
    frames = _frames(n, seed=n)
    if jfn is None:         # no closed form here: the simulator's latency
        want = jarb.batched_tick_latency(jcfg, jnp.asarray(frames))
    else:
        want = jax.vmap(jfn)(jnp.asarray(frames))
    got = tarb.batched_tick_latency(tcfg, torch.from_numpy(frames))
    _equal(got, want, "tick_latency")
    # encode energy over the dense AER stream of each frame
    for frame in frames[:8]:
        order = np.flatnonzero(frame)
        seq = np.full(n, n, np.int32)
        seq[: order.size] = order
        want = jarb.encode_energy_units(scheme, n, jnp.asarray(seq))
        got = tarb.encode_energy_units(scheme, n, torch.from_numpy(seq))
        _equal(got, want, "encode_energy")


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("n,capacity", [(16, 8), (64, 8), (64, 63),
                                        (256, 32), (32, 8)])
def test_sparse_policies_are_equal(scheme, n, capacity):
    jcfg, tcfg = jarb.ArbiterConfig(scheme, n), tarb.ArbiterConfig(scheme, n)
    jctx, tctx = jarb.make_context(jcfg), tarb.make_context(tcfg)
    jentry = jregistry.get_arbiter(scheme)
    tentry = tregistry.get_arbiter(scheme)
    jlat = jentry.sparse_tick_latency(jctx)
    tlat = tentry.sparse_tick_latency(tctx)
    assert (jlat is None) == (tlat is None)
    frames = _frames(n, seed=n + capacity)
    frames &= np.cumsum(frames, axis=1) <= capacity       # within capacity
    jbuf, jcounts = jsparse_ops.compact_events(jnp.asarray(frames), capacity)
    tbuf, tcounts = tsparse_ops.compact_events(torch.from_numpy(frames),
                                               capacity)
    _equal(tbuf, jbuf, "buf")
    _equal(tcounts, jcounts, "counts")
    if jlat is not None:
        _equal(tlat(tbuf, tcounts), jlat(jbuf, jcounts), "sparse latency")
    jenc = jentry.sparse_encode_energy(jctx)
    tenc = tentry.sparse_encode_energy(tctx)
    _equal(tenc(tbuf, tcounts), jenc(jbuf, jcounts), "sparse encode")


def test_levels_follow_the_reference_rounding():
    for n in (2, 4, 8, 32, 128, 512, 2048):
        assert (tarb.ArbiterConfig("hier_tree", n).levels ==
                jarb.ArbiterConfig("hier_tree", n).levels)
    with pytest.raises(ValueError, match="power of two"):
        tarb.ArbiterConfig("hier_tree", 24)
    cfg = dataclasses.replace(tarb.ArbiterConfig("hier_tree", 16), n=64)
    assert math.isclose(tarb.make_context(cfg).lg, 6.0)
