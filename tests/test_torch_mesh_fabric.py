"""``run(shard="chips")`` across ranks, and the compressed all-reduces.

* A chips=4 session on 4 gloo CPU ranks runs `_mesh_loop` (each rank its
  own chip, the results gathered in chip order) and says so
  (``last_shard_body == "mesh"``).  On `tests/conformance/paths.py`'s
  small config (8 cores, 2 a chip) and two scenario streams (Poisson and
  a synchronized burst) its currents are bit for bit the chips=1 xla
  session's, its stats are the single-process sharded body's bit for bit
  and within the conformance contract of the JAX package's sharded run
  (and of the chips=1 session on the partition-independent fields); a
  masked `run_batched` too.
* `compressed_psum_exact_scales` is bit for bit the rank-ordered sum of
  the JAX package's `quantize_int8` of each rank's shard,
  `compressed_psum` is within 1e-6 relative of the JAX formula on the
  same shards, and 20 error-feedback syncs converge as
  `tests/test_distributed.py` asks (relative error < 0.01); `quantize_int8`
  is bit for bit the JAX package's.
* The host-staged functional collectives (`repro_torch.launch.staging`,
  the card's route under gloo) registered for the CPU: a DTensor gather
  through them is exact and counted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import traffic
from repro.core import fabric as jfabric
from repro.interface import Interface as JInterface
from repro.parallel import collectives as jcoll
from repro_torch.interface import Interface
from repro_torch.interface.config import as_interface_config
from repro_torch.interface.types import params_from_numpy
from repro_torch.launch.spawn import spawn
from repro_torch.parallel import collectives as tcoll
import torch_mesh_ranks as ranks
from tests.conformance import paths

CHIPS, TICKS, SEED = 4, 16, 23
STREAMS = ("sparse_poisson", "synchronized_burst")


@pytest.fixture(scope="module")
def fabric():
    jcfg = dataclasses.replace(
        paths.small_config("hier_tree", "multicast_tree", cores=8),
        chips=CHIPS)
    jparams = jfabric.random_connectivity(jax.random.PRNGKey(SEED), jcfg)
    streams = {name: np.asarray(traffic.generate(name, SEED + i, TICKS, jcfg))
               for i, name in enumerate(STREAMS)}
    mask = np.ones((len(STREAMS), TICKS), bool)
    mask[1, TICKS // 2:] = False
    params_np = tuple(np.asarray(x) for x in jparams)
    tcfg = as_interface_config(jcfg)
    results = spawn(ranks.fabric_chips, CHIPS,
                    args=(tcfg, params_np, streams, mask), timeout=300)
    return jcfg, jparams, tcfg, params_np, streams, mask, results


def _single(tcfg, params_np, chips):
    return Interface(dataclasses.replace(tcfg, chips=chips)).compile(
        params_from_numpy(*params_np, device="cpu"), device="cpu")


def _stats_close(got: dict, want, fields, label):
    for f in fields:
        a, b = np.asarray(got[f]), np.asarray(getattr(want, f))
        if f in paths.EXACT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f"{label}: {f}")
        else:
            np.testing.assert_allclose(a, b, rtol=paths.REL_TOL, atol=0,
                                       err_msg=f"{label}: {f}")


@pytest.mark.parametrize("name", STREAMS)
def test_chips_mesh_run_is_bitwise_the_one_chip_session(fabric, name):
    jcfg, jparams, tcfg, params_np, streams, _, results = fabric
    spikes = torch.from_numpy(streams[name].copy())
    flat_cur, flat_st = _single(tcfg, params_np, 1).run(spikes)
    single = _single(tcfg, params_np, CHIPS)
    one_cur, one_st = single.run(spikes, shard="chips")
    assert single.last_shard_body == "single"
    j_cur, j_st = JInterface(jcfg).compile(jparams).run(streams[name],
                                                        shard="chips")
    for out in results:
        cur, st, body = out[name]
        assert body == "mesh"
        assert np.array_equal(cur, flat_cur.numpy()), "currents vs chips=1"
        assert np.array_equal(cur, np.asarray(j_cur))
        for f, v in st.items():
            assert v == float(getattr(one_st, f)), f
        _stats_close(st, j_st, st, f"{name} vs JAX sharded")
        _stats_close(st, flat_st, paths.PATH_INVARIANT_FIELDS,
                     f"{name} vs chips=1")


def test_masked_chips_mesh_run(fabric):
    _, _, tcfg, params_np, streams, mask, results = fabric
    stack = torch.from_numpy(np.stack(list(streams.values())))
    want_cur, want_st = _single(tcfg, params_np, CHIPS).run_batched(
        stack, shard="chips", mask=torch.from_numpy(mask))
    flat_cur, _ = _single(tcfg, params_np, 1).run_batched(
        stack, mask=torch.from_numpy(mask))
    for out in results:
        cur, st, body = out["masked"]
        assert body == "mesh"
        assert np.array_equal(cur, flat_cur.numpy())
        assert np.array_equal(cur, want_cur.numpy())
        for f, v in st.items():
            assert np.array_equal(v, getattr(want_st, f).numpy()), f


def test_chips_mesh_refuses_telemetry():
    from repro_torch.interface.session import CompositionError
    cfg = dataclasses.replace(as_interface_config(
        paths.small_config("hier_tree", "multicast_tree", cores=8)),
        chips=CHIPS)
    session = Interface(cfg).compile(
        params_from_numpy(*(np.asarray(x) for x in jfabric.random_connectivity(
            jax.random.PRNGKey(SEED), paths.small_config(
                "hier_tree", "multicast_tree", cores=8))), device="cpu"),
        device="cpu")
    with pytest.raises(CompositionError):
        session.run(torch.zeros((2, 8, 16), dtype=torch.bool), shard="chips",
                    telemetry="ticks")


# ---- the collectives -----------------------------------------------------------

WORLD = 4


@pytest.fixture(scope="module")
def coll():
    rng = np.random.default_rng(5)
    shards = (rng.standard_normal((WORLD, 1000)).astype(np.float32)
              * np.array([[0.1], [1.0], [10.0], [3.0]], np.float32))
    grads = (np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                          (WORLD, 512))) * 0.1
             ).astype(np.float32)
    return shards, grads, spawn(ranks.collectives, WORLD,
                                args=(shards, grads, True), timeout=300)


def test_exact_scales_sum_is_the_rank_ordered_jax_sum(coll):
    shards, _, results = coll
    want = None
    for r in range(WORLD):
        q, s = jcoll.quantize_int8(jnp.asarray(shards[r]))
        part = np.asarray(q).astype(np.float32) * np.asarray(s)
        want = part if want is None else want + part
    want = want.reshape(-1)[:shards.shape[1]]
    for out in results:
        assert np.array_equal(out["exact"], want)
        exact = shards.sum(0)
        rel = np.abs(exact - out["exact"]).max() / np.abs(exact).max()
        assert rel < 0.02


def test_compressed_psum_matches_the_jax_formula(coll):
    shards, _, results = coll
    qs = [jcoll.quantize_int8(jnp.asarray(x)) for x in shards]
    qsum = sum(np.asarray(q).astype(np.int64) for q, _ in qs)
    mean = sum(np.asarray(s, np.float64) for _, s in qs) / WORLD
    want = (qsum * mean).reshape(-1)[:shards.shape[1]]
    for out in results:
        rel = np.abs(out["approx"] - want).max() / np.abs(want).max()
        assert rel < 1e-6, rel


def test_error_feedback_converges(coll):
    _, grads, results = coll
    want = grads.mean(0) * 20
    for out in results:
        err = np.abs(out["ef_acc"] - want).max() / np.abs(want).max()
        assert err < 0.01, err


def test_staged_collectives_gather_exactly(coll):
    shards, _, results = coll
    for out in results:
        assert np.array_equal(out["staged_gather"], shards)
        assert out["staged_calls"]["all_gather_into_tensor"] >= 1


def test_staged_reduce_scatter_sums_exactly(coll):
    """A `Partial` -> `Shard(0)` redistribute stages one reduce-scatter:
    each rank gets its block of the sum, exactly (whole numbers)."""
    shards, _, results = coll
    n = shards.shape[1] // WORLD
    total = np.round(shards[:, :n * WORLD] * 64).sum(0)
    for rank, out in enumerate(results):
        assert np.array_equal(out["staged_reduce_scatter"],
                              total[rank * n:(rank + 1) * n])
        assert out["staged_calls"]["reduce_scatter_tensor"] == 1


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4097])
def test_quantize_int8_is_bitwise_jax(n):
    x = (np.random.default_rng(n).standard_normal(n) * 7).astype(np.float32)
    qj, sj = jcoll.quantize_int8(jnp.asarray(x))
    qt, st = tcoll.quantize_int8(torch.from_numpy(x))
    assert np.array_equal(np.asarray(qj), qt.numpy())
    assert np.array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(
        np.asarray(jcoll.dequantize_int8(qj, sj, n)),
        tcoll.dequantize_int8(qt, st, n).numpy())
