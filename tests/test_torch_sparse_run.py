"""The port's whole-run sparse tick (`sparse_run`) against the JAX package.

`kernels.sparse_tick.ops.sparse_run` computes every sparse tick of a
session run at once (one kernel launch on the card) and the session's
``impl="pallas_sparse"`` loop is built on it (`pipeline.run_stream`).
Here, on the CPU, its plain version and the session are held to the JAX
`InterfaceSession.run` / `run_batched` on ``impl="pallas_sparse"`` (the
Pallas kernel in interpret mode) at `tests/conformance/paths.small_config`
(4 x 16 x 32, capacity 8) for the 5 x 3 arbiter x NoC grid, on streams
with overflowing ticks mixed in, at T = 0, T = 1 and three lanes, under
the conformance contract (currents bitwise, `EXACT_FIELDS` exact, the
rest within `REL_TOL`).  The op is also held bitwise to the per-tick
composition it replaces, and the kernel's plan of blocks to its
shared-memory formulas.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fabric
from repro.interface import Interface as JInterface
from repro_torch.interface import Interface, StepStats, pipeline
from repro_torch.interface import config as tconfig
from repro_torch.interface.types import params_from_numpy
from repro_torch.kernels.sparse_tick import kernel as sparse_kernel
from repro_torch.kernels.sparse_tick import ops as sparse_ops
from repro_torch.kernels.sparse_tick import ref as sparse_ref
from tests.conformance import paths

CAPACITY = 8                 # resolve_capacity(None, 16)


def _setup(arb_scheme, noc_scheme, seed=3):
    jcfg = dataclasses.replace(paths.small_config(arb_scheme, noc_scheme),
                               impl="pallas_sparse")
    jparams = fabric.random_connectivity(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(*(np.asarray(x) for x in jparams),
                                device="cpu")
    return jcfg, jparams, tconfig.as_interface_config(jcfg), tparams


def _stream(seed, lanes, ticks, overflow=(), p=0.15):
    """(B, T, 4, 16) frames cut to the capacity, except the ``overflow``
    ticks: a full burst in lane 0 and one core just past the capacity in
    the last lane."""
    rng = np.random.default_rng(seed)
    s = rng.random((lanes, ticks, 4, 16)) < p
    s &= np.cumsum(s, -1) <= CAPACITY
    for t in overflow:
        s[0, t] = True
        s[-1, t, 2, :CAPACITY + 1] = True
    return s


def _assert_conformant(got, want, label):
    cur, st = got
    jcur, jst = want
    np.testing.assert_array_equal(cur.numpy(), np.asarray(jcur),
                                  err_msg=f"{label}: currents")
    for field in StepStats._fields:
        a, b = getattr(st, field).numpy(), np.asarray(getattr(jst, field))
        assert a.shape == b.shape, (label, field)
        if field in paths.EXACT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f"{label}: {field}")
        else:
            np.testing.assert_allclose(a, b, rtol=paths.REL_TOL, atol=0,
                                       err_msg=f"{label}: {field}")


def _composition(plan, params, stream, overflow):
    """The per-tick path the op replaces: the dense tick on overflowing
    ticks, else compact_events -> the sparse_tick op -> event_indices ->
    sparse_accounting_stats; the stats added in tick order from 0.0."""
    policy, sparse_cam, capacity = pipeline.resolve_sparse_plan(plan.cfg)
    n = plan.cfg.neurons_per_core
    acc = torch.zeros((12, stream.shape[0]))
    currents = []
    for t in range(stream.shape[1]):
        frames = stream[:, t]
        if overflow[t]:
            cur, st = pipeline.dense_tick(plan, params, frames)
        else:
            buf, counts = sparse_ops.compact_events(frames, capacity)
            cur, lat, enc, hits = sparse_ops.sparse_tick(
                frames.reshape(frames.shape[0], -1), buf, counts,
                plan.routing.src_idx, plan.routing.active, params.weights,
                plan.routing.csr, n=n, policy=policy)
            ev_idx, ev_w = sparse_ops.event_indices(buf, n)
            st = pipeline.sparse_accounting_stats(
                plan.cfg, plan.tables, counts, ev_idx, ev_w, lat, enc, hits,
                params.valid, plan.cam_cycle_ns, sparse_cam)
        acc = acc + torch.stack(tuple(st))
        currents.append(cur)
    return torch.stack(currents, 1), acc


@pytest.mark.parametrize("arb_scheme,noc_scheme", paths.GRID)
def test_session_matches_jax_on_the_grid(arb_scheme, noc_scheme):
    jcfg, jparams, tcfg, tparams = _setup(arb_scheme, noc_scheme)
    jsession = JInterface(jcfg).compile(jparams)
    tsession = Interface(tcfg).compile(tparams, device="cpu")
    label = f"{arb_scheme}/{noc_scheme}"
    mixed = _stream(7, 3, 6, overflow=(1, 4))
    _assert_conformant(tsession.run_batched(torch.from_numpy(mixed)),
                       jsession.run_batched(jnp.asarray(mixed)),
                       f"{label}/batched")
    for lane in range(3):
        _assert_conformant(tsession.run(torch.from_numpy(mixed[lane])),
                           jsession.run(jnp.asarray(mixed[lane])),
                           f"{label}/lane {lane}")


@pytest.mark.parametrize("arb_scheme,noc_scheme", paths.GRID)
def test_op_equals_the_per_tick_composition(arb_scheme, noc_scheme):
    _, _, tcfg, tparams = _setup(arb_scheme, noc_scheme, seed=5)
    plan = pipeline.make_plan(tparams, tcfg)
    stream = torch.from_numpy(_stream(11, 3, 7, overflow=(0, 3)))
    overflow = [t in (0, 3) for t in range(7)]
    cur, acc = pipeline.run_stream(plan, tparams, stream, overflow)
    want_cur, want_acc = _composition(plan, tparams, stream, overflow)
    assert torch.equal(cur, want_cur)
    assert torch.equal(acc, want_acc)


@pytest.mark.parametrize("ticks", [0, 1])
@pytest.mark.parametrize("overflow", [False, True])
def test_short_streams_match_jax(ticks, overflow):
    jcfg, jparams, tcfg, tparams = _setup("hier_tree", "multicast_tree")
    stream = _stream(3, 3, ticks, overflow=(0,) if overflow and ticks
                     else ())
    tsession = Interface(tcfg).compile(tparams, device="cpu")
    got = tsession.run_batched(torch.from_numpy(stream))
    assert got[0].shape == (3, ticks, 4, 16)
    _assert_conformant(got, JInterface(jcfg).compile(jparams).run_batched(
        jnp.asarray(stream)), f"T={ticks}")
    cur, st = tsession.run(torch.from_numpy(stream[0]))
    assert cur.shape == (ticks, 4, 16) and st.events.shape == ()
    if ticks == 0:
        assert all(float(v) == 0.0 for v in st)


def test_session_calls_the_op_once_per_run(monkeypatch):
    """One `sparse_run` a run (one launch on the card), with the
    overflowing ticks left out of its list."""
    _, _, tcfg, tparams = _setup("hier_tree", "unicast")
    session = Interface(tcfg).compile(tparams, device="cpu")
    calls = []
    run = sparse_ops.sparse_run

    def spy(stream, ticks, *args):
        calls.append(ticks)
        return run(stream, ticks, *args)
    monkeypatch.setattr(sparse_ops, "sparse_run", spy)
    session.run_batched(torch.from_numpy(_stream(4, 3, 6, overflow=(2,))))
    assert calls == [[0, 1, 3, 4, 5]]
    session.run(torch.from_numpy(_stream(5, 1, 4)[0]))
    assert calls == [[0, 1, 3, 4, 5], None]


def test_sparse_run_writes_only_the_listed_ticks():
    _, _, tcfg, tparams = _setup("token_ring", "unicast", seed=8)
    plan = pipeline.make_plan(tparams, tcfg)
    stream = torch.from_numpy(_stream(2, 2, 5))
    currents = torch.full((2, 5, 4, 16), -7.0)
    table = torch.full((5, 12, 2), 0.5)
    acc = sparse_ops.sparse_run(stream, [1, 3], plan.run, currents, table)
    for t in (0, 2, 4):
        assert bool((currents[:, t] == -7.0).all())
        assert bool((table[t] == 0.5).all())
    full_cur, _ = pipeline.run_stream(plan, tparams, stream, [False] * 5)
    for t in (1, 3):
        assert torch.equal(currents[:, t], full_cur[:, t])
    assert torch.equal(acc, sparse_ref.sum_in_tick_order(table))


def test_sum_in_tick_order_adds_from_zero_row_by_row():
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((9, 12, 3)).astype(
        np.float32) * 1e4)
    want = torch.zeros((12, 3))
    for row in table:
        want = want + row
    assert torch.equal(sparse_ref.sum_in_tick_order(table), want)
    assert torch.equal(sparse_ref.sum_in_tick_order(table[:0]),
                       torch.zeros((12, 3)))


def test_cpu_runs_never_launch_and_shapes_are_guarded():
    _, _, tcfg, tparams = _setup("hier_tree", "multicast_tree")
    plan = pipeline.make_plan(tparams, tcfg)
    assert plan.run.kernel is None                     # bound on the CPU
    stream = torch.from_numpy(_stream(1, 1, 3))
    before = sparse_kernel.launches
    pipeline.run_stream(plan, tparams, stream, [False] * 3)
    assert sparse_kernel.launches == before
    with pytest.raises(ValueError, match="must both be"):
        sparse_ops.sparse_run(stream, None, plan.run,
                              torch.empty((1, 2, 4, 16)),
                              torch.empty((3, 12, 1)))
    with pytest.raises(ValueError, match="table shape"):
        sparse_ops.sparse_run(stream, None, plan.run,
                              torch.empty((1, 3, 4, 16)),
                              torch.empty((3, 11, 1)))
    with pytest.raises(ValueError, match=r"ticks must lie in \[0, 3\)"):
        sparse_ops.sparse_run(stream, [0, 3], plan.run,
                              torch.empty((1, 3, 4, 16)),
                              torch.empty((3, 12, 1)))


@pytest.mark.parametrize("cores,n,nnz,one_block", [
    (4, 16, 128, 8192),         # the small grid
    (16, 256, 8192, 60868),     # the scaled DYNAPs fabric, every entry live
    (64, 256, 29491, 221136),   # 64 cores at random_connectivity's fan-in
    (64, 256, 32768, None),     # 64 cores with every entry live
    (16, 16384, 1024, None),    # a 256 KB frame
    (128, 256, 58982, None),    # 128 cores on one chip, fan-in 0.9
    (256, 256, 117964, None),   # 16 chips x 16 cores, fan-in 0.9
])
def test_shared_memory_limit_fits_one_block_or_refuses(cores, n, nnz,
                                                       one_block):
    """A fabric whose (tick, lane) fits one block's shared memory keeps the
    one block (G = 1, the bytes of the first port's formula); a larger one
    is planned in G > 1 groups of consecutive cores, every block within
    the limit: none is refused below the JAX package's ceiling."""
    core_nnz = [nnz // cores + (c < nnz % cores) for c in range(cores)]
    plan = sparse_kernel.plan_groups(cores, n, 512, core_nnz, 32, 2 * cores)
    assert plan.starts[0] == 0 and plan.starts[-1] == cores
    assert len(plan.starts) == plan.groups + 1 == len(plan.group_bytes) + 1
    assert all(a < b for a, b in zip(plan.starts, plan.starts[1:]))
    assert plan.smem == max(plan.group_bytes) <= \
        sparse_kernel.MAX_SHARED_BYTES
    if one_block is not None:
        assert not plan.grouped and plan.groups == 1
        assert plan.smem == one_block == sparse_kernel.run_shared_bytes(
            cores, n, nnz, 32, 2 * cores)
        # one more live entry a core costs 4 bytes a core
        assert sparse_kernel.run_shared_bytes(
            cores, n, nnz + cores, 32, 2 * cores) in (one_block,
                                                     one_block + 4 * cores)
        return
    assert plan.grouped and plan.groups > 1
    assert plan.stage == sparse_kernel.STAGE_ALL
    assert sparse_kernel.run_shared_bytes(
        cores, n, nnz, 32, 2 * cores) > sparse_kernel.MAX_SHARED_BYTES
    for lo, hi, need in zip(plan.starts, plan.starts[1:], plan.group_bytes):
        assert need == sparse_kernel.group_shared_bytes(
            hi - lo, n, sum(core_nnz[lo:hi]), 32, plan.stage)
    # the fewest groups: no two neighbours would fit one block
    for g in range(plan.groups - 1):
        lo, hi = plan.starts[g], plan.starts[g + 2]
        assert sparse_kernel.group_shared_bytes(
            hi - lo, n, sum(core_nnz[lo:hi]), 32,
            plan.stage) > sparse_kernel.MAX_SHARED_BYTES


def test_kernel_operands_refuse_cpu_tensors():
    _, _, tcfg, tparams = _setup("hier_tree", "multicast_tree")
    plan = pipeline.make_plan(tparams, tcfg)
    t = plan.tables
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        sparse_kernel.run_operands(
            plan.routing.csr.ptr, plan.routing.csr.entry, tparams.weights,
            t.hops, t.depth, t.dest_counts, t.dest_counts, t.link_table,
            cores=4, n=16, capacity=CAPACITY, policy=4, levels=2,
            flood=False, floats=(0.0,) * 8, entries=32)
