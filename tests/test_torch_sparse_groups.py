"""The whole-run sparse tick's plan of blocks against the JAX package.

On the card `kernels.sparse_tick.kernel.sparse_run_cuda` holds a (tick,
lane) in one block where the fabric fits `MAX_SHARED_BYTES`, and splits
it into groups of consecutive cores where it does not
(`kernel.plan_groups`).  The JAX package's Pallas kernel takes any fabric
of at most `repro.kernels.sparse_tick.kernel.MAX_FUSED_ELEMS` CAM operand
elements.  Here, on the CPU, the plan is held to that ceiling over a
sweep of fabrics, and the port's ``impl="pallas_sparse"`` session at 128
cores x 256 neurons x 512 CAM entries (a fabric over one block) to the
JAX package's on the same numpy params and spikes, under the conformance
contract (currents bitwise, `EXACT_FIELDS` exact, the rest within
`REL_TOL`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fabric
from repro.interface import Interface as JInterface
from repro.kernels.sparse_tick import kernel as jax_kernel
from repro_torch.interface import Interface, StepStats
from repro_torch.interface import config as tconfig
from repro_torch.interface.types import params_from_numpy
from repro_torch.kernels.sparse_tick import kernel as sparse_kernel
from repro_torch.kernels.sparse_tick import ops as sparse_ops
from tests.conformance import paths

CORES = [1 << k for k in range(14)]          # 1 .. 8,192
NEURONS = [1 << k for k in range(4, 17)]     # 16 .. 65,536


def test_the_ceiling_is_the_jax_packages():
    assert sparse_kernel.MAX_FUSED_ELEMS == jax_kernel.MAX_FUSED_ELEMS


def _assert_planned(cores, n, entries, capacity, links):
    """Every CAM entry live: the plan covers the cores in consecutive
    groups, each block within the limit and at least the stats stage."""
    core_nnz = [entries] * cores
    plan = sparse_kernel.plan_groups(cores, n, entries, core_nnz, capacity,
                                     links)
    starts = plan.starts
    assert starts[0] == 0 and starts[-1] == cores
    assert all(a < b for a, b in zip(starts, starts[1:]))
    assert plan.groups == len(starts) - 1 == len(plan.group_bytes)
    assert sparse_kernel.MIN_SHARED_BYTES <= plan.smem <= \
        sparse_kernel.MAX_SHARED_BYTES
    if plan.grouped:
        for lo, hi, need in zip(starts, starts[1:], plan.group_bytes):
            assert need == sparse_kernel.group_shared_bytes(
                hi - lo, n, entries * (hi - lo), capacity, plan.stage)
    else:
        assert plan.smem == sparse_kernel.run_shared_bytes(
            cores, n, cores * entries, capacity, links)
    return plan


@pytest.mark.parametrize("n", NEURONS)
def test_every_fabric_up_to_the_ceiling_is_planned(n):
    """cores x entries at the ceiling, every entry live, at the default
    capacity and at the largest (n - 1); one entry more is refused in the
    JAX package's words."""
    ceiling = jax_kernel.MAX_FUSED_ELEMS
    for cores in CORES:
        entries = ceiling // cores
        for capacity in (sparse_ops.resolve_capacity(None, n), n - 1):
            _assert_planned(cores, n, entries, capacity, 4 * cores)
        with pytest.raises(ValueError, match=rf"\({cores * (entries + 1)} "
                           rf"CAM operand elements > {ceiling}\); use "
                           rf"impl='xla'"):
            sparse_kernel.plan_groups(cores, n, entries + 1,
                                      [entries + 1] * cores, 8, 4 * cores)


def test_plans_hold_what_fits_and_read_the_rest():
    """Where one core does not fit a block with every part held, the plan
    drops the part that core needs most of, and no more."""
    full = sparse_kernel.STAGE_ALL
    # one core of 65,536 neurons: its CSR offsets (256 KB) stay in global
    # memory, its frame and events in the block
    plan = _assert_planned(1, 1 << 16, 512, 8192, 4)
    assert plan.grouped and plan.stage == full & ~sparse_kernel.STAGE_SEG
    # one core of 2^22 entries: its contributions too
    plan = _assert_planned(1, 1 << 16, 1 << 22, 8192, 4)
    assert plan.stage == full & ~(sparse_kernel.STAGE_SEG |
                                  sparse_kernel.STAGE_CONTRIB)
    # at capacity n - 1 the event buffers too (kept in a scratch)
    plan = _assert_planned(1, 1 << 16, 1 << 22, (1 << 16) - 1, 4)
    assert not plan.stage & sparse_kernel.STAGE_EVENTS
    # the paper's core at 8,192 cores: every part held, 63 cores a block
    # at most (3,604 B a core and 1,028 B a block)
    plan = _assert_planned(8192, 256, 512, 32, 4 * 8192)
    assert plan.stage == full and plan.groups == -(-8192 // 63)


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


def test_session_at_128_cores_matches_jax():
    """128 x 256 x 512 under pallas_sparse, 4 ticks (tick 2 overflows a
    core): the card plans it in two groups; on the CPU the port's session
    equals the JAX package's (the Pallas kernel in interpret mode)."""
    jcfg = dataclasses.replace(
        paths.small_config("hier_tree", "multicast_tree", cores=128, n=256,
                           entries=512), impl="pallas_sparse")
    jparams = fabric.random_connectivity(jax.random.PRNGKey(11), jcfg)
    tparams = params_from_numpy(*(np.asarray(x) for x in jparams),
                                device="cpu")
    tsession = Interface(tconfig.as_interface_config(jcfg)).compile(
        tparams, device="cpu")
    capacity = tsession.plan.run.capacity
    rng = np.random.default_rng(11)
    spikes = rng.random((4, 128, 256)) < 0.05
    spikes &= np.cumsum(spikes, -1) <= capacity
    spikes[2, 77, :capacity + 1] = True
    _assert_conformant(tsession.run(torch.from_numpy(spikes)),
                       JInterface(jcfg).compile(jparams).run(
                           jnp.asarray(spikes)), "128 cores")
    ptr = tsession.plan.run.csr.ptr
    plan = sparse_kernel.plan_groups(
        128, 256, 512, ptr[::256].diff().tolist(), capacity,
        tsession.plan.tables.link_table.shape[-1])
    assert plan.grouped and plan.groups == 2
