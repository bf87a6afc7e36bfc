"""The port's MoE dispatch positions (kernel B5's op) against the JAX
package's.

Expert ids are made from a seed with numpy and handed to both packages.
The JAX op runs ``impl="xla"`` (its one-hot cumsum) and ``impl="pallas"``
with the Pallas kernel in interpret mode.  On CPU tensors the port's
``impl="pallas"`` takes its plain version; the CUDA kernel is held to
that plain version on the card (`tests/test_torch_kernels_gpu.py`).
Positions and loads are integers: every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.kernels.moe_dispatch import ops as jops
from repro_torch.kernels.moe_dispatch import kernel as moe_kernel
from repro_torch.kernels.moe_dispatch import ops as tops
from repro_torch.kernels.moe_dispatch import ref as tref

SWEEP = [(256, 16), (2048, 160), (512, 64), (4096, 128)]


def _ids(m, e, seed):
    return np.random.default_rng(seed).integers(0, e, m).astype(np.int32)


def _jax(ids, e, impl):
    kw = {"interpret": True} if impl == "pallas" else {}
    pos, load = jops.dispatch_positions(jnp.asarray(ids), num_experts=e,
                                        impl=impl, **kw)
    return np.asarray(pos), np.asarray(load)


def _port(ids, e, impl):
    pos, load = tops.dispatch_positions(torch.from_numpy(ids), num_experts=e,
                                        impl=impl)
    assert pos.dtype == load.dtype == torch.int32
    return pos.numpy(), load.numpy()


@pytest.mark.parametrize("m,e", SWEEP)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_matches_jax_on_the_sweep(m, e, impl):
    ids = _ids(m, e, m + e)
    pos, load = _port(ids, e, impl)
    for jimpl in ("xla", "pallas"):
        jpos, jload = _jax(ids, e, jimpl)
        np.testing.assert_array_equal(pos, jpos)
        np.testing.assert_array_equal(load, jload)


@pytest.mark.parametrize("m,e", [(256, 64), (3072, 64), (768, 8)])
def test_skewed_streams_match_jax(m, e):
    """Every event on one expert, and a stream where one expert takes
    half the events (the capacity case)."""
    for ids in (np.full(m, e - 1, np.int32),
                np.where(np.arange(m) % 2 == 0, 3,
                         _ids(m, e, m)).astype(np.int32)):
        pos, load = _port(ids, e, "pallas")
        jpos, jload = _jax(ids, e, "pallas")
        np.testing.assert_array_equal(pos, jpos)
        np.testing.assert_array_equal(load, jload)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(2, 32))
def test_property_dense_unique_positions(seed, e):
    """tests/test_kernels.py::test_moe_dispatch_property on the port."""
    ids = _ids(256, e, seed)
    pos, load = _port(ids, e, "pallas")
    for ex in range(e):
        p = np.sort(pos[ids == ex])
        assert list(p) == list(range(len(p)))
    assert int(load.sum()) == 256


def test_pallas_keeps_the_row_rule():
    ids = torch.zeros(300, dtype=torch.int32)
    with pytest.raises(ValueError, match="must be a multiple of row=256"):
        tops.dispatch_positions(ids, num_experts=4, impl="pallas")
    with pytest.raises(ValueError, match="must be a multiple of row=256"):
        jops.dispatch_positions(jnp.zeros(300, jnp.int32), num_experts=4,
                                impl="pallas", interpret=True)
    pos, _ = tops.dispatch_positions(ids, num_experts=4, impl="pallas",
                                     row=100)
    assert int(pos.max()) == 299
    with pytest.raises(ValueError, match="unknown impl"):
        tops.dispatch_positions(ids, num_experts=4, impl="triton")


@pytest.mark.parametrize("pad", [64, 99, -1])
def test_pad_ids_follow_the_tpu_kernel(pad):
    """Ids outside [0, E): position 0 and no load, as the interpret-mode
    kernel gives; the real events keep their positions."""
    e = 64
    ids = _ids(512, e, 5)
    ids[300:] = pad                    # the router's pad, and stray ids
    ids[::37] = pad
    pos, load = _port(ids, e, "pallas")
    jpos, jload = _jax(ids, e, "pallas")
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(load, jload)
    assert (pos[ids == pad] == 0).all() and load.sum() == (ids != pad).sum()
    xpos, xload = _port(ids, e, "xla")          # the port's two impls agree
    np.testing.assert_array_equal(xpos, pos)
    np.testing.assert_array_equal(xload, load)


def test_cpu_takes_the_plain_version_and_the_wrapper_refuses_cpu():
    ids = torch.from_numpy(_ids(256, 16, 1))
    before = moe_kernel.launches
    got = tops.dispatch_positions(ids, num_experts=16, impl="pallas")
    assert moe_kernel.launches == before
    want = tref.dispatch_positions_ref(ids, 16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        moe_kernel.dispatch_positions_cuda(ids, 16)


@pytest.mark.parametrize("m", [1, 24, 255, 256, 1023, 1024, 1025, 3072, 4096,
                               4097, 8192, 65536, 65537, 1_048_576,
                               3_000_001])
def test_launch_geometry_tiles_the_stream(m):
    """The kernel's blocks take spans [r * span, (r + 1) * span) clipped to
    m: they must cover [0, m) once, each block a whole number of rounds
    and at least one event, one block while the stream fits its rounds."""
    blocks, span = moe_kernel.launch_geometry(m)
    assert 1 <= blocks <= moe_kernel.MAX_BLOCKS
    assert span > 0 and span % moe_kernel.ROUND == 0
    starts = [r * span for r in range(blocks)]
    ends = [min(m, s + span) for s in starts]
    assert starts[0] == 0 and ends[-1] == m
    assert all(e0 == s1 for e0, s1 in zip(ends, starts[1:]))
    assert all(s < e for s, e in zip(starts, ends))
    solo = m <= moe_kernel.SOLO_ROUNDS * moe_kernel.ROUND
    assert (blocks == 1) == solo


def test_max_experts_fits_shared_memory_and_deepseek():
    """(2 + 32) E int32 of shared memory a block: the limit fits 227 KB,
    one more expert does not, and DeepSeek-V2's 160 experts fit."""
    per = 4 * (2 + moe_kernel.ROUND // 32)
    assert moe_kernel.MAX_EXPERTS * per <= 232448
    assert (moe_kernel.MAX_EXPERTS + 1) * per > 232448
    assert moe_kernel.MAX_EXPERTS >= 160
