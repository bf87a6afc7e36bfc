"""The PyTorch port's CAM search ops against the JAX package's.

Inputs are numpy arrays made from a seed and handed to both packages; the
JAX side runs the Pallas kernel in interpret mode on the CPU, as
`tests/test_kernels.py` does.  The port's ops take their plain torch
versions on CPU tensors.  Every output is an integer, so every comparison
is exact.  Covered: `pack_bits`; `cam_search`, `cam_first_match` and
`cam_search_speculative` over the shape sweep of `tests/test_kernels.py`
and W in {1, 2, 3}; `cam_match_counts` at shapes that need the JAX op's
block padding, and over a lane axis; the errors both packages raise; and
that the CUDA wrappers refuse CPU tensors without building anything.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cam_search import ops as jcam_ops
from repro.kernels.cam_search import ref as jcam_ref
from repro_torch.kernels import build
from repro_torch.kernels.cam_search import kernel as cam_kernel
from repro_torch.kernels.cam_search import ops as tcam_ops

# (B, E, tag bits): the sweep of tests/test_kernels.py, then W = 3
SWEEP = [(8, 16, 11), (128, 128, 11), (256, 64, 33), (64, 512, 44),
         (128, 256, 70)]
# B or E above one 128 block and not a multiple of it: the JAX op pads
PADDED = [(200, 300, 12), (129, 1000, 40), (300, 130, 70), (2, 129, 12)]


def _operands(b, e, bits, seed, lanes=None):
    """Packed queries and tags (some queries copy a tag) and valid flags,
    as (numpy, torch) pairs."""
    rng = np.random.default_rng(seed)
    tags = (rng.random((e, bits)) < 0.5).astype(np.int32)
    qbits = (rng.random((b, bits)) < 0.5).astype(np.int32)
    qbits[: min(b, e) // 2] = tags[: min(b, e) // 2]
    shape = (e,) if lanes is None else (lanes, e)
    valid = rng.random(shape) < 0.9
    q = np.array(jcam_ref.pack_bits(jnp.asarray(qbits)))
    t = np.array(jcam_ref.pack_bits(jnp.asarray(tags)))
    return ((q, t, valid),
            (torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(valid)))


@pytest.mark.parametrize("bits", [11, 32, 33, 70, 96])
def test_pack_bits_matches_jax(bits):
    rng = np.random.default_rng(bits)
    x = (rng.random((5, 3, bits)) < 0.5).astype(np.int32)
    want = np.asarray(jcam_ref.pack_bits(jnp.asarray(x)))
    got = tcam_ops.pack_bits(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 0).any() or bits < 32     # bit 31 set somewhere


@pytest.mark.parametrize("b,e,bits", SWEEP)
def test_cam_search_and_friends_match_jax(b, e, bits):
    (q, t, v), (tq, tt, tv) = _operands(b, e, bits, seed=b + e)
    jq, jt, jv = jnp.asarray(q), jnp.asarray(t), jnp.asarray(v)
    want = np.asarray(jcam_ops.cam_search(jq, jt, jv, impl="pallas",
                                          interpret=True))
    assert want.sum() > 0
    for impl in ("xla", "pallas"):
        got = tcam_ops.cam_search(tq, tt, tv, impl=impl)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tcam_ops.cam_first_match(tq, tt, tv, impl=impl).numpy(),
            np.asarray(jcam_ops.cam_first_match(jq, jt, jv, impl="pallas",
                                                interpret=True)))
        np.testing.assert_array_equal(
            tcam_ops.cam_search_speculative(tq, tt, tv, impl=impl).numpy(),
            np.asarray(jcam_ops.cam_search_speculative(
                jq, jt, jv, impl="pallas", interpret=True)))


@pytest.mark.parametrize("b,e,bits", PADDED + SWEEP[:2])
def test_cam_match_counts_matches_jax(b, e, bits):
    (q, t, v), (tq, tt, tv) = _operands(b, e, bits, seed=3 * b + e)
    want = np.asarray(jcam_ops.cam_match_counts(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(v), impl="pallas",
        interpret=True))
    assert want.sum() > 0
    for impl in ("xla", "pallas"):
        got = tcam_ops.cam_match_counts(tq, tt, tv, impl=impl)
        assert got.dtype == torch.int32 and got.shape == (b,)
        np.testing.assert_array_equal(got.numpy(), want)


def test_cam_match_counts_over_a_lane_axis():
    (q, t, v), (tq, tt, tv) = _operands(200, 300, 12, seed=5, lanes=3)
    v[1] = False
    tv = torch.from_numpy(v)
    got = tcam_ops.cam_match_counts(tq, tt, tv, impl="pallas")
    assert got.shape == (3, 200)
    for lane in range(3):
        want = jcam_ops.cam_match_counts(
            jnp.asarray(q), jnp.asarray(t), jnp.asarray(v[lane]),
            impl="pallas", interpret=True)
        np.testing.assert_array_equal(got[lane].numpy(), np.asarray(want))
    assert int(got[1].sum()) == 0
    empty = tcam_ops.cam_match_counts(tq, tt, tv[:0], impl="pallas")
    assert empty.shape == (0, 200)


@pytest.mark.parametrize("fn", ["cam_search", "cam_first_match",
                                "cam_search_speculative"])
def test_block_rule_and_impl_errors_match_jax(fn):
    (q, t, v), (tq, tt, tv) = _operands(200, 300, 12, seed=1)
    with pytest.raises(ValueError) as jerr:
        getattr(jcam_ops, fn)(jnp.asarray(q), jnp.asarray(t),
                              jnp.asarray(v), impl="pallas", interpret=True)
    with pytest.raises(ValueError) as terr:
        getattr(tcam_ops, fn)(tq, tt, tv, impl="pallas")
    assert str(terr.value) == str(jerr.value)
    assert "must divide block sizes (128,128)" in str(terr.value)
    for pkg, args in ((jcam_ops, (jnp.asarray(q), jnp.asarray(t),
                                  jnp.asarray(v))), (tcam_ops, (tq, tt, tv))):
        with pytest.raises(ValueError, match="unknown impl 'triton'"):
            getattr(pkg, fn)(*args, impl="triton")


def test_cuda_wrappers_refuse_cpu_tensors_without_building(monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(build, "load", no_build)
    _, (tq, tt, tv) = _operands(16, 32, 12, seed=2)
    before = cam_kernel.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cam_kernel.cam_search_cuda(tq, tt, tv)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cam_kernel.cam_match_counts_cuda(tq, tt, tv[None])
    tcam_ops.cam_match_counts(tq, tt, tv, impl="pallas")
    assert cam_kernel.launches == before
