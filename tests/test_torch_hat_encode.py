"""The PyTorch port's hierarchical address-event encoding against the JAX
package's.

Spike bitmaps are numpy arrays made from a seed and handed to both
packages; the JAX side runs the Pallas kernel in interpret mode on the
CPU, as `tests/test_kernels.py` does.  The port's ops take their plain
torch versions on CPU tensors.  Every output is an integer, so every
comparison is exact.  Covered: `hat_encode` and `encode_stream` over the
(N, row) x rate sweep of `tests/test_kernels.py`, leading batch axes, the
plain branch at an N that is not a multiple of ``row``, the errors both
packages raise, and that the CUDA wrapper refuses CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hat_encode import ops as jhat_ops
from repro_torch.kernels import build
from repro_torch.kernels.hat_encode import kernel as hat_kernel
from repro_torch.kernels.hat_encode import ops as that_ops


def _bitmaps(shape, rate, seed):
    return np.random.default_rng(seed).random(shape) < rate


def _assert_matches_jax(frame, row, t_out, t_stream, t_count):
    """One (N,) frame's port outputs against the JAX pallas ops."""
    j = jnp.asarray(frame)
    want = jhat_ops.hat_encode(j, row=row, impl="pallas", interpret=True)
    for g, w in zip(t_out, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    stream, count = jhat_ops.encode_stream(j, row=row, impl="pallas",
                                           interpret=True)
    np.testing.assert_array_equal(t_stream.numpy(), np.asarray(stream))
    assert int(t_count) == int(count)


@pytest.mark.parametrize("n,row", [(256, 256), (1024, 256), (4096, 128),
                                   (65536, 256)])
@pytest.mark.parametrize("rate", [0.0, 0.05, 1.0])
def test_hat_encode_sweep_matches_jax(n, row, rate):
    frame = _bitmaps((n,), rate, seed=n)
    spikes = torch.from_numpy(frame)
    out = that_ops.hat_encode(spikes, row=row, impl="pallas")
    stream, count = that_ops.encode_stream(spikes, row=row, impl="pallas")
    assert out[2].shape == (n // row,)
    _assert_matches_jax(frame, row, out, stream, count)


def test_batch_axes_match_jax_frame_by_frame():
    frames = _bitmaps((3, 2, 512), 0.3, seed=4)
    frames[0, 1] = False
    frames[2, 0] = True
    spikes = torch.from_numpy(frames)
    out = that_ops.hat_encode(spikes, impl="pallas")
    stream, count = that_ops.encode_stream(spikes, impl="pallas")
    assert out[0].shape == (3, 2, 512) and out[1].shape == (3, 2)
    assert out[2].shape == (3, 2, 2) and stream.shape == (3, 2, 512)
    for i in range(3):
        for j in range(2):
            _assert_matches_jax(frames[i, j], 256,
                                [o[i, j] for o in out], stream[i, j],
                                count[i, j])


@pytest.mark.parametrize("n", [16, 300])
def test_plain_branch_off_the_row_grid_matches_jax(n):
    frame = _bitmaps((n,), 0.3, seed=n)
    got = that_ops.hat_encode(torch.from_numpy(frame), impl="xla")
    want = jhat_ops.hat_encode(jnp.asarray(frame), impl="xla")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].shape == (n,)          # row falls back to 1


@pytest.mark.parametrize("n", [300, (1 << 16) + 256])
def test_pallas_limits_raise_as_in_jax(n):
    frame = np.zeros(n, dtype=bool)
    for fn in ("hat_encode", "encode_stream"):
        with pytest.raises(ValueError) as jerr:
            getattr(jhat_ops, fn)(jnp.asarray(frame), impl="pallas",
                                  interpret=True)
        with pytest.raises(ValueError) as terr:
            getattr(that_ops, fn)(torch.from_numpy(frame), impl="pallas")
        assert str(terr.value) == str(jerr.value)
        assert f"got N={n}" in str(terr.value)


def test_unknown_impl_raises_as_in_jax():
    frame = np.zeros(256, dtype=bool)
    with pytest.raises(ValueError, match="unknown impl 'cuda'"):
        jhat_ops.hat_encode(jnp.asarray(frame), impl="cuda")
    with pytest.raises(ValueError, match="unknown impl 'cuda'"):
        that_ops.hat_encode(torch.from_numpy(frame), impl="cuda")


def test_cuda_wrapper_refuses_cpu_tensors_without_building(monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(build, "load", no_build)
    spikes = torch.zeros((4, 256), dtype=torch.bool)
    before = hat_kernel.launches
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        hat_kernel.hat_encode_cuda(spikes, row=256, stream=True)
    that_ops.encode_stream(spikes, impl="pallas")
    assert hat_kernel.launches == before
