"""The PyTorch port's LIF neuron update against the JAX package's.

Membrane states and currents are numpy arrays made from a seed and
handed to both packages; the JAX side runs its jitted ``impl="xla"`` op
and the Pallas kernel in interpret mode on the CPU, as
`tests/test_kernels.py` does.  The port's op takes its plain torch
version on CPU tensors.  The JAX update rounds ``v * decay + I`` once
(XLA fuses it into one multiply-add), so every comparison is bitwise:
tolerance 0.  Covered: the JAX test's shapes plus the SNN path's
(128, 4096), values exactly at and just below the threshold, a
membrane value where rounding through float64 would round twice, the
JAX semantics case, the gradient of the ``impl="xla"`` update, and the
errors: block rule, unknown impl, bfloat16, grad on the kernel path, a
CPU tensor handed to the CUDA wrapper.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lif_step import ops as jlif_ops
from repro_torch.kernels.lif_step import kernel as lif_kernel
from repro_torch.kernels.lif_step import ops as tlif_ops
from repro_torch.kernels.lif_step import ref as tlif_ref

SHAPES = [(8, 512), (16, 1024), (8, 4096), (32, 128), (128, 4096)]


def _state(shape, seed, threshold=1.0):
    """N(0, 3^2) v and I, with some elements landing exactly on the
    threshold (v = 0, I = threshold) and one float32 ulp below it."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(shape) * 3).astype(np.float32)
    i = (rng.standard_normal(shape) * 3).astype(np.float32)
    flat_v, flat_i = v.reshape(-1), i.reshape(-1)
    at = rng.choice(flat_v.size, size=max(4, flat_v.size // 64),
                    replace=False)
    half = len(at) // 2
    flat_v[at] = 0.0
    flat_i[at[:half]] = np.float32(threshold)
    flat_i[at[half:]] = np.nextafter(np.float32(threshold), np.float32(0))
    return v, i


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _jax(v, i, impl, **kw):
    out = jlif_ops.lif_step(jnp.asarray(v), jnp.asarray(i), impl=impl,
                            interpret=True, **kw)
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_plain_version_bitwise_equals_jax(shape, impl):
    v, i = _state(shape, seed=shape[0] * 7 + shape[1])
    kw = dict(decay=0.9, threshold=1.0)
    jv, js = _jax(v, i, "xla", **kw)
    jpv, jps = _jax(v, i, "pallas", **kw)
    np.testing.assert_array_equal(_bits(jv), _bits(jpv))   # JAX agrees
    tv, ts = tlif_ops.lif_step(torch.from_numpy(v), torch.from_numpy(i),
                               impl=impl, **kw)
    assert tv.dtype == ts.dtype == torch.float32
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    assert js.sum() > 0 and (js == 0).any()
    # the planted threshold values fire, the ones an ulp below do not
    at = (v == 0) & (i == np.float32(1.0))
    assert at.any() and (ts.numpy()[at] == 1).all()


def test_rounds_once_where_float64_rounds_twice():
    # a * b + c is just below a float32 midpoint by 2^-70: float64 rounds
    # the sum onto the midpoint and float32 then rounds it to even, one
    # ulp off; a fused multiply-add rounds once to c.
    a = np.float32(2.0 ** -24 * (1 + 2.0 ** -23))
    b = float(np.float32(1 - 2.0 ** -23))
    c = np.float32(1 + 2.0 ** -23)
    v, i = np.full((8, 128), a), np.full((8, 128), c)
    twice = (v.astype(np.float64) * b + i.astype(np.float64)).astype(
        np.float32)
    assert (_bits(twice) != _bits(i)).all()
    for impl in ("xla", "pallas"):
        jv, _ = _jax(v, i, impl, decay=b, threshold=4.0)
        tv, _ = tlif_ops.lif_step(torch.from_numpy(v), torch.from_numpy(i),
                                  decay=b, threshold=4.0, impl=impl)
        np.testing.assert_array_equal(_bits(jv), _bits(i))
        np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))


@pytest.mark.parametrize("v_reset", [0.0, -0.25])
def test_reset_and_scalar_rounding_match_jax(v_reset):
    v, i = _state((16, 512), seed=11, threshold=0.3)
    kw = dict(decay=0.7, threshold=0.3, v_reset=v_reset)   # not float32
    jv, js = _jax(v, i, "pallas", **kw)
    tv, ts = tlif_ops.lif_step(torch.from_numpy(v), torch.from_numpy(i),
                               impl="pallas", **kw)
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))


def test_semantics():
    v = torch.tensor([[0.5, 2.0, -1.0, 0.95]])
    vn, s = tlif_ops.lif_step(v, torch.zeros((1, 4)), decay=1.0,
                              threshold=1.0)
    assert s.tolist() == [[0.0, 1.0, 0.0, 0.0]]
    np.testing.assert_allclose(vn.numpy(), [[0.5, 0.0, -1.0, 0.95]],
                               rtol=1e-6)


def test_mul_add_once_gradient_matches_jax():
    v, i = _state((8, 128), seed=5)
    g = np.random.default_rng(6).standard_normal((8, 128)).astype(np.float32)

    def jfn(v, i):
        return jnp.sum((v * 0.9 + i) * g)

    jgv, jgi = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(i))
    tv = torch.from_numpy(v).requires_grad_()
    ti = torch.from_numpy(i).requires_grad_()
    (tlif_ref.mul_add_once(tv, 0.9, ti) * torch.from_numpy(g)).sum().backward()
    # exact: both are g * float32(0.9) and g
    np.testing.assert_array_equal(_bits(tv.grad.numpy()), _bits(jgv))
    np.testing.assert_array_equal(_bits(ti.grad.numpy()), _bits(jgi))


@pytest.mark.parametrize("shape", [(12, 512), (8, 700), (3, 1000)])
def test_block_rule_raises_like_jax(shape):
    v = np.zeros(shape, np.float32)
    with pytest.raises(ValueError) as jerr:
        jlif_ops.lif_step(jnp.asarray(v), jnp.asarray(v), decay=0.9,
                          threshold=1.0, impl="pallas", interpret=True)
    with pytest.raises(ValueError) as terr:
        tlif_ops.lif_step(torch.from_numpy(v), torch.from_numpy(v),
                          decay=0.9, threshold=1.0, impl="pallas")
    assert str(terr.value) == str(jerr.value)
    # the plain path has no block rule, in either package
    tlif_ops.lif_step(torch.from_numpy(v), torch.from_numpy(v), decay=0.9,
                      threshold=1.0, impl="xla")


def test_unknown_impl_raises_like_jax():
    v = np.zeros((8, 128), np.float32)
    with pytest.raises(ValueError) as jerr:
        jlif_ops.lif_step(jnp.asarray(v), jnp.asarray(v), decay=0.9,
                          threshold=1.0, impl="triton")
    with pytest.raises(ValueError) as terr:
        tlif_ops.lif_step(torch.from_numpy(v), torch.from_numpy(v),
                          decay=0.9, threshold=1.0, impl="triton")
    assert str(terr.value) == str(jerr.value) == "unknown impl 'triton'"


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bfloat16_is_refused_by_name(impl):
    v = torch.zeros((8, 512), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="bfloat16 lif_step"):
        tlif_ops.lif_step(v, v, decay=0.9, threshold=1.0, impl=impl)


def test_kernel_path_refuses_grad():
    v = torch.zeros((8, 512), requires_grad=True)
    i = torch.zeros((8, 512))
    with pytest.raises(RuntimeError, match="no backward"):
        tlif_ops.lif_step(v, i, decay=0.9, threshold=1.0, impl="pallas")
    with torch.no_grad():
        tlif_ops.lif_step(v, i, decay=0.9, threshold=1.0, impl="pallas")


def test_cuda_wrapper_refuses_cpu_tensors():
    before = lif_kernel.launches
    v = torch.zeros((8, 512))
    with pytest.raises(ValueError, match="CUDA"):
        lif_kernel.lif_step_cuda(v, v, 0.9, 1.0, 0.0)
    assert lif_kernel.launches == before
