"""Plain torch oracle for the lif_step kernel.

Port of `repro.kernels.lif_step.ref`.  On float32 the JAX reference
computes ``v * decay + current`` with one rounding: XLA contracts the
multiply and the add into a fused multiply-add, in its jitted
``impl="xla"`` path as in the Pallas kernel, and the CUDA kernel spells
out ``__fmaf_rn``.  Eager torch rounds the product and then the sum,
which differs in about a fifth of the membrane values, so this module
computes the fused form itself (`mul_add_once`): exact in float64,
independent of the device and of how torch's own kernels were compiled.

On bfloat16 JAX rounds twice, under both impls: the three scalars are
rounded to bfloat16 first (the Pallas kernel's parameter array has the
operand's type, the ``xla`` reference multiplies by a weakly typed
float), the product ``v * decay`` (exact in float32) is rounded to
bfloat16, and the sum is a float32 addition of the two bfloat16 values
rounded to bfloat16 (`mul_add_bf16`).
"""

from __future__ import annotations

import torch


def _fma_f32(v: torch.Tensor, decay: float, current: torch.Tensor):
    """float32 ``v * decay + current`` rounded once, as an FMA rounds it.

    The product of two float32 values is exact in float64.  Rounding the
    float64 sum and then rounding that to float32 can round twice wrongly
    when the first result lands on a float32 midpoint, so the sum is
    rounded to odd first: the exact error of the float64 sum (TwoSum)
    says where the exact value lies, and an inexact sum with an even last
    bit steps one float64 ulp towards it.  53 bits rounded to odd and
    then to 24 bits to nearest is the correctly rounded result.
    """
    p = v.double() * decay                      # exact
    c = current.double()
    s = p + c
    b = s - p
    err = (p - (s - b)) + (c - b)               # p + c == s + err exactly
    bits = s.view(torch.int64)
    even_inexact = (err != 0) & ((bits & 1) == 0)
    towards_err = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where(even_inexact, bits + towards_err, bits)
    return bits.view(torch.float64).to(torch.float32)


class _MulAddOnce(torch.autograd.Function):
    """`_fma_f32` with the gradient of ``v * decay + current``."""

    @staticmethod
    def forward(ctx, v, current, decay):
        ctx.decay = decay
        return _fma_f32(v, decay, current)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.decay, grad, None


def as_float32(x: float) -> float:
    """``x`` rounded to float32, as ``jnp.array(x, jnp.float32)`` does."""
    return torch.tensor(x, dtype=torch.float32).item()


def mul_add_once(v: torch.Tensor, decay: float, current: torch.Tensor):
    """float32 ``v * decay + current`` with one rounding; differentiable in
    ``v`` and ``current``.  ``decay`` is rounded to float32 first."""
    return _MulAddOnce.apply(v, current, as_float32(decay))


def as_bfloat16(x: float) -> float:
    """``x`` rounded to bfloat16 (to nearest, ties to even)."""
    return torch.tensor(x, dtype=torch.float32).to(torch.bfloat16).item()


def mul_add_bf16(v: torch.Tensor, decay: float, current: torch.Tensor):
    """bfloat16 ``v * decay + current`` rounded as JAX rounds it: the
    product (exact in float32) to bfloat16, then the float32 sum of the
    two bfloat16 values to bfloat16.  ``decay`` is rounded to bfloat16
    first."""
    prod = (v.float() * as_bfloat16(decay)).to(torch.bfloat16)
    return (prod.float() + current.float()).to(torch.bfloat16)


def lif_step_ref(v: torch.Tensor, current: torch.Tensor, *, decay: float,
                 threshold: float, v_reset: float = 0.0):
    """One leaky-integrate-and-fire update.

    v, current: (..., N), both float32 or both bfloat16
    returns (v_next, spikes {0,1}) in that type; ``decay``, ``threshold``
    and ``v_reset`` are rounded to it first, as the TPU kernel's
    parameter array is.
    """
    if v.dtype == torch.bfloat16:
        v_new, rounded = mul_add_bf16(v, decay, current), as_bfloat16
    else:
        v_new, rounded = mul_add_once(v, decay, current), as_float32
    spikes = (v_new.float() >= rounded(threshold)).to(v.dtype)
    v_next = torch.where(spikes > 0, rounded(v_reset), v_new)
    return v_next, spikes
