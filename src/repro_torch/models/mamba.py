"""Mamba (selective SSM) layer of the Jamba hybrid architecture.

Port of `repro.models.mamba`.  Selective state-space recurrence with
diagonal A:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

Prefill and training: the per-step decay and input are built in float32
for the whole sequence, as the JAX package builds them, then scanned in
chunks of `SCAN_CHUNK` steps: within a chunk by `associative_scan`, the
odd/even recursion of ``jax.lax.associative_scan`` (so the float32
products and sums come in the JAX package's order, in 2 log2(chunk)
levels of batched ops), the chunk boundary state carried by a Python
loop where JAX scans.  Decode (and a one-token prefill): one recurrence
step against the (conv window, ssm state) cache.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.blocks import Draw, _dense_init, dtype_of
from repro_torch.models.config import ModelConfig

SCAN_CHUNK = 512


def d_inner(cfg: ModelConfig) -> int:
    return cfg.mamba.expand * cfg.d_model


def dt_rank(cfg: ModelConfig) -> int:
    return cfg.mamba.dt_rank or max(1, cfg.d_model // 16)


def init_mamba(draw: Draw, cfg: ModelConfig):
    m = cfg.mamba
    d, di, dr = cfg.d_model, d_inner(cfg), dt_rank(cfg)
    pdt = dtype_of(cfg.param_dtype)
    a = torch.arange(1, m.d_state + 1, dtype=torch.float32).expand(
        di, m.d_state)
    return {
        "w_in": _dense_init(draw, (d, 2 * di), pdt),
        "conv_w": _dense_init(draw, (m.d_conv, di), pdt),
        "conv_b": draw.zeros((di,), pdt),
        "w_bc": _dense_init(draw, (di, 2 * m.d_state), pdt),
        "w_dt_a": _dense_init(draw, (di, dr), pdt),
        "w_dt_b": _dense_init(draw, (dr, di), pdt),
        "dt_bias": draw.const(torch.full((di,), math.log(math.e - 1) * 0.1),
                              pdt),
        # stored in the parameter type (bfloat16 for jamba), as in JAX
        "a_log": draw.const(torch.log(a), pdt),
        "d_skip": draw.const(torch.ones((di,)), pdt),
        "w_out": _dense_init(draw, (di, d), pdt),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv1d.  x (B,T,di); w (K,di); returns (y, new_state).

    The taps sum in the JAX package's order: 0 + tap 0 + tap 1 + ...
    """
    k = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                        # (B, T+K-1, di)
    y = 0
    for i in range(k):
        y = y + xp[:, i:i + x.shape[1]] * w[i][None, None]
    y = y + b[None, None]
    new_state = xp[:, -(k - 1):] if k > 1 else None
    return y, new_state


def _combine(p, q):
    """(a, b) pairs compose as (a2*a1, a2*b1 + b2); ``p`` the earlier."""
    return p[0] * q[0], q[0] * p[1] + q[1]


def _interleave(a, b, axis):
    """a at the even positions along ``axis``, b at the odd ones
    (len(a) == len(b) or len(b) + 1)."""
    n = a.shape[axis] + b.shape[axis]
    if a.shape[axis] > b.shape[axis]:
        b = torch.cat([b, torch.zeros_like(a.narrow(axis, 0, 1))], dim=axis)
    both = torch.stack([a, b], dim=axis + 1)
    return both.flatten(axis, axis + 1).narrow(axis, 0, n)


def associative_scan(elems, axis):
    """Inclusive scan of ``elems`` (a pair of tensors) with `_combine`
    along ``axis``: ``jax.lax.associative_scan``'s odd/even recursion."""
    num = elems[0].shape[axis]
    if num < 2:
        return elems

    def sl(e, start, stop, step=1):
        idx = [slice(None)] * e.dim()
        idx[axis] = slice(start, stop, step)
        return e[tuple(idx)]

    reduced = _combine([sl(e, 0, -1, 2) for e in elems],
                       [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(reduced, axis)
    if num % 2 == 0:
        even = _combine([sl(e, 0, -1) for e in odd],
                        [sl(e, 2, None, 2) for e in elems])
    else:
        even = _combine(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim=axis)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, axis) for e, o in zip(even, odd)]


def _ssm_scan_chunked(u, dt, b_t, c_t, a, ssm_state):
    """u,dt (B,T,di); b_t,c_t (B,T,N); a (di,N); state (B,di,N) f32."""
    bsz, t, di = u.shape
    n = a.shape[1]
    chunk = min(SCAN_CHUNK, t)
    if t % chunk:
        raise ValueError(f"T={t} must divide chunk={chunk}")
    nc = t // chunk
    # per-step decay and input in f32, for the whole sequence
    dt_f = dt.float()
    decay = torch.exp(dt_f[..., None] * (-torch.exp(a.float()))[None, None])
    inp = (dt_f * u.float())[..., None] * b_t.float()[:, :, None, :]

    dec_c = decay.reshape(bsz, nc, chunk, di, n).unbind(1)
    inp_c = inp.reshape(bsz, nc, chunk, di, n).unbind(1)
    c_c = c_t.float().reshape(bsz, nc, chunk, n).unbind(1)
    h = ssm_state.float()
    ys = []
    for dec, xin, c in zip(dec_c, inp_c, c_c):
        a_cum, b_cum = associative_scan((dec, xin), axis=1)
        states = a_cum * h[:, None] + b_cum               # (B,chunk,di,N)
        ys.append(torch.einsum("btdn,btn->btd", states, c))
        h = states[:, -1]
    y = torch.stack(ys, dim=1).reshape(bsz, t, di)
    return y, h


def mamba_apply(p, x, cfg: ModelConfig, state=None):
    """x (B,T,d) -> (y, new_state).  state: dict(conv, ssm) or None."""
    m = cfg.mamba
    bsz, t, _ = x.shape
    dt_ = x.dtype
    di = d_inner(cfg)
    xz = x @ p["w_in"].to(dt_)                             # (B,T,2*di)
    u, z = xz[..., :di], xz[..., di:]

    conv_state = state["conv"] if state is not None else None
    u_c, new_conv = _causal_conv(u, p["conv_w"].to(dt_),
                                 p["conv_b"].to(dt_), conv_state)
    u_c = F.silu(u_c)

    bc = u_c @ p["w_bc"].to(dt_)                           # (B,T,2N)
    b_t, c_t = bc[..., :m.d_state], bc[..., m.d_state:]
    dt_low = u_c @ p["w_dt_a"].to(dt_)
    delta = F.softplus(dt_low @ p["w_dt_b"].to(dt_)
                       + p["dt_bias"].to(dt_))             # (B,T,di)

    ssm_state = (state["ssm"] if state is not None else torch.zeros(
        (bsz, di, m.d_state), dtype=torch.float32, device=x.device))
    if t == 1:
        # decode: single recurrence step
        dec = torch.exp(delta.float()[..., None]
                        * (-torch.exp(p["a_log"].float()))[None, None])
        xin = (delta.float() * u_c.float())[..., None] \
            * b_t.float()[:, :, None, :]
        h = dec[:, 0] * ssm_state.float() + xin[:, 0]
        y = torch.einsum("bdn,bn->bd", h, c_t.float()[:, 0])[:, None]
        new_ssm = h
    else:
        y, new_ssm = _ssm_scan_chunked(u_c, delta, b_t, c_t, p["a_log"],
                                       ssm_state)
    y = y.to(dt_) + u_c * p["d_skip"].to(dt_)[None, None]
    y = y * F.silu(z)
    out = y @ p["w_out"].to(dt_)
    new_state = None
    if state is not None:
        new_state = {"conv": new_conv, "ssm": new_ssm}
    return out, new_state
