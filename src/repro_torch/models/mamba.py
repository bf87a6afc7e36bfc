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
step against the (conv window, ssm state) cache.  On a mesh each rank
runs its block of d_inner (`mamba_apply`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.blocks import (LOCAL, Draw, ShardCtx, _dense_init,
                                      _linear, dtype_of)
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


def _split_uz(xz, ctx: ShardCtx):
    """(u, z) of this rank's d_inner block from ``xz``, this rank's block
    of ``x @ w_in``'s columns ``[u | z]``.

    On one device the two halves.  Inside the region of an enabled
    ``ctx``, ``w_in``'s columns are split contiguously over the M model
    ranks: of the 2M blocks of width di/M, rank s holds blocks 2s and
    2s + 1, and block j (u's when j < M, z's after) belongs to rank
    j mod M.  One all-to-all moves them (at M = 2 rank 0 holds all of u
    and rank 1 all of z): rank s sends one block to each of two ranks and
    receives its u block from rank s // 2 and its z block from rank
    (M + s) // 2, in that order.
    """
    c = xz.shape[-1] // 2
    if not ctx.enabled:
        return xz[..., :c], xz[..., c:]
    from repro_torch.parallel import regions as R
    m, s = ctx.model_size, R.model_index(ctx)
    blocks = sorted(((2 * s + i) % m, i) for i in range(2))  # (dest, block)
    send, recv = [0] * m, [0] * m
    for dest, _ in blocks:
        send[dest] += c
    for src in (s // 2, (m + s) // 2):
        recv[src] += c
    rows = xz.movedim(-1, 0)                               # (2c, B, T)
    rows = torch.cat([rows[i * c:(i + 1) * c] for _, i in blocks])
    uz = R.all_to_all(rows, send, recv, ctx).movedim(0, -1)
    return uz[..., :c], uz[..., c:]


def _sum_over_model(x, ctx: ShardCtx):
    """A row-parallel product's sum over the model ranks (inside the
    region of an enabled ``ctx``); ``x`` on one device."""
    if not ctx.enabled:
        return x
    from repro_torch.parallel import regions as R
    return R.psum(x, ctx)


def mamba_apply(p, x, cfg: ModelConfig, state=None, ctx: ShardCtx = LOCAL):
    """x (B,T,d) -> (y, new_state).  state: dict(conv, ssm) or None.

    Under an enabled ``ctx`` (DTensors placed by the port's specs) each
    rank runs its block of d_inner over the model axis, as GSPMD runs
    the JAX package's layer on its specs: ``x @ w_in`` column-parallel,
    the placed columns exchanged into the rank's (u, z) blocks
    (`_split_uz`); the causal conv, the SSM scan and the gate on the
    block; ``u @ w_bc`` and ``u @ w_dt_a`` row-parallel, their small sums
    reduced over ``model``; ``w_dt_b`` column-parallel; ``w_out``
    row-parallel, so ``y`` is a `Partial` sum.  The state stays split
    over d_inner as `parallel.sharding.cache_pspecs` places it.

    Raises:
      ValueError: under an enabled ``ctx`` whose model size does not
        divide d_inner (the weights would not split alike).
    """
    if not ctx.enabled:
        return _mamba(p, x, cfg, state, ctx)
    if d_inner(cfg) % ctx.model_size:
        raise ValueError(f"d_inner {d_inner(cfg)} does not split over "
                         f"{ctx.model_size} model ranks")
    from repro_torch.parallel import regions as R
    return R.layer_region(lambda p_, x_, s_: _mamba(p_, x_, cfg, s_, ctx),
                          ctx, p, x, state, partial=True)


def _mamba(p, x, cfg: ModelConfig, state, ctx: ShardCtx):
    """`mamba_apply` on one device, or on this rank's d_inner block
    inside the region of an enabled ``ctx``."""
    m = cfg.mamba
    bsz, t, _ = x.shape
    dt_ = x.dtype
    di = p["d_skip"].shape[0]                              # this rank's
    u, z = _split_uz(_linear(x, p["w_in"], dt_), ctx)      # (B,T,di) each

    conv_state = state["conv"] if state is not None else None
    u_c, new_conv = _causal_conv(u, p["conv_w"].to(dt_),
                                 p["conv_b"].to(dt_), conv_state)
    u_c = F.silu(u_c)

    bc = _sum_over_model(u_c @ p["w_bc"].to(dt_), ctx)     # (B,T,2N)
    b_t, c_t = bc[..., :m.d_state], bc[..., m.d_state:]
    dt_low = _sum_over_model(u_c @ p["w_dt_a"].to(dt_), ctx)
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
    out = _linear(y, p["w_out"], dt_)
    new_state = None
    if state is not None:
        new_state = {"conv": new_conv, "ssm": new_ssm}
    return out, new_state
