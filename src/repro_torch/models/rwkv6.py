"""RWKV6 "Finch" layer: data-dependent-decay time mix and channel mix.

Port of `repro.models.rwkv6` (arXiv:2404.05892 at the block level):
ddlerp token shift with a low-rank MLP producing the five mix
coefficients, a per-channel data-dependent decay ``w_t = exp(-exp(d_t))``
from a LoRA head (in float32 whatever the compute type), the bonus term
``u``, a per-head RMS group norm, a silu output gate, and a relu^2
channel mix.

Two equivalent WKV evaluators, plain torch as they are plain jnp in the
JAX package:

  * `wkv_recurrent` - token by token (decode, and any T the chunked form
    does not take);
  * `wkv_chunked` - chunks of `CHUNK` tokens, each in the JAX package's
    factored form: ``exp(lw_before)`` on r and ``exp(-lw_cum)`` on k
    (``exp(decay)`` is clamped at `DECAY_CLAMP`, so the factors stay in
    float32 range: up to e^64 over a chunk), the strictly lower
    triangle, the bonus diagonal, the state term and the state update.
    Everything that does not read the carried state is computed for all
    chunks at once; a Python loop over chunks (where JAX scans) carries
    only the state, two ops a chunk, and the state term then reads the
    state each chunk started from.  Each output element sums its terms
    in the JAX order.

State is float32; activations are in the compute type outside the WKV.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.blocks import Draw, _dense_init, dtype_of, rms_norm
from repro_torch.models.config import ModelConfig

CHUNK = 16
DECAY_CLAMP = 4.0  # exp(decay_logit) clamp; w >= exp(-4) per step


def init_time_mix(draw: Draw, cfg: ModelConfig):
    d = cfg.d_model
    r = cfg.rwkv
    h = d // r.head_dim
    pdt = dtype_of(cfg.param_dtype)
    u = 0.5 * (torch.arange(d) % r.head_dim).float() / r.head_dim
    return {
        "maa_base": draw.zeros((5, d), pdt),
        "maa_x": draw.zeros((d,), pdt),
        "maa_w1": _dense_init(draw, (d, 5 * r.lora_mix), pdt, scale=1e-3),
        "maa_w2": _dense_init(draw, (5, r.lora_mix, d), pdt, scale=1e-3),
        "decay_base": draw.const(torch.full((d,), -1.0), pdt),
        "decay_w1": _dense_init(draw, (d, r.lora_decay), pdt, scale=1e-3),
        "decay_w2": _dense_init(draw, (r.lora_decay, d), pdt, scale=1e-3),
        "bonus": draw.const(u.reshape(h, r.head_dim), pdt),
        "wr": _dense_init(draw, (d, d), pdt),
        "wk": _dense_init(draw, (d, d), pdt),
        "wv": _dense_init(draw, (d, d), pdt),
        "wg": _dense_init(draw, (d, d), pdt),
        "wo": _dense_init(draw, (d, d), pdt),
        "ln_x": {"scale": draw.zeros((d,), pdt)},
    }


def init_channel_mix(draw: Draw, cfg: ModelConfig):
    d, dff = cfg.d_model, cfg.d_ff
    pdt = dtype_of(cfg.param_dtype)
    return {
        "maa_k": draw.zeros((d,), pdt),
        "maa_r": draw.zeros((d,), pdt),
        "wk": _dense_init(draw, (d, dff), pdt),
        "wv": _dense_init(draw, (dff, d), pdt),
        "wr": _dense_init(draw, (d, d), pdt),
    }


def _token_shift(x, prev):
    """x (B,T,d), prev (B,1,d) -> previous-token stream."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(p, x, xs):
    """Data-dependent lerp producing the five mixed streams (w,k,v,r,g)."""
    dt = x.dtype
    dx = xs - x
    xxx = x + dx * p["maa_x"].to(dt)
    b, t, d = x.shape
    mixer = torch.tanh(xxx @ p["maa_w1"].to(dt))          # (B,T,5*rank)
    rank = mixer.shape[-1] // 5
    mixer = mixer.reshape(b, t, 5, rank)
    offs = torch.einsum("btfr,frd->btfd", mixer, p["maa_w2"].to(dt))
    base = p["maa_base"].to(dt)                            # (5, d)
    mixed = x[:, :, None, :] + dx[:, :, None, :] * (base + offs)
    return list(mixed.unbind(2))                           # w,k,v,r,g


def wkv_recurrent(r, k, v, w, u, state):
    """Token-by-token WKV.  r,k,v,w: (B,T,H,D) f32; u: (H,D); state (B,H,D,D).

    S[i,j] accumulates k[i]*v[j] with per-i decay; out[j] = sum_i r[i] *
    (S_prev[i,j] + u[i]*k[i]*v[j]).
    """
    outs = []
    s = state
    for r_t, k_t, v_t, w_t in zip(*(a.unbind(1) for a in (r, k, v, w))):
        kv = k_t[..., :, None] * v_t[..., None, :]        # (B,H,D,D)
        outs.append(torch.einsum("bhi,bhij->bhj", r_t,
                                 s + u[None][..., None] * kv))
        s = w_t[..., :, None] * s + kv
    return torch.stack(outs, dim=1), s                    # (B,T,H,D)


def wkv_chunked(r, k, v, w, u, state, chunk: int = CHUNK):
    """Chunked parallel WKV (f32), equal to `wkv_recurrent` within float32
    rounding.

    Chunks of ``chunk`` tokens: intra-chunk via the bounded factored
    kernel, inter-chunk via the carried state.
    """
    b, t, h, d = r.shape
    if t % chunk:
        raise ValueError(f"T={t} must divide chunk={chunk}")
    nc = t // chunk
    re, ke, ve, we = [a.reshape(b, nc, chunk, h, d).permute(1, 0, 3, 2, 4)
                      for a in (r, k, v, w)]              # (nc,B,H,C,D)
    lw = torch.log(we)                                    # <= 0
    lw_cum = torch.cumsum(lw, dim=-2)                     # inclusive in chunk
    tri_lower = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                      device=r.device), diagonal=-1)

    # decay from chunk start to just before token t (exclusive of t);
    # lw_before in [-C*clamp, 0] (exp <= 1), -lw_cum in [0, C*clamp]
    lw_before = lw_cum - lw
    r_dec = re * torch.exp(lw_before)
    k_dec = ke * torch.exp(-lw_cum)
    a = torch.einsum("nbhti,nbhji->nbhtj", r_dec, k_dec)
    a = torch.where(tri_lower, a, 0.0)
    diag = torch.einsum("nbhti,nbhti->nbht", re * u[None, None, :, None, :],
                        ke)
    out = torch.einsum("nbhtj,nbhjd->nbhtd", a, ve)
    out = out + diag[..., None] * ve
    # state update: decay the full chunk, inject each k_j v_j decayed to the
    # chunk's end
    decay_all = torch.exp(lw_cum[..., -1, :])[..., :, None]   # (nc,B,H,D,1)
    k_tail = ke * torch.exp(lw_cum[..., -1:, :] - lw_cum)
    inject = torch.einsum("nbhji,nbhjd->nbhid", k_tail, ve)
    starts = []
    s = state
    # unbound once: under autograd a slice a chunk would scatter each
    # chunk's gradient into a zero tensor of all the chunks
    for decay_c, inject_c in zip(decay_all.unbind(0), inject.unbind(0)):
        starts.append(s)
        s = decay_c * s + inject_c
    # cross-chunk: the state each chunk started from, decayed to before t
    out = out + torch.einsum("nbhti,nbhid->nbhtd", r_dec,
                             torch.stack(starts))
    # (nc, B, H, C, D) -> (B, T, H, D)
    return out.permute(1, 0, 3, 2, 4).reshape(b, t, h, d), s


def time_mix_apply(p, x, cfg: ModelConfig, state=None, chunked=True):
    """x (B,T,d) -> (out, new_state).  state: dict(prev_x_tm, wkv) or None.

    With cfg.rwkv_pad_heads = H' > H the WKV runs on H' heads, the pad
    heads zero with decay 1, and is sliced back to H: it changes no
    value (the JAX package pads so that the heads shard over a mesh).
    """
    b, t, d = x.shape
    r_cfg = cfg.rwkv
    h = d // r_cfg.head_dim
    dt = x.dtype
    prev_x = (state["prev_x_tm"] if state is not None
              else torch.zeros((b, 1, d), dtype=dt, device=x.device))
    xs = _token_shift(x, prev_x.to(dt))
    xw, xk, xv, xr, xg = _ddlerp(p, x, xs)

    decay_logit = (p["decay_base"].float()
                   + torch.tanh(xw.float() @ p["decay_w1"].float())
                   @ p["decay_w2"].float())
    w = torch.exp(-torch.clamp_max(torch.exp(decay_logit), DECAY_CLAMP))

    r = (xr @ p["wr"].to(dt)).reshape(b, t, h, r_cfg.head_dim)
    k = (xk @ p["wk"].to(dt)).reshape(b, t, h, r_cfg.head_dim)
    v = (xv @ p["wv"].to(dt)).reshape(b, t, h, r_cfg.head_dim)
    g = F.silu(xg @ p["wg"].to(dt))

    h_pad = max(cfg.rwkv_pad_heads, h)
    u = p["bonus"].float()
    w4 = w.reshape(b, t, h, r_cfg.head_dim)
    wkv_state = (state["wkv"] if state is not None else torch.zeros(
        (b, h, r_cfg.head_dim, r_cfg.head_dim), dtype=torch.float32,
        device=x.device))
    if h_pad > h:
        pads = (0, 0, 0, h_pad - h)
        r, k, v = (F.pad(a, pads) for a in (r, k, v))
        w4 = F.pad(w4, pads, value=1.0)                    # decay 1 on pads
        u = F.pad(u, (0, 0, 0, h_pad - h))
        wkv_state = F.pad(wkv_state, (0, 0, 0, 0, 0, h_pad - h))

    args = (r.float(), k.float(), v.float(), w4.float(), u,
            wkv_state.float())
    if chunked and t % r_cfg.chunk == 0 and t > 1:
        o, new_wkv = wkv_chunked(*args, chunk=r_cfg.chunk)
    else:
        o, new_wkv = wkv_recurrent(*args)

    if h_pad > h:
        o = o[:, :, :h]
        new_wkv = new_wkv[:, :h]

    # per-head group norm (per-channel scale reshaped to heads)
    ln = {"scale": p["ln_x"]["scale"].reshape(h, r_cfg.head_dim)}
    o = rms_norm(o, ln, eps=1e-5 * 64)                    # (B,T,H,D) per head
    o = o.reshape(b, t, d).to(dt) * g
    out = o @ p["wo"].to(dt)
    new_state = None
    if state is not None:
        new_state = dict(state)
        new_state["prev_x_tm"] = x[:, -1:, :]
        new_state["wkv"] = new_wkv
    return out, new_state


def channel_mix_apply(p, x, cfg: ModelConfig, state=None):
    b, t, d = x.shape
    dt = x.dtype
    prev_x = (state["prev_x_cm"] if state is not None
              else torch.zeros((b, 1, d), dtype=dt, device=x.device))
    xs = _token_shift(x, prev_x.to(dt))
    dx = xs - x
    xk = x + dx * p["maa_k"].to(dt)
    xr = x + dx * p["maa_r"].to(dt)
    k = torch.square(F.relu(xk @ p["wk"].to(dt)))
    out = torch.sigmoid(xr @ p["wr"].to(dt)) * (k @ p["wv"].to(dt))
    new_state = None
    if state is not None:
        new_state = dict(state)
        new_state["prev_x_cm"] = x[:, -1:, :]
    return out, new_state
