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

import math

import torch
import torch.nn.functional as F

from repro_torch.models.blocks import (LOCAL, Draw, ShardCtx, _dense_init,
                                      _linear, dtype_of, rms_norm)
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
    mixer = torch.tanh(_linear(xxx, p["maa_w1"], dt))     # (B,T,5*rank)
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


def time_mix_apply(p, x, cfg: ModelConfig, state=None, chunked=True,
                   ctx: ShardCtx = LOCAL):
    """x (B,T,d) -> (out, new_state).  state: dict(prev_x_tm, wkv) or None.

    With cfg.rwkv_pad_heads = H' > H the WKV runs on H' heads, the pad
    heads zero with decay 1, and is sliced back to H: it changes no
    value (the JAX package pads so that the heads shard over a mesh).

    Under an enabled ``ctx`` (DTensors placed by the port's specs, the
    time mix's weights whole over the model axis and split over the data
    axes) each rank runs the layer on its batch shard, its products
    through `blocks._linear`: at decode each FSDP block moves to the
    model ranks and the products run row-parallel there, at one
    sequence the blocks stay in place, as GSPMD partitions the JAX
    package's steps.  At H' > H with H' a multiple of the model size
    (`head_split`) the WKV runs on a head split over ``model``, H'/model
    heads a rank:

    * with a state (prefill, decode) the cache holds the H heads split
      over ``model`` (`sharding.cache_pspecs`: DTensor's blocks of
      ceil(H / model) heads, `sharding.block`), and each rank runs the WKV
      on its own block of r, k, v, decay and state padded to H'/model
      heads, and writes its block back: no collective moves the state.
      GSPMD moves some: the JAX package's decode step at H' = 48 on
      16 x 16 gathers 3 padded heads to 6 over pairs of model ranks and
      returns each rank 5 of the 40 (``f32[1,8,5,64,64]``), its output's
      placement being XLA's to choose; read out whole, the port's state
      is the H heads' as on one device.
      Where it moves fewer bytes at decode (`own_heads`), the whole layer
      runs on the rank's heads: the columns of r, k, v, the decay and
      the gate of its heads alone (their weights' column blocks, gathered
      over the data axes in one call where FSDP splits their rows), the
      per-head norm and the gate on them, ``wo`` row-parallel on their
      rows, its partial sum reduced once over ``model``
      (`lm._reduced_like`); otherwise the products run whole and the
      output heads are gathered before the per-head norm, the gate and
      ``wo``;
    * without (the train step) the padded r, k, v and decay split over
      ``model`` by heads (the JAX package's ``with_sharding_constraint``),
      and the new state is gathered whole.

    At H' = H the WKV runs whole on every model rank, as in the JAX
    package.
    """
    if not ctx.enabled:
        return _time_mix(p, x, cfg, state, chunked, ctx)
    from repro_torch.parallel import regions as R
    heads = own_heads(p, x, cfg, state, ctx)
    blocks = None
    if heads is not None:
        hd = cfg.rwkv.head_dim
        cols = (1, heads[0] * hd, heads[1] * hd)
        blocks = {k: cols for k in HEAD_COLUMNS + ("decay_w2",)}
        blocks["wo"] = (0,) + cols[1:]
    return R.layer_region(
        lambda p_, x_, s_: _time_mix(p_, x_, cfg, s_, chunked, ctx, heads),
        ctx, p, x, state, partial=heads is not None, blocks=blocks)


def head_split(cfg: ModelConfig, ctx: ShardCtx) -> bool:
    """Does the WKV run on a head split over ``model`` under ``ctx``
    (``rwkv_pad_heads`` H' > H, a multiple of the model size)?"""
    h = cfg.d_model // cfg.rwkv.head_dim
    pad = cfg.rwkv_pad_heads
    return ctx.enabled and pad > h and pad % ctx.model_size == 0


# the time mix's products whose columns are its heads' (``wo``'s rows)
HEAD_COLUMNS = ("wr", "wk", "wv", "wg")


def own_heads(p, x, cfg: ModelConfig, state, ctx: ShardCtx):
    """(first, n): this rank's block of the H heads (`sharding.block`)
    where a serve step runs the whole time mix on it, or None.

    On a head split with a state and no gradient recorded, two
    partitions: (a) the whole layer on the rank's heads: the columns of
    `HEAD_COLUMNS` and the rows of ``wo`` of its heads
    (`regions.block_of`: where the data axes split a weight's rows, only
    the column block gathered over them in one call; ``wo``'s rows,
    split there, gathered whole), the per-head norm and the gate on its
    heads, ``wo`` row-parallel and its partial sum reduced once over
    ``model``; or (b) the products whole (`regions.product_plan` each:
    at decode on 16 x 16 the permute) and the WKV's output heads
    gathered over ``model``.  The cheaper in bytes a rank moves at the
    decode step (one token a sequence), counted for a block of
    H'/model heads so that every rank chooses alike: (a) the blocks'
    gathers and the partial sum's all-reduce, (b) the five plans'
    bytes and the output heads' gather; ``decay_w2`` moves alike in
    both (gathered whole) and is left out.  A prefill takes the decode
    step's choice: a request's steps run one partition.  GSPMD's at
    ``rwkv_pad_heads`` 48 on 2 x 16 x 16 is (a) but for ``wo``: it
    gathers (2560, 320) column blocks of ``wr``, ``wk``, ``wv`` and
    ``wg``, the gated heads over ``model`` and ``wo`` whole."""
    from repro_torch.ckpt.manager import tree_leaves
    from repro_torch.models.blocks import _bspec_for
    from repro_torch.parallel import regions as R
    from repro_torch.parallel.sharding import block
    if (state is None or not head_split(cfg, ctx)
            or R.recorded(x, *tree_leaves(p))):
        return None
    hd = cfg.rwkv.head_dim
    h, d = cfg.d_model // hd, cfg.d_model
    width = cfg.rwkv_pad_heads // ctx.model_size * hd
    b = x.shape[0]
    bspec = _bspec_for(ctx, b)
    rows = (b // math.prod(n for _, n in R.data_coords(ctx))
            if bspec is not None else b)
    own = (sum(R.block_bytes(p[k], 1, width) for k in HEAD_COLUMNS)
           + R.block_bytes(p["wo"], 0, width) + rows * d * x.dtype.itemsize)
    token = R.constrain(x, (bspec, None, None), ctx)[:, :1]
    plans = [R.product_plan(token, p[k]) for k in HEAD_COLUMNS + ("wo",)]
    whole = (sum(q.bytes for q in plans if q is not None)
             + rows * cfg.rwkv_pad_heads * hd * 4)
    if own >= whole:
        return None
    return block(h, ctx.model_size, R.model_index(ctx))


def _time_mix(p, x, cfg: ModelConfig, state, chunked, ctx: ShardCtx,
              heads=None):
    """`time_mix_apply` on one device, or on this rank's batch shard
    inside the region of an enabled ``ctx``; with ``heads`` (first, n)
    (`own_heads`) on this rank's n heads, ``p``'s head weights their
    blocks, the result this rank's summand of ``wo``'s product."""
    b, t, d = x.shape
    r_cfg = cfg.rwkv
    hd = r_cfg.head_dim
    h = d // hd
    dt = x.dtype
    prev_x = (state["prev_x_tm"] if state is not None
              else torch.zeros((b, 1, d), dtype=dt, device=x.device))
    xs = _token_shift(x, prev_x.to(dt))
    xw, xk, xv, xr, xg = _ddlerp(p, x, xs)

    # the heads this rank computes (all but with ``heads``) and their
    # channels of the per-channel parameters
    first, hh = heads if heads is not None else (0, h)
    chan = (lambda a: a) if heads is None else (
        lambda a: a.narrow(0, first * hd, hh * hd))
    f32 = torch.float32
    decay_logit = (chan(p["decay_base"]).float()
                   + _linear(torch.tanh(_linear(xw.float(), p["decay_w1"],
                                                f32)), p["decay_w2"], f32))
    w = torch.exp(-torch.clamp_max(torch.exp(decay_logit), DECAY_CLAMP))

    r = _linear(xr, p["wr"], dt).reshape(b, t, hh, hd)
    k = _linear(xk, p["wk"], dt).reshape(b, t, hh, hd)
    v = _linear(xv, p["wv"], dt).reshape(b, t, hh, hd)
    g = F.silu(_linear(xg, p["wg"], dt))

    h_pad = max(cfg.rwkv_pad_heads, h)
    u = p["bonus"].float()
    w4 = w.reshape(b, t, hh, hd)
    wkv_state = (state["wkv"] if state is not None else torch.zeros(
        (b, h, hd, hd), dtype=torch.float32, device=x.device))
    split = head_split(cfg, ctx)
    own = split and state is not None
    if own:
        # this rank's block of the heads, its state's (the cache's
        # split), each padded to H'/model heads
        from repro_torch.parallel import regions as R
        from repro_torch.parallel.sharding import block
        kh = h_pad // ctx.model_size
        first, n = block(h, ctx.model_size, R.model_index(ctx))
        if wkv_state.shape[1] != n:
            raise ValueError(
                f"the WKV state holds {wkv_state.shape[1]} heads on this "
                f"rank, not its {n}: place the cache by "
                f"sharding.cache_pspecs")
        pads = (0, 0, 0, kh - n)
        if heads is None:
            r, k, v, w4 = (a.narrow(2, first, n) for a in (r, k, v, w4))
        r, k, v = (F.pad(a, pads) for a in (r, k, v))
        w4 = F.pad(w4, pads, value=1.0)
        u = F.pad(u.narrow(0, first, n), pads)
        wkv_state = F.pad(wkv_state, (0, 0, 0, 0, 0, kh - n))
    elif h_pad > h:
        pads = (0, 0, 0, h_pad - h)
        r, k, v = (F.pad(a, pads) for a in (r, k, v))
        w4 = F.pad(w4, pads, value=1.0)                    # decay 1 on pads
        u = F.pad(u, (0, 0, 0, h_pad - h))
        wkv_state = F.pad(wkv_state, (0, 0, 0, 0, 0, h_pad - h))
        if split:
            from repro_torch.parallel import regions as R
            r, k, v, w4 = (R.split_model(a, 2, ctx) for a in (r, k, v, w4))
            u = R.split_model(u, 0, ctx)
            wkv_state = R.split_model(wkv_state, 1, ctx)

    args = (r.float(), k.float(), v.float(), w4.float(), u,
            wkv_state.float())
    if chunked and t % r_cfg.chunk == 0 and t > 1:
        o, new_wkv = wkv_chunked(*args, chunk=r_cfg.chunk)
    else:
        o, new_wkv = wkv_recurrent(*args)

    if heads is not None:
        o, new_wkv = o[:, :, :hh], new_wkv[:, :hh]
    elif own:
        o = R.gather_whole(o, 2, ctx)
        heads_ = [m * kh + j for m in range(ctx.model_size)
                  for j in range(block(h, ctx.model_size, m)[1])]
        o = (o[:, :, :h] if heads_ == list(range(h))
             else o[:, :, torch.tensor(heads_, device=o.device)])
        new_wkv = new_wkv[:, :n]
    elif split:
        o = R.gather_whole(o, 2, ctx)[:, :, :h]
        new_wkv = R.gather_whole(new_wkv, 1, ctx)[:, :h]
    elif h_pad > h:
        o = o[:, :, :h]
        new_wkv = new_wkv[:, :h]

    # per-head group norm (per-channel scale reshaped to heads)
    ln = {"scale": chan(p["ln_x"]["scale"]).reshape(hh, hd)}
    o = rms_norm(o, ln, eps=1e-5 * 64)                    # (B,T,H,D) per head
    o = o.reshape(b, t, hh * hd).to(dt) * g
    out = _linear(o, p["wo"], dt)
    new_state = None
    if state is not None:
        new_state = dict(state)
        new_state["prev_x_tm"] = x[:, -1:, :]
        new_state["wkv"] = new_wkv
    return out, new_state


def channel_mix_apply(p, x, cfg: ModelConfig, state=None,
                      ctx: ShardCtx = LOCAL):
    """x (B,T,d) -> (out, new_state).  state: dict(prev_x_cm, ...) or None.

    Under an enabled ``ctx`` (DTensors placed by the port's specs) it
    runs tensor-parallel as GSPMD runs the JAX package's specs when the
    model size divides d_ff: ``wk`` column-parallel, the squared ReLU on
    each rank's columns, ``wv`` row-parallel, and the receptance gate
    (``wr`` whole over ``model``) applied to each rank's summand, so the
    result is a `Partial` sum.  Otherwise ``wk`` and ``wv`` are whole
    over ``model`` (`sharding.sanitize_spec`) and each rank computes the
    layer on its batch shard.
    """
    if not ctx.enabled:
        return _channel_mix(p, x, cfg, state)
    from repro_torch.parallel import regions as R
    return R.layer_region(
        lambda p_, x_, s_: _channel_mix(p_, x_, cfg, s_), ctx, p, x, state,
        partial=cfg.d_ff % ctx.model_size == 0)


def _channel_mix(p, x, cfg: ModelConfig, state=None):
    b, t, d = x.shape
    dt = x.dtype
    prev_x = (state["prev_x_cm"] if state is not None
              else torch.zeros((b, 1, d), dtype=dt, device=x.device))
    xs = _token_shift(x, prev_x.to(dt))
    dx = xs - x
    xk = x + dx * p["maa_k"].to(dt)
    xr = x + dx * p["maa_r"].to(dt)
    k = torch.square(F.relu(_linear(xk, p["wk"], dt)))
    out = torch.sigmoid(_linear(xr, p["wr"], dt)) * _linear(k, p["wv"], dt)
    new_state = None
    if state is not None:
        new_state = dict(state)
        new_state["prev_x_cm"] = x[:, -1:, :]
    return out, new_state
