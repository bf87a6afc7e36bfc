"""Transformer building blocks of the DeepSeek-V2 path (MLA + MoE).

Port of the parts of `repro.models.blocks` that an MLA + MoE model runs
on one device: RMS norm, activations, rotary embeddings, the exact
chunked attention, MLA attention with its absorbed decode, the SwiGLU
MLP and the event-routed MoE layer.

Conventions, as in the JAX package:

* params are nested dicts of tensors; ``init_*`` builds them from a
  `Draw` (an explicit `torch.Generator`), ``*_apply`` consumes them;
* activations flow as (B, T, d_model); attention internals use
  (B, T, KH, rep, Dh);
* parameters are kept in ``param_dtype`` and cast to ``compute_dtype``
  at each use; the products the JAX package asks in float32
  (``preferred_element_type``) are float32 products of the same values
  here, and the expert FFN's products round once to ``compute_dtype``.

Only the single-device path (`LOCAL`) is ported.  A `ShardCtx` with
``enabled``, GQA `attention_apply`, `banded_attention` and int8 experts
raise `NotImplementedError` naming their ROADMAP item.  On the card,
float32 products must stay full float32: `check_matmul_precision`
refuses TF32.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import event_router
from repro_torch.models.config import ModelConfig

Params = dict

ITEM_12 = "ROADMAP queue A item 12"


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Whether the JAX package's shard_map paths are on; only the
    disabled (single-device) context is ported, so the mesh axes the JAX
    context names have no fields here."""
    enabled: bool = False


LOCAL = ShardCtx(enabled=False)


def refuse_sharded(ctx: ShardCtx) -> None:
    if ctx.enabled:
        raise NotImplementedError(
            f"sharded execution (ShardCtx.enabled) is not ported to "
            f"repro_torch ({ITEM_12}: parallel/); the port runs on one "
            f"device - use the JAX package `repro` for a mesh")


def check_matmul_precision(x: torch.Tensor) -> None:
    """Refuse TF32 for float32 matrix products on the card."""
    if x.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the LM needs full float32 matrix products on the card; TF32 is "
            "allowed (torch.backends.cuda.matmul.allow_tf32 / "
            "torch.set_float32_matmul_precision): set it to 'highest'")


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


class Draw:
    """Where parameters come from: normal draws from ``generator`` on its
    device, in ``dtype``, with the leading ``lead`` axes (a stack of
    layers).  With ``generator=None`` every tensor is made on the meta
    device, which gives the tree's shapes and nothing else."""

    def __init__(self, generator: torch.Generator | None,
                 dtype: torch.dtype, lead: tuple = ()):
        self.generator = generator
        self.dtype = dtype
        self.lead = lead
        self.device = (generator.device if generator is not None
                       else torch.device("meta"))

    def stacked(self, n: int) -> "Draw":
        return Draw(self.generator, self.dtype, (n,))

    def normal(self, shape, std: float, dtype=None) -> torch.Tensor:
        t = torch.empty(self.lead + tuple(shape), dtype=dtype or self.dtype,
                        device=self.device)
        if self.generator is not None:
            t.normal_(0.0, std, generator=self.generator)
        return t

    def zeros(self, shape, dtype=None) -> torch.Tensor:
        return torch.zeros(self.lead + tuple(shape), dtype=dtype or self.dtype,
                           device=self.device)


# ---------------------------------------------------------------------------
# norms / rope / activations
# ---------------------------------------------------------------------------


def init_rmsnorm(draw: Draw, d: int, cfg: ModelConfig) -> Params:
    return {"scale": draw.zeros((d,), dtype_of(cfg.param_dtype))}


def rms_norm(x, p, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].float())).to(dt)


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu2": lambda x: torch.square(F.relu(x))}[name]


def rope_tables(positions, dim: int, theta: float):
    """positions (...,) int -> cos/sin (..., dim/2) f32."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (B, T, ..., D); cos/sin (B|1, T, D/2) broadcast over middle dims."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    extra = x.dim() - cos.dim()            # head-ish dims between T and D
    shape = cos.shape[:-1] + (1,) * extra + cos.shape[-1:]
    c = cos.reshape(shape).to(x.dtype)
    s = sin.reshape(shape).to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _dense_init(draw: Draw, shape, dtype, scale=None):
    fan_in = shape[0]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return draw.normal(shape, std, dtype)


# ---------------------------------------------------------------------------
# flash-style chunked attention (exact, plain torch)
# ---------------------------------------------------------------------------


def _f32_einsum(spec: str, a, b):
    """``einsum(..., preferred_element_type=float32)``: the float32
    product of the operands' values."""
    return torch.einsum(spec, a.float(), b.float())


def _attn_chunk(q, k, v, q_pos, k_pos, causal, window, scale, kv_len=None):
    """One (q-chunk x kv-chunk) tile -> (m, l, acc) partials in f32."""
    s = _f32_einsum("bqhrd,bkhd->bhrqk", q, k) * scale
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if kv_len is not None:
        mask &= k_pos[None, :] < kv_len       # padded KV tail
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(mask, s, -torch.inf)
    m = torch.amax(s, dim=-1)                                 # (B,KH,R,Cq)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(mask, p, 0.0)
    l = torch.sum(p, dim=-1)
    acc = _f32_einsum("bhrqk,bkhd->bqhrd", p.to(v.dtype), v)
    return m_safe, l, acc


def _merge(carry, new):
    m0, l0, a0 = carry
    m1, l1, a1 = new
    m = torch.maximum(m0, m1)
    e0 = torch.exp(m0 - m)
    e1 = torch.exp(m1 - m)
    l = l0 * e0 + l1 * e1
    a = a0 * _blh(e0) + a1 * _blh(e1)
    return m, l, a


def _blh(x):
    """(B,KH,R,Cq) -> (B,Cq,KH,R,1) broadcast helper."""
    return x.permute(0, 3, 1, 2)[..., None]


DEFAULT_Q_CHUNK = 1024
DEFAULT_KV_CHUNK = 1024


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    q_chunk=None, kv_chunk=None):
    """Exact chunked attention (the JAX package's two-level online
    softmax, with its chunk sizes and merge order).

    q: (B, Tq, KH, R, D); k, v: (B, Tk, KH, D) -> (B, Tq, KH, R, Dv).
    `q_offset`: absolute position of q[0].
    """
    q_chunk = q_chunk or DEFAULT_Q_CHUNK
    kv_chunk = kv_chunk or DEFAULT_KV_CHUNK
    b, tq, kh, r, d = q.shape
    tk = k.shape[1]
    tq_orig, tk_orig = tq, tk
    scale = 1.0 / math.sqrt(d)
    q_chunk = min(q_chunk, tq)
    kv_chunk = min(kv_chunk, tk)
    if tq % q_chunk:
        pad = q_chunk - tq % q_chunk
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
        tq += pad
    if tk % kv_chunk:
        pad = kv_chunk - tk % kv_chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        tk += pad
    dev = q.device
    dv = v.shape[-1]
    outs = []
    for i in range(tq // q_chunk):
        qi = q[:, i * q_chunk:(i + 1) * q_chunk]
        q_pos = q_offset + i * q_chunk + torch.arange(q_chunk, device=dev)
        carry = (torch.full((b, kh, r, q_chunk), -torch.inf, device=dev),
                 torch.zeros((b, kh, r, q_chunk), device=dev),
                 torch.zeros((b, q_chunk, kh, r, dv), device=dev))
        for j in range(tk // kv_chunk):
            sl = slice(j * kv_chunk, (j + 1) * kv_chunk)
            k_pos = j * kv_chunk + torch.arange(kv_chunk, device=dev)
            carry = _merge(carry, _attn_chunk(qi, k[:, sl], v[:, sl], q_pos,
                                              k_pos, causal, window, scale,
                                              kv_len=tk_orig))
        _, l, acc = carry
        out = acc / torch.clamp_min(_blh(l)[..., 0], 1e-30)[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)[:, :tq_orig]


def banded_attention(q, k, v, *, window: int, causal=True):
    raise NotImplementedError(
        f"banded (sliding-window) attention is not ported to repro_torch "
        f"({ITEM_12}: GQA attention for local layers); use the JAX package "
        f"`repro`")


# ---------------------------------------------------------------------------
# GQA attention layer: not ported
# ---------------------------------------------------------------------------


def attention_apply(p, x, cfg: ModelConfig, **kwargs):
    raise NotImplementedError(
        f"GQA attention (attention_apply) is not ported to repro_torch "
        f"({ITEM_12}); the port runs MLA attention - use the JAX package "
        f"`repro` for {cfg.name}")


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V2), with absorbed decode path
# ---------------------------------------------------------------------------


def init_mla(draw: Draw, cfg: ModelConfig) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    pdt = dtype_of(cfg.param_dtype)
    p = {}
    if m.q_lora:
        p["wq_a"] = _dense_init(draw, (d, m.q_lora), pdt)
        p["q_norm"] = init_rmsnorm(draw, m.q_lora, cfg)
        p["wq_b"] = _dense_init(draw, (m.q_lora, h * qk), pdt)
    else:
        p["wq"] = _dense_init(draw, (d, h * qk), pdt)
    p["wkv_a"] = _dense_init(draw, (d, m.kv_lora + m.qk_rope_dim), pdt)
    p["kv_norm"] = init_rmsnorm(draw, m.kv_lora, cfg)
    p["wk_b"] = _dense_init(draw, (m.kv_lora, h * m.qk_nope_dim), pdt)
    p["wv_b"] = _dense_init(draw, (m.kv_lora, h * m.v_head_dim), pdt)
    p["wo"] = _dense_init(draw, (h * m.v_head_dim, d), pdt)
    return p


def cache_write(cache: torch.Tensor, update: torch.Tensor, start: int):
    """``jax.lax.dynamic_update_slice_in_dim(cache, update, start, 1)``,
    in place: the start is clamped so that the update fits, so a write
    past the end overwrites the tail."""
    t, s = update.shape[1], cache.shape[1]
    start = min(max(int(start), 0), s - t)
    cache[:, start:start + t] = update.to(cache.dtype)
    return cache


def mla_apply(p, x, cfg: ModelConfig, *, positions=None, cache=None,
              cache_len=None, ctx: ShardCtx = LOCAL):
    """MLA attention.  The cache stores the latent (c_kv, k_rope) only and
    is updated in place (the JAX package returns a new one); the dict it
    returns holds the same tensors."""
    refuse_sharded(ctx)
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.n_heads
    dt = x.dtype
    if m.q_lora:
        q = rms_norm(x @ p["wq_a"].to(dt), p["q_norm"], cfg.norm_eps)
        q = q @ p["wq_b"].to(dt)
    else:
        q = x @ p["wq"].to(dt)
    q = q.reshape(b, t, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]

    kv_a = x @ p["wkv_a"].to(dt)
    c_kv = rms_norm(kv_a[..., :m.kv_lora], p["kv_norm"], cfg.norm_eps)
    k_rope = kv_a[..., m.kv_lora:]                       # (B, T, rope_dim)

    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :]
    cos, sin = rope_tables(positions, m.qk_rope_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]

    new_cache = None
    if cache is not None and cache_len is not None:
        # --- absorbed decode: score in latent space ------------------------
        new_cache = {"ckv": cache_write(cache["ckv"], c_kv, cache_len),
                     "kr": cache_write(cache["kr"], k_rope, cache_len)}
        wk_b = p["wk_b"].to(dt).reshape(m.kv_lora, h, m.qk_nope_dim)
        q_eff = torch.einsum("bthd,lhd->bthl", q_nope, wk_b)
        scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
        o_lat = _mla_decode(q_eff, q_rope, new_cache["ckv"], new_cache["kr"],
                            cache_len + t, scale)        # (B,T,H,kv_lora)
        wv_b = p["wv_b"].to(dt).reshape(m.kv_lora, h, m.v_head_dim)
        o = torch.einsum("bthl,lhd->bthd", o_lat, wv_b)
    else:
        # --- train/prefill: materialize per-head k, v ----------------------
        k_nope = (c_kv @ p["wk_b"].to(dt)).reshape(b, t, h, m.qk_nope_dim)
        val = (c_kv @ p["wv_b"].to(dt)).reshape(b, t, h, m.v_head_dim)
        k_full = torch.cat(
            [k_nope, k_rope[:, :, None, :].expand(b, t, h, m.qk_rope_dim)],
            dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        # GQA layout with KH=H, rep=1
        o = flash_attention(q_full[:, :, :, None, :], k_full, val, causal=True)
        o = o.reshape(b, t, h, m.v_head_dim)
        if cache is not None:
            new_cache = {"ckv": cache_write(cache["ckv"], c_kv, 0),
                         "kr": cache_write(cache["kr"], k_rope, 0)}

    out = o.reshape(b, t, h * m.v_head_dim) @ p["wo"].to(dt)
    return out, new_cache


def _mla_decode(q_eff, q_rope, ckv, kr, cache_len, scale):
    """Latent-space decode attention over the first ``cache_len`` cache
    positions."""
    pos = torch.arange(ckv.shape[1], device=ckv.device)
    valid = pos < cache_len
    s = (_f32_einsum("bthl,bsl->bhts", q_eff, ckv)
         + _f32_einsum("bthr,bsr->bhts", q_rope, kr)) * scale
    s = torch.where(valid, s, -torch.inf)
    msk = torch.amax(s, dim=-1)
    m_safe = torch.where(torch.isfinite(msk), msk, -1e30)
    pr = torch.exp(s - m_safe[..., None])
    pr = torch.where(valid, pr, 0.0)
    l = torch.sum(pr, dim=-1)
    acc = _f32_einsum("bhts,bsl->bthl", pr.to(ckv.dtype), ckv)
    lt = l.permute(0, 2, 1)[..., None]
    return (acc / torch.clamp_min(lt, 1e-30)).to(q_eff.dtype)


# ---------------------------------------------------------------------------
# MLPs and MoE
# ---------------------------------------------------------------------------


def init_mlp(draw: Draw, d: int, d_ff: int, cfg: ModelConfig) -> Params:
    pdt = dtype_of(cfg.param_dtype)
    return {"w_gate": _dense_init(draw, (d, d_ff), pdt),
            "w_up": _dense_init(draw, (d, d_ff), pdt),
            "w_down": _dense_init(draw, (d_ff, d), pdt)}


def mlp_apply(p, x, cfg: ModelConfig):
    dt = x.dtype
    g = act_fn(cfg.act)(x @ p["w_gate"].to(dt))
    u = x @ p["w_up"].to(dt)
    return (g * u) @ p["w_down"].to(dt)


def _refuse_int8():
    raise NotImplementedError(
        f"weight-only int8 experts (MoEConfig.quant_int8) are not ported to "
        f"repro_torch ({ITEM_12}); use the JAX package `repro`")


def init_moe(draw: Draw, cfg: ModelConfig) -> Params:
    mo = cfg.moe
    if mo.quant_int8:
        _refuse_int8()
    d = cfg.d_model
    pdt = dtype_of(cfg.param_dtype)
    e = mo.num_experts
    p = {"router": _dense_init(draw, (d, e), pdt, scale=0.02)}
    for name, shape in (("w_gate", (e, d, mo.d_expert)),
                        ("w_up", (e, d, mo.d_expert)),
                        ("w_down", (e, mo.d_expert, d))):
        # the JAX package's fan-in is shape[0], the expert count
        p[name] = _dense_init(draw, shape, pdt)
    if mo.num_shared:
        p["shared"] = init_mlp(draw, d, mo.d_expert * mo.num_shared, cfg)
    return p


def _moe_weight(p, name, dt):
    if name + "_scale" in p:
        _refuse_int8()
    return p[name].to(dt)


def _expert_ffn(xe, wg, wu, wd, act):
    """(E, C, d) through per-expert SwiGLU FFNs; each product sums in
    float32 and rounds once to the compute type."""
    g = act(torch.bmm(xe, wg))
    u = torch.bmm(xe, wu)
    return torch.bmm(g * u, wd)


def route_tokens(xf, router_w, cfg: ModelConfig):
    """The router of one MoE layer: (T, d) tokens -> `RouteResult`, with
    the capacity the JAX package computes from the token count."""
    mo = cfg.moe
    tokens = xf.shape[0]
    capacity = max(8, int(mo.capacity_factor * mo.top_k * tokens
                          / mo.num_experts))
    logits = xf @ router_w
    return event_router.hat_route(logits, mo.top_k, capacity,
                                  num_experts=mo.num_experts)


def moe_apply(p, x, cfg: ModelConfig, ctx: ShardCtx = LOCAL):
    """Event-routed MoE layer on one device.  Returns (y, aux_metrics)."""
    refuse_sharded(ctx)
    mo = cfg.moe
    b, t, d = x.shape
    dt = x.dtype
    act = act_fn(cfg.act)
    xf = x.reshape(b * t, d)
    route = route_tokens(xf, p["router"].to(dt), cfg)
    buf = route.buffer_rows
    xe = torch.where((buf >= 0)[..., None], xf[torch.clamp_min(buf, 0).long()],
                     0.0)
    wg = _moe_weight(p, "w_gate", dt)
    wu = _moe_weight(p, "w_up", dt)
    wd = _moe_weight(p, "w_down", dt)
    ye = _expert_ffn(xe, wg, wu, wd, act)                # (E, C, d)
    ev = ye[route.expert_ids.long(),
            torch.clamp_min(route.event_slot, 0).long()]  # (T, k, d)
    wgt = (route.weights * route.kept.to(route.weights.dtype)).to(ev.dtype)
    y = torch.einsum("tkd,tk->td", ev, wgt)
    if mo.num_shared:
        y = y + mlp_apply(p["shared"], xf, cfg)
    aux = {"moe_aux": route.aux_loss * mo.aux_loss_weight,
           "moe_z": route.z_loss * mo.z_loss_weight}
    return y.reshape(b, t, d), aux
