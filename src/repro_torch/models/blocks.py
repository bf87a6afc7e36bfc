"""Transformer building blocks of the port's language models.

Port of `repro.models.blocks` on one device: RMS norm, activations,
rotary embeddings, the exact chunked attention, banded sliding-window
attention, GQA attention with its cache decode, MLA attention with its
absorbed decode, the SwiGLU MLP and the event-routed MoE layer, with
weight-only int8 experts (``MoEConfig.quant_int8``) dequantized at each
use as the JAX package does.  Attention stays plain torch, as it is
plain jnp in the JAX package: the same chunked online softmax, not a
library attention.

Conventions, as in the JAX package:

* params are nested dicts of tensors; ``init_*`` builds them from a
  `Draw` (an explicit `torch.Generator`), ``*_apply`` consumes them;
* activations flow as (B, T, d_model); attention internals use
  (B, T, KH, rep, Dh);
* parameters are kept in ``param_dtype`` and cast to ``compute_dtype``
  at each use; the products the JAX package asks in float32
  (``preferred_element_type``) are float32 products of the same values
  here, and the expert FFN's products round once to ``compute_dtype``.

Distribution: blocks are sharding-agnostic except for an optional
`ShardCtx` whose ``enabled`` paths are the JAX package's ``shard_map``
bodies as ``local_map`` regions on its `DeviceMesh`
(`repro_torch.parallel.regions`): the sequence-sharded decode with its
log-sum-exp combine and cache write, head-TP and sequence-parallel
prefill, the sharded MLA decode and expert-parallel MoE.  Activations
and parameters are then DTensors; a sharded parameter is gathered whole
at its use (`_use`), and the rest of a layer runs on each rank's batch
shard.  With `LOCAL` everything is plain tensors on one device.  On the
card,
float32 products must stay full float32: `check_matmul_precision`
refuses TF32.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.core import event_router
from repro_torch.models.config import ModelConfig

Params = dict

ITEM_12 = "ROADMAP queue A item 12"


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Names of mesh axes, and the `DeviceMesh` the ``local_map`` regions
    run on; ``enabled=False`` (`LOCAL`) is the single-device path."""
    data_axes: tuple = ("data",)     # batch axes ("pod","data") when multi-pod
    model_axis: str = "model"
    model_size: int = 1
    enabled: bool = False
    axis_sizes: tuple = ()           # ((axis, size), ...) for spec sanitizing
    mesh: object = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def batch_spec(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]


LOCAL = ShardCtx(enabled=False)


def _bspec_for(ctx: ShardCtx, batch: int):
    """Batch spec, or None (replicate) when batch doesn't divide the DP
    extent (e.g. long_500k's single sequence)."""
    dp = 1
    for a, sz in ctx.axis_sizes:
        if a in ctx.data_axes:
            dp *= sz
    return ctx.batch_spec if batch % max(dp, 1) == 0 else None


def _regions():
    from repro_torch.parallel import regions
    return regions


def _use(w, dt):
    """A parameter at its use, in ``dt``: a sharded one (a DTensor) is
    gathered whole first, the use-site all-gather of FSDP / TP.  Where
    several data axes split it (`regions.gathers_flat`), its model split
    is gathered first and then its data split in one call over the data
    axes together, whose gradient comes back in one reduce-scatter
    there (`regions.gather_data`)."""
    R = _regions()
    if R.gathers_flat(w):
        from torch.distributed.tensor import Replicate
        data = R.data_dims(w.device_mesh)
        pl = [q if i in data else Replicate()
              for i, q in enumerate(w.placements)]
        if pl != list(w.placements):
            w = w.redistribute(w.device_mesh, pl)
        return R.gather_data(w).to(dt)
    return R.replicate(w).to(dt)


def _linear(x, w, dt):
    """``x @ w`` in ``dt``.  On DTensors the product GSPMD makes of the
    operands' placements, mesh dim by mesh dim:

    * ``x`` split by rows there (the batch, the sequence): the weight is
      gathered there (FSDP's use-site all-gather), the product is local;
    * ``x`` whole there and ``w`` split by columns: column-parallel, the
      result split along its last dim;
    * ``x`` whole (or split along its features) and ``w`` split by rows:
      row-parallel, ``x`` taken along its features and the result a
      `Partial` sum, reduced where it is next read;
    * both whole: the same product on every rank.

    Where autograd records no gradient of the product (prefill, decode:
    no operand requires grad) a weight split over the data axes (FSDP)
    is placed by the cheaper of what GSPMD does with it, in bytes a rank
    moves (`repro.launch.dryrun.collective_bytes`'s convention;
    `regions.product_plan`).  W is the weight's block, D the data ranks
    that split it, R the rows ``x`` holds here, N the product's columns
    here:

    * ``x`` split by rows over those data axes: the split gathered
      (D |W|; one all-gather over the data axes together), or, where
      one data axis splits the weight's rows, it is whole over the model
      axis as ``x`` is and that axis has as many ranks, the block moved
      to the model ranks by one ``collective-permute`` (rank (d, m)
      sends block d to (m, d)) and the product row-parallel over
      ``model``, its partial sums reduced at once (|W| + R N): decode's
      few tokens, where GSPMD permutes RWKV's time mix and llama's
      projections;
    * ``x`` whole over them (a batch that does not split, long_500k's
      one sequence): the gather (D |W|) or the weight left in place,
      row-parallel over the data axes with the partial sums reduced at
      once (R N; also where ``x`` is split there along its features),
      or column-parallel with the result gathered there at once
      (R N D).

    The train step keeps the rules above it (gradients recorded: the
    split is gathered where ``x`` is split by rows, in one call over the
    data axes together where several split one dim of ``w``, its
    gradient reduce-scattered in one call too, `regions.gather_data`).
    No dim of ``x`` is reshaped, and each operand's gradient comes back
    in the placements the rule gives it.  Inside a region
    (`regions.layer_region`), a weight placed so comes as its
    `regions.LocalPlan`, which runs the product on the rank's block.
    """
    if not _is_dtensor(x):
        if not isinstance(w, torch.Tensor):          # a LocalPlan
            return w.apply(x, dt)
        return x @ w.to(dt)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    R = _regions()
    w = w.to(dt)
    plan = R.product_plan(x, w)
    last = x.ndim - 1
    if plan is not None:
        w = R.place_for_product(w, plan)
    else:          # the train step's gather over the rows' data axes
        rows = [i for i in R.data_dims(x.device_mesh)
                if x.placements[i].is_shard()
                and x.placements[i].dim != last]
        if R.gathers_flat(w, rows):
            w = R.gather_data(w, rows)
    x_in, w_in, out, x_grad, w_grad = [], [], [], [], []
    for a, b in zip(x.placements, w.placements):
        if a.is_shard() and a.dim != last:         # rows split here
            row = (a, Replicate(), a, a, Partial())
        elif b.is_shard(1):                        # column-parallel
            row = (Replicate(), b, Shard(last), Partial(), b)
        elif b.is_shard(0):                        # row-parallel
            row = (Shard(last), b, Partial(), Shard(last), b)
        else:
            row = (Replicate(),) * 5
        for dst, v in zip((x_in, w_in, out, x_grad, w_grad), row):
            dst.append(v)
    y = local_map(torch.matmul, out_placements=out,
                  in_placements=(tuple(x_in), tuple(w_in)),
                  in_grad_placements=(tuple(x_grad), tuple(w_grad)),
                  device_mesh=x.device_mesh,
                  redistribute_inputs=True)(x, w)
    return y if plan is None else R.finish_product(y, plan)


def _split_last(x, *shape):
    """``x.reshape(*shape)`` where the last dim splits into
    ``shape[k:]``: a DTensor split along its last dim keeps the split on
    the first new dim when that dim divides it, and is gathered there
    first otherwise."""
    if _is_dtensor(x):
        from torch.distributed.tensor import Replicate
        lead = shape[x.ndim - 1]
        pl = [Replicate() if (p.is_shard(x.ndim - 1)
                              and lead % x.device_mesh.size(i))
              else p for i, p in enumerate(x.placements)]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*shape)


def _mesh_entry(fn):
    """Under an enabled ``ctx``, run ``fn`` with plain tensors (rope
    tables, positions, masks) taken as replicated DTensors."""
    @functools.wraps(fn)
    def run(*args, ctx: ShardCtx = LOCAL, **kw):
        if not ctx.enabled:
            return fn(*args, ctx=ctx, **kw)
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            return fn(*args, ctx=ctx, **kw)
    return run


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _batch_local(fn, ctx: ShardCtx, args, ndims, out_ndim):
    """``fn(*args)`` on each rank's batch shard: every operand (of ndim
    ``ndims[i]``) and the result (of ndim ``out_ndim``) split over the
    data axes on dim 0 (replicated when the batch does not divide them)
    and replicated over the model axis."""
    bspec = _bspec_for(ctx, args[0].shape[0])
    spec = (lambda n: (bspec,) + (None,) * (n - 1))
    return _regions().region(fn, ctx, [spec(n) for n in ndims],
                             spec(out_ndim))(*args)


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

    def const(self, value: torch.Tensor, dtype=None) -> torch.Tensor:
        """``value`` (a CPU tensor) repeated over the leading axes."""
        value = value.to(self.device, dtype or self.dtype)
        return value.expand(self.lead + tuple(value.shape)).clone()


# ---------------------------------------------------------------------------
# norms / rope / activations
# ---------------------------------------------------------------------------


def init_rmsnorm(draw: Draw, d: int, cfg: ModelConfig) -> Params:
    return {"scale": draw.zeros((d,), dtype_of(cfg.param_dtype))}


def rms_norm(x, p, eps: float = 1e-6):
    """On a mesh (DTensor ``x``) under autograd the norm is recomputed in
    the backward: eager autograd would keep its float32 input and output,
    two float32 copies of the stream a norm, where XLA's fusion keeps
    neither.  The same ops run, so the values are the same."""
    if _is_dtensor(x) and torch.is_grad_enabled():
        from torch.utils import checkpoint as ckpt
        return ckpt.checkpoint(_rms_norm, x, p["scale"], eps,
                               use_reentrant=False)
    return _rms_norm(x, p["scale"], eps)


def _rms_norm(x, scale, eps):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


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
    """Sliding-window attention touching only in-window KV: O(T*window).

    Chunks q by ``window``; chunk i attends to kv chunks {i-1, i} only,
    and T is padded to a window multiple (the causal mask hides the
    padding), as in the JAX package.
    q: (B, T, KH, R, D); k, v: (B, T, KH, D).
    """
    b, t, kh, r, d = q.shape
    w = window
    t_orig = t
    if t % w:
        pad = w - t % w
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        t = t + pad
    nc = t // w
    dv = v.shape[-1]
    scale = 1.0 / math.sqrt(d)
    kc = k.reshape(b, nc, w, kh, d)
    vc = v.reshape(b, nc, w, kh, dv)
    # previous chunk (zeros before chunk 0)
    kp = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    vp = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    kwin = torch.cat([kp, kc], dim=2)                     # (B, nc, 2w, KH, D)
    vwin = torch.cat([vp, vc], dim=2)
    qc = q.reshape(b, nc, w, kh, r, d)
    s = _f32_einsum("bnqhrd,bnkhd->bnhrqk", qc, kwin) * scale
    dev = q.device
    q_pos = torch.arange(w, device=dev)[:, None] + w      # within 2w frame
    k_pos = torch.arange(2 * w, device=dev)[None, :]
    mask = (k_pos <= q_pos) if causal else torch.ones(
        (w, 2 * w), dtype=torch.bool, device=dev)
    mask = mask & (k_pos > q_pos - w)
    mask_first = mask & (k_pos >= w)                      # chunk 0: no prev
    full_mask = torch.where(torch.arange(nc, device=dev)[:, None, None] == 0,
                            mask_first[None], mask[None])
    s = torch.where(full_mask[None, :, None, None], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    o = _f32_einsum("bnhrqk,bnkhd->bnqhrd", p.to(vwin.dtype), vwin)
    o = o.reshape(b, t, kh, r, dv).to(q.dtype)
    return o[:, :t_orig]


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     ctx: ShardCtx = LOCAL):
    """Tokens against a KV cache, optionally sequence-sharded.

    q: (B, Tq, KH, R, D); caches (B, S, KH, D).  ``cache_len``: the number
    of valid cache positions; with ``window`` only the last ``window`` of
    them are seen.  Under an enabled ``ctx`` the caches are DTensors
    sharded over the model axis along S: each rank scores its block at
    ``shard_idx * s_loc`` and the partials combine by log-sum-exp
    (``pmax``, then two ``psum``), as in the JAX package.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])

    def local(q_, k_, v_, shard_idx):
        s_loc = k_.shape[1]
        pos = shard_idx * s_loc + torch.arange(s_loc, device=q_.device)
        valid = pos < cache_len
        if window:
            valid &= pos >= cache_len - window
        s = _f32_einsum("bqhrd,bkhd->bhrqk", q_, k_) * scale
        s = torch.where(valid, s, -torch.inf)
        m = torch.amax(s, dim=-1)
        m_safe = torch.where(torch.isfinite(m), m, -1e30)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(valid, p, 0.0)
        l = torch.sum(p, dim=-1)
        acc = _f32_einsum("bhrqk,bkhd->bqhrd", p.to(v_.dtype), v_)
        return m_safe, l, acc

    if not ctx.enabled:
        _, l, acc = local(q, k_cache, v_cache, 0)
        out = acc / torch.clamp_min(_blh(l)[..., 0], 1e-30)[..., None]
        return out.to(q.dtype)

    R = _regions()

    def sharded(q_, k_, v_):
        m, l, acc = local(q_, k_, v_, R.model_index(ctx))
        # distributed LSE combine across sequence shards
        m_g = R.all_reduce(m, "max", ctx)
        w = torch.exp(m - m_g)
        l_g = R.all_reduce(l * w, "sum", ctx)
        acc_g = R.all_reduce(acc * _blh(w), "sum", ctx)
        out = acc_g / torch.clamp_min(_blh(l_g)[..., 0], 1e-30)[..., None]
        return out.to(q_.dtype)

    bspec = _bspec_for(ctx, q.shape[0])
    mx = ctx.model_axis
    return R.region(sharded, ctx,
                    [(bspec, None, None, None, None), (bspec, mx, None, None),
                     (bspec, mx, None, None)],
                    (bspec, None, None, None, None))(q, k_cache, v_cache)


def _cached_attention(q, k_cache, v_cache, cache_len, window, ctx):
    """`decode_attention` over a cache as it is placed: split over the
    model axis along S, or (an S the axis does not divide) replicated
    there and attended on each rank's batch shard."""
    if not ctx.enabled or _seq_sharded(k_cache, ctx):
        return decode_attention(q, k_cache, v_cache, cache_len,
                                window=window, ctx=ctx)
    return _batch_local(
        lambda q_, k_, v_: decode_attention(q_, k_, v_, cache_len,
                                            window=window),
        ctx, (q, k_cache, v_cache), (5, 4, 4), 5)


# ---------------------------------------------------------------------------
# GQA attention layer (projections + rope + cache handling)
# ---------------------------------------------------------------------------


def init_attention(draw: Draw, cfg: ModelConfig) -> Params:
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pdt = dtype_of(cfg.param_dtype)
    p = {"wq": _dense_init(draw, (d, h * dh), pdt),
         "wk": _dense_init(draw, (d, kh * dh), pdt),
         "wv": _dense_init(draw, (d, kh * dh), pdt),
         "wo": _dense_init(draw, (h * dh, d), pdt)}
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(draw, dh, cfg)
        p["k_norm"] = init_rmsnorm(draw, dh, cfg)
    return p


@_mesh_entry
def attention_apply(p, x, cfg: ModelConfig, *, is_local: bool,
                    positions=None, cache=None, cache_len=None,
                    ctx: ShardCtx = LOCAL, causal=True):
    """x (B, T, d) -> ((B, T, d), cache).  The cache ({"k", "v"}, each
    (B, S, KH, Dh)) is written in place: from 0 at prefill, at
    ``cache_len`` (a Python int; clamped as `cache_write` does) at
    decode; the dict it returns holds the same tensors.  Under an
    enabled ``ctx``, ``x`` and ``p`` are DTensors and the caches are
    sequence-sharded over the model axis."""
    b, t, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = h // kh
    dt = x.dtype
    decode = cache is not None and cache_len is not None
    # by flat head where `_prefill_attention` splits the heads but not the
    # kv heads over the model axis: the column-parallel wq leaves each
    # rank its own heads, which stay split, as GSPMD keeps them
    qh = ((h, 1) if not decode and _flat_heads(cfg, ctx, kh, h)
          else (kh, rep))
    q = _split_last(_linear(x, p["wq"], dt), b, t, *qh, dh)
    k = _split_last(_linear(x, p["wk"], dt), b, t, kh, dh)
    v = _split_last(_linear(x, p["wv"], dt), b, t, kh, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :]
    theta = cfg.rope_theta_local if (is_local and cfg.rope_theta_local) \
        else cfg.rope_theta
    cos, sin = rope_tables(positions, dh, theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    window = cfg.sliding_window if is_local else 0
    new_cache = None
    if decode:
        # decode: append k/v at cache_len, attend over the cache
        new_cache = {"k": cache_update(cache["k"], k, cache_len, ctx),
                     "v": cache_update(cache["v"], v, cache_len, ctx)}
        o = _cached_attention(q, new_cache["k"], new_cache["v"],
                              cache_len + t, window, ctx)
    else:
        if cache is not None:
            # prefill: fill the cache, attend over this call's k/v
            new_cache = {"k": cache_update(cache["k"], k, 0, ctx),
                         "v": cache_update(cache["v"], v, 0, ctx)}
        o = _prefill_attention(q, k, v, cfg, window, causal, ctx)
    out = _linear(o.reshape(b, t, h * dh), p["wo"], dt)
    return out, new_cache


def _seq_sharded(cache, ctx: ShardCtx) -> bool:
    """Is a DTensor cache split over the model axis along S?"""
    from torch.distributed.tensor import Shard
    i = list(ctx.mesh.mesh_dim_names).index(ctx.model_axis)
    return cache.placements[i] == Shard(1)


def cache_update(cache, kv, start: int, ctx: ShardCtx = LOCAL):
    """`cache_write` of ``kv`` (B, t, ...) at ``start``; under an enabled
    ``ctx`` on a DTensor cache: each rank writes the part of the clamped
    range [start, start + t) that falls in its own S block, in place
    (the JAX package's ``_sharded_cache_update``)."""
    if not ctx.enabled:
        return cache_write(cache, kv, start)
    R = _regions()
    s_full, t = cache.shape[1], kv.shape[1]
    start = min(max(int(start), 0), s_full - t)
    bspec = _bspec_for(ctx, cache.shape[0])
    rest = (None,) * (cache.ndim - 2)
    sharded = _seq_sharded(cache, ctx)

    def upd(c, kv_):
        s_loc = c.shape[1]
        lo = (R.model_index(ctx) * s_loc) if sharded else 0
        a, z = max(start, lo), min(start + t, lo + s_loc)
        if a < z:
            c[:, a - lo:z - lo] = kv_[:, a - start:z - start].to(c.dtype)
        return c

    cspec = (bspec, ctx.model_axis if sharded else None) + rest
    R.region(upd, ctx, [cspec, (bspec, None) + rest], cspec)(cache, kv)
    return cache


def _flat_heads(cfg: ModelConfig, ctx: ShardCtx, kh: int, h: int) -> bool:
    """Head-TP over fewer kv heads than ranks: the heads divide the
    model axis and the kv heads do not."""
    return (ctx.enabled and cfg.attn_shard == "heads"
            and kh % ctx.model_size != 0 and h % ctx.model_size == 0)


def _prefill_attention(q, k, v, cfg: ModelConfig, window, causal,
                       ctx: ShardCtx = LOCAL):
    """Attention of train and prefill: ``q`` (B, T, KH, rep, D), or (B,
    T, H, 1, D) split over the model axis by head where `_flat_heads`;
    the output in the same layout."""
    if not ctx.enabled:
        if window:
            return banded_attention(q, k, v, window=window, causal=causal)
        return flash_attention(q, k, v, causal=causal)
    R = _regions()
    b, t = q.shape[:2]
    h, kh = q.shape[2] * q.shape[3], k.shape[2]
    rep = h // kh
    bspec = _bspec_for(ctx, b)
    mx = ctx.model_axis

    def attend(q_, k_, v_, q_offset=0):
        if window:
            return banded_attention(q_, k_, v_, window=window, causal=causal)
        return flash_attention(q_, k_, v_, causal=causal, q_offset=q_offset)

    if cfg.attn_shard == "heads" and kh % ctx.model_size == 0:
        # head-TP: the column-parallel projections leave q, k and v split
        # over `model` by kv head, with each kv head's GQA reps beside it:
        # each rank attends its own heads (the JAX package's flat-head
        # split), and the output stays split for the row-parallel wo
        return R.region(attend, ctx,
                        [(bspec, None, mx, None, None),
                         (bspec, None, mx, None), (bspec, None, mx, None)],
                        (bspec, None, mx, None, None))(q, k, v)
    if _flat_heads(cfg, ctx, kh, h):
        # head-TP over fewer kv heads than ranks: q by flat head, H over
        # `model`; kv is replicated, and each rank repeats only its own
        # H/model slice.  Each rank's gradient reaches only its heads, so
        # the replicated kv get partial gradients.  The output stays split
        # by head for the row-parallel wo.
        def heads(q_, k_, v_):
            h_loc = q_.shape[2]
            first = R.model_index(ctx) * h_loc
            kv_of = torch.arange(first, first + h_loc, device=q_.device) // rep
            return attend(q_, k_[:, :, kv_of], v_[:, :, kv_of])

        flat = (bspec, None, mx, None, None)
        spec4 = (bspec, None, None, None)
        return R.region(heads, ctx, [flat, spec4, spec4], flat,
                        in_grad=[None, R.partial_on_model(spec4, ctx),
                                 R.partial_on_model(spec4, ctx)])(q, k, v)
    if (not window and cfg.attn_shard == "sequence"
            and t % ctx.model_size == 0):
        # sequence-parallel attention: q sharded over T, KV all-gathered
        def sp(q_, k_, v_):
            kg = R.all_gather(k_, 1, ctx)
            vg = R.all_gather(v_, 1, ctx)
            return attend(q_, kg, vg,
                          q_offset=R.model_index(ctx) * q_.shape[1])
        spec4 = (bspec, mx, None, None)
        return R.region(sp, ctx, [(bspec, mx, None, None, None), spec4,
                                  spec4],
                        (bspec, mx, None, None, None))(q, k, v)
    return _batch_local(attend, ctx, (q, k, v), (5, 4, 4), 5)


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


@_mesh_entry
def mla_apply(p, x, cfg: ModelConfig, *, positions=None, cache=None,
              cache_len=None, ctx: ShardCtx = LOCAL):
    """MLA attention.  The cache stores the latent (c_kv, k_rope) only and
    is updated in place (the JAX package returns a new one); the dict it
    returns holds the same tensors.  Under an enabled ``ctx`` the latent
    cache is sequence-sharded over the model axis and the decode combines
    the ranks' partials by log-sum-exp (`_mla_decode`)."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.n_heads
    dt = x.dtype
    if m.q_lora:
        q = rms_norm(_linear(x, p["wq_a"], dt), p["q_norm"], cfg.norm_eps)
        q = _linear(q, p["wq_b"], dt)
    else:
        q = _linear(x, p["wq"], dt)
    q = _split_last(q, b, t, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]

    kv_a = _linear(x, p["wkv_a"], dt)
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
        new_cache = {"ckv": cache_update(cache["ckv"], c_kv, cache_len, ctx),
                     "kr": cache_update(cache["kr"], k_rope, cache_len, ctx)}
        scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
        wk_b = _use(p["wk_b"], dt)
        wv_b = _use(p["wv_b"], dt)

        def absorbed(q_nope_, q_rope_, ckv_, kr_, wk_b_, wv_b_, ctx_):
            q_eff = torch.einsum("bthd,lhd->bthl", q_nope_,
                                 wk_b_.reshape(m.kv_lora, h, m.qk_nope_dim))
            o_lat = _mla_decode(q_eff, q_rope_, ckv_, kr_, cache_len + t,
                                scale, ctx_)             # (B,T,H,kv_lora)
            return torch.einsum("bthl,lhd->bthd", o_lat,
                                wv_b_.reshape(m.kv_lora, h, m.v_head_dim))

        if not ctx.enabled:
            o = absorbed(q_nope, q_rope, new_cache["ckv"], new_cache["kr"],
                         wk_b, wv_b, LOCAL)
        else:
            sharded = _seq_sharded(new_cache["ckv"], ctx)
            bspec = _bspec_for(ctx, b)
            mx = ctx.model_axis if sharded else None
            o = _regions().region(
                lambda *a: absorbed(*a, ctx if sharded else LOCAL), ctx,
                [(bspec, None, None, None), (bspec, None, None, None),
                 (bspec, mx, None), (bspec, mx, None), (None, None),
                 (None, None)],
                (bspec, None, None, None))(
                    q_nope, q_rope, new_cache["ckv"], new_cache["kr"],
                    wk_b, wv_b)
    else:
        # --- train/prefill: materialize per-head k, v ----------------------
        k_nope = _split_last(_linear(c_kv, p["wk_b"], dt), b, t, h,
                             m.qk_nope_dim)
        val = _split_last(_linear(c_kv, p["wv_b"], dt), b, t, h,
                          m.v_head_dim)
        o = _mla_prefill(q_nope, q_rope, k_nope, k_rope, val, ctx)
        o = o.reshape(b, t, h, m.v_head_dim)
        if cache is not None:
            new_cache = {"ckv": cache_update(cache["ckv"], c_kv, 0, ctx),
                         "kr": cache_update(cache["kr"], k_rope, 0, ctx)}

    out = _linear(o.reshape(b, t, h * m.v_head_dim), p["wo"], dt)
    return out, new_cache


def _mla_attend(q_nope, q_rope, k_nope, k_rope, val):
    """Causal attention of the per-head q, k (``k_rope`` shared by every
    head) and v: (B, T, H, 1, Dv) in the GQA layout (KH = H, rep = 1)."""
    b, t, h, _ = q_nope.shape
    k_full = torch.cat(
        [k_nope, k_rope[:, :, None, :].expand(b, t, h, k_rope.shape[-1])],
        dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    return flash_attention(q_full[:, :, :, None, :], k_full, val,
                           causal=True)


def _mla_prefill(q_nope, q_rope, k_nope, k_rope, val, ctx: ShardCtx):
    """`_mla_attend` of train and prefill.  Under an enabled ``ctx`` with
    the heads a multiple of the model size, the column-parallel ``wq``,
    ``wk_b`` and ``wv_b`` leave q, ``k_nope`` and v split over ``model``
    by head: each rank attends its own heads with ``k_rope`` whole (its
    gradient a `Partial` sum: each rank reads it for its heads), and the
    output stays split for the row-parallel ``wo``.  Other head counts
    attend on each rank's batch shard, whole over ``model``."""
    if not ctx.enabled:
        return _mla_attend(q_nope, q_rope, k_nope, k_rope, val)
    b, _, h, _ = q_nope.shape
    if h % ctx.model_size:
        return _batch_local(_mla_attend, ctx,
                            (q_nope, q_rope, k_nope, k_rope, val),
                            (4, 4, 4, 3, 4), 5)
    bspec = _bspec_for(ctx, b)
    heads = (bspec, None, ctx.model_axis, None)
    shared = (bspec, None, None)
    R = _regions()
    return R.region(_mla_attend, ctx, [heads, heads, heads, shared, heads],
                    (bspec, None, ctx.model_axis, None, None),
                    in_grad=[None, None, None,
                             R.partial_on_model(shared, ctx), None])(
        q_nope, q_rope, k_nope, k_rope, val)


def _mla_decode(q_eff, q_rope, ckv, kr, cache_len, scale,
                ctx: ShardCtx = LOCAL):
    """Latent-space decode attention over the first ``cache_len`` cache
    positions; inside a region of an enabled ``ctx`` the caches are this
    rank's S block and the partials combine over the model axis."""
    shard_idx = _regions().model_index(ctx) if ctx.enabled else 0
    s_loc = ckv.shape[1]
    pos = shard_idx * s_loc + torch.arange(s_loc, device=ckv.device)
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
    if ctx.enabled:
        R = _regions()
        m_g = R.all_reduce(m_safe, "max", ctx)
        w = torch.exp(m_safe - m_g)
        l = R.all_reduce(l * w, "sum", ctx)
        acc = R.all_reduce(acc * w.permute(0, 2, 1)[..., None], "sum", ctx)
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
    g = act_fn(cfg.act)(_linear(x, p["w_gate"], dt))
    u = _linear(x, p["w_up"], dt)
    return _linear(g * u, p["w_down"], dt)


def quantize_int8(w: torch.Tensor):
    """Weight-only int8 with per-(expert, out-channel) scales, as the JAX
    package's `init_moe` quantizes: ``scale = max |w| over d_in / 127``
    (d_in the second-last axis), ``round(w / max(scale, 1e-12))``
    clipped to +-127.  ``w`` float32 -> (int8 weights, float32 scales
    with d_in kept as 1).

    The division by 127 is a product with float32(1 / 127), as XLA
    compiles it under ``jax.jit`` (eager JAX divides, which differs in the
    last bit of some scales)."""
    scale = torch.amax(torch.abs(w), dim=-2, keepdim=True) * (
        torch.tensor(1.0 / 127.0, dtype=torch.float32).item())
    q = torch.clamp(torch.round(w / torch.clamp_min(scale, 1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def init_moe(draw: Draw, cfg: ModelConfig) -> Params:
    mo = cfg.moe
    d = cfg.d_model
    pdt = dtype_of(cfg.param_dtype)
    e = mo.num_experts
    p = {"router": _dense_init(draw, (d, e), pdt, scale=0.02)}
    for name, shape in (("w_gate", (e, d, mo.d_expert)),
                        ("w_up", (e, d, mo.d_expert)),
                        ("w_down", (e, mo.d_expert, d))):
        # drawn in float32, then quantized or cast, as the JAX package
        # does; its fan-in is shape[0], the expert count
        w = _dense_init(draw, shape, torch.float32)
        if mo.quant_int8:
            p[name], p[name + "_scale"] = quantize_int8(w)
        else:
            p[name] = w.to(pdt)
    if mo.num_shared:
        p["shared"] = init_mlp(draw, d, mo.d_expert * mo.num_shared, cfg)
    return p


def _moe_weight(p, name, dt):
    if name + "_scale" in p:
        # dequantize at each use, in the compute type
        return p[name].to(dt) * p[name + "_scale"].to(dt)
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
    """Event-routed MoE layer.  Returns (y, aux_metrics).

    Distributed path (an enabled ``ctx``), as in the JAX package: the
    layer runs as one region - tokens stay on their data shard (routing
    is per shard: `hat_route`, B5 on the card, once a rank), experts are
    sharded over the model axis (rank i runs experts [i e_loc,
    (i+1) e_loc), int8 ones stay int8 until inside the region), and the
    expert outputs combine with one sum over the model axis; the aux
    losses are averaged over the data axes.
    """
    mo = cfg.moe
    b, t, d = x.shape
    dt = x.dtype
    act = act_fn(cfg.act)

    def local_moe(xf, router_w, ws, first, e_loc):
        route = route_tokens(xf, router_w, cfg)
        # local slice of the (global) buffer: experts [first, first+e_loc)
        buf = route.buffer_rows[first:first + e_loc]
        xe = torch.where((buf >= 0)[..., None],
                         xf[torch.clamp_min(buf, 0).long()], 0.0)
        # dequantize (if int8) after any resharding, so wires carry int8
        wg = _moe_weight(ws, "w_gate", dt)
        wu = _moe_weight(ws, "w_up", dt)
        wd = _moe_weight(ws, "w_down", dt)
        ye = _expert_ffn(xe, wg, wu, wd, act)            # (E_loc, C, d)
        ids = route.expert_ids.long()
        mine = (ids >= first) & (ids < first + e_loc) & route.kept
        ev = ye[torch.clamp(ids - first, 0, e_loc - 1),
                torch.clamp_min(route.event_slot, 0).long()]  # (T, k, d)
        wgt = (route.weights * mine.to(route.weights.dtype)).to(ev.dtype)
        y = torch.einsum("tkd,tk->td", ev, wgt)
        return y, route.aux_loss, route.z_loss

    if ctx.enabled:        # the tokens' flatten needs T whole
        x = _regions().constrain(x, (_bspec_for(ctx, b), None, None), ctx)
    xf = x.reshape(b * t, d)
    ws = {k_: v_ for k_, v_ in p.items()
          if k_.startswith(("w_gate", "w_up", "w_down"))}
    if not ctx.enabled:
        y, aux_l, z_l = local_moe(xf, p["router"].to(dt), ws, 0,
                                  mo.num_experts)
    else:
        y, aux_l, z_l = _moe_sharded(local_moe, xf, _use(p["router"], dt),
                                     ws, cfg, ctx)
        # the layer's aux losses reduced here, as the JAX package's pmean
        # is, not left `Partial` for DTensor to reduce where the sums over
        # layers meet it (which differs between torch versions); at a
        # serve step in one all-reduce for both
        aux_l, z_l = _regions().sum_losses(aux_l, z_l)
    if mo.num_shared:
        y = y + mlp_apply(p["shared"], xf, cfg)
    aux = {"moe_aux": aux_l * mo.aux_loss_weight,
           "moe_z": z_l * mo.z_loss_weight}
    return y.reshape(b, t, d), aux


def _moe_sharded(local_moe, xf, router_w, ws, cfg: ModelConfig,
                 ctx: ShardCtx):
    """The expert-parallel region of `moe_apply`.

    Its results are `Partial` sums, so that every gradient that flows
    back is a sum over ranks as well: ``y`` over the model axis (each
    rank's experts; the one all-reduce happens where ``y`` is next
    read), and the aux losses over every axis, each rank adding
    1/(model x data) of its shard's value (the JAX package's ``pmean``
    over the data axes).  Where the tokens do not divide the data axes
    every data rank routes them all, and ``y`` is summed over the data
    axes too, each adding 1/data of it.  An expert weight that several
    data axes split along one dim is gathered over them in one call
    first (`regions.gather_data`; int8 ones as int8; its gradient
    reduce-scattered in one), as GSPMD gathers it over ``("pod",
    "data")``, where the region's redistribution would gather each axis
    in turn."""
    from torch.distributed.tensor import Partial
    R = _regions()
    mo = cfg.moe
    e_loc = mo.num_experts // ctx.model_size
    # tokens shard over data axes only when they divide; tiny decode
    # batches (long_500k: 1 token) replicate instead
    bspec = _bspec_for(ctx, xf.shape[0])
    dp = 1
    for _, n in R.data_coords(ctx):
        dp *= n
    y_share = 1.0 if bspec is not None else 1.0 / dp
    aux_share = 1.0 / (dp * ctx.model_size)
    keys = sorted(ws)
    ws = {k_: R.gather_data(w) if R.gathers_flat(w) else w
          for k_, w in ws.items()}

    def body(xf_, router_w_, *wl):
        y, aux, z = local_moe(xf_, router_w_, dict(zip(keys, wl)),
                              R.model_index(ctx) * e_loc, e_loc)
        return y * y_share, aux * aux_share, z * aux_share

    every = tuple([Partial()] * ctx.mesh.ndim)
    x_spec = (bspec, None)
    x_pl = R.partial_on_model(x_spec, ctx, data_partial=bspec is None)
    w_specs = [(ctx.model_axis,) + (None,) * (ws[k_].ndim - 1) for k_ in keys]
    names = list(ctx.mesh.mesh_dim_names)
    w_grads = []
    for sp in w_specs:                 # data: partial; model: EP shard
        pl = list(R.partial_on_model(sp, ctx, data_partial=True))
        pl[names.index(ctx.model_axis)] = R.placements(sp, ctx)[
            names.index(ctx.model_axis)]
        w_grads.append(tuple(pl))
    y, aux, z = R.region(
        body, ctx, [x_spec, (None, None)] + w_specs, [x_pl, every, every],
        in_grad=[x_pl, every] + w_grads)(xf, router_w,
                                         *[ws[k_] for k_ in keys])
    return y, aux, z
