"""The port's GQA attention blocks against the JAX package's.

`banded_attention` (sliding-window over chunk pairs), `decode_attention`
(one token against a KV cache, with and without a window) and the GQA
layer `attention_apply` (projections, qk-norm, the local/global rope
switch, causal and bidirectional, prefill cache fill and decode append).
Inputs and parameters are numpy arrays made from a seed (parameters from
the JAX package's `init_attention`), handed to both packages.

Tolerance: rtol 1e-4 / atol 1e-5, as `tests/test_torch_lm.py` holds the
MLA logits.  Both compute in float32, but the softmax sums and the
products' sums run in another order than XLA's; the measured gap is
under 1e-6 on these inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as jblocks
from repro.models.config import ModelConfig
from repro_torch.models import blocks as tblocks
from tests.test_torch_lm import port_config

RTOL, ATOL = 1e-4, 1e-5
B, KH, R, D = 2, 2, 3, 16
WINDOW = 8


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _qkv(t, seed, s=None):
    rng = np.random.default_rng(seed)
    s = s or t
    q = rng.standard_normal((B, t, KH, R, D)).astype(np.float32)
    k = rng.standard_normal((B, s, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, s, KH, D)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [5, WINDOW, 20])      # T < w, T = w, T = 2.5w
def test_banded_attention_matches_jax_and_masked_flash(t, causal):
    q, k, v = _qkv(t, t)
    want = jblocks.banded_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), window=WINDOW,
                                    causal=causal)
    got = tblocks.banded_attention(*_t(q, k, v), window=WINDOW, causal=causal)
    assert got.shape == (B, t, KH, R, D)
    _close(got, want, "banded vs JAX")
    if causal:
        # the same sliding window as a masked full attention: every key
        # within the window before each query
        full = tblocks.flash_attention(*_t(q, k, v), causal=True,
                                       window=WINDOW)
        _close(got, full.numpy(), "banded vs masked flash")


def test_banded_attention_in_bfloat16_matches_jax():
    q, k, v = _qkv(12, 3)
    to_j = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = jblocks.banded_attention(to_j(q), to_j(k), to_j(v), window=WINDOW)
    got = tblocks.banded_attention(
        *(x.to(torch.bfloat16) for x in _t(q, k, v)), window=WINDOW)
    assert got.dtype == torch.bfloat16
    # one bfloat16 rounding of the output: half an ulp at 2^0 is 2^-8
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("cache_len", [1, 7, 12])
def test_decode_attention_matches_jax(window, cache_len):
    q, k, v = _qkv(1, cache_len + window, s=12)
    want = jblocks.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.int32(cache_len),
                                    window=window)
    got = tblocks.decode_attention(*_t(q, k, v), cache_len, window=window)
    _close(got, want, "decode")


def test_decode_attention_at_an_empty_cache_is_zero_as_in_jax():
    """No valid position: JAX's m_safe = -1e30 and the 1e-30 floor give
    zeros, not NaN."""
    q, k, v = _qkv(1, 5, s=6)
    want = jblocks.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.int32(0))
    got = tblocks.decode_attention(*_t(q, k, v), 0)
    assert bool(torch.isfinite(got).all())
    _close(got, want, "empty cache")


def _cfg(**kw):
    base = dict(name="a", family="dense", n_layers=1, d_model=48, n_heads=6,
                n_kv_heads=2, head_dim=16, d_ff=64, vocab=64,
                rope_theta=1_000_000.0, compute_dtype="float32")
    base.update(kw)
    return ModelConfig(**base)


ATTN_CASES = {
    "global": (dict(), False, True),
    "qk_norm": (dict(qk_norm=True), False, True),
    "local": (dict(qk_norm=True, sliding_window=4, local_global_ratio=1,
                   rope_theta_local=10_000.0), True, True),
    "bidirectional": (dict(), False, False),
    "bidirectional_local": (dict(sliding_window=4, local_global_ratio=1),
                            True, False),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_apply_matches_jax(case):
    kw, is_local, causal = ATTN_CASES[case]
    jcfg = _cfg(**kw)
    tcfg = port_config(jcfg)
    jp = jblocks.init_attention(jax.random.PRNGKey(1), jcfg)
    # non-zero norm scales, so qk-norm's scale is exercised
    if "q_norm" in jp:
        jp = {**jp, "q_norm": {"scale": jnp.linspace(-0.5, 0.5, 16)},
              "k_norm": {"scale": jnp.linspace(0.3, -0.2, 16)}}
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(2).standard_normal((B, 10, 48)).astype(
        np.float32)
    want, _ = jblocks.attention_apply(jp, jnp.asarray(x), jcfg,
                                      is_local=is_local, causal=causal)
    got, cache = tblocks.attention_apply(tp, torch.from_numpy(x), tcfg,
                                         is_local=is_local, causal=causal)
    assert cache is None
    _close(got, want, case)


@pytest.mark.parametrize("is_local", [False, True])
def test_attention_apply_prefill_and_decode_match_jax(is_local):
    jcfg = _cfg(qk_norm=True, sliding_window=4, local_global_ratio=1,
                rope_theta_local=10_000.0)
    tcfg = port_config(jcfg)
    jp = jblocks.init_attention(jax.random.PRNGKey(3), jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(4).standard_normal((B, 9, 48)).astype(
        np.float32)
    s = 12
    shape = (B, s, 2, 16)
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    want, jcache = jblocks.attention_apply(
        jp, jnp.asarray(x[:, :6]), jcfg, is_local=is_local, cache=jcache)
    got, tcache2 = tblocks.attention_apply(
        tp, torch.from_numpy(x[:, :6]), tcfg, is_local=is_local,
        cache=tcache)
    assert tcache2["k"] is tcache["k"]                    # in place
    _close(got, want, "prefill")
    for i in range(6, 9):
        pos = jnp.asarray([[i]])
        want, jcache = jblocks.attention_apply(
            jp, jnp.asarray(x[:, i:i + 1]), jcfg, is_local=is_local,
            positions=pos, cache=jcache, cache_len=jnp.int32(i))
        got, _ = tblocks.attention_apply(
            tp, torch.from_numpy(x[:, i:i + 1]), tcfg, is_local=is_local,
            positions=torch.tensor([[i]]), cache=tcache, cache_len=i)
        _close(got, want, f"decode at {i}")
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], f"cache {name}")


def test_gqa_refuses_a_sharded_context():
    cfg = port_config(_cfg())
    with pytest.raises(NotImplementedError, match="ShardCtx.enabled"):
        tblocks.attention_apply({}, torch.zeros(1, 1, 48), cfg,
                                is_local=False,
                                ctx=tblocks.ShardCtx(enabled=True))
    with pytest.raises(NotImplementedError, match="item 12"):
        tblocks.decode_attention(*_t(*_qkv(1, 0)), 1,
                                 ctx=tblocks.ShardCtx(enabled=True))
