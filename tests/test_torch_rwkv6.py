"""The port's RWKV6 time and channel mix against the JAX package's.

Inputs are numpy arrays made from a seed; the layer parameters come from
the JAX package's `init_time_mix` / `init_channel_mix`, with every
all-zero leaf (the mix offsets, the group-norm scale) perturbed so that
each is exercised.  Both sides compute in float32 on the CPU.

Tolerances (float32 products and sums in another order than XLA's; the
chunked form's factors reach e^64 within a chunk, by design):

- WKV outputs and states, both forms: rtol 1e-4 / atol 1e-4 (measured:
  under 3e-5 absolute, on outputs up to 43);
- the port's chunked form against its own recurrent form: atol 1e-3, as
  `tests/test_models.py::test_wkv_chunked_equals_recurrent` holds JAX's;
- the layers' outputs and states: rtol 1e-4 / atol 1e-5;
- `rwkv_pad_heads` against no padding, through the whole model: atol
  1e-5, as `tests/test_perf_variants.py::test_rwkv_pad_heads_is_inert`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.models import rwkv6 as jrwkv
from repro_torch.models import lm as tlm
from repro_torch.models import rwkv6 as trwkv
from tests.test_models import _rwkv
from tests.test_perf_variants import _rwkv_cfg
from tests.test_torch_lm import port_config

WKV_RTOL, WKV_ATOL = 1e-4, 1e-4
RTOL, ATOL = 1e-4, 1e-5
B, H, D = 2, 4, 16


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _tree(tree):
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return _t(tree)


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


def _wkv_inputs(t, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, t, H, D)).astype(np.float32)
               for _ in range(3))
    logit = rng.standard_normal((B, t, H, D)).astype(np.float32) * scale
    w = np.exp(-np.minimum(np.exp(logit), 4.0)).astype(np.float32)
    u = (rng.standard_normal((H, D)) * 0.2).astype(np.float32)
    s0 = (rng.standard_normal((B, H, D, D)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("t", [1, 5, 16])
def test_wkv_recurrent_matches_jax(t):
    args = _wkv_inputs(t, seed=t)
    jo, js = jrwkv.wkv_recurrent(*map(jnp.asarray, args))
    to, ts = trwkv.wkv_recurrent(*map(_t, args))
    _close(to, jo, "outputs", WKV_RTOL, WKV_ATOL)
    _close(ts, js, "state", WKV_RTOL, WKV_ATOL)


@pytest.mark.parametrize("t,chunk", [(16, 16), (64, 16), (64, 8), (48, 16)])
def test_wkv_chunked_matches_jax(t, chunk):
    args = _wkv_inputs(t, seed=t + chunk)
    jo, js = jrwkv.wkv_chunked(*map(jnp.asarray, args), chunk=chunk)
    to, ts = trwkv.wkv_chunked(*map(_t, args), chunk=chunk)
    _close(to, jo, "outputs", WKV_RTOL, WKV_ATOL)
    _close(ts, js, "state", WKV_RTOL, WKV_ATOL)


@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_wkv_chunked_equals_recurrent(scale):
    """Scale 2 drives exp(logit) past the clamp on about a quarter of the
    channels: the factors reach e^64 within the chunk."""
    args = tuple(map(_t, _wkv_inputs(64, seed=3, scale=scale)))
    o1, s1 = trwkv.wkv_recurrent(*args)
    o2, s2 = trwkv.wkv_chunked(*args)
    assert torch.allclose(o1, o2, atol=1e-3)
    assert torch.allclose(s1, s2, atol=1e-3)


def test_wkv_chunked_refuses_a_ragged_sequence_like_jax():
    args = _wkv_inputs(20, seed=4)
    with pytest.raises(ValueError) as jerr:
        jrwkv.wkv_chunked(*map(jnp.asarray, args))
    with pytest.raises(ValueError) as terr:
        trwkv.wkv_chunked(*map(_t, args))
    assert str(terr.value) == str(jerr.value)


def _layer_params(init, cfg, seed, decay_base=None):
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: (a + rng.uniform(-0.3, 0.3, a.shape).astype(
        np.float32)) if not a.any() else a, p)
    if decay_base is not None:
        p["decay_base"] = np.full_like(p["decay_base"], decay_base)
    return p


def _state(cfg, seed, t):
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.rwkv.head_dim
    return {"prev_x_tm": rng.standard_normal((B, 1, d)).astype(np.float32),
            "prev_x_cm": rng.standard_normal((B, 1, d)).astype(np.float32),
            "wkv": (rng.standard_normal((B, d // hd, hd, hd)) * 0.1).astype(
                np.float32)}


@pytest.mark.parametrize("t,chunked,with_state", [
    (16, True, False), (16, True, True), (32, True, True),
    (16, False, True), (7, True, True), (1, False, True)])
def test_time_mix_matches_jax(t, chunked, with_state):
    cfg = _rwkv()
    p = _layer_params(jrwkv.init_time_mix, cfg, seed=t)
    x = np.random.default_rng(t + 1).standard_normal(
        (B, t, cfg.d_model)).astype(np.float32)
    st = _state(cfg, t + 2, t) if with_state else None
    jo, jst = jrwkv.time_mix_apply(
        p, jnp.asarray(x), cfg, state=None if st is None else
        jax.tree.map(jnp.asarray, st), chunked=chunked)
    to, tst = trwkv.time_mix_apply(
        _tree(p), _t(x), port_config(cfg),
        state=None if st is None else _tree(st), chunked=chunked)
    _close(to, jo, "time mix output")
    if with_state:
        assert set(tst) == set(jst)
        for k in jst:
            _close(tst[k], jst[k], f"state {k}")
    else:
        assert tst is None and jst is None


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_jax(with_state):
    cfg = _rwkv()
    p = _layer_params(jrwkv.init_channel_mix, cfg, seed=9)
    x = np.random.default_rng(10).standard_normal(
        (B, 16, cfg.d_model)).astype(np.float32)
    st = _state(cfg, 11, 16) if with_state else None
    jo, jst = jrwkv.channel_mix_apply(
        p, jnp.asarray(x), cfg, state=None if st is None else
        jax.tree.map(jnp.asarray, st))
    to, tst = trwkv.channel_mix_apply(
        _tree(p), _t(x), port_config(cfg),
        state=None if st is None else _tree(st))
    _close(to, jo, "channel mix output")
    if with_state:
        for k in jst:
            _close(tst[k], jst[k], f"state {k}")
        # the new prev_x_cm is the input's last token
        assert torch.equal(tst["prev_x_cm"], _t(x)[:, -1:])


def test_decay_clamp_binds_and_matches_jax():
    """decay_base 2.5 puts exp(decay_logit) near e^2.5 = 12 > DECAY_CLAMP:
    every channel's decay is clamped to exp(-4)."""
    cfg = _rwkv()
    p = _layer_params(jrwkv.init_time_mix, cfg, seed=12, decay_base=2.5)
    x = np.random.default_rng(13).standard_normal(
        (B, 32, cfg.d_model)).astype(np.float32)
    tp = _tree(p)
    logit = tp["decay_base"] + torch.tanh(_t(x) @ tp["decay_w1"]) \
        @ tp["decay_w2"]
    assert bool((torch.exp(logit) > trwkv.DECAY_CLAMP).all())
    jo, _ = jrwkv.time_mix_apply(p, jnp.asarray(x), cfg)
    to, _ = trwkv.time_mix_apply(tp, _t(x), port_config(cfg))
    _close(to, jo, "clamped time mix")


def test_pad_heads_is_inert_and_matches_jax():
    jcfg = _rwkv_cfg()
    padded = dataclasses.replace(jcfg, rwkv_pad_heads=8)
    jp = jax.jit(jlm.init_model, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg)
    tp = tlm.lm_params_from_numpy(port_config(jcfg),
                                  jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(14).integers(0, 100, (2, 32)).astype(
        np.int32)
    tb = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        base = tlm.forward(tp, tb, port_config(jcfg), remat=False)["logits"]
        pad = tlm.forward(tp, tb, port_config(padded), remat=False)["logits"]
    assert torch.allclose(base, pad, atol=1e-5)
    want = jlm.forward(jp, {"tokens": toks}, padded, mode="train",
                       remat=False)["logits"]
    _close(pad, want, "padded heads")
