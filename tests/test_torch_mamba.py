"""The port's Mamba layer against the JAX package's.

Inputs are numpy arrays made from a seed; the layer parameters come from
the JAX package's `init_mamba`, with every all-zero leaf (the conv bias)
perturbed.  Covered: `_causal_conv` with and without a conv state, the
odd/even `associative_scan` against ``jax.lax.associative_scan``,
`_ssm_scan_chunked` below one chunk and over two chunks of 512, its
`ValueError` at T = 600, `mamba_apply` with and without state and in
decode, decode step by step against the scan (as
`tests/test_models.py::test_mamba_decode_equals_scan`), bfloat16
parameters and compute, and the deterministic leaves of `init_mamba`.

Tolerances:

- float32: rtol 1e-5 / atol 1e-5 for the scan and the layer (XLA fuses
  a multiply and an add into one rounding where eager torch rounds
  twice; measured: 7.2e-7 on scan outputs up to 3.3);
- decode against the scan: atol 1e-3, as the JAX test;
- bfloat16 parameters and compute: atol 5e-3 (measured: 4.9e-4 on
  outputs up to 0.13, 1.8e-3 on the float32 ssm state; the conv taps
  and the projections round in bfloat16 in both packages, in different
  orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmamba
from repro.models.config import MambaConfig, ModelConfig
from repro_torch.models import blocks as tblocks
from repro_torch.models import mamba as tmamba
from tests.test_torch_lm import port_config

RTOL, ATOL = 1e-5, 1e-5
B = 2


def _cfg(**kw):
    return ModelConfig(name="t", family="hybrid", n_layers=1, d_model=32,
                       n_heads=2, n_kv_heads=2, d_ff=64, vocab=10,
                       mamba=MambaConfig(d_state=8), compute_dtype="float32",
                       **kw)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def _tree(tree, dtype=torch.float32):
    return {k: _t(v, dtype) for k, v in tree.items()}


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=rtol, atol=atol, err_msg=what)


def _params(cfg, seed=0):
    p = jmamba.init_mamba(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v, np.float32) + rng.uniform(-0.3, 0.3, v.shape)
                .astype(np.float32)) if not np.asarray(v).any()
            else np.asarray(v, np.float32) for k, v in p.items()}


@pytest.mark.parametrize("t", [1, 5, 16])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(t, with_state):
    rng = np.random.default_rng(t)
    di, k = 12, 4
    x = rng.standard_normal((B, t, di)).astype(np.float32)
    w = rng.standard_normal((k, di)).astype(np.float32)
    b = rng.standard_normal((di,)).astype(np.float32)
    st = rng.standard_normal((B, k - 1, di)).astype(np.float32) \
        if with_state else None
    jy, js = jmamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b),
                                 None if st is None else jnp.asarray(st))
    ty, ts = tmamba._causal_conv(_t(x), _t(w), _t(b),
                                 None if st is None else _t(st))
    _close(ty, jy, "conv output")
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))   # a slice


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 33, 64])
def test_associative_scan_matches_jax(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (B, n, 3, 4)).astype(np.float32)
    b = rng.standard_normal((B, n, 3, 4)).astype(np.float32)

    def combine(p, q):
        return p[0] * q[0], q[0] * p[1] + q[1]

    ja, jb = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    ta, tb = tmamba.associative_scan((_t(a), _t(b)), axis=1)
    _close(ta, ja, "products", rtol=1e-6, atol=0)
    _close(tb, jb, "sums", rtol=1e-6, atol=1e-6)


def _scan_inputs(t, seed, di=16, n=4):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((1, t, di)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (1, t, di)).astype(np.float32)
    b_t = rng.standard_normal((1, t, n)).astype(np.float32)
    c_t = rng.standard_normal((1, t, n)).astype(np.float32)
    a = np.log(np.broadcast_to(np.arange(1, n + 1, dtype=np.float32),
                               (di, n))).astype(np.float32)
    s0 = (rng.standard_normal((1, di, n)) * 0.1).astype(np.float32)
    return u, dt, b_t, c_t, a, s0


@pytest.mark.parametrize("t", [16, 100, 1024])
def test_ssm_scan_chunked_matches_jax(t):
    """T = 1024 takes two chunks of SCAN_CHUNK = 512."""
    args = _scan_inputs(t, seed=t)
    jy, js = jmamba._ssm_scan_chunked(*map(jnp.asarray, args))
    ty, ts = tmamba._ssm_scan_chunked(*map(_t, args))
    _close(ty, jy, "scan outputs")
    _close(ts, js, "final state")


def test_ssm_scan_refuses_a_ragged_chunking_like_jax():
    args = _scan_inputs(600, seed=1, di=4, n=2)
    with pytest.raises(ValueError) as jerr:
        jmamba._ssm_scan_chunked(*map(jnp.asarray, args))
    with pytest.raises(ValueError) as terr:
        tmamba._ssm_scan_chunked(*map(_t, args))
    assert str(terr.value) == str(jerr.value) == "T=600 must divide chunk=512"


@pytest.mark.parametrize("t,with_state", [(16, False), (16, True),
                                          (1, True), (1, False), (7, True)])
def test_mamba_apply_matches_jax(t, with_state):
    cfg = _cfg()
    p = _params(cfg, seed=t)
    rng = np.random.default_rng(t + 1)
    x = (rng.standard_normal((B, t, cfg.d_model)) * 0.3).astype(np.float32)
    di = jmamba.d_inner(cfg)
    st = {"conv": rng.standard_normal((B, 3, di)).astype(np.float32),
          "ssm": (rng.standard_normal((B, di, 8)) * 0.1).astype(
              np.float32)} if with_state else None
    jy, jst = jmamba.mamba_apply(
        p, jnp.asarray(x), cfg,
        state=None if st is None else jax.tree.map(jnp.asarray, st))
    ty, tst = tmamba.mamba_apply(_tree(p), _t(x), port_config(cfg),
                                 state=None if st is None else _tree(st))
    _close(ty, jy, "mamba output")
    if with_state:
        for k in ("conv", "ssm"):
            _close(tst[k], jst[k], f"state {k}")
    else:
        assert tst is None and jst is None


def test_decode_equals_scan(monkeypatch):
    cfg = port_config(_cfg())
    p = _tree(_params(_cfg(), seed=3))
    x = _t(np.random.default_rng(4).standard_normal((2, 16, 32)) * 0.3)
    monkeypatch.setattr(tmamba, "SCAN_CHUNK", 8)     # two chunks, as JAX's
    y, _ = tmamba.mamba_apply(p, x, cfg)
    s = {"conv": torch.zeros((2, 3, 64)), "ssm": torch.zeros((2, 64, 8))}
    outs = []
    for t in range(16):
        o, s = tmamba.mamba_apply(p, x[:, t:t + 1], cfg, state=s)
        outs.append(o)
    assert torch.allclose(torch.cat(outs, 1), y, atol=1e-3)


def test_bfloat16_parameters_match_jax():
    """jamba's types: parameters and compute in bfloat16, the scan and its
    state in float32, ``a_log`` rounded to bfloat16 as it is stored."""
    jcfg = _cfg(param_dtype="bfloat16")
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    jp = jmamba.init_mamba(jax.random.PRNGKey(5), jcfg)
    assert jp["a_log"].dtype == jnp.bfloat16
    x = (np.random.default_rng(6).standard_normal((B, 16, 32)) * 0.3)
    jx = jnp.asarray(x, jnp.bfloat16)
    state = {"conv": jnp.zeros((B, 3, 64), jnp.bfloat16),
             "ssm": jnp.zeros((B, 64, 8), jnp.float32)}
    jy, jst = jmamba.mamba_apply(jp, jx, jcfg, state=state)
    tp = {k: _t(np.asarray(v, np.float32), torch.bfloat16)
          for k, v in jp.items()}
    tx = _t(np.asarray(jx, np.float32), torch.bfloat16)
    tst0 = {"conv": torch.zeros((B, 3, 64), dtype=torch.bfloat16),
            "ssm": torch.zeros((B, 64, 8))}
    ty, tst = tmamba.mamba_apply(tp, tx, port_config(jcfg), state=tst0)
    assert ty.dtype == torch.bfloat16 and tst["ssm"].dtype == torch.float32
    assert tst["conv"].dtype == torch.bfloat16
    _close(ty, jy, "bfloat16 output", rtol=0, atol=5e-3)
    _close(tst["ssm"], jst["ssm"], "bfloat16 ssm state", rtol=0, atol=5e-3)
    np.testing.assert_array_equal(tst["conv"].float().numpy(),
                                  np.asarray(jst["conv"], np.float32))


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
def test_init_mamba_leaves_match_jax(pdt):
    jcfg = _cfg(param_dtype=pdt)
    jp = jmamba.init_mamba(jax.random.PRNGKey(0), jcfg)
    tp = tmamba.init_mamba(tblocks.Draw(torch.Generator().manual_seed(0),
                                        tblocks.dtype_of(pdt)),
                           port_config(jcfg))
    assert set(tp) == set(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape, k
        assert str(tp[k].dtype).endswith(str(v.dtype)), k
    for k in ("conv_b", "dt_bias", "a_log", "d_skip"):     # not drawn
        # torch's and XLA's log may differ in the last float32 bit
        np.testing.assert_allclose(tp[k].float().numpy(),
                                   np.asarray(jp[k], np.float32), rtol=1e-6)
