"""The port's weight-only int8 experts against the JAX package's.

`tests/test_perf_variants.py::test_int8_moe_close_to_fp`'s config (8
experts top-2, one shared, capacity factor 8) and deepseek-v2-236b's
smoke config cut to 2 layers (capacity factor 1.25), with
``MoEConfig.quant_int8``.  The JAX package draws each
expert weight in float32 and quantizes it per (expert, out-channel); the
port's `blocks.quantize_int8` of the same float32 weights must give the
same int8 values and scales, bit for bit.  Tolerances:

- the quantized tree: exact;
- `moe_apply` and logits on the int8 tree, float32 compute: rtol 1e-4 /
  atol 1e-5, as the MoE models' other tests (the dequantized weights
  are the same float32 values; the products sum in another order);
- bfloat16 compute: atol 2^-3, 1.5% of the largest output (the
  dequantization, every product and the gated activation round to
  bfloat16 in both packages, the sums in another order; measured: 0.0625,
  one ulp of the largest outputs, up to 8.3);
- int8 against float logits from the same float32 draws: the JAX test's
  relative gap, under 0.15.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jregistry
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models.config import ModelConfig, MoEConfig
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from tests.test_torch_lm import _leaves, port_config

B, T = 2, 16
EXPERTS = ("w_gate", "w_up", "w_down")


def _variant_cfg(quant):
    moe = MoEConfig(num_experts=8, num_shared=1, top_k=2, d_expert=32,
                    first_k_dense=1, d_ff_dense=128, capacity_factor=8.0,
                    quant_int8=quant)
    return ModelConfig(name="q", family="moe", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=4, d_ff=128, vocab=100,
                       head_dim=16, compute_dtype="float32", moe=moe)


def _smoke_cfg(quant):
    """Cut to its dense layer and one MoE layer, as `chip_smoke.py` cuts
    the full config: the MoE layer's input, and so its routes, are then
    the same with and without int8 experts."""
    cfg = jregistry.get_smoke_config("deepseek-v2-236b")
    return dataclasses.replace(cfg, n_layers=2, moe=dataclasses.replace(
        cfg.moe, quant_int8=quant))


CONFIGS = {"variant": _variant_cfg, "dsv2_236b_smoke": _smoke_cfg}


def _np(x):
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    """(JAX cfgs, port cfgs, JAX trees, port trees), float then int8,
    from one key: the same float32 expert draws."""
    out = []
    for quant in (False, True):
        jcfg = CONFIGS[request.param](quant)
        tcfg = port_config(jcfg)
        jp = jax.jit(jlm.init_model, static_argnums=1)(jax.random.PRNGKey(0),
                                                        jcfg)
        tp = tlm.lm_params_from_numpy(tcfg, jax.tree.map(_np, jp),
                                      device="cpu")
        out.append((jcfg, tcfg, jp, tp))
    return out


def _toks(vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def test_quantize_int8_is_the_jax_quantization(models):
    (_, _, jp_fp, _), (_, _, jp_q, _) = models
    want = dict(_leaves(jp_q))
    n = 0
    for path, w in _leaves(jp_fp):
        if path + "_scale" not in want:       # not an expert weight
            continue
        n += 1
        q, scale = tblocks.quantize_int8(torch.from_numpy(np.array(w)))
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(want[path]))
        np.testing.assert_array_equal(scale.numpy(),
                                      np.asarray(want[path + "_scale"]))
    assert n > 0


def test_params_from_numpy_keep_int8_as_int8(models):
    _, (jcfg, tcfg, jp, tp) = models
    got, want = dict(_leaves(tp)), dict(_leaves(jax.tree.map(np.asarray, jp)))
    meta = dict(_leaves(tlm.init_model(None, tcfg, device="meta")))
    assert set(got) == set(want) == set(meta)
    n_int8, n_scale = 0, 0
    for path, w in want.items():
        assert got[path].dtype == meta[path].dtype, path
        assert tuple(got[path].shape) == w.shape, path
        if w.dtype == np.int8:
            n_int8 += 1
            assert got[path].dtype == torch.int8
            np.testing.assert_array_equal(got[path].numpy(), w)
        if path.endswith("_scale"):
            n_scale += 1
            assert got[path].dtype == torch.float32
    assert n_int8 == n_scale > 0 and n_int8 % len(EXPERTS) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_on_int8_experts_matches_jax(models, dtype):
    _, (jcfg, tcfg, jp, tp) = models
    jcfg = dataclasses.replace(jcfg, compute_dtype=dtype)
    tcfg = port_config(jcfg)
    layer = next(i for i in range(jcfg.n_layers) if jcfg.layer_is_moe(i))
    gi, pos = next((gi, layer - start) for gi, (start, length) in
                   enumerate(jcfg.scan_groups())
                   if start <= layer < start + length)
    jffn = jax.tree.map(lambda a: a[0], jp["groups"][gi][pos]["ffn"])
    tffn = tlm._layer_view(tp["groups"][gi][pos]["ffn"], 0)
    x = (np.random.default_rng(2).standard_normal((B, T, jcfg.d_model))
         * 0.5).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jy, jaux = jblocks.moe_apply(jffn, jnp.asarray(x, jdt), jcfg)
    ty, taux = tblocks.moe_apply(
        tffn, torch.from_numpy(x).to(tblocks.dtype_of(dtype)), tcfg)
    assert ty.dtype == tblocks.dtype_of(dtype)
    got, want = ty.float().numpy(), np.asarray(jy.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -3)
    for k in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-4)


def test_dequantized_weight_is_the_jax_one(models):
    _, (jcfg, tcfg, jp, tp) = models
    jffn = jax.tree.map(lambda a: a[0], jp["groups"][-1][0]["ffn"])
    tffn = tlm._layer_view(tp["groups"][-1][0]["ffn"], 0)
    for dtype in ("float32", "bfloat16"):
        for name in EXPERTS:
            want = jblocks._moe_weight(jffn, name, jnp.dtype(dtype))
            got = tblocks._moe_weight(tffn, name, tblocks.dtype_of(dtype))
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))


def test_logits_match_jax_and_stay_close_to_float(models):
    (jfp, tfp, jp_fp, tp_fp), (jq, tq, jp_q, tp_q) = models
    toks = _toks(jq.vocab)
    out = {}
    for tag, jcfg, tcfg, jp, tp in (("fp", jfp, tfp, jp_fp, tp_fp),
                                    ("q", jq, tq, jp_q, tp_q)):
        want = jlm.forward(jp, {"tokens": toks}, jcfg, mode="train",
                           remat=False)["logits"]
        with torch.no_grad():
            got = tlm.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                              remat=False)["logits"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=tag)
        out[tag] = got
    assert bool(out["q"].isfinite().all())
    rel = float((out["q"] - out["fp"]).abs().max()
                / out["fp"].abs().max().clamp_min(1e-6))
    assert 0 < rel < 0.15, rel


def test_port_draws_int8_experts_from_its_float_draws():
    """The port's own init: one generator seed gives the float model and
    the int8 model the same float32 expert draws, quantized in the
    second (so their logits differ by quantization only)."""
    out = {}
    for quant in (False, True):
        cfg = port_config(_variant_cfg(quant))
        params = tlm.init_model(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
        out[quant] = (cfg, params)
    fp_ffn = tlm._layer_view(out[False][1]["groups"][-1][0]["ffn"], 0)
    q_ffn = tlm._layer_view(out[True][1]["groups"][-1][0]["ffn"], 0)
    for name in EXPERTS:
        q, scale = tblocks.quantize_int8(fp_ffn[name])
        assert torch.equal(q, q_ffn[name])
        assert torch.equal(scale, q_ffn[name + "_scale"])
    toks = torch.from_numpy(_toks(100, seed=3))
    with torch.no_grad():
        fp, q = (tlm.forward(p, {"tokens": toks}, c, remat=False)["logits"]
                 for c, p in (out[False], out[True]))
    rel = float((q - fp).abs().max() / fp.abs().max())
    assert 0 < rel < 0.15, rel
