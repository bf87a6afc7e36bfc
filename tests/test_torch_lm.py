"""The port's DeepSeek-V2 language model and serving loop against the
JAX package's.

Parameters come from the JAX package's `init_model`, carried across as
numpy arrays (`lm_params_from_numpy`); tokens are numpy arrays made from
a seed.  Both configs compute in float32: `deepseek_v2_lite_16b`'s
`smoke_config` and `tests/test_models.py::_mla_moe` (q-LoRA, one shared
expert, no drops).  Tolerances:

- logits, caches and the MoE aux losses: rtol 1e-4 / atol 1e-5 (float32
  products and softmaxes sum in another order than XLA's; the measured
  gap is under 1e-5);
- greedy tokens: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v2_lite_16b as jdsv2
from repro.models import lm as jlm
from repro.serve import lm_engine as jengine
from repro_torch import configs as tregistry
from repro_torch.configs import deepseek_v2_lite_16b as tdsv2
from repro_torch.models import blocks as tblocks
from repro_torch.models import config as tconfig
from repro_torch.models import lm as tlm
from repro_torch.serve import lm_engine as tengine
from tests.test_models import _mla_moe

RTOL, ATOL = 1e-4, 1e-5
B, T, PREFILL, STEPS = 2, 16, 8, 8


def port_config(jcfg):
    """The port's ModelConfig with the JAX config's every field."""
    def conv(v):
        if dataclasses.is_dataclass(v):
            cls = getattr(tconfig, type(v).__name__)
            return cls(**{f.name: conv(getattr(v, f.name))
                          for f in dataclasses.fields(v)})
        return v
    return conv(jcfg)


CONFIGS = {"dsv2_lite_smoke": jdsv2.smoke_config, "mla_moe": _mla_moe}


@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    """(JAX cfg, port cfg, JAX params, port params, tokens, JAX outputs):
    train logits and aux; prefill logits and cache; each decode step's
    logits until the cache is full, and the cache then; one more decode
    at cache_len == max_len, and the cache after it; the JAX engine's
    greedy tokens."""
    jcfg = CONFIGS[request.param]()
    tcfg = port_config(jcfg)
    jp = jax.jit(jlm.init_model, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg)
    tp = tlm.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab, (B, T)).astype(np.int32)
    fwd = jax.jit(jlm.forward, static_argnames=("cfg", "mode", "remat"))
    train = fwd(jp, {"tokens": toks}, cfg=jcfg, mode="train", remat=False)
    out = {"train": train["logits"], "aux": train["aux"]}
    pre = fwd(jp, {"tokens": toks[:, :PREFILL]}, cfg=jcfg, mode="prefill",
              cache=jlm.init_cache(jcfg, B, T), remat=False)
    out["prefill"], cache = pre["logits"], pre["cache"]
    out["prefill_cache"] = cache
    out["decode"] = []
    for i in range(PREFILL, T):
        d = fwd(jp, {"tokens": toks[:, i:i + 1]}, cfg=jcfg, mode="decode",
                cache=cache, cache_len=jnp.int32(i), remat=False)
        out["decode"].append(d["logits"])
        cache = d["cache"]
    out["cache"] = cache
    edge = fwd(jp, {"tokens": toks[:, :1]}, cfg=jcfg, mode="decode",
               cache=cache, cache_len=jnp.int32(T), remat=False)
    out["edge"], out["edge_cache"] = edge["logits"], edge["cache"]
    out["tokens"] = np.asarray(jengine.ServeEngine(jcfg, jp, max_len=T)
                               .generate(jnp.asarray(toks[:, :PREFILL]),
                                         STEPS))
    return jcfg, tcfg, jp, tp, toks, out


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_configs_are_the_jax_ones():
    assert tdsv2.config() == port_config(jdsv2.config())
    assert tdsv2.smoke_config() == port_config(jdsv2.smoke_config())
    assert tregistry.get_config("deepseek-v2-lite-16b") == tdsv2.config()
    assert (tregistry.get_smoke_config("deepseek-v2-lite-16b")
            == tdsv2.smoke_config())
    cfg = tdsv2.config()
    assert cfg.scan_groups() == [(0, 1), (1, 26)]
    assert [cfg.layer_is_moe(i) for i in range(3)] == [False, True, True]


def test_full_width_tree_has_15_71_b_parameters():
    """Counted on the meta device (no memory, no draws): 26 MoE layers of
    584,847,872, the dense layer 0 of 81,007,104, and embedding, head
    and final norm 419,432,448 - 62.83 GB in float32."""
    shapes = tlm.init_model(None, tdsv2.config(), device="meta")
    assert sum(t.numel() for _, t in _leaves(shapes)) == 15_706_484_224


def test_params_from_numpy_cover_every_leaf(model):
    _, tcfg, jp, tp, _, _ = model
    jleaves = dict(_leaves(jax.tree.map(np.asarray, jp)))
    tleaves = dict(_leaves(tp))
    assert set(jleaves) == set(tleaves)
    for path, arr in jleaves.items():
        np.testing.assert_array_equal(tleaves[path].numpy(), arr, path)
    meta = dict(_leaves(tlm.init_model(None, tcfg, device="meta")))
    assert {k: tuple(v.shape) for k, v in meta.items()} == {
        k: v.shape for k, v in jleaves.items()}


def test_params_from_numpy_refuse_a_wrong_tree(model):
    _, tcfg, jp, _, _, _ = model
    tree = jax.tree.map(np.asarray, jp)
    tree["final_norm"] = {"scale": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="/final_norm/scale: shape"):
        tlm.lm_params_from_numpy(tcfg, tree, device="cpu")
    del tree["lm_head"]
    with pytest.raises(ValueError, match="keys"):
        tlm.lm_params_from_numpy(tcfg, tree, device="cpu")


def test_train_forward_matches_jax(model):
    _, tcfg, _, tp, toks, out = model
    got = tlm.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                      mode="train")
    _close(got["logits"], out["train"], "train logits")
    assert got["cache"] is None
    assert set(got["aux"]) == set(out["aux"]) == {"moe_aux", "moe_z"}
    for k, v in out["aux"].items():
        _close(got["aux"][k], v, k)


def test_prefill_and_decode_match_jax(model):
    _, tcfg, _, tp, toks, out = model
    cache = tlm.init_cache(tcfg, B, T, device="cpu")
    got = tlm.forward(tp, {"tokens": torch.from_numpy(toks[:, :PREFILL])},
                      tcfg, mode="prefill", cache=cache)
    _close(got["logits"], out["prefill"], "prefill logits")
    for (path, want), (_, have) in zip(_leaves(out["prefill_cache"]),
                                       _leaves(got["cache"])):
        _close(have, want, f"prefill cache {path}")
    cache = got["cache"]
    for n, i in enumerate(range(PREFILL, T)):
        got = tlm.forward(tp, {"tokens": torch.from_numpy(toks[:, i:i + 1])},
                          tcfg, mode="decode", cache=cache, cache_len=i)
        _close(got["logits"], out["decode"][n], f"decode logits at {i}")
        assert got["cache"][0][0]["ckv"] is cache[0][0]["ckv"]   # in place
    for (path, want), (_, have) in zip(_leaves(out["cache"]),
                                       _leaves(cache)):
        _close(have, want, f"decode cache {path}")


def test_decode_past_max_len_overwrites_the_tail_as_jax_does(model):
    """dynamic_update_slice clamps its start: a decode at cache_len ==
    max_len writes the last slot and attends over every position."""
    _, tcfg, _, tp, toks, out = model
    cache = tlm.init_cache(tcfg, B, T, device="cpu")
    tlm.forward(tp, {"tokens": torch.from_numpy(toks[:, :PREFILL])}, tcfg,
                mode="prefill", cache=cache)
    for i in range(PREFILL, T):
        tlm.forward(tp, {"tokens": torch.from_numpy(toks[:, i:i + 1])}, tcfg,
                    mode="decode", cache=cache, cache_len=i)
    before = [leaf.clone() for _, leaf in _leaves(cache)]
    got = tlm.forward(tp, {"tokens": torch.from_numpy(toks[:, :1])}, tcfg,
                      mode="decode", cache=cache, cache_len=T)
    _close(got["logits"], out["edge"], "logits at the edge")
    for (path, want), (_, have), old in zip(_leaves(out["edge_cache"]),
                                            _leaves(cache), before):
        _close(have, want, f"clamped cache {path}")
        assert torch.equal(have[:, :, :-1], old[:, :, :-1]), path
        assert not torch.equal(have[:, :, -1], old[:, :, -1]), path


def test_greedy_serving_matches_jax_token_for_token(model):
    _, tcfg, _, tp, toks, out = model
    engine = tengine.ServeEngine(tcfg, tp, max_len=32)
    got = engine.generate(torch.from_numpy(toks[:, :PREFILL]), STEPS)
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), out["tokens"])
    # temperature > 0 without a generator decodes greedily, as in JAX
    hot = tengine.ServeEngine(tcfg, tp, max_len=32, temperature=0.7)
    np.testing.assert_array_equal(
        hot.generate(torch.from_numpy(toks[:, :PREFILL]), STEPS).numpy(),
        out["tokens"])


def test_sampling_draws_from_the_generator():
    cfg = tdsv2.smoke_config()
    params = tlm.init_model(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    engine = tengine.ServeEngine(cfg, params, max_len=16, temperature=1.0)
    prompts = torch.zeros((2, 4), dtype=torch.int32)
    a, b = (engine.generate(prompts, 6,
                            generator=torch.Generator().manual_seed(s))
            for s in (5, 5))
    assert torch.equal(a, b) and a.shape == (2, 6)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab
    logits = torch.tensor([[0.0, 30.0, 0.0], [-30.0, -30.0, 0.0]])
    draw = tengine.sample_categorical(torch.Generator().manual_seed(0),
                                      logits)
    assert draw.tolist() == [1, 2]


def test_eos_stops_a_lane(model):
    """A lane emits 0 after its eos token, as the JAX loop does; up to and
    with the eos it emits the greedy tokens."""
    _, tcfg, _, tp, toks, out = model
    eos = int(out["tokens"][0, 2])
    got = tengine.ServeEngine(tcfg, tp, max_len=32).generate(
        torch.from_numpy(toks[:, :PREFILL]), STEPS, eos_id=eos).numpy()
    first = list(out["tokens"][0]).index(eos)
    assert (got[0, :first + 1] == out["tokens"][0, :first + 1]).all()
    assert (got[0, first + 1:] == 0).all()


# ---- refusals ------------------------------------------------------------------


def test_refusals_name_their_item():
    with pytest.raises(KeyError, match="unknown arch"):
        tregistry.get_config("gpt-2")
    cfg = tdsv2.smoke_config()
    params = tlm.init_model(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="ShardCtx.enabled"):
        tlm.forward(params, batch, cfg, ctx=tblocks.ShardCtx(enabled=True))
    with pytest.raises(ValueError, match="unknown mode"):
        tlm.forward(params, batch, cfg, mode="score")
    with pytest.raises(ValueError, match="needs a cache"):
        tlm.forward(params, batch, cfg, mode="decode")


def test_cuda_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tdsv2.smoke_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.init_model(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.init_cache(cfg, 1, 8)
