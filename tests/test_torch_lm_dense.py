"""The port's dense GQA language models and their serving loop against
the JAX package's.

The four dense architectures' `smoke_config`s (internlm2-1.8b,
llama3.2-3b, qwen3-32b with qk-norm, gemma3-12b with banded local layers,
sandwich norms and tied heads) and `tests/test_models.py`'s `_dense` and
`_gemma`.  Parameters come from the JAX package's `init_model`, carried
across as numpy arrays (`lm_params_from_numpy`); tokens are numpy arrays
made from a seed.  The prompt (12 tokens) is longer than gemma's window
(8), so the banded path's previous chunk and the decode window both
bite.  Tolerances:

- logits and caches: rtol 1e-4 / atol 1e-5, as for the MLA model in
  `tests/test_torch_lm.py` (float32 softmaxes and products sum in
  another order than XLA's);
- greedy tokens: exact;
- `remat` on against off: bitwise (recomputation changes no value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jregistry
from repro.models import lm as jlm
from repro.serve import lm_engine as jengine
from repro_torch import configs as tregistry
from repro_torch.models import lm as tlm
from repro_torch.serve import lm_engine as tengine
from tests.test_models import _dense, _gemma
from tests.test_torch_lm import _leaves, port_config

RTOL, ATOL = 1e-4, 1e-5
B, T, PREFILL, STEPS = 2, 20, 12, 8
ARCHS = ("internlm2-1.8b", "llama3.2-3b", "qwen3-32b", "gemma3-12b")
CONFIGS = {**{a: (lambda a=a: jregistry.get_smoke_config(a)) for a in ARCHS},
           "dense": _dense, "gemma": _gemma}


@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    """(port cfg, port params, tokens, JAX outputs): train logits; prefill
    logits and cache; each decode step's logits until the cache is full,
    and the cache then; one more decode at cache_len == max_len and the
    cache after it; the JAX engine's greedy tokens."""
    jcfg = CONFIGS[request.param]()
    tcfg = port_config(jcfg)
    jp = jax.jit(jlm.init_model, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg)
    # non-zero norm scales, so every norm's scale is exercised
    leaves, treedef = jax.tree.flatten(jp)
    rng = np.random.default_rng(5)
    leaves = [l + rng.uniform(-0.3, 0.3, l.shape).astype(np.float32)
              if np.all(np.asarray(l) == 0) else l for l in leaves]
    jp = jax.tree.unflatten(treedef, leaves)
    tp = tlm.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab, (B, T)).astype(np.int32)
    fwd = jax.jit(jlm.forward, static_argnames=("cfg", "mode", "remat"))
    out = {"train": fwd(jp, {"tokens": toks}, cfg=jcfg, mode="train",
                        remat=False)["logits"]}
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
    return tcfg, tp, toks, out, jax.tree.map(np.asarray, jp)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _fwd(tp, tcfg, toks, **kw):
    return tlm.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_ones(arch):
    for get in ("get_config", "get_smoke_config"):
        assert getattr(tregistry, get)(arch) == port_config(
            getattr(jregistry, get)(arch)), (arch, get)


def test_gemma3_stacks_8_repeats_of_5_local_and_1_global():
    cfg = tregistry.get_config("gemma3-12b")
    assert cfg.scan_groups() == [(0, 48)]
    assert [cfg.layer_is_local(i) for i in range(6)] == [True] * 5 + [False]
    cache = tlm.init_cache(cfg, 2, 16, device="meta")
    assert len(cache) == 1 and len(cache[0]) == 6
    assert tuple(cache[0][0]["k"].shape) == (8, 2, 16, 8, 256)
    assert cache[0][5]["v"].dtype == torch.bfloat16


def test_params_from_numpy_cover_every_leaf(model):
    tcfg, tp, _, _, jtree = model
    jleaves = dict(_leaves(jtree))
    tleaves = dict(_leaves(tp))
    assert set(jleaves) == set(tleaves)
    for path, arr in jleaves.items():
        np.testing.assert_array_equal(tleaves[path].numpy(), arr, path)
    meta = dict(_leaves(tlm.init_model(None, tcfg, device="meta")))
    assert {k: tuple(v.shape) for k, v in meta.items()} == {
        k: v.shape for k, v in jleaves.items()}


def test_train_forward_matches_jax_and_remat_changes_nothing(model):
    tcfg, tp, toks, out, _ = model
    got = _fwd(tp, tcfg, toks, mode="train", remat=False)
    _close(got["logits"], out["train"], "train logits")
    assert got["cache"] is None and got["aux"] == {}
    for policy in (None, "dots", "dots_batch", "everything"):
        again = _fwd(tp, tcfg, toks, mode="train", remat=True,
                     remat_policy=policy)
        assert torch.equal(again["logits"], got["logits"]), policy


def test_prefill_and_decode_match_jax(model):
    tcfg, tp, toks, out, _ = model
    cache = tlm.init_cache(tcfg, B, T, device="cpu")
    got = _fwd(tp, tcfg, toks[:, :PREFILL], mode="prefill", cache=cache)
    _close(got["logits"], out["prefill"], "prefill logits")
    for (path, want), (_, have) in zip(_leaves(out["prefill_cache"]),
                                       _leaves(got["cache"])):
        _close(have, want, f"prefill cache {path}")
    for n, i in enumerate(range(PREFILL, T)):
        got = _fwd(tp, tcfg, toks[:, i:i + 1], mode="decode", cache=cache,
                   cache_len=i)
        _close(got["logits"], out["decode"][n], f"decode logits at {i}")
        assert got["cache"][0][0]["k"] is cache[0][0]["k"]      # in place
    for (path, want), (_, have) in zip(_leaves(out["cache"]),
                                       _leaves(cache)):
        _close(have, want, f"decode cache {path}")


def test_decode_past_max_len_overwrites_the_tail_as_jax_does(model):
    tcfg, tp, toks, out, _ = model
    cache = tlm.init_cache(tcfg, B, T, device="cpu")
    _fwd(tp, tcfg, toks[:, :PREFILL], mode="prefill", cache=cache)
    for i in range(PREFILL, T):
        _fwd(tp, tcfg, toks[:, i:i + 1], mode="decode", cache=cache,
             cache_len=i)
    before = [leaf.clone() for _, leaf in _leaves(cache)]
    got = _fwd(tp, tcfg, toks[:, :1], mode="decode", cache=cache,
               cache_len=T)
    _close(got["logits"], out["edge"], "logits at the edge")
    for (path, want), (_, have), old in zip(_leaves(out["edge_cache"]),
                                            _leaves(cache), before):
        _close(have, want, f"clamped cache {path}")
        assert torch.equal(have[:, :, :-1], old[:, :, :-1]), path
        assert not torch.equal(have[:, :, -1], old[:, :, -1]), path


def test_greedy_serving_matches_jax_token_for_token(model):
    tcfg, tp, toks, out, _ = model
    got = tengine.ServeEngine(tcfg, tp, max_len=T).generate(
        torch.from_numpy(toks[:, :PREFILL]), STEPS)
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), out["tokens"])


def test_remat_policy_without_counterpart_is_refused():
    cfg = tregistry.get_smoke_config("internlm2-1.8b")
    params = tlm.init_model(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="item 12"):
        tlm.forward(params, batch, cfg, remat_policy="nothing_saveable")


def test_remat_recomputes_in_the_backward_and_gives_the_same_gradients():
    """Checkpointed repeats run their forward twice under backward (once
    without remat); the gradients are bitwise equal."""
    cfg = tregistry.get_smoke_config("gemma3-12b")
    params = tlm.init_model(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    leaves = [leaf.requires_grad_() for _, leaf in _leaves(params)]
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    calls = []
    orig = tlm._apply_layer

    def counted(*args, **kwargs):
        calls.append(args[3])
        return orig(*args, **kwargs)

    grads = {}
    for remat in (False, True):
        calls.clear()
        tlm._apply_layer = counted
        try:
            logits = tlm.forward(params, {"tokens": toks}, cfg,
                                 remat=remat)["logits"]
            grads[remat] = torch.autograd.grad(logits.square().sum(), leaves)
        finally:
            tlm._apply_layer = orig
        assert len(calls) == cfg.n_layers * (2 if remat else 1)
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)
