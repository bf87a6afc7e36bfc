"""The port's RWKV6 and Jamba language models and their serving loop
against the JAX package's.

rwkv6-3b's and jamba-1.5-large-398b's `smoke_config`s and
`tests/test_models.py`'s `_rwkv` and `_jamba` (jamba's smoke config
routes with capacity factor 1.25, so experts drop tokens; `_jamba` with
8.0, so none do).  Parameters come from the JAX package's `init_model`,
every all-zero leaf perturbed, carried across as numpy arrays
(`lm_params_from_numpy`); tokens are numpy arrays made from a seed.  The
16-token prefill takes RWKV's chunked WKV and Mamba's scan; decode their
recurrent steps.  Tolerances:

- logits and state caches: rtol 1e-4 / atol 1e-4 (float32 products and
  sums in another order than XLA's, the chunked WKV's factors up to
  e^64; measured: under 5e-5 on rwkv6-3b's smoke logits, up to 3.7;
  under 2e-5 on the others);
- greedy tokens: exact;
- decode against the train forward: 2e-2, as
  `tests/test_models.py::test_decode_matches_train`;
- the loss: rtol 1e-6; each gradient element within 1e-3 of its leaf's
  largest plus 1e-4 of itself.  RWKV6's chunked WKV factors its decay as
  exp(lw_before) and exp(-lw_cum), |lw_cum| up to 64 within a chunk: the
  two factors' gradients are large and nearly cancel, so the summation
  order moves each gradient by ~3e-4 of its norm (measured: 4.05e-4 of
  the leaf's largest at rwkv6-3b's smoke config; Jamba's 2e-5);
- `remat` on against off: bitwise, logits and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jregistry
from repro.models import lm as jlm
from repro.serve import lm_engine as jengine
from repro.train import step as jstep
from repro_torch.ckpt import manager as tckpt
from repro_torch.models import lm as tlm
from repro_torch.serve import lm_engine as tengine
from repro_torch.train import step as tstep
from tests.test_models import _jamba, _rwkv
from tests.test_torch_lm import _leaves, port_config

RTOL, ATOL = 1e-4, 1e-4
B, T, PREFILL, STEPS = 2, 32, 16, 8
CONFIGS = {"rwkv6-3b": lambda: jregistry.get_smoke_config("rwkv6-3b"),
           "jamba": lambda: jregistry.get_smoke_config(
               "jamba-1.5-large-398b"),
           "rwkv": _rwkv, "jamba_nodrop": _jamba}


def perturbed(jp, seed=5):
    """The JAX tree with every all-zero leaf (norm scales, mix offsets,
    biases) moved off zero, so that each is exercised."""
    leaves, treedef = jax.tree.flatten(jp)
    rng = np.random.default_rng(seed)
    leaves = [(l + rng.uniform(-0.3, 0.3, l.shape)).astype(l.dtype)
              if np.all(np.asarray(l) == 0) else l for l in leaves]
    return jax.tree.unflatten(treedef, leaves)


@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    """(JAX cfg, port cfg, port params, tokens, JAX outputs): train
    logits; prefill logits and cache; each decode step's logits and the
    cache after the last; the JAX engine's greedy tokens; the JAX
    parameters."""
    jcfg = CONFIGS[request.param]()
    tcfg = port_config(jcfg)
    jp = perturbed(jax.jit(jlm.init_model, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
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
    out["tokens"] = np.asarray(jengine.ServeEngine(jcfg, jp, max_len=T)
                               .generate(jnp.asarray(toks[:, :PREFILL]),
                                         STEPS))
    out["params"] = jp
    return jcfg, tcfg, tp, toks, out


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _close_trees(got, want, what):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want), what
    for path, w in want.items():
        assert got[path].dtype == tlm.blocks.DTYPES[str(w.dtype)], path
        _close(got[path], w, f"{what} {path}")


def _paths(tree, prefix=""):
    """``tree``'s structure with each leaf's path (as `_leaves` names it)."""
    if isinstance(tree, dict):
        return {k: _paths(v, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_paths(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
    return prefix


def _fwd(tp, tcfg, toks, **kw):
    return tlm.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg, **kw)


def test_params_from_numpy_cover_every_leaf(model):
    jcfg, tcfg, tp, _, _ = model
    want = jax.eval_shape(lambda: jlm.init_model(jax.random.PRNGKey(0),
                                                 jcfg))
    meta = dict(_leaves(tlm.init_model(None, tcfg, device="meta")))
    got = dict(_leaves(tp))
    want = dict(_leaves(want))
    assert set(meta) == set(got) == set(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == tuple(meta[path].shape) == w.shape
        assert got[path].dtype == meta[path].dtype


def test_train_forward_matches_jax(model):
    _, tcfg, tp, toks, out = model
    with torch.no_grad():
        got = _fwd(tp, tcfg, toks, mode="train", remat=False)
    _close(got["logits"], out["train"], "train logits")
    assert got["cache"] is None


def test_prefill_and_decode_match_jax_with_their_state_caches(model):
    _, tcfg, tp, toks, out = model
    cache = tlm.init_cache(tcfg, B, T, device="cpu")
    with torch.no_grad():
        got = _fwd(tp, tcfg, toks[:, :PREFILL], mode="prefill", cache=cache)
        _close(got["logits"], out["prefill"], "prefill logits")
        _close_trees(cache, out["prefill_cache"], "prefill cache")
        first = dict(_leaves(cache))
        for n, i in enumerate(range(PREFILL, T)):
            got = _fwd(tp, tcfg, toks[:, i:i + 1], mode="decode",
                       cache=cache, cache_len=i)
            _close(got["logits"], out["decode"][n], f"decode logits at {i}")
    # the states are written in place into the stacked cache
    for path, leaf in _leaves(got["cache"]):
        assert leaf is first[path], path
    _close_trees(cache, out["cache"], "decode cache")


def test_greedy_serving_matches_jax_token_for_token(model):
    _, tcfg, tp, toks, out = model
    got = tengine.ServeEngine(tcfg, tp, max_len=T).generate(
        torch.from_numpy(toks[:, :PREFILL]), STEPS)
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), out["tokens"])


def test_decode_matches_train(model):
    _, tcfg, tp, toks, _ = model
    with torch.no_grad():
        ref = _fwd(tp, tcfg, toks, mode="train", remat=False)["logits"]
        cache = tlm.init_cache(tcfg, B, T + 8, device="cpu")
        tp_ = T - 4
        logits = [_fwd(tp, tcfg, toks[:, :tp_], mode="prefill",
                       cache=cache)["logits"]]
        for i in range(tp_, T):
            logits.append(_fwd(tp, tcfg, toks[:, i:i + 1], mode="decode",
                               cache=cache, cache_len=i)["logits"])
    assert float((torch.cat(logits, 1) - ref).abs().max()) < 2e-2


def test_loss_and_gradients_match_jax(model):
    jcfg, tcfg, tp, toks, out = model
    jp = out["params"]
    batch = {"tokens": toks, "labels": np.concatenate(
        [toks[:, 1:], np.full((B, 1), -100, np.int32)], 1)}
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: jstep.loss_fn(
        p, b, jcfg, jstep.LOCAL, remat=False)[0]))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, _, tgrads = tstep.value_and_grad(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    jgrads = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    # the gradients come in flatten order, as the leaves' paths do
    grads = dict(zip(tckpt.tree_leaves(_paths(tp)), tgrads))
    assert set(grads) == set(jgrads)
    for path, w in jgrads.items():
        tol = 1e-3 * float(np.abs(w).max()) + 1e-4 * np.abs(w)
        assert np.all(np.abs(grads[path].numpy() - w) <= tol), path


def test_remat_changes_no_logit_and_no_gradient(model):
    _, tcfg, tp, toks, _ = model
    leaves = [leaf.detach().clone().requires_grad_() for _, leaf in
              _leaves(tp)]
    params = tlm._tree_map(lambda t: t, tp)
    it = iter(leaves)
    params = tlm._tree_map(lambda _: next(it), params)
    results = {}
    for remat in (False, True):
        logits = _fwd(params, tcfg, toks, mode="train",
                      remat=remat)["logits"]
        results[remat] = (logits.detach(), torch.autograd.grad(
            logits.square().mean(), leaves, allow_unused=True))
    assert torch.equal(results[False][0], results[True][0])
    for a, b in zip(results[False][1], results[True][1]):
        assert (a is None and b is None) or torch.equal(a, b)
