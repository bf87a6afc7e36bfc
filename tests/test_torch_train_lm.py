"""The port's LM training tier against the JAX package's: the loss, the
training step (microbatch 1 and 2), AdamW on the LM's nested tree, the
token pipeline and the restart drill.

Parameters come from the JAX package's `init_model` (the smoke configs
of internlm2-1.8b and gemma3-12b), batches and gradients from a numpy
seed; both packages get them as numpy arrays.  Tolerances, stated where
they are used:

- `cross_entropy` and `loss_fn`: rtol 1e-6 (float32 logsumexp in another
  order);
- one training step: the loss and ``grad_norm`` within rtol 1e-6,
  ``lr`` exactly; gradients within rtol 1e-4 / atol 1e-5 of the leaf's
  largest (the tolerance `chip_smoke.py` holds the card's SNN step to);
  moments within 5e-5 of the leaf's largest magnitude (a CPU run read
  1.1e-5); parameters within what that gradient gap can move them
  (`test_train_step_matches_jax`);
- AdamW on a nested tree: as `tests/test_torch_train.py` holds it on the
  SNN's flat dict (1e-6 relative, the leaf's largest as the floor); on
  the flat dict the same bits as the per-key loop it replaced;
- checkpoints and restarts: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jregistry
from repro.data import pipeline as jpipeline
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.ckpt import manager as tckpt
from repro_torch.data import pipeline as tpipeline
from repro_torch.ft import runner as trunner
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep
from tests.test_torch_lm import _leaves, port_config

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
ARCHS = ("internlm2-1.8b", "gemma3-12b")
B, T = 4, 16


def _f32(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _batch(vocab, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, T)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -100, np.int32)], 1)
    out = {"tokens": toks, "labels": labels}
    if mask:
        out["loss_mask"] = (rng.random((B, T)) < 0.7).astype(np.int32)
    return out


def _models(arch):
    jcfg = jregistry.get_smoke_config(arch)
    jp = jax.jit(jlm.init_model, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg)
    tcfg = port_config(jcfg)
    tp = tlm.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _models(request.param)


# ---- loss ---------------------------------------------------------------------


@pytest.mark.parametrize("with_mask", [False, True])
def test_cross_entropy_matches_jax(with_mask):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((B, T, 50)) * 4).astype(np.float32)
    batch = _batch(50, 4, mask=with_mask)
    labels = batch["labels"].copy()
    labels[0, :5] = -100
    mask = batch.get("loss_mask")
    want = jstep.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               None if mask is None else jnp.asarray(mask))
    got = tstep.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6)
    # every position ignored: the denominator floors at 1, the loss is 0
    none = torch.full((B, T), -100, dtype=torch.int32)
    assert float(tstep.cross_entropy(torch.from_numpy(logits), none)) == 0.0


def test_loss_fn_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    batch = _batch(jcfg.vocab, 5, mask=True)
    want, wm = jstep.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                             jcfg, jstep.LOCAL, remat=False)
    got, gm = tstep.loss_fn(tp, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6)
    assert set(gm) == set(wm) == {"ce_loss"}
    ev = tstep.make_eval_step(tcfg)(tp, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    assert torch.equal(ev["loss"], got.detach()) and not ev["loss"].requires_grad


# ---- the training step ----------------------------------------------------------


def _paths(tree, prefix=""):
    """``tree``'s structure with each leaf's path (as `_leaves` names it)."""
    if isinstance(tree, dict):
        return {k: _paths(v, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_paths(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
    return prefix


def _jax_grads(jp, batch, jcfg, microbatch):
    """The JAX step's gradient: each microbatch's, summed in float32 in
    order and divided, as its scan does."""
    grad = jax.jit(jax.grad(lambda p, b: jstep.loss_fn(
        p, b, jcfg, jstep.LOCAL, remat=False)[0]))
    total = None
    for i in range(microbatch):
        mb = {k: jnp.asarray(v.reshape(microbatch, -1, *v.shape[1:])[i])
              for k, v in batch.items()}
        g = grad(jp, mb)
        total = g if total is None else jax.tree.map(jnp.add, total, g)
    return jax.tree.map(lambda g: np.asarray(g / microbatch), total)


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_jax(models, microbatch):
    """One step at microbatch 1 and 2.  Gradients within rtol 1e-4 /
    atol 1e-5 of the leaf's largest (the port's, taken apart, against
    the JAX step's); the moments within 5e-5 of the leaf's largest; each
    parameter within 1e-6 of the leaf's largest plus what that gradient
    gap can move it: AdamW's first step moves an element by about
    lr g / (|g| + eps), so a gap of tol moves it by at most
    2 lr min(1, tol / |g|)."""
    jcfg, tcfg, jp, tp = models
    jc, tc = jadamw.AdamWConfig(**OPT), tadamw.AdamWConfig(**OPT)
    batch = _batch(jcfg.vocab, 6)
    jstate = jstep.TrainState(jp, jadamw.init(jc, jp), jnp.int32(0))
    jnew, jm = jax.jit(jstep.make_train_step(jcfg, jc, microbatch=microbatch))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate = tstep.TrainState(tp, tadamw.init(tc, tp),
                              torch.zeros((), dtype=torch.int32))
    tnew, tm = tstep.make_train_step(tcfg, tc, microbatch=microbatch)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(tnew.step) == 1 and int(tnew.opt.step) == 1
    assert set(tm) == set(jm) == {"ce_loss", "grad_norm", "lr", "loss"}
    for name in ("loss", "ce_loss", "grad_norm"):
        np.testing.assert_allclose(_f32(tm[name]), _f32(jm[name]), rtol=1e-6,
                                   err_msg=name)
    assert float(tm["lr"]) == float(jm["lr"])
    lr = float(jm["lr"])
    # the port's gradient, as its step takes it
    tgrads = []
    for i in range(microbatch):
        mb = {k: torch.from_numpy(v.reshape(microbatch, -1, *v.shape[1:])[i])
              for k, v in batch.items()}
        g = tstep.value_and_grad(tp, mb, tcfg, tstep.LOCAL, True, None)[2]
        tgrads = g if not tgrads else [a + b for a, b in zip(tgrads, g)]
    jgrads = dict(_leaves(_jax_grads(jp, batch, jcfg, microbatch)))
    # the leaves' paths in flatten order, as the gradients come
    paths = tckpt.tree_leaves(_paths(tp))
    tol = {}
    for path, g in zip(paths, tgrads):
        g, w = _f32(g) / microbatch, jgrads[path]
        tol[path] = 1e-4 * np.abs(w) + 1e-5 * float(np.abs(w).max())
        assert np.all(np.abs(g - w) <= tol[path]), f"gradient {path}"
    for part, got, want in (("params", tnew.params, jnew.params),
                            ("mu", tnew.opt.mu, jnew.opt.mu),
                            ("nu", tnew.opt.nu, jnew.opt.nu)):
        wl = dict(_leaves(jax.tree.map(np.asarray, want)))
        gl = dict(_leaves(got))
        assert set(gl) == set(wl)
        for path, w in wl.items():
            g = gl[path]
            assert not g.requires_grad
            if part == "params":
                ag = np.abs(jgrads[path])
                moved = 2 * lr * np.minimum(
                    1.0, tol[path] / np.maximum(ag, 1e-30))
                bound = moved + 1e-6 * float(np.abs(w).max())
            else:
                bound = 5e-5 * float(np.abs(w).max())
            assert np.all(np.abs(_f32(g) - w) <= bound), f"{part} {path}"
    # the step moved the parameters and left its inputs as they were
    assert not torch.equal(tnew.params["embed"], tp["embed"])
    assert not tp["embed"].requires_grad


def test_microbatches_accumulate_the_full_batch_gradient():
    """Two microbatches of 2 give the 4-sample batch's mean loss, and
    gradients within float32 summation gaps of it."""
    _, tcfg, _, tp = _models("internlm2-1.8b")
    tc = tadamw.AdamWConfig(**OPT)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg.vocab, 7).items()}
    state = tstep.TrainState(tp, tadamw.init(tc, tp),
                             torch.zeros((), dtype=torch.int32))
    _, one = tstep.make_train_step(tcfg, tc)(state, batch)
    _, two = tstep.make_train_step(tcfg, tc, microbatch=2)(state, batch)
    # equal-length halves with one -100 per row: the mean of the halves'
    # means is the batch mean
    np.testing.assert_allclose(_f32(two["loss"]), _f32(one["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(_f32(two["grad_norm"]),
                               _f32(one["grad_norm"]), rtol=1e-5)


# ---- AdamW on the LM tree ------------------------------------------------------


def test_adamw_on_the_nested_tree_matches_jax(models):
    jcfg, _, jp, tp = models
    jc = jadamw.AdamWConfig(**OPT, weight_decay=0.1)
    tc = tadamw.AdamWConfig(**OPT, weight_decay=0.1)
    rng = np.random.default_rng(8)
    jgrads = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), jp)
    tgrads = jax.tree.map(torch.from_numpy, jgrads)
    # the port walks the tree in JAX's flatten order
    assert [tuple(x.shape) for x in tckpt.tree_leaves(tgrads)] == [
        x.shape for x in jax.tree.leaves(jgrads)]
    np.testing.assert_allclose(_f32(tadamw.global_norm(tgrads)),
                               _f32(jadamw.global_norm(jgrads)), rtol=1e-6)
    jstate = jadamw.init(jc, jp)
    tstate = tadamw.init(tc, tp)
    for _ in range(2):
        jp, jstate, jm = jadamw.update(jc, jgrads, jstate, jp)
        tp, tstate, tm = tadamw.update(tc, tgrads, tstate, tp)
    np.testing.assert_allclose(_f32(tm["grad_norm"]), _f32(jm["grad_norm"]),
                               rtol=1e-6)
    for part, got, want in (("params", tp, jp), ("mu", tstate.mu, jstate.mu),
                            ("nu", tstate.nu, jstate.nu)):
        for path, g, w in zip(tckpt.tree_leaves(_paths(got)),
                              tckpt.tree_leaves(got),
                              jax.tree.leaves(want)):
            w = np.asarray(w)
            np.testing.assert_allclose(
                _f32(g), w, rtol=1e-6, atol=1e-6 * float(np.abs(w).max()),
                err_msg=f"{part} {path}")


def _flat_update(cfg, grads, state, params):
    """The per-key loop `adamw.update` ran on flat dicts before it walked
    trees."""
    gnorm = torch.sqrt(sum(grads[k].float().square().sum()
                           for k in sorted(grads)))
    one = torch.tensor(1.0)
    scale = torch.minimum(one, cfg.clip_norm / torch.maximum(
        gnorm, torch.tensor(1e-9)))
    step = state.step + 1
    lr = tadamw.schedule(cfg, step)
    stepf = step.float()
    bc1 = 1.0 - torch.tensor(cfg.b1) ** stepf
    bc2 = 1.0 - torch.tensor(cfg.b2) ** stepf
    out = {}, {}, {}
    for k in sorted(params):
        p, g = params[k], grads[k].float() * scale
        m32 = state.mu[k].float() * cfg.b1 + g * (1 - cfg.b1)
        v32 = state.nu[k].float() * cfg.b2 + g.square() * (1 - cfg.b2)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if p.ndim >= 2:
            delta = delta + cfg.weight_decay * p.float()
        out[0][k], out[1][k], out[2][k] = p.float() - lr * delta, m32, v32
    return out


def test_adamw_on_a_flat_dict_keeps_its_bits():
    rng = np.random.default_rng(9)
    shapes = {"w_out": (6, 3), "syn_w": (4, 5), "w_in": (7,)}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in shapes.items()}
    grads = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for k, s in shapes.items()}
    cfg = tadamw.AdamWConfig(**OPT, weight_decay=0.1)
    state = tadamw.init(cfg, params)
    new, st, _ = tadamw.update(cfg, grads, state, params)
    want = _flat_update(cfg, grads, state, params)
    assert list(new) == list(params)
    for got, ref in zip((new, st.mu, st.nu), want):
        for k in shapes:
            assert torch.equal(got[k], ref[k]), k


# ---- the token pipeline ----------------------------------------------------------


def test_pipeline_shapes_labels_and_purity():
    cfg = port_config(jregistry.get_smoke_config("internlm2-1.8b"))
    dc = tpipeline.DataConfig(global_batch=3, seq_len=32, seed=4)
    pipe = tpipeline.Pipeline(cfg, dc, device="cpu")
    b0 = pipe.batch(0)
    assert set(b0) == {"tokens", "labels"}
    assert b0["tokens"].shape == b0["labels"].shape == (3, 32)
    assert b0["tokens"].dtype == b0["labels"].dtype == torch.int32
    assert torch.equal(b0["labels"][:, :-1], b0["tokens"][:, 1:])
    assert bool((b0["labels"][:, -1] == -100).all())
    assert int(b0["tokens"].min()) >= 0 and int(b0["tokens"].max()) < cfg.vocab
    # a pure function of (seed, step), as the JAX stream is
    again = tpipeline.Pipeline(cfg, dc, device="cpu")
    assert torch.equal(again.batch(0)["tokens"], b0["tokens"])
    assert not torch.equal(pipe.batch(1)["tokens"], b0["tokens"])
    other = tpipeline.Pipeline(cfg, tpipeline.DataConfig(3, 32, seed=5),
                               device="cpu")
    assert not torch.equal(other.batch(0)["tokens"], b0["tokens"])
    it = iter(pipe)
    assert torch.equal(next(it)["tokens"], b0["tokens"])
    jb = jpipeline.Pipeline(jregistry.get_smoke_config("internlm2-1.8b"),
                            jpipeline.DataConfig(3, 32, seed=4)).batch(0)
    assert {k: v.shape for k, v in jb.items()} == {
        k: tuple(v.shape) for k, v in b0.items()}


def test_synth_tokens_have_the_zipf_and_copy_statistics():
    """The JAX package's distribution: unigram frequencies of a Zipf law
    (alpha 1.1) and, with copy_frac 0.5, a token equal to the one 8 back
    at a quarter of the positions (plus chance repeats).  Held against
    JAX's own stream at the same sizes, within sampling error."""
    vocab, batch, seq = 64, 64, 512
    dc = tpipeline.DataConfig(global_batch=batch, seq_len=seq)
    got = tpipeline.synth_tokens(torch.Generator().manual_seed(0), batch, seq,
                                 vocab, dc).numpy()
    want = np.asarray(jpipeline.synth_tokens(
        jax.random.PRNGKey(0), batch, seq, vocab,
        jpipeline.DataConfig(global_batch=batch, seq_len=seq)))
    n = got.size
    p = np.exp(-1.1 * np.log(np.arange(1, vocab + 1)))
    p /= p.sum()
    for toks in (got, want):
        freq = np.bincount(toks.reshape(-1), minlength=vocab) / n
        # five standard errors of each of the ten likeliest tokens
        se = np.sqrt(p[:10] * (1 - p[:10]) / n)
        assert np.all(np.abs(freq[:10] - p[:10]) < 5 * se), freq[:10]
    copies = lambda t: float(np.mean(t == np.roll(t, 8, axis=1)))
    # a position equals the one 8 back where it copied and that one did
    # not (1/4), and by chance otherwise
    chance = float(np.sum(p ** 2))
    expect = 0.25 + 0.75 * chance
    assert abs(copies(got) - expect) < 0.01
    assert abs(copies(got) - copies(want)) < 0.02


@pytest.mark.parametrize("arch", ["hubert-xlarge", "phi-3-vision-4.2b"])
def test_pipeline_draws_the_frontend_batches(arch):
    """The audio and vision batches: the JAX stream's keys, shapes and
    dtypes, its label rule, and (seed, step) purity."""
    jcfg = jregistry.get_smoke_config(arch)
    cfg = port_config(jcfg)
    dc = tpipeline.DataConfig(global_batch=3, seq_len=32, seed=4)
    pipe = tpipeline.Pipeline(cfg, dc, device="cpu")
    b0 = pipe.batch(0)
    jb = jpipeline.Pipeline(jcfg, jpipeline.DataConfig(3, 32, seed=4)).batch(0)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in b0.items()} == {
        k: (v.shape, "bool" if v.dtype == bool else str(v.dtype))
        for k, v in jb.items()}
    if cfg.frontend.kind == "audio":
        assert set(b0) == {"frames", "mask", "labels"}
        assert bool((b0["labels"][~b0["mask"]] == -100).all())
        assert bool((b0["labels"][b0["mask"]] >= 0).all())
    else:
        assert set(b0) == {"tokens", "image_embeds", "labels"}
        assert b0["image_embeds"].shape == (3, cfg.frontend.max_prefix,
                                            cfg.frontend.d_in)
        assert torch.equal(b0["labels"][:, :-1], b0["tokens"][:, 1:])
        assert bool((b0["labels"][:, -1] == -100).all())
    again = tpipeline.Pipeline(cfg, dc, device="cpu").batch(0)
    one = pipe.batch(1)
    for k in b0:
        assert torch.equal(again[k], b0[k]), k
    assert not torch.equal(one["labels"], b0["labels"])


# ---- the restart drill -----------------------------------------------------------


def _lm_run(tmp_path, name, injector, steps=6):
    cfg = port_config(jregistry.get_smoke_config("gemma3-12b"))
    tc = tadamw.AdamWConfig(**OPT)
    pipe = tpipeline.Pipeline(cfg, tpipeline.DataConfig(4, 16, seed=2),
                              device="cpu")
    mgr = tckpt.CheckpointManager(str(tmp_path / name), every=2, keep=2,
                                  async_save=False)
    logs = []
    state, history = trunner.run_with_restarts(
        lambda: tstep.init_state(torch.Generator().manual_seed(0), cfg, tc,
                                 device="cpu"),
        tstep.make_train_step(cfg, tc, microbatch=2), pipe, num_steps=steps,
        manager=mgr, injector=injector, logger=logs.append)
    return state, history, logs


def test_injected_failure_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    clean, clean_hist, _ = _lm_run(tmp_path, "clean",
                                   trunner.FailureInjector())
    state, history, logs = _lm_run(
        tmp_path, "ft", trunner.FailureInjector(fail_at_steps=(5,)))
    assert any("injected failure at step 5" in l for l in logs)
    assert any("resumed from step 4" in l for l in logs)
    assert len(clean_hist) == 6 and len(history) == 2     # steps 4-5
    assert history == clean_hist[4:]
    assert int(state.step) == int(clean.step) == 6
    for got, want in zip(tckpt.tree_leaves(state), tckpt.tree_leaves(clean)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert clean_hist[-1]["loss"] < clean_hist[0]["loss"]
