"""The port's audio and vision frontends against the JAX package's.

hubert-xlarge's smoke config (audio frames through a projection, a mask
embedding at masked frames, an encoder-only bidirectional stack) and
phi-3-vision-4.2b's (image patch embeddings projected and put before the
unscaled text tokens).  Parameters come from the JAX package's
`init_model`, every all-zero leaf perturbed, carried across as numpy
arrays; frames, masks, patches, tokens and labels are numpy arrays made
from a seed.  Tolerances:

- logits: rtol 1e-4 / atol 1e-5 (float32 sums in another order than
  XLA's; measured: under 3.2e-6 on logits up to 4.5);
- `loss_fn`: rtol 1e-6, as `tests/test_torch_train_lm.py` holds the
  token models';
- one training step: the loss and ``grad_norm`` within rtol 1e-5, every
  gradient within rtol 1e-4 / atol 1e-5 of the leaf's largest;
- `Pipeline`'s frontend batches: JAX's shapes, dtypes and label rule
  exactly, the audio mask rate within 0.01 of 0.08 over 8,192 frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jregistry
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.serve import lm_engine as jengine
from repro.train import step as jstep
from repro_torch.ckpt import manager as tckpt
from repro_torch.data import pipeline as tpipeline
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadamw
from repro_torch.serve import lm_engine as tengine
from repro_torch.train import step as tstep
from tests.test_torch_lm import _leaves, port_config
from tests.test_torch_lm_hybrid import perturbed

RTOL, ATOL = 1e-4, 1e-5
B, T = 2, 16
ARCHS = ("hubert-xlarge", "phi-3-vision-4.2b")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = jregistry.get_smoke_config(request.param)
    tcfg = port_config(jcfg)
    jp = perturbed(jax.jit(jlm.init_model, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    tp = tlm.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    return jcfg, tcfg, jp, tp


def _batch(jcfg, seed, masked=True):
    rng = np.random.default_rng(seed)
    fe = jcfg.frontend
    if fe.kind == "audio":
        mask = rng.random((B, T)) < 0.25
        units = rng.integers(0, jcfg.vocab, (B, T)).astype(np.int32)
        out = {"frames": rng.standard_normal((B, T, fe.d_in)).astype(
            np.float32), "labels": np.where(mask, units, -100).astype(
                np.int32)}
        if masked:
            out["mask"] = mask
        return out
    toks = rng.integers(0, jcfg.vocab, (B, T)).astype(np.int32)
    return {"tokens": toks,
            "image_embeds": rng.standard_normal(
                (B, fe.max_prefix, fe.d_in)).astype(np.float32),
            "labels": np.concatenate([toks[:, 1:],
                                      np.full((B, 1), -100, np.int32)], 1)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _inputs(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("masked", [True, False])
def test_forward_matches_jax(model, masked):
    jcfg, tcfg, jp, tp = model
    batch = _inputs(_batch(jcfg, 1, masked))
    want = jlm.forward(jp, batch, jcfg, mode="train", remat=False)["logits"]
    with torch.no_grad():
        got = tlm.forward(tp, _torch(batch), tcfg, mode="train",
                          remat=False)["logits"]
    prefix = jcfg.frontend.max_prefix if jcfg.frontend.kind == "vision" \
        else 0
    assert tuple(got.shape) == (B, T + prefix, jcfg.vocab)
    _close(got, want, "logits")


def test_frontend_leaves_are_jax_ones(model):
    jcfg, tcfg, jp, tp = model
    meta = tlm.init_model(None, tcfg, device="meta")
    want = {"embed", "frontend_proj", "groups", "final_norm", "lm_head"}
    if jcfg.frontend.kind == "audio":
        want.add("mask_embed")
    assert set(meta) == set(jp) == want
    assert tuple(meta["frontend_proj"].shape) == (jcfg.frontend.d_in,
                                                  jcfg.d_model)


def test_audio_mask_embeds_the_masked_frames():
    jcfg = jregistry.get_smoke_config("hubert-xlarge")
    tcfg = port_config(jcfg)
    tp = tlm.init_model(torch.Generator().manual_seed(0), tcfg, device="cpu")
    batch = _torch(_inputs(_batch(jcfg, 2)))
    x = tlm._embed(tp, batch, tcfg)
    mask = batch["mask"]
    assert torch.equal(x[mask], tp["mask_embed"].expand(int(mask.sum()), -1))
    assert torch.equal(x[~mask], (batch["frames"] @ tp["frontend_proj"])[
        ~mask])


def test_vision_tokens_are_not_scaled_after_the_image_prefix():
    """The JAX package scales token embeddings by sqrt(d) only without
    an image prefix, so decode steps (tokens alone) are scaled and the
    prefilled text is not."""
    jcfg = jregistry.get_smoke_config("phi-3-vision-4.2b")
    tcfg = port_config(jcfg)
    tp = tlm.init_model(torch.Generator().manual_seed(0), tcfg, device="cpu")
    batch = _torch(_inputs(_batch(jcfg, 3)))
    x = tlm._embed(tp, batch, tcfg)
    p = jcfg.frontend.max_prefix
    assert torch.equal(x[:, p:], tp["embed"][batch["tokens"].long()])
    alone = tlm._embed(tp, {"tokens": batch["tokens"]}, tcfg)
    assert torch.allclose(alone, x[:, p:] * jcfg.d_model ** 0.5)


def test_loss_fn_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    batch = _batch(jcfg, 4)
    want, wm = jstep.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                             jcfg, jstep.LOCAL, remat=False)
    got, gm = tstep.loss_fn(tp, _torch(batch), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6)
    assert set(gm) == set(wm) == {"ce_loss"}


def test_train_step_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    jc, tc = jadamw.AdamWConfig(**OPT), tadamw.AdamWConfig(**OPT)
    batch = _batch(jcfg, 5)
    jstate = jstep.TrainState(jp, jadamw.init(jc, jp), jnp.int32(0))
    _, jm = jax.jit(jstep.make_train_step(jcfg, jc))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate = tstep.TrainState(tp, tadamw.init(tc, tp),
                              torch.zeros((), dtype=torch.int32))
    tnew, tm = tstep.make_train_step(tcfg, tc)(tstate, _torch(batch))
    for name in ("loss", "ce_loss", "grad_norm"):
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]),
                                   rtol=1e-5, err_msg=name)
    jgrads = jax.grad(lambda p: jstep.loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, jstep.LOCAL,
        remat=False)[0])(jp)
    jgrads = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    tgrads = tstep.value_and_grad(tp, _torch(batch), tcfg)[2]
    paths = tckpt.tree_leaves(_paths(tp))
    assert set(paths) == set(jgrads)
    for path, g in zip(paths, tgrads):
        w = jgrads[path]
        tol = 1e-4 * np.abs(w) + 1e-5 * float(np.abs(w).max())
        assert np.all(np.abs(g.numpy() - w) <= tol), f"gradient {path}"
    assert float(tm["grad_norm"]) > 0
    assert not torch.equal(tnew.params["frontend_proj"], tp["frontend_proj"])


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _paths(v, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_paths(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
    return prefix


def test_vision_prompt_served_through_prefill_and_decode_like_jax():
    """A vision prompt goes through `make_prefill_step` with its image
    embeddings, then greedy `make_decode_step`s from cache_len = prefix +
    prompt, as the JAX package's step functions serve it."""
    jcfg = jregistry.get_smoke_config("phi-3-vision-4.2b")
    tcfg = port_config(jcfg)
    jp = perturbed(jlm.init_model(jax.random.PRNGKey(0), jcfg))
    tp = tlm.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    batch = _inputs(_batch(jcfg, 6))
    max_len, steps = jcfg.frontend.max_prefix + T + 8, 8
    jpre = jax.jit(jengine.make_prefill_step(jcfg, remat=False))
    jdec = jax.jit(jengine.make_decode_step(jcfg))
    jlog, jcache = jpre(jp, batch, jlm.init_cache(jcfg, B, max_len))
    tlog, tcache = tengine.make_prefill_step(tcfg)(
        tp, _torch(batch), tlm.init_cache(tcfg, B, max_len, device="cpu"))
    _close(tlog, jlog, "prefill logits")
    clen = jcfg.frontend.max_prefix + T
    tdec = tengine.make_decode_step(tcfg)
    for i in range(steps):
        jt = jnp.argmax(jlog, -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tlog, -1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jlog, jcache = jdec(jp, jcache, jt, jnp.int32(clen + i))
        with torch.no_grad():
            tlog, tcache = tdec(tp, tcache, tt, clen + i)
        _close(tlog, jlog, f"decode logits {i}")


def test_audio_pipeline_mask_rate_and_labels():
    cfg = port_config(jregistry.get_smoke_config("hubert-xlarge"))
    pipe = tpipeline.Pipeline(cfg, tpipeline.DataConfig(16, 512, seed=3),
                              device="cpu")
    b = pipe.batch(0)
    rate = float(b["mask"].float().mean())
    assert abs(rate - tpipeline.AUDIO_MASK_RATE) < 0.01, rate
    units = b["labels"][b["mask"]]
    assert int(units.min()) >= 0 and int(units.max()) < cfg.vocab
    assert bool((b["labels"][~b["mask"]] == -100).all())
    assert abs(float(b["frames"].mean())) < 0.01
    assert abs(float(b["frames"].std()) - 1.0) < 0.01
