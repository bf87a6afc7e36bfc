"""The port's training tier against the JAX package's: AdamW, the SNN
training step, checkpoints (in both directions) and the fault-tolerant
runner.

Weights and topology come from the JAX package's `init_snn` at
`smoke_config`, batches from `repro.data.pipeline.snn_batch`, gradients
and moments from a numpy seed; both packages get them as numpy arrays.
Tolerances, stated where they are used:

- `adamw.update` and `schedule`: within 1e-6 relative (both compute in
  float32; ``pow``, ``cos`` and the global norm's sum may round their
  last bit differently).  Parameters and moments are held element by
  element, with 1e-6 of the leaf's largest magnitude as the floor for
  elements near zero, where a cancelling sum carries its inputs' gaps
  unscaled (`_leaf_close`);
- training steps: step 1's loss and updated parameters within 1e-6
  relative, as above (AdamW's first step is a clipped sign of the
  gradient, so the gradients' summation-order gaps barely reach the
  parameters); later
  losses within rtol 1e-5 / atol 1e-6, the forward's tolerance
  (`tests/test_torch_snn.py`), as long as no spike flips between the
  packages - the network is chaotic, so a step whose raster differs is
  named and only the steps before it are held;
- checkpoints and restarts: bitwise.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import manager as jckpt
from repro.configs import paper_dynaps as jconfigs
from repro.data import pipeline as jpipeline
from repro.ft import runner as jrunner
from repro.models import snn as jsnn
from repro.optim import adamw as jadamw
from repro_torch.ckpt import manager as tckpt
from repro_torch.configs import paper_dynaps as tconfigs
from repro_torch.data.pipeline import SNNPipeline
from repro_torch.ft import runner as trunner
from repro_torch.models import snn as tsnn
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.optim import adamw as tadamw

NAMES = ("syn_w", "w_in", "w_out")
# the example's optimizer
OPT = dict(lr=5e-3, warmup_steps=2, total_steps=80, weight_decay=0.0)


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, port cfg, JAX params, JAX topology, port params, port
    topology) at smoke_config from one JAX `init_snn`."""
    jcfg, tcfg = jconfigs.smoke_config(), tconfigs.smoke_config()
    jp, jt = jsnn.init_snn(jax.random.PRNGKey(0), jcfg)
    tp, tt = tsnn.snn_params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()},
        {k: np.asarray(v) for k, v in jt.items()}, device="cpu")
    return jcfg, tcfg, jp, jt, tp, tt


def _tree(rng, shapes, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def _f32(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _leaf_close(got, want, what):
    """Within 1e-6 relative, relative to the leaf's largest magnitude
    where an element is near zero: a value that cancels (``m b1 + g (1 -
    b1)``, ``p - lr delta``) carries its inputs' float32 gaps unscaled."""
    want = _f32(want)
    _close(got, want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()),
           what=what)


# ---- AdamW --------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 2, 9, 10, 11, 40, 99, 100, 101, 250])
def test_schedule_matches_jax(step):
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1), OPT, dict()):
        jc, tc = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
        want = jadamw.schedule(jc, jnp.int32(step))
        got = tadamw.schedule(tc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.ndim == 0
        _close(got, want, rtol=1e-6, what=f"{kw} step {step}")
    # warmup, the cosine's middle and its end, as the JAX tests state them
    tc = tadamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    for s, lr in ((5, 0.5), (10, 1.0), (55, 0.55), (100, 0.1), (400, 0.1)):
        assert float(tadamw.schedule(tc, torch.tensor(s))) == pytest.approx(
            lr, rel=1e-6)


@pytest.mark.parametrize("prior_step", [0, 1, 57])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay,grad_scale", [(0.0, 1.0), (0.1, 1.0),
                                                     (0.1, 1e-3)])
def test_adamw_update_matches_jax(model, moment_dtype, prior_step,
                                  weight_decay, grad_scale):
    """One update on the SNN parameter tree from moments at a prior step;
    grad_scale 1 clips (global norm > 1), 1e-3 does not."""
    _, _, jp, _, tp, _ = model
    kw = dict(OPT, weight_decay=weight_decay, moment_dtype=moment_dtype)
    jc, tc = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    rng = np.random.default_rng(prior_step)
    shapes = {k: v.shape for k, v in jp.items()}
    grads = _tree(rng, shapes, grad_scale)
    mu, nu = _tree(rng, shapes, 0.01), _tree(rng, shapes, 0.01)
    nu = {k: np.abs(v) for k, v in nu.items()}
    if prior_step == 0:
        mu = {k: np.zeros_like(v) for k, v in mu.items()}
        nu = {k: np.zeros_like(v) for k, v in nu.items()}
    jdt = jnp.dtype(moment_dtype)
    jstate = jadamw.AdamWState(
        step=jnp.int32(prior_step),
        mu={k: jnp.asarray(v).astype(jdt) for k, v in mu.items()},
        nu={k: jnp.asarray(v).astype(jdt) for k, v in nu.items()})
    tdt = getattr(torch, moment_dtype)
    tstate = tadamw.AdamWState(
        step=torch.tensor(prior_step, dtype=torch.int32),
        mu={k: torch.from_numpy(v).to(tdt) for k, v in mu.items()},
        nu={k: torch.from_numpy(v).to(tdt) for k, v in nu.items()})
    for k in NAMES:     # the same rounded moments go in
        np.testing.assert_array_equal(_f32(tstate.mu[k]), _f32(jstate.mu[k]))
    jnew, jst, jm = jadamw.update(jc, {k: jnp.asarray(v)
                                       for k, v in grads.items()},
                                  jstate, jp)
    tnew, tst, tm = tadamw.update(tc, {k: torch.from_numpy(v)
                                       for k, v in grads.items()}, tstate, tp)
    assert int(tst.step) == int(jst.step) == prior_step + 1
    assert tst.step.dtype == torch.int32
    for name in ("grad_norm", "lr"):
        _close(tm[name], jm[name], rtol=1e-6, what=name)
    for k in NAMES:
        assert tnew[k].dtype == torch.float32 and not tnew[k].requires_grad
        assert tst.mu[k].dtype == tdt and tst.nu[k].dtype == tdt
        _leaf_close(tnew[k], jnew[k], f"params {k}")
        _leaf_close(tst.mu[k], jst.mu[k], f"mu {k}")
        _leaf_close(tst.nu[k], jst.nu[k], f"nu {k}")
    # the parameters moved
    assert not np.array_equal(_f32(tnew["syn_w"]), _f32(tp["syn_w"]))


def test_adamw_init_global_norm_and_decay_rule(model):
    _, _, jp, _, tp, _ = model
    for dtype in ("float32", "bfloat16"):
        st = tadamw.init(tadamw.AdamWConfig(moment_dtype=dtype), tp)
        jst = jadamw.init(jadamw.AdamWConfig(moment_dtype=dtype), jp)
        assert int(st.step) == 0 and st.step.dtype == torch.int32
        for k in NAMES:
            assert st.mu[k].dtype == getattr(torch, dtype)
            assert st.mu[k].shape == tuple(jst.mu[k].shape)
            assert not bool(st.mu[k].any()) and not bool(st.nu[k].any())
            assert st.mu[k].data_ptr() != st.nu[k].data_ptr()
    _close(tadamw.global_norm(tp), jadamw.global_norm(jp), rtol=1e-6)
    # decay touches matrices only: a zero gradient moves a matrix, not a
    # vector
    params = {"m": torch.ones((2, 2)), "v": torch.ones(3)}
    cfg = tadamw.AdamWConfig(lr=1.0, warmup_steps=0, weight_decay=0.5)
    new, _, _ = tadamw.update(cfg, {k: torch.zeros_like(v)
                                    for k, v in params.items()},
                              tadamw.init(cfg, params), params)
    assert torch.equal(new["v"], params["v"])
    assert bool((new["m"] < 1).all())


# ---- training steps -------------------------------------------------------------


def _jax_step(jcfg, jt, opt_cfg):
    loss_g = jax.jit(jax.value_and_grad(
        lambda p, b: jsnn.snn_loss(p, jt, b, jcfg)))

    def step(state, batch):
        params, opt = state
        loss, grads = loss_g(params, batch)
        params, opt, _ = jadamw.update(opt_cfg, grads, opt, params)
        return (params, opt), loss
    return step


def _jax_batches(jcfg, count, seed=1):
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(count):
        key, sub = jax.random.split(key)
        out.append(jpipeline.snn_batch(sub, 32, jcfg.t_steps, jcfg.d_in,
                                       jcfg.d_out))
    return out


def _to_port(batch):
    return {"x": torch.from_numpy(np.array(batch["x"])),
            "y": torch.from_numpy(np.asarray(batch["y"]).astype(np.int64))}


def _rasters(jp, jt, jcfg, tp, tt, tcfg, x):
    want = jsnn.snn_forward(jp, jt, jnp.asarray(x), jcfg)[1]
    with torch.no_grad():
        got = tsnn.snn_forward(tp, tt, torch.from_numpy(x), tcfg)[1]
    return np.array_equal(got.numpy(), np.asarray(want))


def _hold_steps(model, jstate, tstate, batches, first):
    """Step both packages through ``batches``; return the index of the
    first step whose input raster flips a spike between them (None if
    none).  Step ``first`` (the first of a fresh optimizer) is held to
    1e-6 relative, later steps' losses to rtol 1e-5 / atol 1e-6."""
    jcfg, tcfg, _, jt, _, tt = model
    jc, tc = jadamw.AdamWConfig(**OPT), tadamw.AdamWConfig(**OPT)
    jstep = _jax_step(jcfg, jt, jc)
    tstep = functools.partial(tsnn.train_step, topology=tt, cfg=tcfg,
                              opt_cfg=tc)
    for i, batch in enumerate(batches):
        x = np.array(batch["x"])
        if not _rasters(jstate[0], jt, jcfg, tstate[0], tt, tcfg, x):
            return i
        jstate, jloss = jstep(jstate, batch)
        tstate, tm = tstep(tstate, _to_port(batch))
        if i == first:
            _close(tm["loss"], jloss, rtol=1e-6, what=f"step {i} loss")
            for k in NAMES:
                _leaf_close(tstate[0][k], jstate[0][k],
                            f"step {i} params {k}")
        else:
            _close(tm["loss"], jloss, rtol=1e-5, atol=1e-6,
                   what=f"step {i} loss")
        assert int(tstate[1].step) == int(jstate[1].step)
    return None


def test_three_training_steps_match_jax(model):
    jcfg, _, jp, _, tp, _ = model
    jc, tc = jadamw.AdamWConfig(**OPT), tadamw.AdamWConfig(**OPT)
    flipped = _hold_steps(model, (jp, jadamw.init(jc, jp)),
                          (tp, tadamw.init(tc, tp)), _jax_batches(jcfg, 3),
                          first=0)
    # at smoke_config no spike flips in these three steps; if one ever
    # does, the steps before it were held and this names the step
    assert flipped is None, f"a spike flips at step {flipped}"


def test_train_step_leaves_its_inputs_and_counts_steps(model):
    _, tcfg, _, _, tp, tt = model
    tc = tadamw.AdamWConfig(**OPT)
    state = (tp, tadamw.init(tc, tp))
    before = {k: v.clone() for k, v in tp.items()}
    batch = SNNPipeline(tcfg, 8, seed=3, device="cpu").batch(0)
    (params, opt), metrics = tsnn.train_step(state, batch, tt, tcfg, tc)
    assert set(metrics) == {"loss", "grad_norm", "lr"}
    assert all(m.ndim == 0 for m in metrics.values())
    for k in NAMES:
        assert torch.equal(tp[k], before[k])
        assert not tp[k].requires_grad and not params[k].requires_grad
    assert int(opt.step) == 1
    # the same state and batch give the same bits
    again = tsnn.train_step(state, batch, tt, tcfg, tc)
    for k in NAMES:
        assert torch.equal(again[0][0][k], params[k])


def test_snn_pipeline_regenerates_steps():
    cfg = tconfigs.smoke_config()
    a, b = (SNNPipeline(cfg, 4, seed=1, device="cpu"),
            SNNPipeline(cfg, 4, seed=1, device="cpu"))
    for step in (0, 5, 5, 2**40 + 7):
        x, y = a.batch(step), b.batch(step)
        assert torch.equal(x["x"], y["x"]) and torch.equal(x["y"], y["y"])
        assert x["x"].shape == (4, cfg.t_steps, cfg.d_in)
    assert not torch.equal(a.batch(0)["x"], a.batch(1)["x"])
    assert not torch.equal(a.batch(0)["x"],
                           SNNPipeline(cfg, 4, seed=2, device="cpu")
                           .batch(0)["x"])


# ---- checkpoints ----------------------------------------------------------------


def test_jax_checkpoint_restores_into_the_port_and_training_continues(
        model, tmp_path):
    jcfg, tcfg, jp, jt, tp, _ = model
    jc, tc = jadamw.AdamWConfig(**OPT), tadamw.AdamWConfig(**OPT)
    batches = _jax_batches(jcfg, 3)
    jstate = (jp, jadamw.init(jc, jp))
    jstep = _jax_step(jcfg, jt, jc)
    for batch in batches[:2]:
        jstate, _ = jstep(jstate, batch)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, jstate, step=2, extra={"data_step": 2})
    template = (tp, tadamw.init(tc, tp))
    restored = tckpt.restore(path, template, device="cpu")
    assert isinstance(restored[1], tadamw.AdamWState)
    for got, want in zip(tckpt.tree_leaves(restored),
                         jax.tree_util.tree_leaves(jstate)):
        assert torch.is_tensor(got)
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tckpt.load_meta(path)["extra"] == {"data_step": 2}
    # the next step continues as the JAX package's does
    flipped = _hold_steps(model, jstate, restored, batches[2:], first=None)
    assert flipped is None, f"a spike flips at step {flipped}"
    # and the port's checkpoint of the same state restores into JAX
    port_path = str(tmp_path / "port.npz")
    tckpt.save(port_path, restored, step=2, extra={"data_step": 2})
    back = jckpt.restore(port_path, jstate)
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    port_meta, jax_meta = (tckpt.load_meta(port_path),
                           jckpt.load_meta(path))
    assert port_meta.keys() == jax_meta.keys()
    assert port_meta["treedef"] == jax_meta["treedef"]
    assert port_meta["num_leaves"] == jax_meta["num_leaves"] == 10


def test_bfloat16_moments_keep_the_jax_bytes(model, tmp_path):
    """numpy has no bfloat16: both packages write the raw 2-byte
    patterns (``|V2``); the port reads them back as bfloat16."""
    _, _, jp, _, tp, _ = model
    kw = dict(OPT, moment_dtype="bfloat16")
    rng = np.random.default_rng(0)
    grads = _tree(rng, {k: v.shape for k, v in jp.items()})
    jstate = jadamw.update(jadamw.AdamWConfig(**kw), {
        k: jnp.asarray(v) for k, v in grads.items()},
        jadamw.init(jadamw.AdamWConfig(**kw), jp), jp)[1]
    path = str(tmp_path / "bf16.npz")
    jckpt.save(path, jstate, step=1)
    template = tadamw.init(tadamw.AdamWConfig(**kw), tp)
    got = tckpt.restore(path, template, device="cpu")
    for k in NAMES:
        assert got.mu[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(got.mu[k]), _f32(jstate.mu[k]))
        np.testing.assert_array_equal(_f32(got.nu[k]), _f32(jstate.nu[k]))
    port_path = str(tmp_path / "port_bf16.npz")
    tckpt.save(port_path, got, step=1)
    with np.load(path) as a, np.load(port_path) as b:
        assert a.files == b.files
        for f in a.files:
            assert a[f].dtype == b[f].dtype
            assert a[f].tobytes() == b[f].tobytes(), f
    again = tckpt.restore(port_path, template, device="cpu")
    for x, y in zip(tckpt.tree_leaves(again), tckpt.tree_leaves(got)):
        assert torch.equal(x, y)


def test_port_checkpoint_roundtrip_and_keep_k(tmp_path):
    tree = ({"b": torch.arange(4.0), "a": torch.ones((2, 3)),
             "i": torch.tensor([1, 2], dtype=torch.int32)},
            tadamw.AdamWState(step=torch.tensor(3, dtype=torch.int32),
                              mu={"w": torch.full((2,), 0.5)},
                              nu={"w": torch.full((2,), 0.25)}),
            None, [torch.zeros(1)])
    path = str(tmp_path / "sub" / "c.npz")
    tckpt.save(path, tree, step=7, extra={"data_step": 7})
    assert not any(f.endswith(".tmp") or ".tmp." in f
                   for f in os.listdir(tmp_path / "sub"))
    with np.load(path) as z:   # JAX's flatten order: keys sorted
        assert z.files == [f"leaf_{i}" for i in range(7)]
        np.testing.assert_array_equal(z["leaf_0"], np.ones((2, 3)))
        np.testing.assert_array_equal(z["leaf_1"], np.arange(4.0))
    back = tckpt.restore(path, tree, device="cpu")
    assert back[2] is None and list(back[0]) == ["b", "a", "i"]
    for got, want in zip(tckpt.tree_leaves(back), tckpt.tree_leaves(tree)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    meta = tckpt.load_meta(path)
    assert meta["step"] == 7 and meta["num_leaves"] == 7
    assert meta["treedef"] == str(jax.tree_util.tree_structure(
        jax.tree.map(np.asarray, ({"b": 0, "a": 0, "i": 0},
                                  jadamw.AdamWState(0, {"w": 0}, {"w": 0}),
                                  None, [0]))))

    for async_save in (False, True):
        d = tmp_path / f"mgr{async_save}"
        mgr = tckpt.CheckpointManager(str(d), every=1, keep=2,
                                      async_save=async_save)
        w = {"w": torch.arange(4.0)}
        assert mgr.restore_latest(w, device="cpu") == (None, None)
        assert not mgr.maybe_save(0, w)
        for s in (1, 2, 3, 4):
            w["w"] += 1.0                  # in place after the save call
            assert mgr.maybe_save(s, {"w": w["w"] * s})
        mgr.wait()
        assert mgr.latest_step() == 4
        files = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
        assert files == ["ckpt_00000003.npz", "ckpt_00000004.npz"]
        back, meta = mgr.restore_latest(w, device="cpu")
        assert meta["step"] == 4
        assert torch.equal(back["w"], (torch.arange(4.0) + 4) * 4)


def test_restore_defaults_to_cuda_and_refuses_without_it(tmp_path,
                                                          monkeypatch):
    path = str(tmp_path / "c.npz")
    tree = {"w": torch.ones(2)}
    tckpt.save(path, tree, step=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tckpt.restore(path, tree)


# ---- fault tolerance ------------------------------------------------------------


def _snn_run(model, tmp_path, name, injector, steps=10):
    _, tcfg, _, _, tp, tt = model
    tc = tadamw.AdamWConfig(**OPT)
    step_fn = functools.partial(tsnn.train_step, topology=tt, cfg=tcfg,
                                opt_cfg=tc)
    pipe = SNNPipeline(tcfg, 8, seed=1, device="cpu")
    mgr = tckpt.CheckpointManager(str(tmp_path / name), every=2, keep=5,
                                  async_save=False)
    logs = []
    state, history = trunner.run_with_restarts(
        lambda: (tp, tadamw.init(tc, tp)), step_fn, pipe, num_steps=steps,
        manager=mgr, injector=injector, logger=logs.append)
    return state, history, logs


def test_injected_failure_resume_is_bitwise_the_uninterrupted_run(
        model, tmp_path):
    _, tcfg, _, _, tp, tt = model
    tc = tadamw.AdamWConfig(**OPT)
    pipe = SNNPipeline(tcfg, 8, seed=1, device="cpu")
    ref = (tp, tadamw.init(tc, tp))
    for i in range(10):
        ref, _ = tsnn.train_step(ref, pipe.batch(i), tt, tcfg, tc)

    registry = MetricsRegistry()
    injector = trunner.FailureInjector(fail_at_steps=(7,), registry=registry)
    state, history, logs = _snn_run(model, tmp_path, "ft", injector)
    assert any("injected failure at step 7" in l for l in logs)
    assert any("resumed from step 6" in l for l in logs)
    assert registry.counters["ft.injected_failures"].value == 1
    assert len(history) == 4          # steps 6-9 after the resume
    for got, want in zip(tckpt.tree_leaves(state), tckpt.tree_leaves(ref)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    clean, _, _ = _snn_run(model, tmp_path, "clean",
                           trunner.FailureInjector())
    for got, want in zip(tckpt.tree_leaves(clean), tckpt.tree_leaves(ref)):
        assert torch.equal(got, want)


def test_failure_injector_counts_like_jax():
    for mod in (jrunner, trunner):
        registry = (MetricsRegistry() if mod is trunner
                    else __import__("repro.obs.metrics", fromlist=["x"])
                    .MetricsRegistry())
        inj = mod.FailureInjector(fail_at_steps=(2, 5), registry=registry,
                                  prefix="train")
        for step in range(7):
            if step in (2, 5):
                with pytest.raises(RuntimeError,
                                   match=f"injected failure at step {step}"):
                    inj.check(step)
            inj.check(step)           # fires once per step
        assert registry.counters["train.injected_failures"].value == 2
    trunner.FailureInjector(fail_at_steps=(1,)).check(0)   # no registry
    with pytest.raises(RuntimeError):
        trunner.FailureInjector(fail_at_steps=(1,)).check(1)


def test_run_with_restarts_gives_up_after_max_restarts(model, tmp_path):
    class Always:
        def check(self, step):
            raise RuntimeError("device lost")
    with pytest.raises(RuntimeError, match="device lost"):
        _, tcfg, _, _, tp, tt = model
        tc = tadamw.AdamWConfig(**OPT)
        trunner.run_with_restarts(
            lambda: (tp, tadamw.init(tc, tp)),
            functools.partial(tsnn.train_step, topology=tt, cfg=tcfg,
                              opt_cfg=tc),
            SNNPipeline(tcfg, 4, device="cpu"), num_steps=3,
            manager=tckpt.CheckpointManager(str(tmp_path), async_save=False),
            injector=Always(), max_restarts=2, logger=lambda *a: None)


@pytest.mark.parametrize("dtype", ["float16", "int16", "float32"])
def test_bfloat16_template_refuses_other_leaf_formats(tmp_path, dtype):
    """A bfloat16 leaf is read only from the ``|V2`` bytes both packages
    write; any other stored dtype is refused, not converted."""
    path = str(tmp_path / "other.npz")
    tckpt.save(path, {"w": torch.zeros(3, dtype=getattr(torch, dtype))},
               step=0)
    with pytest.raises(ValueError, match="as bfloat16"):
        tckpt.restore(path, {"w": torch.zeros(3, dtype=torch.bfloat16)},
                      device="cpu")
