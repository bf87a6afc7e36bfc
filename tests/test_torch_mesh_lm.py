"""The port's LM paths on a mesh of gloo CPU ranks.

`ShardCtx(enabled=True)` on a `DeviceMesh`: parameters, batches and
caches are DTensors placed by the port's specs, and the JAX package's
``shard_map`` bodies run as ``local_map`` regions.

* The JAX package's three mesh tests (`tests/test_distributed.py`), at
  its 2 x 4 mesh (8 ranks), against the JAX package's single-device
  results and with its tolerances: the dense sharded train loss (1e-3),
  sequence-parallel attention logits (1e-3) and the sequence-sharded
  decode (1e-4).  Each rank's parameter blocks have the shapes their
  specs give.
* On a 2 x 2 mesh (4 ranks), with float32 parameters drawn by the
  port's `init_model` and given to both packages as numpy, against the
  JAX package's single device: prefill + 4 greedy decode steps of the
  smoke configs of the dense, RWKV, hybrid, MLA + MoE (also with int8
  experts) and vision families (tokens equal, logits within rtol 1e-4
  / atol 1e-5 as `tests/test_torch_lm.py` holds the port's one device,
  routes exact) and hubert's encoder forward (the same).  The MoE
  routes each data shard on its own, as the JAX package's
  expert-parallel layer does, so the single-device runs are taken per
  data shard, and each rank's routes must equal its shard's.  The same
  runs also hold within 1e-5 of the port's own single device.
* Gradients of the loss on the 2 x 2 mesh against `jax.value_and_grad`
  of the JAX loss, for the MLA + MoE, RWKV, hybrid (Mamba + MoE) and
  audio families and internlm2 (per data shard, averaged, where a MoE
  routes): the loss within 1e-5, each gradient within 1e-4 of each
  element plus 1e-5 of its leaf's largest (as
  `tests/test_torch_train_lm.py` holds the port's one device).  One
  sharded train step of internlm2 against the JAX step: loss, ``lr``
  and each updated parameter within 1e-5; gradients and AdamW's
  moments in the parameters' placements.

One spawn per mesh, module-scoped; the JAX references of the 2 x 2
spawn are computed while it runs; the asserts read its results.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jregistry
from repro.core import event_router as jrouter
from repro.data.pipeline import DataConfig, Pipeline
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models.config import ModelConfig
from repro.optim import adamw as jadamw
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.serve import lm_engine as jengine
from repro.train import step as jstep
from repro_torch import configs as tregistry
from repro_torch.launch.spawn import spawn
from repro_torch.models import lm as tlm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import map_with_path
import torch_mesh_ranks as ranks
from tests.test_torch_lm import port_config

TRAIN_TOL, SP_TOL, DECODE_TOL = 1e-3, 1e-3, 1e-4
PORT_TOL = 1e-5
# against the JAX package's one device, as the port's one device is held
# to it: logits (`tests/test_torch_lm.py`), gradients of the leaf's
# largest (`tests/test_torch_train_lm.py`)
JAX_RTOL, JAX_ATOL = 1e-4, 1e-5
# qwen3-32b+kv1: one kv head, which the model axis does not divide, so
# q stays split by head (`blocks._flat_heads`), with its qk-norm
GRAD_ARCHS = ("deepseek-v2-lite-16b", "rwkv6-3b", "jamba-1.5-large-398b",
              "hubert-xlarge", "internlm2-1.8b", "qwen3-32b+kv1")
TRAIN_ARCH = "internlm2-1.8b"
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
DATA = 2                          # the 2 x 2 mesh's data extent


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _by_path(tree):
    out = {}
    map_with_path(lambda p, x: out.__setitem__(p, np.asarray(x)), tree)
    return out


def _jax_cfg(arch):
    name, _, variant = arch.partition("+")
    cfg = dataclasses.replace(jregistry.get_smoke_config(name),
                              param_dtype="float32", compute_dtype="float32")
    if variant == "int8":        # int8 experts, dequantized at each use
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, quant_int8=True))
    if variant == "kv1":
        cfg = dataclasses.replace(cfg, n_kv_heads=1)
    return cfg


def _routes(cfg):
    return any(map(cfg.layer_is_moe, range(cfg.n_layers)))


def _shards(batch):
    n = next(iter(batch.values())).shape[0] // DATA
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            for i in range(DATA)]


def _inputs(cfg, seed, train=False):
    """A numpy batch of ranks.BATCH rows: tokens (and image embeddings),
    or an audio frontend's frames and mask; for training, labels too
    (the next token; the masked frames' targets)."""
    rng = np.random.default_rng(seed)
    b, t = ranks.BATCH, ranks.PROMPT
    if cfg.encoder_only:
        mask = rng.random((b, t)) < 0.2
        out = {"frames": rng.standard_normal(
            (b, t, cfg.frontend.d_in)).astype(np.float32), "mask": mask}
        if train:
            out["labels"] = np.where(mask, rng.integers(0, cfg.vocab, (b, t)),
                                     -100).astype(np.int32)
        return out
    toks = rng.integers(0, cfg.vocab, (b, t + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1]}
    if train:
        out["labels"] = toks[:, 1:]
    if cfg.frontend.kind == "vision":
        out["image_embeds"] = rng.standard_normal(
            (b, cfg.frontend.max_prefix, cfg.frontend.d_in)).astype(np.float32)
    return out


def _jax_serve(cfg, params, batch, log, snap=None):
    """Prefill + ranks.STEPS greedy decode steps on one device: (tokens,
    logits of every step), and with ``snap`` the cache by path after
    that many decode steps; each MoE call's routes appended to
    ``log``."""
    b = batch["tokens"].shape[0]
    prefix = cfg.frontend.max_prefix if "image_embeds" in batch else 0
    clen = prefix + ranks.PROMPT
    cache = jlm.init_cache(cfg, b, clen + ranks.STEPS + 4)
    inner = jrouter.hat_route

    def hat_route(*a, **k):
        r = inner(*a, **k)
        jax.debug.callback(lambda *f: log.append(tuple(map(np.asarray, f))),
                           r.expert_ids, r.event_slot, r.kept, ordered=True)
        return r
    jrouter.hat_route = hat_route
    try:
        logits, cache = jax.jit(jengine.make_prefill_step(cfg, remat=False))(
            params, batch, cache)
        decode = jax.jit(jengine.make_decode_step(cfg))
        toks, steps, state = [], [logits], None
        for i in range(ranks.STEPS):
            nxt = jnp.argmax(logits, -1).astype(jnp.int32)
            toks.append(nxt)
            logits, cache = decode(params, cache, nxt[:, None],
                                   jnp.int32(clen + i))
            steps.append(logits)
            if i + 1 == snap:
                state = _by_path(cache)
        jax.effects_barrier()
    finally:
        jrouter.hat_route = inner
    if snap is not None:
        return np.stack(toks, 1), np.stack(steps), state
    return np.stack(toks, 1), np.stack(steps)


def _jax_grads(cfg, params, batch):
    """(loss, gradients by path) of the JAX loss on one device; averaged
    over the data shards where a MoE routes each shard on its own."""
    vg = jax.jit(jax.value_and_grad(lambda p, b: jstep.loss_fn(
        p, b, cfg, jblocks.LOCAL, remat=False)[0]))
    parts = [vg(params, b) for b in (_shards(batch) if _routes(cfg)
                                     else [batch])]
    loss = sum(float(l) for l, _ in parts) / len(parts)
    grads = jax.tree.map(lambda *g: sum(g) / len(g), *[g for _, g in parts])
    return loss, _by_path(grads)


def _jax_refs(cases):
    """The JAX package's single-device results of the 2 x 2 cases."""
    serve, train = {}, {}
    for arch, (cfg, params, batch) in cases["serve"].items():
        if cfg.encoder_only:
            serve[arch] = {"logits": np.asarray(jlm.forward(
                params, batch, cfg, remat=False)["logits"])}
            continue
        parts, routes = [], []
        for b in _shards(batch):
            routes.append([])
            parts.append(_jax_serve(cfg, params, b, routes[-1]))
        serve[arch] = {"tokens": np.concatenate([p[0] for p in parts]),
                       "logits": np.concatenate([p[1] for p in parts], 1),
                       "routes": routes}
    for arch, (cfg, params, batch) in cases["train"].items():
        loss, grads = _jax_grads(cfg, params, batch)
        train[arch] = {"loss": loss, "grads": grads}
        if arch == TRAIN_ARCH:
            opt = JAdamWConfig(**OPT)
            state = jstep.TrainState(params, jadamw.init(opt, params),
                                     jnp.int32(0))
            new, m = jax.jit(jstep.make_train_step(cfg, opt))(state, batch)
            train[arch].update(step_loss=float(m["loss"]), lr=float(m["lr"]),
                               params=_by_path(new.params))
    return serve, train


@pytest.fixture(scope="module")
def jax_cases():
    """The JAX package's three mesh tests' inputs and single-device
    results (`tests/test_distributed.py`)."""
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                      n_heads=8, n_kv_heads=4, d_ff=128, vocab=128,
                      head_dim=8, param_dtype="float32",
                      compute_dtype="float32")
    opt = JAdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    batch = Pipeline(cfg, DataConfig(global_batch=8, seq_len=32,
                                     seed=0)).batch(0)
    state = jstep.init_state(jax.random.PRNGKey(0), cfg, opt)
    _, m = jax.jit(jstep.make_train_step(cfg, opt))(state, batch)
    train = (port_config(cfg), AdamWConfig(**dataclasses.asdict(opt)),
             _np_tree(state.params), _np_tree(batch))

    sp_cfg = ModelConfig(name="sp", family="dense", n_layers=2, d_model=48,
                         n_heads=6, n_kv_heads=2, d_ff=96, vocab=64,
                         head_dim=8, attn_shard="sequence",
                         param_dtype="float32", compute_dtype="float32")
    p = jlm.init_model(jax.random.PRNGKey(1), sp_cfg)
    toks = jax.random.randint(jax.random.PRNGKey(2), (2, 32), 0, 64)
    sp_ref = jlm.forward(p, {"tokens": toks}, sp_cfg, mode="train",
                         remat=False)["logits"]
    sp = (port_config(sp_cfg), _np_tree(p), np.asarray(toks, np.int32))

    b, s, kh, r, d = 2, 64, 2, 3, 16
    q = jax.random.normal(jax.random.PRNGKey(0), (b, 1, kh, r, d))
    k = jax.random.normal(jax.random.PRNGKey(1), (b, s, kh, d))
    v = jax.random.normal(jax.random.PRNGKey(2), (b, s, kh, d))
    dec_ref = jblocks.decode_attention(q, k, v, jnp.int32(50))
    dec = tuple(np.asarray(a) for a in (q, k, v)) + (50,)
    refs = {"train_loss": float(m["loss"]), "sp_logits": np.asarray(sp_ref),
            "decode": np.asarray(dec_ref)}
    return (train, sp, dec), refs


@pytest.fixture(scope="module")
def mesh_2x4(jax_cases):
    cases, refs = jax_cases
    return spawn(ranks.jax_mesh_tests, 8, args=cases, timeout=600), refs


@pytest.fixture(scope="module")
def mesh_2x2():
    """(each rank's results, the JAX references): the spawn runs while
    the test process computes the references."""
    cases = {"serve": {}, "train": {}}
    rank_args = {"serve": {}, "train": {}}
    for part, archs in (("serve", ranks.SERVE_ARCHS + ("hubert-xlarge",)),
                        ("train", GRAD_ARCHS)):
        for seed, arch in enumerate(archs):
            cfg = _jax_cfg(arch)
            tcfg = port_config(cfg)
            # the JAX tree's nesting and draws (`init_model` is ported),
            # made here in milliseconds; both packages get it as numpy
            p_np = jax.tree.map(lambda x: x.numpy(), tlm.init_model(
                torch.Generator().manual_seed(seed), tcfg, device="cpu"))
            batch = _inputs(cfg, 100 + seed, train=part == "train")
            cases[part][arch] = (cfg, jax.tree.map(jnp.asarray, p_np), batch)
            rank_args[part][arch] = (
                (tcfg, p_np, batch) if part == "serve" else
                (tcfg, AdamWConfig(**OPT) if arch == TRAIN_ARCH else None,
                 p_np, batch))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(spawn, ranks.lm_2x2, 4,
                              args=(rank_args["serve"], rank_args["train"]),
                              timeout=600)
        refs = _jax_refs(cases)
        return running.result(), refs


@pytest.mark.parametrize("case,tol", [("train_loss", TRAIN_TOL),
                                      ("sp_logits", SP_TOL),
                                      ("decode", DECODE_TOL)])
def test_jax_mesh_tests_on_the_port(mesh_2x4, case, tol):
    results, refs = mesh_2x4
    for rank, out in enumerate(results):
        gap = float(np.max(np.abs(np.asarray(out[case]) - refs[case])))
        print(f"rank {rank} {case}: gap {gap:.3e} (tolerance {tol:g})")
        assert gap < tol, (rank, case, gap)


def test_each_rank_holds_only_its_blocks(mesh_2x4):
    results, _ = mesh_2x4
    for rank, out in enumerate(results):
        sharded = 0
        for path, local, want in out["local_shapes"]:
            assert local == want, (rank, path, local, want)
            sharded += local != tuple(dict(
                (p, w) for p, _, w in out["local_shapes"])[path]) or 0
        # the embedding (vocab over model, d over data) is split 8 ways
        emb = next(r for r in out["local_shapes"] if r[0] == "embed")
        assert emb[1] == (128 // 4, 64 // 2)


@pytest.mark.parametrize("arch", ranks.SERVE_ARCHS)
def test_mesh_serve_matches_jax(mesh_2x2, arch):
    results, (want, _) = mesh_2x2
    want = want[arch]
    for rank, out in enumerate(results):
        got = out["serve"][arch]
        gap = float(np.abs(got["logits"] - want["logits"]).max())
        print(f"rank {rank} {arch}: logit gap to JAX {gap:.3e}")
        assert np.array_equal(got["tokens"], want["tokens"]), (rank, arch)
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   rtol=JAX_RTOL, atol=JAX_ATOL,
                                   err_msg=f"rank {rank} {arch}")
        # this rank's routes are its data shard's, call for call
        mine = want["routes"][got["data_rank"]]
        assert len(got["routes"]) == len(mine), (rank, arch)
        for call, (g, w) in enumerate(zip(got["routes"], mine)):
            for field, a, b in zip(("expert_ids", "event_slot", "kept"), g, w):
                assert np.array_equal(a, b), (rank, arch, call, field)


@pytest.mark.parametrize("arch", ranks.SERVE_ARCHS)
def test_mesh_serve_matches_the_single_device(mesh_2x2, arch):
    results, _ = mesh_2x2
    for rank, out in enumerate(results):
        got = out["serve"][arch]
        print(f"rank {rank} {arch}: logit gap {got['logit_gap']:.3e}, "
              f"calls {got['calls']}")
        assert got["tokens_equal"], (rank, arch)
        # ServeEngine(ctx=) on ranks.ENGINE_ARCHS
        assert got["engine_equal"] is not False, (rank, arch)
        assert got["logit_gap"] < PORT_TOL, (rank, arch, got["logit_gap"])
        assert got["routes_equal"], (rank, arch)


def test_mesh_moe_routes_on_every_rank(mesh_2x2):
    # each rank routes its own data shard once a MoE layer a forward
    # (prefill + 4 decode steps): B5's launches on the card
    results, _ = mesh_2x2
    cfg = tregistry.get_smoke_config("deepseek-v2-lite-16b")
    moe_layers = sum(map(cfg.layer_is_moe, range(cfg.n_layers)))
    for out in results:
        ref_calls, mesh_calls = out["serve"]["deepseek-v2-lite-16b"]["calls"]
        assert mesh_calls == moe_layers * (1 + ranks.STEPS)
        assert ref_calls == 2 * mesh_calls


def test_mesh_encoder_forward(mesh_2x2):
    results, (want, _) = mesh_2x2
    for out in results:
        got = out["serve"]["hubert-xlarge"]
        gap = float(np.abs(got["logits"]
                           - want["hubert-xlarge"]["logits"]).max())
        print(f"hubert-xlarge: gap to JAX {gap:.3e}, to the port's one "
              f"device {got['logit_gap']:.3e}")
        np.testing.assert_allclose(got["logits"],
                                   want["hubert-xlarge"]["logits"],
                                   rtol=JAX_RTOL, atol=JAX_ATOL)
        assert got["logit_gap"] < PORT_TOL


def _grad_gaps(got, want):
    """{path: largest gap relative to the leaf's largest value} and
    whether each leaf is within JAX_RTOL of each element plus JAX_ATOL
    of the leaf's largest."""
    assert set(got) == set(want)
    gaps, ok = {}, {}
    for path, w in want.items():
        d, top = np.abs(got[path] - w), float(np.abs(w).max())
        gaps[path] = float(d.max()) / max(top, 1e-30)
        ok[path] = bool(np.all(d <= JAX_RTOL * np.abs(w) + JAX_ATOL * top))
    return gaps, ok


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_mesh_gradients_match_jax(mesh_2x2, arch):
    """`value_and_grad` on the 2 x 2 mesh against JAX's on one device:
    the partial sums of row-parallel products, the MoE region's
    (1/(model x data) of each aux loss a rank) and the gradients of
    regions whose operands are replicated over ``model`` are all held
    here."""
    results, (_, want) = mesh_2x2
    want = want[arch]
    for rank, out in enumerate(results):
        got = out["train"][arch]
        gaps, ok = _grad_gaps(got["grads"], want["grads"])
        worst = max(gaps, key=gaps.get)
        print(f"rank {rank} {arch}: loss {got['loss']} vs {want['loss']}; "
              f"widest gradient gap {gaps[worst]:.3e} ({worst})")
        assert abs(got["loss"] - want["loss"]) < PORT_TOL, (rank, arch)
        assert all(ok.values()), (rank, arch, [p for p in ok if not ok[p]])
        assert got["grads_like_params"], (rank, arch)


def test_mesh_train_step_matches_the_single_device(mesh_2x2):
    """One sharded train step against the JAX step on one device: loss,
    ``lr`` and every updated parameter within 1e-5."""
    results, (_, want) = mesh_2x2
    want = want[TRAIN_ARCH]
    for rank, out in enumerate(results):
        got = out["train"][TRAIN_ARCH]
        gap = max(float(np.abs(got["params"][p] - w).max())
                  for p, w in want["params"].items())
        print(f"rank {rank}: loss {got['step_loss']} vs {want['step_loss']}, "
              f"parameter gap {gap:.3e}")
        assert set(got["params"]) == set(want["params"])
        assert abs(got["step_loss"] - want["step_loss"]) < PORT_TOL
        assert got["lr"] == want["lr"]
        assert gap < PORT_TOL, (rank, gap)
        assert got["moments_like_params"], rank
