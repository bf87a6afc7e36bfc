"""Rank bodies of the port's mesh tests (`tests/test_torch_mesh_*.py`,
`tests/test_torch_sharding.py`), run by `repro_torch.launch.spawn` on
gloo CPU ranks.

This module imports torch and the port only: every rank is a fresh
process, and the JAX references are computed in the test process.  Each
body takes numpy inputs and returns numpy results (or plain values).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _mesh_ctx(data, model, cfg=None):
    from repro_torch.launch import mesh as M
    from repro_torch.parallel import sharding as shd
    mesh = M.make_host_mesh(data, model, device="cpu")
    return mesh, shd.make_shard_ctx(mesh, cfg)


def _np(x):
    from repro_torch.parallel import regions as R
    return R.full(x).detach().float().numpy()


# ---- the JAX package's three mesh tests, at its 2 x 4 mesh ----------------


def jax_mesh_tests(rank, world, train, sp, dec):
    """``train``: (cfg, opt_cfg, params, batch); ``sp``: (cfg, params,
    tokens); ``dec``: (q, k, v, cache_len).  Returns the sharded train
    loss, the SP logits, the sequence-sharded decode output and each
    rank's local parameter shapes against their specs' shapes."""
    from repro_torch.models import blocks, lm
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import step as ts
    from repro_torch.optim import adamw
    out = {}
    cfg, opt_cfg, params_np, batch_np = train
    mesh, ctx = _mesh_ctx(2, 4, cfg)
    params = lm.lm_params_from_numpy(cfg, params_np, device="cpu")
    specs = shd.params_pspecs(params, cfg, ctx)
    sp_params = shd.shard_tree(params, specs, mesh)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    batch = shd.shard_tree(batch, shd.batch_pspecs(batch, cfg, ctx), mesh)
    state = ts.TrainState(params=sp_params, opt=adamw.init(opt_cfg, sp_params),
                          step=torch.zeros((), dtype=torch.int32))
    _, metrics = ts.make_train_step(cfg, opt_cfg, ctx=ctx)(state, batch)
    out["train_loss"] = float(_np(metrics["loss"]))
    out["local_shapes"] = _local_vs_spec(sp_params, specs, mesh)

    cfg, params_np, toks = sp
    _, ctx = _mesh_ctx(2, 4, cfg)
    params = lm.lm_params_from_numpy(cfg, params_np, device="cpu")
    sp_params = shd.shard_tree(params, shd.params_pspecs(params, cfg, ctx),
                               ctx.mesh)
    logits = lm.forward(sp_params, {"tokens": torch.from_numpy(toks)}, cfg,
                        mode="train", ctx=ctx, remat=False)["logits"]
    out["sp_logits"] = _np(logits)

    q, k, v, clen = dec
    ctx = dataclasses.replace(ctx, model_size=4)
    spec = ("data", "model", None, None)
    ks = shd.place(torch.from_numpy(k), spec, ctx.mesh)
    vs = shd.place(torch.from_numpy(v), spec, ctx.mesh)
    qs = shd.place(torch.from_numpy(q), ("data", None, None, None, None),
                   ctx.mesh)
    out["decode"] = _np(blocks.decode_attention(qs, ks, vs, clen, ctx=ctx))
    return out


def _local_vs_spec(tree, specs, mesh):
    """(path, local shape, the shape the spec gives) per leaf."""
    from repro_torch.parallel import sharding as shd
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    spec_of = {}
    shd.map_with_path(lambda p, s: spec_of.__setitem__(p, s), specs)
    rows = []

    def one(path, leaf):
        want = list(leaf.shape)
        for d, entry in enumerate(spec_of[path]):
            for a in shd._axes(entry):
                want[d] //= sizes[a]
        rows.append((path, tuple(leaf.to_local().shape), tuple(want)))
    shd.map_with_path(one, tree)
    return rows


# ---- the LM paths on a 2 x 2 mesh, against the port's single device ------


SERVE_ARCHS = ("internlm2-1.8b", "llama3.2-3b", "gemma3-12b", "rwkv6-3b",
               "jamba-1.5-large-398b", "deepseek-v2-lite-16b",
               "deepseek-v2-lite-16b+int8", "phi-3-vision-4.2b")
ENGINE_ARCHS = ("internlm2-1.8b", "deepseek-v2-lite-16b")
PROMPT, STEPS, BATCH = 16, 4, 4
SNAP = 2                          # decode steps before the cache is read


def _record_routes(log):
    """Wrap `blocks.route_tokens` so each call's routes land in ``log``."""
    from repro_torch.models import blocks
    inner = blocks.route_tokens

    def route_tokens(xf, router_w, cfg):
        r = inner(xf, router_w, cfg)
        log.append(tuple(np.asarray(getattr(r, f).detach().cpu())
                         for f in ("expert_ids", "event_slot", "kept")))
        return r
    blocks.route_tokens = route_tokens
    return inner


def _serve(cfg, params, batch, ctx=None, snap=None, keep=None, logs=None):
    """Prefill then STEPS greedy decode steps: (tokens, logits of every
    step), and with ``snap`` the cache's full values by path after that
    many decode steps; the cache appended to the list ``keep``; the
    prefill run under the context ``logs["prefill"]`` and each decode
    step under ``logs["decode"]``."""
    import contextlib
    from repro_torch.models import lm
    from repro_torch.models.blocks import LOCAL
    from repro_torch.parallel import regions as R, sharding as shd
    from repro_torch.serve.lm_engine import make_decode_step, make_prefill_step
    ctx = ctx or LOCAL
    logs = logs or {}
    b = batch["tokens"].shape[0]
    prefix = cfg.frontend.max_prefix if "image_embeds" in batch else 0
    cache = lm.init_cache(cfg, b, prefix + PROMPT + STEPS + 4, device="cpu")
    if ctx.enabled:
        cache = shd.shard_tree(cache, shd.cache_pspecs(cache, cfg, ctx),
                               ctx.mesh)
    if keep is not None:
        keep.append(cache)
    with logs.get("prefill", contextlib.nullcontext()):
        logits, _ = make_prefill_step(cfg, ctx)(params, batch, cache)
    decode = make_decode_step(cfg, ctx)
    toks, steps = [], [R.full(logits)]
    clen = prefix + PROMPT
    state = None
    for i in range(STEPS):
        nxt = R.full(logits).argmax(-1).to(torch.int32)
        toks.append(nxt)
        with logs.get("decode", contextlib.nullcontext()):
            logits, _ = decode(params, cache, nxt[:, None], clen + i)
        steps.append(R.full(logits))
        if i + 1 == snap:
            state = _by_path(cache)
    if snap is not None:
        return torch.stack(toks, 1), torch.stack(steps), state
    return torch.stack(toks, 1), torch.stack(steps)


def _per_shard(fn, batch, data):
    """``fn`` on each data shard's rows, concatenated: the single-device
    counterpart of a mesh run whose MoE routes each shard on its own."""
    n = next(iter(batch.values())).shape[0] // data
    parts = [fn({k: v[i * n:(i + 1) * n] for k, v in batch.items()})
             for i in range(data)]
    return [torch.cat([p[j] for p in parts], dim=0 if j == 0 else 1)
            for j in range(len(parts[0]))]


def _by_path(tree):
    """{path: full value as numpy} of a tree of (D)Tensors; every rank
    walks it in the same order, so the gathers pair up."""
    from repro_torch.parallel import sharding as shd
    out = {}
    shd.map_with_path(lambda p, x: out.__setitem__(p, _np(x)), tree)
    return out


def lm_mesh_2x2(rank, world, cases):
    """``cases``: {arch: (cfg, params, batch)}, numpy, float32.  For
    each, prefill + STEPS greedy decode steps on a 2 x 2 mesh (an
    encoder: its forward): the mesh's tokens, logits and this rank's
    routes (one per MoE call), which the test holds against the JAX
    package; and the same run on the port's single device (per data
    shard), held here."""
    from repro_torch.models import blocks, lm
    from repro_torch.parallel import sharding as shd
    out = {}
    for arch, (cfg, params_np, batch_np) in cases.items():
        params = lm.lm_params_from_numpy(cfg, params_np, device="cpu")
        mesh, ctx = _mesh_ctx(2, 2, cfg)
        sp = shd.shard_tree(params, shd.params_pspecs(params, cfg, ctx), mesh)
        batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
        if cfg.encoder_only:
            want = lm.forward(params, batch, cfg, remat=False)["logits"]
            got = _np(lm.forward(sp, batch, cfg, ctx=ctx,
                                 remat=False)["logits"])
            out[arch] = {"logits": got,
                         "logit_gap": float(np.abs(got - want.numpy()).max())}
            continue
        ref_routes, mesh_routes = [], []
        inner = _record_routes(ref_routes)
        want_toks, want_logits = _per_shard(
            lambda b: _serve(cfg, params, b), batch, 2)
        blocks.route_tokens = inner
        _record_routes(mesh_routes)
        got_toks, got_logits = _serve(cfg, sp, batch, ctx)
        blocks.route_tokens = inner
        # the user's entry point, ServeEngine over the mesh (one dense and
        # one MoE family: the loop is the same for all)
        engine_equal = None
        if arch in ENGINE_ARCHS:
            from repro_torch.serve.lm_engine import ServeEngine
            max_len = PROMPT + STEPS
            want_eng = _per_shard(lambda b: [ServeEngine(
                cfg, params, max_len=max_len).generate(b["tokens"], STEPS)],
                {"tokens": batch["tokens"]}, 2)[0]
            got_eng = ServeEngine(cfg, sp, max_len=max_len,
                                  ctx=ctx).generate(batch["tokens"], STEPS)
            engine_equal = bool(torch.equal(want_eng, got_eng))
        data_rank = mesh.get_local_rank("data")
        out[arch] = {
            "tokens": got_toks.numpy(), "logits": got_logits.numpy(),
            "routes": mesh_routes, "data_rank": data_rank,
            "tokens_equal": bool(torch.equal(want_toks, got_toks)),
            "engine_equal": engine_equal,
            "logit_gap": float((got_logits - want_logits).abs().max()),
            "calls": (len(ref_routes), len(mesh_routes)),
            # this rank's routes are those of its own data shard's reference
            "routes_equal": _routes_equal(ref_routes, mesh_routes,
                                          data_rank)}
    return out


def serve_one_sequence(rank, world, shape, cases):
    """``cases``: {arch: (cfg, params, batch)}, numpy, float32, a batch
    of one sequence.  On a mesh of ``shape`` ((data, model) or (pod,
    data, model)), the parameters placed by the port's specs (FSDP:
    split over the data axes), prefill + STEPS greedy decode steps with
    the batch whole over the data axes: the tokens, the logits, the
    plans the products took (`regions.product_plan`, by kind; a table
    lookup's as ``"lookup <kind>"``) and the same run on the port's
    single device, held here."""
    import collections
    from repro_torch.launch import mesh as M
    from repro_torch.models import lm
    from repro_torch.parallel import regions as R, sharding as shd
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    mesh = M.make_mesh(shape, axes, device="cpu")
    inner = R.product_plan
    out = {}
    for arch, (cfg, params_np, batch_np) in cases.items():
        ctx = shd.make_shard_ctx(mesh, cfg)
        params = lm.lm_params_from_numpy(cfg, params_np, device="cpu")
        sp = shd.shard_tree(params, shd.params_pspecs(params, cfg, ctx), mesh)
        batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
        want_toks, want_logits = _serve(cfg, params, batch)
        kinds = collections.Counter()

        def product_plan(x, w, lookup_dt=None):
            plan = inner(x, w, lookup_dt)
            if plan is not None:
                kinds[("lookup " if lookup_dt is not None else "")
                      + plan.kind] += 1
            return plan
        R.product_plan = product_plan
        try:
            got_toks, got_logits = _serve(cfg, sp, batch, ctx)
        finally:
            R.product_plan = inner
        out[arch] = {
            "tokens": got_toks.numpy(), "logits": got_logits.numpy(),
            "plans": dict(kinds),
            "tokens_equal": bool(torch.equal(want_toks, got_toks)),
            "logit_gap": float((got_logits - want_logits).abs().max())}
    return out


def _collective_log():
    """A dispatch mode that logs each functional collective (and the
    port's permute) a rank runs, one entry a result tensor: (op under
    the dry run's names, `repro_torch.launch.dryrun.COLLECTIVE_OPS`,
    result shape, group size of an all-gather or a reduce-scatter or
    None)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.launch import dryrun

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func._schema.name.split("::")[-1]
            if (func.namespace in dryrun.COLLECTIVE_NAMESPACES
                    and name in dryrun.COLLECTIVE_OPS):
                op = dryrun.COLLECTIVE_OPS[name]
                size = {"all-gather": 1, "reduce-scatter": 2}.get(op)
                size = args[size] if size is not None else None
                for t in (out if isinstance(out, (list, tuple)) else [out]):
                    self.calls.append((op, tuple(t.shape), size))
            return out

    return Log()


def serve_gspmd(rank, world, shape, cases):
    """``cases``: {name: (cfg, params, batch)}, numpy, float32.  On a
    mesh of ``shape`` ((data, model) or (pod, data, model)), the
    parameters placed by the port's specs (FSDP: split over the data
    axes), the batch split over the data axes: prefill + STEPS greedy
    decode steps (`_serve`), the cache read out whole after SNAP of
    them; the plans the products took (`regions.product_plan` by kind,
    a lookup's as ``"lookup <kind>"``), the functional collectives of
    the prefill and of the decode steps (op, result shape, group size),
    each time mix's choice of `rwkv6.own_heads` and the shapes of the
    weight blocks its products took as plain tensors;
    whether each cache leaf's block on this rank is its block of the
    leaf read out whole (`sharding.local_slice`); and the same run on
    the port's single device (per data shard where a MoE routes), held
    here."""
    import collections
    import math
    from repro_torch.launch import mesh as M
    from repro_torch.models import lm, rwkv6
    from repro_torch.parallel import regions as R, sharding as shd
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    mesh = M.make_mesh(shape, axes, device="cpu")
    data = math.prod(shape[:-1])
    inner = R.product_plan
    inner_heads, inner_linear = rwkv6.own_heads, rwkv6._linear
    out = {}
    for name, (cfg, params_np, batch_np) in cases.items():
        ctx = shd.make_shard_ctx(mesh, cfg)
        params = lm.lm_params_from_numpy(cfg, params_np, device="cpu")
        sp = shd.shard_tree(params, shd.params_pspecs(params, cfg, ctx), mesh)
        batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
        moe = any(map(cfg.layer_is_moe, range(cfg.n_layers)))
        want_toks, want_logits = (
            _per_shard(lambda b: _serve(cfg, params, b), batch, data)
            if moe else _serve(cfg, params, batch))
        kinds = collections.Counter()
        logs = {"prefill": _collective_log(), "decode": _collective_log()}

        def product_plan(x, w, lookup_dt=None):
            plan = inner(x, w, lookup_dt)
            if plan is not None:
                kinds[("lookup " if lookup_dt is not None else "")
                      + plan.kind] += 1
            return plan
        heads, products = [], collections.Counter()

        def own_heads(*args, **kw):
            heads.append(inner_heads(*args, **kw))
            return heads[-1]

        def linear(x, w, dt):
            # the time mix's products of a weight block the rank holds
            if type(w) is torch.Tensor and w.ndim == 2:
                products[tuple(w.shape)] += 1
            return inner_linear(x, w, dt)
        R.product_plan = product_plan
        rwkv6.own_heads, rwkv6._linear = own_heads, linear
        caches = []
        try:
            got_toks, got_logits, state = _serve(
                cfg, sp, batch, ctx, snap=SNAP, keep=caches, logs=logs)
        finally:
            R.product_plan = inner
            rwkv6.own_heads, rwkv6._linear = inner_heads, inner_linear
        blocks_equal = []
        shd.map_with_path(lambda p, leaf: blocks_equal.append(
            torch.equal(shd.local_slice(R.full(leaf), _spec_of(leaf, mesh),
                                        mesh), leaf.to_local())),
            caches[0])
        out[name] = {
            "tokens": got_toks.numpy(), "logits": got_logits.numpy(),
            "state": state, "plans": dict(kinds),
            "calls": {k: v.calls for k, v in logs.items()},
            "heads": heads, "products": dict(products),
            "blocks_equal": all(blocks_equal),
            "tokens_equal": bool(torch.equal(want_toks, got_toks)),
            "logit_gap": float((got_logits - want_logits).abs().max())}
    return out


def _spec_of(leaf, mesh):
    """The spec of a DTensor's placements on ``mesh`` (the axes that
    split each dim, major to minor)."""
    names = list(mesh.mesh_dim_names)
    spec = [[] for _ in range(leaf.ndim)]
    for name, p in zip(names, leaf.placements):
        if p.is_shard():
            spec[p.dim].append(name)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in spec)



def _routes_equal(ref, got, shard):
    """The mesh run's routes (one per MoE call on this rank) against the
    reference's calls on the same data shard (it ran shard 0's whole
    serve, then shard 1's)."""
    if not got:
        return True
    n = len(got)
    mine = ref[shard * n:(shard + 1) * n]
    return len(mine) == n and all(
        all(np.array_equal(a, b) for a, b in zip(x, y))
        for x, y in zip(mine, got))


def train_2x2(rank, world, cases):
    """``cases``: {arch: (cfg, AdamW config or None, params, batch)},
    numpy, float32.  For each, the loss and gradients of
    `value_and_grad` on a 2 x 2 mesh (full values by path) and whether
    each gradient has its parameter's placements; with an AdamW config,
    one sharded train step too: its loss, ``lr``, updated parameters and
    whether AdamW's moments have the parameters' placements.  The test
    holds them against the JAX package."""
    from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import step as ts
    out = {}
    for arch, (cfg, opt, params_np, batch_np) in cases.items():
        params = lm.lm_params_from_numpy(cfg, params_np, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
        mesh, ctx = _mesh_ctx(2, 2, cfg)
        sp = shd.shard_tree(params, shd.params_pspecs(params, cfg, ctx), mesh)
        sb = shd.shard_tree(batch, shd.batch_pspecs(batch, cfg, ctx), mesh)
        loss, _, grads = ts.value_and_grad(sp, sb, cfg, ctx)
        r = {"loss": float(_np(loss)),
             "grads": _by_path(tree_unflatten(sp, grads)),
             "grads_like_params": all(a.placements == p.placements
                                      for a, p in zip(grads, tree_leaves(sp)))}
        if opt is not None:
            state, m = ts.make_train_step(cfg, opt, ctx=ctx)(
                ts.TrainState(sp, adamw.init(opt, sp),
                              torch.zeros((), dtype=torch.int32)), sb)
            r.update(step_loss=float(_np(m["loss"])), lr=float(_np(m["lr"])),
                     params=_by_path(state.params),
                     moments_like_params=all(
                         a.placements == b.placements
                         for a, b in zip(tree_leaves(state.opt.mu),
                                         tree_leaves(state.params))))
        out[arch] = r
    return out


def train_microbatch_2x2(rank, world, cases):
    """``cases``: {arch: (cfg, AdamW config, microbatch, params, batch)},
    numpy, float32.  For each, on a 2 x 2 mesh: the loss and gradients
    of `microbatch_value_and_grad` (the step's split of the batch into
    microbatches, each placed as the batch was) by path, whether each
    gradient has its parameter's placements, and one train step in
    microbatches: its loss, ``grad_norm``, ``lr``, updated parameters and
    AdamW's first moments by path.  The test holds them against the JAX
    package."""
    from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import step as ts
    out = {}
    for arch, (cfg, opt, microbatch, params_np, batch_np) in cases.items():
        params = lm.lm_params_from_numpy(cfg, params_np, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
        mesh, ctx = _mesh_ctx(2, 2, cfg)
        sp = shd.shard_tree(params, shd.params_pspecs(params, cfg, ctx), mesh)
        sb = shd.shard_tree(batch, shd.batch_pspecs(batch, cfg, ctx), mesh)
        loss, _, grads = ts.microbatch_value_and_grad(sp, sb, cfg, ctx,
                                                      microbatch)
        state, m = ts.make_train_step(cfg, opt, ctx=ctx,
                                      microbatch=microbatch)(
            ts.TrainState(sp, adamw.init(opt, sp),
                          torch.zeros((), dtype=torch.int32)), sb)
        out[arch] = {
            "loss": float(_np(loss)),
            "grads": _by_path(tree_unflatten(sp, grads)),
            "grads_like_params": all(a.placements == p.placements
                                     for a, p in zip(grads, tree_leaves(sp))),
            "step_loss": float(_np(m["loss"])),
            "grad_norm": float(_np(m["grad_norm"])), "lr": float(_np(m["lr"])),
            "params": _by_path(state.params), "mu": _by_path(state.opt.mu)}
    return out


# ---- the recurrent mixers and MLA prefill, tensor-parallel ----------------


def _record_widths(log):
    """Wrap the calls inside the mixers so each logs the width it runs
    on a rank: Mamba's scan its d_inner channels, the WKV and attention
    their heads.  Returns a function that unwraps them."""
    from repro_torch.models import blocks, mamba, rwkv6
    saved = []

    def wrap(mod, name, tag, dim):
        inner = getattr(mod, name)
        saved.append((mod, name, inner))

        def run(a, *rest, **kw):
            log.append((tag, a.shape[dim]))
            return inner(a, *rest, **kw)
        setattr(mod, name, run)

    wrap(mamba, "_ssm_scan_chunked", "mamba_scan", -1)
    wrap(rwkv6, "wkv_chunked", "wkv", 2)
    wrap(rwkv6, "wkv_recurrent", "wkv", 2)
    wrap(blocks, "flash_attention", "attention", 2)

    def restore():
        for mod, name, inner in saved:
            setattr(mod, name, inner)
    return restore


def _is_mixer_weight(path, cfg):
    """A weight of a layer's mixer (Mamba, RWKV's time mix, attention,
    MLA) or of RWKV's channel mix."""
    return "/mix/" in path or ("/ffn/" in path and cfg.family == "rwkv")


def mixers_2x2(rank, world, serve, grad, staged):
    """On a 2 x 2 mesh, float32, numpy in and out.

    ``serve``: {name: (cfg, params, batch)}: prefill + STEPS greedy
    decode steps (tokens, logits, this rank's routes a MoE call, the
    cache after 2 decode steps) and the widths the mixers ran on
    (`_record_widths`).  ``grad``: {name: (cfg, params, batch)}:
    `value_and_grad` (loss, gradients by path) and whether each mixer
    weight's gradient has its parameter's placements.  ``staged``:
    {name: (cfg, params, batch)}: one forward under ``serve_tp_only``
    and one under FSDP x TP with the functional collectives staged
    through the host (`launch.staging`, here on the CPU), each
    all-gather's operand shape and whether it ran over the data axis,
    the block shapes a Mamba or channel-mix weight can take, and the
    staged calls and bytes by op."""
    from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
    from repro_torch.models import blocks, lm
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import step as ts
    out = {"serve": {}, "grad": {}, "staged": {}}
    for name, (cfg, params_np, batch_np) in serve.items():
        params = lm.lm_params_from_numpy(cfg, params_np, device="cpu")
        mesh, ctx = _mesh_ctx(2, 2, cfg)
        sp = shd.shard_tree(params, shd.params_pspecs(params, cfg, ctx), mesh)
        batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
        routes, widths = [], []
        inner = _record_routes(routes)
        restore = _record_widths(widths)
        try:
            toks, logits, state = _serve(cfg, sp, batch, ctx, snap=2)
        finally:
            blocks.route_tokens = inner
            restore()
        out["serve"][name] = {
            "tokens": toks.numpy(), "logits": logits.numpy(), "state": state,
            "routes": routes, "data_rank": mesh.get_local_rank("data"),
            "widths": sorted(set(widths))}
    for name, (cfg, params_np, batch_np) in grad.items():
        params = lm.lm_params_from_numpy(cfg, params_np, device="cpu")
        mesh, ctx = _mesh_ctx(2, 2, cfg)
        sp = shd.shard_tree(params, shd.params_pspecs(params, cfg, ctx), mesh)
        batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
        sb = shd.shard_tree(batch, shd.batch_pspecs(batch, cfg, ctx), mesh)
        loss, _, grads = ts.value_and_grad(sp, sb, cfg, ctx, remat=False)
        order = tree_leaves(shd.map_with_path(lambda p, _: p, sp))
        placed = {path: g.placements == p.placements
                  for path, g, p in zip(order, grads, tree_leaves(sp))
                  if _is_mixer_weight(path, cfg)}
        out["grad"][name] = {"loss": float(_np(loss)),
                             "grads": _by_path(tree_unflatten(sp, grads)),
                             "placements": placed}
    if staged:
        out["staged"] = _staged_forwards(staged)
    return out


def _staged_forwards(cases):
    """`mixers_2x2`'s ``staged`` part (last: the staging stays installed
    in the process)."""
    from repro_torch.launch import staging
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as shd
    import torch.distributed as dist
    gathers = []
    inner = staging.all_gather_into_tensor

    def recorded(x, group_size, group_name):
        # by its ranks: DTensor may run a redistribution it planned on an
        # equal mesh made earlier over that mesh's group of the same ranks
        gathers.append((tuple(x.shape), tuple(dist.get_process_group_ranks(
            staging._group(group_name)))))
        return inner(x, group_size, group_name)
    staging.all_gather_into_tensor = recorded
    staging.install("CPU")
    out = {}
    for name, (cfg, params_np, batch_np) in cases.items():
        params = lm.lm_params_from_numpy(cfg, params_np, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
        for tp_only in (True, False):
            c = dataclasses.replace(cfg, serve_tp_only=tp_only)
            mesh, ctx = _mesh_ctx(2, 2, c)
            specs = shd.params_pspecs(params, c, ctx)
            sp = shd.shard_tree(params, specs, mesh)
            spec_of, blocks_ = {}, set()
            shd.map_with_path(lambda p, s_: spec_of.__setitem__(p, s_), specs)

            def shapes(path, leaf):
                """A repeat's block as placed, and with its data split
                gathered."""
                if not _is_mixer_weight(path, c):
                    return
                whole_data = list(leaf.shape[1:])
                for d, entry in enumerate(spec_of[path][1:]):
                    if "model" in shd._axes(entry):
                        whole_data[d] //= 2
                blocks_.update({tuple(leaf.to_local().shape[1:]),
                                tuple(whole_data)})
            shd.map_with_path(shapes, sp)
            data_group = tuple(dist.get_process_group_ranks(
                mesh.get_group("data")))
            gathers.clear()
            staging.COUNTS.clear()
            staging.BYTES.clear()
            with torch.no_grad():
                lm.forward(sp, batch, c, ctx=ctx, remat=False)
            out[(name, tp_only)] = {
                "gathers": [(s_, g == data_group) for s_, g in gathers],
                "blocks": blocks_, "counts": dict(staging.COUNTS),
                "bytes": dict(staging.BYTES)}
    return out


# ---- the dry run's per-device pass against a real rank ---------------------


def dryrun_costs_2x2(rank, world, cases, mesh_shape=(2, 2)):
    """``cases``: {name: (cfg, Shape, train kwargs)}.  For each, the
    cell's step
    (`repro_torch.launch.dryrun.cell_step`) on a real mesh of gloo CPU
    ranks (2 x 2, or (pod, data, model) ``mesh_shape``), its operands
    placed by the dry run's specs from values drawn here (parameters
    from seed 0, tokens and labels from seed 1, a zero cache), measured
    as the dry run measures a fake rank (`dryrun.measure`): this rank's
    record."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as shd
    out = {}
    for name, (cfg, shape, train_kwargs) in cases.items():
        if len(mesh_shape) == 2:
            mesh, ctx = _mesh_ctx(*mesh_shape, cfg)
        else:
            mesh = M.make_mesh(mesh_shape, ("pod", "data", "model"),
                               device="cpu")
            ctx = shd.make_shard_ctx(mesh, cfg)
        _, p_specs, meta_batch, b_specs, _, c_specs = dryrun._operands(
            cfg, shape, ctx)
        params = lm.init_model(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
        gen = torch.Generator().manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab, tuple(v.shape), generator=gen,
                                  dtype=v.dtype)
                 for k, v in meta_batch.items()}
        params = shd.shard_tree(params, p_specs, mesh)
        batch = shd.shard_tree(batch, b_specs, mesh)
        cache = None
        if shape.kind != "train":
            cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                                  device="cpu")
            cache = shd.shard_tree(cache, c_specs, mesh)
        step, operands = dryrun.cell_step(cfg, shape.kind, ctx, params, batch,
                                          cache, train_kwargs=train_kwargs,
                                          decode_len=shape.seq_len - 1)
        out[name] = dryrun.measure(step, operands)
    return out


def dryrun_train_cell(cfg, shape, mesh, folded):
    """The dry run's fake rank of ``cfg``'s ``shape`` train step, run in
    a process of its own (the fake process group is process-global): on
    ``mesh`` at `dryrun.CALIBRATION_REPEATS` repeats of the layer
    pattern, with the redistributions run as sequential collectives at
    the first (`tools/dryrun_sequential.py`'s record, described), the
    calibrated collectives, and on ``folded`` at the first."""
    import importlib.util
    import os
    from repro_torch.launch import dryrun
    spec = importlib.util.spec_from_file_location(
        "dryrun_sequential", os.path.join(os.path.dirname(__file__), "..",
                                          "tools", "dryrun_sequential.py"))
    sequential = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sequential)
    first, second = (dryrun._unrolled_variant(cfg, k)
                     for k in dryrun.CALIBRATION_REPEATS)
    with sequential.recording() as seen:
        one = dryrun.per_device_costs(first, shape, mesh)
    two = dryrun.per_device_costs(second, shape, mesh)
    base = cfg.moe.first_k_dense if cfg.moe is not None else 0
    reps = (cfg.n_layers - base) / max(cfg.scan_group, 1)
    return {"sequential": sequential.describe(seen), "repeats": one,
            "folded": dryrun.per_device_costs(first, shape, folded),
            "calibrated": {op: dryrun._affine(
                one["collectives"].get(op, 0), two["collectives"].get(op, 0),
                reps) for op in set(one["collectives"])
                | set(two["collectives"])}}


def train_multipod(rank, world, shape, cases):
    """``cases``: {name: (cfg, params, batch)}, numpy, float32.  On a
    (pod, data, model) mesh of ``shape``, the parameters placed by the
    port's specs (FSDP over ``("pod", "data")``), the batch split over
    the data axes: `train.step.value_and_grad` without remat (each
    weight used once a forward): the loss, the gradients by path,
    whether each has its parameter's placements, the functional
    collectives the ranks ran (op, result shape, group size) and the
    number of FSDP-split weights a step uses (a stacked leaf's repeats
    each), split over the data axes together, or over one of them."""
    from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
    from repro_torch.launch import mesh as M
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import step as ts
    mesh = M.make_mesh(shape, ("pod", "data", "model"), device="cpu")
    out = {}
    for name, (cfg, params_np, batch_np) in cases.items():
        ctx = shd.make_shard_ctx(mesh, cfg)
        params = lm.lm_params_from_numpy(cfg, params_np, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
        sp = shd.shard_tree(params, shd.params_pspecs(params, cfg, ctx), mesh)
        sb = shd.shard_tree(batch, shd.batch_pspecs(batch, cfg, ctx), mesh)
        log = _collective_log()
        with log:
            loss, _, grads = ts.value_and_grad(sp, sb, cfg, ctx, remat=False)
        leaves = tree_leaves(sp)
        stacked = tree_leaves(shd.map_with_path(
            lambda p, _: p.startswith("groups/"), sp))
        split = collections.Counter(
            tuple(q.dim for q in w.placements[:2] if q.is_shard())
            for w in leaves)
        fsdp = sum((w.shape[0] if st else 1) for w, st in zip(leaves, stacked)
                   if all(q.is_shard() for q in w.placements[:2])
                   and w.placements[0] == w.placements[1])
        out[name] = {
            "loss": float(_np(loss)),
            "grads": _by_path(tree_unflatten(sp, grads)),
            "grads_like_params": all(g.placements == w.placements
                                     for g, w in zip(grads, leaves)),
            "calls": log.calls, "fsdp": fsdp,
            "one_axis": sum(n for dims, n in split.items()
                            if len(dims) == 1)}
    return out


# ---- the loss on logits split along the vocab ------------------------------


def vocab_loss_2x2(rank, world, cases):
    """``cases``: {name: (logits, labels, mask or None)}, numpy.  Each
    case's logits placed as `repro_torch.models.lm._head` places them on
    the 2 x 2 mesh (the batch over ``data``, the vocab over ``model``
    where it divides), the mesh train step's loss
    (`train.step._cross_entropy_sharded`) and its gradient: {name: (loss,
    the gradient's full value, the logits' placements, the gradient's
    placements, this rank's gradient block's shape)}: a placement is
    the dim it splits, or its class's name."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import step as ts
    mesh, ctx = _mesh_ctx(2, 2)
    out = {}
    for name, (logits, labels, mask) in cases.items():
        vspec = "model" if logits.shape[-1] % 2 == 0 else None
        x = shd.place(torch.from_numpy(logits), ("data", None, vspec),
                      mesh).requires_grad_()
        lab = shd.place(torch.from_numpy(labels), ("data", None), mesh)
        msk = (None if mask is None
               else shd.place(torch.from_numpy(mask), ("data", None), mesh))
        loss = ts._cross_entropy_sharded(x, lab, msk, ctx)
        with implicit_replication():
            (g,) = torch.autograd.grad(loss, [x])
        out[name] = (float(_np(loss)), _np(g), _placed(x), _placed(g),
                     tuple(g.to_local().shape))
    return out


def _placed(x):
    return [p.dim if p.is_shard() else type(p).__name__
            for p in x.placements]


# ---- placements and meshes ------------------------------------------------


def placements_2x2x2(rank, world, full, specs):
    """Each spec's local block on a (pod, data, model) = 2 x 2 x 2 mesh,
    this rank's coordinate, and whether `make_host_mesh` refuses a
    wrong world size; and the serve steps' moves there (no gradient):
    ``full`` split over ("pod", "data") gathered in one call
    (`regions.gather_data`), split over data moved to the model ranks
    (`regions.permute_to_model`), and a sum `Partial` over pod and data
    of (rank + 1) * ``full`` reduced in one call (`regions.sum_partial`),
    with the calls each made."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.launch import dryrun, mesh as M
    from repro_torch.parallel import regions as R, sharding as shd
    mesh = M.make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    t = torch.from_numpy(full)
    blocks = [shd.place(t, spec, mesh).to_local().numpy() for spec in specs]

    class Calls(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func._schema.name.split("::")[-1]
            if (func.namespace in dryrun.COLLECTIVE_NAMESPACES
                    and name in dryrun.COLLECTIVE_OPS):
                self.names.append(name)
            return func(*args, **(kwargs or {}))

    moves = {}
    with torch.no_grad():
        for name, fn in (
                ("gathered", lambda: R.gather_data(
                    shd.place(t, (("pod", "data"), None, None), mesh))),
                ("permuted", lambda: R.permute_to_model(
                    shd.place(t, ("data", None, None), mesh), 1)),
                ("summed", lambda: R.sum_partial(DTensor.from_local(
                    t * (dist.get_rank() + 1), mesh,
                    [Partial(), Partial(), Replicate()]), [0, 1]))):
            calls = Calls()
            with calls:
                out = fn()
            moves[name] = (out.to_local().numpy(), calls.names, _placed(out))
    refused = []
    for d, m in ((2, 2), (3, 3), (1, 4)):
        try:
            M.make_host_mesh(d, m, device="cpu")
            refused.append(False)
        except ValueError:
            refused.append(True)
    return {"coord": tuple(mesh.get_coordinate()), "blocks": blocks,
            "refused": refused, "moves": moves}


# ---- the fabric over a chips mesh, and the collectives ---------------------


def fabric_chips(rank, world, cfg, params_np, streams, mask):
    """``run(shard="chips")`` of each stream on a session whose process
    group has ``chips`` ranks, and one masked ``run_batched``."""
    from repro_torch.interface import Interface
    from repro_torch.interface.types import params_from_numpy
    params = params_from_numpy(*params_np, device="cpu")
    session = Interface(cfg).compile(params, device="cpu")
    out = {}
    for name, spikes in streams.items():
        cur, st = session.run(torch.from_numpy(spikes), shard="chips")
        out[name] = (cur.numpy(), {k: float(v) for k, v in
                                   st._asdict().items()},
                     session.last_shard_body)
    stack = torch.from_numpy(np.stack(list(streams.values())))
    cur, st = session.run_batched(stack, shard="chips",
                                  mask=torch.from_numpy(mask))
    out["masked"] = (cur.numpy(), {k: v.numpy() for k, v in
                                   st._asdict().items()},
                     session.last_shard_body)
    return out


def collectives(rank, world, shards, ef_grads, staged):
    """The compressed all-reduces of this rank's shard, 20 error-feedback
    syncs, and (``staged``) one DTensor gather and one reduce-scatter
    (of whole numbers, so any order sums them exactly) with the
    host-staged functional collectives registered for the CPU."""
    from repro_torch.parallel import collectives as C
    x = torch.from_numpy(shards[rank])
    out = {"exact": C.compressed_psum_exact_scales(x).numpy(),
           "approx": C.compressed_psum(x).numpy()}
    sync = C.make_ef_sync()
    g = torch.from_numpy(ef_grads[rank])
    res = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    for _ in range(20):
        s, res = sync(g, res)
        acc = acc + s
    out["ef_acc"] = acc.numpy()
    if staged:
        from torch.distributed.tensor import DTensor, Partial, Shard
        from repro_torch.launch import mesh as M, staging
        staging.install("CPU")
        mesh = M.make_mesh((world,), ("chips",), device="cpu")
        before = dict(staging.COUNTS)
        full = DTensor.from_local(x[None], mesh, [Shard(0)],
                                  run_check=False).full_tensor()
        out["staged_gather"] = full.numpy()
        whole = torch.round(x[:x.shape[0] // world * world] * 64)
        out["staged_reduce_scatter"] = DTensor.from_local(
            whole, mesh, [Partial()], run_check=False).redistribute(
            mesh, [Shard(0)]).to_local().numpy()
        out["staged_calls"] = {k: v - before.get(k, 0)
                               for k, v in staging.COUNTS.items()}
    return out


def lm_2x2(rank, world, serve, train):
    """`lm_mesh_2x2` and `train_2x2` in one spawn."""
    return {"serve": lm_mesh_2x2(rank, world, serve),
            "train": train_2x2(rank, world, train)}


def gqa_1x2(rank, world, cfg, params_np, x, qkv):
    """`decode_attention` over a cache split along S (window 0 and 8),
    and `attention_apply`: an 8-token head-TP prefill filling a
    sequence-sharded 10-slot cache, then one decode step, on a 1 x 2
    mesh."""
    from repro_torch.models import blocks
    from repro_torch.parallel import sharding as shd
    _, ctx = _mesh_ctx(1, 2, cfg)
    q, k, v = (torch.from_numpy(a) for a in qkv)
    kv_spec = ("data", "model", None, None)
    ks, vs = (shd.place(a, kv_spec, ctx.mesh) for a in (k, v))
    qs = shd.place(q, ("data", None, None, None, None), ctx.mesh)
    out = {"decode": [_np(blocks.decode_attention(qs, ks, vs, 11, window=w,
                                                  ctx=ctx))
                      for w in (0, 8)]}
    p = {k_: shd.place(torch.from_numpy(np.asarray(v_)), (None,) * v_.ndim,
                       ctx.mesh) for k_, v_ in params_np.items()}
    xs = shd.place(torch.from_numpy(x), ("data", None, None), ctx.mesh)
    b = x.shape[0]
    cache = {n: shd.place(torch.zeros((b, 10, cfg.n_kv_heads, cfg.head_dim)),
                          kv_spec, ctx.mesh) for n in ("k", "v")}
    o, cache = blocks.attention_apply(p, xs[:, :8], cfg, is_local=False,
                                      cache=cache, ctx=ctx)
    out["prefill"] = _np(o)
    o, _ = blocks.attention_apply(p, xs[:, 8:9], cfg, is_local=False,
                                  positions=torch.tensor([[8]]), cache=cache,
                                  cache_len=8, ctx=ctx)
    out["decode_step"] = _np(o)
    return out


# ---- on the card (tests/test_torch_mesh_gpu.py): gloo ranks on cuda:0 -----


def gpu_collectives(rank, world):
    """The direct gloo collectives on CUDA tensors, and a DTensor gather
    and all-reduce through the host staging of a mesh on the card."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Shard
    from repro_torch.launch import mesh as M, staging
    dev = torch.device("cuda", 0)
    x = torch.arange(8, dtype=torch.float32, device=dev) + rank
    red = x.clone()
    dist.all_reduce(red)
    gat = torch.empty(8 * world, device=dev)
    dist.all_gather_into_tensor(gat, x)
    rs = torch.empty(8 // world, device=dev)
    dist.reduce_scatter_tensor(rs, x)
    mesh = M.make_host_mesh(2, world // 2, device="cuda")
    staging.COUNTS.clear()
    full = DTensor.from_local(x[None], mesh, [Shard(0), Shard(0)],
                              run_check=False).full_tensor()
    summed = DTensor.from_local(x, mesh, [Partial(), Partial()],
                                run_check=False).full_tensor()
    return {"all_reduce": red.cpu(), "all_gather": gat.cpu(),
            "reduce_scatter": rs.cpu(), "staged_gather": full.cpu(),
            "staged_all_reduce": summed.cpu(), "staged": dict(staging.COUNTS),
            "installed": staging.installed()}


def gpu_chips(rank, world, cfg, params, spikes):
    """``run(shard="chips")`` at chips=world on the card, this rank's chip."""
    from repro_torch.interface import Interface
    from repro_torch.interface.types import InterfaceParams
    dev = torch.device("cuda", 0)
    session = Interface(cfg).compile(
        InterfaceParams(*(t.to(dev) for t in params)), device=dev)
    cur, st = session.run(spikes.to(dev), shard="chips")
    return (cur.cpu(), {k: v.cpu() for k, v in st._asdict().items()},
            session.last_shard_body)


def gpu_lm(rank, world, arch, backend_mesh=(2, 2), over=None):
    """A smoke config's (with ``over`` replaced) prefill + STEPS greedy
    decode steps on a mesh on the card against the one-device run (per
    data shard), the backend the ranks ran and the widths the mixers ran
    on (`_record_widths`)."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import mesh as M
    from repro_torch.models import lm
    from repro_torch.models.blocks import LOCAL
    from repro_torch.parallel import regions as R, sharding as shd
    from repro_torch.serve.lm_engine import make_decode_step, make_prefill_step
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(_f32(configs.get_smoke_config(arch)),
                              **(over or {}))
    params = lm.init_model(torch.Generator(dev).manual_seed(0), cfg,
                           device=dev)
    mesh = M.make_host_mesh(*backend_mesh, device="cuda")
    ctx = shd.make_shard_ctx(mesh, cfg)
    sp = shd.shard_tree(params, shd.params_pspecs(params, cfg, ctx), mesh)
    toks = torch.randint(0, cfg.vocab, (BATCH, PROMPT), device=dev,
                         generator=torch.Generator(dev).manual_seed(1),
                         dtype=torch.int32)

    def serve(p, tokens, ctx_):
        cache = lm.init_cache(cfg, tokens.shape[0], PROMPT + STEPS,
                              device=dev)
        if ctx_.enabled:
            cache = shd.shard_tree(cache, shd.cache_pspecs(cache, cfg, ctx_),
                                   mesh)
        logits, _ = make_prefill_step(cfg, ctx_)(p, {"tokens": tokens},
                                                  cache)
        out, steps = [], [R.full(logits)]
        for i in range(STEPS):
            nxt = R.full(logits).argmax(-1).to(torch.int32)
            out.append(nxt)
            logits, _ = make_decode_step(cfg, ctx_)(p, cache, nxt[:, None],
                                                    PROMPT + i)
            steps.append(R.full(logits))
        return torch.stack(out, 1), torch.stack(steps)

    data = backend_mesh[0]
    n = BATCH // data
    with torch.no_grad():
        parts = [serve(params, toks[i * n:(i + 1) * n], LOCAL)
                 for i in range(data)]
        want_t = torch.cat([p[0] for p in parts])
        want_l = torch.cat([p[1] for p in parts], dim=1)
        widths = []
        restore = _record_widths(widths)
        try:
            got_t, got_l = serve(sp, toks, ctx)
        finally:
            restore()
    return {"tokens_equal": bool(torch.equal(want_t, got_t)),
            "logit_gap": float((got_l - want_l).abs().max()),
            "backend": dist.get_backend(), "widths": set(widths)}
