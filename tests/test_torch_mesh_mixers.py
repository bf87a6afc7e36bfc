"""The recurrent mixers and MLA's prefill on the JAX package's
tensor-parallel layout, on a 2 x 2 mesh of gloo CPU ranks.

Under `ShardCtx(enabled=True)` the port's specs place Mamba's d_inner,
RWKV's channel-mix FFN and MLA's heads over ``model``, and the layers
compute on those blocks as GSPMD computes the JAX package's: Mamba's
``w_in`` column-parallel with one all-to-all of the activation into
each rank's (u, z) blocks, its scan on d_inner/model channels and its
state split; RWKV's channel mix column/row-parallel; RWKV's WKV on
H'/model padded heads at ``rwkv_pad_heads`` = H' > H (whole otherwise);
MLA's prefill attention on H/model heads.

Held against the JAX package's single device (per data shard where a
MoE routes, as the JAX package's expert-parallel layer routes each
shard alone), on the smoke configs of rwkv6-3b (``rwkv_pad_heads`` 0
and 8), jamba-1.5-large-398b and deepseek-v2-lite-16b in float32:
served tokens equal, logits and the decode cache after 2 steps within
1e-5 (the cache relative to its leaf's largest above 1), routes exact
a call; `value_and_grad`'s loss within 1e-5 and its gradients as the
other mesh tests hold them, also where the dims do not divide the
model axis (RWKV's d_ff 225, MLA's 3 heads: the
layer then runs on each rank's batch shard, as the JAX package
replicates it).  Structure, which the whole-mixer layout failed: the
widths each rank runs on (and each mixer weight's gradient in its
parameter's placements); under
``serve_tp_only`` no all-gather of a Mamba or channel-mix weight, and
under FSDP x TP only the data-axis gathers the JAX package also makes
(the functional collectives staged through the host and recorded).

One spawn for the file; the JAX references are computed while it runs.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.launch.spawn import spawn
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as tmamba
from repro_torch.models.blocks import ShardCtx
import torch_mesh_ranks as ranks
from tests.test_torch_lm import port_config
from tests.test_torch_mesh_lm import (_grad_gaps, _inputs, _jax_cfg,
                                      _jax_grads, _jax_serve, _routes,
                                      _shards)

TOL = 1e-5
# name -> (arch, overrides of its smoke config)
SERVE = {"rwkv6-3b": ("rwkv6-3b", {}),
         "rwkv6-3b+pad8": ("rwkv6-3b", {"rwkv_pad_heads": 8}),
         "jamba-1.5-large-398b": ("jamba-1.5-large-398b", {}),
         "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", {})}
# and where the model axis does not divide the dims: whole on each rank
GRAD = {**SERVE,
        "rwkv6-3b+ff225": ("rwkv6-3b", {"d_ff": 225}),
        "deepseek-v2-lite-16b+h3": ("deepseek-v2-lite-16b",
                                    {"n_heads": 3, "n_kv_heads": 3})}
STAGED = ("rwkv6-3b", "jamba-1.5-large-398b")
# what each rank runs on: Mamba's d_inner / 2, the WKV's H' / 2 heads
# (H = 4 whole at pad 0), MLA's H / 2 heads
WIDTHS = {"rwkv6-3b": {("wkv", 4)}, "rwkv6-3b+pad8": {("wkv", 4)},
          "jamba-1.5-large-398b": {("mamba_scan", 64)},
          "deepseek-v2-lite-16b": {("attention", 2)}}
SNAP = 2                          # the decode steps before the state check


def _case(name, seed, train):
    """(JAX config, numpy parameters drawn by the port, numpy batch)."""
    arch, over = GRAD[name]
    cfg = dataclasses.replace(_jax_cfg(arch), **over)
    p_np = jax.tree.map(lambda x: x.numpy(), tlm.init_model(
        torch.Generator().manual_seed(seed), port_config(cfg), device="cpu"))
    return cfg, p_np, _inputs(cfg, 200 + seed, train=train)


def _jax_refs(serve, grad):
    out = {"serve": {}, "grad": {}}
    for name, (cfg, p_np, batch) in serve.items():
        params = jax.tree.map(jnp.asarray, p_np)
        parts, routes = [], []
        for b in (_shards(batch) if _routes(cfg) else [batch]):
            routes.append([])
            parts.append(_jax_serve(cfg, params, b, routes[-1], snap=SNAP))
        out["serve"][name] = {
            "tokens": np.concatenate([p[0] for p in parts]),
            "logits": np.concatenate([p[1] for p in parts], 1),
            "state": {k: np.concatenate([p[2][k] for p in parts], 1)
                      for k in parts[0][2]},
            "routes": routes}
    for name, (cfg, p_np, batch) in grad.items():
        loss, grads = _jax_grads(cfg, jax.tree.map(jnp.asarray, p_np), batch)
        out["grad"][name] = {"loss": loss, "grads": grads}
    return out


@pytest.fixture(scope="module")
def mixers():
    """(each rank's results, the JAX references)."""
    serve = {n: _case(n, i, False) for i, n in enumerate(SERVE)}
    grad = {n: _case(n, 10 + i, True) for i, n in enumerate(GRAD)}
    staged = {n: serve[n] for n in STAGED}
    port = {part: {n: (port_config(c), p, b) for n, (c, p, b) in cases.items()}
            for part, cases in (("serve", serve), ("grad", grad),
                                ("staged", staged))}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(spawn, ranks.mixers_2x2, 4,
                              args=(port["serve"], port["grad"],
                                    port["staged"]), timeout=600)
        refs = _jax_refs(serve, grad)
        return running.result(), refs


@pytest.mark.parametrize("name", SERVE)
def test_mixers_serve_match_jax(mixers, name):
    results, refs = mixers
    want = refs["serve"][name]
    for rank, out in enumerate(results):
        got = out["serve"][name]
        gap = float(np.abs(got["logits"] - want["logits"]).max())
        print(f"rank {rank} {name}: logit gap to JAX {gap:.3e}, largest "
              f"{float(np.abs(want['logits']).max()):.3e}")
        assert np.array_equal(got["tokens"], want["tokens"]), (rank, name)
        assert gap < TOL, (rank, name, gap)
        # a MoE's routes by data shard; one empty list elsewhere
        mine = want["routes"][got["data_rank"] % len(want["routes"])]
        assert len(got["routes"]) == len(mine), (rank, name)
        for call, (g, w) in enumerate(zip(got["routes"], mine)):
            for field, a, b in zip(("expert_ids", "event_slot", "kept"), g, w):
                assert np.array_equal(a, b), (rank, name, call, field)


@pytest.mark.parametrize("name", SERVE)
def test_mixers_decode_state_matches_jax(mixers, name):
    """The whole cache (Mamba's conv window and ssm state, RWKV's token
    shifts and WKV state, the KV and latent caches) after prefill and
    2 decode steps."""
    results, refs = mixers
    want = refs["serve"][name]["state"]
    for rank, out in enumerate(results):
        got = out["serve"][name]["state"]
        assert set(got) == set(want), (rank, name)
        gaps = {k: float(np.abs(got[k] - w).max())
                / max(float(np.abs(w).max()), 1.0) for k, w in want.items()}
        worst = max(gaps, key=gaps.get)
        print(f"rank {rank} {name}: widest state gap {gaps[worst]:.3e} "
              f"({worst}, largest {float(np.abs(want[worst]).max()):.3e})")
        assert gaps[worst] < TOL, (rank, name, worst, gaps[worst])


@pytest.mark.parametrize("name", SERVE)
def test_mixers_run_on_their_blocks(mixers, name):
    results, _ = mixers
    for rank, out in enumerate(results):
        widths = set(out["serve"][name]["widths"])
        print(f"rank {rank} {name}: {sorted(widths)}")
        assert WIDTHS[name] <= widths, (rank, name, sorted(widths))
        tags = {tag for tag, _ in WIDTHS[name]}
        assert {w for w in widths if w[0] in tags} == WIDTHS[name], (
            rank, name, sorted(widths))


def _rwkv_grads_ok(got, want):
    """RWKV6's gradients as `tests/test_torch_lm_hybrid.py` holds the
    port's one device to the JAX package: each element within 1e-3 of
    its leaf's largest plus 1e-4 of itself (the factored WKV's two
    nearly cancelling decay factors move them with summation order)."""
    return {p: bool(np.all(np.abs(got[p] - w)
                           <= 1e-3 * np.abs(w).max() + 1e-4 * np.abs(w)))
            for p, w in want.items()}


@pytest.mark.parametrize("name", GRAD)
def test_mixers_gradients_match_jax(mixers, name):
    """The loss within 1e-5; each gradient as the port's one device is
    held to the JAX package: 1e-4 of each element plus 1e-5 of its
    leaf's largest (`_grad_gaps`), RWKV6's by `_rwkv_grads_ok`.  On
    these inputs the port's one device is itself 7.9e-05 of the leaf's
    largest from the JAX package on rwkv6-3b and 1.8e-05 on jamba's
    ``a_log``, so 1e-5 of the largest alone holds no family's one
    device."""
    results, refs = mixers
    want = refs["grad"][name]
    for rank, out in enumerate(results):
        got = out["grad"][name]
        gaps, ok = _grad_gaps(got["grads"], want["grads"])
        if GRAD[name][0] == "rwkv6-3b":
            ok = _rwkv_grads_ok(got["grads"], want["grads"])
        worst = max(gaps, key=gaps.get)
        print(f"rank {rank} {name}: loss {got['loss']} vs {want['loss']}; "
              f"widest gradient gap {gaps[worst]:.3e} of its leaf's "
              f"largest ({worst})")
        assert abs(got["loss"] - want["loss"]) < TOL, (rank, name)
        assert all(ok.values()), (rank, name, [p for p in ok if not ok[p]])


@pytest.mark.parametrize("name", GRAD)
def test_mixer_gradients_keep_their_placements(mixers, name):
    results, _ = mixers
    for rank, out in enumerate(results):
        placed = out["grad"][name]["placements"]
        assert placed and all(placed.values()), (rank, name, placed)


@pytest.mark.parametrize("arch", STAGED)
def test_serving_gathers_no_mixer_weight(mixers, arch):
    """``serve_tp_only``: no weight keeps a data split, and no Mamba or
    channel-mix weight is gathered by a forward."""
    results, _ = mixers
    for rank, out in enumerate(results):
        rec = out["staged"][(arch, True)]
        hits = [s for s, _ in rec["gathers"] if s in rec["blocks"]]
        print(f"rank {rank} {arch}: staged {rec['counts']}, bytes "
              f"{rec['bytes']}")
        assert rec["counts"] and rec["bytes"], (rank, arch)
        assert set(rec["counts"]) == set(rec["bytes"]), (rank, arch)
        assert not hits, (rank, arch, hits)


@pytest.mark.parametrize("arch", STAGED)
def test_fsdp_gathers_mixer_weights_over_data_only(mixers, arch):
    results, _ = mixers
    for rank, out in enumerate(results):
        rec = out["staged"][(arch, False)]
        hits = [(s, data) for s, data in rec["gathers"]
                if s in rec["blocks"]]
        assert hits, (rank, arch)
        assert all(data for _, data in hits), (rank, arch, hits)


def test_mamba_refuses_an_uneven_d_inner():
    cfg = port_config(_jax_cfg("jamba-1.5-large-398b"))
    ctx = ShardCtx(enabled=True, model_size=3)
    with pytest.raises(ValueError, match="d_inner 128"):
        tmamba.mamba_apply({}, torch.zeros(1, 2, cfg.d_model), cfg, ctx=ctx)
