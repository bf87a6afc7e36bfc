"""The serve steps' moves that GSPMD makes of the JAX package's, held
for their values on meshes of gloo CPU ranks, the parameters placed by
the port's specs (FSDP: split over the data axes) and the batch split
over the data axes:

- the WKV state kept split by heads in the cache at ``rwkv_pad_heads``
  H' > H (`repro_torch.models.rwkv6.head_split`): each rank reads and
  writes its own block of the H heads (DTensor's blocks of ceil(H /
  model), padded to H'/model), so a later decode step reads back what
  an earlier one wrote, and no collective returns the state;
- the decode embedding lookup in place (`regions.product_plan`'s
  ``"all_to_all"``): the tokens gathered over the data axes, each rank's
  columns of the table looked up, the rows moved to their owners by one
  all-to-all, the table never gathered;
- the expert weights gathered over ``("pod", "data")`` in one call, and
  the MoE aux losses reduced in one all-reduce a layer
  (`blocks._moe_sharded`, `regions.sum_losses`).

On the smoke configs, float32, prefill + `torch_mesh_ranks.STEPS`
greedy decode steps of `torch_mesh_ranks.BATCH` sequences: rwkv6-3b at
``rwkv_pad_heads`` 6 (H = 4 heads in blocks of 2, the WKV on 3 a rank)
and at 0, and llama3.2-3b, on 2 x 2; deepseek-v2-lite-16b and rwkv6-3b
at 6 on 2 x 2 x 2 (one sequence a data shard; the MoE routes each
shard alone, as the JAX package's expert-parallel layer does, so its
references run per shard).  Tokens equal to the JAX package's single
device and logits within rtol 1e-4 / atol 1e-5
(`tests/test_torch_mesh_lm.py`'s tolerance against JAX), within 1e-5 of
the port's own single device; the cache read out whole after 2 decode
steps within 1e-5 of JAX's (of the leaf's largest above 1), each rank's
block of it its block of that whole; and the moves themselves, from
every functional collective the ranks ran.

Two spawns (4, then 8 gloo ranks) while the test process computes the
JAX references.
"""

import concurrent.futures
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.launch.spawn import spawn
from repro_torch.models import lm as tlm
import torch_mesh_ranks as ranks
from tests.test_torch_lm import port_config
from tests.test_torch_mesh_lm import (JAX_ATOL, JAX_RTOL, PORT_TOL, _inputs,
                                      _jax_cfg, _jax_serve)

# name -> (arch, overrides of its smoke config), by mesh
CASES = {
    (2, 2): {"rwkv6-3b+pad6": ("rwkv6-3b", {"rwkv_pad_heads": 6}),
             "rwkv6-3b": ("rwkv6-3b", {}),
             "llama3.2-3b": ("llama3.2-3b", {})},
    (2, 2, 2): {"deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", {}),
                "rwkv6-3b+pad6": ("rwkv6-3b", {"rwkv_pad_heads": 6})},
}
PARAMS = [(mesh, name) for mesh, cases in CASES.items() for name in cases]
STATE_TOL = 1e-5


def _ids(param):
    mesh, name = param
    return f"{'x'.join(map(str, mesh))}-{name}"


def _jax_refs(cfg, params, batch, data):
    """JAX's single device: (tokens, logits, state after SNAP decode
    steps), per data shard where a MoE routes."""
    moe = any(map(cfg.layer_is_moe, range(cfg.n_layers)))
    n = batch["tokens"].shape[0] // (data if moe else 1)
    parts = [_jax_serve(cfg, params, {k: v[i * n:(i + 1) * n]
                                      for k, v in batch.items()}, [],
                        snap=ranks.SNAP)
             for i in range(batch["tokens"].shape[0] // n)]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts], 1),
            {k: np.concatenate([p[2][k] for p in parts], 1)
             for k in parts[0][2]})


def _spawns(rank_args):
    return {mesh: spawn(ranks.serve_gspmd, math.prod(mesh),
                        args=(mesh, cases), timeout=600)
            for mesh, cases in rank_args.items()}


@pytest.fixture(scope="module")
def runs():
    """(each mesh's rank results, the JAX references by (mesh, name))."""
    jax_cases, rank_args = {}, {}
    for mesh, cases in CASES.items():
        rank_args[mesh] = {}
        for seed, (name, (arch, over)) in enumerate(cases.items()):
            cfg = dataclasses.replace(_jax_cfg(arch), **over)
            tcfg = port_config(cfg)
            p_np = jax.tree.map(lambda x: x.numpy(), tlm.init_model(
                torch.Generator().manual_seed(seed), tcfg, device="cpu"))
            batch = _inputs(cfg, 300 + seed)
            jax_cases[(mesh, name)] = (cfg, p_np, batch)
            rank_args[mesh][name] = (tcfg, p_np, batch)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(_spawns, rank_args)
        refs = {key: _jax_refs(cfg, jax.tree.map(jnp.asarray, p_np), batch,
                               math.prod(key[0][:-1]))
                for key, (cfg, p_np, batch) in jax_cases.items()}
        return running.result(), refs


@pytest.mark.parametrize("param", PARAMS, ids=_ids)
def test_serve_matches_jax(runs, param):
    mesh, name = param
    results, refs = runs
    want_toks, want_logits, want_state = refs[param]
    for rank, out in enumerate(results[mesh]):
        got = out[name]
        gap = float(np.abs(got["logits"] - want_logits).max())
        gaps = {k: float(np.abs(got["state"][k] - w).max())
                / max(float(np.abs(w).max()), 1.0)
                for k, w in want_state.items()}
        worst = max(gaps, key=gaps.get)
        print(f"{_ids(param)} rank {rank}: logit gap to JAX {gap:.3e}, "
              f"widest state gap {gaps[worst]:.3e} ({worst})")
        assert np.array_equal(got["tokens"], want_toks), (rank, name)
        np.testing.assert_allclose(got["logits"], want_logits,
                                   rtol=JAX_RTOL, atol=JAX_ATOL,
                                   err_msg=f"{_ids(param)} rank {rank}")
        assert set(got["state"]) == set(want_state), (rank, name)
        assert gaps[worst] < STATE_TOL, (rank, name, worst, gaps[worst])


@pytest.mark.parametrize("param", PARAMS, ids=_ids)
def test_serve_matches_the_single_device(runs, param):
    mesh, name = param
    for rank, out in enumerate(runs[0][mesh]):
        got = out[name]
        print(f"{_ids(param)} rank {rank}: logit gap {got['logit_gap']:.3e}, "
              f"plans {got['plans']}")
        assert got["tokens_equal"], (rank, name)
        assert got["logit_gap"] < PORT_TOL, (rank, name, got["logit_gap"])
        # the cache read out whole holds each rank's block where the rank
        # wrote it (the WKV state's uneven split by heads included)
        assert got["blocks_equal"], (rank, name)


def _gathers(calls):
    return [(shape, size) for op, shape, size in calls if op == "all-gather"]


@pytest.mark.parametrize("param", PARAMS, ids=_ids)
def test_serve_moves_as_gspmd(runs, param):
    mesh, name = param
    arch, _ = CASES[mesh][name]
    cfg = _jax_cfg(arch)
    for rank, out in enumerate(runs[0][mesh]):
        got = out[name]
        plans, calls = got["plans"], got["calls"]
        # the decode steps' lookups of tokens split over the data axes:
        # in place, the rows moved, the table never gathered
        assert plans.get("lookup all_to_all", 0) >= ranks.STEPS, (
            rank, name, plans)
        assert "lookup gather" not in plans, (rank, name, plans)
        assert sum(op == "all-to-all"
                   for op, _, _ in calls["decode"]) == ranks.STEPS, rank
        if arch == "rwkv6-3b":
            # no decode step's collective returns the WKV state (the
            # padded heads' (H', B / data, D, D) once gathered whole)
            hd = cfg.rwkv.head_dim
            state = [c for c in calls["decode"] if c[1][-2:] == (hd, hd)]
            assert not state, (rank, name, state)
        if arch == "deepseek-v2-lite-16b":
            # each expert weight (the only 3-D weights) gathered in one
            # call over the data axes together
            moe = sum(map(cfg.layer_is_moe, range(cfg.n_layers)))
            for step, n in (("prefill", 1), ("decode", ranks.STEPS)):
                experts = [c for c in _gathers(calls[step])
                           if len(c[0]) == 3]
                assert len(experts) == 3 * moe * n, (rank, step, experts)
                assert {size for _, size in experts} == {
                    math.prod(mesh[:-1])}, (rank, step, experts)
            # at decode both aux losses in one all-reduce a MoE layer,
            # none alone
            losses = [s for op, s, _ in calls["decode"]
                      if op == "all-reduce" and s in ((), (2,))]
            assert losses == [(2,)] * moe * ranks.STEPS, (rank, losses)


@pytest.mark.parametrize("mesh", [m for m, cases in CASES.items()
                                  if "rwkv6-3b+pad6" in cases])
def test_time_mix_runs_on_its_heads(runs, mesh):
    """rwkv6-3b at pad 6: where `rwkv6.own_heads` chooses the rank's
    heads (on 2 x 2 x 2, where ``("pod", "data")`` split the weights; on
    2 x 2 the permute at decode moves fewer bytes), the rank's ``wr``,
    ``wk``, ``wv`` and ``wg`` products run at its block's width: 2 heads
    of 16 of the 4."""
    cfg = _jax_cfg("rwkv6-3b")
    for rank, out in enumerate(runs[0][mesh]):
        got = out["rwkv6-3b+pad6"]
        own = [h for h in got["heads"] if h is not None]
        print(f"{'x'.join(map(str, mesh))} rank {rank}: heads "
              f"{set(own)} in {len(own)} of {len(got['heads'])} time "
              f"mixes, products {got['products']}")
        assert len(own) == (len(got["heads"]) if mesh == (2, 2, 2) else 0)
        width = {n * cfg.rwkv.head_dim for _, n in own}
        assert width <= {cfg.d_model // 2}, (rank, width)
        for w in width:
            assert got["products"][(cfg.d_model, w)] == 4 * len(own), rank
