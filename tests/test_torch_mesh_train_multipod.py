"""The train step on a (pod, data, model) = 2 x 2 x 2 mesh of gloo CPU
ranks, its FSDP weights gathered over ``("pod", "data")`` in one call
and their gradients reduce-scattered in one (`regions.gather_data`), a
replicated leaf's gradient summed in one all-reduce there
(`regions.reduce_data`), against the JAX package's one device.

Float32 parameters drawn by the port's `init_model` go to both packages
as numpy, with the same batch (2 rows a data shard), at the smoke
configs of internlm2-1.8b (dense), deepseek-v2-lite-16b (MLA and
experts; the mesh routes each data shard alone, as the JAX package's
expert-parallel layer does, so its reference is the mean over the four
shards) and rwkv6-3b.  Held (`train.step.value_and_grad`, no remat):

- the loss within 1e-5; each gradient within rtol 1e-4 / atol 1e-5 of
  the leaf's largest (`tests/test_torch_mesh_lm.py` ``_grad_gaps``),
  RWKV6's as the port's one device is held to JAX (1e-3 of the leaf's
  largest plus 1e-4 of itself, `tests/test_torch_mesh_mixers.py`);
  each in its parameter's placements;
- the collectives the ranks ran: one all-gather over the 4 ranks of
  ``("pod", "data")`` for each use of an FSDP weight (a stacked leaf's
  repeats each) and one reduce-scatter over them for its gradient, none
  over one data axis alone.

One spawn of 8 ranks while the test process computes the references.
"""

import concurrent.futures
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import step as jstep
from repro_torch.launch.spawn import spawn
from repro_torch.models import lm as tlm
from tests import torch_mesh_ranks as ranks
from tests.test_torch_lm import port_config
from tests.test_torch_mesh_lm import (PORT_TOL, _by_path, _grad_gaps,
                                      _jax_cfg, _routes)
from tests.test_torch_mesh_mixers import _rwkv_grads_ok

MESH = (2, 2, 2)
DATA = math.prod(MESH[:-1])
BATCH, SEQ = 2 * DATA, 16
ARCHS = ("internlm2-1.8b", "deepseek-v2-lite-16b", "rwkv6-3b")


def _inputs(cfg, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jax_refs(cases):
    """(loss, gradients by path) of the JAX loss on one device, the mean
    over the data shards where a MoE routes each on its own."""
    out = {}
    for arch, (cfg, params, batch) in cases.items():
        vg = jax.jit(jax.value_and_grad(lambda p, b, cfg=cfg: jstep.loss_fn(
            p, b, cfg, jstep.LOCAL, remat=False)[0]))
        n = BATCH // (DATA if _routes(cfg) else 1)
        parts = [vg(params, {k: jnp.asarray(v[i:i + n])
                             for k, v in batch.items()})
                 for i in range(0, BATCH, n)]
        out[arch] = {
            "loss": sum(float(l) for l, _ in parts) / len(parts),
            "grads": _by_path(jax.tree.map(lambda *g: sum(g) / len(g),
                                           *[g for _, g in parts]))}
    return out


@pytest.fixture(scope="module")
def runs():
    """(each rank's results, the JAX references)."""
    cases, rank_cases = {}, {}
    for seed, arch in enumerate(ARCHS):
        cfg = _jax_cfg(arch)
        tcfg = port_config(cfg)
        p_np = jax.tree.map(lambda x: x.numpy(), tlm.init_model(
            torch.Generator().manual_seed(seed), tcfg, device="cpu"))
        batch = _inputs(cfg, 400 + seed)
        cases[arch] = (cfg, jax.tree.map(jnp.asarray, p_np), batch)
        rank_cases[arch] = (tcfg, p_np, batch)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(spawn, ranks.train_multipod, math.prod(MESH),
                              args=(MESH, rank_cases), timeout=600)
        refs = _jax_refs(cases)
        return running.result(), refs


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(runs, arch):
    results, refs = runs
    want = refs[arch]
    for rank, out in enumerate(results):
        got = out[arch]
        gaps, ok = _grad_gaps(got["grads"], want["grads"])
        if arch == "rwkv6-3b":
            ok = _rwkv_grads_ok(got["grads"], want["grads"])
        worst = max(gaps, key=gaps.get)
        print(f"rank {rank} {arch}: loss {got['loss']} vs {want['loss']}; "
              f"widest gradient gap {gaps[worst]:.3e} of its leaf's "
              f"largest ({worst})")
        assert abs(got["loss"] - want["loss"]) < PORT_TOL, (rank, arch)
        assert all(ok.values()), (rank, arch, [p for p in ok if not ok[p]])
        assert got["grads_like_params"], (rank, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_move_in_one_call_over_the_data_axes(runs, arch):
    results, _ = runs
    for rank, out in enumerate(results):
        got = out[arch]
        moves = {(op, size): sum(1 for o, _, s in got["calls"]
                                 if (o, s) == (op, size))
                 for op in ("all-gather", "reduce-scatter")
                 for size in (DATA, 2)}
        print(f"rank {rank} {arch}: {got['fsdp']} FSDP weight uses, "
              f"moves {moves}")
        assert got["fsdp"] > 0 and got["one_axis"] == 0, (rank, arch)
        assert moves == {("all-gather", DATA): got["fsdp"],
                         ("reduce-scatter", DATA): got["fsdp"],
                         ("all-gather", 2): 0,
                         ("reduce-scatter", 2): 0}, (rank, arch)
