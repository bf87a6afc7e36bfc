"""The port's train step in microbatches on a 2 x 2 mesh of gloo CPU
ranks, against the JAX package's step.

`repro_torch.train.step.make_train_step(microbatch=2)` on the mesh
gathers the batch once, splits rows ``[i b/2, (i+1) b/2)`` off it and
places each microbatch as the batch was; the gradients accumulate in
float32 DTensors of the parameters' placements.  Float32 parameters drawn
by the port's `init_model` go to both packages as numpy, with the same
batch, at the smoke configs of internlm2-1.8b (dense) and
deepseek-v2-lite (MLA and experts).

The reference is `repro.train.step.make_train_step` on one device.  A
dense model's loss and gradient do not depend on which rows go
together, so its reference runs at the mesh's 2 microbatches.  A MoE
routes each data shard of each microbatch on its own, as the JAX
package's expert-parallel layer does (`tests/test_torch_mesh_lm.py`),
and its aux loss depends on which rows are routed together: on the 2 x 2
mesh the groups are the batch's four quarters in order, so its
reference is the JAX step at 4 microbatches, which routes the same
groups (every row's labels count, so the mean of the quarters' losses is
the mean of the halves').  A wrong split or placement of the
microbatches changes the MoE's groups and fails here.

Held: the loss of `microbatch_value_and_grad` and the step's within 1e-5
(as the mesh tests hold a loss), ``grad_norm`` within rtol 1e-5, ``lr``
exactly; each gradient within rtol 1e-4 / atol 1e-5 of the leaf's
largest (as `tests/test_torch_train_lm.py` holds the port's one
device), in the parameters' placements; AdamW's first moments, the step's
own gradient after clipping times (1 - b1), within the same; each
updated parameter within 1e-6 of the leaf's largest plus what that
gradient gap can move it (AdamW's first step moves an element by about
lr g / (|g| + eps), so by at most 2 lr min(1, tol / |g|) for a gap of
tol), as `tests/test_torch_train_lm.py` holds it.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.launch.spawn import spawn
from repro_torch.models import lm as tlm
from repro_torch.optim.adamw import AdamWConfig
from tests import torch_mesh_ranks as ranks
from tests.test_torch_lm import port_config
from tests.test_torch_mesh_lm import (DATA, JAX_ATOL, JAX_RTOL, OPT,
                                      PORT_TOL, _by_path, _jax_cfg, _routes)
from tests.test_torch_train_lm import _jax_grads

MICROBATCH = 2
# two rows a routed group, so that a split taking other rows together
# routes other groups
BATCH, SEQ = 2 * MICROBATCH * DATA, 16
ARCHS = ("internlm2-1.8b", "deepseek-v2-lite-16b")


def _inputs(cfg, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _groups(cfg):
    """The row groups the mesh's step takes apart: its microbatches, and
    each microbatch's data shards where a MoE routes them on their own."""
    return MICROBATCH * (DATA if _routes(cfg) else 1)


def _jax_refs(cases):
    out = {}
    opt = jadamw.AdamWConfig(**OPT)
    for arch, (cfg, params, batch) in cases.items():
        groups = _groups(cfg)
        state = jstep.TrainState(params, jadamw.init(opt, params),
                                 jnp.int32(0))
        new, m = jax.jit(jstep.make_train_step(cfg, opt, microbatch=groups))(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        out[arch] = {
            "groups": groups,
            "grads": _by_path(_jax_grads(params, batch, cfg, groups)),
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "lr": float(m["lr"]), "params": _by_path(new.params),
            "mu": _by_path(new.opt.mu)}
    return out


@pytest.fixture(scope="module")
def mesh_microbatch():
    """(each rank's results, the JAX references): the spawn runs while
    the test process computes the references."""
    cases, rank_cases = {}, {}
    for seed, arch in enumerate(ARCHS):
        cfg = _jax_cfg(arch)
        tcfg = port_config(cfg)
        p_np = jax.tree.map(lambda x: x.numpy(), tlm.init_model(
            torch.Generator().manual_seed(seed), tcfg, device="cpu"))
        batch = _inputs(cfg, 200 + seed)
        cases[arch] = (cfg, jax.tree.map(jnp.asarray, p_np), batch)
        rank_cases[arch] = (tcfg, AdamWConfig(**OPT), MICROBATCH, p_np, batch)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(spawn, ranks.train_microbatch_2x2, 4,
                              args=(rank_cases,), timeout=600)
        refs = _jax_refs(cases)
        return running.result(), refs


def _within(got, want, tol_of):
    """The paths where ``got`` strays from ``want`` beyond ``tol_of(path,
    want)``, elementwise."""
    assert set(got) == set(want)
    return [p for p, w in want.items()
            if not np.all(np.abs(got[p] - w) <= tol_of(p, w))]


def _grad_tol(_, w):
    return JAX_RTOL * np.abs(w) + JAX_ATOL * float(np.abs(w).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_microbatch_gradients_match_jax(mesh_microbatch, arch):
    results, refs = mesh_microbatch
    want = refs[arch]
    if arch == "deepseek-v2-lite-16b":
        assert want["groups"] == MICROBATCH * DATA
    for rank, out in enumerate(results):
        got = out[arch]
        print(f"rank {rank} {arch}: loss {got['loss']} vs {want['loss']}")
        assert abs(got["loss"] - want["loss"]) < PORT_TOL, (rank, arch)
        assert not _within(got["grads"], want["grads"], _grad_tol), (
            rank, arch)
        assert got["grads_like_params"], (rank, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_microbatch_step_matches_jax(mesh_microbatch, arch):
    results, refs = mesh_microbatch
    want = refs[arch]
    lr = want["lr"]

    def param_tol(path, w):
        g = np.abs(want["grads"][path])
        moved = 2 * lr * np.minimum(1.0, _grad_tol(path, want["grads"][path])
                                    / np.maximum(g, 1e-30))
        return moved + 1e-6 * float(np.abs(w).max())

    for rank, out in enumerate(results):
        got = out[arch]
        print(f"rank {rank} {arch}: step loss {got['step_loss']} vs "
              f"{want['loss']}, grad_norm {got['grad_norm']} vs "
              f"{want['grad_norm']}")
        assert abs(got["step_loss"] - want["loss"]) < PORT_TOL, (rank, arch)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)
        assert got["lr"] == lr
        assert not _within(got["mu"], want["mu"], _grad_tol), (rank, arch)
        assert not _within(got["params"], want["params"], param_tol), (
            rank, arch)
