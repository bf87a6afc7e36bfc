"""The mesh train step's loss on logits split along the vocab, against
the JAX package's `cross_entropy`.

`repro_torch.train.step._cross_entropy_sharded` takes the logits as
`repro_torch.models.lm._head` places them: the batch over ``data`` and,
where the vocab divides the model axis, the vocab over ``model``.  There
each rank combines its block's max, its sum of exponentials and its gold
logit over ``model``, and the gradient of its block is its own part of
``softmax - one_hot``: no rank holds the whole vocab (GSPMD's partition
of JAX's ``logsumexp`` and ``take_along_axis``).  Where the vocab does
not divide, the logits are whole on each rank, as JAX keeps hubert's 504.

- On 4 gloo CPU ranks (2 x 2), numpy logits and labels from a seed, with
  ``-100`` labels, labels on the edges of the vocab blocks and a
  ``loss_mask``, at a vocab that divides ``model`` and at one that does
  not: the loss within rtol 1e-5 of `repro.train.step.cross_entropy`,
  the logits' gradient within rtol 1e-4 / atol 1e-5 of the largest of
  ``jax.grad`` of it (the gradient tolerance of
  `tests/test_torch_train_lm.py`), in the logits' own placements.
- The dry run's per-device pass of a smoke train step (internlm2-1.8b's
  smoke config at a vocab of 1,000, 2 x 4, rank 0 of a fake process
  group): no collective takes or gives a tensor with a dim of the whole
  vocab, and the loss makes its two all-reduces of the rank's positions.
- The same pass on a fake 2 x 8 mesh at a vocab of 1,024 and 2,048: the
  peak grows by at most `PEAK_SHARDS` times one rank's vocab block of
  the logits for the added vocab (float32), where gathering the vocab
  whole would add at least 8 times it for each whole-vocab tensor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import step as jstep
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshSpec, fake_mesh
from repro_torch.launch.spawn import spawn
from repro_torch.parallel import sharding as shd
from tests import torch_mesh_ranks as ranks

BATCH, SEQ = 4, 12
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# (vocab, with a loss_mask): 64 divides the model axis of 2, 63 does not
CASES = {"v64_mask": (64, True), "v64": (64, False), "v63_mask": (63, True)}
# the peak's growth from a vocab of 1,024 to 2,048, in one rank's vocab
# blocks of the float32 logits for the added 1,024: the logits, their
# gradient and the step's temporaries of the loss, a few blocks
PEAK_SHARDS = 6


def _case(vocab, with_mask, seed):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((BATCH, SEQ, vocab))).astype(
        np.float32)
    labels = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
    half = vocab // 2
    # the edges of the model ranks' vocab blocks, and ignored positions
    labels[0, :4] = [0, half - 1, half, vocab - 1]
    labels[1, :3] = -100
    labels[3, -2:] = -100
    mask = None
    if with_mask:
        mask = (rng.random((BATCH, SEQ)) > 0.25).astype(np.int32)
        mask[2, :2] = 0
    return logits, labels, mask


@pytest.fixture(scope="module")
def mesh_losses():
    cases = {name: _case(v, m, seed)
             for seed, (name, (v, m)) in enumerate(CASES.items())}
    got = spawn(ranks.vocab_loss_2x2, 4, args=(cases,), timeout=300)[0]
    return cases, got


def _jax_loss_and_grad(logits, labels, mask):
    fn = (lambda x: jstep.cross_entropy(x, jnp.asarray(labels),
                                        None if mask is None
                                        else jnp.asarray(mask)))
    loss, grad = jax.value_and_grad(fn)(jnp.asarray(logits))
    return float(loss), np.asarray(grad)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(mesh_losses, name):
    cases, got = mesh_losses
    want, _ = _jax_loss_and_grad(*cases[name])
    assert abs(got[name][0] - want) <= LOSS_RTOL * abs(want), (
        got[name][0], want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_logit_gradient_matches_jax(mesh_losses, name):
    cases, got = mesh_losses
    _, want = _jax_loss_and_grad(*cases[name])
    grad = got[name][1]
    tol = GRAD_RTOL * np.abs(want) + GRAD_ATOL * float(np.abs(want).max())
    assert np.all(np.abs(grad - want) <= tol), float(
        np.abs(grad - want).max())
    # ignored positions get no gradient
    logits, labels, mask = cases[name]
    ignored = labels < 0 if mask is None else (labels < 0) | (mask == 0)
    assert np.all(grad[ignored] == 0.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_logit_gradient_keeps_the_logits_placement(mesh_losses, name):
    cases, got = mesh_losses
    vocab = cases[name][0].shape[-1]
    _, _, x_pl, g_pl, local = got[name]
    assert g_pl == x_pl
    split = vocab % 2 == 0
    assert x_pl == [0, 2 if split else "Replicate"]
    assert local == (BATCH // 2, SEQ, vocab // 2 if split else vocab)


def _smoke(vocab):
    return dataclasses.replace(configs.get_smoke_config("internlm2-1.8b"),
                               vocab=vocab)


def _recording_mode():
    """A dispatch mode that records the shapes of every tensor each
    functional collective takes and gives, on this rank, in ``.calls``
    (DTensor ops are handed back to DTensor, whose local ops come back
    here, as the dry run's `CostMode` does)."""
    from torch.distributed._functional_collectives import (
        AsyncCollectiveTensor)
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Recorded(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, (DTensor, AsyncCollectiveTensor))
                   for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if func.namespace == "_c10d_functional":
                self.calls.append((func.__name__, [
                    tuple(t.shape) for t in tree_leaves((args, out))
                    if isinstance(t, torch.Tensor)]))
            return out
    return Recorded()


def _train_collectives(cfg, shape, mesh_spec):
    """Each functional collective of the cell's train step as rank 0 of
    a fake process group: (op, the shapes it takes and gives)."""
    with fake_mesh(mesh_spec) as mesh:
        ctx = shd.make_shard_ctx(mesh, cfg)
        params, p_specs, batch, b_specs, _, _ = dryrun._operands(cfg, shape,
                                                                 ctx)
        params = shd.shard_tree(params, p_specs, mesh)
        batch = shd.shard_tree(batch, b_specs, mesh)
        step, _ = dryrun.cell_step(cfg, "train", ctx, params, batch)
        mode = _recording_mode()
        with dryrun._propagation_unseen(), mode:
            step()
    return mode.calls


def test_no_collective_moves_the_whole_vocab():
    vocab, batch, seq = 1000, 4, 24
    calls = _train_collectives(_smoke(vocab),
                               configs.Shape("train_t", seq, batch, "train"),
                               MeshSpec((2, 4), ("data", "model")))
    whole = [(op, shapes) for op, shapes in calls
             if any(vocab in s for s in shapes)]
    assert not whole, whole[:4]
    # the loss's two all-reduces over model, of this rank's positions:
    # the max, then the sums of exponentials and the gold logits
    rows = (batch // 2, seq)
    loss = [shapes[0] for op, shapes in calls
            if op.startswith("all_reduce") and shapes[0] in (rows,
                                                            (2,) + rows)]
    assert loss == [rows, (2,) + rows]


def test_doubling_the_vocab_adds_a_few_vocab_blocks_to_the_peak():
    shape = configs.Shape("train_t", 256, 4, "train")
    mesh = MeshSpec((2, 8), ("data", "model"))
    peak = {v: dryrun.per_device_costs(_smoke(v), shape,
                                       mesh)["memory"]["peak_bytes"]
            for v in (1024, 2048)}
    block = (4 // 2) * 256 * (1024 // 8) * 4
    grown = peak[2048] - peak[1024]
    assert 0 < grown <= PEAK_SHARDS * block, (grown, grown / block)
