"""The one-sequence serve path on a mesh of gloo CPU ranks: the batch
whole over the data axes (long_500k's case), so the products of the
weights the port's specs split over them (FSDP) leave those weights in
place (`repro_torch.models.blocks._linear`'s rule,
`repro_torch.parallel.regions.product_plan`): row-parallel over the
data axes with the partial sums reduced, column-parallel with the
columns gathered (inside a layer region by `regions.LocalPlan`), and
the embedding looked up in the table's column blocks.

On the smoke configs of rwkv6-3b (RWKV's time and channel mix),
llama3.2-3b (``attn_shard="sequence"``) and jamba-1.5-large-398b
(Mamba's ``w_in`` / ``w_out``, a MoE) in float32, one sequence of
`torch_mesh_ranks.PROMPT` tokens, prefill + 4 greedy decode steps on a
2 x 2 (data, model) mesh and a 2 x 2 x 2 (pod, data, model) one (two
data axes: one group over both, ranks indexed pod-major): tokens equal
to the JAX package's single device and logits within rtol 1e-4 /
atol 1e-5 (`tests/test_torch_mesh_lm.py`'s tolerance against JAX), and
within 1e-5 of the port's own single device.  Each run takes the
in-place plans (rows, columns, the lookup) and no permute.

The two spawns run one after the other while the test process computes
the JAX references.
"""

import concurrent.futures
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
from tests.test_torch_mesh_lm import (JAX_ATOL, JAX_RTOL, PORT_TOL, _jax_cfg,
                                      _jax_serve)

ARCHS = ("rwkv6-3b", "llama3.2-3b", "jamba-1.5-large-398b")
MESHES = {"2x2": (2, 2), "2x2x2": (2, 2, 2)}


def _spawns(rank_args):
    return {name: spawn(ranks.serve_one_sequence, math.prod(shape),
                        args=(shape, rank_args), timeout=600)
            for name, shape in MESHES.items()}


@pytest.fixture(scope="module")
def one_sequence():
    """(each mesh's rank results, the JAX references by arch)."""
    cases, rank_args = {}, {}
    for seed, arch in enumerate(ARCHS):
        cfg = _jax_cfg(arch)
        tcfg = port_config(cfg)
        p_np = jax.tree.map(lambda x: x.numpy(), tlm.init_model(
            torch.Generator().manual_seed(seed), tcfg, device="cpu"))
        rng = np.random.default_rng(200 + seed)
        batch = {"tokens": rng.integers(0, cfg.vocab, (1, ranks.PROMPT))
                 .astype(np.int32)}
        cases[arch] = (cfg, jax.tree.map(jnp.asarray, p_np), batch)
        rank_args[arch] = (tcfg, p_np, batch)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(_spawns, rank_args)
        refs = {}
        for arch, (cfg, params, batch) in cases.items():
            toks, logits = _jax_serve(cfg, params, batch, [])
            refs[arch] = {"tokens": toks, "logits": logits}
        return running.result(), refs


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_sequence_matches_jax(one_sequence, arch, mesh):
    results, refs = one_sequence
    want = refs[arch]
    for rank, out in enumerate(results[mesh]):
        got = out[arch]
        gap = float(np.abs(got["logits"] - want["logits"]).max())
        print(f"{mesh} rank {rank} {arch}: logit gap to JAX {gap:.3e}")
        assert np.array_equal(got["tokens"], want["tokens"]), (rank, arch)
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   rtol=JAX_RTOL, atol=JAX_ATOL,
                                   err_msg=f"{mesh} rank {rank} {arch}")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_sequence_matches_the_single_device(one_sequence, arch, mesh):
    results, _ = one_sequence
    for rank, out in enumerate(results[mesh]):
        got = out[arch]
        print(f"{mesh} rank {rank} {arch}: logit gap {got['logit_gap']:.3e}, "
              f"plans {got['plans']}")
        assert got["tokens_equal"], (rank, arch)
        assert got["logit_gap"] < PORT_TOL, (rank, arch, got["logit_gap"])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_sequence_leaves_the_weights_in_place(one_sequence, arch, mesh):
    """The run went through the in-place plans the value tests hold."""
    results, _ = one_sequence
    for rank, out in enumerate(results[mesh]):
        plans = out[arch]["plans"]
        for kind in ("rows", "cols", "lookup cols"):
            assert plans.get(kind, 0) > 0, (rank, arch, kind, plans)
        assert "permute" not in plans, (rank, arch, plans)
