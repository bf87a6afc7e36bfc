"""The train step's collectives over ``("pod", "data")`` in one call,
held by the dry run (`repro_torch.launch.dryrun`, a fake rank of the
mesh's world size) on a (pod, data, model) = 2 x 4 x 4 mesh, the smoke
configs of internlm2-1.8b, rwkv6-3b and deepseek-v2-lite-16b at a
16-sequence, 16-token train step:

- no DTensor redistribution runs as sequential collectives over the
  data axes (`tools/dryrun_sequential.py`'s record at 2 repeats): every
  FSDP weight is gathered in one all-gather over the 8 ranks of
  ``("pod", "data")`` and its gradient reduce-scattered in one call
  (`regions.gather_data`), a replicated leaf's gradient summed in one
  all-reduce there (`regions.reduce_data`);
- the all-gathers and reduce-scatters, calls and bytes, equal the 8 x 4
  mesh's, ``pod`` folded into ``data``: the same weights move the same
  bytes (DTensor's gather over each axis in turn moved 1.5 times them
  on 2 x 16 x 16);
- against JAX's dry run of the same cell (`repro.launch.dryrun` in one
  subprocess; `tests/test_torch_dryrun_costs.py` ``_jax_dry_runs``):
  the all-gather bytes within 1.25 times JAX's, and the collective
  total within 1.25 times JAX's (GSPMD all-reduces the gradients where
  the port reduce-scatters them, so the reductions compare in total);
- a fake rank's calls, bytes by op and FLOPs equal a real gloo rank's
  on 2 x 2 x 2, for rwkv6-3b (`tests/torch_mesh_ranks.py`
  ``dryrun_costs_2x2``).
"""

import concurrent.futures
import multiprocessing

import pytest

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.spawn import spawn
from tests import torch_mesh_ranks as ranks
from tests.test_torch_dryrun_costs import _jax_dry_runs

BOUND = 1.25
ARCHS = ("internlm2-1.8b", "rwkv6-3b", "deepseek-v2-lite-16b")
SEQ, BATCH = 16, 16
SHAPE = configs.Shape(f"train_{SEQ}x{BATCH}", SEQ, BATCH, "train")
MESH = MeshSpec((2, 4, 4), ("pod", "data", "model"))
FOLDED = MeshSpec((8, 4), ("data", "model"))
REAL = (2, 2, 2)
REAL_ARCH = "rwkv6-3b"
MOVES = ("all-gather", "reduce-scatter")


def _cfg(arch):
    return configs.get_smoke_config(arch)


@pytest.fixture(scope="module")
def runs():
    """(the port's fake-rank records by arch, `torch_mesh_ranks`
    ``dryrun_train_cell``; JAX's records by arch; a real 2 x 2 x 2 rank
    0's record of `REAL_ARCH`): each arch's fake passes in a process
    of its own and the gloo ranks while the JAX dry run's subprocess
    lowers the three cells (about a minute in all)."""
    with concurrent.futures.ProcessPoolExecutor(
            len(ARCHS), mp_context=multiprocessing.get_context("spawn")
    ) as procs, concurrent.futures.ThreadPoolExecutor(1) as threads:
        port = {arch: procs.submit(ranks.dryrun_train_cell, _cfg(arch),
                                   SHAPE, MESH, FOLDED) for arch in ARCHS}
        real = threads.submit(spawn, ranks.dryrun_costs_2x2, 8,
                              args=({REAL_ARCH: (_cfg(REAL_ARCH), SHAPE,
                                                 {})}, REAL), timeout=300)
        jax_recs = _jax_dry_runs([(arch, "train", SEQ, BATCH,
                                   list(MESH.shape), {}) for arch in ARCHS])
        return ({arch: f.result() for arch, f in port.items()},
                dict(zip(ARCHS, jax_recs)), real.result()[0][REAL_ARCH])


@pytest.mark.parametrize("arch", ARCHS)
def test_no_redistribution_runs_sequentially(runs, arch):
    found = runs[0][arch]["sequential"]
    print(f"{arch}: {found}")
    assert found == "none", found


@pytest.mark.parametrize("arch", ARCHS)
def test_moves_equal_the_folded_mesh(runs, arch):
    pods, folded = runs[0][arch]["repeats"], runs[0][arch]["folded"]
    for field in ("collectives", "collective_counts"):
        got = {op: pods[field].get(op, 0) for op in MOVES}
        want = {op: folded[field].get(op, 0) for op in MOVES}
        print(f"{arch} {field}: 2 x 4 x 4 {got}, 8 x 4 {want}")
        assert got == want, (arch, field)
        assert all(want.values()), (arch, field)


@pytest.mark.parametrize("arch", ARCHS)
def test_within_the_bound_of_jax(runs, arch):
    got = runs[0][arch]["calibrated"]
    want = runs[1][arch]["cal"]["collectives"]
    print(f"{arch}: port {got}, JAX {want}")
    assert 0 < got["all-gather"] <= BOUND * want["all-gather"], arch
    assert 0 < got["total"] <= BOUND * want["total"], arch


def test_fake_rank_equals_a_real_gloo_rank(runs):
    real = runs[2]
    fake = dryrun.per_device_costs(_cfg(REAL_ARCH), SHAPE,
                                   MeshSpec(REAL, ("pod", "data", "model")))
    for field in ("collective_counts", "collectives"):
        assert fake[field] == real[field], field
    assert fake["cost"]["flops"] == real["cost"]["flops"]
    assert real["collective_counts"]["reduce-scatter"] > 0
