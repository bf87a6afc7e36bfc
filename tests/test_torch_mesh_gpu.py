"""The port's mesh on the card: gloo ranks sharing one H100, and NCCL on
one rank.

Marked ``gpu``: each test decides inside itself whether there is a CUDA
device and skips with a reason when there is none.  Run on a machine
with the card (no JAX there, so the JAX conftest is left out):

    python -m pytest --noconftest -q -m gpu tests/test_torch_mesh_gpu.py

NCCL refuses two ranks on one device, so the meshes run as gloo ranks
on cuda:0: gloo's own collectives on CUDA tensors, and the functional
collectives DTensor calls through the port's host staging
(`repro_torch.launch.staging`), each exact.  ``run(shard="chips")`` on 4
ranks is bitwise the one-chip session on the card; the LM smoke configs
on a 2 x 2 mesh give the one-device greedy tokens (logits within 1e-4),
the recurrent mixers each rank on its block of d_inner or WKV heads;
one NCCL rank runs the same path on a 1 x 1 mesh with no staging.
"""

import dataclasses

import pytest
import torch

from repro_torch.interface import Interface, InterfaceConfig
from repro_torch.interface.types import random_connectivity
from repro_torch.launch.spawn import spawn
from repro_torch.noc.topology import NocConfig
import torch_mesh_ranks as ranks

LOGIT_TOL = 1e-4


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the mesh's ranks run there)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gloo_collectives_on_the_card():
    _cuda()
    world = 4
    out = spawn(ranks.gpu_collectives, world, device_id=0, timeout=300)
    xs = [torch.arange(8.0) + r for r in range(world)]
    total = sum(xs)
    for r, o in enumerate(out):
        assert torch.equal(o["all_reduce"], total)
        assert torch.equal(o["all_gather"], torch.cat(xs))
        assert torch.equal(o["reduce_scatter"], total[r * 2:r * 2 + 2])
        assert torch.equal(o["staged_gather"], torch.stack(xs))
        assert torch.equal(o["staged_all_reduce"], total)
        assert o["installed"] and sum(o["staged"].values()) >= 2


@pytest.mark.gpu
def test_chips_mesh_on_the_card_is_bitwise_one_chip():
    dev = _cuda()
    cfg = InterfaceConfig(cores=16, neurons_per_core=64,
                          cam_entries_per_core=128, scheme="hier_tree",
                          noc=NocConfig("multicast_tree"), impl="xla")
    params = random_connectivity(torch.Generator(dev).manual_seed(0), cfg,
                                 device=dev)
    spikes = torch.rand((32, 16, 64), generator=torch.Generator(
        dev).manual_seed(1), device=dev) < 0.05
    spikes[::8] = True
    want_cur, _ = Interface(cfg).compile(params, device=dev).run(spikes)
    four = dataclasses.replace(cfg, chips=4)
    _, one_st = Interface(four).compile(params, device=dev).run(
        spikes, shard="chips")
    out = spawn(ranks.gpu_chips, 4, device_id=0, timeout=300,
                args=(four, tuple(t.cpu() for t in params), spikes.cpu()))
    for cur, st, body in out:
        assert body == "mesh"
        assert torch.equal(cur, want_cur.cpu())
        for f, v in st.items():
            assert torch.equal(v, getattr(one_st, f).cpu()), f


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "llama3.2-3b",
                                  "deepseek-v2-lite-16b"])
def test_lm_mesh_on_the_card_matches_one_device(arch):
    _cuda()
    for o in spawn(ranks.gpu_lm, 4, device_id=0, timeout=300, args=(arch,)):
        assert o["backend"] == "gloo"
        assert o["tokens_equal"]
        assert o["logit_gap"] < LOGIT_TOL, o["logit_gap"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,over,width", [
    ("rwkv6-3b", {}, ("wkv", 4)),
    ("rwkv6-3b", {"rwkv_pad_heads": 8}, ("wkv", 4)),
    ("jamba-1.5-large-398b", {}, ("mamba_scan", 64))])
def test_mixers_mesh_on_the_card_match_one_device(arch, over, width):
    """The recurrent mixers on their tensor-parallel layout (Mamba's
    d_inner and RWKV's padded WKV heads split over ``model``, the channel
    mix column/row-parallel) on the card: greedy tokens and logits as
    one device, each rank on its own block."""
    _cuda()
    for o in spawn(ranks.gpu_lm, 4, device_id=0, timeout=300,
                   args=(arch, (2, 2), over)):
        assert o["tokens_equal"]
        assert o["logit_gap"] < LOGIT_TOL, o["logit_gap"]
        assert {w for w in o["widths"] if w[0] == width[0]} == {width}


@pytest.mark.gpu
def test_nccl_one_rank_mesh():
    _cuda()
    o = spawn(ranks.gpu_lm, 1, backend="nccl", device_id=0, timeout=300,
              args=("internlm2-1.8b", (1, 1)))[0]
    assert o["backend"] == "nccl"
    assert o["tokens_equal"] and o["logit_gap"] < LOGIT_TOL
