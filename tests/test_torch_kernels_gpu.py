"""The CUDA sparse tick kernel against its plain torch version, on the card.

Marked ``gpu``: each test decides inside itself whether there is a CUDA
device and skips with a reason when there is none.  Run on a machine
with the card (no JAX needed there, so the JAX conftest is left out):

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import arbiter as arb
from repro_torch.interface import InterfaceConfig, pipeline
from repro_torch.interface.types import random_connectivity
from repro_torch.kernels.sparse_tick import kernel as sparse_kernel
from repro_torch.kernels.sparse_tick import ops as sparse_ops
from repro_torch.kernels.sparse_tick import ref as sparse_ref

SCHEMES = ("binary_tree", "greedy_tree", "token_ring", "hier_ring",
           "hier_tree")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _operands(scheme, cores, n, entries, lanes, p, seed, device):
    cfg = InterfaceConfig(cores=cores, neurons_per_core=n,
                          cam_entries_per_core=entries, scheme=scheme,
                          impl="pallas_sparse")
    gen = torch.Generator().manual_seed(seed)
    params = random_connectivity(gen, cfg).to(device)
    routing = pipeline.build_routing_index(params, cfg)
    policy, _, capacity = pipeline.resolve_sparse_plan(
        cfg, arb.ArbiterConfig(scheme, n))
    rng = np.random.default_rng(seed)
    spikes = torch.from_numpy(rng.random((lanes, cores, n)) < p).to(device)
    # keep every core within capacity, as the session guarantees
    keep = spikes.to(torch.int32).cumsum(-1) <= capacity
    spikes = spikes & keep
    buf, counts = sparse_ops.compact_events(spikes, capacity)
    args = (spikes.reshape(lanes, -1), buf, counts, routing.src_idx,
            routing.active, params.weights, routing.csr)
    return args, policy, n


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("cores,lanes", [(16, 1), (64, 1), (16, 3)])
def test_kernel_matches_plain_version(scheme, cores, lanes):
    device = _cuda()
    args, policy, n = _operands(scheme, cores, 256, 512, lanes, 0.05, 7,
                                device)
    before = sparse_kernel.launches
    got = sparse_kernel.sparse_tick_cuda(
        *args, n=n, policy=policy.kernel_policy, levels=policy.levels)
    torch.cuda.synchronize()
    assert sparse_kernel.launches == before + 1
    want = sparse_ref.sparse_tick_ref(*args, n=n,
                                      latency_fn=policy.latency_fn,
                                      encode_fn=policy.encode_fn)
    for name, g, w in zip(("currents", "latency", "encode", "hits"), got,
                          want):
        assert torch.equal(g, w), name


@pytest.mark.gpu
def test_cuda_dispatch_launches_kernel_and_never_falls_back():
    device = _cuda()
    args, policy, n = _operands("hier_tree", 16, 256, 512, 1, 0.05, 3,
                                device)
    before = sparse_kernel.launches
    sparse_ops.sparse_tick(*args, n=n, policy=policy)
    assert sparse_kernel.launches == before + 1
    with pytest.raises(ValueError):
        sparse_ops.sparse_tick(*args, n=n,
                               policy=policy._replace(kernel_policy=None))
