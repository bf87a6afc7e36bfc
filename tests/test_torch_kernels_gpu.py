"""The CUDA kernels against their plain torch versions, on the card.

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
from repro_torch.kernels.cam_search import kernel as cam_kernel
from repro_torch.kernels.cam_search import ops as cam_ops
from repro_torch.kernels.cam_search import ref as cam_ref
from repro_torch.kernels.hat_encode import kernel as hat_kernel
from repro_torch.kernels.hat_encode import ops as hat_ops
from repro_torch.kernels.hat_encode import ref as hat_ref
from repro_torch.kernels.lif_step import kernel as lif_kernel
from repro_torch.kernels.lif_step import ops as lif_ops
from repro_torch.kernels.lif_step import ref as lif_ref
from repro_torch.kernels.moe_dispatch import kernel as moe_kernel
from repro_torch.kernels.moe_dispatch import ops as moe_ops
from repro_torch.kernels.moe_dispatch import ref as moe_ref
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


# ---- cam_search (B2) ----------------------------------------------------------


def _tags(rng, rows, bits, device):
    return cam_ref.pack_bits(torch.from_numpy(
        rng.random((rows, bits)) < 0.5)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("b,e,bits", [(1000, 777, 12), (96, 100, 40),
                                      (256, 384, 70), (33, 5, 200)])
def test_cam_search_kernel_matches_plain_version(b, e, bits):
    device = _cuda()
    rng = np.random.default_rng(b + e)
    t = _tags(rng, e, bits, device)
    q = _tags(rng, b, bits, device)
    q[: min(b, e) // 2] = t[: min(b, e) // 2]           # force matches
    valid = torch.from_numpy(rng.random(e) < 0.9).to(device)
    before = cam_kernel.launches
    got = cam_kernel.cam_search_cuda(q, t, valid)
    torch.cuda.synchronize()
    assert cam_kernel.launches == before + 1
    want = cam_ref.cam_search_ref(q, t, valid)
    assert torch.equal(got, want) and int(want.sum()) > 0
    assert torch.equal(cam_ref.first_match_ref(got),
                       cam_ref.first_match_ref(want))


@pytest.mark.gpu
@pytest.mark.parametrize("b,e,bits,lanes", [(8192, 4096, 12, 1),
                                            (8192, 4096, 12, 3),
                                            (1000, 777, 40, 2),
                                            (64, 3000, 150, 1)])
def test_cam_match_counts_kernel_matches_plain_version(b, e, bits, lanes):
    device = _cuda()
    rng = np.random.default_rng(b * lanes)
    t = _tags(rng, e, bits, device)
    q = torch.cat([t, _tags(rng, b, bits, device)])[:b].contiguous()
    valid = torch.from_numpy(rng.random((lanes, e)) < 0.3).to(device)
    before = cam_kernel.launches
    got = cam_ops.cam_match_counts(q, t, valid, impl="pallas")
    torch.cuda.synchronize()
    assert cam_kernel.launches == before + 1
    want = cam_ref.match_counts_ref(q, t, valid)
    assert torch.equal(got, want) and int(want.sum()) > 0


@pytest.mark.gpu
def test_cam_ops_on_cuda_launch_and_keep_the_block_rule():
    device = _cuda()
    rng = np.random.default_rng(0)
    t = _tags(rng, 256, 44, device)
    q = t[:128].contiguous()
    valid = torch.ones(256, dtype=torch.bool, device=device)
    before = cam_kernel.launches
    first = cam_ops.cam_first_match(q, t, valid, impl="pallas")
    spec = cam_ops.cam_search_speculative(q, t, valid, impl="pallas")
    assert cam_kernel.launches == before + 3
    assert torch.equal(first, cam_ref.first_match_ref(
        cam_ref.cam_search_ref(q, t, valid)))
    assert torch.equal(spec, cam_ref.cam_search_ref(q, t, valid))
    with pytest.raises(ValueError, match="must divide block sizes"):
        cam_ops.cam_search(q, t[:200].contiguous(), valid[:200],
                           impl="pallas")


# ---- hat_encode (B3) ----------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n,row", [(16, 256, 256), (48, 256, 256),
                                        (4, 512, 256), (2, 65536, 256),
                                        (3, 4096, 128), (5, 300, 1)])
@pytest.mark.parametrize("rate", [0.0, 0.05, 0.5, 1.0])
def test_hat_encode_kernel_matches_plain_version(rows, n, row, rate):
    device = _cuda()
    rng = np.random.default_rng(rows + n)
    spikes = torch.from_numpy(rng.random((rows, n)) < rate).to(device)
    before = hat_kernel.launches
    ranks, count, clusters, stream = hat_kernel.hat_encode_cuda(
        spikes, row=row, stream=True)
    torch.cuda.synchronize()
    assert hat_kernel.launches == before + 1
    want = hat_ref.hat_encode_ref(spikes, row=row)
    for g, w in zip((ranks, count, clusters), want):
        assert torch.equal(g, w)
    assert torch.equal(stream, hat_ref.compact_stream(*want[:2]))


@pytest.mark.gpu
def test_hat_ops_on_cuda_launch_once_per_call():
    device = _cuda()
    spikes = torch.rand((2, 16, 256), device=device) < 0.05
    before = hat_kernel.launches
    stream, count = hat_ops.encode_stream(spikes, impl="pallas")
    ranks, _, _ = hat_ops.hat_encode(spikes, impl="pallas")
    assert hat_kernel.launches == before + 2
    want = hat_ref.hat_encode_ref(spikes)
    assert torch.equal(ranks, want[0]) and torch.equal(count, want[1])
    assert torch.equal(stream, hat_ref.compact_stream(*want[:2]))
    with pytest.raises(ValueError, match="N % 256 == 0"):
        hat_ops.hat_encode(spikes[..., :100], impl="pallas")


# ---- lif_step (B4) ------------------------------------------------------------


def _lif_state(shape, seed, threshold, device):
    """N(0, 3^2) v and I; a sixty-fourth of the elements land exactly on
    the threshold (v = 0, I = threshold)."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(shape) * 3).astype(np.float32)
    i = (rng.standard_normal(shape) * 3).astype(np.float32)
    at = rng.random(shape) < 1 / 64
    v[at], i[at] = 0.0, np.float32(threshold)
    return torch.from_numpy(v).to(device), torch.from_numpy(i).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(128, 4096), (8, 512), (32, 128),
                                   (3, 5), (1, 4099)])
@pytest.mark.parametrize("decay,threshold,v_reset", [(0.9, 1.0, 0.0),
                                                     (0.7, 0.3, -0.25)])
def test_lif_step_kernel_matches_plain_version(shape, decay, threshold,
                                               v_reset):
    device = _cuda()
    v, i = _lif_state(shape, sum(shape), threshold, device)
    before = lif_kernel.launches
    got = lif_kernel.lif_step_cuda(v, i, decay, threshold, v_reset)
    torch.cuda.synchronize()
    assert lif_kernel.launches == before + 1
    want = lif_ref.lif_step_ref(v, i, decay=decay, threshold=threshold,
                                v_reset=v_reset)
    for g, w in zip(got, want):                    # bitwise
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert 0 < int(got[1].sum()) < got[1].numel()
    # the unaligned scalar path: a view one float past a 16-byte boundary
    flat_v, flat_i = v.reshape(-1)[1:], i.reshape(-1)[1:]
    got = lif_kernel.lif_step_cuda(flat_v, flat_i, decay, threshold, v_reset)
    want = lif_ref.lif_step_ref(flat_v, flat_i, decay=decay,
                                threshold=threshold, v_reset=v_reset)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.gpu
def test_lif_ops_on_cuda_launch_and_keep_the_block_rule():
    device = _cuda()
    v, i = _lif_state((16, 1024), 3, 1.0, device)
    before = lif_kernel.launches
    got = lif_ops.lif_step(v, i, decay=0.9, threshold=1.0, impl="pallas")
    assert lif_kernel.launches == before + 1
    want = lif_ops.lif_step(v, i, decay=0.9, threshold=1.0, impl="xla")
    assert lif_kernel.launches == before + 1       # xla: the plain version
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="must divide blocks"):
        lif_ops.lif_step(v[:12], i[:12], decay=0.9, threshold=1.0,
                         impl="pallas")
    with pytest.raises(RuntimeError, match="no backward"):
        lif_kernel.lif_step_cuda(v.requires_grad_(), i, 0.9, 1.0)
    assert lif_kernel.launches == before + 1


# ---- moe_dispatch (B5) --------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("m,e", [(256, 16), (2048, 160), (512, 64),
                                 (4096, 128), (3072, 64), (256, 64),
                                 (1000, 7), (70000, 64), (4096, 20000)])
@pytest.mark.parametrize("stream", ["uniform", "one_expert", "padded"])
def test_moe_dispatch_kernel_matches_plain_version(m, e, stream):
    device = _cuda()
    rng = np.random.default_rng(m + e)
    ids = rng.integers(0, e, m).astype(np.int32)
    if stream == "one_expert":
        ids[:] = e - 1
    elif stream == "padded":             # the router's pad, and stray ids
        ids[m // 2:] = e
        ids[::29] = -3
    ids = torch.from_numpy(ids).to(device)
    before = moe_kernel.launches
    got = moe_kernel.dispatch_positions_cuda(ids, e)
    torch.cuda.synchronize()
    assert moe_kernel.launches == before + 1
    want = moe_ref.dispatch_positions_ref(ids, e)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_moe_dispatch_ops_on_cuda_launch_and_keep_the_row_rule():
    device = _cuda()
    ids = torch.randint(0, 64, (3072,), device=device, dtype=torch.int32)
    before = moe_kernel.launches
    got = moe_ops.dispatch_positions(ids, num_experts=64, impl="pallas")
    assert moe_kernel.launches == before + 1
    want = moe_ops.dispatch_positions(ids, num_experts=64, impl="xla")
    assert moe_kernel.launches == before + 1       # xla: the plain version
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="multiple of row=256"):
        moe_ops.dispatch_positions(ids[:300], num_experts=64, impl="pallas")
    with pytest.raises(ValueError, match="must lie in"):
        moe_kernel.dispatch_positions_cuda(ids, 0)
    assert moe_kernel.launches == before + 1
