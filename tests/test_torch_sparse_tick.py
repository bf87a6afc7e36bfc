"""The PyTorch port's sparse tick against the JAX package's.

Inputs are numpy arrays made from a seed and handed to both packages; the
JAX side runs the fused Pallas kernel in interpret mode on the CPU, as its
own tests do.  Covered: the event compaction and event indices, the plain
torch `sparse_tick_ref` against `repro.kernels.sparse_tick.ops.sparse_tick`
(impl="pallas") for every arbiter scheme, the deterministic CSR scatter
against JAX's ascending-entry scatter-add, and the dispatch layer: CPU
tensors take the plain version, the CUDA wrapper refuses them, shape
guards raise, and no kernel build is triggered by importing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arbiter as jarb
from repro.interface import registry as jregistry
from repro.kernels.sparse_tick import ops as jsparse_ops
from repro_torch.core import arbiter as tarb
from repro_torch.interface import InterfaceConfig, pipeline as tpipeline
from repro_torch.interface.types import params_from_numpy
from repro_torch.kernels import build
from repro_torch.kernels.sparse_tick import kernel as sparse_kernel
from repro_torch.kernels.sparse_tick import ops as tsparse_ops
from repro_torch.kernels.sparse_tick import ref as tsparse_ref

SCHEMES = ("binary_tree", "greedy_tree", "token_ring", "hier_ring",
           "hier_tree")


def _frames(rng, lanes, cores, n, p, capacity):
    """Lanes of Bernoulli frames, each core cut to ``capacity`` events,
    with an empty core and a core exactly at capacity."""
    frames = rng.random((lanes, cores, n)) < p
    frames &= np.cumsum(frames, axis=-1) <= capacity
    frames[0, 0] = False
    frames[-1, -1] = False
    frames[-1, -1, rng.choice(n, capacity, replace=False)] = True
    return frames


def _params(rng, cores, n, entries):
    """Routing operands as numpy: many entries share each target."""
    total = cores * n
    src = rng.integers(0, total + 3, (cores, entries))     # some out of range
    tag_bits = max(1, int(np.ceil(np.log2(total))))
    tags = (src[..., None] >> np.arange(tag_bits - 1, -1, -1)) & 1
    valid = rng.random((cores, entries)) < 0.85
    weights = (rng.standard_normal((cores, entries)) * 0.5 + 1.0).astype(
        np.float32)
    targets = rng.integers(0, n, (cores, entries)).astype(np.int32)
    return tags.astype(np.int32), valid, weights, targets


# ---- compaction ------------------------------------------------------------------

@pytest.mark.parametrize("cores,n,capacity,p", [(4, 16, 8, 0.3),
                                                 (3, 64, 8, 0.5),
                                                 (2, 256, 32, 0.05)])
def test_compaction_and_event_indices_are_equal(cores, n, capacity, p):
    rng = np.random.default_rng(n)
    frames = rng.random((3, cores, n)) < p
    frames[1] = True                                        # every core overflows
    frames[2, 0] = False
    for frame in frames:
        jbuf, jcounts = jsparse_ops.compact_events(jnp.asarray(frame), capacity)
        tbuf, tcounts = tsparse_ops.compact_events(torch.from_numpy(frame),
                                                   capacity)
        np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
        np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
        jidx, jw = jsparse_ops.event_indices(jbuf, n)
        tidx, tw = tsparse_ops.event_indices(tbuf, n)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    # a leading batch axis compacts every lane alike
    tbuf, tcounts = tsparse_ops.compact_events(torch.from_numpy(frames),
                                               capacity)
    for lane, frame in enumerate(frames):
        jbuf, jcounts = jsparse_ops.compact_events(jnp.asarray(frame), capacity)
        np.testing.assert_array_equal(tbuf[lane].numpy(), np.asarray(jbuf))
        np.testing.assert_array_equal(tcounts[lane].numpy(),
                                      np.asarray(jcounts))


# ---- the fused tick against the Pallas kernel -------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("cores,n,entries", [(4, 16, 32), (3, 64, 48)])
def test_sparse_tick_ref_matches_the_pallas_kernel(scheme, cores, n, entries):
    rng = np.random.default_rng(cores * n + len(scheme))
    tags, valid, weights, targets = _params(rng, cores, n, entries)
    cfg = InterfaceConfig(cores=cores, neurons_per_core=n,
                          cam_entries_per_core=entries, scheme=scheme,
                          impl="pallas_sparse")
    tparams = params_from_numpy(tags, valid, weights, targets)
    routing = tpipeline.build_routing_index(tparams, cfg)
    policy, _, capacity = tpipeline.resolve_sparse_plan(cfg)
    frames = _frames(rng, 3, cores, n, 0.2, capacity)

    tspikes = torch.from_numpy(frames)
    tbuf, tcounts = tsparse_ops.compact_events(tspikes, capacity)
    got = tsparse_ops.sparse_tick(
        tspikes.reshape(3, -1), tbuf, tcounts, routing.src_idx,
        routing.active, tparams.weights, routing.csr, n=n, policy=policy)

    jctx = jarb.make_context(jarb.ArbiterConfig(scheme, n))
    jentry = jregistry.get_arbiter(scheme)
    src_idx = jnp.asarray(routing.src_idx.numpy())
    active = jnp.asarray(routing.active.numpy())
    for lane, frame in enumerate(frames):
        jbuf, jcounts = jsparse_ops.compact_events(jnp.asarray(frame), capacity)
        want = jsparse_ops.sparse_tick(
            jnp.asarray(frame.reshape(-1)), jbuf, jcounts, src_idx, active,
            jnp.asarray(weights), jnp.asarray(targets), n=n,
            latency_fn=jentry.sparse_tick_latency(jctx),
            encode_fn=jentry.sparse_encode_energy(jctx), impl="pallas",
            interpret=True)
        for name, g, w in zip(("currents", "latency", "encode", "hits"),
                              got, want):
            np.testing.assert_array_equal(g[lane].numpy(), np.asarray(w),
                                          err_msg=f"{scheme} lane {lane} {name}")


@pytest.mark.parametrize("seed", range(4))
def test_csr_scatter_sums_in_the_jax_order(seed):
    rng = np.random.default_rng(seed)
    cores, n, entries = 3, 8, 200                        # ~25 entries a target
    _, valid, weights, targets = _params(rng, cores, n, entries)
    drive = rng.random((cores, entries)) < 0.7
    contrib = (drive * weights).astype(np.float32)
    csr = tsparse_ref.build_target_csr(torch.from_numpy(targets),
                                       torch.from_numpy(valid), n)
    got = tsparse_ref.scatter_currents(
        torch.from_numpy(contrib * valid)[None], csr, n)[0]
    want = jax.vmap(lambda c, t: jnp.zeros((n,), jnp.float32).at[t].add(c))(
        jnp.asarray(contrib * valid), jnp.asarray(targets))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_target_csr_groups_live_entries_in_ascending_order():
    rng = np.random.default_rng(5)
    cores, n, entries = 4, 16, 40
    _, valid, _, targets = _params(rng, cores, n, entries)
    csr = tsparse_ref.build_target_csr(torch.from_numpy(targets),
                                       torch.from_numpy(valid), n)
    ptr, entry = csr.ptr.numpy(), csr.entry.numpy()
    assert ptr[0] == 0 and ptr[-1] == entry.size == valid.sum()
    for g in range(cores * n):
        c, t = divmod(g, n)
        want = [c * entries + e for e in range(entries)
                if valid[c, e] and targets[c, e] == t]
        assert list(entry[ptr[g]:ptr[g + 1]]) == want
        row = csr.gather[g].numpy()
        assert list(row[: len(want)]) == want
        assert (row[len(want):] == cores * entries).all()   # the 0.0 pad


# ---- dispatch ------------------------------------------------------------------

def _small_operands(scheme="hier_tree"):
    rng = np.random.default_rng(11)
    cfg = InterfaceConfig(cores=4, neurons_per_core=16,
                          cam_entries_per_core=32, scheme=scheme,
                          impl="pallas_sparse")
    params = params_from_numpy(*_params(rng, 4, 16, 32))
    routing = tpipeline.build_routing_index(params, cfg)
    policy, _, capacity = tpipeline.resolve_sparse_plan(cfg)
    spikes = torch.from_numpy(_frames(rng, 2, 4, 16, 0.2, capacity))
    buf, counts = tsparse_ops.compact_events(spikes, capacity)
    args = [spikes.reshape(2, -1), buf, counts, routing.src_idx,
            routing.active, params.weights, routing.csr]
    return args, policy


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    args, policy = _small_operands()
    before = sparse_kernel.launches
    got = tsparse_ops.sparse_tick(*args, n=16, policy=policy)
    want = tsparse_ref.sparse_tick_ref(*args, n=16,
                                       latency_fn=policy.latency_fn,
                                       encode_fn=policy.encode_fn)
    assert sparse_kernel.launches == before
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert torch.equal(got[3], want[3].sum(-1))


def test_cuda_wrapper_refuses_cpu_tensors():
    args, policy = _small_operands()
    before = sparse_kernel.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        sparse_kernel.sparse_tick_cuda(*args, n=16,
                                       policy=policy.kernel_policy,
                                       levels=policy.levels)
    assert sparse_kernel.launches == before


@pytest.mark.parametrize("broken", ["buf_rank", "buf_cores", "spikes",
                                    "weights"])
def test_shape_guards_raise(broken):
    args, policy = _small_operands()
    if broken == "buf_rank":
        args[1] = args[1][0]
    elif broken == "buf_cores":
        args[1] = args[1][:, :3]
    elif broken == "spikes":
        args[0] = args[0][:, :-1]
    else:
        args[5] = args[5][:, :-1]
    with pytest.raises(ValueError):
        tsparse_ops.sparse_tick(*args, n=16, policy=policy)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_every_scheme_has_a_kernel_branch(scheme):
    cfg = InterfaceConfig(cores=4, neurons_per_core=16, scheme=scheme,
                          impl="pallas_sparse")
    policy, _, _ = tpipeline.resolve_sparse_plan(cfg)
    assert policy.kernel_policy == SCHEMES.index(scheme)
    assert policy.levels == tarb.ArbiterConfig(scheme, 16).levels


@pytest.mark.parametrize("scheme,n", [("greedy_tree", 2), ("hier_ring", 32)])
def test_undefined_sparse_policies_refuse_alike(scheme, n):
    kw = dict(cores=2, neurons_per_core=n, cam_entries_per_core=8,
              scheme=scheme, impl="pallas_sparse")
    from repro.interface import pipeline as jpipeline
    from repro.interface.config import InterfaceConfig as JConfig
    with pytest.raises(ValueError) as want:
        jpipeline.resolve_sparse_plan(JConfig(**kw))
    with pytest.raises(ValueError) as got:
        tpipeline.resolve_sparse_plan(InterfaceConfig(**kw))
    assert str(got.value) == str(want.value)


def test_library_is_keyed_by_the_source_and_built_lazily():
    path = build.library_path(sparse_kernel.SOURCE)
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("sparse_tick-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert (build.CSRC / "sparse_tick.cu").is_file()
