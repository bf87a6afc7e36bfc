"""The PyTorch port's whole-run arbiter terms (`hat_run`) against the JAX
package's.

`hat_run` gives, for every (tick, lane, core) bitmap of a (B, T, C, n)
stream, the arbiter's tick latency, the AER encode energy and the event
count: what the interface tick takes from the frame and from B3's
address stream.  Its plain version (`ref.hat_run_ref`, what the op runs
on CPU tensors) is held here to the JAX package's composition, bitmap by
bitmap: `repro.core.arbiter.batched_tick_latency` on the frame and
`encode_energy_units` over the stream that
`repro.kernels.hat_encode.ops.encode_stream` makes (the Pallas kernel in
interpret mode, as `tests/test_kernels.py` runs it).  Spike streams are
numpy arrays made from a seed and handed to both packages.

Every latency is an exact small integer and every energy an exact
integer over n, so all three outputs are compared exactly, the float32
ones bit for bit.  Covered: the five arbiter schemes at n in {256, 1024},
spike rates 0, 0.05, 0.5 and 1, B = 2 lanes x T = 3 ticks; the stream's
edges (one event at address 0, one at n - 1, an empty core, a full
core); the op's dispatch and errors, and the CUDA wrapper's checks, on
the CPU; the kernel's quantities a plan binds on the card, and the
pallas plan's refusal there of a scheme without a kernel branch.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arbiter as jarb
from repro.kernels.hat_encode import ops as jhat_ops
from repro_torch.core import arbiter as tarb
from repro_torch.interface import Interface, InterfaceConfig, registry
from repro_torch.interface import pipeline as tpipeline
from repro_torch.interface.types import random_connectivity
from repro_torch.kernels import build
from repro_torch.kernels.hat_encode import kernel as hat_kernel
from repro_torch.kernels.hat_encode import ops as that_ops

SCHEMES = ("binary_tree", "greedy_tree", "token_ring", "hier_ring",
           "hier_tree")
LANES, TICKS, CORES = 2, 3, 4


def _policy(scheme, n):
    cfg = tarb.ArbiterConfig(scheme, n)
    return that_ops.bind_run(
        tarb.tick_latency_fn(cfg),
        functools.partial(tarb.encode_energy_units, scheme, n),
        registry.get_arbiter(scheme).kernel_policy, cfg.levels, n, "cpu")


def _jax_terms(scheme, stream):
    """The JAX package's (latency, energy, count), each (B, T, C)."""
    n = stream.shape[-1]
    frames = jnp.asarray(stream.reshape(-1, n))
    aer, count = jax.vmap(functools.partial(
        jhat_ops.encode_stream, impl="pallas", interpret=True))(frames)
    lat = jarb.batched_tick_latency(jarb.ArbiterConfig(scheme, n), frames)
    enc = jax.vmap(functools.partial(jarb.encode_energy_units, scheme,
                                     n))(aer)
    return tuple(np.asarray(x).reshape(stream.shape[:-1])
                 for x in (lat, enc, count))


def _assert_matches_jax(scheme, stream):
    got = that_ops.hat_run(torch.from_numpy(stream), _policy(scheme,
                                                             stream.shape[-1]),
                           impl="pallas")
    want = _jax_terms(scheme, stream)
    lanes, ticks, cores = stream.shape[:3]
    for name, g, w, dtype in zip(("latency", "energy", "count"), got, want,
                                 (torch.float32, torch.float32,
                                  torch.int32)):
        assert g.dtype == dtype and g.shape == (ticks, lanes, cores), name
        g = g.numpy()
        for t in range(ticks):             # tick by tick, core by core
            for b in range(lanes):
                for c in range(cores):
                    assert g[t, b, c].tobytes() == np.asarray(
                        w[b, t, c], g.dtype).tobytes(), (name, b, t, c,
                                                         g[t, b, c],
                                                         w[b, t, c])


@pytest.mark.parametrize("rate", [0.0, 0.05, 0.5, 1.0])
@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_hat_run_matches_jax(scheme, n, rate):
    stream = np.random.default_rng(n + int(100 * rate)).random(
        (LANES, TICKS, CORES, n)) < rate
    _assert_matches_jax(scheme, stream)


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_hat_run_stream_edges_match_jax(scheme, n):
    """One event at address 0, one at n - 1, an empty core and a full
    core: the stream's first element and first pad, an all-pad stream
    (its energy is 2 levels / n, not 0) and a stream with no pad."""
    stream = np.random.default_rng(n).random((LANES, TICKS, CORES, n)) < 0.05
    stream[0, 0, :] = False
    stream[0, 0, 0, 0] = True
    stream[0, 0, 1, n - 1] = True
    stream[0, 0, 3] = True
    stream[1, 2, 2] = False
    stream[1, 2, 3, [0, n - 1]] = True
    _assert_matches_jax(scheme, stream)
    if scheme == "hier_tree":
        energy = _jax_terms(scheme, stream)[1][0, 0, 2]
        levels = tarb.ArbiterConfig(scheme, n).levels
        assert energy == np.float32(2 * levels) / np.float32(n)


def test_hat_run_dispatch_and_errors_on_the_cpu(monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(build, "load", no_build)
    stream = torch.zeros((1, 2, 3, 256), dtype=torch.bool)
    policy = _policy("hier_tree", 256)
    before = hat_kernel.launches
    for impl in ("pallas", "xla"):          # CPU frames: the plain version
        out = that_ops.hat_run(stream, policy, impl=impl)
        assert [tuple(x.shape) for x in out] == [(2, 1, 3)] * 3
    assert hat_kernel.launches == before
    with pytest.raises(ValueError, match="unknown impl 'cuda'"):
        that_ops.hat_run(stream, policy, impl="cuda")
    with pytest.raises(ValueError, match=r"\(B, T, C, 256\) frames"):
        that_ops.hat_run(stream[0], policy)
    narrow = torch.zeros((1, 2, 3, 64), dtype=torch.bool)
    with pytest.raises(ValueError, match="got N=64"):
        that_ops.hat_run(narrow, _policy("hier_tree", 64), impl="pallas")
    out = that_ops.hat_run(narrow, _policy("hier_tree", 64), impl="xla")
    assert out[1].shape == (2, 1, 3)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        hat_kernel.hat_run_cuda(stream, hat_kernel.run_args(4, 256, 4))


@pytest.mark.parametrize("scheme,n,derived", [
    ("binary_tree", 256, (0, 14.0, 8.0)),
    ("greedy_tree", 4096, (0, 22.0, 12.0)),
    ("token_ring", 1024, (0, 18.0, 10.0)),
    ("hier_ring", 1024, (5, 18.0, 10.0)),
    ("hier_ring", 65536, (8, 30.0, 16.0)),
    ("hier_tree", 256, (0, 14.0, 8.0)),
])
def test_run_args_derive_the_kernel_quantities(scheme, n, derived):
    """A plan bound for the card carries the scheme's kernel branch, its
    level count and the derived ring shift (log2 sqrt n, hier_ring only),
    grant cost 2 (log2 n - 1) and log2 n; one bound for the CPU none."""
    levels = tarb.ArbiterConfig(scheme, n).levels
    kernel_policy = registry.get_arbiter(scheme).kernel_policy
    args = that_ops.bind_run(None, None, kernel_policy, levels, n,
                             torch.device("cuda")).args
    assert args == hat_kernel.RunArgs(kernel_policy, n, levels, *derived)
    assert _policy(scheme, n).args is None


NO_KERNEL = "hier_tree_no_kernel"


@pytest.fixture
def scheme_without_kernel_policy():
    """hier_tree's closed forms registered under another name with no
    ``kernel_policy``: a scheme the CUDA kernels have no branch for."""
    registry.register_arbiter(NO_KERNEL, dataclasses.replace(
        registry.get_arbiter("hier_tree"), name=NO_KERNEL,
        kernel_policy=None))
    yield NO_KERNEL
    registry.ARBITERS.unregister(NO_KERNEL)


class _OnTheCard:
    """Stands in for weights on a CUDA device: `make_plan` reads only
    their device when it binds the arbiter terms of a pallas plan."""
    device = torch.device("cuda")


@pytest.mark.parametrize("n,refused", [(256, True), (64, False)])
def test_pallas_plan_on_the_card_refuses_a_scheme_without_kernel_policy(
        scheme_without_kernel_policy, n, refused):
    """On the card, impl="pallas" at an n the hat_run kernel takes raises
    when the plan is bound for a scheme without a kernel branch: no
    plain-path fallback.  At other n, and on the CPU, the plain versions
    run it, and the session matches impl="xla" on the same frames."""
    cfg = InterfaceConfig(cores=4, neurons_per_core=n, cam_entries_per_core=16,
                          scheme=scheme_without_kernel_policy, impl="pallas")
    params = random_connectivity(torch.Generator().manual_seed(1), cfg)
    tables = tpipeline.build_tables(params, cfg)
    routing = tpipeline.build_routing_index(params, cfg)
    on_card = params._replace(weights=_OnTheCard())
    if refused:
        with pytest.raises(ValueError, match="registers no kernel_policy"):
            tpipeline.make_plan(on_card, cfg, tables=tables, routing=routing)
    else:
        assert tpipeline.make_plan(on_card, cfg, tables=tables,
                                   routing=routing).hat.args is None
    assert tpipeline.make_plan(params, cfg).hat.args is None
    frames = torch.from_numpy(np.random.default_rng(n).random((5, 4, n)) < 0.1)
    got = Interface(cfg).compile(params, device="cpu").run(frames)
    want = Interface(dataclasses.replace(cfg, impl="xla")).compile(
        params, device="cpu").run(frames)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
