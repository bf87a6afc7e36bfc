"""The PyTorch port's session against the JAX package's, end to end.

Both packages get the same routing state (the JAX package's
`random_connectivity`, carried across with `params_from_numpy`) and the
same numpy spike streams.  `run` and `run_batched`, under impl="xla",
"pallas" and "pallas_sparse", over a sample of the 5 x 3 arbiter x NoC
grid on `tests/conformance/paths.small_config` (4 x 16 x 32), with
sparse, overflowing and full-burst frames; impl="pallas" also at
4 x 256 x 64, where the arbiter terms take the hat_encode kernel
branch; and the six `repro.traffic` scenarios through all three impls.  The tolerance is the conformance
contract: currents bitwise, `EXACT_FIELDS` exact, every other stat within
`REL_TOL` (energies multiply float32 counts by Python-float constants,
whose rounding may differ between the two frameworks).

Also here: the surfaces the port refuses by name (``mask`` and
``stats0`` left the list when the masked session was ported; the
serving tier's ``TenantSpec(fault=...)`` and ``shard="chips"`` joined
it), ``mask`` with ``telemetry`` as the typed `CompositionError`, the GPU
default of `compile`, and that the port imports nothing of JAX or of the
JAX package (its serving tier, traffic, obs and ft layers included).
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import traffic
from repro.core import fabric
from repro.interface import Interface as JInterface
from repro.kernels.hat_encode import ops as jhat_ops
from repro_torch.interface import Interface, StepStats, interface_tick
from repro_torch.interface.session import CompositionError
from repro_torch.serve import TenantSpec
from repro_torch.interface import config as tconfig
from repro_torch.interface import pipeline as tpipeline
from repro_torch.interface.types import params_from_numpy, random_connectivity
from repro_torch.kernels.hat_encode import ops as that_ops
from repro_torch.kernels.sparse_tick import kernel as sparse_kernel
from tests.conformance import paths

ROOT = pathlib.Path(__file__).resolve().parents[1]

# every arbiter scheme and every NoC scheme at least twice
SAMPLED_GRID = (("binary_tree", "broadcast"), ("greedy_tree", "unicast"),
                ("token_ring", "multicast_tree"), ("hier_ring", "broadcast"),
                ("hier_tree", "unicast"), ("hier_tree", "multicast_tree"))


def _stream(seed, ticks=6, cores=4, n=16, p=0.15):
    """Sparse frames, one full burst and one core past the capacity (8)."""
    rng = np.random.default_rng(seed)
    s = rng.random((ticks, cores, n)) < p
    s[2] = True
    s[4, 1, :12] = True
    return s


def _setup(arb_scheme, noc_scheme, impl, seed=3, **shape):
    jcfg = dataclasses.replace(paths.small_config(arb_scheme, noc_scheme,
                                                  **shape), impl=impl)
    jparams = fabric.random_connectivity(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(*(np.asarray(x) for x in jparams),
                                device="cpu")
    return jcfg, jparams, tconfig.as_interface_config(jcfg), tparams


def _assert_conformant(got, want, label):
    cur, st = got
    jcur, jst = want
    np.testing.assert_array_equal(cur.numpy(), np.asarray(jcur),
                                  err_msg=f"{label}: currents")
    for field in StepStats._fields:
        a, b = getattr(st, field).numpy(), np.asarray(getattr(jst, field))
        assert a.shape == b.shape, (label, field)
        if field in paths.EXACT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f"{label}: {field}")
        else:
            np.testing.assert_allclose(a, b, rtol=paths.REL_TOL, atol=0,
                                       err_msg=f"{label}: {field}")


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_sparse"])
@pytest.mark.parametrize("arb_scheme,noc_scheme", SAMPLED_GRID)
def test_run_matches_jax(arb_scheme, noc_scheme, impl):
    jcfg, jparams, tcfg, tparams = _setup(arb_scheme, noc_scheme, impl)
    jsession = JInterface(jcfg).compile(jparams)
    tsession = Interface(tcfg).compile(tparams, device="cpu")
    burst = _stream(7)
    sparse = _stream(8)
    sparse[2], sparse[4] = sparse[1], sparse[3]     # every frame fits
    if impl == "pallas_sparse":     # the fast path, then the guarded one
        assert not any(tsession._overflow(torch.from_numpy(sparse)[None]))
        assert any(tsession._overflow(torch.from_numpy(burst)[None]))
    for name, stream in (("burst", burst), ("sparse", sparse)):
        _assert_conformant(tsession.run(torch.from_numpy(stream)),
                           jsession.run(jnp.asarray(stream)),
                           f"{arb_scheme}/{noc_scheme}/{impl}/{name}")


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_sparse"])
@pytest.mark.parametrize("arb_scheme,noc_scheme",
                         [("hier_tree", "multicast_tree"),
                          ("token_ring", "broadcast"),
                          ("hier_ring", "unicast")])
def test_run_batched_matches_jax(arb_scheme, noc_scheme, impl):
    jcfg, jparams, tcfg, tparams = _setup(arb_scheme, noc_scheme, impl, 5)
    lanes = np.stack([_stream(1), _stream(2, p=0.05), _stream(3, p=0.3)])
    lanes[1, 2] = lanes[1, 1]                       # lane 1 fits except tick 4
    got = Interface(tcfg).compile(tparams, device="cpu").run_batched(
        torch.from_numpy(lanes))
    want = JInterface(jcfg).compile(jparams).run_batched(jnp.asarray(lanes))
    _assert_conformant(got, want, f"{arb_scheme}/{noc_scheme}/{impl}")
    assert got[0].shape == (3, 6, 4, 16)


@pytest.mark.parametrize("arb_scheme,noc_scheme",
                         [("hier_tree", "multicast_tree"),
                          ("binary_tree", "broadcast")])
def test_pallas_at_256_neurons_takes_the_hat_encode_branch(
        arb_scheme, noc_scheme, monkeypatch):
    """At n = 256 the arbiter terms go through hat_encode's kernel path,
    `hat_run` (its plain version on the CPU, tick by tick); run and
    run_batched still match the JAX package's pallas path
    (`paths.run_pallas`)."""
    jcfg, jparams, tcfg, tparams = _setup(arb_scheme, noc_scheme, "pallas",
                                          n=256, entries=64)
    calls = []
    hat_run = tpipeline.hat_ops.hat_run

    def spy(stream, policy, **kw):
        calls.append(kw["impl"])
        return hat_run(stream, policy, **kw)
    monkeypatch.setattr(tpipeline.hat_ops, "hat_run", spy)
    rng = np.random.default_rng(11)
    lanes = rng.random((2, 3, 4, 256)) < np.array([0.05, 0.3])[:, None,
                                                                None, None]
    lanes[1, 1] = True
    session = Interface(tcfg).compile(tparams, device="cpu")
    _assert_conformant(session.run(torch.from_numpy(lanes[1])),
                       paths.run_pallas(jcfg, jparams, jnp.asarray(lanes[1])),
                       f"{arb_scheme}/{noc_scheme}/run")
    want = JInterface(jcfg).compile(jparams).run_batched(jnp.asarray(lanes))
    _assert_conformant(session.run_batched(torch.from_numpy(lanes)), want,
                       f"{arb_scheme}/{noc_scheme}/run_batched")
    assert calls and set(calls) == {"pallas"}


@pytest.mark.parametrize("scenario", traffic.scenario_names())
def test_traffic_scenarios_match_jax(scenario):
    """Each `repro.traffic` scenario (made by the JAX package, carried as
    numpy) through the port's three impls, held to the JAX session."""
    index = traffic.scenario_names().index(scenario)
    arb_scheme, noc_scheme = paths.GRID[(5 * index + 2) % len(paths.GRID)]
    jcfg, jparams, tcfg, tparams = _setup(arb_scheme, noc_scheme, "xla",
                                          seed=index)
    spikes = np.array(traffic.generate(scenario, 17 + index, 4, jcfg))
    want = JInterface(jcfg).compile(jparams).run(jnp.asarray(spikes))
    for impl in ("xla", "pallas", "pallas_sparse"):
        session = Interface(dataclasses.replace(tcfg, impl=impl)).compile(
            tparams, device="cpu")
        _assert_conformant(session.run(torch.from_numpy(spikes)), want,
                           f"{scenario}/{arb_scheme}/{noc_scheme}/{impl}")


def test_sparse_and_dense_branches_agree_tick_by_tick():
    _, _, tcfg, tparams = _setup("hier_tree", "multicast_tree",
                                 "pallas_sparse")
    session = Interface(tcfg).compile(tparams, device="cpu")
    dense = Interface(dataclasses.replace(tcfg, impl="xla")).compile(
        tparams, device="cpu")
    stream = torch.from_numpy(_stream(9))
    cur, st = session.run(stream)
    for t in range(stream.shape[0]):
        sc, ss = session.step(stream[t])
        dc, ds = dense.step(stream[t])
        tc, ts = interface_tick(session.params, stream[t], tcfg)
        assert torch.equal(sc, dc) and torch.equal(sc, tc)
        assert torch.equal(sc, cur[t])
        for a, b, c in zip(ss, ds, ts):
            assert torch.equal(a, b) and torch.equal(a, c)
    acc = StepStats.zeros()
    for t in range(stream.shape[0]):
        acc = acc.accumulate(session.step(stream[t])[1])
    for a, b in zip(acc, st):
        assert torch.equal(a, b)


def test_cpu_sessions_never_launch_the_kernel():
    _, _, tcfg, tparams = _setup("hier_tree", "multicast_tree",
                                 "pallas_sparse")
    before = sparse_kernel.launches
    Interface(tcfg).compile(tparams, device="cpu").run(
        torch.from_numpy(_stream(4)))
    assert sparse_kernel.launches == before


def test_empty_stream_and_stats_helpers():
    _, _, tcfg, tparams = _setup("hier_tree", "multicast_tree",
                                 "pallas_sparse")
    session = Interface(tcfg).compile(tparams, device="cpu")
    cur, st = session.run(torch.zeros((0, 4, 16), dtype=torch.bool))
    assert cur.shape == (0, 4, 16)
    assert all(float(v) == 0.0 for v in st)
    with pytest.raises(ValueError, match="positive tick count"):
        st.mean(0)
    _, st = session.run(torch.from_numpy(_stream(6)))
    per_tick = st.summary(ticks=6)
    assert per_tick["events"] == pytest.approx(float(st.events) / 6)
    with pytest.raises(ValueError, match="expected 3-d spikes"):
        session.run(torch.zeros((4, 16), dtype=torch.bool))


def test_encode_stream_matches_jax():
    rng = np.random.default_rng(0)
    for n in (16, 256, 512):
        frames = rng.random((3, n)) < 0.3
        frames[0] = False
        got, gcount = that_ops.encode_stream(torch.from_numpy(frames))
        for i, frame in enumerate(frames):
            want, wcount = jhat_ops.encode_stream(jnp.asarray(frame))
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
            assert int(gcount[i]) == int(wcount)


def test_random_connectivity_is_seeded_and_shaped():
    cfg = tconfig.InterfaceConfig(cores=4, neurons_per_core=16,
                                  cam_entries_per_core=32)
    a = random_connectivity(torch.Generator().manual_seed(1), cfg)
    b = random_connectivity(torch.Generator().manual_seed(1), cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a.tags.shape == (4, 32, cfg.tag_bits) and a.tags.dtype == torch.int32
    assert a.valid.dtype == torch.bool and a.weights.dtype == torch.float32
    assert int(a.targets.max()) < 16 and a.targets.dtype == torch.int32


# ---- refused surfaces and the device default --------------------------------------

def _session(impl="xla", **kw):
    _, _, tcfg, tparams = _setup("hier_tree", "multicast_tree", impl)
    return Interface(dataclasses.replace(tcfg, **kw)), tparams


REFUSED = {
    "chips": (lambda: _session(chips=2)[0].compile(_session()[1],
                                                   device="cpu"), 7),
    "shard": (lambda: _cpu().run(_zeros(), shard="chips"), 7),
    "mask_shard": (lambda: _cpu().run(_zeros(), mask=np.ones(2, bool),
                                      shard="chips"), 7),
    "telemetry": (lambda: _cpu().run(_zeros(), telemetry="ticks"), 7),
    "fault_tick0": (lambda: _cpu().run(_zeros(), fault_tick0=0), 7),
    "fault": (lambda: _session()[0].compile(_session()[1], device="cpu",
                                            fault=object()), 9),
    "tenant_fault": (lambda: TenantSpec("t", _session()[0].config,
                                        fault=object()), 9),
    "tenant_shard": (lambda: TenantSpec("t", dataclasses.replace(
        _session()[0].config, chips=2), shard="chips"), 7),
    "oracle": (lambda: interface_tick(_session()[1], _zeros()[0],
                                      _session()[0].config, oracle=True), 8),
}


def _cpu():
    interface, params = _session()
    return interface.compile(params, device="cpu")


def _zeros():
    return torch.zeros((2, 4, 16), dtype=torch.bool)


@pytest.mark.parametrize("surface", sorted(REFUSED))
def test_unported_surfaces_raise_by_roadmap_item(surface):
    fn, item = REFUSED[surface]
    with pytest.raises(NotImplementedError, match=f"queue A item {item}"):
        fn()


def test_mask_with_telemetry_raises_composition_error():
    """The JAX package's typed rejection, a ValueError, before the
    telemetry refusal: mask and telemetry never compose."""
    with pytest.raises(CompositionError, match="telemetry"):
        _cpu().run(_zeros(), mask=np.ones(2, bool), telemetry="ticks")
    with pytest.raises(CompositionError, match="one-chip"):
        TenantSpec("t", _session()[0].config, shard="chips")
    assert issubclass(CompositionError, ValueError)


def test_xla_without_a_closed_form_raises_at_compile():
    cfg = tconfig.InterfaceConfig(cores=2, neurons_per_core=32,
                                  cam_entries_per_core=8, scheme="hier_ring")
    params = random_connectivity(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(NotImplementedError, match="item 8"):
        Interface(cfg).compile(params, device="cpu")


def test_compile_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    interface, params = _session()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interface.compile(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interface.compile(params, device="cuda")


# ---- import isolation -------------------------------------------------------------

_ISOLATED = """
import sys, torch
import repro_torch
from repro_torch.interface import Interface, InterfaceConfig
from repro_torch.interface.types import random_connectivity
import repro_torch.kernels.sparse_tick.kernel
import repro_torch.kernels.cam_search.kernel
import repro_torch.kernels.hat_encode.kernel
import repro_torch.kernels.lif_step.kernel
import repro_torch.kernels.moe_dispatch.kernel
from repro_torch.configs import get_smoke_config
from repro_torch.core import event_router
from repro_torch.models import lm
from repro_torch.serve.lm_engine import ServeEngine
from repro_torch.configs import paper_dynaps
from repro_torch.data.pipeline import snn_batch
from repro_torch.models import snn
for impl in ("pallas_sparse", "pallas"):
    cfg = InterfaceConfig(cores=4, neurons_per_core=256,
                          cam_entries_per_core=32, impl=impl)
    params = random_connectivity(torch.Generator().manual_seed(0), cfg)
    cur, st = Interface(cfg).compile(params, device="cpu").run(
        torch.rand((3, 4, 256), generator=torch.Generator().manual_seed(1))
        < 0.05)
    assert cur.shape == (3, 4, 256)
cfg = paper_dynaps.smoke_config()
params, topo = snn.init_snn(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
x = snn_batch(torch.Generator().manual_seed(1), 2, cfg.t_steps, cfg.d_in,
              cfg.d_out, device="cpu")["x"]
with torch.no_grad():
    logits, rates, stats = snn.snn_forward(params, topo, x, cfg,
                                           impl="pallas", account=True)
assert logits.shape == (2, cfg.d_out) and float(stats.events) > 0
lm_cfg = get_smoke_config("deepseek-v2-lite-16b")
lm_params = lm.init_model(torch.Generator().manual_seed(0), lm_cfg,
                          device="cpu")
toks = ServeEngine(lm_cfg, lm_params, max_len=16).generate(
    torch.zeros((2, 4), dtype=torch.int32), 3)
assert toks.shape == (2, 3)
route = event_router.hat_route(torch.randn(10, 8), 2, 4)
assert int(route.load.sum()) == 20
from repro_torch.serve import ServeEngine as FabricEngine, TenantSpec
from repro_torch.ft import ChaosInjector, FaultPlan
from repro_torch.obs import Tracer
import repro_torch.obs.report
engine = FabricEngine(flush_ticks=4, flush_deadline_s=0.0, device="cpu",
                      chaos=ChaosInjector(FaultPlan()))
cfg = InterfaceConfig(cores=4, neurons_per_core=16, cam_entries_per_core=32,
                      impl="pallas_sparse")
with Tracer():
    for i in range(2):
        engine.register(TenantSpec(f"t{i}", cfg, scenario="mixture", seed=i))
        engine.submit_scenario(f"t{i}", 6)
    assert engine.drain() == 12 and engine.accounting()["closes"]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
"""


def test_port_runs_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _ISOLATED], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_source_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "examples" /
              "snn_multicore_torch.py"]
    assert len(files) > 10
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "repro"}, path
