"""The PyTorch port's SNN workload against the JAX package's.

Weights and topology come from the JAX package's `init_snn`, carried
across as numpy arrays (`snn_params_from_numpy`); input rasters are
numpy arrays made from a seed.  The JAX forward runs ``impl="pallas"``
with the Pallas kernel in interpret mode, as `repro.models.snn` does on
the CPU.  Tolerances, stated where they are used:

- `routing_matrix`, spike rates and every membrane value: bitwise (the
  port rounds the membrane update once, as the jitted JAX step does).
- logits: rtol 1e-5 / atol 1e-6; the float32 matrix products sum in
  another order than XLA's (measured gap at most 4.3e-7 at `config`).
- ``account=True`` stats: the conformance contract
  (`tests/conformance/paths.py`: `EXACT_FIELDS` exactly, the rest within
  `REL_TOL`).
- surrogate gradient and `snn_loss` gradients: rtol 1e-5 / atol 1e-7
  (sigmoid and summation order differ in the last bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_dynaps as jconfigs
from repro.core import fabric as jfabric
from repro.data import pipeline as jpipeline
from repro.models import snn as jsnn
from repro_torch.configs import paper_dynaps as tconfigs
from repro_torch.data import pipeline as tpipeline
from repro_torch.interface import StepStats
from repro_torch.interface.config import InterfaceConfig
from repro_torch.interface.types import InterfaceParams
from repro_torch.kernels.lif_step import kernel as lif_kernel
from repro_torch.models import snn as tsnn
from tests.conformance import paths

CONFIGS = ("smoke_config", "config")


@pytest.fixture(scope="module", params=CONFIGS)
def model(request):
    """(name, JAX cfg, port cfg, JAX params, JAX topology, port params,
    port topology) from one JAX `init_snn`."""
    name = request.param
    jcfg, tcfg = getattr(jconfigs, name)(), getattr(tconfigs, name)()
    jp, jt = jsnn.init_snn(jax.random.PRNGKey(0), jcfg)
    tp, tt = tsnn.snn_params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()},
        {k: np.asarray(v) for k, v in jt.items()}, device="cpu")
    return name, jcfg, tcfg, jp, jt, tp, tt


def _raster(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((batch, cfg.t_steps, cfg.d_in))
            < cfg.input_rate).astype(np.float32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_routing_matrix_bitwise_equals_jax(model):
    _, jcfg, tcfg, jp, jt, tp, tt = model
    want = jsnn.routing_matrix(jsnn.fabric_params(jp, jt), jcfg.fabric)
    got = tsnn.routing_matrix(tsnn.fabric_params(tp, tt), tcfg.fabric)
    assert got.shape == (tcfg.n_total, tcfg.n_total)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_routing_matrix_adds_duplicates_in_entry_order():
    # core 0: five entries on one (source, target) pair whose sum depends
    # on the order, and an invalid entry; core 2: a tag past N_total and
    # a tag with a digit that is not a bit, both matching no source
    jcfg = jfabric.FabricConfig(cores=3, neurons_per_core=4,
                                cam_entries_per_core=8)
    tcfg = InterfaceConfig(cores=3, neurons_per_core=4,
                           cam_entries_per_core=8)
    src = np.array([[5, 5, 5, 5, 5, 1, 7, 2], [0, 0, 3, 3, 6, 6, 6, 4],
                    [13, 11, 9, 8, 6, 6, 6, 6]])
    tags = np.array(jfabric.int_to_bits(jnp.asarray(src), jcfg.tag_bits))
    tags[2, 4] = [0, 0, 2, 0]                      # decodes to 4 if unchecked
    valid = np.ones((3, 8), bool)
    valid[0, 5] = False
    weights = np.array([[1e8, 1.0, -1e8, 1.0, 0.5, 3.0, 2.0, 1.5],
                        [0.25, 0.125, 1.0, 1e-8, 1.0, 1e8, -1e8, 2.0],
                        [9.0, 8.0, 7.0, 6.0, 5.0, 1e8, 1.0, -1e8]],
                       np.float32)
    targets = np.array([[2, 2, 2, 2, 2, 0, 1, 3], [1, 1, 0, 0, 3, 3, 3, 2],
                        [0, 1, 2, 3, 3, 0, 0, 0]], np.int32)
    want = np.asarray(jsnn.routing_matrix(
        jfabric.FabricParams(jnp.asarray(tags), jnp.asarray(valid),
                             jnp.asarray(weights), jnp.asarray(targets)),
        jcfg))
    fp = InterfaceParams(torch.tensor(tags), torch.tensor(valid),
                         torch.tensor(weights), torch.tensor(targets))
    got = tsnn.routing_matrix(fp, tcfg).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # ((1e8 + 1) - 1e8) + 1 + 0.5 in float32 and entry order: the first 1
    # is lost; summed last to first, 0.5 + 1 + (-1e8) + 1 + 1e8 gives 0
    assert got[5, 2] == 1.5
    assert got[6, 8] == 0.0 and got[4, 11] == 0.0   # no stray matches
    assert got[13:].sum() == 0.0


def test_routing_matrix_is_differentiable_in_the_weights(model):
    _, jcfg, tcfg, jp, jt, tp, tt = model
    g = np.random.default_rng(2).standard_normal(
        (tcfg.n_total, tcfg.n_total)).astype(np.float32)
    jgrad = jax.grad(lambda w: jnp.sum(jsnn.routing_matrix(
        jfabric.FabricParams(jt["tags"], jt["valid"], w, jt["targets"]),
        jcfg.fabric) * g))(jp["syn_w"])
    w = tp["syn_w"].clone().requires_grad_()
    fp = InterfaceParams(tt["tags"], tt["valid"], w, tt["targets"])
    (tsnn.routing_matrix(fp, tcfg.fabric) * torch.from_numpy(g)).sum(
    ).backward()
    # each weight lands in one element: its gradient is that element of g
    np.testing.assert_array_equal(_bits(w.grad.numpy()), _bits(jgrad))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_matches_jax(model, impl):
    _, jcfg, tcfg, jp, jt, tp, tt = model
    x = _raster(jcfg, 16, seed=3)
    jlogits, jrates, _ = jsnn.snn_forward(jp, jt, jnp.asarray(x), jcfg,
                                          impl=impl)
    with torch.no_grad():
        logits, rates, stats = tsnn.snn_forward(tp, tt, torch.from_numpy(x),
                                                tcfg, impl=impl)
    assert stats is None
    assert rates.shape == (16, tcfg.n_total)
    assert logits.shape == (16, tcfg.d_out)
    np.testing.assert_array_equal(_bits(rates.numpy()), _bits(jrates))
    assert 0 < float(rates.mean()) < 1
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-6)


def test_pallas_and_xla_forwards_agree_bitwise(model):
    _, jcfg, tcfg, _, _, tp, tt = model
    x = torch.from_numpy(_raster(jcfg, 8, seed=4))
    with torch.no_grad():
        outs = [tsnn.snn_forward(tp, tt, x, tcfg, impl=impl)[:2]
                for impl in ("xla", "pallas")]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))


def test_account_stats_match_jax_under_the_contract():
    jcfg, tcfg = jconfigs.smoke_config(), tconfigs.smoke_config()
    jp, jt = jsnn.init_snn(jax.random.PRNGKey(1), jcfg)
    tp, tt = tsnn.snn_params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()},
        {k: np.asarray(v) for k, v in jt.items()}, device="cpu")
    x = _raster(jcfg, 4, seed=5)
    _, _, jstats = jsnn.snn_forward(jp, jt, jnp.asarray(x), jcfg,
                                    impl="pallas", account=True)
    with torch.no_grad():
        _, rates, stats = tsnn.snn_forward(tp, tt, torch.from_numpy(x), tcfg,
                                           impl="pallas", account=True)
    assert isinstance(stats, StepStats)
    # the replayed raster: events per tick are the mean spikes per tick
    assert float(stats.events) == pytest.approx(
        float(rates.sum()) * tcfg.t_steps / (4 * tcfg.t_steps), rel=1e-6)
    for field in StepStats._fields:
        a, b = float(getattr(stats, field)), float(getattr(jstats, field))
        if field in paths.EXACT_FIELDS:
            assert a == b, field
        else:
            assert a == pytest.approx(b, rel=paths.REL_TOL, abs=0), field


def test_spike_fn_surrogate_gradient_matches_jax():
    grid = np.linspace(-3, 3, 601, dtype=np.float32)
    grid = np.concatenate([grid, np.float32([0.0, -0.0, 1e-8, -1e-8])])
    jgrad = jax.vmap(jax.grad(jsnn.spike_fn))(jnp.asarray(grid))
    v = torch.from_numpy(grid).requires_grad_()
    s = tsnn.spike_fn(v)
    np.testing.assert_array_equal(s.detach().numpy(),
                                  np.asarray(jsnn.spike_fn(jnp.asarray(grid))))
    s.sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)


def test_loss_and_gradients_match_jax():
    jcfg, tcfg = jconfigs.smoke_config(), tconfigs.smoke_config()
    jp, jt = jsnn.init_snn(jax.random.PRNGKey(2), jcfg)
    tp, tt = tsnn.snn_params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()},
        {k: np.asarray(v) for k, v in jt.items()}, device="cpu")
    x = _raster(jcfg, 8, seed=6)
    y = np.random.default_rng(7).integers(0, jcfg.d_out, 8).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jsnn.snn_loss(p, jt, {"x": jnp.asarray(x),
                                        "y": jnp.asarray(y)}, jcfg))(jp)
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    loss = tsnn.snn_loss(tp, tt, {"x": torch.from_numpy(x),
                                  "y": torch.from_numpy(y)}, tcfg)
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    for k in ("w_in", "syn_w", "w_out"):
        assert float(np.abs(np.asarray(jgrads[k])).max()) > 0, k
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_pallas_forward_refuses_grad_and_module_matches_functional():
    tcfg = tconfigs.smoke_config()
    params, topo = tsnn.init_snn(torch.Generator().manual_seed(0), tcfg,
                                 device="cpu")
    model = tsnn.SNN(tcfg, params, topo)
    assert {n for n, _ in model.named_parameters()} == {"w_in", "syn_w",
                                                        "w_out"}
    assert {n for n, _ in model.named_buffers()} == {"tags", "valid",
                                                     "targets"}
    x = tpipeline.snn_batch(torch.Generator().manual_seed(1), 8,
                            tcfg.t_steps, tcfg.d_in, tcfg.d_out,
                            device="cpu")["x"]
    with pytest.raises(RuntimeError, match="no backward"):
        model(x, impl="pallas")
    before = lif_kernel.launches
    with torch.no_grad():
        got = model(x, impl="pallas")
        want = tsnn.snn_forward(params, topo, x, tcfg, impl="xla")
    assert lif_kernel.launches == before        # CPU tensors: plain version
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown impl 'triton'"):
        model(x, impl="triton")


def _class_levels(x, y, n_classes):
    """(classes, d_in) firing rate of each input over a class's samples."""
    return np.stack([x[y == c].mean((0, 1)) for c in range(n_classes)])


def test_snn_batch_shapes_and_rates():
    gen = torch.Generator().manual_seed(0)
    batch = tpipeline.snn_batch(gen, 512, 32, 64, 10, device="cpu")
    x, y = batch["x"], batch["y"]
    assert x.shape == (512, 32, 64) and x.dtype == torch.float32
    assert y.shape == (512,) and int(y.min()) >= 0 and int(y.max()) < 10
    assert set(torch.unique(x).tolist()) <= {0.0, 1.0}
    jbatch = jpipeline.snn_batch(jax.random.PRNGKey(0), 512, 32, 64, 10)
    # in both packages each input of a class fires at 0.3 * (0.4 + bit):
    # 0.12 or 0.42, the bits a fixed prototype per class, about half set.
    # About 1600 draws per (class, input): 0.05 is over four sigmas.
    for xs, ys in ((x.numpy(), y.numpy()),
                   (np.asarray(jbatch["x"]), np.asarray(jbatch["y"]))):
        levels = _class_levels(xs, ys, 10)
        high = levels > 0.27
        np.testing.assert_allclose(levels, np.where(high, 0.42, 0.12),
                                   atol=0.05)
        assert 0.35 < high.mean() < 0.65
    again = tpipeline.snn_batch(torch.Generator().manual_seed(0), 512, 32,
                                64, 10, device="cpu")
    assert torch.equal(again["x"], x) and torch.equal(again["y"], y)


@pytest.mark.parametrize("name", ["config", "scaled_config", "smoke_config"])
def test_paper_dynaps_fields_match_jax(name):
    j, t = getattr(jconfigs, name)(), getattr(tconfigs, name)()
    for field in ("d_in", "d_out", "t_steps", "decay", "threshold",
                  "input_rate", "n_total"):
        assert getattr(t, field) == getattr(j, field), field
    for field in ("cores", "neurons_per_core", "cam_entries_per_core",
                  "scheme", "impl", "chips", "cores_per_chip",
                  "sparse_capacity", "tag_bits"):
        assert getattr(t.fabric, field) == getattr(j.fabric, field), field
    assert t.fabric.noc.scheme == j.fabric.noc.scheme
    assert t.fabric.cam.entries == j.fabric.cam.entries
    assert t.fabric.cam.variant == j.fabric.cam.variant
