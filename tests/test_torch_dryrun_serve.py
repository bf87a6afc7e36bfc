"""The mesh's serve steps against the JAX dry run: the products of
weights split over the data axes (FSDP) partitioned as GSPMD partitions
the JAX package's decode steps (`repro_torch.models.blocks._linear`,
`repro_torch.parallel.regions.product_plan`).

At the smoke configs of rwkv6-3b (RWKV's time mix, ``(data, None)``)
and llama3.2-3b (``attn_shard="sequence"``: weights whole over
``model``), on a 2 x 2 mesh (data and model of one size, as 16 x 16):
a decode step of 4 sequences (2 a data rank, a cache of 16) and a
one-sequence step (the batch does not split: long_500k's case).  This
size shows the production pattern in JAX's post-SPMD HLO: at decode
each time-mix / projection block ``f32[32,64]`` (``[24,48]`` ...) goes
by one ``collective-permute`` from device (d, m) to (m, d), the dots
run on half the contraction dim, and the partial sums are all-reduced
over ``model``; at one sequence no weight moves.

Held by the calls of the JAX dry run's one- and two-repeat lowerings
(a subprocess) against the port's per-device pass at two and three
(`repro_torch.launch.dryrun.per_device_costs` on a fake 2 x 2 group),
each split into the part a layer adds:

- the weights a layer moves (the collectives with 2-D results, by
  elements): at decode the port permutes the blocks JAX permutes and
  gathers the weights JAX gathers, but for two named differences where
  GSPMD moves more or differently (`DIFFERENT`); at one sequence
  neither moves a weight;
- at decode the all-reduces a layer makes: the same tensors and bytes
  (JAX's tupled ones counted by element);
- collective bytes and FLOPs in all within 1.25 times JAX's, FLOPs
  counted as each side counts them (XLA's cost analysis also counts
  elementwise work), and a layer's FLOPs; a layer's bytes at decode.
  At one sequence each collective of a layer moves at most one row of
  the widest activation: there the port gathers the two
  column-parallel outputs over data where GSPMD keeps the stream split
  along d and reduces the norms' sums (rwkv6-3b's smoke layer 2,944 B
  against JAX's 2,312).

And the fake rank's calls, bytes by op and FLOPs equal a real gloo rank's
on the same steps (`tests/torch_mesh_ranks.py` `dryrun_costs_2x2`): the
permute runs as pairs of sends and receives there.
"""

import collections
import concurrent.futures

import pytest
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.spawn import spawn
from tests import torch_mesh_ranks as ranks
from tests.test_torch_dryrun_costs import _jax_dry_runs

MESH = (2, 2)
STEPS = {"decode": (16, 4), "one": (16, 1)}       # cache length, batch
ARCHS = ("rwkv6-3b", "llama3.2-3b")
CASES = [(arch, step) for arch in ARCHS for step in STEPS]
BOUND = 1.25
# where the port and GSPMD move a layer's weights differently at decode
# (elements of each 2-D collective result):
# - rwkv6-3b's decay_w2 (8, 64), split by columns over data: GSPMD
#   moves its input's rows (a permute, a gather over model and an
#   all-to-all of activations); the port gathers the weight;
# - llama3.2-3b's wo (48, 48) and w_down (128, 48), split by columns
#   over data: GSPMD permutes each block to the model ranks and then
#   gathers it there; the port gathers it over data (the same gathered
#   bytes, without the permute).
DIFFERENT = {"rwkv6-3b": {"port_gathers": [8 * 64]},
             "llama3.2-3b": {"jax_permutes": [48 * 24, 128 * 24]}}


def _shape(step):
    seq, batch = STEPS[step]
    return configs.Shape(f"decode_{seq}x{batch}", seq, batch, "decode")


class _Calls(TorchDispatchMode):
    """Each functional collective (and the port's permute) a rank runs:
    (op, result shapes), under the dry run's names."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name.split("::")[-1]
        if (func.namespace in dryrun.COLLECTIVE_NAMESPACES
                and name in dryrun.COLLECTIVE_OPS):
            res = out if isinstance(out, (list, tuple)) else [out]
            self.calls.append((dryrun.COLLECTIVE_OPS[name],
                               tuple(tuple(t.shape) for t in res)))
        return out


def _tensors(calls):
    """A multiset of (op, result shape) by tensor (a tupled JAX
    collective counts each element)."""
    return collections.Counter((op, s) for op, shapes in calls
                               for s in shapes)


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n


def _bytes(counter):
    """Bytes by op of a float32 multiset (every collective here moves
    float32 but the tokens, which no layer moves)."""
    out = collections.Counter()
    for (op, s), n in counter.items():
        out[op] += 4 * _numel(s) * n
    return out


def _weights(counter, op):
    """Elements of each 2-D result of ``op``, sorted: the weights."""
    return sorted(_numel(s) for (o, s), n in counter.items()
                  for _ in range(n) if o == op and len(s) == 2)


def _port(arch, step):
    """The port's pass at two and three repeats: (records, per-layer
    multiset)."""
    recs, calls = [], []
    for k in dryrun.CALIBRATION_REPEATS:
        cfg = dryrun._unrolled_variant(configs.get_smoke_config(arch), k)
        mode = _Calls()
        with mode:
            recs.append(dryrun.per_device_costs(
                cfg, _shape(step), MeshSpec(MESH, ("data", "model"))))
        calls.append(_tensors(mode.calls))
    return recs, calls[1] - calls[0]


def _jax(rec):
    """The JAX lowerings' per-layer multiset and FLOPs a layer."""
    one, two = (_tensors([(op, [tuple(d) for _, d in shapes])
                          for op, shapes in calls])
                for calls in rec["calls"])
    f1, f2 = (c["flops"] for c in rec["costs"])
    return two - one, f2 - f1


def _real_cases():
    return {f"{arch}/{step}": (configs.get_smoke_config(arch), _shape(step),
                               {})
            for arch, step in CASES}


@pytest.fixture(scope="module")
def runs():
    """(JAX's records by case, a real rank 0's records by case name),
    the JAX dry run in a subprocess while the gloo ranks run."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        real = pool.submit(spawn, ranks.dryrun_costs_2x2, 4,
                           args=(_real_cases(),), timeout=300)
        jax_recs = _jax_dry_runs([(arch, "decode", *STEPS[step], list(MESH),
                                   {}) for arch, step in CASES])
        return dict(zip(CASES, jax_recs)), real.result()[0]


@pytest.mark.parametrize("arch,step", CASES)
def test_weights_move_as_gspmd_moves_them(runs, arch, step):
    jax_layer, _ = _jax(runs[0][(arch, step)])
    _, port_layer = _port(arch, step)
    jax_perm = _weights(jax_layer, "collective-permute")
    jax_gath = _weights(jax_layer, "all-gather")
    port_perm = _weights(port_layer, "collective-permute")
    port_gath = _weights(port_layer, "all-gather")
    print(f"{arch} {step}: a layer permutes {port_perm} (JAX {jax_perm}), "
          f"gathers {port_gath} (JAX {jax_gath})")
    if step == "one":
        assert jax_perm == jax_gath == port_perm == port_gath == []
        return
    diff = DIFFERENT[arch]
    assert jax_perm, "the smoke size must show JAX's permuted blocks"
    assert sorted(port_perm + diff.get("jax_permutes", [])) == jax_perm
    assert sorted(jax_gath + diff.get("port_gathers", [])) == port_gath


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_reduces_the_partial_sums_as_gspmd(runs, arch):
    """Every partial sum a layer's products leave is all-reduced once,
    in JAX's shapes: the row-parallel projections' and the decode
    attention's combine."""
    jax_layer, _ = _jax(runs[0][(arch, "decode")])
    _, port_layer = _port(arch, "decode")

    def reduces(c):
        return sorted(_numel(s) for (op, s), n in c.items()
                      for _ in range(n) if op == "all-reduce")
    assert reduces(port_layer) == reduces(jax_layer)
    assert _bytes(port_layer)["all-reduce"] == _bytes(jax_layer)["all-reduce"]


@pytest.mark.parametrize("arch,step", CASES)
def test_bytes_and_flops_within_the_bound(runs, arch, step):
    jax_rec = runs[0][(arch, step)]
    jax_layer, jax_flops = _jax(jax_rec)
    recs, port_layer = _port(arch, step)
    layers = configs.get_smoke_config(arch).n_layers
    at = recs[dryrun.CALIBRATION_REPEATS.index(layers)]
    port_total = at["collectives"]["total"]
    jax_total = jax_rec["cal"]["collectives"]["total"]
    layer = (sum(_bytes(port_layer).values()),
             sum(_bytes(jax_layer).values()))
    flops_layer = (recs[1]["cost"]["flops"] - recs[0]["cost"]["flops"],
                   jax_flops)
    flops = (at["cost"]["flops"], jax_rec["cal"]["flops"])
    print(f"{arch} {step}: bytes {port_total} (JAX {jax_total}), a layer "
          f"{layer}; FLOPs {flops}, a layer {flops_layer}")
    held = [(port_total, jax_total), flops, flops_layer]
    if step == "decode":
        held.append(layer)
    else:
        cfg = configs.get_smoke_config(arch)
        widest = max(cfg.d_model, cfg.d_ff)
        assert all(_numel(s) <= widest for _, s in port_layer), port_layer
    for port, jax in held:
        assert 0 < port <= BOUND * jax, (port, jax)


def test_fake_rank_equals_a_real_gloo_rank(runs):
    real = runs[1]
    for name, (cfg, shape, _) in _real_cases().items():
        fake = dryrun.per_device_costs(cfg, shape,
                                       MeshSpec(MESH, ("data", "model")))
        for field in ("collective_counts", "collectives"):
            assert fake[field] == real[name][field], (name, field)
        assert fake["cost"]["flops"] == real[name]["cost"]["flops"], name
    assert real["rwkv6-3b/decode"]["collective_counts"][
        "collective-permute"] > 0
