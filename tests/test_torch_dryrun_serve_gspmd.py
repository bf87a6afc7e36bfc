"""The serve steps' last moves beyond GSPMD's, held by the dry run
against the JAX package's (`repro_torch.launch.dryrun`, a fake rank of
the mesh's world size; `repro.launch.dryrun` in a subprocess):

- deepseek-v2-lite-16b's decode_32k at full size on the production
  2 x 16 x 16 mesh: every expert weight gathered in one call over
  ``("pod", "data")`` (`blocks._moe_sharded`; DTensor's redistribution
  gathers each axis in turn, 1.5 times the bytes), so the step's
  collective bytes are within 1.25 times JAX's calibrated figure (they
  were 1.47 times); on 16 x 16 no more than the 4,046,125,472 B the
  port moved before;
- rwkv6-3b's decode step at ``rwkv_pad_heads`` H' > H (the dry run's
  ``rwkv48`` variant at full size on 16 x 16, and H' = 8 at the smoke
  size on 2 x 2): no collective returns the WKV state (the cache holds
  it split by heads, `rwkv6.head_split`), so the state's collective
  bytes a layer (results shaped ``(..., D, D)``) are at most JAX's (GSPMD
  gathers 3 padded heads to 6 over pairs of model ranks at full size);
- rwkv6-3b's decode step at ``rwkv_pad_heads`` 48 at full size on the
  production 2 x 16 x 16 mesh: the time mix on each rank's block of
  heads (`rwkv6.own_heads`), its head weights gathered as column blocks
  in one call over ``("pod", "data")``, so its collective bytes and
  FLOPs are within 1.25 times JAX's;
- rwkv6-3b's decode step with its parameters FSDP-placed on 2 x 2 (the
  smoke size): the embedding lookup gathers no table, only the tokens,
  and moves its rows by one all-to-all (`regions.product_plan`'s
  ``"all_to_all"``), as GSPMD looks the decode step's tokens up;

and a fake rank's calls, bytes by op and FLOPs equal a real gloo rank's
on the two smoke steps (`tests/torch_mesh_ranks.py`
`dryrun_costs_2x2`).  Every JAX case runs in one subprocess, the gloo
ranks in one spawn beside it.
"""

import collections
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshSpec, fake_mesh, make_production_mesh
from repro_torch.launch.spawn import spawn
from repro_torch.models import lm
from repro_torch.parallel import sharding as shd
from tests import torch_mesh_ranks as ranks
from tests.test_torch_dryrun_costs import SRC

BOUND = 1.25
DECODE = "decode_32k"
# the port's deepseek-v2-lite-16b decode_32k on 16 x 16 before the
# experts' one-call gather and the in-place lookup
DSL_SINGLEPOD_BEFORE = 4_046_125_472
SMOKE_MESH = (2, 2)
SMOKE_STEP = (16, 4)                        # cache length, batch
# name -> (arch, overrides, production mesh (multi-pod) or None (smoke))
CASES = {"dsl": ("deepseek-v2-lite-16b", {}, True),
         "rwkv48": ("rwkv6-3b", {"rwkv_pad_heads": 48}, False),
         "rwkv48_pods": ("rwkv6-3b", {"rwkv_pad_heads": 48}, True),
         "pad8": ("rwkv6-3b", {"rwkv_pad_heads": 8}, None),
         "fsdp": ("rwkv6-3b", {}, None)}
JAX_CASES = ("dsl", "rwkv48", "rwkv48_pods", "pad8")

JAX_SIDE = """
    import dataclasses, json, sys
    from repro.launch import dryrun as jd
    from repro import configs
    cases = json.loads(sys.argv[1])
    texts = []
    inner = jd.collective_bytes

    def recorded(text):
        texts.append(text)
        return inner(text)
    jd.collective_bytes = recorded

    def calls(text):
        # each collective line: its op and its result shapes
        out = []
        for line in text.splitlines():
            m = jd.COLLECTIVE_RE.search(line)
            if m:
                shapes = [[dt, [int(d) for d in dims.split(",") if d]]
                          for dt, dims in jd.SHAPE_RE.findall(
                              line[:m.start()]) if dt in jd.DTYPE_BYTES]
                out.append([m.group(1), shapes])
        return out

    results = []
    for arch, over, multi_pod, seq, batch, mesh in cases:
        if mesh is None:                      # production size and mesh
            cfg, name = configs.get_config(arch), "decode_32k"
        else:
            cfg, name = configs.get_smoke_config(arch), f"decode_{seq}x{batch}"
            configs.SHAPES[name] = configs.Shape(name, seq, batch, "decode")
        cfg = dataclasses.replace(cfg, **over)
        del texts[:]
        cal = jd.calibrated_costs(cfg.name, name, cfg, multi_pod=multi_pod,
                                  mesh_shape=None if mesh is None
                                  else tuple(mesh))
        results.append({"cal": cal, "calls": [calls(t) for t in texts]})
    print(json.dumps(results))
"""


def _jax_dry_runs(names):
    """JAX's calibrated costs and the collective calls of its one- and
    two-repeat lowerings, for each case of `CASES` named, in one
    subprocess (it sets its own 512 host devices)."""
    cases = []
    for name in names:
        arch, over, multi_pod = CASES[name]
        smoke = multi_pod is None
        cases.append([arch, over, bool(multi_pod), *SMOKE_STEP,
                      list(SMOKE_MESH) if smoke else None])
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_SIDE),
                        json.dumps(cases)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(zip(names, json.loads(r.stdout.strip().splitlines()[-1])))


def _cfg(name, repeats=None):
    arch, over, multi_pod = CASES[name]
    cfg = (configs.get_smoke_config(arch) if multi_pod is None
           else configs.get_config(arch))
    cfg = dataclasses.replace(cfg, **over)
    return cfg if repeats is None else dryrun._unrolled_variant(cfg, repeats)


def _mesh(name, multi_pod=None):
    multi = CASES[name][2] if multi_pod is None else multi_pod
    if multi is None:
        return MeshSpec(SMOKE_MESH, ("data", "model"))
    return make_production_mesh(multi_pod=multi)


def _shape(name):
    if CASES[name][2] is None:
        seq, batch = SMOKE_STEP
        return configs.Shape(f"decode_{seq}x{batch}", seq, batch, "decode")
    return configs.SHAPES[DECODE]


def _port(name, multi_pod=None):
    """The port's pass at `dryrun.CALIBRATION_REPEATS` repeats, each
    with its collective calls: (records, calls)."""
    recs, calls = [], []
    for k in dryrun.CALIBRATION_REPEATS:
        mode = ranks._collective_log()
        with mode:
            recs.append(dryrun.per_device_costs(
                _cfg(name, k), _shape(name), _mesh(name, multi_pod)))
        calls.append(mode.calls)
    return recs, calls


def _calibrated_total(name, recs, field="collectives", key="total"):
    cfg = _cfg(name)
    base = cfg.moe.first_k_dense if cfg.moe is not None else 0
    reps = (cfg.n_layers - base) / max(cfg.scan_group, 1)
    return dryrun._affine(recs[0][field][key], recs[1][field][key], reps)


def _state_bytes(calls, hd):
    """Bytes of the collectives whose results are WKV states (trailing
    dims (D, D)), float32, by `repro.launch.dryrun.collective_bytes`'s
    convention (the gathered result; the operand of the others, the same
    shape)."""
    return sum(4 * torch.Size(s).numel() for _, s, _ in calls
               if tuple(s[-2:]) == (hd, hd))


def _jax_calls(rec):
    """JAX's calls of its two lowerings as `ranks._collective_log` logs
    them (one entry a result)."""
    return [[(op, tuple(d), None) for op, shapes in c for _, d in shapes]
            for c in rec["calls"]]


def _lookup_costs(name):
    """`dryrun.measure` of the embedding alone (`lm._embed_sharded`) of
    the smoke case's decode step, on a fake rank."""
    cfg = _cfg(name)
    with fake_mesh(_mesh(name)) as mesh:
        ctx = shd.make_shard_ctx(mesh, cfg)
        params, p_specs, batch, b_specs, _, _ = dryrun._operands(
            cfg, _shape(name), ctx)
        params = shd.shard_tree(params, p_specs, mesh)
        batch = shd.shard_tree(batch, b_specs, mesh)

        def step():
            with torch.no_grad():
                return lm._embed_sharded(params, batch, cfg, ctx)
        return dryrun.measure(step, [params["embed"], batch["tokens"]])


def _real_cases():
    return {name: (_cfg(name), _shape(name), {})
            for name in ("pad8", "fsdp")}


@pytest.fixture(scope="module")
def runs():
    """(JAX's records by case, a real rank 0's records by case), the JAX
    dry run in a subprocess while the gloo ranks run."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        real = pool.submit(spawn, ranks.dryrun_costs_2x2, 4,
                           args=(_real_cases(),), timeout=300)
        jax_recs = _jax_dry_runs(JAX_CASES)
        return jax_recs, real.result()[0]


def test_experts_gathered_in_one_call_within_the_bound(runs):
    jax_total = runs[0]["dsl"]["cal"]["collectives"]["total"]
    recs, calls = _port("dsl")
    total = _calibrated_total("dsl", recs)
    cfg = _cfg("dsl")
    mesh = _mesh("dsl")
    data = mesh.sizes["pod"] * mesh.sizes["data"]
    expert = (cfg.moe.num_experts // mesh.sizes["model"] * cfg.d_model
              * cfg.moe.d_expert)
    for k, c in zip(dryrun.CALIBRATION_REPEATS, calls):
        gathers = collections.Counter(
            (torch.Size(s).numel(), size) for op, s, size in c
            if op == "all-gather" and len(s) == 3)
        # three expert weights a MoE layer, each in one call over the 32
        # ranks of ("pod", "data"), none first over one axis of them
        kcfg = _cfg("dsl", k)
        moe = sum(map(kcfg.layer_is_moe, range(kcfg.n_layers)))
        print(f"{k} repeats: 3-D gathers (elements, group size) "
              f"{dict(gathers)}")
        assert {key: n for key, n in gathers.items()
                if key[0] == expert} == {(expert, data): 3 * moe}, k
        assert not [key for key in gathers
                    if key[0] in (expert // 2, expert // 16)], k
    print(f"deepseek-v2-lite-16b {DECODE} 2 x 16 x 16: port {total} B, JAX "
          f"{jax_total} B ({total / jax_total:.3f})")
    assert 0 < total <= BOUND * jax_total
    single, _ = _port("dsl", multi_pod=False)
    assert _calibrated_total("dsl", single) <= DSL_SINGLEPOD_BEFORE


def test_rwkv48_time_mix_on_its_heads_within_the_bound(runs):
    """rwkv48's decode_32k on 2 x 16 x 16: each rank runs the time mix on
    its block of heads (`rwkv6.own_heads`), ``wr``, ``wk``, ``wv`` and
    ``wg`` gathered as column blocks of its 3 heads over the 32 ranks of
    ``("pod", "data")`` (GSPMD gathers 5 heads' (2560, 320)), ``wo``
    whole as GSPMD gathers it, none of the four whole: collective bytes
    and FLOPs within 1.25 times JAX's (the parent read 2.10 and 1.63
    times)."""
    cal = runs[0]["rwkv48_pods"]["cal"]
    recs, calls = _port("rwkv48_pods")
    cfg = _cfg("rwkv48_pods")
    d, hd = cfg.d_model, cfg.rwkv.head_dim
    block = -(-d // hd // make_production_mesh(multi_pod=True).sizes[
        "model"]) * hd
    for k, c in zip(dryrun.CALIBRATION_REPEATS, calls):
        gathers = collections.Counter(
            (s, size) for op, s, size in c if op == "all-gather"
            and len(s) == 2 and d in s)
        print(f"{k} repeats: 2-D gathers of d rows (shape, group size) "
              f"{dict(gathers)}")
        assert gathers[((d, block), 32)] == 4 * k, k
        # wo and the channel mix's wr
        assert gathers[((d, d), 32)] == 2 * k, k
    total = _calibrated_total("rwkv48_pods", recs)
    flops = _calibrated_total("rwkv48_pods", recs, "cost", "flops")
    jax_total, jax_flops = cal["collectives"]["total"], cal["flops"]
    print(f"rwkv48 {DECODE} 2 x 16 x 16: port {total} B, {flops:.4g} "
          f"FLOPs; JAX {jax_total} B, {jax_flops:.4g} FLOPs")
    assert 0 < total <= BOUND * jax_total
    assert 0 < flops <= BOUND * jax_flops


@pytest.mark.parametrize("name", ["rwkv48", "pad8"])
def test_wkv_state_stays_split(runs, name):
    cfg = _cfg(name)
    hd = cfg.rwkv.head_dim
    _, calls = _port(name)
    port = [_state_bytes(c, hd) for c in calls]
    one, two = (_state_bytes(c, hd) for c in _jax_calls(runs[0][name]))
    layer = (port[1] - port[0], two - one)
    print(f"{name}: state collective bytes by repeats {port}, a layer "
          f"{layer[0]} (JAX {layer[1]})")
    # no collective returns the state, at any depth
    assert port == [0, 0]
    assert layer[0] <= layer[1]


def test_decode_lookup_gathers_no_table():
    cfg = _cfg("fsdp")
    rec = _lookup_costs("fsdp")
    batch = SMOKE_STEP[1]
    data, model = SMOKE_MESH
    # the tokens gathered over data (int32); each rank's columns of the
    # vocab block looked up for all of them, summed over model, the rows
    # moved: B x d / data float32 each
    moved = batch * cfg.d_model // data * 4
    print(f"the lookup's collectives {rec['collectives']}, calls "
          f"{rec['collective_counts']}")
    assert rec["collectives"] == {"all-gather": batch * 4,
                                  "all-reduce": moved, "all-to-all": moved,
                                  "total": batch * 4 + 2 * moved}
    assert cfg.vocab // model * cfg.d_model * 4 > 2 * moved


def test_fake_rank_equals_a_real_gloo_rank(runs):
    real = runs[1]
    for name, (cfg, shape, _) in _real_cases().items():
        fake = dryrun.per_device_costs(cfg, shape, _mesh(name))
        for field in ("collective_counts", "collectives"):
            assert fake[field] == real[name][field], (name, field)
        assert fake["cost"]["flops"] == real[name]["cost"]["flops"], name
    assert real["fsdp"]["collective_counts"]["all-to-all"] == 1
