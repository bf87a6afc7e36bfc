"""The dry run's per-device pass (`repro_torch.launch.dryrun`) and
``remat_policy`` under the `jax.checkpoint_policies` names.

- The pass counts the local shard's FLOPs of a DTensor product, where
  `FlopCounterMode` around the same product counts the global ones.
- A collective's result under autograd is held once (the wrapper that
  makes it an autograd tensor is an alias; its meta kernel copies).
- The fake rank's FLOPs, collective bytes and collective calls equal, to
  the unit, what rank 0 of a real 4-rank gloo CPU mesh records with the
  same mode, at the smoke configs of internlm2-1.8b (dense) and
  deepseek-v2-lite (MLA and experts) on 2 x 2, for a prefill and a train
  step, and internlm2's train step in two microbatches.  (The mesh's
  train step in microbatches against the JAX step:
  `tests/test_torch_mesh_microbatch.py`.)
- The ranks' FLOPs sum to the cell's global count at internlm2's smoke
  prefill on 1 x 2 under ``serve_tp_only`` (no product is replicated).
- (``cost_calibrated`` against a direct count:
  `tests/test_torch_dryrun_calibration.py`.)
- Against the JAX dry run (`repro.launch.dryrun._lower_one` and
  ``calibrated_costs`` in a subprocess) at the same 1 x 2 prefill, the
  calls counted at two depths of each side and split into a part that
  does not grow with depth and a part a layer: every all-reduce moves
  the same (B, T, d) float32 operand, the embedding lookup makes the
  one fixed all-reduce on both sides, and the port makes GSPMD's two a
  layer (the attention and MLP outputs, each `Partial` sum reduced once
  before its residual add, `repro_torch.models.lm._reduced_like`): the
  JAX dry run's count and bytes exactly, on any torch version
  (`chip_smoke.py` checks the same on the card's).
- Each policy name maps to the policy JAX resolves it to: the JAX
  package's ``REMAT_POLICIES`` names the same `jax.checkpoint_policies`
  object, the aliases are the same objects in JAX, and
  ``nothing_saveable`` saves no product as JAX's ``"none"`` (no
  policy).  Each name runs: gradients bitwise the port's without remat
  (as `tests/test_torch_arch_smoke.py` holds remat) and within rtol 1e-4
  / atol 1e-5 of the leaf's largest of JAX's gradients under the same
  name (the tolerance `tests/test_torch_train_lm.py` holds a step's
  gradients to); factories and unknown names stay refused.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro import configs as jregistry
from repro.models import lm as jlm
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.ckpt.manager import tree_leaves
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshSpec, fake_mesh
from repro_torch.launch.spawn import spawn
from repro_torch.models import lm as tlm
from repro_torch.parallel import sharding as shd
from repro_torch.train import step as tstep
from tests import torch_mesh_ranks as ranks
from tests.test_torch_lm import _leaves, port_config

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESH_2X2 = MeshSpec((2, 2), ("data", "model"))
MESH_1X2 = MeshSpec((1, 2), ("data", "model"))
PREFILL = configs.Shape("prefill_t", 16, 4, "prefill")
TRAIN = configs.Shape("train_t", 16, 4, "train")


def test_dtensor_product_counts_the_local_shard():
    """(256, 4096) on (Shard(0), Shard(1)) times (4096, 8192) on
    (Replicate(), Shard(1)) on a fake 16 x 16 mesh: rank 0 computes a
    (16, 512) block over all 4096 of k, 67,108,864 FLOPs, which is the
    global count times local over global output elements (no output dim
    is `Partial`); `FlopCounterMode` sees the DTensor shapes and counts
    all 17,179,869,184.  Nothing is allocated: the shards are meta."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    with fake_mesh(MeshSpec((16, 16), ("data", "model"))) as mesh:
        a = DTensor.from_local(torch.empty(16, 256, device="meta"), mesh,
                               [Shard(0), Shard(1)], run_check=False,
                               shape=(256, 4096), stride=(4096, 1))
        b = DTensor.from_local(torch.empty(4096, 512, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False,
                               shape=(4096, 8192), stride=(8192, 1))
        rec = dryrun.measure(lambda: a @ b, [a, b])
        counter = FlopCounterMode(display=False)
        with counter:
            out = a @ b
        assert not any(p.is_partial() for p in out.placements)
        local = out.to_local().numel()
    glob = 2 * 256 * 4096 * 8192
    assert counter.get_total_flops() == glob == 17_179_869_184
    assert rec["cost"]["flops"] == glob * local // (256 * 8192) == 67_108_864
    # the first shard's columns are gathered whole over "model" first
    assert rec["collective_counts"] == {"all-gather": 1, "total": 1}
    assert rec["collectives"]["all-gather"] == 256 * 4096 // 16 * 4
    import torch.distributed as dist
    assert not dist.is_initialized()


@pytest.mark.parametrize("src,op", [("Partial", "all-reduce"),
                                    ("Shard", "all-gather")])
def test_a_collective_result_under_autograd_is_held_once(src, op):
    """A (256, 1024) float32 block that requires grad, made whole over
    ``model`` on a fake 2 x 2 mesh: the rank holds the collective's
    result once (the all-reduce's 1 MiB, the gathered 2 MiB), not again
    for the autograd wrapper, an alias that its meta kernel copies."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    with fake_mesh(MESH_2X2) as mesh:
        x = DTensor.from_local(
            torch.empty(256, 1024, device="meta"), mesh,
            [Replicate(), Partial() if src == "Partial" else Shard(0)],
            run_check=False).requires_grad_()
        rec = dryrun.measure(
            lambda: x.redistribute(mesh, [Replicate(), Replicate()]), [x])
    block = 256 * 1024 * 4
    assert rec["collective_counts"] == {op: 1, "total": 1}
    assert rec["memory"]["placed_bytes"] == block
    assert rec["memory"]["temp_bytes"] == (block if op == "all-reduce"
                                           else 2 * block)


def _fake_and_real_cases():
    """Each arch's prefill and train step; internlm2's train step also in
    two microbatches (the JAX dry run's ``mb8`` variant, scaled down)."""
    cases = {f"{arch}/{shape.kind}": (configs.get_smoke_config(arch), shape,
                                      {})
             for arch in ("internlm2-1.8b", "deepseek-v2-lite-16b")
             for shape in (PREFILL, TRAIN)}
    cases["internlm2-1.8b/train/mb2"] = (
        configs.get_smoke_config("internlm2-1.8b"), TRAIN, {"microbatch": 2})
    return cases


def test_fake_rank_equals_a_real_gloo_rank():
    cases = _fake_and_real_cases()
    real = spawn(ranks.dryrun_costs_2x2, 4, args=(cases,), timeout=300)[0]
    for name, (cfg, shape, train_kwargs) in cases.items():
        fake = dryrun.per_device_costs(cfg, shape, MESH_2X2,
                                       train_kwargs=train_kwargs)
        for field in ("collective_counts", "collectives"):
            assert fake[field] == real[name][field], (name, field)
        assert fake["cost"]["flops"] == real[name]["cost"]["flops"], name
        assert fake["collective_counts"]["total"] > 0, name


def test_per_device_flops_sum_to_the_global_count():
    cfg = dataclasses.replace(configs.get_smoke_config("internlm2-1.8b"),
                              serve_tp_only=True)
    per_rank = [dryrun.per_device_costs(cfg, PREFILL, MESH_1X2, rank=r)
                for r in (0, 1)]
    total = sum(r["cost"]["flops"] for r in per_rank)
    assert total == dryrun.count_flops(cfg, PREFILL, {}, {}) > 0
    assert per_rank[0]["cost"]["flops"] == per_rank[1]["cost"]["flops"]


JAX_SIDE = """
    import dataclasses, json, sys
    from repro.launch import dryrun as jd
    from repro.launch import mesh as jm
    from repro import configs
    cases = json.loads(sys.argv[1])
    texts, recs = [], []
    inner, lower = jd.collective_bytes, jd._lower_one
    production = jd.make_production_mesh

    def mesh_of(*, multi_pod=False, shape=None):
        # a (pod, data, model) mesh of any shape for the smoke cells
        if shape is not None and len(shape) == 3:
            return jd.jax.make_mesh(tuple(shape), ("pod", "data", "model"),
                                    **jm._axis_kwargs(3))
        return production(multi_pod=multi_pod, shape=shape)
    jd.make_production_mesh = mesh_of

    def recorded(text):
        texts.append(text)
        return inner(text)

    def lowered(*a, **k):
        recs.append(lower(*a, **k))
        return recs[-1]
    jd.collective_bytes, jd._lower_one = recorded, lowered

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
    for arch, kind, seq, batch, mesh, over in cases:
        name = f"{kind}_{seq}x{batch}"
        configs.SHAPES[name] = configs.Shape(name, seq, batch, kind)
        cfg = dataclasses.replace(configs.get_smoke_config(arch), **over)
        del texts[:], recs[:]
        pods = len(mesh) == 3
        rec = jd._lower_one(cfg, name, multi_pod=pods,
                            mesh_shape=tuple(mesh))
        cal = jd.calibrated_costs(cfg.name, name, cfg, multi_pod=pods,
                                  mesh_shape=tuple(mesh))
        counts, lines = [], []
        for text in texts[1:]:          # the two calibration lowerings
            n = {}
            for line in text.splitlines():
                m = jd.COLLECTIVE_RE.search(line)
                if m:
                    n[m.group(1)] = n.get(m.group(1), 0) + 1
                    if len(counts) == 0:
                        lines.append(line.strip()[:160])
            counts.append(n)
        results.append({"direct": rec["collectives"], "cal": cal,
                        "counts": counts, "layers": cfg.n_layers,
                        "hlo_lines": lines,
                        "costs": [r["cost"] for r in recs[1:]],
                        "calls": [calls(t) for t in texts[1:]]})
    print(json.dumps(results))
"""


def _jax_dry_runs(cases):
    """The JAX dry run of each case ``(arch, kind, seq_len, batch, mesh,
    overrides)``: a ``kind`` step of ``batch`` sequences (a cache of
    ``seq_len`` at decode) at the arch's smoke config with ``overrides``,
    on ``mesh`` (data, model) or (pod, data, model), in one subprocess
    (it sets its own 512 host devices).  Each: the direct and calibrated
    collectives, the calibrated costs, and of the one- and two-repeat
    lowerings the collective calls by op, the costs, and every collective
    line's op and result shapes; the one-repeat lowering's collective
    lines."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)   # the JAX dry run sets its 512 devices
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_SIDE),
                        json.dumps([list(c) for c in cases])],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return json.loads(r.stdout.strip().splitlines()[-1])


def _jax_dry_run(kind="prefill", mesh=(1, 2), tp_only=True,
                 arch="internlm2-1.8b", seq_len=16, batch=4):
    """`_jax_dry_runs` of one case: ``arch``'s smoke config (internlm2's
    by default) at a ``seq_len``-token, ``batch``-sequence ``kind``
    step on ``mesh``, ``serve_tp_only`` as ``tp_only`` says."""
    return _jax_dry_runs([(arch, kind, seq_len, batch, list(mesh),
                           {"serve_tp_only": tp_only})])[0]


def test_all_reduces_against_the_jax_dry_run():
    jax_rec = _jax_dry_run()
    cfg = dataclasses.replace(configs.get_smoke_config("internlm2-1.8b"),
                              serve_tp_only=True)
    layers = jax_rec["layers"]
    assert layers == cfg.n_layers == 2
    operand = PREFILL.global_batch * PREFILL.seq_len * cfg.d_model * 4
    # JAX: the embedding lookup's sum, then two a layer (the attention
    # and MLP outputs), counted from the k = 1 and k = 2 lowerings
    one, two = (c["all-reduce"] for c in jax_rec["counts"])
    jax_fixed, jax_layer = 2 * one - two, two - one
    assert (jax_fixed, jax_layer) == (1, 2)
    jax_count = jax_fixed + jax_layer * layers
    assert jax_rec["cal"]["collectives"]["all-reduce"] == jax_count * operand
    # the port at two and three layers: the same fixed one and JAX's
    # two a layer, each moving the same operand
    at = {k: dryrun.per_device_costs(dryrun._unrolled_variant(cfg, k),
                                     PREFILL, MESH_1X2)
          for k in (2, 3)}
    p2, p3 = (at[k]["collective_counts"]["all-reduce"] for k in (2, 3))
    assert 3 * p2 - 2 * p3 == jax_fixed
    assert p3 - p2 == jax_layer
    for rec in at.values():
        assert rec["collectives"]["all-reduce"] == (
            rec["collective_counts"]["all-reduce"] * operand)
    # at the smoke config's two layers: JAX's 5 calls and 81,920 B
    assert p2 == jax_count == 5
    assert at[2]["collectives"]["all-reduce"] == (
        jax_rec["cal"]["collectives"]["all-reduce"]) == 81_920


# ---- remat_policy by its jax.checkpoint_policies name -----------------------

POLICY_NAMES = ("dots_saveable", "dots_with_no_batch_dims_saveable",
                "everything_saveable", "nothing_saveable", "checkpoint_dots",
                "checkpoint_dots_with_no_batch_dims")


@pytest.fixture(scope="module")
def remat_models():
    jcfg = jregistry.get_smoke_config("internlm2-1.8b")
    jp = jax.jit(jlm.init_model, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg)
    tcfg = port_config(jcfg)
    tp = tlm.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    batch = {"tokens": toks,
             "labels": np.roll(toks, -1, axis=1).astype(np.int32)}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    plain = tstep.value_and_grad(tp, tb, tcfg, remat=False)[2]
    return jcfg, tcfg, jp, tp, batch, tb, plain


def _jax_short_name(name):
    """The JAX package's short name (`repro.models.lm.REMAT_POLICIES`)
    whose policy is the `jax.checkpoint_policies` attribute ``name``;
    ``"none"`` (no policy: nothing saved) for ``nothing_saveable``."""
    policies = jax.checkpoint_policies
    policy = getattr(policies, name)
    same = [short for short, long in jlm.REMAT_POLICIES.items()
            if short is not None and long is not None
            and getattr(policies, long) is policy]
    if not same and policy is policies.nothing_saveable:
        assert jlm.REMAT_POLICIES["none"] is None
        assert not policy(jax.lax.dot_general_p)
        same = ["none"]
    assert len(same) == 1, (name, same)
    return same[0]


@pytest.mark.parametrize("name", POLICY_NAMES)
def test_remat_policy_by_its_jax_name(remat_models, name):
    assert tlm.JAX_POLICY_NAMES[name] == _jax_short_name(name)
    jcfg, tcfg, jp, tp, batch, tb, plain = remat_models
    got = tstep.value_and_grad(tp, tb, tcfg, remat=True, remat_policy=name)[2]
    for a, b in zip(plain, got):
        assert torch.equal(a, b), name
    want = jax.grad(lambda p: jstep.loss_fn(
        p, {k: jax.numpy.asarray(v) for k, v in batch.items()}, jcfg,
        jstep.LOCAL, remat=True, remat_policy=name)[0])(jp)
    want = dict(_leaves(jax.tree.map(np.asarray, want)))
    # the leaves' paths in flatten order, as the gradients come
    paths = tree_leaves(shd.map_with_path(lambda p, _: "/" + p, tp))
    assert sorted(paths) == sorted(want)
    for path, g in zip(paths, got):
        w = np.asarray(want[path], np.float32)
        tol = 1e-4 * np.abs(w) + 1e-5 * float(np.abs(w).max())
        assert np.all(np.abs(g.float().numpy() - w) <= tol), (name, path)


@pytest.mark.parametrize("name", ["save_only_these_names",
                                  "save_anything_except_these_names",
                                  "offload_dot_with_no_batch_dims",
                                  "no_such_policy"])
def test_remat_policy_factories_stay_refused(remat_models, name):
    _, tcfg, _, tp, _, tb, _ = remat_models
    with pytest.raises(NotImplementedError, match="item 12"):
        tstep.value_and_grad(tp, tb, tcfg, remat=True, remat_policy=name)


def main():
    """Print the smoke cells' per-device costs, the port's beside the JAX
    dry run's: internlm2's smoke config, a 4 x 16 prefill on 1 x 2 under
    ``serve_tp_only`` and a 4 x 16 train step on 2 x 2 (FSDP x TP), each
    calibrated to its 2 layers; JSON lines."""
    for kind, mesh, tp_only in (("prefill", (1, 2), True),
                                ("train", (2, 2), False)):
        cfg = dataclasses.replace(configs.get_smoke_config("internlm2-1.8b"),
                                  serve_tp_only=tp_only)
        shape = configs.Shape(f"{kind}_t", 16, 4, kind)
        port = dryrun.calibrated_costs(cfg, shape,
                                       MeshSpec(mesh, ("data", "model")))
        jax_rec = _jax_dry_run(kind, mesh, tp_only)
        print(json.dumps({"cell": [kind, list(mesh), tp_only],
                          "torch": torch.__version__, "port": port,
                          "jax": jax_rec}))


if __name__ == "__main__":
    main()
