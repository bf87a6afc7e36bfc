"""The port's partition specs, placements and shape dry run against the
JAX package.

* `params_pspecs`, `cache_pspecs` and `batch_pspecs` equal the JAX
  package's leaf by leaf for all ten architectures' full configs at the
  (16, 16), (2, 16, 16) and (8, 32) meshes (JAX trees from
  `jax.eval_shape`, a JAX `ShardCtx` with the mesh's ``axis_sizes``; no
  device is needed), and so do the per-device bytes computed from them.
* `to_placements` gives each of 8 gloo CPU ranks (a 2 x 2 x 2 pod x data
  x model mesh) the block JAX's spec assigns its device: a tuple of axes
  on one dim splits it major to minor.  `make_host_mesh` refuses a
  world size other than data x model.
* The registry's cell matrix (`all_cells`: 40 cells, 31 runnable), the
  dry run's `VARIANTS` keys (read from the JAX module's source: importing
  it would set ``XLA_FLAGS`` for the process), and one cell of the dry
  run written to disk with the JAX specs' bytes.
"""

import ast
import functools
import json
import pathlib

import jax
import numpy as np
import pytest

from repro import configs as jregistry
from repro.models import lm as jlm
from repro.models.blocks import ShardCtx as JShardCtx
from repro.parallel import sharding as jshd
from repro_torch import configs as tregistry
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshSpec, make_production_mesh
from repro_torch.launch.spawn import spawn
from repro_torch.models import lm as tlm
from repro_torch.parallel import sharding as tshd
import torch_mesh_ranks as ranks

MESHES = {"16x16": {}, "2x16x16": {"multi_pod": True},
          "8x32": {"shape": (8, 32)}}
ARCHS = tuple(tregistry.ARCHS)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_ctx(mesh: MeshSpec):
    sizes = mesh.sizes
    data_axes = ("pod", "data") if "pod" in sizes else ("data",)
    return JShardCtx(data_axes=data_axes, model_axis="model",
                     model_size=sizes["model"], enabled=True,
                     axis_sizes=tuple(sizes.items()))


def _jax_path(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _jax_specs(tree, specs) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {_jax_path(p): (tuple(s), tuple(leaf.shape), leaf.dtype.itemsize)
            for (p, leaf), s in zip(leaves, spec_leaves)}


def _port_specs(tree, specs) -> dict:
    flat = {}
    tshd.map_with_path(lambda p, s: flat.__setitem__(p, s), specs)
    out = {}
    tshd.map_with_path(lambda p, leaf: out.__setitem__(
        p, (flat[p], tuple(leaf.shape), leaf.element_size())), tree)
    return out


def _bytes(entries: dict, sizes: dict) -> int:
    total = 0
    for spec, shape, item in entries.values():
        parts = 1
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                parts *= sizes[a]
        total += int(np.prod(shape)) * item // parts
    return total


def _trim(spec: tuple, ndim: int) -> tuple:
    """PartitionSpec drops trailing Nones only when built so; compare
    padded to the leaf's rank."""
    return tuple(spec) + (None,) * (ndim - len(spec))


@functools.lru_cache(maxsize=None)
def _trees(arch):
    jcfg = jregistry.get_config(arch)
    tcfg = tregistry.get_config(arch)
    jp = jax.eval_shape(lambda k: jlm.init_model(k, jcfg),
                        jax.random.PRNGKey(0))
    tp = tlm.init_model(None, tcfg, device="meta")
    jc = jax.eval_shape(lambda: jlm.init_cache(jcfg, 128, 1024))
    tc = tlm.init_cache(tcfg, 128, 1024, device="meta")
    return jcfg, tcfg, jp, tp, jc, tc


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_bytes_equal_jax(arch, mesh_name):
    jcfg, tcfg, jp, tp, jc, tc = _trees(arch)
    mesh = make_production_mesh(**MESHES[mesh_name])
    jctx, tctx = _jax_ctx(mesh), tshd.make_shard_ctx(mesh, tcfg)
    for what, jt, tt, jspec, tspec in (
            ("params", jp, tp, jshd.params_pspecs(jp, jcfg, jctx),
             tshd.params_pspecs(tp, tcfg, tctx)),
            ("cache", jc, tc, jshd.cache_pspecs(jc, jcfg, jctx),
             tshd.cache_pspecs(tc, tcfg, tctx))):
        want, got = _jax_specs(jt, jspec), _port_specs(tt, tspec)
        assert sorted(want) == sorted(got), what
        for path, (spec, shape, item) in want.items():
            assert got[path][1] == shape, (what, path)
            assert got[path][2] == item, (what, path)
            assert _trim(got[path][0], len(shape)) == _trim(
                spec, len(shape)), (what, path, got[path][0], spec)
        assert _bytes(got, mesh.sizes) == _bytes(want, mesh.sizes), what
    shapes = {"tokens": (256, 4096), "labels": (256, 4096),
              "frames": (256, 4096, 512)}
    jb = jshd.batch_pspecs(shapes, jcfg, jctx)
    tb = tshd.batch_pspecs(shapes, tcfg, tctx)
    assert {k: tuple(v) for k, v in jb.items()} == tb


def test_dry_run_bytes_are_the_jax_specs_bytes(tmp_path):
    arch, shape = "internlm2-1.8b", "decode_32k"
    rec = dryrun.run_cell(arch, shape, False, str(tmp_path))
    on_disk = json.loads((tmp_path / f"{arch}__{shape}__singlepod.json")
                         .read_text())
    assert on_disk["status"] == "ok" and on_disk["flops"] > 0
    assert rec["memory"] == on_disk["memory"]
    jcfg = jregistry.get_config(arch)
    mesh = make_production_mesh()
    jctx = _jax_ctx(mesh)
    jp = jax.eval_shape(lambda k: jlm.init_model(k, jcfg),
                        jax.random.PRNGKey(0))
    want = _bytes(_jax_specs(jp, jshd.params_pspecs(jp, jcfg, jctx)),
                  mesh.sizes)
    assert rec["memory"]["param_bytes"] == want
    jc = jax.eval_shape(lambda: jlm.init_cache(jcfg, 128, 32768))
    assert rec["memory"]["cache_bytes"] == _bytes(
        _jax_specs(jc, jshd.cache_pspecs(jc, jcfg, jctx)), mesh.sizes)
    assert rec["memory"]["fits_80gb"] == (
        rec["memory"]["total_bytes"] <= 80 * 10**9)
    # an encoder has no decode step: the cell is skipped, as in JAX
    skip = dryrun.run_cell("hubert-xlarge", shape, True, str(tmp_path))
    assert skip["status"] == "skipped" and "encoder-only" in skip["reason"]


def test_cell_matrix_equals_jax():
    assert tregistry.all_cells() == jregistry.all_cells()
    assert len(tregistry.all_cells()) == 40
    assert sum(ok for _, _, ok, _ in tregistry.all_cells()) == 31
    assert {k: tuple(dataclass_fields(v)) for k, v in
            tregistry.SHAPES.items()} == {
        k: tuple(dataclass_fields(v)) for k, v in jregistry.SHAPES.items()}


def dataclass_fields(shape):
    return (shape.name, shape.seq_len, shape.global_batch, shape.kind)


def test_dry_run_variants_equal_jax():
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    keys = next(
        [k.value for k in node.value.keys]
        for node in ast.walk(tree) if isinstance(node, ast.Assign)
        and getattr(node.targets[0], "id", None) == "VARIANTS")
    assert list(dryrun.VARIANTS) == keys


# ---- placements on a 2 x 2 x 2 mesh ------------------------------------------

FULL = np.arange(8 * 4 * 2, dtype=np.float32).reshape(8, 4, 2)
SPECS = ((("pod", "data"), "model", None), ("model", None, None),
         (("data", "model"), None, None), (None, ("pod", "model"), None),
         (("pod", "data", "model"), None, None), (None, None, None))


@pytest.fixture(scope="module")
def placed():
    return spawn(ranks.placements_2x2x2, 8, args=(FULL, SPECS), timeout=300)


def _jax_block(spec, coord):
    """The block JAX's NamedSharding gives the device at ``coord``
    (pod, data, model): each dim split over the product of its axes,
    the first axis major."""
    sizes = {"pod": 2, "data": 2, "model": 2}
    at = dict(zip(("pod", "data", "model"), coord))
    block = FULL
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        parts, idx = 1, 0
        for a in axes:
            idx = idx * sizes[a] + at[a]
            parts *= sizes[a]
        n = FULL.shape[d] // parts
        block = np.take(block, range(idx * n, (idx + 1) * n), axis=d)
    return block


def test_serve_moves_on_2x2x2(placed):
    """The serve steps' moves on gloo ranks of a (pod, data, model) mesh,
    where no gradient is recorded: a split over ("pod", "data") gathered
    whole by one all-gather; a split over data moved to the model ranks
    by one collective-permute, each rank then holding the block JAX
    gives the spec ("model", None, None) at its coordinate; a sum over
    pod and data by one all-reduce."""
    for out in placed:
        coord = out["coord"]
        got, calls, pl = out["moves"]["gathered"]
        np.testing.assert_array_equal(got, FULL)
        assert calls == ["all_gather_into_tensor"], calls
        assert pl == ["Replicate"] * 3
        got, calls, pl = out["moves"]["permuted"]
        np.testing.assert_array_equal(
            got, _jax_block(("model", None, None), coord))
        assert calls == ["collective_permute"], calls
        assert pl == ["Replicate", "Replicate", 0]
        got, calls, _ = out["moves"]["summed"]
        # the ranks at this model coordinate: pod * 4 + data * 2 + model
        ranks = [p * 4 + d * 2 + coord[2] for p in (0, 1) for d in (0, 1)]
        np.testing.assert_array_equal(got, FULL * sum(r + 1 for r in ranks))
        assert calls == ["all_reduce"], calls


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_to_placements_gives_jax_blocks(placed, i):
    coords = set()
    for out in placed:
        coords.add(out["coord"])
        np.testing.assert_array_equal(out["blocks"][i],
                                      _jax_block(SPECS[i], out["coord"]))
    assert len(coords) == 8


def test_host_mesh_refuses_a_wrong_world_size(placed):
    for out in placed:
        assert out["refused"] == [True, True, True]


def test_to_placements_refuses_bad_specs():
    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
    with pytest.raises(ValueError, match="not on the mesh"):
        tshd.to_placements(("chips",), Mesh())
    with pytest.raises(ValueError, match="used twice"):
        tshd.to_placements(("model", "model"), Mesh())
    with pytest.raises(ValueError, match="mesh order"):
        tshd.to_placements((("data", "pod"),), Mesh())
    assert str(tshd.to_placements((("pod", "data"), "model"), Mesh())) == (
        "[Shard(dim=0), Shard(dim=0), Shard(dim=1)]")
