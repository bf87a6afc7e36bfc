"""Mesh construction.

Port of `repro.launch.mesh`.  A `torch.distributed.device_mesh.DeviceMesh`
is built over a process group that is already running (`spawn` starts
one); the constructors take the device type from the caller and never
pick a backend themselves: `init_process_group` with NCCL is the route
when each rank has its own card, gloo the route for ranks on the CPU or
for several ranks sharing one card.

`make_production_mesh` needs no process group: it describes the
production meshes (`MeshSpec`) for the dry run, which places nothing.
`fake_mesh` builds a `DeviceMesh` of such a spec for one rank over a
``fake`` process group (no peers, no transport): the dry run's
per-device pass runs a cell's step there.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh's shape and axis names, without devices."""
    shape: tuple
    axis_names: tuple

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))


def make_production_mesh(*, multi_pod: bool = False, shape=None) -> MeshSpec:
    """(16, 16) data x model single pod, or (2, 16, 16) pod x data x model.

    `shape` overrides the single-pod (data, model) factorization with the
    same 256-chip budget (e.g. (8, 32) for serving wide-TP)."""
    if shape is not None and not multi_pod:
        axes = ("data", "model")
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshSpec(tuple(shape), axes)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a `MeshSpec` or a `DeviceMesh`."""
    if isinstance(mesh, MeshSpec):
        return mesh.sizes
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _device_type(device) -> str:
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; a mesh is on the card unless "
            "the caller passes device='cpu'")
    return kind


def make_mesh(shape, axes, device=None, ranks=None):
    """A `DeviceMesh` of ``shape`` named ``axes`` over ``ranks`` (all
    ranks of the running process group when None), on the CUDA device
    unless ``device="cpu"``.  A mesh on the card over a gloo group
    stages its functional collectives through host memory
    (`repro_torch.launch.staging`, counted).

    Raises:
      RuntimeError: when no process group runs.
      ValueError: when ``ranks`` are not as many as the mesh's points.
    """
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a running process group "
                           "(torch.distributed.init_process_group)")
    kind = _device_type(device)
    n = 1
    for s in shape:
        n *= s
    ranks = list(range(dist.get_world_size())) if ranks is None else ranks
    if len(ranks) != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, have "
                         f"{len(ranks)}")
    if kind == "cuda" and dist.get_backend() == "gloo":
        from repro_torch.launch import staging
        staging.install()
    return DeviceMesh(kind, torch.tensor(ranks).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """(data, model) mesh over every rank of the running process group.

    Raises:
      ValueError: when ``data * model`` is not the world size (the JAX
        function raises on too few devices; a rank outside the mesh
        would have nothing to run).
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data * model != world:
        raise ValueError(f"need {data * model} ranks, have {world}")
    return make_mesh((data, model), ("data", "model"), device)


def make_chip_mesh(chips: int, device=None):
    """1D ``("chips",)`` mesh over ranks 0..chips-1 for sharded interface
    sessions (`InterfaceSession.run(shard="chips")`): one rank per
    simulated neuromorphic chip.  Callers fall back to the single-device
    body when fewer ranks exist than chips.

    Raises:
      ValueError: when the process group has fewer than ``chips`` ranks.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if chips > world:
        raise ValueError(f"need {chips} ranks for a chip mesh, have {world}")
    return make_mesh((chips,), ("chips",), device, ranks=list(range(chips)))


@contextlib.contextmanager
def fake_mesh(spec: MeshSpec, rank: int = 0):
    """A CPU `DeviceMesh` of ``spec``'s shape and axes as rank ``rank``
    of a ``fake`` process group of the mesh's world size
    (`torch.testing._internal.distributed.fake_pg.FakeStore`): its
    collectives return at once and move nothing, so one process runs a
    rank's share of a production mesh.  The group is destroyed on exit.

    Raises:
      RuntimeError: when a process group already runs (the fake group
        is process-global).
    """
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a fake mesh needs a process without a process "
                           "group; one already runs")
    world = 1
    for s in spec.shape:
        world *= s
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield DeviceMesh("cpu", torch.arange(world).reshape(spec.shape),
                         mesh_dim_names=spec.axis_names)
    finally:
        dist.destroy_process_group()
