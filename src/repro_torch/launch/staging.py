"""Host staging of the functional collectives for gloo ranks on a card.

DTensor redistributes and the port's ``local_map`` regions communicate
through ``torch.ops._c10d_functional``.  gloo stages CUDA tensors for its
own collectives (``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single`` all run on an H100),
but the functional ops reach it through its coalesced entry points,
and ``all_gather_into_tensor`` there ended the ranks on an H100
(torch 2.11; `tools/gloo_cuda_probe.py`).  `install` registers CUDA
kernels for those ops that copy the operand to host memory, run the
collective there over the same gloo group, and copy the result back to
the card.  Every staged call adds one to `COUNTS` under its op's name,
the bytes it copies between the card and the host (its operand down,
its result back) to `BYTES` and one to `SHAPES` under its op's name and
result shape, so a caller can print how many collectives, and how many
bytes, went through the host, and which tensors they returned.  The port's
own ``repro_torch::collective_permute`` (a pair exchange by
``batch_isend_irecv``) is staged and counted the same way.

It is installed only where a mesh on the card runs over a gloo group
(`repro_torch.launch.mesh.make_mesh`); NCCL ranks never take it.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

COUNTS: collections.Counter = collections.Counter()
BYTES: collections.Counter = collections.Counter()
SHAPES: collections.Counter = collections.Counter()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}
_LIB = None


def _group(name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


def _count(op: str, x: torch.Tensor, out: torch.Tensor) -> None:
    COUNTS[op] += 1
    BYTES[op] += (x.numel() + out.numel()) * x.element_size()
    SHAPES[op, tuple(out.shape)] += 1


def _reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    host = x.detach().to("cpu", copy=True)    # the operand stays as it is
    if op == "avg":
        dist.all_reduce(host, dist.ReduceOp.SUM, group=group)
        host = host / dist.get_world_size(group)
    else:
        dist.all_reduce(host, _OPS[op], group=group)
    return host


def all_reduce(x, reduce_op, group_name):
    host = _reduce(x, reduce_op, _group(group_name))
    _count("all_reduce", x, host)
    return host.to(x.device)


def all_reduce_(x, reduce_op, group_name):
    host = _reduce(x, reduce_op, _group(group_name))
    _count("all_reduce", x, host)
    x.copy_(host)
    return x


def all_reduce_coalesced(xs, reduce_op, group_name):
    return [all_reduce(x, reduce_op, group_name) for x in xs]


def all_gather_into_tensor(x, group_size, group_name):
    host = x.detach().contiguous().cpu()
    out = host.new_empty((host.shape[0] * group_size,) + host.shape[1:])
    dist.all_gather_into_tensor(out, host, group=_group(group_name))
    _count("all_gather_into_tensor", x, out)
    return out.to(x.device)


def all_gather_into_tensor_coalesced(xs, group_size, group_name):
    return [all_gather_into_tensor(x, group_size, group_name) for x in xs]


def reduce_scatter_tensor(x, reduce_op, group_size, group_name):
    host = x.detach().contiguous().cpu()
    out = host.new_empty((host.shape[0] // group_size,) + host.shape[1:])
    op = dist.ReduceOp.SUM if reduce_op == "avg" else _OPS[reduce_op]
    dist.reduce_scatter_tensor(out, host, op, group=_group(group_name))
    if reduce_op == "avg":
        out = out / group_size
    _count("reduce_scatter_tensor", x, out)
    return out.to(x.device)


def reduce_scatter_tensor_coalesced(xs, reduce_op, group_size, group_name):
    return [reduce_scatter_tensor(x, reduce_op, group_size, group_name)
            for x in xs]


def all_to_all_single(x, output_split_sizes, input_split_sizes, group_name):
    group = _group(group_name)
    host = x.detach().contiguous().cpu()
    if output_split_sizes is None:
        out = torch.empty_like(host)
    else:
        out = host.new_empty((sum(output_split_sizes),) + host.shape[1:])
    dist.all_to_all_single(out, host, output_split_sizes, input_split_sizes,
                           group=group)
    _count("all_to_all_single", x, out)
    return out.to(x.device)


def collective_permute(x, peer):
    """`repro_torch.parallel.regions.permute_op` through the host: this
    rank's block to global rank ``peer``, ``peer``'s back (a host copy
    when ``peer`` is this rank: counted all the same, as every rank's
    program makes the call)."""
    from repro_torch.parallel import regions
    host = x.detach().contiguous().cpu()
    out = regions.send_recv(host, peer)
    _count("collective_permute", x, out)
    return out.to(x.device)


def install(device_type: str = "CUDA") -> None:
    """Register the staged kernels for ``device_type`` (once a process),
    the port's ``repro_torch::collective_permute`` with them.  Tests
    register them for ``"CPU"`` to run the same code on gloo CPU
    ranks."""
    global _LIB
    if _LIB is not None:
        return
    from repro_torch.parallel import regions
    regions.permute_op().register_kernel(device_type.lower())(
        collective_permute)
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name, fn in (("all_reduce", all_reduce), ("all_reduce_", all_reduce_),
                     ("all_reduce_coalesced", all_reduce_coalesced),
                     ("all_gather_into_tensor", all_gather_into_tensor),
                     ("all_gather_into_tensor_coalesced",
                      all_gather_into_tensor_coalesced),
                     ("reduce_scatter_tensor", reduce_scatter_tensor),
                     ("reduce_scatter_tensor_coalesced",
                      reduce_scatter_tensor_coalesced),
                     ("all_to_all_single", all_to_all_single)):
        lib.impl(name, fn, device_type)
    _LIB = lib


def installed() -> bool:
    return _LIB is not None
