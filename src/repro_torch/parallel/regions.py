"""The port's counterpart of ``shard_map``: ``local_map`` regions on a
`ShardCtx`'s `DeviceMesh`, and the collectives their bodies call.

A region runs a function on each rank's local blocks.  Its operands and
results are DTensors whose placements come from specs (tuples of None /
axis name / tuple of axis names, as `repro_torch.parallel.sharding`
writes them); operands are redistributed to the placements asked for on
the way in.  Inside, `model_index` takes the place of
``jax.lax.axis_index`` and `all_reduce` / `all_gather` of ``pmax`` /
``psum`` / ``all_gather`` over the model axis.

Gradients: a result may be `Partial` on the model axis
(`partial_on_model`: each rank holds a summand; DTensor sums them where
a later op needs the value, one all-reduce), and ``in_grad`` names the
placements of an operand's gradient where they differ from its own: an
operand replicated over the model axis whose ranks each use a different
part of it gets a partial gradient there.
"""

from __future__ import annotations

import torch

from repro_torch.models.blocks import ShardCtx

def _fc():
    import torch.distributed._functional_collectives as fc
    return fc


def model_index(ctx: ShardCtx) -> int:
    return ctx.mesh.get_local_rank(ctx.model_axis)


def model_group(ctx: ShardCtx):
    return ctx.mesh.get_group(ctx.model_axis)


def data_coords(ctx: ShardCtx) -> list:
    """(index, size) of this rank on each data axis."""
    sizes = dict(ctx.axis_sizes)
    return [(ctx.mesh.get_local_rank(a), sizes[a]) for a in ctx.data_axes]


def all_reduce(x: torch.Tensor, op: str, ctx: ShardCtx) -> torch.Tensor:
    """``pmax`` / ``psum`` over the model axis (no gradient)."""
    fc = _fc()
    return fc.wait_tensor(fc.all_reduce(x.contiguous(), op,
                                        model_group(ctx)))


class _GatherModel(torch.autograd.Function):
    """Tiled all-gather over the model axis along ``dim``; its gradient
    sums the ranks' gradients and keeps this rank's block (each rank's
    result feeds a different part of the objective)."""

    @staticmethod
    def forward(ctx_, x, dim, group, size):
        fc = _fc()
        ctx_.dim, ctx_.group, ctx_.size = dim, group, size
        xm = x.movedim(dim, 0).contiguous()
        out = fc.wait_tensor(fc.all_gather_tensor(xm, 0, group))
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx_, g):
        fc = _fc()
        gm = g.movedim(ctx_.dim, 0).contiguous()
        out = fc.wait_tensor(fc.reduce_scatter_tensor(gm, "sum", 0,
                                                      ctx_.group))
        return out.movedim(0, ctx_.dim), None, None, None


def all_gather(x: torch.Tensor, dim: int, ctx: ShardCtx) -> torch.Tensor:
    """``jax.lax.all_gather(x, model, axis=dim, tiled=True)``."""
    return _GatherModel.apply(x, dim, model_group(ctx), ctx.model_size)


def placements(spec, ctx: ShardCtx):
    """The DTensor placements of ``spec`` on ``ctx.mesh`` (None for a
    non-tensor operand)."""
    from repro_torch.parallel.sharding import to_placements
    if spec is None:
        return None
    return tuple(to_placements(spec, ctx.mesh))


def partial_on_model(spec, ctx: ShardCtx, data_partial: bool = False):
    """Placements of ``spec`` with the model axis `Partial` (sum), and
    the data axes too when ``data_partial``."""
    from torch.distributed.tensor import Partial
    pl = list(placements(spec, ctx))
    names = list(ctx.mesh.mesh_dim_names)
    pl[names.index(ctx.model_axis)] = Partial()
    if data_partial:
        for a in ctx.data_axes:
            pl[names.index(a)] = Partial()
    return tuple(pl)


def grad_of_replicated(spec, ctx: ShardCtx, batch_split: bool):
    """Gradient placements of an operand replicated as ``spec`` says and
    used by every rank on its own batch shard: a sum over the data axes
    when the batch is split over them, as ``spec`` otherwise (each
    model rank computes the same gradient)."""
    from torch.distributed.tensor import Partial
    pl = list(placements(spec, ctx))
    if batch_split:
        names = list(ctx.mesh.mesh_dim_names)
        for a in ctx.data_axes:
            pl[names.index(a)] = Partial()
    return tuple(pl)


def region(fn, ctx: ShardCtx, in_specs, out_specs, in_grad=None):
    """``local_map(fn)`` on ``ctx.mesh``: ``in_specs`` one spec (or
    placements tuple, or None for a non-tensor) per operand,
    ``out_specs`` one per result (a single spec for one result),
    ``in_grad`` the gradients' placements per operand (None: as the
    operand)."""
    from torch.distributed.tensor.experimental import local_map

    def pl(s):
        if s is None or (isinstance(s, tuple) and s and not isinstance(
                s[0], (str, tuple, type(None)))):
            return s                      # None or already placements
        return placements(s, ctx)

    ins = tuple(pl(s) for s in in_specs)
    if isinstance(out_specs, list):
        outs = tuple(pl(s) for s in out_specs)
    else:
        outs = list(pl(out_specs))    # one result: a list of placements
    grads = None
    if in_grad is not None:
        grads = tuple(g if g is not None else i
                      for g, i in zip(in_grad, ins))
    return local_map(fn, out_placements=outs, in_placements=ins,
                     in_grad_placements=grads, device_mesh=ctx.mesh,
                     redistribute_inputs=True)


def replicate(x):
    """A DTensor replicated on every mesh axis (the use-site all-gather
    of an FSDP / TP-sharded parameter); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def constrain(x, spec, ctx: ShardCtx):
    """``with_sharding_constraint``: ``x`` redistributed to ``spec``."""
    return x.redistribute(ctx.mesh, placements(spec, ctx))


def full(x) -> torch.Tensor:
    """A DTensor's full value on every rank; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x
