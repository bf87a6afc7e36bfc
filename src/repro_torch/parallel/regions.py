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


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Tiled all-gather of ``x`` over ``group`` along ``dim``."""
    fc = _fc()
    xm = x.movedim(dim, 0).contiguous()
    return fc.wait_tensor(fc.all_gather_tensor(xm, 0, group)).movedim(0, dim)


class _GatherModel(torch.autograd.Function):
    """Tiled all-gather over the model axis along ``dim``; its gradient
    sums the ranks' gradients and keeps this rank's block (each rank's
    result feeds a different part of the objective)."""

    @staticmethod
    def forward(ctx_, x, dim, group, size):
        ctx_.dim, ctx_.group, ctx_.size = dim, group, size
        return _gather(x, dim, group)

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


class _SumModel(torch.autograd.Function):
    """``psum`` over the model axis where each rank reads the sum for a
    different part of the objective (a region whose result is a `Partial`
    sum): the gradient of each summand is the sum of the ranks'
    gradients, a ``psum`` too."""

    @staticmethod
    def forward(ctx_, x, group):
        fc = _fc()
        ctx_.group = group
        return fc.wait_tensor(fc.all_reduce(x.contiguous(), "sum", group))

    @staticmethod
    def backward(ctx_, g):
        fc = _fc()
        return fc.wait_tensor(fc.all_reduce(g.contiguous(), "sum",
                                            ctx_.group)), None


def psum(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """The sum of ``x`` over the model axis, differentiable (`_SumModel`)."""
    return _SumModel.apply(x, model_group(ctx))


class _SplitModel(torch.autograd.Function):
    """This rank's block of ``x`` (the same on every rank) along ``dim``;
    the gradient, each rank's for its own block, is gathered whole."""

    @staticmethod
    def forward(ctx_, x, dim, index, group):
        ctx_.dim, ctx_.group = dim, group
        n = x.shape[dim] // group.size()
        return x.narrow(dim, index * n, n)

    @staticmethod
    def backward(ctx_, g):
        return _gather(g, ctx_.dim, ctx_.group), None, None, None


class _GatherWhole(torch.autograd.Function):
    """Tiled all-gather over the model axis along ``dim`` whose result
    every rank uses alike; the gradient (the same on every rank) keeps
    this rank's block."""

    @staticmethod
    def forward(ctx_, x, dim, index, group):
        ctx_.dim, ctx_.index, ctx_.n = dim, index, x.shape[dim]
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx_, g):
        return (g.narrow(ctx_.dim, ctx_.index * ctx_.n, ctx_.n), None, None,
                None)


def split_model(x: torch.Tensor, dim: int, ctx: ShardCtx) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x``, whole on every rank (a
    ``with_sharding_constraint`` from replicated to split, no
    communication); its gradient is gathered (`_SplitModel`)."""
    return _SplitModel.apply(x, dim, model_index(ctx), model_group(ctx))


def gather_whole(x: torch.Tensor, dim: int, ctx: ShardCtx) -> torch.Tensor:
    """The blocks of `split_model` gathered whole along ``dim``, for a use
    that every rank makes alike (`_GatherWhole`)."""
    return _GatherWhole.apply(x, dim, model_index(ctx), model_group(ctx))


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over the model axis along dim 0; its gradient
    goes back the way it came (the splits swapped)."""

    @staticmethod
    def forward(ctx_, x, send, recv, group):
        fc = _fc()
        ctx_.send, ctx_.recv, ctx_.group = send, recv, group
        return fc.wait_tensor(fc.all_to_all_single(x.contiguous(), recv,
                                                   send, group))

    @staticmethod
    def backward(ctx_, g):
        fc = _fc()
        return fc.wait_tensor(fc.all_to_all_single(
            g.contiguous(), ctx_.send, ctx_.recv, ctx_.group)), None, None, \
            None


def all_to_all(x: torch.Tensor, send: list, recv: list,
               ctx: ShardCtx) -> torch.Tensor:
    """Rows of ``x`` (dim 0) to the model ranks: ``send[j]`` rows to rank
    j in rank order, ``recv[j]`` rows from rank j; differentiable."""
    return _AllToAll.apply(x, list(send), list(recv), model_group(ctx))


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


def layer_region(body, ctx: ShardCtx, p, x, state=None, *,
                 partial: bool = False):
    """``body(p, x, state) -> (out, new_state)``, a layer whose weights
    stay where the port's specs place them over the model axis, run on
    each rank's blocks.  Its operands: each weight of the tree ``p`` (a
    DTensor) in its own placements with its data (FSDP) split gathered,
    the use-site gather GSPMD makes; ``x`` (B, T, d) split by batch over
    the data axes (when they divide it) and whole over ``model``; each
    leaf of the ``state`` dict in its own placements (the cache specs),
    which the new state's leaves keep.

    With ``partial`` the result is a `Partial` sum over ``model`` (the
    body ends in a row-parallel product), so the gradients of ``x`` and
    of each weight whole over ``model`` are `Partial` sums there too.
    A weight's gradient sums over the data axes where the batch is split
    over them.
    """
    from torch.distributed.tensor import Partial, Replicate
    from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
    from repro_torch.models.blocks import _bspec_for
    leaves = tree_leaves(p)
    keys = sorted(state) if state is not None else []
    bspec = _bspec_for(ctx, x.shape[0])
    names = list(ctx.mesh.mesh_dim_names)
    data = [names.index(a) for a in ctx.data_axes]
    model = names.index(ctx.model_axis)

    def weight(w):
        pin = [Replicate() if i in data else q
               for i, q in enumerate(w.placements)]
        grad = list(pin)
        for i in data:
            grad[i] = Partial() if bspec is not None else grad[i]
        if partial and not pin[model].is_shard():
            grad[model] = Partial()
        return tuple(pin), tuple(grad)

    xs = (bspec, None, None)
    w_pl = [weight(w) for w in leaves]
    s_pl = [tuple(state[k].placements) for k in keys]
    out = partial_on_model(xs, ctx) if partial else placements(xs, ctx)

    def run(x_, *rest):
        p_ = tree_unflatten(p, list(rest[:len(leaves)]))
        s_ = (dict(zip(keys, rest[len(leaves):])) if state is not None
              else None)
        o, ns = body(p_, x_, s_)
        return (o,) + tuple(ns[k] for k in keys)

    outs = region(
        run, ctx, [placements(xs, ctx)] + [a for a, _ in w_pl] + s_pl,
        [out] + s_pl,
        in_grad=[partial_on_model(xs, ctx) if partial else None]
        + [g for _, g in w_pl] + [None] * len(keys))(
            x, *leaves, *[state[k] for k in keys])
    return outs[0], (dict(zip(keys, outs[1:])) if state is not None
                     else None)


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
