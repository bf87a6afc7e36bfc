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

Products of weights split over the data axes (FSDP) in a step autograd
does not record (prefill, decode): `product_plan` chooses how each
is partitioned, as GSPMD partitions the JAX package's serve steps, and
`place_for_product` moves the weight for it (`collective_permute`, a
staged op the dry run counts as ``collective-permute``, or one gather
over the data axes together); `models.blocks._linear` states the rule.
A table lookup may instead leave the table in place and move its rows
to their owners (`rows_to_owners`, one all-to-all), a region's scalar
sums over every mesh dim are reduced in one call (`sum_losses`), and a
layer may read only its rank's block of a weight (`block_of`).

Where several data axes split one dim of a weight (``("pod", "data")``
on 2 x 16 x 16), it moves in one collective over them together, as
GSPMD moves it, where DTensor runs one a mesh dim: the use-site gather
and, where autograd records, its gradient's reduce-scatter
(`gather_data`), and a sum over them (`sum_partial`, `reduce_data`: a
replicated leaf's gradient, the loss).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math

import torch
import torch.distributed as dist

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


def _done(t: torch.Tensor) -> torch.Tensor:
    """A functional collective's result, waited for.  A meta tensor (the
    dry run's) has nothing to wait for, and the wait's meta kernel would
    allocate a copy that no rank holds."""
    return t if t.is_meta else _fc().wait_tensor(t)


def _reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """``x`` reduced by ``op`` over ``group`` (no gradient)."""
    return _done(torch.ops._c10d_functional.all_reduce(
        x.contiguous(), op, group.group_name))


def all_reduce(x: torch.Tensor, op: str, ctx: ShardCtx) -> torch.Tensor:
    """``pmax`` / ``psum`` over the model axis (no gradient)."""
    return _reduce(x, op, model_group(ctx))


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Tiled all-gather of ``x`` over ``group`` along ``dim``."""
    out = torch.ops._c10d_functional.all_gather_into_tensor(
        x.movedim(dim, 0).contiguous(), group.size(), group.group_name)
    return _done(out).movedim(0, dim)


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
        ctx_.group = group
        return _reduce(x, "sum", group)

    @staticmethod
    def backward(ctx_, g):
        return _reduce(g, "sum", ctx_.group), None


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
                 partial: bool = False, blocks=None):
    """``body(p, x, state) -> (out, new_state)``, a layer whose weights
    stay where the port's specs place them over the model axis, run on
    each rank's blocks.  Its operands: each weight of the tree ``p`` (a
    DTensor) in its own placements with its data (FSDP) split gathered,
    the use-site gather GSPMD makes (in one call where several data
    axes split it, `gather_data`); ``x`` (B, T, d) split by batch over
    the data axes (when they divide it) and whole over ``model``; each
    leaf of the ``state`` dict in its own placements (the cache specs),
    which the new state's leaves keep.

    With ``partial`` the result is a `Partial` sum over ``model`` (the
    body ends in a row-parallel product), so the gradients of ``x`` and
    of each weight whole over ``model`` are `Partial` sums there too.
    A weight's gradient sums over the data axes where the batch is split
    over them.

    Where autograd records nothing (a serve step: no operand requires
    grad), a 2-D weight split over the data axes
    is placed by `product_plan` instead (the rule of
    `models.blocks._linear`): gathered, moved to the model ranks, or left
    in place; the body gets each weight placed so as a `LocalPlan`
    bound to its block, which only ``_linear`` reads (it runs the
    product on the rank's blocks).  ``blocks`` ({key of ``p``: (dim,
    start, length)}, serve steps only) names weights the body reads only
    a block of on this rank: it gets that block as a plain tensor
    (`block_of`), not an operand of the region.
    """
    from torch.distributed.tensor import Partial, Replicate
    from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
    from repro_torch.models.blocks import _bspec_for
    leaves = tree_leaves(p)
    blocks = blocks or {}
    if blocks and recorded(x, *leaves):
        raise ValueError("a region's weight blocks are for serve steps: "
                         "autograd records this one")
    owners = [k for k in sorted(p) for _ in tree_leaves(p[k])]
    fixed = {i: block_of(w, *blocks[k])
             for i, (k, w) in enumerate(zip(owners, leaves)) if k in blocks}
    keys = sorted(state) if state is not None else []
    bspec = _bspec_for(ctx, x.shape[0])
    names = list(ctx.mesh.mesh_dim_names)
    data = [names.index(a) for a in ctx.data_axes]
    model = names.index(ctx.model_axis)
    xs = (bspec, None, None)
    if not recorded(x, *leaves):         # as the region takes it
        x = x.redistribute(ctx.mesh, placements(xs, ctx))

    def weight(w):
        plan = product_plan(x, w) if w.ndim == 2 else None
        if plan is not None:
            w = place_for_product(w, plan)
            return w, tuple(w.placements), None, local_plan(w, plan)
        if gathers_flat(w):
            w = gather_data(w)
        pin = [Replicate() if i in data else q
               for i, q in enumerate(w.placements)]
        grad = list(pin)
        for i in data:
            grad[i] = Partial() if bspec is not None else grad[i]
        if partial and not pin[model].is_shard():
            grad[model] = Partial()
        return w, tuple(pin), tuple(grad), None

    w_pl = [weight(w) for i, w in enumerate(leaves) if i not in fixed]
    s_pl = [tuple(state[k].placements) for k in keys]
    out = partial_on_model(xs, ctx) if partial else placements(xs, ctx)

    def run(x_, *rest):
        bound = iter(b if lp is None else dataclasses.replace(lp, block=b)
                     for b, (_, _, _, lp) in zip(rest[:len(w_pl)], w_pl))
        p_ = tree_unflatten(p, [fixed[i] if i in fixed else next(bound)
                                for i in range(len(leaves))])
        s_ = (dict(zip(keys, rest[len(w_pl):])) if state is not None
              else None)
        o, ns = body(p_, x_, s_)
        return (o,) + tuple(ns[k] for k in keys)

    outs = region(
        run, ctx, [placements(xs, ctx)] + [a for _, a, _, _ in w_pl] + s_pl,
        [out] + s_pl,
        in_grad=[partial_on_model(xs, ctx) if partial else None]
        + [g for _, _, g, _ in w_pl] + [None] * len(keys))(
            x, *[w for w, _, _, _ in w_pl], *[state[k] for k in keys])
    if state is None:
        return outs[0], None
    # each new leaf in its leaf's shape: ``local_map`` takes a split to be
    # even, which the WKV state's split by heads need not be
    # (`sharding.cache_pspecs`)
    from torch.distributed.tensor import DTensor
    return outs[0], {k: DTensor.from_local(
        o.to_local(), ctx.mesh, o.placements, run_check=False,
        shape=state[k].shape, stride=state[k].stride())
        for k, o in zip(keys, outs[1:])}


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


# ---- products of weights split over the data axes, without autograd ------


def send_recv(x: torch.Tensor, peer: int) -> torch.Tensor:
    """``x`` sent to global rank ``peer`` and its block received from it
    (a copy when ``peer`` is this rank)."""
    if peer == dist.get_rank():
        return x.clone()
    out = torch.empty_like(x)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x.contiguous(), peer),
            dist.P2POp(dist.irecv, out, peer)]):
        req.wait()
    return out


@functools.cache
def permute_op():
    """``torch.ops.repro_torch.collective_permute(x, peer)``: this rank's
    block to global rank ``peer`` and ``peer``'s back, the pair exchange
    of XLA's ``collective-permute`` (each rank's partner sends to it in
    turn).  Defined on first use; `repro_torch.launch.staging` registers
    its host-staged kernel for gloo ranks on a card, and a meta tensor
    takes the fake kernel (the dry run)."""

    @torch.library.custom_op("repro_torch::collective_permute",
                             mutates_args=())
    def collective_permute(x: torch.Tensor, peer: int) -> torch.Tensor:
        return send_recv(x, peer)

    @collective_permute.register_fake
    def _(x, peer):
        return torch.empty_like(x)

    return collective_permute


def recorded(*tensors) -> bool:
    """Does autograd record an op on ``tensors`` (grad mode on and one of
    them requires grad)?  The train step's products; a serve step's
    parameters require no gradient."""
    return torch.is_grad_enabled() and any(
        getattr(t, "requires_grad", False) for t in tensors)


def _dims(mesh):
    """(the model mesh dim or None, the other (data) mesh dims)."""
    names = list(mesh.mesh_dim_names)
    model = names.index("model") if "model" in names else None
    return model, [i for i in range(len(names)) if i != model]


def data_dims(mesh) -> list:
    """The data mesh dims of ``mesh`` (all but ``model``)."""
    return _dims(mesh)[1]


def _rank_at(mesh, coord) -> int:
    """The global rank at mesh coordinate ``coord``, from this rank's
    groups along each mesh dim (a mesh over evenly spaced ranks, as
    `launch.mesh` builds them; ``DeviceMesh.mesh`` otherwise, which
    keeps a copy of the rank grid alive)."""
    mine = list(mesh.get_coordinate())
    rank = dist.get_rank()
    for i, (c, m) in enumerate(zip(coord, mine)):
        ranks = dist.get_process_group_ranks(mesh.get_group(i))
        step = ranks[1] - ranks[0] if len(ranks) > 1 else 0
        if ranks != [ranks[0] + k * step for k in range(len(ranks))]:
            return int(mesh.mesh[tuple(coord)])
        rank += (c - m) * step
    return rank


def _group(mesh, dims):
    """The process group over mesh dims ``dims`` together (major to
    minor) and this rank's index in it.  Several dims take groups made
    here, once a mesh (every rank makes all of them, as a new group
    asks), not `DeviceMesh._flatten`: DTensor and the mesh's slicing may
    reuse an equal mesh's flattened dims, whose groups die with an
    earlier process group (a fake one a dry run pass)."""
    if len(dims) == 1:
        return mesh.get_group(dims[0]), mesh.get_local_rank(dims[0])
    groups = mesh.__dict__.setdefault("_repro_groups", {})
    key = tuple(dims)
    if key not in groups:
        lists = []
        for fixed in itertools.product(*(
                range(mesh.size(i)) if i not in dims else [None]
                for i in range(mesh.ndim))):
            lists.append([_rank_at(mesh, [f if f is not None else idx[
                dims.index(i)] for i, f in enumerate(fixed)])
                for idx in itertools.product(
                    *(range(mesh.size(i)) for i in dims))])
        mine = next(r for r in lists if dist.get_rank() in r)
        group, _ = dist.new_subgroups_by_enumeration(lists)
        groups[key] = group, mine.index(dist.get_rank())
    return groups[key]


@dataclasses.dataclass(frozen=True)
class ProductPlan:
    """How ``x @ w`` runs over the mesh dims ``dims`` that split ``w``
    along its dim ``dim`` (`product_plan`): ``kind`` is ``"gather"``
    (the split gathered), ``"permute"`` (the block moved to the model
    ranks, the product row-parallel there), ``"rows"`` or ``"cols"``
    (the weight left in place, row- or column-parallel over ``dims``),
    ``"all_to_all"`` (a lookup: the table left in place, the indices
    gathered over ``dims`` and the rows moved back, `rows_to_owners`);
    ``bytes`` what it moves a rank (`product_plan`'s costs)."""
    kind: str
    dims: tuple
    dim: int
    bytes: int = dataclasses.field(default=0, compare=False)


def product_plan(x, w, lookup_dt=None):
    """The plan of ``x @ w`` (DTensors, ``w`` 2-D) over the data mesh
    dims that split ``w``, where autograd does not record it; None where
    it does (the train step gathers, `gather_data`) or when no data dim
    splits ``w``.  With ``lookup_dt``, ``x`` holds indices of ``w``'s
    rows instead, each a row of the product (a table lookup: the
    product of their one-hot rows with ``w``, in ``lookup_dt``).  The
    rule and its costs: `models.blocks._linear`; a lookup whose indices
    are split by rows over those dims and whose table is split there by
    columns may also take ``"all_to_all"``: the indices gathered there
    (D R of them), each rank's columns looked up for all of them and the
    rows moved to their owners by one all-to-all (R D N), as GSPMD looks
    up the decode step's tokens, where that is cheaper than the
    gather (D |W|)."""
    from torch.distributed.tensor import DTensor
    if (not isinstance(w, DTensor) or not isinstance(x, DTensor)
            or recorded(x, w)):
        return None
    mesh = w.device_mesh
    model, data = _dims(mesh)
    split = {i: w.placements[i].dim for i in data
             if w.placements[i].is_shard()}
    if not split:
        return None
    dims = tuple(sorted(split))
    wl, xl = w.to_local(), x.to_local()
    parts = math.prod(mesh.size(i) for i in dims)
    gather = wl.numel() * wl.element_size() * parts
    if len(set(split.values())) != 1:
        return ProductPlan("gather", dims, -1, gather)
    wd = split[dims[0]]
    xs = [x.placements[i] for i in dims]
    if lookup_dt is None:
        last = x.ndim - 1
        rows = xl.numel() // max(xl.shape[-1], 1)
        out_item = torch.promote_types(x.dtype, w.dtype).itemsize
    else:
        last, rows, out_item = x.ndim, xl.numel(), lookup_dt.itemsize
    if all(p.is_shard() and p.dim != last for p in xs):
        if lookup_dt is not None and wd == 1:
            moved = (xl.numel() * x.dtype.itemsize * parts
                     + rows * parts * wl.shape[1] * out_item)
            if moved < gather:
                return ProductPlan("all_to_all", dims, wd, moved)
        if (wd == 0 and len(dims) == 1 and model is not None
                and mesh.size(dims[0]) == mesh.size(model)
                and w.placements[model].is_replicate()
                and x.placements[model].is_replicate()):
            permute = (wl.numel() * wl.element_size()
                       + rows * wl.shape[1] * out_item)
            if permute < gather:
                return ProductPlan("permute", dims, wd, permute)
        return ProductPlan("gather", dims, wd, gather)
    whole = all(p.is_replicate() for p in xs)
    if whole or (wd == 0 and all(p.is_shard(last) or p.is_replicate()
                                 for p in xs)):
        # x whole over them, or (a row-parallel product) split there
        # along its features as the weight's rows are
        cols = wl.shape[1] * (parts if wd == 1 else 1)
        if rows * cols * out_item < gather:
            return ProductPlan("rows" if wd == 0 else "cols", dims, wd,
                               rows * cols * out_item)
    return ProductPlan("gather", dims, wd, gather)


def gathers_flat(w, dims=None) -> bool:
    """Does `gather_data` gather ``w`` in one call over several data mesh
    dims (``dims``; all that split it when None): do they split one
    tensor dim?"""
    from torch.distributed.tensor import DTensor
    if not isinstance(w, DTensor):
        return False
    if dims is None:
        dims = [i for i in _dims(w.device_mesh)[1]
                if w.placements[i].is_shard()]
    split = [w.placements[i].dim if w.placements[i].is_shard() else None
             for i in dims]
    return len(split) > 1 and len(set(split)) == 1 and None not in split


def _from_local(local, like, placements):
    """``local`` as a DTensor of ``like``'s mesh, shape and stride in
    ``placements``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, like.device_mesh, placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


class _GatherData(torch.autograd.Function):
    """A DTensor whole over the data mesh dims ``dims`` that split its
    tensor dim ``dim``: one tiled all-gather over their group (major to
    minor, `_group`), as GSPMD gathers an FSDP weight over ``("pod",
    "data")``.  Its gradient comes back in the operand's placements:
    one reduce-scatter over the same group where it is a `Partial` sum
    there (each rank used the weight on its own batch shard), this
    rank's block where it is whole there.  Nothing is saved: under remat
    the gather runs again."""

    @staticmethod
    def forward(ctx_, w, dims, dim, group, index):
        from torch.distributed.tensor import Replicate
        ctx_.dims, ctx_.dim, ctx_.group, ctx_.index = dims, dim, group, index
        ctx_.placements = tuple(w.placements)
        local = _gather(w.to_local(), dim, group)
        return _from_local(local, w, [Replicate() if i in dims else q
                                      for i, q in enumerate(w.placements)])

    @staticmethod
    def backward(ctx_, g):
        dims, dim = ctx_.dims, ctx_.dim
        pl = list(g.placements)
        for i in dims:
            pl[i] = ctx_.placements[i]
        if all(g.placements[i].is_partial() for i in dims):
            local = g.to_local().movedim(dim, 0).contiguous()
            local = _done(torch.ops._c10d_functional.reduce_scatter_tensor(
                local, "sum", ctx_.group.size(), ctx_.group.group_name))
            local = local.movedim(0, dim)
        elif all(g.placements[i].is_replicate() for i in dims):
            n = g.shape[dim] // ctx_.group.size()
            local = g.to_local().narrow(dim, ctx_.index * n, n)
        else:
            raise ValueError(
                f"the gradient of a weight gathered over mesh dims {dims} "
                f"comes back {tuple(g.placements)}: neither a sum nor whole "
                f"there")
        return _from_local(local, g, pl), None, None, None, None


def gather_data(w, dims=None):
    """``w`` (a DTensor) whole over the data mesh dims ``dims`` (all that
    split it when None): where several of them split one tensor dim, one
    tiled all-gather over them together, as GSPMD gathers over
    ``("pod", "data")`` (DTensor gathers each in turn: 1.5 times the
    bytes on 2 x 16 x 16), and where autograd records, its gradient
    reduce-scattered in one call too (`_GatherData`); otherwise
    DTensor's redistribution."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    if dims is None:
        dims = [i for i in _dims(mesh)[1] if w.placements[i].is_shard()]
    dims = list(dims)
    if not dims:
        return w
    if not gathers_flat(w, dims):
        return w.redistribute(mesh, [Replicate() if i in dims else q
                                     for i, q in enumerate(w.placements)])
    group, index = _group(mesh, dims)
    return _GatherData.apply(w, tuple(dims), w.placements[dims[0]].dim,
                             group, index)


def permute_to_model(w, dim: int):
    """``w`` (a DTensor split over the data mesh dim ``dim`` along its
    dim 0, whole over ``model``, the two of equal size) split over
    ``model`` instead: rank (d, m) sends its block d to rank (m, d) and
    receives block m from it (`permute_op`), as GSPMD moves an FSDP
    shard to the model axis for a row-parallel product."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = w.device_mesh
    model, _ = _dims(mesh)
    coord = list(mesh.get_coordinate())
    coord[dim], coord[model] = coord[model], coord[dim]
    peer = _rank_at(mesh, coord)
    local = permute_op()(w.to_local().contiguous(), peer)
    pl = list(w.placements)
    pl[dim], pl[model] = Replicate(), Shard(0)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=w.shape, stride=w.stride())


def place_for_product(w, plan: ProductPlan):
    """``w`` moved as ``plan`` asks (gathered, or permuted to the model
    ranks); left in place for ``"rows"`` and ``"cols"``."""
    if plan.kind == "gather":
        return gather_data(w, plan.dims)
    if plan.kind == "permute":
        return permute_to_model(w, plan.dims[0])
    return w


def _block_split(w):
    """(the data mesh dims that split ``w``, the tensor dim they split)
    of a DTensor whole over ``model``."""
    model, data = _dims(w.device_mesh)
    dims = [i for i in data if w.placements[i].is_shard()]
    split = {w.placements[i].dim for i in dims}
    if (model is not None and not w.placements[model].is_replicate()) \
            or len(split) > 1:
        raise ValueError(f"a weight block needs the weight whole over "
                         f"model and split along one dim, not "
                         f"{tuple(w.placements)}")
    return dims, (split.pop() if split else None)


def block_of(w, dim: int, start: int, length: int) -> torch.Tensor:
    """The block ``[start, start + length)`` along ``dim`` of ``w`` (a
    DTensor whole over ``model``; a plain tensor as it is), whole, as a
    plain tensor of this rank, where no gradient is recorded.  Where the
    data mesh dims split ``w``'s other dim, each rank's part of the
    block gathered in one call over them (the columns of a row-split
    weight: GSPMD's column block); where they split ``dim``, ``w``
    gathered whole in one call and the block taken; else the block of
    this rank's tensor, no collective."""
    from torch.distributed.tensor import DTensor
    if not isinstance(w, DTensor):
        return w.narrow(dim, start, length)
    dims, split = _block_split(w)
    local = w.to_local()
    if not dims:
        return local.narrow(dim, start, length)
    group, _ = _group(w.device_mesh, dims)
    if split == dim:
        return _gather(local, split, group).narrow(dim, start, length)
    part = local.narrow(dim, start, length)
    if not length:         # every rank of the group holds the same block
        shape = list(part.shape)
        shape[split] *= group.size()
        return part.new_empty(shape)
    return _gather(part, split, group)


def block_bytes(w, dim: int, length: int) -> int:
    """The bytes `block_of` gathers for a block ``length`` long along
    ``dim`` of ``w`` (the gathered result, as the dry run counts an
    all-gather)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(w, DTensor):
        return 0
    dims, split = _block_split(w)
    if not dims:
        return 0
    shape = list(w.shape)
    if split != dim:
        shape[dim] = length
    return math.prod(shape) * w.element_size()


class _SumPartial(torch.autograd.Function):
    """A DTensor `Partial` over mesh dims ``dims`` reduced there by one
    all-reduce over their group; its gradient (whole there, as every
    rank reads the sum) goes back to each summand as it is, as DTensor's
    own reduction passes it."""

    @staticmethod
    def forward(ctx_, x, dims, group):
        from torch.distributed.tensor import Replicate
        ctx_.dims = dims
        return _from_local(_reduce(x.to_local(), "sum", group), x,
                           [Replicate() if i in dims else q
                            for i, q in enumerate(x.placements)])

    @staticmethod
    def backward(ctx_, g):
        if not all(g.placements[i].is_replicate() for i in ctx_.dims):
            raise ValueError(
                f"the gradient of a sum over mesh dims {ctx_.dims} comes "
                f"back {tuple(g.placements)}, not whole there")
        return g, None, None


def sum_partial(out, dims):
    """A DTensor `Partial` over mesh dims ``dims`` reduced there: one
    all-reduce over them together (`_SumPartial`, differentiable)."""
    dims = [i for i in dims if out.placements[i].is_partial()]
    if not dims:
        return out
    group, _ = _group(out.device_mesh, dims)
    return _SumPartial.apply(out, tuple(dims), group)


def reduce_data(x, placements=None):
    """``x`` (a DTensor; a plain tensor as it is) with its `Partial`
    sums over several data mesh dims reduced in one all-reduce over them
    together, as GSPMD reduces a sum over ``("pod", "data")``, where
    ``placements`` holds them whole (None: only that); then in
    ``placements`` by DTensor's redistribution (one collective a mesh
    dim), as where one data dim holds the sum."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    dims = [i for i in _dims(mesh)[1] if x.placements[i].is_partial()
            and (placements is None or placements[i].is_replicate())]
    if len(dims) > 1:
        x = sum_partial(x, dims)
    if placements is None or tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def finish_product(y, plan: ProductPlan):
    """The result of a product placed by ``plan``, reduced or gathered at
    once where GSPMD does: the partial sums over ``model`` (a permuted
    block) or over the data dims (rows in place), the columns over the
    data dims (columns in place), the rows to their owners (a lookup
    by ``"all_to_all"``)."""
    if plan.kind == "permute":
        return sum_partial(y, [_dims(y.device_mesh)[0]])
    if plan.kind == "rows":
        return sum_partial(y, plan.dims)
    if plan.kind == "cols":
        return gather_data(y, plan.dims)
    if plan.kind == "all_to_all":
        return rows_to_owners(y, plan.dims)
    return y


def rows_to_owners(y, dims):
    """``y`` (a DTensor whole along dim 0 over the data mesh dims
    ``dims`` and split there along its last dim) split along dim 0
    there instead, its last dim whole: one all-to-all over them
    together, rank j of their group receiving each rank's columns of
    its block j of rows (no gradient)."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = y.device_mesh
    group, _ = _group(mesh, list(dims))
    n = group.size()
    local = y.to_local()
    rows = local.shape[0] // n
    out = _done(torch.ops._c10d_functional.all_to_all_single(
        local.contiguous(), [rows] * n, [rows] * n, group.group_name))
    out = out.reshape(n, rows, *local.shape[1:]).movedim(0, -2).reshape(
        rows, *local.shape[1:-1], n * local.shape[-1])
    pl = list(y.placements)
    for i in dims:
        pl[i] = Shard(0)
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=y.shape,
                              stride=y.stride())


def sum_losses(*xs):
    """DTensors `Partial` over mesh dims (a region's scalar sums: the MoE
    aux losses), replicated: where autograd records, each by
    `reduce_data` (one all-reduce over the data dims, one over
    ``model``), otherwise by one all-reduce of them stacked, over those
    dims together."""
    from torch.distributed.tensor import DTensor, Replicate
    if recorded(*xs):
        return tuple(reduce_data(x, [Replicate()] * x.device_mesh.ndim)
                     for x in xs)
    dims = [i for i, p in enumerate(xs[0].placements) if p.is_partial()]
    if not dims:
        return xs
    mesh = xs[0].device_mesh
    group, _ = _group(mesh, dims)
    total = _reduce(torch.stack([x.to_local() for x in xs]), "sum", group)
    return tuple(DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False, shape=x.shape,
                                    stride=x.stride())
                 for t, x in zip(total.unbind(0), xs))


@dataclasses.dataclass(frozen=True)
class LocalPlan:
    """A planned weight's block inside a region (`layer_region`), which
    the body reads only through `models.blocks._linear` (it is no
    tensor): ``"rows"``: the input's features ``[index * k, (index + 1)
    * k)`` times ``block`` (k rows), summed over ``group``; ``"cols"``:
    the input times ``block``, its columns gathered over ``group``."""
    kind: str
    index: int
    group: object
    block: torch.Tensor | None = None

    def apply(self, x, dt):
        w = self.block.to(dt)
        if self.kind == "cols":
            return _gather(x @ w, x.ndim - 1, self.group)
        k = w.shape[0]
        return _reduce(x[..., self.index * k:(self.index + 1) * k] @ w,
                       "sum", self.group)


def local_plan(w, plan: ProductPlan):
    """The `LocalPlan` of a weight placed by `place_for_product`, its
    block to be bound in the region (None where its product is a plain
    local one: gathered)."""
    mesh = w.device_mesh
    if plan.kind == "permute":
        model, _ = _dims(mesh)
        return LocalPlan("rows", mesh.get_local_rank(model),
                         mesh.get_group(model))
    if plan.kind in ("rows", "cols"):
        group, index = _group(mesh, list(plan.dims))
        return LocalPlan(plan.kind, index, group)
    return None
