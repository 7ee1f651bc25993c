"""DTensor placement for the model layers: what ``torch.distributed.tensor``
cannot place by itself, or not under ``torch.func``.

The model code calls these on any tensor; on a plain tensor each is the
plain op (``einsum`` is ``torch.einsum``, ``write_rows`` one
``index_put_``, ``take_rows`` an index, ``merge_dims`` a view, ``rows``
a slice, ``on_local_shards`` the call itself), so nothing on a one-card
path changes.  On DTensors (a mesh's dry run or the ``shard`` backend):

  * ``placements_of`` / ``redistribute``: a DTensor's placements and a
    redistribution, also of one under ``torch.func``'s wrappers, whose
    ``vmap`` dim keeps the split it has where the hint leaves its mesh
    dim free, as ``jax.vmap`` of a sharding constraint leaves the batch
    dim unconstrained (``_Redistribute``, an ``autograd.Function`` with
    ``vmap`` rules, since DTensor's own has none);
  * ``einsum``: a product of two DTensors on each rank's own blocks, one
    letter per mesh dim (DTensor's ``bmm`` over a flattened batch of
    letters split by different mesh dims is a strided split, for which
    torch's redistribute planner searches for minutes on a 3-D mesh);
  * ``on_local_shards``: a function independent across rows and heads (a
    recurrent scan) run once on local blocks, where DTensor would
    dispatch each of its per-chunk ops;
  * ``write_rows``: a decode's in-place cache write on this rank's block
    (DTensor has no rule for an indexed write into a split tensor);
  * ``take_rows``: an embedding lookup whose ids torch 2.11's DTensor
    cannot index while two mesh dims split one of their dims;
  * ``merge_dims``: a merge of two dims that DTensor can flatten, whose
    gradient, under ``torch.func``, comes back placed as the value is;
  * ``rows``: a microbatch's rows, split over the ranks as the batch's.
"""

from __future__ import annotations

import torch
from torch._C import _functorch as ft


def _inner(x: torch.Tensor) -> torch.Tensor:
    """The tensor under ``torch.func``'s wrappers of ``x`` (``x`` itself
    without them)."""
    while ft.is_functorch_wrapped_tensor(x):
        x = ft.get_unwrapped(x)
    return x


def _mesh_of(x: torch.Tensor):
    """The mesh of the DTensor ``x`` is or wraps."""
    return _inner(x).device_mesh


def placements_of(x: torch.Tensor) -> list | None:
    """The placements of the DTensor ``x`` is, or wraps under
    ``torch.func``'s transforms, over ``x``'s own dims (None for a plain
    tensor).  A mesh dim that splits a ``vmap`` batch dim, which ``x``
    does not have, reads as ``Replicate()``."""
    if type(x) is torch.Tensor and not ft.is_functorch_wrapped_tensor(x):
        return None          # a plain tensor: the one-card path's
    bdims = []
    while ft.is_functorch_wrapped_tensor(x):
        if ft.is_batchedtensor(x):
            bdims.append(ft.maybe_get_bdim(x))
        x = ft.get_unwrapped(x)
    if not hasattr(x, "placements"):
        return None
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for p in x.placements:
        if p.is_shard():
            d = p.dim
            for b in reversed(bdims):
                d = None if d is None or d == b else d - (d > b)
            p = Replicate() if d is None else \
                (Shard(d) if type(p) is Shard else p)
        out.append(p)
    return out


def redistribute(x: torch.Tensor, placements) -> torch.Tensor:
    """The DTensor ``x`` (or one under ``torch.func`` wrappers) in
    ``placements`` of its own dims; the values are unchanged."""
    placements = tuple(placements)
    if hasattr(x, "placements"):
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(x.device_mesh, placements)
    return _Redistribute.apply(x, placements)


class _Redistribute(torch.autograd.Function):
    """``DTensor.redistribute`` as a function ``torch.func`` can transform
    (DTensor's own is an autograd function without ``setup_context`` and
    ``vmap`` rules).  Under ``vmap`` the batch dim is left as it is split
    wherever the hint leaves that mesh dim free and the split stays even,
    as ``jax.vmap`` of a sharding constraint leaves the batch dim
    unconstrained in the reference; a mesh dim the hint gives to another
    dim moves there.  The gradient is placed as the value is (a pending
    sum's as replicated), as the transpose of the reference's sharding
    constraint constrains the cotangent alike."""

    @staticmethod
    def forward(x, placements):
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def setup_context(ctx, inputs, output):
        from torch.distributed.tensor import Replicate

        # a pending sum's gradient is whole on every rank
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in inputs[1])

    @staticmethod
    def backward(ctx, grad):
        return redistribute(grad, ctx.placements), None

    @staticmethod
    def vmap(info, in_dims, x, placements):
        from torch.distributed.tensor import Replicate, Shard

        if in_dims[0] is None:
            return _Redistribute.apply(x, placements), None
        x = x.movedim(in_dims[0], 0)
        have, mesh = placements_of(x), _mesh_of(x)
        phys, blocks = [], 1
        for md, p in enumerate(placements):
            if p.is_shard():
                phys.append(Shard(p.dim + 1))
            elif p.is_partial():
                phys.append(p)
            elif have[md].is_shard(0) and \
                    x.shape[0] % (blocks * mesh.size(md)) == 0:
                blocks *= mesh.size(md)
                phys.append(Shard(0))       # the examples' split, kept
            else:
                phys.append(Replicate())
        return _Redistribute.apply(x, tuple(phys)), 0


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)``; DTensors (under ``torch.func``
    transforms too) multiply on each rank's own shards.

    DTensor propagates an einsum through the ``bmm`` it decomposes into,
    whose batch dim flattens every batch letter: a batch split over
    ("pod", "data") beside heads split over "model" make that dim a
    strided shard, and torch's redistribute planner then searches a graph
    of placements for each candidate strategy (minutes for one op on a
    3-D mesh).  Here each mesh dim splits one letter of the two operands
    instead (the one it already splits in the larger operand): an
    operand with that letter is split there, one without it whole, and
    the product of the local blocks is this rank's block of the output,
    or its part of a pending sum when the letter is summed over."""
    if (placements_of(a) is None and placements_of(b) is None) or \
            not _einsum_transposable(eq):
        return torch.einsum(eq, a, b)
    return _LocalEinsum.apply(eq, a, b)


def _einsum_terms(eq: str) -> tuple[str, str, str]:
    ins, out = eq.replace(" ", "").split("->")
    left, right = ins.split(",")
    return left, right, out


def _einsum_transposable(eq: str) -> bool:
    """Whether each operand's gradient is an einsum of the other and the
    output's gradient (every letter of an operand is in one of them)."""
    left, right, out = _einsum_terms(eq)
    return set(left) <= set(right + out) and set(right) <= set(left + out)


def _einsum_plan(eq: str, a, b):
    """Placements of a, b and the output, one letter per mesh dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    left, right, out = _einsum_terms(eq)
    pa, pb = placements_of(a), placements_of(b)
    mesh = _mesh_of(a if pa is not None else b)
    pa = pa or [Replicate()] * mesh.ndim
    pb = pb or [Replicate()] * mesh.ndim
    big = (a, left, pa), (b, right, pb)
    if b.numel() > a.numel():
        big = big[::-1]
    plan = ([], [], [])
    for md in range(mesh.ndim):
        letter = None
        for x, terms, pl in big:
            p = pl[md]
            if type(p) is Shard and x.shape[p.dim] > 1:
                letter = terms[p.dim]
                break
        for x, terms, target in ((a, left, plan[0]), (b, right, plan[1])):
            dim = terms.find(letter) if letter else -1
            target.append(Shard(dim) if dim >= 0 and x.shape[dim] > 1
                          else Replicate())
        if letter is None:
            plan[2].append(Replicate())
        else:
            plan[2].append(Shard(out.index(letter)) if letter in out
                           else Partial())
    return mesh, plan


class _LocalEinsum(torch.autograd.Function):
    """``einsum`` on local shards (its docstring), with ``vmap`` rules
    and an einsum for each operand's gradient."""

    @staticmethod
    def forward(eq, a, b):
        mesh, (pa, pb, po) = _einsum_plan(eq, a, b)
        out = torch.einsum(eq, local_block(a, mesh, pa),
                           local_block(b, mesh, pb))
        left, right, terms = _einsum_terms(eq)
        sizes = dict(zip(left, a.shape))
        sizes.update((t, max(n, sizes.get(t, 1)))
                     for t, n in zip(right, b.shape))
        return from_block(out, mesh, po, [sizes[t] for t in terms])

    @staticmethod
    def setup_context(ctx, inputs, output):
        eq, a, b = inputs
        ctx.eq = eq
        ctx.save_for_backward(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        left, right, out = _einsum_terms(ctx.eq)
        da = einsum(f"{out},{right}->{left}", grad, b) \
            if ctx.needs_input_grad[1] else None
        db = einsum(f"{left},{out}->{right}", a, grad) \
            if ctx.needs_input_grad[2] else None
        return None, da, db

    @staticmethod
    def vmap(info, in_dims, eq, a, b):
        left, right, out = _einsum_terms(eq)
        z = next(c for c in "zyxwvutsrqponmlkjihgfedcba"
                 if c not in left + right + out)
        _, da, db = in_dims
        if da is not None:
            a, left = a.movedim(da, 0), z + left
        if db is not None:
            b, right = b.movedim(db, 0), z + right
        return _LocalEinsum.apply(f"{left},{right}->{z}{out}", a, b), 0


def on_local_shards(fn, args: tuple, dims: tuple, out_dims: tuple):
    """``fn(*args)`` for a function whose rows and heads are independent
    (a recurrent scan), run once on each rank's own blocks when ``args[0]``
    is a DTensor and no gradient is taken; ``fn(*args)`` itself
    otherwise.

    ``dims[i]`` maps "batch" and "heads" to ``args[i]``'s dims (an arg
    without one is whole along that role), ``out_dims[j]`` the outputs'.
    Each mesh dim keeps the role it splits ``args[0]`` by; everything
    else is made whole.  A scan's chunk loop then dispatches plain ops
    (one per chunk and step) instead of DTensor ones."""
    if not hasattr(args[0], "placements") or torch.is_grad_enabled():
        return fn(*args)
    from torch.distributed.tensor import Replicate, Shard

    mesh, first = args[0].device_mesh, args[0].placements
    roles = [next((r for r, d in dims[0].items() if p.is_shard(d)), None)
             if type(p) is Shard else None for p in first]
    size = {r: args[0].shape[d] for r, d in dims[0].items()}

    def placed(where):
        return [Shard(where[r]) if r in where else Replicate()
                for r in roles]

    local = [local_block(a, mesh, placed(d)) for a, d in zip(args, dims)]
    outs = []
    for y, where in zip(fn(*local), out_dims):
        shape = list(y.shape)
        for r, d in where.items():
            shape[d] = size[r]
        outs.append(from_block(y, mesh, placed(where), shape))
    return tuple(outs)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def local_block(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of ``x`` under ``placements`` (a plain ``x`` is
    one every rank holds whole)."""
    if not hasattr(x, "placements"):
        x = _replicated(x, mesh)
    return redistribute(x, placements).to_local()


def from_block(x: torch.Tensor, mesh, placements, shape):
    """The DTensor of global ``shape`` whose block on this rank is ``x``
    (made contiguous, as the stride it is given)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x.contiguous(), mesh, placements,
                              run_check=False, shape=tuple(shape),
                              stride=_contiguous_stride(shape))


def write_rows(cache: torch.Tensor, index: torch.Tensor,
               value: torch.Tensor) -> None:
    """``cache[b, index[b]] = value[b]`` for every row b, in place.

    cache: [B, L, ...]; index: int [B]; value: [B, ...].  A plain cache
    takes one ``index_put_``.  A DTensor cache (sharded over its batch,
    its sequence or a later dim, in any mix) is written on this rank's
    own block: the value is redistributed to the cache's placements (its
    sequence dim whole), and each row this rank holds is written where
    its position falls in this rank's block of the sequence, and left
    as it was elsewhere.  Only the new rows move: DTensor has no rule for
    an indexed write into a sharded tensor, and gathering the cache to
    write it would move all of it."""
    if not hasattr(cache, "placements"):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache.index_put_((rows, index.long()), value)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    mesh, placements = cache.device_mesh, tuple(cache.placements)
    # the value [B, ...] lacks the cache's sequence dim 1
    want = [Replicate() if not p.is_shard() or p.dim == 1
            else Shard(p.dim - (p.dim > 1)) for p in placements]
    index = local_block(index, mesh, [Replicate()] * mesh.ndim)
    local = cache.to_local()
    val = local_block(value, mesh, want)
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, placements)
    pos = index.long()[offset[0]:offset[0] + shape[0]] - offset[1]
    rows = torch.arange(shape[0], device=local.device)
    if shape[1] == cache.shape[1]:
        local.index_put_((rows, pos), val)
        return
    inside = (pos >= 0) & (pos < shape[1])
    pos = pos.clamp(0, shape[1] - 1)
    keep = inside.reshape((-1,) + (1,) * (val.ndim - 1))
    local.index_put_((rows, pos), torch.where(keep, val, local[rows, pos]))


def _replicated(x: torch.Tensor, mesh):
    """A plain tensor every rank holds whole, as a replicated DTensor."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (an embedding lookup).  On DTensors: ids with a dim
    that more than one mesh dim splits (the batch over ("pod", "data"))
    are made whole first, since torch 2.11's DTensor has no rule for an
    index split twice; under ``torch.func`` transforms, a mesh dim that
    splits both the ids and the table's rows' width (its FSDP split)
    gathers the table's width first, so that the rows come out split as
    the ids are (DTensor would follow the table, and a ``vmap``'s
    examples would lose their split, which no hint can state; without a
    transform the next hint moves the rows, fewer bytes than the table
    at a decode step); and where the table takes a gradient the lookup
    is ``embedding``, whose backward DTensor places (torch 2.11's rule
    for the indexed write that ``table[ids]``'s backward is fails with
    split ids).  The rows are the same."""
    inner = _inner(ids)
    if not hasattr(inner, "placements"):
        return table[ids]
    from torch.distributed.tensor import Replicate

    mesh = inner.device_mesh
    split = [p.dim for md, p in enumerate(inner.placements)
             if p.is_shard() and mesh.size(md) > 1]
    if len(split) != len(set(split)):
        ids = redistribute(ids, [Replicate()] * mesh.ndim)
        inner = _inner(ids)
    width = placements_of(table)
    if width is not None and inner is not ids:
        keep = [Replicate() if p.is_shard(1) and q.is_shard() else p
                for p, q in zip(width, inner.placements)]
        if keep != width:
            table = redistribute(table, keep)
    if torch.is_grad_enabled():
        return torch.nn.functional.embedding(ids, table)
    return table[ids]


def summed(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending sums summed, its other placements kept; ``x``
    itself otherwise.  An embedding of a vocab-split table is a pending
    masked sum, which DTensor cannot concatenate with another tensor (it
    would mask that one too)."""
    from torch.distributed.tensor import Replicate

    placements = placements_of(x)
    if placements is None or not any(p.is_partial() for p in placements):
        return x
    return redistribute(x, [Replicate() if p.is_partial() else p
                            for p in placements])


def even_splits(placements, mesh, dim: int, n: int) -> list:
    """``placements`` with the mesh dims that split ``dim`` into blocks
    that do not divide ``n`` made whole: every one past the last whose
    running product of extents divides ``n`` (GSPMD reshards such a dim
    without being asked; DTensor refuses a view of it)."""
    from torch.distributed.tensor import Replicate

    blocks, keep = 1, list(placements)
    for md, p in enumerate(keep):
        if p.is_shard(dim):
            blocks *= mesh.size(md)
            if n % blocks:
                keep[md] = Replicate()
    return keep


def rows(x: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """``x[start:stop]`` (a microbatch of a batch).  DTensor slices a
    split dim by making it whole; the slice of a DTensor is placed back
    as ``x`` is, as far as its splits divide the rows, so that the
    microbatch's examples stay split over the ranks that split the
    batch.  The values are the slice's."""
    y = x[start:stop]
    if not hasattr(x, "placements"):
        return y
    return redistribute(y, even_splits(x.placements, x.device_mesh, 0,
                                       stop - start))


def merge_dims(x: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """``x`` with dims ``dim`` and ``dim + 1`` merged: a view of a plain
    tensor.

    A DTensor whose ``dim`` its mesh dims split into blocks that do not
    divide it is first made whole over those mesh dims (DTensor refuses
    the uneven flatten).  Under ``torch.func`` transforms the merged
    value's gradient comes back through the view's backward, a split,
    which DTensor refuses where it is uneven; the merged value is
    therefore re-placed as it is (a no-op forward), so that its gradient
    arrives in the same placements, which split evenly."""
    dim %= x.ndim
    placements = placements_of(x)
    if placements is not None:
        x = redistribute(x, even_splits(placements, _mesh_of(x), dim,
                                        x.shape[dim]))
    y = x.reshape(*x.shape[:dim], x.shape[dim] * x.shape[dim + 1],
                  *x.shape[dim + 2:])
    if placements is None or hasattr(y, "placements"):
        return y
    return _Redistribute.apply(y, tuple(placements_of(y)))
