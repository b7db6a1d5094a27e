"""Every collective of the port (the counterparts of the collectives XLA's
SPMD partitioner inserts for mtl_tpu/parallel/mesh.py and sp.py).

All of them are built on ``torch.distributed.all_reduce`` (sum) and
``broadcast`` alone: the two collectives gloo takes on CUDA tensors as well
as on CPU tensors, so one code path serves CPU gloo ranks, ranks that share
one card over gloo, and NCCL ranks with a card each. An all-gather is the
sum over the axis of a zeroed ``[size, ...]`` buffer into which each rank
wrote its own slab.

Each function takes an ``Axis`` (``parallel/mesh.py``): a process group,
the rank's index in it and its size. On an axis of size 1 every function is
the identity and launches nothing.

``all_reduce_grad`` is the autograd-aware form: its backward is again a
call of this module (the backward of a sum all-reduce is the sum
all-reduce of the incoming gradients), written with differentiable ops, so
a ``create_graph`` backward (the second-order meta step) differentiates
through it once more. Every rank of an axis must call the same
collectives in the same order, forward and backward; the steps run one
program on every rank, so they do.

The tensor-parallel layers (``parallel/tp.py``, ``models/layers.py``) use
Megatron's autograd-aware pairs over the ``model`` axis. Their loss is
the same on every rank of the axis, so a tensor that every rank computes
alike (replicated) carries the full gradient on every rank, and a tensor
split over the axis carries the gradient of this rank's part:

* ``copy_to_model``: forward the identity, backward the all-reduce (a
  replicated input of a split layer collects each rank's part of its
  gradient);
* ``reduce_from_model``: forward the all-reduce of partial sums, backward
  the identity;
* ``gather_from_model``: forward the all-gather of the last dim, backward
  the reduce-scatter (the consumer of the gathered tensor is a split
  layer, whose gradient on each rank is a partial sum); ``all_gather_last``
  is the same gather with the slice as its backward (its consumer computes
  alike on every rank);
* ``scatter_to_model``: forward this rank's slice of the last dim,
  backward the all-gather; ``reduce_scatter_to_model`` is the reduce, then
  the slice.

Each backward calls its adjoint, so a ``create_graph`` backward
differentiates it again. Their sums run in f32 for a 16-bit tensor, the
result cast back.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def _sum_(t: torch.Tensor, axis) -> torch.Tensor:
    """In-place sum of ``t`` over the axis (``t`` must be contiguous)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=axis.group)
    return t


def all_reduce(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``x`` over the axis, as a new tensor (no autograd)."""
    if axis.size == 1:
        return x
    return _sum_(x.detach().clone(memory_format=torch.contiguous_format),
                 axis)


def all_reduce_list(tensors: Sequence[torch.Tensor], axis
                    ) -> List[torch.Tensor]:
    """The sums over the axis of a list of tensors of one dtype, in one
    collective over their concatenation (no autograd)."""
    tensors = list(tensors)
    if axis.size == 1 or not tensors:
        return tensors
    flat = _sum_(torch.cat([t.detach().reshape(-1) for t in tensors]), axis)
    return [p.view_as(t) for p, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_gather(x: torch.Tensor, axis) -> torch.Tensor:
    """[size, *x.shape]: every rank's ``x`` (equal shapes), in axis
    order (no autograd)."""
    if axis.size == 1:
        return x[None]
    buf = x.new_zeros((axis.size,) + tuple(x.shape))
    buf[axis.index] = x.detach()
    return _sum_(buf, axis)


def all_gather_varlen(x: torch.Tensor, lengths: Sequence[int], axis,
                      dim: int = 1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, where rank i's extent
    along ``dim`` is ``lengths[i]`` (known to every rank): the slabs go
    through one ``[size, ..., max(lengths), ...]`` buffer and are cropped to
    their lengths (no autograd)."""
    if axis.size == 1:
        return x
    longest = max(lengths)
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, longest - x.shape[dim]]
    full = all_gather(torch.nn.functional.pad(x.detach(), pad), axis)
    return torch.cat([full[i].narrow(dim, 0, n)
                      for i, n in enumerate(lengths)], dim=dim)


def broadcast_(tensors: Sequence[torch.Tensor], axis, src: int = 0
               ) -> None:
    """Overwrites each tensor with the axis rank ``src``'s, in place; one
    collective per dtype over their concatenation."""
    if axis.size == 1:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    root = axis.ranks[src]
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.broadcast(flat, src=root, group=axis.group)
        with torch.no_grad():
            for t, p in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(p.view_as(t))


def broadcast_flag(flag: bool, axis, device: torch.device,
                   src: int = 0) -> bool:
    """The axis rank ``src``'s decision, on every rank of the axis."""
    if axis.size == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int64, device=device)
    dist.broadcast(t, src=axis.ranks[src], group=axis.group)
    return bool(t.item())


def any_flag(flag: bool, axis, device: torch.device) -> bool:
    """True on every rank of the axis when it is true on any."""
    if axis.size == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int64, device=device)
    return bool(_sum_(t, axis).item() > 0)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _sum_(x.clone(memory_format=torch.contiguous_format), axis)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad.contiguous(), ctx.axis), None


def all_reduce_grad(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``x`` over the axis; its gradient is the sum over the
    axis of the incoming gradients, differentiable again."""
    if axis.size == 1:
        return x
    return _AllReduceSum.apply(x, axis)


def all_reduce_grad_list(tensors: Sequence[torch.Tensor], axis
                         ) -> List[torch.Tensor]:
    """``all_reduce_grad`` of a list of tensors of one dtype, in one
    collective over their concatenation."""
    tensors = list(tensors)
    if axis.size == 1 or not tensors:
        return tensors
    flat = all_reduce_grad(torch.cat([t.reshape(-1) for t in tensors]), axis)
    return [p.view_as(t) for p, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]



# -- the tensor-parallel pairs over the ``model`` axis ----------------------

def _sum_f32(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``x`` over the axis as a new tensor of x's dtype, summed
    in f32 for a 16-bit ``x``."""
    wide = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    out = _sum_(wide.clone(memory_format=torch.contiguous_format), axis)
    return out.to(x.dtype)


def _gather_last(x: torch.Tensor, axis) -> torch.Tensor:
    """[..., size * n]: every rank's [..., n] in axis order."""
    buf = x.new_zeros((axis.size,) + tuple(x.shape),
                      dtype=torch.float32 if x.dtype in (
                          torch.bfloat16, torch.float16) else x.dtype)
    buf[axis.index] = x
    full = _sum_(buf, axis).to(x.dtype)
    return full.movedim(0, -2).reshape(*x.shape[:-1], -1)


def _slice_last(x: torch.Tensor, axis) -> torch.Tensor:
    n = x.shape[-1] // axis.size
    return x.narrow(-1, axis.index * n, n).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _Reduce.apply(grad, ctx.axis), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _sum_f32(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return _Copy.apply(grad, ctx.axis), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _gather_last(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return _Scatter.apply(grad, ctx.axis), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _slice_last(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return _Gather.apply(grad, ctx.axis), None


def copy_to_model(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` (replicated) as the input of a split layer: forward the
    identity, backward the all-reduce."""
    return x if axis is None or axis.size == 1 else _Copy.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum over the axis of partial sums: forward the all-reduce,
    backward the identity."""
    return x if axis is None or axis.size == 1 else _Reduce.apply(x, axis)


def all_gather_last(x: torch.Tensor, axis) -> torch.Tensor:
    """Every rank's part of the last dim, concatenated in axis order, for a
    consumer that computes alike on every rank: backward this rank's
    slice."""
    return x if axis is None or axis.size == 1 else _Gather.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis) -> torch.Tensor:
    """``all_gather_last`` for a consumer split over the axis: backward the
    reduce-scatter (the sum of the ranks' partial gradients, then this
    rank's slice)."""
    if axis is None or axis.size == 1:
        return x
    return _Copy.apply(_Gather.apply(x, axis), axis)


def scatter_to_model(x: torch.Tensor, axis) -> torch.Tensor:
    """This rank's slice of the last dim of a replicated ``x``: backward
    the all-gather."""
    return x if axis is None or axis.size == 1 else _Scatter.apply(x, axis)


def reduce_scatter_to_model(x: torch.Tensor, axis) -> torch.Tensor:
    """This rank's slice of the last dim of the sum over the axis of
    partial sums: backward the all-gather."""
    if axis is None or axis.size == 1:
        return x
    return _Scatter.apply(_Reduce.apply(x, axis), axis)
