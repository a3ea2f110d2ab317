"""Differentiable collectives over one mesh axis.

The JAX package never writes a collective for tensor parallelism, FSDP,
the pipeline's final sum or synchronised BatchNorm: it annotates shardings
and GSPMD inserts the all-reduces, all-gathers and reduce-scatters, with
their transposes for the backward pass.  One process per device runs them
itself, so each is written out here as an ``autograd.Function`` whose
backward is the forward's transpose, on a :class:`~.ring_attention.SeqAxis`
(a mesh axis: its size, this rank's index on it and its process group):

=========================  =========================  ==========================
function                   forward                    backward
=========================  =========================  ==========================
:func:`all_reduce`         sum over the axis          sum over the axis
:func:`reduce_from`        sum over the axis          identity
:func:`copy_to`            identity                   sum over the axis
:func:`gather_from`        concatenate along ``dim``  this rank's slice
:func:`all_gather`         concatenate along ``dim``  sum, then this rank's slice
=========================  =========================  ==========================

``all_reduce`` is the one for statistics every rank reads (BatchNorm's
sums: each rank's loss depends on every rank's activations).
``copy_to`` and ``reduce_from`` are Megatron's ``f`` and ``g``: a
replicated activation entering a column-parallel product, and the partial
outputs of a row-parallel one, whose downstream computation every rank of
the axis repeats.  ``gather_from`` gathers a vocabulary-split logit whose
loss every rank repeats; ``all_gather`` gathers an FSDP parameter block,
each rank's cotangent a different share of the gradient (its backward is
the reduce-scatter).  On an axis of one rank each is the identity and
issues no collective.
"""

import torch
import torch.distributed as dist

__all__ = ['all_reduce', 'reduce_from', 'copy_to', 'gather_from', 'all_gather']


def _sum(x, axis):
    x = x.contiguous().clone()      # the collective writes in place
    dist.all_reduce(x, group=axis.group)
    return x


def _gather(x, axis, dim):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim=dim)


def _slice(x, axis, dim):
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * n, n).contiguous()


def _reduce_scatter(x, axis, dim):
    if dist.get_backend(axis.group) == 'nccl':
        chunks = x.movedim(dim, 0).contiguous()
        out = torch.empty((chunks.shape[0] // axis.size,) + tuple(chunks.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, chunks, group=axis.group)
        return out.movedim(0, dim).contiguous()
    # gloo has no reduce-scatter: the sum, then this rank's share
    return _slice(_sum(x, axis), axis, dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x):
        ctx.axis = axis
        return _sum(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return None, _sum(grad, ctx.axis)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x):
        return _sum(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return None, grad


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return None, _sum(grad, ctx.axis)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, dim, x):
        ctx.axis, ctx.dim = axis, dim
        return _gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return None, None, _slice(grad, ctx.axis, ctx.dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, dim, x):
        ctx.axis, ctx.dim = axis, dim
        return _gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return None, None, _reduce_scatter(grad, ctx.axis, ctx.dim)


def all_reduce(x, axis):
    """Sum over ``axis``; the gradient is summed over it too."""
    return x if axis is None or axis.size == 1 else _AllReduce.apply(axis, x)


def reduce_from(x, axis):
    """Sum over ``axis``; the gradient passes through (Megatron's ``g``)."""
    return x if axis is None or axis.size == 1 else _ReduceFrom.apply(axis, x)


def copy_to(x, axis):
    """Identity; the gradient is summed over ``axis`` (Megatron's ``f``)."""
    return x if axis is None or axis.size == 1 else _CopyTo.apply(axis, x)


def gather_from(x, axis, dim=-1):
    """Every rank's ``x`` concatenated along ``dim`` in axis order; the
    gradient is this rank's slice of it."""
    dim = dim % x.dim()
    return x if axis is None or axis.size == 1 else _GatherFrom.apply(axis, dim, x)


def all_gather(x, axis, dim=0):
    """Every rank's ``x`` concatenated along ``dim`` in axis order; the
    gradient is summed over ``axis`` and this rank's slice kept (a
    reduce-scatter)."""
    dim = dim % x.dim()
    return x if axis is None or axis.size == 1 else _AllGather.apply(axis, dim, x)
