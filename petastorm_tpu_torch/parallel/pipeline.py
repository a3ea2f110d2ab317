"""Pipeline parallelism: stages on a mesh axis, activations hopping stage to
stage.

Counterpart of ``petastorm_tpu/parallel/pipeline.py``: the GPipe schedule.
Every rank of the axis holds one stage's parameters; the microbatch stream
enters at stage 0, and each tick every rank runs its stage and then passes
its activation one hop down the ring, so all stages compute at once once
the pipeline fills (``n_stages - 1`` ticks of bubble).  The JAX package's
``ppermute`` is the ring attention's differentiable rotation
(``batch_isend_irecv``, whose backward rotates the gradient back), and its
final ``psum`` a differentiable all-reduce whose backward passes the
gradient through (every rank then holds the outputs and repeats the loss).
The schedule is unrolled in Python (the stage and tick are host integers),
and every selection is a ``torch.where`` on a mask, as JAX's
``jnp.where``: every tick every rank computes its stage (the bubble ticks
too) and issues the same rotation, and every rank's output depends on every
tick's activation and rotation, so that each rank's backward pass runs
every rotation's backward, in the same order on every rank.
"""

import torch

from petastorm_tpu_torch.parallel.collectives import reduce_from
from petastorm_tpu_torch.parallel.mesh import NamedSharding
from petastorm_tpu_torch.parallel.ring_attention import SeqAxis, _rotate

__all__ = ['pipeline_apply', 'make_pipeline']


def pipeline_apply(stage_fn, stage_params, microbatches, axis, n_stages):
    """Run the schedule for this rank's stage.

    Args:
        stage_fn: ``fn(stage_params, x) -> y`` with ``y.shape == x.shape``
            (the activation rides the ring; project in and out around the
            pipeline).
        stage_params: this rank's stage parameters (the stacked axis
            already taken away).
        microbatches: ``[n_micro, microbatch, ...]``, the same on every
            rank (only stage 0 reads it).
        axis: the stages' mesh axis (a :class:`SeqAxis`).
        n_stages: the stage count (the axis size).

    Returns ``[n_micro, microbatch, ...]`` outputs, the same on every rank.
    """
    stage_id = axis.index
    n_micro = microbatches.shape[0]
    ticks = n_micro + n_stages - 1
    device = microbatches.device

    def mask(flag):
        return torch.full((), bool(flag), dtype=torch.bool, device=device)

    first, last = mask(stage_id == 0), mask(stage_id == n_stages - 1)
    state = torch.zeros_like(microbatches[0])
    outputs = [torch.zeros_like(microbatches[0]) for _ in range(n_micro)]
    for t in range(ticks):
        # stage 0 injects microbatch t; later stages take the activation that
        # just hopped in.  A bubble tick computes on it and keeps the state.
        x = torch.where(first, microbatches[min(max(t, 0), n_micro - 1)], state)
        y = stage_fn(stage_params, x)
        active = 0 <= t - stage_id < n_micro
        y = torch.where(mask(active), y, state)
        # the last stage retires microbatch t - (n_stages - 1)
        out_idx = min(max(t - (n_stages - 1), 0), n_micro - 1)
        retire = mask(active and stage_id == n_stages - 1)
        outputs[out_idx] = torch.where(retire, y, outputs[out_idx])
        state = _rotate(axis, y)
    # only the last stage holds real outputs; the sum gives them to every rank
    outputs = torch.stack(outputs)
    return reduce_from(torch.where(last, outputs, torch.zeros_like(outputs)), axis)


def make_pipeline(mesh, stage_fn, pipe_axis='pipe'):
    """The pipeline over ``mesh``'s ``pipe_axis``.

    Returns ``(fn, stage_sharding)``: ``fn(stacked_params, microbatches)``
    where ``stacked_params`` is this rank's block of a tree of dicts whose
    leaves have a leading ``n_stages`` axis (place it with
    :func:`petastorm_tpu_torch.parallel.device_put` and ``stage_sharding``:
    rank d keeps slice d) and ``microbatches`` is ``[n_micro, microbatch,
    ...]``, the same on every rank."""
    axis = SeqAxis(mesh, pipe_axis)
    n_stages = axis.size

    def take(tree):
        return {k: take(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[0]

    def fn(stacked_params, microbatches):
        return pipeline_apply(stage_fn, take(stacked_params), microbatches, axis, n_stages)

    return fn, NamedSharding(mesh, (pipe_axis,))
