"""Fully-sharded data parallelism (FSDP / ZeRO-3) as sharding rules.

Counterpart of ``petastorm_tpu/parallel/fsdp.py``: shard every large
parameter along the ``data`` mesh axis.  The rules are the JAX package's,
stated on each parameter's flax leaf (:func:`petastorm_tpu_torch.convert.flax_leaves`
for a port model; the keys of a tree of dicts otherwise): start from
``base_spec_fn(path)`` (default replicated; the Megatron rules of
``models.transformer.megatron_spec_fn`` compose into ZeRO-3 x tensor
parallelism), then give ``data_axis`` to the largest dimension still free
and divisible by the axis size, unless the leaf has fewer than
``min_shard_elements`` elements.  The dimension is chosen on the flax
shape, as JAX chooses it, whatever the torch layout.

Where JAX lets GSPMD insert the all-gather before each use and the
reduce-scatter of the gradients, :func:`petastorm_tpu_torch.parallel.place`
stores each rank's block and gathers it before use with a differentiable
all-gather whose backward is the reduce-scatter.
"""

import numpy as np
import torch
from torch import nn

from petastorm_tpu_torch.parallel.mesh import NamedSharding, axis_size

__all__ = ['fsdp_shardings', 'fsdp_size_report']


def _leaves(params):
    """``[(key, path, shape, itemsize)]`` of a port model or a tree of dicts
    of tensors or arrays."""
    if isinstance(params, nn.Module):
        from petastorm_tpu_torch.convert import flax_leaves
        tensors = dict(params.named_parameters())
        return [(name, leaf.path, leaf.shape, tensors[name].element_size())
                for name, leaf in flax_leaves(params).items()]
    out = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, torch.Tensor):
            out.append((path, path, tuple(tree.shape), tree.element_size()))
        else:
            a = np.asarray(tree)
            out.append((path, path, a.shape, a.itemsize))
    walk(params, ())
    return out


def _as_tree(params, values):
    """``values`` (by key) in the structure of ``params``."""
    if isinstance(params, nn.Module):
        return dict(values)
    out = {}
    for path, value in values.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return out


def _canonical(dims):
    while dims and dims[-1] is None:     # canonical: no trailing Nones
        dims.pop()
    return tuple(dims)


def fsdp_shardings(params, mesh, data_axis='data', min_shard_elements=2 ** 14,
                   base_spec_fn=None):
    """A ``NamedSharding`` per parameter sharding each large one over
    ``data_axis``: ``{name: NamedSharding}`` for a port model, or a tree of
    dicts of them for a tree of dicts of tensors.

    Per leaf: start from ``base_spec_fn(path)`` (``path``: the tuple of
    flax keys; default replicated), then assign ``data_axis`` to the largest
    dimension that is still free in the base spec and divisible by the axis
    size.  Leaves smaller than ``min_shard_elements`` stay on the base
    spec, as does a leaf whose base spec already spends ``data_axis``."""
    if data_axis not in mesh.mesh_dim_names:
        raise ValueError('mesh has no axis %r (axes: %s)' % (data_axis, mesh.mesh_dim_names))
    size = axis_size(mesh, data_axis)

    def spec_for(path, shape):
        base = list(base_spec_fn(path)) if base_spec_fn is not None else []
        base += [None] * (len(shape) - len(base))
        if int(np.prod(shape, dtype=np.int64)) < min_shard_elements:
            return _canonical(base)
        taken = {axis for entry in base if entry is not None
                 for axis in (entry if isinstance(entry, tuple) else (entry,))}
        if data_axis in taken:
            return _canonical(base)
        candidates = [(dim, i) for i, dim in enumerate(shape)
                      if base[i] is None and dim % size == 0]
        if not candidates:
            return _canonical(base)
        _, best = max(candidates)
        base[best] = data_axis
        return _canonical(base)

    return _as_tree(params, {key: NamedSharding(mesh, spec_for(path, shape))
                             for key, path, shape, _ in _leaves(params)})


def _flat(shardings, params):
    if isinstance(params, nn.Module):
        return shardings
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        else:
            out[path] = tree
    walk(shardings, ())
    return out


def fsdp_size_report(params, shardings):
    """``{'total_mb', 'per_device_mb', 'sharded_fraction'}`` of ``params``
    (an unplaced port model or a tree of dicts) under ``shardings``: the
    startup log line of a training script.  ``per_device_mb`` is what each
    rank stores after :func:`petastorm_tpu_torch.parallel.place`."""
    by_key = _flat(shardings, params)
    total = per_device = 0
    for key, _, shape, itemsize in _leaves(params):
        nbytes = int(np.prod(shape, dtype=np.int64)) * itemsize
        total += nbytes
        sharding = by_key[key]
        factor = 1
        for dim in range(len(sharding.spec)):
            for name in sharding.axes(dim):
                factor *= axis_size(sharding.mesh, name)
        per_device += nbytes // factor
    return {
        'total_mb': round(total / 2 ** 20, 3),
        'per_device_mb': round(per_device / 2 ** 20, 3),
        'sharded_fraction': round(1.0 - per_device / total, 4) if total else 0.0,
    }
