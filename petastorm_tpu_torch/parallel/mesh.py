"""Mesh construction and per-rank global-batch assembly over ``torch.distributed``.

Counterpart of ``petastorm_tpu/parallel/mesh.py``.  The JAX package runs one
process per host holding every device of that host; here one process runs
each device (``torchrun``, or ranks spawned by the caller), so the mesh is a
mesh of ranks: a :class:`~torch.distributed.device_mesh.DeviceMesh` with
named dims, each rank at one coordinate of it.

* :func:`init_distributed` starts the default process group (the JAX
  package leaves ``jax.distributed.initialize`` to its caller): from
  torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` when they are set, else
  from a ``dist.FileStore``.  The backend follows the device: NCCL on the
  card, gloo on the CPU.
* :class:`NamedSharding` is a mesh and a spec with one entry per array dim,
  read as a ``PartitionSpec`` is: ``None`` (the dim whole), a mesh axis
  name, or a tuple of names (the dim split over those axes, the first
  outermost).
* :func:`global_batch_from_local` is ``jax.make_array_from_process_local_data``
  for one process per device: each rank holds the rows its coordinate on the
  batch axes selects, every other dim whole (the ranks of one ``seq`` group
  read the same rows), and keeps its block of each leaf as a ``DTensor``
  whose global shape, and whose block on each rank, are JAX's
  ``addressable_devices_indices_map`` for the same mesh and spec.
"""

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from petastorm_tpu_torch.gpu.transfer import canonical_dtype, resolve_device

__all__ = ['init_distributed', 'make_mesh', 'NamedSharding', 'data_parallel_sharding',
           'global_batch_from_local', 'host_shard_info', 'sync_hosts', 'min_over_hosts',
           'epoch_steps', 'axis_size', 'axis_index', 'world_size', 'group_device']


def world_size():
    """The default group's size, 1 when no group is up."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def group_device():
    """The device the default group's collectives run on: the rank's card
    under NCCL, else the CPU."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def init_distributed(device=None, store_path=None, rank=0, world_size=1):
    """Start the default process group once; returns ``(rank, world)``.

    Under torchrun (``RANK`` in the environment) the group rendezvouses
    through its ``env://`` variables; otherwise through a ``dist.FileStore``
    at ``store_path`` as ``rank`` of ``world_size`` (a file in a new
    temporary directory when there is one rank and no path).  The backend
    is NCCL for a ``cuda`` device (the default, as every entry point of the
    port) and gloo for the CPU; on the card the rank's device
    (``LOCAL_RANK``, else the rank modulo the cards) is made current first.
    A group already up is kept when its backend is the device's."""
    device = resolve_device(device)
    backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError('the process group runs %s, but %s needs %s'
                               % (dist.get_backend(), device, backend))
        return dist.get_rank(), dist.get_world_size()
    env = 'RANK' in os.environ
    if env:
        rank, world_size = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
    kwargs = {}
    if device.type == 'cuda':
        local = int(os.environ.get('LOCAL_RANK', rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs['device_id'] = torch.device('cuda', local)
    if env:
        dist.init_process_group(backend, init_method='env://', **kwargs)
    else:
        if store_path is None:
            if world_size != 1:
                raise ValueError('a group of %d ranks needs a store_path every rank shares'
                                 % world_size)
            store_path = os.path.join(tempfile.mkdtemp(prefix='pstpu_torch_group_'), 'store')
        dist.init_process_group(backend, store=dist.FileStore(store_path, world_size),
                                rank=rank, world_size=world_size, **kwargs)
    return dist.get_rank(), dist.get_world_size()


def make_mesh(axis_shapes=None, devices=None):
    """A ``DeviceMesh`` over the group's ranks with named dims.

    ``axis_shapes``: ordered ``{axis_name: size}``; ``-1`` for one axis means
    "all remaining ranks".  Default: 1-D ``{'data': world}``.  ``devices``:
    the ranks, laid out row-major (default every rank in order).  The group
    must be up (:func:`init_distributed`); the mesh's device type is its
    backend's."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError('make_mesh needs the process group: start it with '
                           'parallel.init_distributed')
    devices = list(devices if devices is not None else range(dist.get_world_size()))
    if axis_shapes is None:
        axis_shapes = {'data': len(devices)}
    names = list(axis_shapes)
    sizes = list(axis_shapes.values())
    if sizes.count(-1) > 1:
        raise ValueError('At most one axis may be -1')
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if len(devices) % known:
            raise ValueError('%d devices not divisible by %d' % (len(devices), known))
        sizes[sizes.index(-1)] = len(devices) // known
    total = int(np.prod(sizes))
    if total != len(devices):
        raise ValueError('Mesh shape %s needs %d devices, have %d'
                         % (dict(zip(names, sizes)), total, len(devices)))
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    device_type = group_device().type
    if devices == list(range(dist.get_world_size())):
        return init_device_mesh(device_type, tuple(sizes), mesh_dim_names=tuple(names))
    return DeviceMesh(device_type, torch.tensor(devices).reshape(sizes),
                      mesh_dim_names=tuple(names))


def axis_size(mesh, name):
    """The size of the mesh axis ``name``."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh, name):
    """This rank's coordinate on the mesh axis ``name``."""
    return mesh.get_local_rank(name)


class NamedSharding(object):
    """``mesh`` and ``spec``, one entry per leading array dim (see the module
    docstring); the port's ``jax.sharding.NamedSharding``."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec)
        names = mesh.mesh_dim_names
        used = [a for entry in self.spec for a in self._names(entry)]
        for a in used:
            if a not in names:
                raise ValueError('spec %r names axis %r, not in the mesh %r'
                                 % (self.spec, a, names))
        if len(set(used)) != len(used):
            raise ValueError('spec %r uses a mesh axis twice' % (self.spec,))

    @staticmethod
    def _names(entry):
        if entry is None:
            return ()
        return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)

    def axes(self, dim):
        """The mesh axes that split array dim ``dim`` (outermost first)."""
        return self._names(self.spec[dim]) if dim < len(self.spec) else ()

    def splits(self, ndim):
        """Per array dim of an ``ndim`` leaf: ``(parts, this rank's part)``."""
        if len(self.spec) > ndim:
            raise ValueError('spec %r has %d entries for a leaf of %d dims'
                             % (self.spec, len(self.spec), ndim))
        out = []
        for dim in range(ndim):
            parts, index = 1, 0
            for a in self.axes(dim):
                n = axis_size(self.mesh, a)
                parts, index = parts * n, index * n + axis_index(self.mesh, a)
            out.append((parts, index))
        return out

    def _cut(self, shape, splits):
        out = []
        for dim, (size, (parts, i)) in enumerate(zip(shape, splits)):
            if size % parts:
                raise ValueError('spec %r cannot split dim %d of size %d into %d equal parts'
                                 % (self.spec, dim, size, parts))
            out.append(slice(i * (size // parts), (i + 1) * (size // parts)))
        return tuple(out)

    def index(self, shape):
        """This rank's block of a global array of ``shape``, as slices: what
        ``addressable_devices_indices_map(shape)`` gives its device.  A dim
        its axes cannot split evenly raises."""
        return self._cut(shape, self.splits(len(shape)))

    def local_index(self, shape):
        """This rank's block of its local data of ``shape`` (its rows over
        the batch axes, every other dim whole): dim 0 whole, every other dim
        as :meth:`index` cuts it."""
        splits = self.splits(len(shape))
        return self._cut(shape, [(1, 0)] + splits[1:]) if shape else ()

    def global_shape(self, block_shape):
        """The global shape whose block on this rank has ``block_shape``."""
        return tuple(size * parts for size, (parts, _)
                     in zip(block_shape, self.splits(len(block_shape))))

    def placements(self):
        """The ``DTensor`` placements of this sharding: per mesh dim,
        ``Shard(d)`` where the spec splits array dim ``d`` over it, else
        ``Replicate()``.  A dim split over several axes takes them in mesh
        order, as ``DTensor`` nests its shards."""
        from torch.distributed.tensor import Replicate, Shard
        names = self.mesh.mesh_dim_names
        out = [Replicate()] * len(names)
        for dim in range(len(self.spec)):
            axes = self.axes(dim)
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError('spec %r splits dim %d over %r out of mesh order %r'
                                 % (self.spec, dim, axes, names))
            for i in order:
                out[i] = Shard(dim)
        return out

    def wrap(self, block):
        """``block`` (this rank's, on its device) as a ``DTensor`` of the
        global shape; ``to_local()`` gives ``block`` back."""
        from torch.distributed.tensor import DTensor
        shape = self.global_shape(tuple(block.shape))
        stride = tuple(int(np.prod(shape[d + 1:], dtype=np.int64)) for d in range(len(shape)))
        return DTensor.from_local(block, self.mesh, self.placements(), run_check=False,
                                  shape=torch.Size(shape), stride=stride)

    def blocks(self, local_tree):
        """This rank's block of each leaf (numpy array or tensor) of a tree
        of dicts of its local data (see :meth:`local_index`)."""
        return _map_leaves(lambda x: x[self.local_index(tuple(x.shape))], local_tree)

    def wrap_tree(self, block_tree):
        """:meth:`wrap` over each tensor of a tree of dicts."""
        return _map_leaves(self.wrap, block_tree)

    def __repr__(self):
        return 'NamedSharding(mesh=%r, spec=%r)' % (self.mesh, self.spec)


def data_parallel_sharding(mesh, batch_axes=('data',)):
    """Sharding placing the leading (batch) dim over ``batch_axes``."""
    return NamedSharding(mesh, (tuple(batch_axes) if len(batch_axes) > 1 else batch_axes[0],))


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def global_batch_from_local(local_batch_tree, sharding):
    """This rank's rows (a tree of dicts of numpy arrays or tensors) as a
    tree of ``DTensor`` global arrays laid out per ``sharding``: each keeps
    this rank's block, on its device (numpy leaves take their device dtype,
    int64 -> int32 and float64 -> float32, as JAX's)."""
    device = group_device()

    def on_device(x):
        t = x if isinstance(x, torch.Tensor) else \
            torch.from_numpy(np.asarray(x).astype(canonical_dtype(np.asarray(x).dtype)))
        return t.to(device).contiguous()

    return sharding.wrap_tree(_map_leaves(on_device, sharding.blocks(local_batch_tree)))


def host_shard_info():
    """``(rank, world)`` - the loader's default shard identity; ``(0, 1)``
    with no group up."""
    if world_size() == 1:
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def sync_hosts(tag='petastorm_tpu'):
    """Barrier over every rank (e.g. 'all ranks finished the epoch'); a
    no-op with no group up.  ``tag`` is accepted for the JAX signature."""
    del tag
    if world_size() > 1:
        dist.barrier()


def min_over_hosts(value):
    """``min(value)`` over every rank; the identity at world size 1 (no
    collective runs)."""
    if world_size() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=group_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def epoch_steps(reader, batch_size, drop_last=True):
    """Per-rank steps ALL ranks can take this epoch without hanging a
    collective: the fewest full batches any rank's shard holds (row groups
    shard round-robin, so ranks can hold different row counts, and a rank
    that runs out of batches deadlocks every collective).

    Cap the loop with ``itertools.islice(loader, epoch_steps(reader, B))``.
    ``predicate=`` and NGram readers raise, as does a batch reader whose
    ``transform_spec`` has a ``func``: their yields are data-dependent.
    ``drop_last=False`` is single-rank only: the final ragged batch would
    have different shapes on different ranks."""
    if getattr(reader, 'ngram', None) is not None:
        raise ValueError('epoch_steps cannot bound an NGram reader: window '
                         'counts are data-dependent; set the step budget '
                         'explicitly')
    if getattr(reader, 'predicate', None) is not None:
        raise ValueError('epoch_steps cannot bound a predicate= reader: the '
                         'filtered yield is data-dependent; set the step '
                         'budget explicitly')
    if getattr(reader, 'transform_may_change_row_count', False):
        raise ValueError('epoch_steps cannot bound a batch reader whose '
                         'transform_spec has a func: the DataFrame transform '
                         'may change the row count, making the yield data-'
                         'dependent; set the step budget explicitly')
    if not drop_last and world_size() > 1:
        raise ValueError('drop_last=False is unsafe multi-host: the ragged '
                         'final batch differs across hosts')
    local = reader.num_local_rows()
    steps = local // batch_size if drop_last else -(-local // batch_size)
    return min_over_hosts(steps)
