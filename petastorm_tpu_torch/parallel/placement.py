"""Place parameters on a mesh of ranks: the port's ``jax.device_put(params,
shardings)``.

In the JAX package a parameter placed with a ``NamedSharding`` is one
global array whose shards live on the devices, and GSPMD makes every
product that reads it correct.  Here each rank keeps only its block, and the
modules compute with it:

* :func:`place` puts a model's parameters on the mesh by ``{name:
  NamedSharding}`` (``models.transformer.param_shardings``,
  ``parallel.fsdp_shardings``, or both composed).  Specs are stated in flax
  axes; each parameter is carried to its flax layout, cut to this rank's
  block and carried back (:func:`petastorm_tpu_torch.convert.flax_leaves`),
  so a head-sharded ``qkv`` keeps the q, k and v rows of this rank's heads.
  A block split over the model axis is what the module computes with
  (tensor parallelism: :class:`~petastorm_tpu_torch.models.transformer.Dense`
  column- or row-parallel, ``Attention`` on this rank's heads, ``Embed``
  over this rank's vocabulary rows); a block split over any other axis is
  gathered before each use (FSDP) by a differentiable all-gather whose
  backward is the reduce-scatter, through a ``torch.nn.utils.parametrize``
  parametrization, so the rank stores only its block.
* :func:`device_put` cuts each tensor of a tree of dicts to this rank's
  block (the pipeline's stacked stages, the MoE's experts).
* :func:`reduce_gradients` sums the gradients of the parameters that a
  batch axis replicates over that axis, in one all-reduce per axis: the
  data-parallel half of a step that GSPMD derives from the global batch.

Nothing here runs on an axis of one rank: a placement on ``{'data': 1,
'model': 1}`` leaves every parameter whole and issues no collective.
"""

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from petastorm_tpu_torch.parallel import collectives
from petastorm_tpu_torch.parallel.mesh import NamedSharding, group_device
from petastorm_tpu_torch.parallel.ring_attention import SeqAxis

__all__ = ['place', 'device_put', 'local_blocks', 'reduce_gradients']


class _Gathered(nn.Module):
    """The parametrization of an FSDP-placed parameter: its stored block
    (torch layout) gathered over each axis that splits it but the model
    axis, in flax layout, and carried back."""

    def __init__(self, leaf, block_shape, gathers):
        super().__init__()
        self.leaf, self.block_shape, self.gathers = leaf, tuple(block_shape), gathers

    def forward(self, stored):
        f = self.leaf.to_flax(stored, self.block_shape)
        for dim, axis in self.gathers:
            f = collectives.all_gather(f, axis, dim)
        return self.leaf.to_torch(f)


class Placement(object):
    """What :func:`place` did to one parameter: its ``sharding``, the flax
    dims the model axis splits (``tp_dims``), the stored block's flax shape
    and the gathers before use."""

    def __init__(self, sharding, leaf, tp_dims, block_shape, gathers):
        self.sharding, self.leaf, self.tp_dims = sharding, leaf, tuple(tp_dims)
        self.block_shape, self.gathers = tuple(block_shape), gathers


def _axis(mesh, name, cache):
    if name not in cache:
        cache[name] = SeqAxis(mesh, name)
    return cache[name]


def _stored(module, attr):
    if parametrize.is_parametrized(module, attr):
        return module.parametrizations[attr].original
    return getattr(module, attr)


def place(model, shardings, model_axis='model'):
    """Put ``model``'s parameters on the mesh, in place; returns ``model``.

    ``shardings``: ``{parameter name: NamedSharding}`` for every parameter
    (specs in flax axes, as the JAX package's rules give them).  The model
    axis may split the dims the Megatron rules split (heads, feed-forward
    features, vocabulary rows); any other axis may split any one dim.  The
    model then computes what the unplaced model computes: every rank of a
    model group reads the same rows (shard the batch over the other axes),
    every rank gets the whole logits, and after :func:`reduce_gradients`
    over the batch axes every block holds its share of the gradient of the
    loss summed over ranks."""
    from petastorm_tpu_torch.convert import flax_leaves
    leaves = flax_leaves(model)
    params = dict(model.named_parameters())
    if set(shardings) != set(params):
        raise ValueError('shardings name %s; the model has %s'
                         % (sorted(set(shardings) - set(params)) or 'no other parameter',
                            sorted(set(params) - set(shardings)) or 'no other parameter'))
    modules = dict(model.named_modules())
    axes = {}
    placements = {}
    for name, p in params.items():
        leaf, sharding = leaves[name], shardings[name]
        if not isinstance(sharding, NamedSharding):
            raise TypeError('%s: expected a NamedSharding, got %r' % (name, sharding))
        mesh = sharding.mesh
        tp_dims, gathers = [], []
        for dim in range(len(sharding.spec)):
            names = sharding.axes(dim)
            if not names:
                continue
            if len(names) > 1:
                raise ValueError('%s: dim %d is split over %r; place() splits a dim over one '
                                 'axis' % (name, dim, names))
            if names[0] == model_axis:
                tp_dims.append(dim)
            else:
                gathers.append((dim, _axis(mesh, names[0], axes)))
        block = leaf.to_flax(p.detach())[sharding.index(leaf.shape)]
        gathers = [(dim, axis) for dim, axis in gathers if axis.size > 1]
        module_name, _, attr = name.rpartition('.')
        module = modules[module_name]
        stored = nn.Parameter(leaf.to_torch(block).contiguous().clone(),
                              requires_grad=p.requires_grad)
        delattr(module, attr)
        module.register_parameter(attr, stored)
        if gathers:
            parametrize.register_parametrization(module, attr,
                                                 _Gathered(leaf, block.shape, gathers),
                                                 unsafe=True)
        placements[name] = Placement(sharding, leaf, tp_dims, block.shape, gathers)
    tp = {}
    for name, pl in placements.items():
        if pl.tp_dims:
            tp_axis = _axis(pl.sharding.mesh, model_axis, axes)
            if tp_axis.size > 1:
                tp[name] = tp_axis
    _configure(placements, tp, modules)
    model._placements = placements
    return model


def _configure(placements, tp, modules):
    """Set each module's tensor-parallel mode from where the model axis
    splits its parameters; a split no module computes with raises."""
    from petastorm_tpu_torch.models.transformer import Attention, Dense, Embed
    used = set()
    for module_name, module in modules.items():
        prefix = module_name + '.' if module_name else ''
        if isinstance(module, Dense):
            w, b = prefix + 'weight', prefix + 'bias'
            used.update((w, b))
            if w not in tp and b not in tp:
                continue
            leaf = placements[w].leaf
            dims = placements[w].tp_dims
            if w in tp and all(d >= leaf.in_axes for d in dims) and b in tp:
                module.tp = ('column', tp[w])
            elif w in tp and all(d < leaf.in_axes for d in dims) and b not in tp:
                module.tp = ('row', tp[w])
            else:
                raise ValueError('%s: the model axis splits its kernel on flax dims %s and its '
                                 'bias on %s: neither a column- nor a row-parallel product'
                                 % (module_name, dims, placements[b].tp_dims))
        elif isinstance(module, Embed):
            e = prefix + 'embedding'
            used.add(e)
            if e in tp:
                if placements[e].tp_dims != (0,):
                    raise ValueError('%s: the model axis splits the table on dims %s; only '
                                     'its rows (dim 0) can be split'
                                     % (module_name, placements[e].tp_dims))
                axis = tp[e]
                module.tp = (axis, axis.index * placements[e].block_shape[0])
    for module_name, module in modules.items():
        if isinstance(module, Attention):
            _configure_attention(module)
    stray = sorted(set(tp) - used)
    if stray:
        raise ValueError('the model axis splits %s, which no module computes with in blocks'
                         % stray)


def _configure_attention(attn):
    q = attn.qkv if attn.num_kv_heads is None else attn.q
    if q.tp is None:
        if attn.out.tp is not None or (attn.num_kv_heads is not None and attn.kv.tp is not None):
            raise ValueError('the model axis splits the attention output or kv heads but '
                             'not the query heads')
        return
    if q.tp[0] != 'column' or attn.out.tp is None or attn.out.tp[0] != 'row':
        raise ValueError('query heads split without a row-parallel output projection')
    axis = q.tp[1]
    attn.local_heads = attn.num_heads // axis.size
    if attn.num_kv_heads is None:
        attn.local_kv_heads = attn.local_heads
        return
    if attn.kv.tp is not None:
        attn.local_kv_heads = attn.num_kv_heads // axis.size
        return
    # kv replicated (kv_heads not divisible by the axis, e.g. MQA): every rank
    # computes every kv head and keeps those its query heads read
    g = attn.num_heads // attn.num_kv_heads
    first = axis.index * attn.local_heads
    if attn.local_heads % g == 0:
        count = attn.local_heads // g
    elif g % attn.local_heads == 0:
        count = 1
    else:
        raise ValueError('%d query heads per rank do not cover whole groups of %d over %d kv '
                         'heads' % (attn.local_heads, g, attn.num_kv_heads))
    attn.kv_select = (axis, first // g, count)
    attn.local_kv_heads = count


def local_blocks(model):
    """``{parameter name: this rank's stored block}`` of a placed model
    (torch layout; the unplaced parameter where :func:`place` did not run)."""
    placements = getattr(model, '_placements', {})
    modules = dict(model.named_modules())
    out = {}
    for name in placements or dict(model.named_parameters()):
        module_name, _, attr = name.rpartition('.')
        out[name] = _stored(modules[module_name], attr)
    return out


def device_put(tree, sharding):
    """This rank's block of each tensor (or array) of a tree of dicts, on
    the group's device; ``sharding`` is one ``NamedSharding`` for every
    leaf or a tree of them of the same structure."""
    device = group_device()
    if isinstance(tree, dict):
        return {k: device_put(v, sharding[k] if isinstance(sharding, dict) else sharding)
                for k, v in tree.items()}
    t = torch.as_tensor(tree)
    return t[sharding.index(tuple(t.shape))].to(device).contiguous().clone()


def _pairs(params, shardings):
    if isinstance(params, nn.Module):
        blocks = local_blocks(params)
        return [(blocks[n], pl.sharding) for n, pl in params._placements.items()]
    out = []

    def walk(p, s):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], s[k] if isinstance(s, dict) else s)
        else:
            out.append((p, s))
    walk(params, shardings)
    return out


def reduce_gradients(params, axes=('data',), shardings=None):
    """Sum each gradient over every axis of ``axes`` that its sharding does
    not split (the axes whose ranks read other rows of the batch), in one
    flat all-reduce per axis.  ``params``: a placed model, or a tree of
    tensors with ``shardings`` (one ``NamedSharding`` or a tree of them).
    An FSDP block needs nothing over its own axis: its gather's backward
    already summed there."""
    pairs = [(p, s) for p, s in _pairs(params, shardings) if p.grad is not None]
    if not pairs:
        return
    mesh = pairs[0][1].mesh
    for name in axes:
        if name not in mesh.mesh_dim_names:
            continue
        axis = SeqAxis(mesh, name)
        if axis.size == 1:
            continue
        grads = [p.grad for p, s in pairs
                 if not any(name in s.axes(d) for d in range(len(s.spec)))]
        if not grads:
            continue
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=axis.group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
