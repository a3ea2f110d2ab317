"""Carry flax parameters of the JAX package's models into the port's modules.

``vit_params_from_flax(params)`` takes the ``params`` tree of
``petastorm_tpu.models.vit.ViT`` (nested dicts of numpy arrays, e.g.
``jax.tree.map(np.asarray, variables['params'])``) and returns a
``state_dict`` for :class:`petastorm_tpu_torch.models.vit.ViT` of the same
configuration; ``block_params_from_flax`` and
``attention_params_from_flax`` do the same for one ``Block`` or
``Attention``.  ``resnet_params_from_flax(params, batch_stats)`` does the
same for ``petastorm_tpu.models.resnet.ResNet50``, running statistics
included, and ``bottleneck_params_from_flax`` for one ``BottleneckBlock``;
``mlp_params_from_flax`` for the MNIST example's ``MLP``;
``dlrm_params_from_flax`` for ``petastorm_tpu.models.dlrm.DLRM``.
Layouts:

=======================================  ====================================
flax                                     port
=======================================  ====================================
``Conv`` kernel HWIO                     ``Conv2d``/``Conv`` weight OIHW
``BatchNorm`` scale, bias; stats mean,   ``BatchNorm`` scale, bias,
var                                      running_mean, running_var
``Dense`` kernel ``(in, out)``           ``Dense.weight`` ``(out, in)``
qkv ``DenseGeneral`` ``(d, 3, h, hd)``   ``(3*h*hd, d)``, rows (qkv, h, hd)
q ``DenseGeneral`` ``(d, h, hd)`` (GQA)  ``(h*hd, d)``
kv ``DenseGeneral`` ``(d, 2, h, hd)``    ``(2*h*hd, d)``, rows (kv, h, hd)
out ``DenseGeneral`` ``(h, hd, d)``      ``(d, h*hd)``
``Embed`` embedding ``(n, d)``           ``Embed.embedding`` ``(n, d)``
=======================================  ====================================

The maps are linear, so they carry gradient trees across as well.

:func:`flax_leaves` goes the other way for a transformer or ViT of the
port: for each parameter, the flax leaf that these functions map onto it
(its path of flax keys, its flax shape and the layout map both ways), so
that a sharding stated in flax axes (``models.transformer.param_shardings``,
``parallel.fsdp_shardings``) reaches the torch tensor through the same map.
``moe_params_from_flax`` carries ``petastorm_tpu.models.moe`` parameters.
"""

import numpy as np
import torch

__all__ = ['vit_params_from_flax', 'block_params_from_flax', 'attention_params_from_flax',
           'transformer_lm_params_from_flax', 'resnet_params_from_flax',
           'bottleneck_params_from_flax', 'mlp_params_from_flax', 'dlrm_params_from_flax',
           'moe_params_from_flax', 'FlaxLeaf', 'flax_leaves']


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(name, p, in_axes=1):
    """A (General)Dense whose kernel contracts its first ``in_axes`` axes."""
    kernel = np.asarray(p['kernel'], dtype=np.float32)
    fan_in = int(np.prod(kernel.shape[:in_axes]))
    return {name + '.weight': _t(kernel.reshape(fan_in, -1).T),
            name + '.bias': _t(np.asarray(p['bias']).reshape(-1))}


def attention_params_from_flax(p):
    """flax ``Attention`` params (MHA or GQA) -> port ``Attention`` state_dict."""
    if 'qkv' in p:
        out = _dense('qkv', p['qkv'])             # (d, 3, h, hd) -> (3*h*hd, d)
    else:
        out = _dense('q', p['q'])                 # (d, h, hd) -> (h*hd, d)
        out.update(_dense('kv', p['kv']))         # (d, 2, h_kv, hd) -> (2*h_kv*hd, d)
    out.update(_dense('out', p['out'], in_axes=2))  # (h, hd, d) -> (d, h*hd)
    return out


def block_params_from_flax(p):
    """flax ``Block`` params -> port ``Block`` state_dict."""
    out = {'ln1.scale': _t(p['ln1']['scale']), 'ln2.scale': _t(p['ln2']['scale'])}
    out.update({'attn.' + k: v for k, v in attention_params_from_flax(p['attn']).items()})
    out.update(_dense('ffw_in', p['ffw_in']))
    out.update(_dense('ffw_out', p['ffw_out']))
    return out


def vit_params_from_flax(params):
    """flax ``ViT`` params -> port ``ViT`` state_dict."""
    conv = np.asarray(params['patch_embed']['kernel'], dtype=np.float32)   # HWIO
    out = {'patch_embed.weight': _t(conv.transpose(3, 2, 0, 1)),           # OIHW
           'patch_embed.bias': _t(params['patch_embed']['bias']),
           'pos_embed': _t(params['pos_embed']),
           'ln_f.scale': _t(params['ln_f']['scale'])}
    if 'cls_token' in params:
        out['cls_token'] = _t(params['cls_token'])
    out.update(_blocks(params))
    out.update(_dense('head', params['head']))
    return out


def _blocks(params):
    """flax ``block_i`` subtrees -> the port's ``blocks.i.*`` entries."""
    out = {}
    i = 0
    while 'block_%d' % i in params:
        out.update({'blocks.%d.%s' % (i, k): v
                    for k, v in block_params_from_flax(params['block_%d' % i]).items()})
        i += 1
    return out


def transformer_lm_params_from_flax(params):
    """flax ``TransformerLM`` params -> port ``TransformerLM`` state_dict."""
    out = {'embed.embedding': _t(params['embed']['embedding']),
           'ln_f.scale': _t(params['ln_f']['scale'])}
    if 'pos_embed' in params:
        out['pos_embed.embedding'] = _t(params['pos_embed']['embedding'])
    out.update(_blocks(params))
    return out


def _conv(name, p):
    kernel = np.asarray(p['kernel'], dtype=np.float32)                     # HWIO
    return {name + '.weight': _t(kernel.transpose(3, 2, 0, 1))}            # OIHW


def _batch_norm(name, p, stats):
    out = {name + '.scale': _t(p['scale']), name + '.bias': _t(p['bias'])}
    if stats is not None:
        out.update({name + '.running_mean': _t(stats['mean']),
                    name + '.running_var': _t(stats['var'])})
    return out


def bottleneck_params_from_flax(params, batch_stats=None):
    """flax ``BottleneckBlock`` params (and ``batch_stats``) -> port
    ``BottleneckBlock`` state_dict.  flax names the layers in call order:
    ``Conv_0..2``/``BatchNorm_0..2`` on the main branch, ``Conv_3`` and
    ``BatchNorm_3`` on the projection."""
    out = {}
    for i, (conv, bn) in enumerate((('conv0', 'bn0'), ('conv1', 'bn1'), ('conv2', 'bn2'),
                                    ('proj', 'proj_bn'))):
        if 'Conv_%d' % i not in params:
            break
        out.update(_conv(conv, params['Conv_%d' % i]))
        out.update(_batch_norm(bn, params['BatchNorm_%d' % i],
                               None if batch_stats is None else batch_stats['BatchNorm_%d' % i]))
    return out


def resnet_params_from_flax(params, batch_stats=None):
    """flax ``ResNet50`` params (and ``batch_stats``) -> port ``ResNet50``
    state_dict; without ``batch_stats`` (a gradient tree) the running
    statistics are left out."""
    stats = batch_stats or {}
    out = _conv('stem', params['Conv_0'])
    out.update(_batch_norm('stem_bn', params['BatchNorm_0'], stats.get('BatchNorm_0')))
    i = 0
    while 'BottleneckBlock_%d' % i in params:
        name = 'BottleneckBlock_%d' % i
        out.update({'blocks.%d.%s' % (i, k): v for k, v in bottleneck_params_from_flax(
            params[name], stats.get(name)).items()})
        i += 1
    out.update(_dense('head', params['Dense_0']))
    return out


def mlp_params_from_flax(params):
    """flax ``MLP`` params (``Dense_0`` .. ``Dense_k``) -> port
    :class:`~petastorm_tpu_torch.models.mlp.MLP` state_dict: each kernel
    ``(in, out)`` becomes the weight ``(out, in)``."""
    out = {}
    for i in range(len(params)):
        out.update(_dense('layers.%d' % i, params['Dense_%d' % i]))
    return out


def dlrm_params_from_flax(params):
    """flax ``DLRM`` params -> port :class:`~petastorm_tpu_torch.models.dlrm.DLRM`
    state_dict: the bottom MLP (``MLP_0``) and the top one (``MLP_1``) by
    :func:`mlp_params_from_flax`'s rule, each ``table_i`` embedding
    ``(vocab, dim)`` as it is."""
    out = {}
    for flax_name, name in (('MLP_0', 'bottom'), ('MLP_1', 'top')):
        mlp = params[flax_name]
        for i in range(len(mlp)):
            out.update(_dense('%s.layers.%d' % (name, i), mlp['Dense_%d' % i]))
    for key, p in params.items():
        if key.startswith('table_'):
            out['tables.%d.weight' % int(key[len('table_'):])] = _t(p['embedding'])
    return out


def moe_params_from_flax(params):
    """``petastorm_tpu.models.moe.moe_init`` params -> the port's MoE params:
    ``router`` ``[d, E]``, ``w1`` ``[E, d, f]`` and ``w2`` ``[E, f, d]``,
    the same layouts, as fp32 tensors."""
    return {name: _t(params[name]) for name in ('router', 'w1', 'w2')}


class FlaxLeaf(object):
    """The flax leaf one port parameter is carried from: its ``path`` (a
    tuple of flax keys), its flax ``shape``, and the layout map between the
    two, which holds for any block of the leaf as well as the whole.

    ``kind`` is ``'dense'`` (a kernel whose first ``in_axes`` flax axes are
    the input features: torch ``[out, in]``), ``'conv'`` (HWIO against
    OIHW), ``'flat'`` (a ``DenseGeneral`` bias, flattened in torch) or
    ``'plain'`` (the same layout)."""

    def __init__(self, path, shape, kind='plain', in_axes=1):
        self.path, self.shape, self.kind, self.in_axes = tuple(path), tuple(shape), kind, in_axes

    def to_flax(self, t, shape=None):
        """A torch-layout tensor (the leaf, or a block of it whose flax
        shape is ``shape``) in the flax layout."""
        shape = tuple(shape or self.shape)
        if self.kind == 'dense':
            return t.t().reshape(shape)
        if self.kind == 'conv':
            return t.permute(2, 3, 1, 0)
        return t.reshape(shape)

    def to_torch(self, a):
        """A flax-layout tensor (the leaf or a block of it) in torch's."""
        if self.kind == 'dense':
            return a.reshape(int(np.prod(a.shape[:self.in_axes])), -1).t()
        if self.kind == 'conv':
            return a.permute(3, 2, 0, 1)
        if self.kind == 'flat':
            return a.reshape(-1)
        return a

    def __repr__(self):
        return 'FlaxLeaf(%r, %r, %r)' % (self.path, self.shape, self.kind)


def _flax_path(module_name, leaf):
    keys, parts = [], [k for k in module_name.split('.') if k]
    i = 0
    while i < len(parts):
        if parts[i] == 'blocks' and i + 1 < len(parts):
            keys.append('block_%s' % parts[i + 1])
            i += 2
            continue
        keys.append(parts[i])
        i += 1
    return tuple(keys + [leaf])


def flax_leaves(model):
    """``{parameter name: FlaxLeaf}`` for a port ``TransformerLM``, ``ViT``,
    ``Block`` or ``Attention`` (or any module of ``Dense``, ``Embed``,
    ``RMSNorm``, ``Conv2d`` and plain parameters): the inverse of
    :func:`transformer_lm_params_from_flax` and :func:`vit_params_from_flax`.
    Run it on the model before :func:`parallel.place
    <petastorm_tpu_torch.parallel.place>` replaces its parameters."""
    from torch import nn

    from petastorm_tpu_torch.models.transformer import Attention, Dense
    dense = {}      # id(Dense) -> (kernel shape, bias shape, in_axes)
    for m in model.modules():
        if isinstance(m, Attention):
            h, hd = m.num_heads, m.head_dim
            d = h * hd
            if m.num_kv_heads is None:
                dense[id(m.qkv)] = ((d, 3, h, hd), (3, h, hd), 1)
            else:
                dense[id(m.q)] = ((d, h, hd), (h, hd), 1)
                dense[id(m.kv)] = ((d, 2, m.num_kv_heads, hd), (2, m.num_kv_heads, hd), 1)
            dense[id(m.out)] = ((h, hd, d), (d,), 2)
    modules = dict(model.named_modules())
    out = {}
    for name, p in model.named_parameters():
        module_name, _, leaf = name.rpartition('.')
        module = modules[module_name]
        if isinstance(module, Dense):
            out_f, in_f = p.shape if leaf == 'weight' else (p.shape[0], None)
            kernel, bias, in_axes = dense.get(id(module), ((in_f, out_f), (out_f,), 1))
            out[name] = (FlaxLeaf(_flax_path(module_name, 'kernel'), kernel, 'dense', in_axes)
                         if leaf == 'weight' else
                         FlaxLeaf(_flax_path(module_name, 'bias'), bias,
                                  'flat' if len(bias) > 1 else 'plain'))
        elif isinstance(module, nn.Conv2d) and leaf == 'weight':
            o, i, kh, kw = p.shape
            out[name] = FlaxLeaf(_flax_path(module_name, 'kernel'), (kh, kw, i, o), 'conv')
        else:
            out[name] = FlaxLeaf(_flax_path(module_name, leaf), p.shape)
    return out
