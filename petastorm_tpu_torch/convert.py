"""Carry flax parameters of the JAX package's ViT into the port's modules.

``vit_params_from_flax(params)`` takes the ``params`` tree of
``petastorm_tpu.models.vit.ViT`` (nested dicts of numpy arrays, e.g.
``jax.tree.map(np.asarray, variables['params'])``) and returns a
``state_dict`` for :class:`petastorm_tpu_torch.models.vit.ViT` of the same
configuration; ``block_params_from_flax`` and
``attention_params_from_flax`` do the same for one ``Block`` or
``Attention``.  Layouts:

=======================================  ====================================
flax                                     port
=======================================  ====================================
``Conv`` kernel HWIO                     ``Conv2d`` weight OIHW
``Dense`` kernel ``(in, out)``           ``Dense.weight`` ``(out, in)``
qkv ``DenseGeneral`` ``(d, 3, h, hd)``   ``(3*h*hd, d)``, rows (qkv, h, hd)
out ``DenseGeneral`` ``(h, hd, d)``      ``(d, h*hd)``
=======================================  ====================================

The maps are linear, so they carry gradient trees across as well.
"""

import numpy as np
import torch

__all__ = ['vit_params_from_flax', 'block_params_from_flax', 'attention_params_from_flax']


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(name, p, in_axes=1):
    """A (General)Dense whose kernel contracts its first ``in_axes`` axes."""
    kernel = np.asarray(p['kernel'], dtype=np.float32)
    fan_in = int(np.prod(kernel.shape[:in_axes]))
    return {name + '.weight': _t(kernel.reshape(fan_in, -1).T),
            name + '.bias': _t(np.asarray(p['bias']).reshape(-1))}


def attention_params_from_flax(p):
    """flax ``Attention`` params (MHA) -> port ``Attention`` state_dict."""
    out = _dense('qkv', p['qkv'])                 # (d, 3, h, hd) -> (3*h*hd, d)
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
    i = 0
    while 'block_%d' % i in params:
        out.update({'blocks.%d.%s' % (i, k): v
                    for k, v in block_params_from_flax(params['block_%d' % i]).items()})
        i += 1
    out.update(_dense('head', params['head']))
    return out
