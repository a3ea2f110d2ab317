"""The port's ResNet-50 modules against the JAX package's flax modules
(``petastorm_tpu.models.resnet``), with flax parameters and batch
statistics carried across by ``petastorm_tpu_torch.convert``.

Tolerances, with ``dtype=float32``: 2e-4 absolute on outputs, logits and
running statistics; gradients within 1e-3 of the largest magnitude of each
tensor (relative).  With bf16: 3e-2 of the largest magnitude of what is
compared (the reference's own bf16 flash tolerance), since the two
frameworks round bf16 intermediates at different points.

Train mode runs the whole model at 64x64, batch 2, and eval mode at 32x32.
Train mode at 32x32, batch 2 is chaotic, in the reference alone: the last
stage's BatchNorms then see two values per channel, and normalising two
nearly equal values amplifies their difference up to 1 / sqrt(epsilon)
(316x) per layer, so scaling the input by (1 + 1e-6) moves the flax
model's own fp32 logits by 0.078 (of 3.8).  At 64x64 each of those BNs sees
eight values and the same perturbation moves them by 3e-6.  The SGD step
takes its reference from flax in float64: XLA's fp32 gradients on the CPU
are up to 2.5e-3 of a tensor's largest magnitude away from it.  Run this
file as a script (``PYTHONPATH=. python tests/test_torch_resnet.py``) to
print these numbers.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from petastorm_tpu.models import resnet as jax_resnet

from petastorm_tpu_torch.convert import bottleneck_params_from_flax, resnet_params_from_flax
from petastorm_tpu_torch.models.resnet import (BatchNorm, BottleneckBlock, Conv, ResNet50,
                                               same_padding)

DTYPES = {'float32': (jnp.float32, torch.float32), 'bfloat16': (jnp.bfloat16, torch.bfloat16)}
ATOL = 2e-4
BF16_SHARE = 3e-2


def _perturbed(tree, seed, sigma=0.05):
    """numpy copy of a flax tree with noise added, so zero-initialised
    biases and the blocks' zero BN scales carry signal too."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, sigma, a.shape).astype(np.float32), tree)


def _stats(tree, seed):
    """Running statistics away from (0, 1): mean +- 0.1, var in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) * rng.uniform(0.5, 1.5, a.shape)
                   + rng.normal(0, 0.1, a.shape) * (np.asarray(a) == 0)).astype(np.float32),
        tree)


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().float().numpy()


def _close(got, want, dtype_name, err_msg=''):
    want = np.asarray(want, np.float32)
    atol = ATOL if dtype_name == 'float32' else BF16_SHARE * np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=atol, rtol=0,
                               err_msg=err_msg)


@pytest.mark.parametrize('size,pads', [(7, (1, 1)), (8, (0, 1)), (56, (0, 1))])
def test_stride2_same_padding_matches_flax(size, pads):
    """flax's 'SAME' on a 3x3 stride-2 conv pads (0, 1) on even inputs:
    torch's ``padding=1`` gives the same shape and other numbers."""
    x = np.random.default_rng(size).standard_normal((2, size, size, 4)).astype(np.float32)
    conv = nn.Conv(6, (3, 3), strides=(2, 2), use_bias=False, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, conv.init(jax.random.PRNGKey(0), x)['params'])
    want = np.asarray(conv.apply({'params': params}, x))
    port = Conv(4, 6, 3, 2, dtype=torch.float32)
    port.load_state_dict({'weight': torch.tensor(params['kernel'].transpose(3, 2, 0, 1))})
    got = port(_nchw(x))
    assert same_padding(size, 3, 2) == pads
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=0)
    symmetric = F.conv2d(_nchw(x), port.weight, stride=2, padding=1)
    assert symmetric.shape == got.shape
    assert np.allclose(_nhwc(symmetric), want, atol=1e-3) == (pads == (1, 1))


@pytest.mark.parametrize('dtype_name', ['float32', 'bfloat16'])
def test_batchnorm_matches_flax(dtype_name):
    """Batch statistics, the normalised output, the running mean and the
    *biased* running variance after one train-mode call; then eval mode."""
    jdt, tdt = DTYPES[dtype_name]
    x = np.random.default_rng(1).normal(1.5, 2.0, (4, 5, 5, 8)).astype(np.float32)
    n = 4 * 5 * 5
    bn = nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=jdt)
    variables = bn.init(jax.random.PRNGKey(0), x, use_running_average=False)
    params = _perturbed(variables['params'], 2, sigma=0.3)
    stats = _stats(variables['batch_stats'], 3)
    xj = jnp.asarray(x, jdt)
    want, mutated = bn.apply({'params': params, 'batch_stats': stats}, xj,
                             use_running_average=False, mutable=['batch_stats'])
    new_stats = jax.tree.map(np.asarray, mutated['batch_stats'])

    port = BatchNorm(8, tdt)
    port.load_state_dict({'scale': torch.tensor(params['scale']),
                          'bias': torch.tensor(params['bias']),
                          'running_mean': torch.tensor(stats['mean']),
                          'running_var': torch.tensor(stats['var'])})
    got = port(_nchw(np.asarray(xj.astype(jnp.float32))).to(tdt))
    assert got.dtype == tdt and want.dtype == jdt
    _close(_nhwc(got), want.astype(jnp.float32), dtype_name)
    np.testing.assert_allclose(port.running_mean.numpy(), new_stats['mean'], atol=ATOL, rtol=0)
    np.testing.assert_allclose(port.running_var.numpy(), new_stats['var'], atol=ATOL, rtol=0)

    # the batch statistics behind the update: fp32 mean and biased variance
    xf = np.asarray(xj.astype(jnp.float32)).reshape(-1, 8).astype(np.float64)
    batch_mean = (port.running_mean.numpy() - 0.9 * stats['mean']) / 0.1
    batch_var = (port.running_var.numpy() - 0.9 * stats['var']) / 0.1
    np.testing.assert_allclose(batch_mean, xf.mean(0), atol=1e-3, rtol=0)
    np.testing.assert_allclose(batch_var, xf.var(0), atol=1e-3, rtol=0)
    unbiased = 0.9 * stats['var'] + 0.1 * xf.var(0) * n / (n - 1)   # nn.BatchNorm2d's update
    assert np.abs(port.running_var.numpy() - unbiased).max() > 10 * ATOL

    port.eval()
    want_eval = bn.apply({'params': params, 'batch_stats': mutated['batch_stats']}, xj,
                         use_running_average=True)
    got_eval = port(_nchw(np.asarray(xj.astype(jnp.float32))).to(tdt))
    _close(_nhwc(got_eval), want_eval.astype(jnp.float32), dtype_name)
    np.testing.assert_allclose(port.running_var.numpy(), new_stats['var'], atol=ATOL, rtol=0)


@pytest.mark.parametrize('projection', [False, True])
def test_bottleneck_block_forward_and_gradients_match_flax(projection):
    in_channels, strides = (16, 2) if projection else (32, 1)
    x = np.random.default_rng(4).standard_normal((3, 8, 8, in_channels)).astype(np.float32)
    block = jax_resnet.BottleneckBlock(8, strides=strides, projection=projection,
                                       dtype=jnp.float32)
    variables = block.init(jax.random.PRNGKey(1), x)
    params = _perturbed(variables['params'], 5)
    stats = _stats(variables['batch_stats'], 6)
    out_shape = (3, 8 // strides, 8 // strides, 32)
    weights = np.random.default_rng(7).standard_normal(out_shape).astype(np.float32)

    def loss_fn(p, xx):
        y, mutated = block.apply({'params': p, 'batch_stats': stats}, xx,
                                 mutable=['batch_stats'])
        return jnp.sum(y * weights), (y, mutated['batch_stats'])

    (_, (want, new_stats)), (grads, grad_x) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(params, x)

    port = BottleneckBlock(in_channels, 8, strides, projection, dtype=torch.float32)
    port.load_state_dict(bottleneck_params_from_flax(params, stats))
    xt = _nchw(x).requires_grad_()
    got = port(xt)
    (got * _nchw(weights)).sum().backward()
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL, rtol=0)
    want_grads = bottleneck_params_from_flax(jax.tree.map(np.asarray, grads))
    named = dict(port.named_parameters())
    assert set(want_grads) == set(named)
    for name, g in list(want_grads.items()) + [('x', torch.tensor(np.asarray(grad_x)))]:
        actual = _nhwc(xt.grad) if name == 'x' else named[name].grad.numpy()
        expected = g.numpy()
        np.testing.assert_allclose(actual, expected, rtol=0,
                                   atol=1e-3 * np.abs(expected).max(), err_msg=name)
    want_stats = bottleneck_params_from_flax(params, jax.tree.map(np.asarray, new_stats))
    for name, value in port.state_dict().items():
        if 'running' in name:
            np.testing.assert_allclose(value.numpy(), want_stats[name].numpy(), atol=ATOL,
                                       rtol=0, err_msg=name)


@pytest.fixture(scope='module')
def flax_resnet():
    """The flax ResNet50(num_classes=10) with perturbed params and running
    stats: eval-mode logits at 32x32 and train-mode logits and running
    stats at 64x64 (both batch 2), in fp32 and bf16; and one train-mode SGD
    step at 64x64 computed in float64, the reference for gradients."""
    rng = np.random.default_rng(8)
    x_eval = rng.uniform(-2, 2, (2, 32, 32, 3)).astype(np.float32)
    x_train = rng.uniform(-2, 2, (2, 64, 64, 3)).astype(np.float32)
    labels = np.array([3, 7], np.int32)
    init = jax.jit(lambda k, x: jax_resnet.ResNet50(num_classes=10).init(k, x, train=True))
    variables = init(jax.random.PRNGKey(0), x_eval)
    params = _perturbed(variables['params'], 9)
    stats = _stats(variables['batch_stats'], 10)
    out = {'params': params, 'stats': stats, 'x_eval': x_eval, 'x_train': x_train,
           'labels': labels}
    for name, (jdt, _) in DTYPES.items():
        model = jax_resnet.ResNet50(num_classes=10, dtype=jdt)
        out['eval', name] = np.asarray(jax.jit(
            lambda p, s, x: model.apply({'params': p, 'batch_stats': s}, x, train=False))(
                params, stats, x_eval))
        logits, mutated = jax.jit(
            lambda p, s, x: model.apply({'params': p, 'batch_stats': s}, x, train=True,
                                        mutable=['batch_stats']))(params, stats, x_train)
        out['train', name] = np.asarray(logits)
        out['train_stats', name] = jax.tree.map(np.asarray, mutated['batch_stats'])

    with jax.enable_x64(True):
        model = jax_resnet.ResNet50(num_classes=10, dtype=jnp.float64)
        f64 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float64), tree)  # noqa: E731
        stats64 = f64(stats)
        tx = optax.sgd(0.1, momentum=0.9)

        def loss_fn(p):
            logits, mutated = model.apply({'params': p, 'batch_stats': stats64},
                                          x_train.astype(np.float64), train=True,
                                          mutable=['batch_stats'])
            loss = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
            return loss, mutated['batch_stats']

        @jax.jit
        def step(p):
            (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
            updates, _ = tx.update(grads, tx.init(p))
            return loss, new_stats, grads, optax.apply_updates(p, updates)

        loss, new_stats, grads, new_params = jax.tree.map(np.asarray, step(f64(params)))
    out.update(loss=loss, new_stats=new_stats, grads=grads, new_params=new_params)
    return out


def _port_resnet(ref, dtype):
    model = ResNet50(10, dtype=dtype)
    model.load_state_dict(resnet_params_from_flax(ref['params'], ref['stats']))
    return model


@pytest.mark.parametrize('dtype_name', ['float32', 'bfloat16'])
@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_resnet50_logits_match_flax(flax_resnet, mode, dtype_name):
    model = _port_resnet(flax_resnet, DTYPES[dtype_name][1])
    model.train(mode == 'train')
    with torch.no_grad():
        got = model(torch.tensor(flax_resnet['x_' + mode]))
    want = flax_resnet[mode, dtype_name]
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 10)
    _close(got.numpy(), want, dtype_name)
    if mode == 'train':
        want_stats = resnet_params_from_flax(flax_resnet['params'],
                                             flax_resnet['train_stats', dtype_name])
        for name, value in model.state_dict().items():
            if 'running' in name:
                _close(value.numpy(), want_stats[name].numpy(), dtype_name, err_msg=name)


def test_resnet50_sgd_step_matches_optax(flax_resnet):
    """One train-mode SGD(momentum 0.9) step in fp32 against the float64
    reference: the loss, every gradient, the parameters after the step and
    the running statistics."""
    ref = flax_resnet
    model = _port_resnet(ref, torch.float32).train()
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    loss = F.cross_entropy(model(torch.tensor(ref['x_train'])),
                           torch.tensor(ref['labels']).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref['loss']), atol=ATOL, rtol=0)
    named = dict(model.named_parameters())
    want_grads = resnet_params_from_flax(ref['grads'])
    assert set(want_grads) == set(named)
    for name, want in want_grads.items():
        np.testing.assert_allclose(named[name].grad.numpy(), want.numpy(), rtol=0,
                                   atol=1e-3 * float(want.abs().max()), err_msg=name)
    opt.step()
    want_state = resnet_params_from_flax(ref['new_params'], ref['new_stats'])
    state = model.state_dict()
    assert set(want_state) == set(state)
    for name, want in want_state.items():
        np.testing.assert_allclose(state[name].numpy(), want.numpy(), atol=ATOL, rtol=0,
                                   err_msg=name)


def test_resnet50_layout_and_initial_weights():
    """The flax model's layer count, initial BN values (the blocks' last
    scale zeros) and lecun-normal conv kernels; NHWC input only."""
    model = ResNet50(10, generator=torch.Generator().manual_seed(0))
    assert len(model.blocks) == 16
    assert [b.projection for b in model.blocks].count(True) == 4
    assert sum(p.numel() for p in ResNet50().parameters()) == 25_557_032
    for block in model.blocks:
        assert not block.bn2.scale.any() and block.bn0.scale.eq(1).all()
    std = float(model.blocks[5].conv1.weight.detach().std())
    assert abs(std - (9 * 128) ** -0.5) < 0.05 * (9 * 128) ** -0.5
    with pytest.raises(ValueError):
        model(torch.zeros(1, 3, 32, 32))


def _conditioning_report():
    """Print the numbers behind this file's sizes and references, on the
    CPU: how far flax's own train-mode logits move when the input is scaled
    by (1 + 1e-6), and how far the port's are from flax's, at 32x32 and
    64x64 (batch 2); how far XLA's and the port's fp32 gradients are from
    flax's float64 ones (of each tensor's largest magnitude); and bf16
    against fp32 logits at 224x224 (batch 8) for both frameworks."""
    ref = flax_resnet.__wrapped__()
    model = jax_resnet.ResNet50(num_classes=10, dtype=jnp.float32)
    apply = jax.jit(lambda p, s, x: model.apply({'params': p, 'batch_stats': s}, x,
                                                train=True, mutable=['batch_stats'])[0])
    port = _port_resnet(ref, torch.float32).train()
    for hw in (32, 64):
        x = np.random.default_rng(8).uniform(-2, 2, (2, hw, hw, 3)).astype(np.float32)
        want = np.asarray(apply(ref['params'], ref['stats'], x))
        moved = np.asarray(apply(ref['params'], ref['stats'], x * np.float32(1 + 1e-6)))
        with torch.no_grad():
            got = port(torch.tensor(x)).numpy()
        print('train mode %dx%d: flax moves %.3g under (1 + 1e-6) x; port vs flax %.3g; '
              'largest logit %.3g' % (hw, hw, np.abs(moved - want).max(),
                                      np.abs(got - want).max(), np.abs(want).max()))
    want = resnet_params_from_flax(ref['grads'])
    model32 = jax_resnet.ResNet50(num_classes=10, dtype=jnp.float32)

    def loss32(p):
        logits, _ = model32.apply({'params': p, 'batch_stats': ref['stats']}, ref['x_train'],
                                  train=True, mutable=['batch_stats'])
        return optax.softmax_cross_entropy_with_integer_labels(logits, ref['labels']).mean()

    xla = resnet_params_from_flax(jax.tree.map(np.asarray, jax.jit(jax.grad(loss32))(
        ref['params'])))
    port = _port_resnet(ref, torch.float32).train()
    F.cross_entropy(port(torch.tensor(ref['x_train'])),
                    torch.tensor(ref['labels']).long()).backward()
    named = dict(port.named_parameters())
    share = lambda got, name: float((got - want[name]).abs().max() / want[name].abs().max())  # noqa: E731
    print('fp32 gradients against float64, largest share of a tensor\'s largest magnitude: '
          'XLA %.3g, port %.3g' % (max(share(xla[k], k) for k in want),
                                   max(share(named[k].grad, k) for k in want)))
    x = np.random.default_rng(8).uniform(-2, 2, (8, 224, 224, 3)).astype(np.float32)
    logits = {}
    for name, (jdt, tdt) in DTYPES.items():
        model = jax_resnet.ResNet50(num_classes=10, dtype=jdt)
        logits['flax', name] = np.asarray(jax.jit(lambda p, s, x: model.apply(
            {'params': p, 'batch_stats': s}, x, train=True, mutable=['batch_stats'])[0])(
                ref['params'], ref['stats'], x))
        with torch.no_grad():
            logits['port', name] = _port_resnet(ref, tdt).train()(torch.tensor(x)).numpy()
    for side in ('flax', 'port'):
        print('224x224 train mode, %s bf16 against fp32: %.3g of the largest logit'
              % (side, np.abs(logits[side, 'bfloat16'] - logits[side, 'float32']).max()
                 / np.abs(logits[side, 'float32']).max()))


if __name__ == '__main__':
    _conditioning_report()
