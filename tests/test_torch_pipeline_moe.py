"""The port's GPipe pipeline and expert-parallel MoE at 4 ranks against the
JAX package's.

Four spawned ranks of a gloo group (``tests/torch_dist_ranks.py``) run
``parallel.make_pipeline`` over ``{'pipe': 4}`` and
``models.moe.make_expert_parallel_moe`` over three meshes; the JAX side
runs in this process on the virtual CPU devices (``tests/conftest.py``).
These are the counterparts of ``test_pipeline.py`` and ``test_moe.py``.

Tolerances (fp32), JAX's own: pipeline outputs 1e-5 and gradients 1e-4;
MoE outputs 1e-5 and gradients 5e-4; the pipeline's Adam losses within
1e-4 (relative) of optax's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from petastorm_tpu.models.moe import make_expert_parallel_moe as jax_ep_moe
from petastorm_tpu.models.moe import moe_apply as jax_moe_apply
from petastorm_tpu.models.moe import moe_init as jax_moe_init
from petastorm_tpu.parallel import make_pipeline as jax_make_pipeline

from petastorm_tpu_torch.convert import moe_params_from_flax
from petastorm_tpu_torch.models.moe import moe_apply, moe_init

from torch_dist_ranks import run_ranks

WORLD = 4
N_STAGES, N_MICRO, MB, DIM = WORLD, 6, 8, 16
TRAIN_STEPS = 8
D, F, E = 16, 32, 8
#: label -> (mesh axes, capacity factor, gradients too)
MOE_CASES = {'data2_expert2': ({'data': 2, 'expert': 2}, float(E), True),
             'expert4': ({'data': 1, 'expert': 4}, float(E), False),
             'data4': ({'data': 4}, float(E), False),
             'tight': ({'data': 2, 'expert': 2}, 1.0, False)}


def _jax_mesh(axes):
    return Mesh(np.array(jax.devices()[:WORLD]).reshape(tuple(axes.values())), tuple(axes))


def _stage_fn(params, x):
    return jnp.tanh(x @ params['w'] + params['b'])


def _sequential(params, microbatches):
    out = microbatches
    for s in range(N_STAGES):
        stage = jax.tree_util.tree_map(lambda p: p[s], params)
        out = jax.vmap(lambda x: _stage_fn(stage, x))(out)
    return out


@pytest.fixture(scope='module')
def pipeline():
    rng = np.random.default_rng(1)
    params = {'w': rng.standard_normal((N_STAGES, DIM, DIM)).astype(np.float32) * 0.5,
              'b': rng.standard_normal((N_STAGES, DIM)).astype(np.float32) * 0.1}
    x = rng.standard_normal((N_MICRO, MB, DIM)).astype(np.float32)
    y = rng.standard_normal((N_MICRO, MB, DIM)).astype(np.float32) * 0.1
    mesh = _jax_mesh({'pipe': N_STAGES})
    fn, stage_sharding = jax_make_pipeline(mesh, _stage_fn)
    placed = jax.device_put(params, stage_sharding)
    out = jax.jit(fn)(placed, x)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(fn(p, x) ** 2)))(placed)
    tx = optax.adam(1e-2)

    @jax.jit
    def step(p, opt):
        loss, g = jax.value_and_grad(lambda p: jnp.mean((fn(p, x) - y) ** 2))(p)
        updates, opt = tx.update(g, opt)
        return optax.apply_updates(p, updates), opt, loss

    p, opt, losses = placed, tx.init(placed), []
    for _ in range(TRAIN_STEPS):
        p, opt, loss = step(p, opt)
        losses.append(float(loss))
    return dict(params=params, x=x, y=y, out=np.asarray(out),
                sequential=np.asarray(_sequential(params, x)),
                grads=jax.tree.map(np.asarray, grads), losses=losses)


@pytest.fixture(scope='module')
def moe():
    params = jax.tree.map(np.asarray, jax_moe_init(jax.random.PRNGKey(0), D, F, E))
    tokens = np.random.default_rng(5).standard_normal((64, D)).astype(np.float32)
    out = {'params': params, 'tokens': tokens, 'cases': {}}
    for label, (axes, factor, grads) in MOE_CASES.items():
        fn, shardings, token_sharding = jax_ep_moe(_jax_mesh(axes), E, capacity_factor=factor)
        p = jax.tree.map(jax.device_put, params, shardings(params))
        x = jax.device_put(tokens, token_sharding)
        case = {'out': np.asarray(jax.jit(fn)(p, x))}
        if grads:
            case['grads'] = jax.tree.map(np.asarray, jax.jit(jax.grad(
                lambda p, x: jnp.sum(fn(p, x) ** 2)))(p, x))
        out['cases'][label] = case
    oracle = jax.jit(lambda p: jax_moe_apply(p, tokens, capacity_factor=float(E)))
    out['oracle'] = np.asarray(oracle(params))
    out['oracle_grads'] = jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p: jnp.sum(oracle(p) ** 2)))(params))
    return out


@pytest.fixture(scope='module')
def ranks(tmp_path_factory, pipeline, moe):
    payload = dict(
        pipeline=dict(params=pipeline['params'], x=pipeline['x'], y=pipeline['y'],
                      steps=TRAIN_STEPS),
        moe=dict(params={k: v.numpy() for k, v in moe_params_from_flax(moe['params']).items()},
                 tokens=moe['tokens'], experts=E,
                 cases=[(label, tuple(axes.items()), factor, grads)
                        for label, (axes, factor, grads) in MOE_CASES.items()]))
    return run_ranks(tmp_path_factory.mktemp('pipeline_moe_ranks'), WORLD, 'pipeline_moe_cases',
                     payload)


def test_pipeline_matches_sequential_and_jax(ranks, pipeline):
    for rank, result in enumerate(ranks):
        np.testing.assert_allclose(result['pipeline']['out'], pipeline['sequential'],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(result['pipeline']['out'], pipeline['out'],
                                   atol=1e-5, rtol=1e-5)
        for key in ('w', 'b'):     # rank d keeps stage d
            np.testing.assert_array_equal(result['pipeline']['block'][key],
                                          pipeline['params'][key][rank:rank + 1])


def test_pipeline_gradients_match_jax(ranks, pipeline):
    """Each rank's stage gradients against JAX's for that stage (JAX's own
    pipeline gradients equal the sequential oracle's in test_pipeline.py)."""
    for rank, result in enumerate(ranks):
        for key in ('w', 'b'):
            np.testing.assert_allclose(result['pipeline']['grads'][key],
                                       pipeline['grads'][key][rank:rank + 1],
                                       atol=1e-4, rtol=1e-4, err_msg='%s rank %d' % (key, rank))


def test_pipeline_trains_as_jax_does(ranks, pipeline):
    for result in ranks:
        losses = result['pipeline']['losses']
        assert losses[-1] < losses[0]
        np.testing.assert_allclose(losses, pipeline['losses'], rtol=1e-4, atol=0)


def test_moe_oracle_matches_jax(moe):
    port = {k: v for k, v in moe_params_from_flax(moe['params']).items()}
    got = moe_apply(port, torch.tensor(moe['tokens']), capacity_factor=float(E))
    np.testing.assert_allclose(got.numpy(), moe['oracle'], rtol=1e-5, atol=1e-5)
    leaves = {k: v.clone().requires_grad_() for k, v in port.items()}
    (moe_apply(leaves, torch.tensor(moe['tokens']), capacity_factor=float(E)) ** 2) \
        .sum().backward()
    for key in ('router', 'w1', 'w2'):
        np.testing.assert_allclose(leaves[key].grad.numpy(), moe['oracle_grads'][key],
                                   rtol=5e-4, atol=5e-4, err_msg=key)


@pytest.mark.parametrize('label', sorted(MOE_CASES))
def test_expert_parallel_moe_matches_jax(ranks, moe, label):
    """Each rank's outputs are its token block of JAX's sharded MoE (with
    capacity per rank from its local tokens, so a tight capacity drops the
    same tokens), and, with ample capacity, of the oracle's."""
    axes, factor, _ = MOE_CASES[label]
    for result in ranks:
        case = result['moe'][label]
        rows = case['index'][0] if case['index'] else slice(None)
        np.testing.assert_allclose(case['out'], moe['cases'][label]['out'][rows],
                                   rtol=1e-5, atol=1e-5)
        if factor == float(E):
            np.testing.assert_allclose(case['out'], moe['oracle'][rows], rtol=1e-5, atol=1e-5)
    if label == 'tight':
        dropped = sum(int(np.all(r['moe'][label]['out'] == 0, axis=-1).sum()) for r in ranks)
        assert dropped > 0
        assert dropped == int(np.all(moe['cases'][label]['out'] == 0, axis=-1).sum())


def test_expert_parallel_gradients_match_jax(ranks, moe):
    want = moe['cases']['data2_expert2']['grads']
    for rank, result in enumerate(ranks):
        case = result['moe']['data2_expert2']
        for key in ('router', 'w1', 'w2'):
            index = case['param_index'][key]
            np.testing.assert_allclose(case['grads'][key], want[key][index], rtol=5e-4,
                                       atol=5e-4, err_msg='%s rank %d' % (key, rank))
            np.testing.assert_allclose(case['grads'][key], moe['oracle_grads'][key][index],
                                       rtol=5e-4, atol=5e-4, err_msg='%s rank %d' % (key, rank))


def test_capacity_drops_tokens_as_jax_does():
    """Tiny capacity: overflow tokens contribute zero, the same ones as in
    JAX, finite, and unlike the ample-capacity result."""
    params = jax.tree.map(np.asarray, jax_moe_init(jax.random.PRNGKey(1), D, F, 2))
    port = moe_params_from_flax(params)
    x = np.random.default_rng(0).standard_normal((32, D)).astype(np.float32)
    tight = moe_apply(port, torch.tensor(x), capacity_factor=0.25).numpy()
    ample = moe_apply(port, torch.tensor(x), capacity_factor=4.0).numpy()
    want = np.asarray(jax.jit(lambda p, x: jax_moe_apply(p, x, capacity_factor=0.25))(params, x))
    np.testing.assert_allclose(tight, want, rtol=1e-5, atol=1e-5)
    assert np.isfinite(tight).all()
    dropped = np.all(tight == 0, axis=-1)
    assert dropped.sum() > 0
    np.testing.assert_array_equal(dropped, np.all(want == 0, axis=-1))
    assert not np.allclose(tight, ample)


def test_indivisible_experts_rejected_with_jax_text(ranks):
    with pytest.raises(ValueError) as info:
        jax_ep_moe(_jax_mesh({'expert': WORLD}), num_experts=6)
    for result in ranks:
        assert result['indivisible'] == str(info.value)


def test_moe_init_shapes_and_scale():
    params = moe_init(D, F, E, generator=torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        'router': (D, E), 'w1': (E, D, F), 'w2': (E, F, D)}
    for key, fan_in in (('router', D), ('w1', D), ('w2', F)):
        std = float(params[key].std())
        assert abs(std - fan_in ** -0.5) < 0.15 * fan_in ** -0.5, key
