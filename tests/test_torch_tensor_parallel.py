"""Tensor parallelism and FSDP of the port at 4 ranks, ``{'data': 2,
'model': 2}``, against the JAX package's rules and models.

Four spawned ranks of a gloo group (``tests/torch_dist_ranks.py``) place
port models carried from flax parameters (``convert``) with the port's
``param_shardings`` and ``fsdp_shardings`` and run them on their data rows;
the JAX side runs in this process on the virtual CPU devices
(``tests/conftest.py``), rank ``r`` at the mesh coordinate of JAX's device
``r``.  These are the counterparts of ``test_transformer.py``'s
``test_tensor_parallel_matches_dense``, ``test_param_shardings_cover_tree``,
``test_gqa_tp_sharding`` and ``test_mqa_sharding_falls_back_to_replication``,
``test_vit.py``'s ``test_tp_sharding_step`` and ``test_fsdp_composition``,
every test of ``test_fsdp.py`` and ``test_decoding.py``'s
``test_generate_with_tp_sharded_params``.

Tolerances (fp32): logits within JAX's own 2e-4 of the dense model's;
gradients within 1e-4 of each tensor's largest magnitude of JAX's (the
sums over ranks add in another order); specs, stored blocks and generated
tokens exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from petastorm_tpu.models.decoding import generate as jax_generate
from petastorm_tpu.models.transformer import TransformerLM as JaxLM
from petastorm_tpu.models.transformer import make_attn_fn as jax_make_attn_fn
from petastorm_tpu.models.transformer import megatron_spec_fn as jax_megatron_spec_fn
from petastorm_tpu.models.transformer import param_shardings as jax_param_shardings
from petastorm_tpu.models.vit import ViT as JaxViT
from petastorm_tpu.parallel import fsdp_shardings as jax_fsdp_shardings
from petastorm_tpu.parallel import fsdp_size_report as jax_fsdp_size_report
from petastorm_tpu.parallel import make_mesh as jax_make_mesh

from petastorm_tpu_torch.convert import (flax_leaves, transformer_lm_params_from_flax,
                                         vit_params_from_flax)
from petastorm_tpu_torch.models.transformer import TransformerLM
from petastorm_tpu_torch.models.vit import ViT

from torch_dist_ranks import run_ranks

WORLD = 4
LOGITS_TOL = 2e-4
GRAD_SHARE = 1e-4
VOCAB, D_MODEL, HEADS, LAYERS, D_FF, SEQ = 64, 32, 4, 2, 64, 32
LM = dict(vocab_size=VOCAB, d_model=D_MODEL, num_heads=HEADS, num_layers=LAYERS, d_ff=D_FF,
          max_seq_len=SEQ)
GQA = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=1, d_ff=64, max_seq_len=16)
VIT = dict(num_classes=4, patch_size=8, d_model=32, num_heads=2, num_layers=2, d_ff=64)
VIT_WIDE = dict(VIT, d_model=64, d_ff=128)
#: name -> (kind, config, rule)
CASES = {'tp': ('lm', LM, 'tp'),
         'tp_fsdp': ('lm', LM, 'tp_fsdp'),
         'gqa': ('lm', dict(GQA, num_kv_heads=2), 'tp'),
         'mqa': ('lm', dict(GQA, num_kv_heads=1), 'tp'),
         'vit_tp': ('vit', VIT, 'tp'),
         'vit_fsdp': ('vit', VIT_WIDE, 'tp_fsdp')}
GEN = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, d_ff=64, max_seq_len=32)


def _jax_mesh():
    return Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2), ('data', 'model'))


def _jax_model(kind, config):
    # the dense reference attention: what the placed port model's logits
    # are held against (the port runs its flash kernels' plain version)
    attn = jax_make_attn_fn(strategy='dense')
    if kind == 'vit':
        return JaxViT(**config, dtype=jnp.float32, attn_fn=attn)
    return JaxLM(**config, dtype=jnp.float32, attn_fn=attn)


def _fsdp_params():
    return {'dense': {'kernel': np.zeros((512, 256), np.float32),
                      'bias': np.zeros((256,), np.float32)},
            'embed': {'table': np.zeros((1024, 128), np.float32)},
            'norm': {'scale': np.ones((256,), np.float32)}}


def _case(name):
    """The flax model, its params, inputs, labels, logits and the gradient
    of the mean cross entropy, as numpy."""
    kind, config, rule = CASES[name]
    model = _jax_model(kind, config)
    rng = np.random.default_rng(len(config) + (7 if kind == 'vit' else 0))
    if kind == 'vit':
        inputs = rng.uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
        labels = rng.integers(0, config['num_classes'], (8,)).astype(np.int32)
    else:
        seq = config['max_seq_len']
        inputs = rng.integers(0, config['vocab_size'], (4, seq)).astype(np.int32)
        labels = np.roll(inputs, -1, axis=1)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), inputs[:1])['params']

    def loss_fn(p):
        logits = model.apply({'params': p}, inputs)
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

    logits = jax.jit(model.apply)({'params': params}, inputs)
    grads = jax.jit(jax.grad(loss_fn))(params)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return dict(kind=kind, config=config, rule=rule, model=model, params=to_np(params),
                inputs=inputs, labels=labels, logits=np.asarray(logits), grads=to_np(grads))


@pytest.fixture(scope='module')
def cases():
    """Each case; cases of one model and config share its flax run."""
    out, runs = {}, {}
    for name, (kind, config, rule) in CASES.items():
        key = (kind, tuple(sorted(config.items())))
        if key not in runs:
            runs[key] = _case(name)
        out[name] = dict(runs[key], rule=rule)
    return out


@pytest.fixture(scope='module')
def generation():
    model = JaxLM(**GEN, dtype=jnp.float32, attn_fn=jax_make_attn_fn(strategy='dense'))
    params = jax.jit(model.init)(jax.random.PRNGKey(7), jnp.zeros((1, 8), jnp.int32))['params']
    prompt = np.random.default_rng(5).integers(0, 64, (2, 5)).astype(np.int32)
    ref = np.asarray(jax_generate(model, params, jnp.asarray(prompt), 6))
    return dict(params=jax.tree.map(np.asarray, params), prompt=prompt, ref=ref)


def _state(case):
    convert = vit_params_from_flax if case['kind'] == 'vit' else transformer_lm_params_from_flax
    return {k: v.numpy() for k, v in convert(case['params']).items()}


@pytest.fixture(scope='module')
def ranks(tmp_path_factory, cases, generation):
    payload = dict(
        cases=[dict(name=name, kind=c['kind'], config=c['config'], rule=c['rule'],
                    state=_state(c), inputs=c['inputs'], labels=c['labels'])
               for name, c in cases.items()],
        fsdp_tree=_fsdp_params(),
        generate=dict(config=GEN, new=6, prompt=generation['prompt'],
                      state={k: v.numpy() for k, v in
                             transformer_lm_params_from_flax(generation['params']).items()}))
    return run_ranks(tmp_path_factory.mktemp('tp_ranks'), WORLD, 'tensor_parallel_cases',
                     payload)


def _jax_shardings(case):
    mesh = _jax_mesh()
    if case['rule'] == 'tp':
        return jax_param_shardings(case['params'], mesh)
    return jax_fsdp_shardings(case['params'], mesh, min_shard_elements=256,
                              base_spec_fn=jax_megatron_spec_fn())


def _by_path(tree):
    return {tuple(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _port_model(case):
    if case['kind'] == 'vit':
        return ViT(**case['config'], image_hw=(32, 32), compute_dtype=torch.float32)
    return TransformerLM(**case['config'], compute_dtype=torch.float32)


@pytest.mark.parametrize('name', sorted(CASES))
def test_every_spec_equals_jax_by_flax_path(ranks, cases, name):
    """param_shardings (and FSDP composed with the Megatron rules) give
    every parameter of the port JAX's spec for its flax leaf; the leaves
    cover the flax tree."""
    case = cases[name]
    want = {path: tuple(s.spec) for path, s in _by_path(_jax_shardings(case)).items()}
    for result in ranks:
        got = result[name]['specs']
        assert sorted(path for path, _ in got.values()) == sorted(want)
        for param, (path, spec) in got.items():
            assert spec == want[path], (param, path)


def test_megatron_rules_shard_what_jax_shards(ranks):
    specs = {path: spec for path, spec in ranks[0]['tp']['specs'].values()}
    assert specs[('embed', 'embedding')] == ('model', None)
    assert specs[('block_0', 'attn', 'qkv', 'kernel')] == (None, None, 'model', None)
    assert specs[('block_1', 'ffw_in', 'kernel')] == (None, 'model')
    assert all(spec == () for path, spec in specs.items() if path[-2].startswith('ln'))
    gqa = {path: spec for path, spec in ranks[0]['gqa']['specs'].values()}
    assert gqa[('block_0', 'attn', 'q', 'kernel')] == (None, 'model', None)
    assert gqa[('block_0', 'attn', 'kv', 'kernel')] == (None, None, 'model', None)
    mqa = {path: spec for path, spec in ranks[0]['mqa']['specs'].values()}
    assert mqa[('block_0', 'attn', 'kv', 'kernel')] == ()          # replicated fallback
    assert mqa[('block_0', 'attn', 'q', 'kernel')] == (None, 'model', None)
    vit = {path: spec for path, spec in ranks[0]['vit_tp']['specs'].values()}
    assert any('qkv' in path and spec != () for path, spec in vit.items())


@pytest.mark.parametrize('name', sorted(CASES))
def test_each_rank_stores_convert_of_its_jax_shard(ranks, cases, name):
    """Each rank's block of each parameter is convert's image of the shard
    JAX places on the device at its mesh coordinate, and no more."""
    case = cases[name]
    shardings = _jax_shardings(case)
    placed = jax.device_put(case['params'], shardings)
    shards = {path: {s.device: np.asarray(s.data) for s in leaf.addressable_shards}
              for path, leaf in _by_path(placed).items()}
    leaves = flax_leaves(_port_model(case))
    convert = vit_params_from_flax if case['kind'] == 'vit' else transformer_lm_params_from_flax
    whole = convert(case['params'])
    for name_, leaf in leaves.items():        # the layout map is convert's
        np.testing.assert_array_equal(
            leaf.to_torch(torch.tensor(_by_path(case['params'])[leaf.path])),
            whole[name_].numpy())
    for rank, result in enumerate(ranks):
        device = jax.devices()[rank]
        for param, block in result[name]['blocks'].items():
            leaf = leaves[param]
            want = leaf.to_torch(torch.tensor(shards[leaf.path][device])).numpy()
            np.testing.assert_array_equal(block, want, err_msg='%s rank %d' % (param, rank))


@pytest.mark.parametrize('name', sorted(CASES))
def test_placed_logits_match_dense(ranks, cases, name):
    """The placed model's logits on each rank's data rows against the dense
    flax model's within JAX's 2e-4 (and the unplaced port model's)."""
    case = cases[name]
    for result in ranks:
        start, stop = result[name]['rows']
        np.testing.assert_allclose(result[name]['logits'], case['logits'][start:stop],
                                   atol=LOGITS_TOL, rtol=LOGITS_TOL)
        assert result[name]['unplaced_max_err'] < LOGITS_TOL


@pytest.mark.parametrize('name', sorted(CASES))
def test_placed_gradients_are_shards_of_jax_gradients(ranks, cases, name):
    """A train step's gradients (the global mean loss, summed over the data
    axis by reduce_gradients, FSDP blocks by their gather's backward): each
    rank's gradient block is convert's image of its shard of JAX's."""
    import torch
    case = cases[name]
    mesh = _jax_mesh()
    specs = {path: s.spec for path, s in _by_path(_jax_shardings(case)).items()}
    grads = _by_path(case['grads'])
    leaves = flax_leaves(_port_model(case))
    for rank, result in enumerate(ranks):
        device = jax.devices()[rank]
        for param, got in result[name]['grads'].items():
            leaf = leaves[param]
            full = grads[leaf.path]
            index = NamedSharding(mesh, specs[leaf.path]).addressable_devices_indices_map(
                full.shape)[device]
            want = leaf.to_torch(torch.tensor(full[index])).numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=GRAD_SHARE * max(float(np.abs(full).max()), 1e-12),
                                       err_msg='%s rank %d' % (param, rank))


@pytest.mark.parametrize('name', ['tp_fsdp', 'vit_fsdp'])
def test_a_rank_stores_per_device_mb(ranks, cases, name):
    """fsdp_size_report is JAX's, and its per_device_mb is what each rank
    stores."""
    case = cases[name]
    want = jax_fsdp_size_report(case['params'], _jax_shardings(case))
    for result in ranks:
        assert result[name]['report'] == want
        assert round(result[name]['stored_bytes'] / 2 ** 20, 3) == want['per_device_mb']
    assert want['sharded_fraction'] > 0.5


def test_fsdp_rules_on_a_tree_match_jax(ranks):
    """test_fsdp.py's cases: large leaves shard over data and small ones
    stay replicated, a base spec composes, a base spec that spends the data
    axis passes through, indivisible dims stay on the base, and the missing
    axis refuses with JAX's text."""
    mesh = jax_make_mesh({'data': 2, 'model': 2}, devices=jax.devices()[:WORLD])
    params = _fsdp_params()

    def specs(tree):
        return jax.tree.map(lambda s: tuple(s.spec), tree,
                            is_leaf=lambda s: isinstance(s, NamedSharding))

    def base(path):
        return P(None, 'model') if path[-1].key == 'kernel' else P()

    want = dict(default=specs(jax_fsdp_shardings(params, mesh)),
                composed=specs(jax_fsdp_shardings(params, mesh, base_spec_fn=base)),
                base_data=specs(jax_fsdp_shardings(params, mesh,
                                                   base_spec_fn=lambda path: P('data'))),
                indivisible=specs(jax_fsdp_shardings({'odd': np.zeros((17, 33), np.float32)},
                                                     mesh, min_shard_elements=1)))
    with pytest.raises(ValueError) as info:
        jax_fsdp_shardings(params, mesh, data_axis='nope')
    for result in ranks:
        tree = result['fsdp_tree']
        for key in want:
            assert tree[key] == want[key], key
        assert tree['default']['dense']['kernel'] == ('data',)
        assert tree['default']['dense']['bias'] == ()
        assert tree['composed']['dense']['kernel'] == ('data', 'model')
        assert tree['indivisible']['odd'] == ()
        assert tree['missing'] == str(info.value)


def test_fsdp_placed_tree_computes_and_reports(ranks):
    """Blocks of the placed tree are the data-axis shards, a product through
    the gathered kernel is the replicated one, and the size report is
    JAX's and what a rank stores."""
    mesh = jax_make_mesh({'data': 2, 'model': 2}, devices=jax.devices()[:WORLD])
    params = _fsdp_params()
    want = jax_fsdp_size_report(params, jax_fsdp_shardings(params, mesh))
    for result in ranks:
        tree = result['fsdp_tree']
        assert tree['kernel_block'] == (256, 256)
        np.testing.assert_array_equal(tree['product'], np.zeros((8, 256)))
        assert tree['report'] == want
        assert round(tree['stored_bytes'] / 2 ** 20, 3) == want['per_device_mb']
        assert want['per_device_mb'] < want['total_mb'] / 1.5


def test_generate_with_tp_placed_params_is_token_identical(ranks, generation):
    for result in ranks:
        np.testing.assert_array_equal(result['generate'], generation['ref'])
        assert result['cache_heads'] == GEN['num_heads'] // 2     # this rank's kv heads
