"""Ring and Ulysses attention of the port at 2 ranks against the JAX package's.

Two spawned ranks of a gloo group (``tests/torch_dist_ranks.py``) run
``petastorm_tpu_torch.parallel`` on their blocks of the same inputs (made
with numpy from a seed) that the JAX functions take whole on two of the
8 virtual CPU devices (``tests/conftest.py``), with JAX's flash kernel in
interpret mode.  Each rank's output and q/k/v gradients (of ``sum(out *
ct)``) must equal the JAX result's block at that rank's mesh position, at
the reference's tolerances (``tests/test_parallel_attention.py``): 2e-5
forward, 1e-4 gradients, 2e-4 and 2e-3 chunked.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from petastorm_tpu.ops import flash_attention as jax_flash_attention
from petastorm_tpu.parallel.ring_attention import make_ring_attention, make_ulysses_attention

from torch_dist_ranks import run_ranks

B, S, H, D = 2, 64, 4, 8

#: name -> case; meshes are ordered {'data': n, 'seq': m}.
CASES = {}
for _causal in (False, True):
    _c = 'causal' if _causal else 'full'
    CASES['ring %s' % _c] = dict(kind='ring', causal=_causal, packed=False)
    CASES['ring %s block_k 24' % _c] = dict(kind='ring', causal=_causal, packed=False,
                                            block_k=24)
    CASES['ring %s packed' % _c] = dict(kind='ring', causal=_causal, packed=True)
    CASES['ulysses %s' % _c] = dict(kind='ulysses', causal=_causal, packed=False)
    CASES['ulysses %s packed flash' % _c] = dict(kind='ulysses', causal=_causal, packed=True,
                                                 attn='flash')
CASES['ring causal packed block_k 12'] = dict(kind='ring', causal=True, packed=True, block_k=12)
CASES['ulysses causal flash'] = dict(kind='ulysses', causal=True, packed=False, attn='flash')
CASES['ring causal seq axis 1'] = dict(kind='ring', causal=True, packed=False,
                                       mesh={'data': 2, 'seq': 1})
CASES['ulysses causal seq axis 1'] = dict(kind='ulysses', causal=True, packed=False,
                                          mesh={'data': 2, 'seq': 1})
for _name, _case in CASES.items():
    _case.update(name=_name)
    _case.setdefault('mesh', {'data': 1, 'seq': 2})


def _inputs():
    rng = np.random.default_rng(11)
    arrays = {n: rng.standard_normal((B, S, H, D)).astype(np.float32) for n in ('q', 'k', 'v',
                                                                               'ct')}
    seg = np.zeros((B, S), np.int32)
    seg[0, :20], seg[0, 20:50], seg[0, 50:] = 1, 2, 0        # a segment across the split
    seg[1, :33], seg[1, 33:] = 3, 4
    arrays['seg'] = seg
    return arrays


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    payload = dict(_inputs(), cases=list(CASES.values()))
    return run_ranks(tmp_path_factory.mktemp('attention_ranks'), 2, 'attention_cases', payload)


def _jax_case(case, arrays):
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(case['mesh']['data'],
                                                    case['mesh']['seq']), ('data', 'seq'))
    if case['kind'] == 'ring':
        fn, _ = make_ring_attention(mesh, causal=case['causal'], block_k=case.get('block_k'),
                                    packed=case['packed'])
    else:
        fn, _ = make_ulysses_attention(
            mesh, causal=case['causal'], packed=case['packed'],
            attn_fn=jax_flash_attention if case.get('attn') == 'flash' else None)
    seg = jnp.asarray(arrays['seg'])

    def loss(q, k, v):
        out = fn(q, k, v, seg) if case['packed'] else fn(q, k, v)
        return jnp.sum(out * arrays['ct']), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(arrays[n]) for n in 'qkv'))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _tolerances(case):
    if case.get('block_k'):
        return 2e-4, 2e-3
    return 2e-5, 1e-4


@pytest.mark.parametrize('name', list(CASES))
def test_each_rank_holds_the_jax_block(ranks, name):
    case = CASES[name]
    arrays = _inputs()
    want_out, want_grads = _jax_case(case, arrays)
    fwd_tol, grad_tol = _tolerances(case)
    seen = set()
    for rank, result in enumerate(ranks):
        got = result['cases'][name]
        index = got['index']
        seen.add(tuple((s.start, s.stop) for s in index))
        np.testing.assert_allclose(got['out'], want_out[index], rtol=fwd_tol, atol=fwd_tol,
                                   err_msg='rank %d out' % rank)
        for g, want in zip(('dq', 'dk', 'dv'), want_grads):
            np.testing.assert_allclose(got[g], want[index], rtol=grad_tol, atol=grad_tol,
                                       err_msg='rank %d %s' % (rank, g))
    assert len(seen) == 2     # the two ranks hold the two blocks


def _jax_error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_refusals_carry_the_reference_texts(ranks):
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ('data', 'seq'))
    q3 = jnp.zeros((1, 8, 3, 8))
    want = {
        'ulysses_heads': _jax_error(lambda: make_ulysses_attention(mesh)[0](q3, q3, q3)),
        'block_k': _jax_error(lambda: make_ring_attention(mesh, block_k=0)[0](q3, q3, q3)),
    }
    for result in ranks:
        got = result['refusals']
        assert got['ulysses_heads'] == want['ulysses_heads']
        assert got['block_k'] == want['block_k']
        assert 'built with causal=True but called with causal=False' in got['curried_causal']
        assert got['ring_causal_ok'] == (1, 4, 3, 8)
