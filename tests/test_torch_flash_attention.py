"""The port's flash attention (CPU path: each kernel's plain version under the
port's autograd Function) against ``petastorm_tpu.ops.flash_attention``
(its Pallas kernels in interpret mode, as the JAX suite runs them).

Inputs are made with numpy from a seed and fed to both.  Tolerances are the
JAX suite's own (tests/test_flash_attention.py): fp32 forward 2e-5, fp32
gradients 1e-4 (3e-5 for the packed and chunked cases), bf16 3e-2.  The two
sides sum in different orders (dense plain version vs blocked online
softmax), so equality is not expected.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from petastorm_tpu.ops import flash_attention as jax_flash
from petastorm_tpu.parallel import full_attention as jax_full

from petastorm_tpu_torch.ops import flash_attention, full_attention

fa = importlib.import_module('petastorm_tpu_torch.ops.flash_attention')


def _inputs(seed, b=2, s=64, h=2, d=16, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(n)]


def _segments(seed, b, s, max_segs=4):
    """Contiguous nonzero segments with a zero-padded tail (the JAX suite's
    generator)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((b, s), np.int32)
    for r in range(b):
        off = 0
        for seg in range(1, max_segs + 1):
            length = int(rng.integers(1, max(2, s // max_segs)))
            if off + length > s - 2:
                break
            out[r, off:off + length] = seg
            off += length
    return out


def _port(q, k, v, dout=None, **kw):
    """Port output (and input gradients under cotangent ``dout``) as numpy."""
    seg = kw.pop('segment_ids', None)
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = flash_attention(*ts, segment_ids=None if seg is None else torch.tensor(seg), **kw)
    if dout is None:
        return out.detach().float().numpy()
    (out.float() * torch.tensor(dout)).sum().backward()
    return out.detach().float().numpy(), [t.grad.numpy() for t in ts]


def _jax(q, k, v, dout=None, **kw):
    seg = kw.pop('segment_ids', None)
    if seg is not None:
        kw['segment_ids'] = jnp.asarray(seg)
    args = tuple(jnp.asarray(x) for x in (q, k, v))
    out = np.asarray(jax_flash(*args, **kw).astype(jnp.float32))
    if dout is None:
        return out
    grads = jax.grad(lambda t: (jax_flash(*t, **kw) * jnp.asarray(dout)).sum())(args)
    return out, [np.asarray(g) for g in grads]


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('seq', [24, 64, 100])
def test_forward_matches_jax(causal, seq):
    q, k, v = _inputs(1, s=seq)
    want = _jax(q, k, v, causal=causal, block_q=32, block_k=32)
    got = _port(q, k, v, causal=causal, block_q=32, block_k=32)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('seq', [40, 100])
def test_gradients_match_jax(causal, seq):
    q, k, v, dout = _inputs(2, b=1, s=seq, d=8, n=4)
    want, want_g = _jax(q, k, v, dout, causal=causal, block_q=32, block_k=32)
    got, got_g = _port(q, k, v, dout, causal=causal, block_q=32, block_k=32)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    for g, w, name in zip(got_g, want_g, 'qkv'):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg='d%s' % name)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('seq', [52, 64])
def test_segments_match_jax(causal, seq):
    q, k, v, dout = _inputs(3, s=seq, h=1, n=4)
    seg = _segments(4, 2, seq)
    want, want_g = _jax(q, k, v, dout, causal=causal, block_q=32, block_k=32,
                        segment_ids=seg)
    got, got_g = _port(q, k, v, dout, causal=causal, segment_ids=seg)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    for g, w, name in zip(got_g, want_g, 'qkv'):
        np.testing.assert_allclose(g, w, atol=3e-5, rtol=3e-5, err_msg='d%s' % name)
    # padding rows (segment 0) output exactly zero on both sides
    pad = seg == 0
    assert np.abs(got[pad]).max() == 0.0 and np.abs(want[pad]).max() == 0.0


@pytest.mark.parametrize('causal', [False, True])
def test_kv_chunk_matches_jax_chunked(causal):
    """The JAX side streams K/V in 32-row chunks (its VMEM fold); the port
    accepts kv_chunk and gives the unchunked result."""
    q, k, v, dout = _inputs(5, b=1, s=64, h=1, n=4)
    seg = np.zeros((1, 64), np.int32)
    seg[:, :24] = 1
    seg[:, 24:56] = 2
    kw = dict(causal=causal, block_q=32, block_k=32, kv_chunk=32, segment_ids=seg)
    want, want_g = _jax(q, k, v, dout, **dict(kw))
    got, got_g = _port(q, k, v, dout, **dict(kw))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, atol=3e-5, rtol=3e-5)


def test_block_sizes_and_kv_chunk_do_not_change_the_result():
    q, k, v = _inputs(6, s=100)
    base = _port(q, k, v, causal=True)
    for kw in (dict(block_q=16, block_k=48), dict(block_q=128, block_k=32, kv_chunk=32),
               dict(kv_chunk=0), dict(kv_chunk=50)):
        np.testing.assert_array_equal(_port(q, k, v, causal=True, **kw), base)


def test_bfloat16_matches_jax():
    q, k, v = (x.astype(jnp.bfloat16) for x in _inputs(7))
    want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), causal=True, block_q=32,
                                block_k=32).astype(jnp.float32))
    ts = [torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16) for x in (q, k, v)]
    got = flash_attention(*ts, causal=True)
    assert got.dtype == torch.bfloat16
    oracle = np.asarray(jax_full(*(jnp.asarray(x, jnp.float32) for x in (q, k, v)),
                                 causal=True))
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(got.float().numpy(), oracle, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize('causal', [False, True])
def test_full_attention_matches_jax_reference(causal):
    q, k, v = _inputs(8, s=52)
    seg = _segments(9, 2, 52)
    want = np.asarray(jax_full(*map(jnp.asarray, (q, k, v)), causal=causal,
                               segment_ids=jnp.asarray(seg)))
    got = full_attention(*map(torch.tensor, (q, k, v)), causal=causal,
                         segment_ids=torch.tensor(seg)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_forward_plain_lse_is_the_log_sum_exp():
    """flash_fwd on CPU tensors is its plain version: lse = logsumexp of the
    scaled, masked scores, NEG_INF on fully masked rows."""
    q, k, v = (torch.tensor(x) for x in _inputs(10, s=20))
    seg = torch.tensor(_segments(11, 2, 20))
    o, lse = fa.flash_fwd(q, k, v, seg, True, 0.25)
    assert o.dtype == torch.float32 and lse.shape == (2 * 2, 20)
    scores = torch.einsum('bqhd,bkhd->bhqk', q, k) * 0.25
    keep = torch.tril(torch.ones(20, 20, dtype=torch.bool)) \
        & (seg[:, :, None] == seg[:, None, :])[:, None] & (seg != 0)[:, None, :, None]
    keep = keep.expand(2, 2, 20, 20)
    want = torch.logsumexp(scores.masked_fill(~keep, float('-inf')), dim=-1).reshape(4, 20)
    dead = ~keep.any(-1).reshape(4, 20)
    np.testing.assert_allclose(lse[~dead].numpy(), want[~dead].numpy(), atol=2e-5, rtol=2e-5)
    assert (lse[dead] == fa.NEG_INF).all() and dead.any()
    assert fa.flash_fwd.launches == 0   # the CPU path launches nothing


def test_rejects_bad_arguments():
    q, k, v = (torch.tensor(x) for x in _inputs(12, s=32))
    with pytest.raises(ValueError):
        flash_attention(q, k, v, segment_ids=torch.zeros(2, 16, dtype=torch.int32))
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :16], v[:, :16])
    with pytest.raises(ValueError):
        flash_attention(q, k, v, kv_chunk=-1)
    with pytest.raises(ValueError):
        flash_attention(q[0], k[0], v[0])


@pytest.mark.parametrize('causal,segments', [(False, False), (True, False), (True, True)])
def test_head_dim_256_matches_jax(causal, segments):
    """head_dim 256, the widest tile of the kernels' CUDA-core design: the
    forward and the gradients in fp32 at the JAX suite's fp32 tolerances
    (the packed case's 3e-5 for gradients with segments)."""
    q, k, v, dout = _inputs(13, b=1, s=40, h=2, d=256, n=4)
    kw = dict(causal=causal, block_q=32, block_k=32)
    if segments:
        kw['segment_ids'] = _segments(14, 1, 40)
    want, want_g = _jax(q, k, v, dout, **dict(kw))
    got, got_g = _port(q, k, v, dout, **dict(kw))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    grad_tol = 3e-5 if segments else 1e-4
    for g, w, name in zip(got_g, want_g, 'qkv'):
        np.testing.assert_allclose(g, w, atol=grad_tol, rtol=grad_tol, err_msg='d%s' % name)


#: float16 against the JAX kernels in float16: two fp16 ulps (2 * 2**-10)
#: relative, both sides computing in f32 and rounding once to fp16, which
#: may land on either side of a value's rounding boundary.
FP16_TOL = 2e-3


@pytest.mark.parametrize('d', [64, 256])
@pytest.mark.parametrize('causal', [False, True])
def test_float16_matches_jax(d, causal):
    q, k, v, dout = (x.astype(np.float16) for x in _inputs(15, b=1, s=48, h=2, d=d, n=4))
    kw = dict(causal=causal, block_q=32, block_k=32)
    want, want_g = _jax(q, k, v, dout, **dict(kw))
    got, got_g = _port(q, k, v, dout, **dict(kw))
    np.testing.assert_allclose(got, want, atol=FP16_TOL, rtol=FP16_TOL)
    for g, w, name in zip(got_g, want_g, 'qkv'):
        assert g.dtype == np.float16
        np.testing.assert_allclose(g.astype(np.float32), np.asarray(w, np.float32),
                                   atol=FP16_TOL, rtol=FP16_TOL, err_msg='d%s' % name)
