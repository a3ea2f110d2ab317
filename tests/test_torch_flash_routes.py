"""The two designs of the port's flash kernels (tensor cores, CUDA cores):
which operands take which, that every C entry point in ``csrc/`` is bound
with the right arguments, that each route reaches its launch, and that the
tensor-core kernels' rounding of P and dS to bf16 hi and lo parts stays
within the bf16 tolerance against the unchanged plain versions.

The kernels themselves run only on the card (``chip_smoke.py``); here the
routing is checked with the launch replaced by a recorder, and the numerics
by doing the kernels' arithmetic in plain PyTorch.
"""

import importlib
import importlib.util
import os
import re

import pytest
import torch

fa = importlib.import_module('petastorm_tpu_torch.ops.flash_attention')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, 'petastorm_tpu_torch', 'csrc')


def _chip_smoke_tol():
    spec = importlib.util.spec_from_file_location('chip_smoke', os.path.join(REPO, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.TOL


def _qkv(dtype, d, b=1, s=8, h=2):
    return [torch.zeros(b, s, h, d, dtype=dtype) for _ in range(3)]


def _misaligned(shape, dtype):
    """A contiguous tensor whose data starts one element past an aligned
    allocation."""
    n = 1
    for x in shape:
        n *= x
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


# ---------------------------------------------------------------------------
# the route function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('d', [16, 32, 64, 128])
def test_bf16_tile_widths_take_the_tensor_cores(d):
    assert fa.kernel_design(torch.bfloat16, d, *_qkv(torch.bfloat16, d)) == 'tensor_core'


@pytest.mark.parametrize('d', [8, 40, 72, 120])
def test_bf16_head_dims_that_are_multiples_of_8_take_the_tensor_cores(d):
    assert fa.kernel_design(torch.bfloat16, d, *_qkv(torch.bfloat16, d)) == 'tensor_core'


@pytest.mark.parametrize('dtype,d', [(torch.float32, 16), (torch.float32, 40),
                                     (torch.float32, 64), (torch.float32, 100),
                                     (torch.float32, 128), (torch.bfloat16, 100),
                                     (torch.bfloat16, 12), (torch.bfloat16, 4)])
def test_fp32_and_other_head_dims_take_the_cuda_cores(dtype, d):
    assert fa.kernel_design(dtype, d, *_qkv(dtype, d)) == 'cuda_core'


@pytest.mark.parametrize('dtype,d', [(torch.float16, 64), (torch.float16, 256),
                                     (torch.bfloat16, 256), (torch.bfloat16, 136),
                                     (torch.float32, 256)])
def test_fp16_and_head_dims_above_128_take_the_cuda_cores(dtype, d):
    assert fa.kernel_design(dtype, d, *_qkv(dtype, d)) == 'cuda_core'


@pytest.mark.parametrize('which', range(3))
def test_a_misaligned_view_takes_the_cuda_cores(which):
    tensors = _qkv(torch.bfloat16, 64)
    tensors[which] = _misaligned(tuple(tensors[which].shape), torch.bfloat16)
    assert tensors[which].is_contiguous() and tensors[which].data_ptr() % 16 != 0
    assert fa.kernel_design(torch.bfloat16, 64, *tensors) == 'cuda_core'


# ---------------------------------------------------------------------------
# the manifest: sources, symbols, argument counts
# ---------------------------------------------------------------------------

_EXTERN_C = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _extern_c_symbols():
    """{symbol: (source file, number of arguments)} over csrc/*.cu."""
    found = {}
    for name in sorted(os.listdir(CSRC)):
        if name.endswith('.cu'):
            with open(os.path.join(CSRC, name)) as f:
                for symbol, args in _EXTERN_C.findall(f.read()):
                    found[symbol] = (name, len([a for a in args.split(',') if a.strip()]))
    return found


def test_every_source_is_built_and_every_symbol_is_bound():
    sources = sorted(n for n in os.listdir(CSRC) if n.endswith('.cu'))
    assert sorted(fa._SOURCES.values()) == sources
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(('.h', '.cuh')))
    assert sorted(fa._HEADERS) == headers
    symbols = _extern_c_symbols()
    assert sorted(symbols) == sorted(fa._SYMBOLS)
    for symbol, (source, n_args) in symbols.items():
        library, argtypes = fa._SYMBOLS[symbol]
        assert fa._SOURCES[library] == source, symbol
        assert len(argtypes) == n_args, symbol


def test_the_c_header_declares_every_symbol():
    with open(os.path.join(CSRC, 'flash_api.h')) as f:
        header = f.read()
    declared = dict((name, len([a for a in args.split(',') if a.strip()]))
                    for name, args in re.findall(r'^int\s+(\w+)\s*\(([^)]*)\);', header, re.M | re.S))
    assert declared == {sym: n for sym, (_, n) in _extern_c_symbols().items()}


# ---------------------------------------------------------------------------
# both routes of each wrapper reach their launch
# ---------------------------------------------------------------------------

@pytest.fixture
def recorded_launches(monkeypatch):
    """Wrappers that take CPU tensors for CUDA ones and record the launch
    instead of making it."""
    calls = []
    monkeypatch.setattr(fa, '_device_kind', lambda t: 'cuda')
    monkeypatch.setattr(fa, '_stream', lambda t: 0)
    monkeypatch.setattr(fa, '_launch', lambda symbol, *args: calls.append((symbol, args)))
    for kernel in fa.KERNELS:
        monkeypatch.setattr(kernel, 'launches', 0)
        monkeypatch.setattr(kernel, 'launches_by_design', {'tensor_core': 0, 'cuda_core': 0})
    return calls


def _operands(dtype, d, misaligned=False, b=2, s=20, h=2):
    shape = (b, s, h, d)
    q, k, v, do = (_misaligned(shape, dtype) if misaligned else torch.zeros(shape, dtype=dtype)
                   for _ in range(4))
    stats = [torch.zeros(b * h, s) for _ in range(2)]
    return q, k, v, do, stats


@pytest.mark.parametrize('dtype,d,misaligned,symbol,design', [
    (torch.bfloat16, 64, False, 'pt_flash_fwd_sm90', 'tensor_core'),
    (torch.bfloat16, 40, False, 'pt_flash_fwd_sm90', 'tensor_core'),
    (torch.bfloat16, 64, True, 'pt_flash_fwd', 'cuda_core'),
    (torch.bfloat16, 100, False, 'pt_flash_fwd', 'cuda_core'),
    (torch.float32, 64, False, 'pt_flash_fwd', 'cuda_core'),
    (torch.float16, 64, False, 'pt_flash_fwd', 'cuda_core'),
    (torch.bfloat16, 256, False, 'pt_flash_fwd', 'cuda_core'),
    (torch.float32, 256, False, 'pt_flash_fwd', 'cuda_core'),
])
def test_forward_routes_reach_their_launch(recorded_launches, dtype, d, misaligned, symbol,
                                           design):
    q, k, v, _, _ = _operands(dtype, d, misaligned)
    o, lse = fa.flash_fwd(q, k, v, None, False, 0.125)
    assert [c[0] for c in recorded_launches] == [symbol]
    assert len(recorded_launches[0][1]) == len(fa._SYMBOLS[symbol][1])
    if design == 'cuda_core':   # the dtype code before the stream (csrc/flash_api.h)
        assert recorded_launches[0][1][-2] == {torch.float32: 0, torch.bfloat16: 1,
                                               torch.float16: 2}[dtype]
    assert o.shape == q.shape and o.dtype == dtype and lse.shape == (4, 20)
    assert fa.flash_fwd.launches == 1
    assert fa.flash_fwd.launches_by_design[design] == 1
    assert sum(fa.flash_fwd.launches_by_design.values()) == 1


@pytest.mark.parametrize('dtype,d,misaligned,symbol,design', [
    (torch.bfloat16, 64, False, 'pt_flash_bwd_dkv_sm90', 'tensor_core'),
    (torch.bfloat16, 128, False, 'pt_flash_bwd_dkv_sm90', 'tensor_core'),
    (torch.bfloat16, 64, True, 'pt_flash_bwd_dkv', 'cuda_core'),
    (torch.bfloat16, 100, False, 'pt_flash_bwd_dkv', 'cuda_core'),
    (torch.float32, 64, False, 'pt_flash_bwd_dkv', 'cuda_core'),
    (torch.float16, 256, False, 'pt_flash_bwd_dkv', 'cuda_core'),
])
def test_dkv_routes_reach_their_launch(recorded_launches, dtype, d, misaligned, symbol, design):
    q, k, v, do, (lse, delta) = _operands(dtype, d, misaligned)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, None, True, 0.125)
    assert [c[0] for c in recorded_launches] == [symbol]
    assert len(recorded_launches[0][1]) == len(fa._SYMBOLS[symbol][1])
    assert dk.shape == dv.shape == q.shape
    assert fa.flash_bwd_dkv.launches == 1
    assert fa.flash_bwd_dkv.launches_by_design[design] == 1
    assert sum(fa.flash_bwd_dkv.launches_by_design.values()) == 1


@pytest.mark.parametrize('dtype,d,misaligned,symbol,design', [
    (torch.bfloat16, 64, False, 'pt_flash_bwd_dq_sm90', 'tensor_core'),
    (torch.bfloat16, 128, False, 'pt_flash_bwd_dq_sm90', 'tensor_core'),
    (torch.bfloat16, 64, True, 'pt_flash_bwd_dq', 'cuda_core'),
    (torch.bfloat16, 100, False, 'pt_flash_bwd_dq', 'cuda_core'),
    (torch.float32, 64, False, 'pt_flash_bwd_dq', 'cuda_core'),
    (torch.float16, 64, False, 'pt_flash_bwd_dq', 'cuda_core'),
    (torch.bfloat16, 256, False, 'pt_flash_bwd_dq', 'cuda_core'),
])
def test_dq_routes_reach_their_launch(recorded_launches, dtype, d, misaligned, symbol, design):
    q, k, v, do, (lse, delta) = _operands(dtype, d, misaligned)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, None, True, 0.125)
    assert [c[0] for c in recorded_launches] == [symbol]
    assert len(recorded_launches[0][1]) == len(fa._SYMBOLS[symbol][1])
    assert dq.shape == q.shape and dq.dtype == dtype
    assert fa.flash_bwd_dq.launches == 1
    assert fa.flash_bwd_dq.launches_by_design[design] == 1
    assert sum(fa.flash_bwd_dq.launches_by_design.values()) == 1


def test_head_dims_above_256_and_other_dtypes_are_refused(recorded_launches):
    q, k, v, _, _ = _operands(torch.bfloat16, 264)
    with pytest.raises(ValueError, match='head_dim <= 256'):
        fa.flash_fwd(q, k, v, None, False, 0.125)
    q, k, v, _, _ = _operands(torch.float64, 64)
    with pytest.raises(TypeError, match='float16'):
        fa.flash_fwd(q, k, v, None, False, 0.125)
    assert recorded_launches == [] and fa.flash_fwd.launches == 0


def _call_forward(q, k, v, do, lse, delta):
    return fa.flash_fwd(q, k, v, None, False, 0.125)


def _call_dq(q, k, v, do, lse, delta):
    return fa.flash_bwd_dq(q, k, v, do, lse, delta, None, False, 0.125)


@pytest.mark.parametrize('wrapper,call,symbol', [
    (fa.flash_fwd, _call_forward, 'pt_flash_fwd_sm90'),
    (fa.flash_bwd_dq, _call_dq, 'pt_flash_bwd_dq_sm90'),
])
def test_a_failed_launch_raises_and_counts_nothing(monkeypatch, wrapper, call, symbol):
    """A launch that returns a CUDA error raises; no other design is tried."""
    tried = []

    def failing(symbol):
        tried.append(symbol)
        return lambda *args: 700

    monkeypatch.setattr(fa, '_device_kind', lambda t: 'cuda')
    monkeypatch.setattr(fa, '_stream', lambda t: 0)
    monkeypatch.setattr(fa, '_symbol', failing)
    monkeypatch.setattr(wrapper, 'launches', 0)
    q, k, v, do, (lse, delta) = _operands(torch.bfloat16, 64)
    with pytest.raises(RuntimeError, match='%s.*error 700' % symbol):
        call(q, k, v, do, lse, delta)
    assert tried == [symbol] and wrapper.launches == 0


# ---------------------------------------------------------------------------
# numerics budget of the tensor-core kernels
# ---------------------------------------------------------------------------

def _bf16_parts(x, rounding):
    """x as the tensor cores take it: ``'split'`` into bf16 hi + lo parts (the
    kernels' choice), ``'once'`` rounded to bf16, or ``None`` left in f32."""
    if rounding is None:
        return x
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float() if rounding == 'split' else hi


def _fwd_tensor_core(q, k, v, segment_ids, causal, scale, rounding):
    """flash_fwd_sm90.cu's arithmetic: online softmax over 64-key tiles with
    f32 running max and sum, P rounded to bf16 (parts) for O += P.V."""
    b, s, h, d = q.shape
    sc = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    sc = torch.where(fa._mask(s, causal, segment_ids, q.device), sc, fa.NEG_INF)
    m = torch.full((b, h, s, 1), fa.NEG_INF)
    l = torch.zeros(b, h, s, 1)
    acc = torch.zeros(b, h, s, d)
    for k0 in range(0, s, 64):
        tile = sc[..., k0:k0 + 64]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        alpha = torch.where(m == fa.NEG_INF, 0.0, torch.exp(m - m_new))
        p = torch.where(m_new == fa.NEG_INF, 0.0, torch.exp(tile - m_new))
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum('bhqk,bkhd->bhqd', _bf16_parts(p, rounding),
                                         v[:, k0:k0 + 64].float())
        m = m_new
    o = torch.where(l == 0, 0.0, acc / torch.where(l == 0, 1.0, l))
    return o.permute(0, 2, 1, 3).to(q.dtype)


def _dq_tensor_core(q, k, v, dout, lse, delta, segment_ids, causal, scale, rounding):
    """flash_bwd_dq_sm90.cu's arithmetic: dS in f32, rounded to bf16 (parts)
    for dQ += dS.K."""
    _, ds = fa._probs_and_ds(q, k, v, dout, lse, delta, segment_ids, causal, scale)
    return torch.einsum('bhqk,bkhd->bqhd', _bf16_parts(ds, rounding), k.float()).to(q.dtype)


def _dkv_tensor_core(q, k, v, dout, lse, delta, segment_ids, causal, scale, rounding):
    """flash_bwd_dkv_sm90.cu's arithmetic: P^T and dS^T in f32, rounded to
    bf16 (parts) for dV += P^T.dO and dK += dS^T.Q."""
    p, ds = fa._probs_and_ds(q, k, v, dout, lse, delta, segment_ids, causal, scale)
    dk = torch.einsum('bhqk,bqhd->bkhd', _bf16_parts(ds, rounding), q.float())
    dv = torch.einsum('bhqk,bqhd->bkhd', _bf16_parts(p, rounding), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _share_of_limit(actual, expected, tol):
    """max |actual - expected| / (atol + rtol |expected|): at most 1 passes."""
    atol, rtol = tol
    err = (actual.float() - expected.float()).abs()
    return float((err / (atol + rtol * expected.float().abs())).max())


def _budget_inputs(seed=0, b=4, s=196, h=6, d=64):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g).to(torch.bfloat16) for _ in range(4))
    seg = torch.sort(torch.randint(0, 4, (b, s), generator=g), dim=1)[0].to(torch.int32)
    return q, k, v, do, seg


def _budget_shares(rounding, causal=True):
    q, k, v, do, seg = _budget_inputs()
    b, s, h, d = q.shape
    scale = d ** -0.5
    tol = _chip_smoke_tol()['bf16_vs_plain']
    o_plain, lse = fa.flash_fwd_plain(q, k, v, seg, causal, scale)
    o = _fwd_tensor_core(q, k, v, seg, causal, scale, rounding)
    delta = (do.float() * o_plain.float()).sum(-1).permute(0, 2, 1).reshape(b * h, s)
    dq_plain = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, seg, causal, scale)
    dq = _dq_tensor_core(q, k, v, do, lse, delta, seg, causal, scale, rounding)
    dk_plain, dv_plain = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, seg, causal, scale)
    dk, dv = _dkv_tensor_core(q, k, v, do, lse, delta, seg, causal, scale, rounding)
    return {'o': _share_of_limit(o, o_plain, tol), 'dq': _share_of_limit(dq, dq_plain, tol),
            'dk': _share_of_limit(dk, dk_plain, tol), 'dv': _share_of_limit(dv, dv_plain, tol)}


def test_split_rounding_stays_within_the_bf16_tolerance():
    """The kernels' hi/lo split of P and dS, at b=4, s=196, h=6, d=64, causal
    with segment ids, against the unchanged plain versions at chip_smoke's
    ``bf16_vs_plain`` tolerance."""
    shares = _budget_shares('split')
    assert max(shares.values()) <= 0.9, shares


def test_rounding_once_would_not_fit():
    """Why the kernels split: one bf16 rounding of P and dS exceeds the
    tolerance on the same inputs, for dQ, dK and dV alike."""
    shares = _budget_shares('once')
    assert max(shares['dk'], shares['dv']) > 1.0, shares
    assert shares['dq'] > 1.0, shares


def test_the_emulated_forward_without_rounding_is_the_plain_forward():
    """The emulation's online softmax itself is exact: in f32 it agrees with
    the plain version to f32 rounding."""
    q, k, v, _, seg = _budget_inputs(b=2, s=150, h=2, d=32)
    q, k, v = (t.float() for t in (q, k, v))
    got = _fwd_tensor_core(q, k, v, seg, True, 32 ** -0.5, rounding=None)
    want, _ = fa.flash_fwd_plain(q, k, v, seg, True, 32 ** -0.5)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


if __name__ == '__main__':
    # The budget behind the kernels' choice: the worst share of the limit for
    # o, dq, dk and dv under each rounding.
    for rounding in ('once', 'split'):
        print(rounding, {k: round(v, 3) for k, v in _budget_shares(rounding).items()})
