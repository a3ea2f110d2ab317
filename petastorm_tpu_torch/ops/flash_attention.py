"""Flash attention (forward + backward) as hand-written CUDA kernels for Hopper.

Counterpart of ``petastorm_tpu/ops/flash_attention.py``, whose three Pallas
TPU kernels become CUDA C++ kernels for ``sm_90a`` in ``../csrc``:

=========================  ===================================================
JAX package (Pallas)       this module (CUDA, ``csrc/``)
=========================  ===================================================
``_fwd_kernel``            :func:`flash_fwd` (``flash_fwd_sm90.cu``,
                           ``flash_fwd.cu``)
``_bwd_dq_kernel``         :func:`flash_bwd_dq` (``flash_bwd_dq_sm90.cu``,
                           ``flash_bwd.cu``)
``_bwd_dkv_kernel``        :func:`flash_bwd_dkv` (``flash_bwd_dkv_sm90.cu``,
                           ``flash_bwd.cu``)
=========================  ===================================================

Each kernel has two designs, and :func:`kernel_design` picks one before
launch from the operands alone: ``'tensor_core'`` (wgmma fed by TMA; bf16,
head_dim a multiple of 8 up to 128, 16-byte aligned tensors) or
``'cuda_core'`` (f32 FMAs; every other case: fp32 above all, whose tolerance
the tensor cores' TF32 could not hold, fp16, and head_dim up to 256).  A
launch that fails raises: no design stands in for another.

Each kernel wrapper takes ``[batch, seq, heads, head_dim]`` tensors, allocates
its outputs, launches its kernel on the current stream and counts the launch
in its ``launches`` attribute (and by design in ``launches_by_design``);
under a CUDA graph (:mod:`~petastorm_tpu_torch.gpu.graphs`) they count the
launches each replay runs.
Beside each kernel sits its plain PyTorch version (``*_plain``): the wrapper
runs it for tensors on the CPU, and for a CUDA tensor it launches the kernel
or raises.  :func:`full_attention` is the dense reference (PyTorch's own
autograd) that both are held against.

The kernels stream K/V (and, for dK/dV, Q) through shared memory at any
length, so the TPU kernel's ``kv_chunk`` streaming and its block sizes have
nothing left to decide here: :func:`flash_attention` accepts them and returns
the same result whatever their values.

The libraries are built with ``nvcc`` at first use into ``build/`` at the
root of the checkout (one ``nvcc`` per source, started together) and bound
with ``ctypes``.
"""

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

from petastorm_tpu_torch.gpu import graphs

__all__ = ['NEG_INF', 'flash_attention', 'full_attention', 'flash_fwd', 'flash_bwd_dq',
           'flash_bwd_dkv', 'flash_fwd_plain', 'flash_bwd_dq_plain', 'flash_bwd_dkv_plain',
           'build_kernels', 'kernel_design', 'KERNELS']

#: Finite stand-in for -inf (the JAX package's value): keeps exp() exactly 0
#: without NaNs.
NEG_INF = -1e30

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, 'csrc')
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build', 'petastorm_tpu_torch')
#: library name -> CUDA source; one nvcc process per source.
_SOURCES = {'pt_flash_fwd': 'flash_fwd.cu', 'pt_flash_bwd': 'flash_bwd.cu',
            'pt_flash_fwd_sm90': 'flash_fwd_sm90.cu',
            'pt_flash_bwd_dq_sm90': 'flash_bwd_dq_sm90.cu',
            'pt_flash_bwd_dkv_sm90': 'flash_bwd_dkv_sm90.cu'}
_HEADERS = ('flash_api.h', 'flash_common.cuh', 'sm90_common.cuh')
_NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3', '-shared',
               '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C symbol -> (library, argtypes); see csrc/flash_api.h.
_SYMBOLS = {
    'pt_flash_fwd': ('pt_flash_fwd', [_P] * 6 + [_I] * 4 + [_F, _I, _I, _P]),
    'pt_flash_bwd_dq': ('pt_flash_bwd', [_P] * 8 + [_I] * 4 + [_F, _I, _I, _P]),
    'pt_flash_bwd_dkv': ('pt_flash_bwd', [_P] * 9 + [_I] * 4 + [_F, _I, _I, _P]),
    'pt_flash_fwd_sm90': ('pt_flash_fwd_sm90', [_P] * 6 + [_I] * 4 + [_F, _I, _P]),
    'pt_flash_bwd_dq_sm90': ('pt_flash_bwd_dq_sm90', [_P] * 8 + [_I] * 4 + [_F, _I, _P]),
    'pt_flash_bwd_dkv_sm90': ('pt_flash_bwd_dkv_sm90', [_P] * 9 + [_I] * 4 + [_F, _I, _P]),
}

_libs = {}
_build_lock = threading.Lock()


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') or '/usr/local/cuda'
    path = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(path):
        return path
    path = shutil.which('nvcc')
    if path is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME): the flash-attention kernels '
                           'are built from petastorm_tpu_torch/csrc at first use')
    return path


def _stale(lib_path, source):
    if not os.path.exists(lib_path):
        return True
    built = os.path.getmtime(lib_path)
    deps = [source] + [os.path.join(_CSRC, h) for h in _HEADERS]
    return any(os.path.getmtime(p) > built for p in deps)


def build_kernels():
    """Compile every kernel library that is missing or older than its sources,
    one ``nvcc`` per source, all started together.  Returns ``{library:
    {'seconds': wall time, 'log': nvcc output}}`` for the libraries built."""
    with _build_lock:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        started = {}
        for name, src in _SOURCES.items():
            source = os.path.join(_CSRC, src)
            lib_path = os.path.join(_BUILD_DIR, 'lib%s.so' % name)
            if not _stale(lib_path, source):
                continue
            tmp = '%s.%d.tmp' % (lib_path, os.getpid())
            proc = subprocess.Popen([_nvcc()] + _NVCC_FLAGS + ['-o', tmp, source],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            started[name] = (proc, tmp, lib_path, time.monotonic())
        built, failed = {}, []
        for name, (proc, tmp, lib_path, t0) in started.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append('nvcc failed for %s (exit %d):\n%s'
                              % (_SOURCES[name], proc.returncode, log))
                continue
            os.replace(tmp, lib_path)   # atomic: a concurrent loader never sees half a file
            built[name] = {'seconds': time.monotonic() - t0, 'log': log}
        if failed:
            raise RuntimeError('\n'.join(failed))
        return built


def _symbol(symbol):
    lib_name = _SYMBOLS[symbol][0]
    lib = _libs.get(lib_name)
    if lib is None:
        build_kernels()
        lib = _libs[lib_name] = ctypes.CDLL(os.path.join(_BUILD_DIR, 'lib%s.so' % lib_name))
        for sym, (owner, types) in _SYMBOLS.items():
            if owner == lib_name:
                fn = getattr(lib, sym)
                fn.argtypes = types
                fn.restype = ctypes.c_int
    return getattr(lib, symbol)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: The largest head_dim the kernels take (the CUDA-core design's widest tile).
MAX_HEAD_DIM = 256


def _check_cuda(q, k, v, segment_ids, *more):
    """Validate the kernels' operands; returns (b, s, h, d, dtype code)."""
    if q.dim() != 4:
        raise ValueError('expected [batch, seq, heads, head_dim], got %r' % (tuple(q.shape),))
    b, s, h, d = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError('flash kernels take float32, bfloat16 or float16, got %s' % (q.dtype,))
    if d > MAX_HEAD_DIM:
        raise ValueError('flash kernels take head_dim <= %d, got %d' % (MAX_HEAD_DIM, d))
    for t in (q, k, v) + more:
        if t.device != q.device or t.dtype != q.dtype or tuple(t.shape) != (b, s, h, d):
            raise ValueError('q, k, v (and dO) must share device, dtype and shape %r; got %s %s %r'
                             % ((b, s, h, d), t.device, t.dtype, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError('flash kernels take contiguous tensors')
    if segment_ids is not None and (segment_ids.device != q.device
                                    or segment_ids.dtype != torch.int32
                                    or tuple(segment_ids.shape) != (b, s)
                                    or not segment_ids.is_contiguous()):
        raise ValueError('segment_ids must be a contiguous int32 [batch, seq] tensor on %s'
                         % (q.device,))
    return b, s, h, d, _DTYPE_CODES[q.dtype]


def _check_stats(b, s, h, device, *stats):
    for t in stats:
        if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != (b * h, s) \
                or not t.is_contiguous():
            raise ValueError('lse/delta must be contiguous float32 [batch*heads, seq] on %s'
                             % (device,))


def _launch(symbol, *args):
    code = _symbol(symbol)(*args)
    if code != 0:
        raise RuntimeError('%s: kernel launch failed with CUDA error %d' % (symbol, code))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def kernel_design(dtype, head_dim, *tensors):
    """The kernel design for operands of ``dtype`` and ``head_dim`` held in
    ``tensors`` (the ones the kernel reads or writes by TMA):
    ``'tensor_core'`` for bf16 with head_dim a multiple of 8 up to 128 and
    every tensor 16-byte aligned (TMA's rule for a base and its strides),
    else ``'cuda_core'`` (fp32, fp16, other head dims up to
    :data:`MAX_HEAD_DIM`, misaligned tensors)."""
    if dtype == torch.bfloat16 and head_dim % 8 == 0 and 8 <= head_dim <= 128 \
            and all(t.data_ptr() % 16 == 0 for t in tensors):
        return 'tensor_core'
    return 'cuda_core'


def _count(wrapper, design):
    wrapper.launches += 1
    wrapper.launches_by_design[design] += 1


def _device_kind(t):
    if t.device.type not in ('cpu', 'cuda'):
        raise ValueError('flash kernels run on cuda (plain version on cpu), got %s' % (t.device,))
    return t.device.type


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------

def _mask(s_len, causal, segment_ids, device):
    """[b or 1, 1, q, k] bool: which pairs may attend."""
    mask = torch.ones(s_len, s_len, dtype=torch.bool, device=device)
    if causal:
        mask = torch.tril(mask)
    mask = mask[None, None]
    if segment_ids is not None:
        seg = segment_ids
        mask = mask & ((seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0))[:, None]
    return mask


def flash_fwd_plain(q, k, v, segment_ids, causal, scale):
    """Plain version of :func:`flash_fwd`: ``(o, lse)`` computed densely in
    fp32; fully masked rows give ``o = 0`` and ``lse = NEG_INF``."""
    b, s, h, _ = q.shape
    sc = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    sc = torch.where(_mask(s, causal, segment_ids, q.device), sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(m == NEG_INF, 0.0, torch.exp(sc - m))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    o = torch.einsum('bhqk,bkhd->bqhd', p / l_safe, v.float())
    lse = torch.where(l == 0, NEG_INF, m + torch.log(l_safe))
    return o.to(q.dtype), lse.reshape(b * h, s)


def _probs_and_ds(q, k, v, dout, lse, delta, segment_ids, causal, scale):
    b, s, h, _ = q.shape
    sc = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    mask = _mask(s, causal, segment_ids, q.device)
    p = torch.where(mask, torch.exp(sc - lse.reshape(b, h, s, 1)), 0.0)
    dp = torch.einsum('bqhd,bkhd->bhqk', dout.float(), v.float())
    ds = p * (dp - delta.reshape(b, h, s, 1)) * scale
    return p, ds


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, segment_ids, causal, scale):
    """Plain version of :func:`flash_bwd_dq`: ``dq = ds . K`` with
    ``p = exp(s - lse)`` recomputed from the saved log-sum-exp."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, segment_ids, causal, scale)
    return torch.einsum('bhqk,bkhd->bqhd', ds, k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, segment_ids, causal, scale):
    """Plain version of :func:`flash_bwd_dkv`: ``dk = ds^T . Q``,
    ``dv = p^T . dO``."""
    p, ds = _probs_and_ds(q, k, v, dout, lse, delta, segment_ids, causal, scale)
    dk = torch.einsum('bhqk,bqhd->bkhd', ds, q.float())
    dv = torch.einsum('bhqk,bqhd->bkhd', p, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def full_attention(q, k, v, causal=False, scale=None, segment_ids=None):
    """Dense single-device reference attention (test oracle, small shapes).

    Copy of ``petastorm_tpu.parallel.ring_attention.full_attention``:
    ``[batch, seq, heads, head_dim]`` inputs, computed in their dtype, with
    PyTorch's own autograd.  ``segment_ids`` ([batch, seq] int, 0 = padding)
    restricts attention to same-nonzero-segment pairs; fully masked rows
    output exactly 0.
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    # the scale in q's dtype, as JAX rounds a Python scalar to the array's
    sc = torch.einsum('bqhd,bkhd->bhqk', q, k) * torch.tensor(scale, dtype=q.dtype)
    if causal:
        s_len = q.shape[1]
        keep = torch.tril(torch.ones(s_len, s_len, dtype=torch.bool, device=q.device))
        sc = torch.where(keep, sc, NEG_INF)
    if segment_ids is not None:
        seg = segment_ids
        same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0)
        sc = torch.where(same[:, None], sc, NEG_INF)
    # jax.nn.softmax op by op, so a bf16 input rounds where XLA rounds it
    unnormalized = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    p = unnormalized / unnormalized.sum(dim=-1, keepdim=True)
    if segment_ids is not None:
        # padding rows would softmax uniformly over NEG_INF; zero them
        p = torch.where((segment_ids != 0)[:, None, :, None], p, 0.0)
    return torch.einsum('bhqk,bkhd->bqhd', p, v)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def flash_fwd(q, k, v, segment_ids, causal, scale):
    """Forward kernel: ``(o [b, s, h, d] in q's dtype, lse [b*h, s] f32)``."""
    if _device_kind(q) == 'cpu':
        return flash_fwd_plain(q, k, v, segment_ids, causal, scale)
    b, s, h, d, code = _check_cuda(q, k, v, segment_ids)
    o = torch.empty_like(q)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    args = (_ptr(q), _ptr(k), _ptr(v), _ptr(segment_ids), _ptr(o), _ptr(lse), b, s, h, d,
            float(scale), int(bool(causal)))
    design = kernel_design(q.dtype, d, q, k, v, o)
    if design == 'tensor_core':
        _launch('pt_flash_fwd_sm90', *args, _stream(q))
    else:
        _launch('pt_flash_fwd', *args, code, _stream(q))
    _count(flash_fwd, design)
    return o, lse


flash_fwd.launches = 0
flash_fwd.launches_by_design = {'tensor_core': 0, 'cuda_core': 0}


def flash_bwd_dq(q, k, v, dout, lse, delta, segment_ids, causal, scale):
    """dQ kernel: ``dq`` in q's dtype."""
    if _device_kind(q) == 'cpu':
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, segment_ids, causal, scale)
    b, s, h, d, code = _check_cuda(q, k, v, segment_ids, dout)
    _check_stats(b, s, h, q.device, lse, delta)
    dq = torch.empty_like(q)
    args = (_ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(lse), _ptr(delta), _ptr(segment_ids),
            _ptr(dq), b, s, h, d, float(scale), int(bool(causal)))
    design = kernel_design(q.dtype, d, q, k, v, dout, dq)
    if design == 'tensor_core':
        _launch('pt_flash_bwd_dq_sm90', *args, _stream(q))
    else:
        _launch('pt_flash_bwd_dq', *args, code, _stream(q))
    _count(flash_bwd_dq, design)
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.launches_by_design = {'tensor_core': 0, 'cuda_core': 0}


def flash_bwd_dkv(q, k, v, dout, lse, delta, segment_ids, causal, scale):
    """dK/dV kernel: ``(dk, dv)`` in k's and v's dtype."""
    if _device_kind(q) == 'cpu':
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, segment_ids, causal, scale)
    b, s, h, d, code = _check_cuda(q, k, v, segment_ids, dout)
    _check_stats(b, s, h, q.device, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    args = (_ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(lse), _ptr(delta), _ptr(segment_ids),
            _ptr(dk), _ptr(dv), b, s, h, d, float(scale), int(bool(causal)))
    design = kernel_design(q.dtype, d, q, k, v, dout, dk, dv)
    if design == 'tensor_core':
        _launch('pt_flash_bwd_dkv_sm90', *args, _stream(q))
    else:
        _launch('pt_flash_bwd_dkv', *args, code, _stream(q))
    _count(flash_bwd_dkv, design)
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.launches_by_design = {'tensor_core': 0, 'cuda_core': 0}

#: The kernel wrappers in launch order, for counting and reporting.
KERNELS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
for _wrapper in KERNELS:   # a replay counts the launches its capture recorded
    graphs.counts_launches(_wrapper)


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """The forward kernel, and the two backward kernels as its gradient
    (the JAX package's ``_flash`` custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, scale):
        o, lse = flash_fwd(q, k, v, segment_ids, causal, scale)
        ctx.save_for_backward(q, k, v, segment_ids, o, lse)
        ctx.causal = causal
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, o, lse = ctx.saved_tensors
        dout = dout.contiguous()
        b, s, h, _ = q.shape
        # delta = rowsum(dO * O) in fp32, laid out like lse: [b*h, s].
        delta = (dout.float() * o.float()).sum(dim=-1).permute(0, 2, 1).reshape(b * h, s)
        delta = delta.contiguous()
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, segment_ids, ctx.causal, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, segment_ids, ctx.causal, ctx.scale)
        # segment ids are labels: no gradient
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=False, scale=None, block_q=128, block_k=128,
                    segment_ids=None, kv_chunk=None):
    """Flash attention over ``[batch, seq, heads, head_dim]`` inputs.

    Same signature and semantics as ``petastorm_tpu.ops.flash_attention``;
    differentiable through the dQ and dK/dV kernels.  ``segment_ids``
    (``[batch, seq]`` int, 0 = padding) restricts attention to
    same-nonzero-segment pairs.  ``block_q``, ``block_k`` and ``kv_chunk``
    are validated and do not change the result (see the module docstring).
    """
    if q.dim() != 4:
        raise ValueError('expected [batch, seq, heads, head_dim], got %r' % (tuple(q.shape),))
    b, seq_len, h, d = q.shape
    if k.shape[1] != seq_len:
        raise ValueError('flash_attention requires seq_q == seq_kv (got %d vs %d)'
                         % (seq_len, k.shape[1]))
    for name, value in (('block_q', block_q), ('block_k', block_k)):
        if int(value) < 1:
            raise ValueError('%s must be positive, got %r' % (name, value))
    if kv_chunk is not None and int(kv_chunk) < 0:
        raise ValueError('kv_chunk must be None, 0 or positive, got %r' % (kv_chunk,))
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (b, seq_len):
            raise ValueError('segment_ids must be [batch, seq] = %r, got %r'
                             % ((b, seq_len), tuple(segment_ids.shape)))
        segment_ids = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    scale = float(scale) if scale is not None else d ** -0.5
    return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), segment_ids,
                                 bool(causal), scale)
