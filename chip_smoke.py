"""Chip smoke test of petastorm_tpu_torch on one NVIDIA GPU (Hopper).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure propagates and exits nonzero:

1. device: a CUDA card, its name and power limit (``nvidia-smi``);
2. build: the flash-attention kernels (nvcc) and the native decode plane
   (g++, ``csrc/pt_decode.cc``), from ``petastorm_tpu_torch/csrc``; the
   functions the decode library holds (a library family whose headers the
   host lacks is printed as absent, with the paths that decode with cv2);
3. kernels vs plain: each kernel against its plain PyTorch version on the
   same inputs, and the differentiable op against the dense fp32 reference,
   at (a) the ViT-S/16 training shapes in bf16, (b) a small fp32 case with
   causal masking, segment ids and a length that is no multiple of 64,
   (c) one case for each other head_dim tile width of the CUDA-core kernels,
   (d) bf16 cases on the tensor-core route for each of its tile widths and
   masks, (e) bf16 cases on the CUDA-core route for each of its tile
   widths, and (f) the LM paths' shapes: L1's causal 8 x 1024 x 8 x 32,
   L2's causal 4 x 512 x 4 x 32 with the segment ids of a real packed
   batch, and L3's causal prefill 2 x 8 x 4 x 32; each case checks which
   design each kernel took;
   then each kernel timed at (a) beside its plain version, one PyTorch
   library call where one computes the same function, and its bound, each
   also through its CUDA-core design, and PyTorch's fused attention
   backward beside the two backward kernels; and each kernel's host time
   per wrapper call, for both designs; then each kernel timed at the L1
   shapes (causal), beside its plain version, PyTorch's causal fused
   attention and its bound; then the cases only the CUDA-core design takes,
   fp16 and head_dim 256 (fp32, bf16, fp16) at each mask, checked as above
   and timed at b=4, s=1024, h=4;
4. model: the ViT-S/16 forward through the kernels against the same model
   through the dense reference, on a small batch;
5. main path: a synthetic JPEG Parquet dataset, then 20 full-width
   ViT-S/16 training steps through the port's reader, loader, on-device
   augment and model, with every kernel's launches counted; then a short
   run of the same path under torch.profiler: the device busy time per step
   and its split by kernel family, and the host's time in launch calls and
   in calls that wait for the device.  Every kernel launch of the 20 steps
   must take the tensor-core design;
6. ResNet-50: 20 full-width training steps (the JAX example's default
   model) on the same dataset, streaming, with the stall monitor's
   ``stall_pct``, every BatchNorm's running statistics finite and moved,
   and no flash kernel launched; the trained weights' bf16 logits against
   the same weights run in fp32; and a profile of the step like the ViT's;
7. HBM cache: 16 ResNet-50 steps (two epochs) through
   ``DeviceInMemDataLoader.scan_epochs`` and a profile of its step; then
   each epoch's batches, gathered on the card, against the host cache's
   rows at the epoch order that ``petastorm_tpu_torch.random`` computes,
   every row once per epoch;
8. long-context LM (L1): 20 steps of ``train_lm`` at the example's widths
   (8 x 1024 tokens, 4 layers, d_model 256, remat) from token Parquet, with
   8 forward, 4 dQ and 4 dK/dV launches per step, all on the tensor
   cores, and a profile of its step;
9. packed LM (L2): 20 steps of ``train_packed`` through the flash kernels
   with segment ids (4 x 512 packed rows, 2 layers, d_model 128), the
   packing utilisation, and on one loader batch and on a packer's tail
   batch with all-padding rows: the flash loss against the dense
   ``packed_attention`` loss on the same weights, every gradient finite;
   and a profile of its step;
10. generation (L3): the trained L2 model samples (KV cache, temperature
   0.8, top-p 0.95) with one prefill forward launch per layer, repeats exactly under
   the same key, and its greedy tokens equal the argmax of a full forward
   recomputed step by step;
11. native: each function the decode library holds against the cv2 or
   np.load path on the JPEG dataset's images (JPEG within 1 LSB, the fused
   decode and resize to 224x224 within 2, PNG, .npy and zlib .npy exact),
   host decode rates on one thread, and a ``ResizeImages`` read to the card
   that must go through the fused native function where the library holds it;
12. decode plane, read from a warm pool: the image reader alone (no
   training) to the card with 8, 2 and 1 decode threads and 8, 4 and 1
   decode processes, 12 epochs timed after 2 (images/s, the put to the card
   per batch, a process's busy time per row group, also without each
   worker's first); graphed runs of 100 steps timed after 20 of ResNet-50
   streaming with 8, 4 and 2 decode threads and 8 decode processes, ViT
   with 8 threads and 8 processes, L1 with the native plane and under
   ``native.disabled()``, and L2, all through the loader's transfer plane
   and its dispatch thread; ResNet-50 and ViT at 8 threads, L1 native and
   L2 also with the plane off (``transfer=False``), each right after its
   pumped run (the image pairs traced: the stall's top component); each
   with the put, its slab packing, ring wait and copy call timed inside it
   on the thread that ran them (with the plane on: the dispatch thread,
   beside the data wait),
   ``h2d_degraded``, the advisor's regime and its launches checked; every
   process-pool run must have delivered through /dev/shm and left no slab
   and no child; the L1 native runs must have decoded through the native
   plane;
13. pool parity: in a process started with ``PYTHONHASHSEED=0``, the
   process pool with one worker and no shuffle delivers the thread pool's
   batches to the card bit for bit, and leaves no slab and no child;
14. pump parity and the GIL probe: a coalesced put unpacked on the card
   equals the CPU's bit for bit, at full width and with
   ``wire_dtypes='auto'``; with one decode thread and no shuffle the pumped
   loader delivers the inline loader's batches bit for bit, its pulls and
   puts on the dispatch thread; a structure the plane refuses is counted in
   ``h2d_degraded`` and reaches the card; how fast another Python thread
   runs, and how long another thread's ``non_blocking`` copy call takes,
   while this one sleeps, replays a graph whose launches wait for the card,
   and synchronizes; in a process of its own, what a garbage collection
   that frees an unreachable CUDA graph does to a capture it runs inside,
   and that a step graph's capture survives such a graph;
15. disk cache (``--decoded-cache-dir``): ResNet-50 for one epoch that
   decodes and writes the cache, then 100 steps timed after 20 from the
   memory-mapped files with no reader; the files' sizes; an epoch from the
   cache pumped and inline, bit for bit;
16. trace (``--trace``): ResNet-50 through the command line; the Chrome
   trace holds ``data_wait``, ``step``, ``host_batch`` and the plane's
   ``h2d/*`` spans, the loader's on the dispatch thread.

Every streaming path moves its batches through the loader's transfer
plane (``transfer='auto'``): a dispatch thread pulls, transforms and puts
each batch into one pinned slab and one copy; the training thread only
takes finished batches.  Every training path (5-9) runs graphed, the
default on the card: a CUDA
graph of the step replayed once per step (``petastorm_tpu_torch.gpu.graphs``),
with the flash launches counted as capture x replays.  Beside each graphed
run: the same run eagerly (``cuda_graph=False``) with the same flash
launches, both runs' images/s or tokens/s, step ms, host ms per step, data
wait and ``stall_pct``; a profile of the graphed step; and an eager and a
graphed run from the same seeds and data order (one decode thread, no
row-group shuffle), whose losses, parameters and buffers must be equal bit
for bit.  ResNet-50 streaming also runs the
example's ``--scan-steps 4``; the HBM cache's profiled step must hold one
graph launch and no kernel launched from the host but the two fills of the
augment generator's seed and offset that PyTorch makes before a replay; L3
samples the same tokens graphed and eager, each timed per new token.

A line ``{"paths": {...}}`` holds those numbers.  The line before the last
is one JSON object ``{"kernels": [...]}``; the last line is ``{"ok": true,
"device": {...}}``.  Imports nothing of JAX.
"""

import contextlib
import importlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

T_START = time.monotonic()
STEPS = 20
BATCH = 64
IMAGE_ROWS = 512   # the JPEG dataset's rows: 8 row groups of 64
VIT_SHAPE = dict(b=64, s=196, h=6, d=64)     # ViT-S/16 at 224x224: 14*14 patches, 384/6
LM_SHAPE = dict(b=8, s=1024, h=8, d=32)      # L1: jax_example.py's batch 8, 256/8 heads
PACKED_SHAPE = dict(b=4, s=512, h=4, d=32)   # L2: packed_example.py's 4 rows of 512, 128/4
PREFILL_SHAPE = dict(b=2, s=8, h=4, d=32)    # L3: the sampler's prefill of 2 prompts of 8
SMALL_SHAPE = dict(b=2, s=100, h=2, d=16)
REPAIR_SHAPE = dict(b=2, s=256, h=2)         # fp16 and head_dim 256: the CUDA-core design
REPAIR_TIME_SHAPE = dict(b=4, s=1024, h=4)
#: Steps of each eager-against-graphed comparison (one warm-up step, the
#: capture, then replays); the HBM cache runs two epochs of 8.
EQ_STEPS = 8
#: (shape, dtype, causal, segments, misaligned, design) of the kernel checks:
#: the main path's shapes, the small fp32 case, one case for each other tile
#: width the CUDA-core kernels instantiate (head_dim up to 32, 64, 128), then
#: bf16 cases on the tensor-core route for each of its tile widths (16, 32,
#: 64, 128) and masks, two with head_dims that fill only part of their tile
#: (40, 72), bf16 cases on the CUDA-core route at each of its tile widths:
#: head_dims 20 and 100 (no multiple of 8), and the main path's shapes on
#: copies that start 2 bytes past a 16-byte boundary; then the LM paths'
#: shapes, whose lengths (1024, 512) are whole numbers of 64-row tiles, L2's
#: with the segment ids of a real packed batch (``'packed'``), and L3's
#: prefill, one 8-row query tile against one 8-key tile inside the 64-row
#: tile.  ``design`` is the design all three kernels must take.
KERNEL_CASES = (
    (VIT_SHAPE, torch.bfloat16, False, False, False, 'tensor_core'),
    (SMALL_SHAPE, torch.float32, True, True, False, 'cuda_core'),
    (dict(b=2, s=130, h=2, d=128), torch.bfloat16, True, False, False, 'tensor_core'),
    (dict(b=3, s=77, h=3, d=40), torch.float32, False, True, False, 'cuda_core'),
    (dict(b=1, s=150, h=2, d=100), torch.float32, True, True, False, 'cuda_core'),
    (dict(b=2, s=100, h=2, d=32), torch.bfloat16, True, True, False, 'tensor_core'),
    (dict(b=2, s=130, h=2, d=64), torch.bfloat16, True, True, False, 'tensor_core'),
    (dict(b=2, s=196, h=2, d=128), torch.bfloat16, False, True, False, 'tensor_core'),
    (dict(b=2, s=70, h=2, d=16), torch.bfloat16, True, False, False, 'tensor_core'),
    (dict(b=3, s=77, h=3, d=40), torch.bfloat16, False, True, False, 'tensor_core'),
    (dict(b=1, s=150, h=2, d=72), torch.bfloat16, True, True, False, 'tensor_core'),
    (dict(b=2, s=90, h=2, d=20), torch.bfloat16, True, True, False, 'cuda_core'),
    (VIT_SHAPE, torch.bfloat16, False, False, True, 'cuda_core'),
    (dict(b=2, s=130, h=2, d=64), torch.bfloat16, True, True, True, 'cuda_core'),
    (dict(b=1, s=150, h=2, d=100), torch.bfloat16, True, True, False, 'cuda_core'),
    (LM_SHAPE, torch.bfloat16, True, False, False, 'tensor_core'),
    (PACKED_SHAPE, torch.bfloat16, True, 'packed', False, 'tensor_core'),
    (PREFILL_SHAPE, torch.bfloat16, True, False, False, 'tensor_core'),
    # fp16 and head_dim 256, which only the CUDA-core design takes: each mask,
    # head_dim 256 in fp32, bf16 and fp16, fp16 at 64, and 200 (a partial
    # 256 tile) at a length that is no multiple of the 32-row streamed tile
    (dict(REPAIR_SHAPE, d=256), torch.float32, False, False, False, 'cuda_core'),
    (dict(REPAIR_SHAPE, d=256), torch.float32, True, True, False, 'cuda_core'),
    (dict(REPAIR_SHAPE, d=256), torch.bfloat16, True, False, False, 'cuda_core'),
    (dict(REPAIR_SHAPE, d=256), torch.bfloat16, False, True, False, 'cuda_core'),
    (dict(REPAIR_SHAPE, d=64), torch.float16, False, False, False, 'cuda_core'),
    (dict(REPAIR_SHAPE, d=64), torch.float16, True, True, False, 'cuda_core'),
    (dict(REPAIR_SHAPE, d=256), torch.float16, True, False, False, 'cuda_core'),
    (dict(REPAIR_SHAPE, d=256), torch.float16, False, True, False, 'cuda_core'),
    (dict(b=1, s=150, h=2, d=200), torch.bfloat16, True, True, False, 'cuda_core'),
)
#: Tolerances as (atol, rtol).  fp32: forward 2e-5, gradients 1e-4, as in
#: tests/test_flash_attention.py.  A bf16 kernel against its plain version:
#: one bf16 ulp (rtol 8e-3 >= 2**-7, atol 2e-3 near 0), since both compute
#: in fp32 and differ only in the last rounding to bf16; fp16 likewise, two
#: fp16 ulps (rtol 2e-3 >= 2 * 2**-10, atol 2.5e-4).  bf16 against the fp32
#: reference (the op, and the model): 3e-2; fp16: 1e-2 (its ulp is 8 times
#: finer, and the op rounds o to fp16 before delta = rowsum(dO * O)).
TOL = {'fwd_f32': (2e-5, 2e-5), 'grad_f32': (1e-4, 1e-4), 'bf16_vs_plain': (2e-3, 8e-3),
       'bf16': (3e-2, 3e-2), 'fp16_vs_plain': (2.5e-4, 2e-3), 'fp16': (1e-2, 1e-2)}
#: ResNet-50 bf16 logits against the same weights in fp32: at most this
#: share of the largest fp32 logit (the bf16 tolerance of the tests).
RESNET_BF16_SHARE = 3e-2
#: H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12     # and fp16, on the tensor cores
F32_FLOP_PER_S = 67e12       # fp32 outside the tensor cores
REPLACES = {
    'flash_fwd': 'petastorm_tpu/ops/flash_attention.py:47',
    'flash_bwd_dq': 'petastorm_tpu/ops/flash_attention.py:200',
    'flash_bwd_dkv': 'petastorm_tpu/ops/flash_attention.py:252',
}
#: The design each kernel takes on the main path, and its source.
MAIN_PATH_DESIGN = {'flash_fwd': 'tensor_core', 'flash_bwd_dq': 'tensor_core',
                    'flash_bwd_dkv': 'tensor_core'}
SOURCES = {
    'flash_fwd': 'petastorm_tpu_torch/csrc/flash_fwd_sm90.cu',
    'flash_bwd_dq': 'petastorm_tpu_torch/csrc/flash_bwd_dq_sm90.cu',
    'flash_bwd_dkv': 'petastorm_tpu_torch/csrc/flash_bwd_dkv_sm90.cu',
}


def log(*args):
    print(*args, flush=True)


def max_err(actual, expected):
    return float((actual.detach().float() - expected.detach().float()).abs().max())


def check(name, actual, expected, tol):
    """assert_close at ``tol = (atol, rtol)``; returns the max abs error."""
    atol, rtol = tol
    torch.testing.assert_close(actual.float(), expected.float(), atol=atol, rtol=rtol,
                               msg=lambda m: '%s: %s' % (name, m))
    return max_err(actual, expected)


def share_of_limit(actual, expected, tol):
    """max |actual - expected| / (atol + rtol |expected|): the share of the
    tolerance used (at most 1 passes)."""
    atol, rtol = tol
    err = (actual.detach().float() - expected.detach().float()).abs()
    return float((err / (atol + rtol * expected.detach().float().abs())).max())


def reset_counts(fa):
    for kernel in fa.KERNELS:
        kernel.launches = 0
        kernel.launches_by_design = {'tensor_core': 0, 'cuda_core': 0}


def designs_taken(fa, before):
    """{kernel: design} of the launches since ``before`` (a snapshot of
    ``launches_by_design``), each kernel having launched by one design."""
    taken = {}
    for kernel in fa.KERNELS:
        grown = [d for d, n in kernel.launches_by_design.items()
                 if n > before[kernel.__name__][d]]
        if len(grown) != 1:
            raise AssertionError('%s launched by %s designs' % (kernel.__name__, grown or 'no'))
        taken[kernel.__name__] = grown[0]
    return taken


def snapshot(fa):
    return {kernel.__name__: dict(kernel.launches_by_design) for kernel in fa.KERNELS}


def check_designs(fa, before, design, tag):
    """Every kernel launched since ``before`` by ``design`` alone."""
    for name, taken in designs_taken(fa, before).items():
        if taken != design:
            raise AssertionError('%s [%s] took the %s design, expected %s'
                                 % (name, tag, taken, design))


def counts(fa):
    """Each kernel's launches, and its launches by design."""
    return {kernel.__name__: kernel.launches for kernel in fa.KERNELS}, snapshot(fa)


def check_launches(tag, launches, by_design, expected):
    """Each kernel launched ``expected[name]`` times, all on the tensor cores."""
    for name, n in launches.items():
        if n != expected[name]:
            raise AssertionError('%s: %s launched %d times, expected %d'
                                 % (tag, name, n, expected[name]))
        design = MAIN_PATH_DESIGN[name]
        if by_design[name][design] != n:
            raise AssertionError('%s: %d of the %d launches of %s took the %s design'
                                 % (tag, by_design[name][design], n, name, design))


def make_inputs(b, s, h, d, dtype, seed, segments=False):
    g = torch.Generator(device='cuda').manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device='cuda').to(dtype)
                   for _ in range(4))
    seg = None
    if segments == 'packed':
        seg = torch.from_numpy(packed_segment_ids(b, s, seed)).cuda()
    elif segments:
        # sorted ids in 0..3: packed rows with a padding (0) prefix
        seg = torch.sort(torch.randint(0, 4, (b, s), generator=g, device='cuda'), dim=1)[0]
        seg = seg.to(torch.int32).contiguous()
    return q, k, v, do, seg


def packed_segment_ids(b, s, seed):
    """Segment ids of a real packed batch with the cases padding brings:
    the last batch ``pack_stream`` emits for the fewest documents like the
    packed example's (32 to ``s`` tokens) whose tail batch holds both an
    all-padding row and a document row that ends in padding."""
    from petastorm_tpu_torch.gpu.packing import pack_stream
    rng = np.random.default_rng(seed)
    docs = []
    while True:
        docs.append(np.zeros(int(rng.integers(32, s + 1)), np.int32))
        seg = list(pack_stream(docs, s, b))[-1]['segment_ids']
        empty = (seg == 0).all(axis=1)
        if empty.any() and (seg[~empty, -1] == 0).any():
            return seg


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device (torch.cuda.is_available() is False)')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log('device: %s; torch %s, CUDA %s, %d card(s)'
        % (torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda,
           torch.cuda.device_count()))
    log(smi)
    # fp32 matmuls in full fp32 (the reference and plain versions too).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build(fa):
    t0 = time.monotonic()
    built = fa.build_kernels()
    log('build: %.1f s wall for %s' % (time.monotonic() - t0, sorted(built) or 'nothing (fresh)'))
    for name, info in sorted(built.items()):
        log('  %s: %.1f s' % (name, info['seconds']))
        for line in info['log'].splitlines():
            if 'registers' in line or 'spill' in line:
                log('    ' + line.strip())


def kernel_case(fa, shape, dtype, causal, segments, misaligned, design, seed):
    """Each kernel against its plain version on the same inputs, and the
    autograd op against the dense fp32 reference, with q, k, v and dO on
    ``misaligned`` copies or not.  Every kernel must take ``design``.
    Returns max errors."""
    b, s, h, d = shape['b'], shape['s'], shape['h'], shape['d']
    q, k, v, do, seg = make_inputs(b, s, h, d, dtype, seed, segments)
    if misaligned:
        q, k, v, do = (misaligned_copy(t) for t in (q, k, v, do))
    scale = d ** -0.5
    low = {torch.bfloat16: 'bf16', torch.float16: 'fp16'}.get(dtype)   # None: fp32
    tol_fwd = TOL[low + '_vs_plain'] if low else TOL['fwd_f32']
    tol_grad = TOL[low + '_vs_plain'] if low else TOL['grad_f32']
    tag = ' '.join([str(dtype)[6:]] + ['causal'] * causal
                   + ([segments] if segments == 'packed' else ['segments'] * segments)
                   + ['misaligned'] * misaligned + ['b=%d s=%d h=%d' % (b, s, h)])
    errs = {}
    before = snapshot(fa)

    o, lse = fa.flash_fwd(q, k, v, seg, causal, scale)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, seg, causal, scale)
    errs['flash_fwd'] = check('fwd o [%s]' % tag, o, o_p, tol_fwd)
    live = lse_p > fa.NEG_INF / 2          # fully masked rows: both exactly NEG_INF
    torch.testing.assert_close(lse[~live], lse_p[~live], atol=0, rtol=0)
    check('fwd lse [%s]' % tag, lse[live], lse_p[live], TOL['fwd_f32'])   # f32 either way

    delta = (do.float() * o_p.float()).sum(-1).permute(0, 2, 1).reshape(b * h, s).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, lse_p, delta, seg, causal, scale)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, seg, causal, scale)
    errs['flash_bwd_dq'] = check('dq [%s]' % tag, dq, dq_p, tol_grad)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_p, delta, seg, causal, scale)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, seg, causal, scale)
    errs['flash_bwd_dkv'] = max(check('dk [%s]' % tag, dk, dk_p, tol_grad),
                                check('dv [%s]' % tag, dv, dv_p, tol_grad))
    shares = (share_of_limit(o, o_p, tol_fwd), share_of_limit(dq, dq_p, tol_grad),
              share_of_limit(dk, dk_p, tol_grad), share_of_limit(dv, dv_p, tol_grad))
    check_designs(fa, before, design, tag)

    # The differentiable op (all three kernels) against the dense fp32
    # reference with PyTorch's own autograd.  detach() keeps each tensor's
    # storage, so misaligned inputs stay misaligned.
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = snapshot(fa)
    out = fa.flash_attention(*leaves, causal=causal, segment_ids=seg)
    out.backward(do)
    check_designs(fa, before, design, tag + ', op')
    ref_leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref = fa.full_attention(*ref_leaves, causal=causal, segment_ids=seg)
    ref.backward(do.float())
    e2e = [check('flash_attention out [%s]' % tag, out, ref,
                 TOL[low] if low else TOL['fwd_f32'])]
    for name, a, r in zip('qkv', leaves, ref_leaves):
        e2e.append(check('flash_attention d%s [%s]' % (name, tag), a.grad, r.grad,
                         TOL[low] if low else TOL['grad_f32']))
    torch.cuda.synchronize()
    log('kernels [%s d=%d, on %s]: max err vs plain fwd %.3g dq %.3g dkv %.3g '
        '(share of the limit o %.2f dq %.2f dk %.2f dv %.2f); vs fp32 reference %s'
        % ((tag, d, design, errs['flash_fwd'], errs['flash_bwd_dq'], errs['flash_bwd_dkv'])
           + shares + (' '.join('%.3g' % e for e in e2e),)))
    return errs


def time_ms(fn, flush, iters=20, warmup=3):
    """Mean device time of ``fn()`` with a cold L2 (a 64 MB write between
    calls), from CUDA events around each call.  A ~5 ms device spin
    (``torch.cuda._sleep``, PyTorch's own spin kernel) goes ahead of the
    flush, so the host has enqueued ``fn``'s launches (an autograd call's
    too, which launch from autograd's device thread) before the start event
    fires: the window holds the device's work, not the host's time to launch
    it, which :func:`host_us` measures."""
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        torch.cuda._sleep(10_000_000)
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def host_us(fn, calls=20, rounds=5):
    """Host time of one ``fn()`` call in microseconds, the median over
    ``rounds`` of the mean over ``calls`` back-to-back calls: for a kernel
    wrapper, its Python, its checks, the C entry point (the tensor maps'
    encoding included) and the launch.  The device runs behind the host, so
    no call waits for it."""
    means = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        means.append(1e6 * (time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return float(np.median(means))


def bound(nbytes, flops, flop_rate):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def misaligned_copy(t):
    """A contiguous copy of ``t`` whose data starts 2 bytes past a 16-byte
    boundary: the kernels' route then takes the CUDA-core design."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def phase_timing(fa):
    """Each kernel at the ViT-S/16 shapes (bf16): its device time and its
    host time per call, its plain version's device time, one library call's
    where PyTorch has one, and its bound; each also through its CUDA-core
    design on the same inputs (misaligned copies), timed in turns with the
    tensor-core one."""
    b, s, h, d = (VIT_SHAPE[x] for x in 'bshd')
    q, k, v, do, _ = make_inputs(b, s, h, d, torch.bfloat16, seed=11)
    qm, km, vm, dom = (misaligned_copy(t) for t in (q, k, v, do))
    scale = d ** -0.5
    o, lse = fa.flash_fwd(q, k, v, None, False, scale)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(b * h, s).contiguous()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device='cuda')
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # SDPA's [b, h, s, d] view
    elems, stat = b * s * h * d * 2, b * h * s * 4       # bytes of one tensor, of lse/delta
    pair = b * h * s * s * d                             # one s x s x d product = 2*pair flops
    # Operations the function needs, whatever the design: the tensor-core
    # kernels' hi/lo products of P and dS are not counted.
    cases = [
        ('flash_fwd', lambda: fa.flash_fwd(q, k, v, None, False, scale),
         lambda: fa.flash_fwd(qm, km, vm, None, False, scale),
         lambda: fa.flash_fwd_plain(q, k, v, None, False, scale),
         lambda: F.scaled_dot_product_attention(qt, kt, vt),
         4 * elems + stat, 4 * pair),
        ('flash_bwd_dq', lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, None, False, scale),
         lambda: fa.flash_bwd_dq(qm, km, vm, dom, lse, delta, None, False, scale),
         lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, None, False, scale),
         None, 5 * elems + 2 * stat, 6 * pair),
        ('flash_bwd_dkv', lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, None, False, scale),
         lambda: fa.flash_bwd_dkv(qm, km, vm, dom, lse, delta, None, False, scale),
         lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, None, False, scale),
         None, 6 * elems + 2 * stat, 8 * pair),
    ]
    rows = {}
    for name, kernel, cuda_core, plain, library, nbytes, flops in cases:
        # in turns: kernel, CUDA-core design, CUDA-core design, kernel
        first, cc1, cc2, last = (time_ms(fn, flush)
                                 for fn in (kernel, cuda_core, cuda_core, kernel))
        ms, cuda_core_ms = (first + last) / 2, (cc1 + cc2) / 2
        first, cc1, cc2, last = (host_us(fn) for fn in (kernel, cuda_core, cuda_core, kernel))
        us, cuda_core_us = (first + last) / 2, (cc1 + cc2) / 2
        plain_ms = time_ms(plain, flush)
        library_ms = time_ms(library, flush) if library is not None else None
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOP_PER_S)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by, cuda_core_ms=cuda_core_ms,
                          host_us=us, cuda_core_host_us=cuda_core_us)
        log('time %s @ b=%d s=%d h=%d d=%d bf16: kernel %.4f ms (%s), CUDA-core design '
            '%.4f ms (%.1fx), plain %.4f ms, library %s, bound %.4f ms (%s; %.1f MB, '
            '%.2f GFLOP); host per call %.1f us, CUDA-core design %.1f us'
            % (name, b, s, h, d, ms, MAIN_PATH_DESIGN[name], cuda_core_ms, cuda_core_ms / ms,
               plain_ms, 'n/a' if library_ms is None else '%.4f ms' % library_ms,
               bound_ms, bound_by, nbytes / 1e6, flops / 1e9, us, cuda_core_us))
    # No PyTorch call computes dQ or dK/dV alone, but the fused attention
    # backward computes all three in one call: the yardstick for the sum
    # of the two backward kernels.
    leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves)
    library_bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, do.transpose(1, 2),
                                                         retain_graph=True), flush)
    log('time SDPA backward (dQ, dK, dV in one call) @ b=%d s=%d h=%d d=%d bf16: %.4f ms; '
        'flash_bwd_dq + flash_bwd_dkv: %.4f ms'
        % (b, s, h, d, library_bwd_ms, rows['flash_bwd_dq']['ms'] + rows['flash_bwd_dkv']['ms']))
    return rows


def phase_timing_lm(fa):
    """Each kernel at L1's shapes (bf16, causal): its device time, its plain
    version's, PyTorch's causal fused attention for the forward, and its
    bound, whose operations count the causal pairs only (s(s+1)/2 a row)."""
    b, s, h, d = (LM_SHAPE[x] for x in 'bshd')
    q, k, v, do, _ = make_inputs(b, s, h, d, torch.bfloat16, seed=12)
    scale = d ** -0.5
    o, lse = fa.flash_fwd(q, k, v, None, True, scale)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(b * h, s).contiguous()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device='cuda')
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    elems, stat = b * s * h * d * 2, b * h * s * 4
    pair = b * h * d * s * (s + 1) // 2
    cases = [
        ('flash_fwd', lambda: fa.flash_fwd(q, k, v, None, True, scale),
         lambda: fa.flash_fwd_plain(q, k, v, None, True, scale),
         lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
         4 * elems + stat, 4 * pair),
        ('flash_bwd_dq', lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, None, True, scale),
         lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, None, True, scale),
         None, 5 * elems + 2 * stat, 6 * pair),
        ('flash_bwd_dkv', lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, None, True, scale),
         lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, None, True, scale),
         None, 6 * elems + 2 * stat, 8 * pair),
    ]
    rows = {}
    for name, kernel, plain, library, nbytes, flops in cases:
        # in turns: kernel, plain version, kernel
        first, plain_ms, last = (time_ms(fn, flush) for fn in (kernel, plain, kernel))
        ms = (first + last) / 2
        library_ms = time_ms(library, flush) if library is not None else None
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOP_PER_S)
        rows[name] = dict(shape='b=%d s=%d h=%d d=%d bf16 causal' % (b, s, h, d), ms=ms,
                          plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        log('time %s @ L1 b=%d s=%d h=%d d=%d bf16 causal: kernel %.4f ms (%.4f / %.4f), plain '
            '%.4f ms, library %s, bound %.4f ms (%s; %.1f MB, %.2f GFLOP)'
            % (name, b, s, h, d, ms, first, last, plain_ms,
               'n/a' if library_ms is None else '%.4f ms' % library_ms, bound_ms, bound_by,
               nbytes / 1e6, flops / 1e9))
    leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    library_bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, do.transpose(1, 2),
                                                         retain_graph=True), flush)
    log('time SDPA causal backward @ L1: %.4f ms; flash_bwd_dq + flash_bwd_dkv: %.4f ms'
        % (library_bwd_ms, rows['flash_bwd_dq']['ms'] + rows['flash_bwd_dkv']['ms']))
    return rows


def phase_timing_repair(fa):
    """Each kernel where only its CUDA-core design runs: head_dim 256 in fp32
    and bf16, and fp16 at head_dim 64 and 256, non-causal at b=4, s=1024,
    h=4; its device time, its plain version's, PyTorch's fused attention for
    the forward, and its bound (operations at 989 TFLOP/s for bf16 and fp16,
    at 67 TFLOP/s for fp32, the rate outside the tensor cores).  Returns
    ``{kernel: [row per case]}``."""
    b, s, h = (REPAIR_TIME_SHAPE[x] for x in 'bsh')
    flush = torch.empty(64 << 20, dtype=torch.uint8, device='cuda')
    rows = {name: [] for name in ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')}
    for dtype, d in ((torch.float32, 256), (torch.bfloat16, 256), (torch.float16, 64),
                     (torch.float16, 256)):
        q, k, v, do, _ = make_inputs(b, s, h, d, dtype, seed=13)
        scale = d ** -0.5
        o, lse = fa.flash_fwd(q, k, v, None, False, scale)
        delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(b * h, s).contiguous()
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        elems, stat = b * s * h * d * q.element_size(), b * h * s * 4
        pair = b * h * s * s * d
        rate = F32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
        cases = [
            ('flash_fwd', lambda: fa.flash_fwd(q, k, v, None, False, scale),
             lambda: fa.flash_fwd_plain(q, k, v, None, False, scale),
             lambda: F.scaled_dot_product_attention(qt, kt, vt), 4 * elems + stat, 4 * pair),
            ('flash_bwd_dq', lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, None, False, scale),
             lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, None, False, scale),
             None, 5 * elems + 2 * stat, 6 * pair),
            ('flash_bwd_dkv',
             lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, None, False, scale),
             lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, None, False, scale),
             None, 6 * elems + 2 * stat, 8 * pair),
        ]
        before = snapshot(fa)
        for name, kernel, plain, library, nbytes, flops in cases:
            first, plain_ms, last = (time_ms(fn, flush, iters=10) for fn in (kernel, plain, kernel))
            library_ms = time_ms(library, flush, iters=10) if library is not None else None
            bound_ms, bound_by = bound(nbytes, flops, rate)
            shape = 'b=%d s=%d h=%d d=%d %s' % (b, s, h, d, str(dtype)[6:])
            rows[name].append(dict(shape=shape, ms=(first + last) / 2, plain_ms=plain_ms,
                                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by))
            log('time %s @ %s (CUDA-core design): kernel %.4f ms (%.4f / %.4f), plain %.4f ms, '
                'library %s, bound %.4f ms (%s; %.1f MB, %.2f GFLOP at %.0f TFLOP/s)'
                % (name, shape, (first + last) / 2, first, last, plain_ms,
                   'n/a' if library_ms is None else '%.4f ms' % library_ms, bound_ms, bound_by,
                   nbytes / 1e6, flops / 1e9, rate / 1e12))
        check_designs(fa, before, 'cuda_core', 'repair timing d=%d %s' % (d, dtype))
    return rows


def phase_model(fa):
    """ViT-S/16 logits through the kernels vs through the dense reference."""
    from petastorm_tpu_torch.models.vit import ViT
    from petastorm_tpu_torch.train import VIT_S16
    model = ViT(generator=torch.Generator().manual_seed(3), **VIT_S16).cuda()
    images = torch.rand(4, 224, 224, 3, generator=torch.Generator().manual_seed(4)).cuda()
    with torch.no_grad():
        logits = model(images)
        for block in model.blocks:
            block.attn.attn_fn = fa.full_attention
        ref = model(images)
    if not torch.isfinite(logits).all():
        raise AssertionError('ViT logits are not finite')
    err = check('ViT-S/16 logits (kernels vs dense reference, bf16)', logits, ref, TOL['bf16'])
    log('model: ViT-S/16 logits %s, kernels vs dense reference max err %.3g'
        % (tuple(logits.shape), err))


def write_dataset(url, rows=IMAGE_ROWS, seed=0):
    """Synthetic ImageNet-like JPEG Parquet: RGB images at mixed sizes (most
    not 224x224, so the transform's resize runs) and a string noun_id."""
    import cv2
    import pyarrow as pa
    from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('ImagenetSchema', [
        UnischemaField('noun_id', np.str_, (), ScalarCodec(pa.string()), False),
        UnischemaField('image', np.uint8, (None, None, 3), CompressedImageCodec('jpeg'), False)])
    rng = np.random.default_rng(seed)
    sizes = [(224, 224), (256, 256), (300, 200), (180, 240)]
    with DatasetWriter(url, schema, rows_per_rowgroup=64) as writer:
        for i in range(rows):
            h, w = sizes[i % len(sizes)]
            # smooth content plus noise: JPEG sizes like photographs', not like noise
            img = cv2.resize(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8), (w, h),
                             interpolation=cv2.INTER_CUBIC)
            img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
            writer.write({'noun_id': 'n%08d' % rng.integers(0, 1000), 'image': img})


def phase_main_path(fa, url, tmp):
    from petastorm_tpu_torch.train import train

    def run(steps=STEPS, **kwargs):
        return train(url, steps=steps, batch_size=BATCH, model_name='vit', **kwargs)
    reset_counts(fa)
    result = run()
    launches, by_design = counts(fa)
    check_main_path(result, launches, by_design)
    eager_beside(fa, 'vit', run, result, launches)
    SUMMARY['vit']['profile'] = phase_profile(lambda n: run(n), 'vit', tmp)
    SUMMARY['vit']['profile_eager'] = phase_profile(lambda n: run(n, cuda_graph=False),
                                                  'vit eager', tmp)
    eager_vs_graphed(fa, 'vit', lambda **kw: run(EQ_STEPS, **kw))
    return launches


def check_main_path(result, launches, by_design):
    losses = result['losses']
    log('main path: steps=%d final loss=%.4f images/s=%.1f step_ms=%.2f host_ms=%.3f (over steps '
        '3..%d, graphed: %s) data_wait_ms=%.2f (steps 3..%d) launches=%s'
        % (result['steps'], losses[-1], result['images_per_s'], result['step_ms'],
           result['host_ms'], STEPS, result['cuda_graph'], result['data_wait_ms'], STEPS - 1,
           launches))
    log('launches by design: %s' % by_design)
    log('losses: %s' % ' '.join('%.4f' % x for x in losses))
    if not np.all(np.isfinite(losses)):
        raise AssertionError('non-finite training loss: %s' % losses)
    if result['batch_devices'] != ['cuda']:
        raise AssertionError('batches reached the model on %s' % result['batch_devices'])
    # 12 encoder blocks, one attention call each per step
    check_launches('main path', launches, by_design, {name: 12 * STEPS for name in launches})


def _family(name):
    """Kernel family of a CUDA kernel name, for the time breakdown."""
    for key in ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv'):
        if key + '_kernel' in name:
            return key
    lowered = name.lower()
    # cuDNN's convolutions are implicit GEMMs: named by pass before matmul
    if any(k in lowered for k in ('conv', 'fprop', 'dgrad', 'wgrad')):
        return 'conv'
    if any(k in lowered for k in ('nvjet', 'gemm', 'cutlass', 'sm90_xmma')):
        return 'matmul'
    for key in ('reduce', 'elementwise', 'memcpy', 'memset'):
        if key in lowered:
            return key
    return 'other'


def _step_starts(trace, events):
    """``(device time, host time)`` at which each profiled step starts: the
    first device event launched from inside each ``train_step`` range of
    the host (matched by the launch's correlation id; every kernel of a
    graph replay carries its graph launch's), and the range's start.  Only
    the training thread's calls count: the loader's transfer thread copies
    meanwhile."""
    main_tid = _step_tid(trace)
    device_ts = {}
    for e in events:
        c = e.get('args', {}).get('correlation')
        if c is not None:
            device_ts[c] = min(e['ts'], device_ts.get(c, e['ts']))
    launches = sorted((e['ts'], e['args']['correlation']) for e in trace
                      if e.get('cat') in ('cuda_runtime', 'cuda_driver') and e['tid'] == main_tid
                      and e.get('args', {}).get('correlation') in device_ts)
    starts = []
    for step in sorted((e for e in trace if e.get('cat') == 'user_annotation'
                        and e['name'] == 'train_step'), key=lambda e: e['ts']):
        inside = [device_ts[c] for t, c in launches if step['ts'] <= t <= step['ts'] + step['dur']]
        if inside:
            starts.append((min(inside), step['ts']))
    return starts


def _step_tid(trace):
    """The training thread's id in a profile: that of its ``train_step``
    ranges."""
    tids = {e['tid'] for e in trace
            if e.get('cat') == 'user_annotation' and e['name'] == 'train_step'}
    if len(tids) != 1:
        raise AssertionError('train_step ranges on %d threads' % len(tids))
    return tids.pop()


def phase_profile(run, label, tmp, steps=8):
    """Where the time of a training step goes: ``run(steps)``, a short
    training run, under torch.profiler (host and device activity).  Over
    steps 3..steps-1 (:func:`_step_starts` finds where each starts on the
    device and on the host): the device busy time per step and its split by
    kernel family, the kernels per step, and on the host the time per step
    inside CUDA launch calls (kernel launches and graph launches, also
    counted apart; a graph launch waits while the device is still busy with
    earlier work) and inside calls that wait for the device (synchronize,
    blocking copies).  Returns the numbers per step."""
    from torch.profiler import ProfilerActivity, profile
    path = os.path.join(tmp, 'trace_%s.json' % label.replace(' ', '_'))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(steps)
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)['traceEvents']
    events = [e for e in trace if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')]
    main_tid = _step_tid(trace)
    # the training thread's calls (the transfer thread waits on its own events)
    runtime = [e for e in trace if e.get('cat') in ('cuda_runtime', 'cuda_driver')
               and e['tid'] == main_tid]
    events.sort(key=lambda e: e['ts'])
    starts = _step_starts(trace, events)
    if len(starts) != steps:
        raise AssertionError('profile %s: found %d step starts for %d steps'
                             % (label, len(starts), steps))
    (lo, host_lo), (hi, host_hi) = starts[2], starts[-1]
    busy, end, families, names = 0.0, lo, {}, {}
    for e in events:
        t0, t1 = max(e['ts'], lo), min(e['ts'] + e['dur'], hi)
        if t1 <= t0:
            continue
        family = _family(e['name'])
        families[family] = families.get(family, 0.0) + (t1 - t0)
        names[e['name']] = names.get(e['name'], 0.0) + (t1 - t0)
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    n = len(starts) - 3
    kernels = sum(1 for e in events if e.get('cat') == 'kernel' and lo <= e['ts'] < hi)
    launch_us = wait_us = 0.0
    graph_launches = kernel_launches = 0
    launched = {}    # device kernel name -> launches from the host (not by a graph)
    kernel_name = {e['args']['correlation']: e['name'] for e in events
                   if e.get('cat') == 'kernel' and 'correlation' in e.get('args', {})}
    for e in runtime:   # the host's calls from the start of step 3 to that of the last
        if host_lo <= e['ts'] < host_hi:
            if 'Launch' in e['name']:
                launch_us += e.get('dur', 0)
                if 'GraphLaunch' in e['name']:
                    graph_launches += 1
                else:
                    kernel_launches += 1
                    name = kernel_name.get(e.get('args', {}).get('correlation'), '?')
                    launched[name] = launched.get(name, 0) + 1
            elif 'Synchronize' in e['name'] or e['name'] in ('cudaMemcpy', 'cuMemcpy'):
                wait_us += e.get('dur', 0)
    log('profile %s (steps 3..%d under torch.profiler, %.2f ms per step): device busy %.2f ms '
        'per step (%.1f%%); kernel time by family, ms per step: %s'
        % (label, steps - 1, (hi - lo) / n / 1e3, busy / n / 1e3, 100.0 * busy / (hi - lo),
           ', '.join('%s %.2f' % (k, v / n / 1e3)
                     for k, v in sorted(families.items(), key=lambda kv: -kv[1]))))
    longest = {}
    for name, t in sorted(names.items(), key=lambda kv: -kv[1]):
        longest.setdefault(_family(name), (name, t))
    short = lambda name: name.replace('void ', '').replace('at::native::', '')[:100]  # noqa: E731
    log('profile %s: the 6 kernels with the most time, ms per step: %s'
        % (label, '; '.join('%s %.2f' % (short(k), v / n / 1e3) for k, v in
                            sorted(names.items(), key=lambda kv: -kv[1])[:6])))
    log('profile %s: the longest kernel of each family, ms per step: %s'
        % (label, '; '.join('%s: %s %.2f' % (f, short(k), v / n / 1e3)
                            for f, (k, v) in longest.items())))
    log('profile %s host: %.0f kernels per step; %.3f ms per step in CUDA launch calls (%.1f '
        'graph launches and %.1f kernel launches per step), %.2f ms per step in calls that wait '
        'for the device'
        % (label, kernels / n, launch_us / n / 1e3, graph_launches / n, kernel_launches / n,
           wait_us / n / 1e3))
    if graph_launches:
        log('profile %s host: kernels launched from the host, not by a graph, per step: %s'
            % (label, '; '.join('%s %.1f' % (short(k), v / n) for k, v in launched.items())
               or 'none'))
    return dict(step_ms=(hi - lo) / n / 1e3, busy_ms=busy / n / 1e3,
                busy_pct=100.0 * busy / (hi - lo), kernels=kernels / n,
                launch_ms=launch_us / n / 1e3, graph_launches=graph_launches / n,
                kernel_launches=kernel_launches / n, wait_ms=wait_us / n / 1e3,
                host_launched={k: v / n for k, v in launched.items()})


#: Per path: the graphed run, the eager run beside it, the profile of the
#: graphed run and the eager-against-graphed comparison; printed as JSON.
SUMMARY = {}
#: What each path's result reports per step, for the eager-beside-graphed line.
METRICS = ('images_per_s', 'tokens_per_s', 'step_tokens_per_s', 'step_ms', 'host_ms',
           'data_wait_ms', 'stall_pct')


def _metrics(result):
    return {k: result[k] for k in METRICS if result.get(k) is not None}


def eager_beside(fa, label, run, graphed, graphed_launches):
    """The same run eagerly (``cuda_graph=False``) beside the graphed one:
    the same flash launches, counted as capture x replays on the graphed
    side, and each path's timings side by side."""
    if not graphed['cuda_graph']:
        raise AssertionError('%s: the default run did not replay a graph' % label)
    reset_counts(fa)
    eager = run(cuda_graph=False)
    launches, _ = counts(fa)
    if eager['cuda_graph'] or launches != graphed_launches:
        raise AssertionError('%s: eager run launched %s, graphed %s'
                             % (label, launches, graphed_launches))
    got, want = _metrics(graphed), _metrics(eager)
    log('%s eager vs graphed (same flash launches %s): %s'
        % (label, launches, ', '.join('%s %.2f / %.2f' % (k, want[k], got[k])
                                      for k in METRICS if k in got and k in want)))
    SUMMARY.setdefault(label, {}).update(graphed=got, eager=want)
    if 'loader_metrics' in graphed:   # the streaming paths: through the transfer plane
        h2d = {mode: {k: r['loader_metrics'].get(k, 0) for k in ('h2d_batches', 'h2d_degraded')}
               for mode, r in (('graphed', graphed), ('eager', eager))}
        log('%s transfer plane (graphed / eager): %s' % (label, h2d))
        if not all(n['h2d_batches'] + n['h2d_degraded'] for n in h2d.values()):
            raise AssertionError('%s: a run did not go through the transfer plane: %s'
                                 % (label, h2d))
        SUMMARY[label]['h2d'] = h2d
    return eager


@contextlib.contextmanager
def same_data_order():
    """Every ``make_reader`` of the training entry points reads with one
    decode thread and no row-group shuffle, so that two runs see the same
    batches in the same order (the 8- and 4-thread pools deliver row groups
    in the order their threads finish them)."""
    import petastorm_tpu_torch.train as image_train
    import petastorm_tpu_torch.train_lm as lm_train
    from petastorm_tpu_torch.reader import make_reader

    def ordered(*args, **kwargs):
        kwargs.update(workers_count=1, shuffle_row_groups=False)
        return make_reader(*args, **kwargs)

    image_train.make_reader = lm_train.make_reader = ordered
    try:
        yield
    finally:
        image_train.make_reader = lm_train.make_reader = make_reader


def _differences(a, b):
    """(loss rel diff, number of state tensors that differ, worst relative
    norm of a state tensor's difference) of two results."""
    la, lb = np.asarray(a['losses'], np.float64), np.asarray(b['losses'], np.float64)
    if la.shape != lb.shape:
        raise AssertionError('runs of %d and %d steps' % (len(la), len(lb)))
    loss_rel = float((np.abs(la - lb) / np.abs(lb)).max())
    sa, sb = a['model'].state_dict(), b['model'].state_dict()
    differ, worst = 0, 0.0
    for name, x in sa.items():
        y = sb[name]
        if not torch.equal(x, y):
            differ += 1
            worst = max(worst, float((x.double() - y.double()).norm()
                                     / y.double().norm().clamp_min(1e-30)))
    return loss_rel, differ, worst, len(sa)


def eager_vs_graphed(fa, label, run):
    """``run(cuda_graph=False)`` and ``run(cuda_graph=None)`` from the same
    seeds and data order: the same flash launches, and losses, parameters
    and buffers equal bit for bit (both run the same kernels on the same
    data; the differences are reported when they are not)."""
    results = {}
    with same_data_order():
        for mode, flag in (('eager', False), ('graphed', None)):
            reset_counts(fa)
            results[mode] = run(cuda_graph=flag)
            results[mode + '_launches'] = counts(fa)[0]
        eager, graphed = results['eager'], results['graphed']
        if results['eager_launches'] != results['graphed_launches']:
            raise AssertionError('%s: flash launches eager %s, graphed %s'
                                 % (label, results['eager_launches'], results['graphed_launches']))
        loss_rel, differ, worst, n_state = _differences(graphed, eager)
        row = dict(steps=len(eager['losses']), loss_rel=loss_rel, state_differ=differ,
                   state_rel=worst, state_tensors=n_state,
                   bitwise=loss_rel == 0.0 and differ == 0)
    SUMMARY.setdefault(label, {})['eager_vs_graphed'] = row
    verdict = ('equal bit for bit' if row['bitwise'] else
               'loss off by %.3g (relative), %d of %d state tensors differ, worst %.3g in '
               'relative norm' % (loss_rel, differ, n_state, worst))
    log('%s eager vs graphed, same seeds and data order, %d steps: %s; losses %s'
        % (label, row['steps'], verdict, ' '.join('%.6f' % x for x in graphed['losses'])))
    if not row['bitwise']:
        raise AssertionError('%s: the graphed run is not the eager one bit for bit: %s'
                             % (label, verdict))
    return row


def phase_resnet(fa, url, tmp):
    """ResNet-50 at full width, streaming: the main-path checks, running
    statistics, bf16 against fp32 on the trained weights, and a profile."""
    import copy
    from petastorm_tpu_torch.gpu import augment
    from petastorm_tpu_torch.models.resnet import BatchNorm, ResNet50
    from petastorm_tpu_torch.train import main, train

    def run(steps=STEPS, **kwargs):
        return train(url, steps=steps, batch_size=BATCH, model_name='resnet50', **kwargs)
    reset_counts(fa)
    result = run()
    launches, _ = counts(fa)
    losses = result['losses']
    log('resnet50: steps=%d final loss=%.4f images/s=%.1f step_ms=%.2f host_ms=%.3f (over steps '
        '3..%d, graphed: %s) data_wait_ms=%.2f stall_pct=%.2f (steps 3..%d) flash launches=%s'
        % (result['steps'], losses[-1], result['images_per_s'], result['step_ms'],
           result['host_ms'], STEPS, result['cuda_graph'], result['data_wait_ms'],
           result['stall_pct'], STEPS - 1, launches))
    log('resnet50 losses: %s' % ' '.join('%.4f' % x for x in losses))
    if not np.all(np.isfinite(losses)) or len(losses) != STEPS:
        raise AssertionError('resnet50: losses %s' % losses)
    if result['batch_devices'] != ['cuda']:
        raise AssertionError('resnet50: batches reached the model on %s'
                             % result['batch_devices'])
    if any(launches.values()):
        raise AssertionError('resnet50 launched flash kernels: %s' % launches)
    model = result['model']
    norms = [(name, m) for name, m in model.named_modules() if isinstance(m, BatchNorm)]
    for name, m in norms:
        for stat, init in (('running_mean', 0.0), ('running_var', 1.0)):
            value = getattr(m, stat)
            if value.device.type != 'cuda' or not torch.isfinite(value).all() \
                    or not (value != init).any():
                raise AssertionError('resnet50 %s.%s: not finite or not moved' % (name, stat))
    log('resnet50: %d BatchNorms, running mean and var finite and moved from (0, 1)'
        % len(norms))
    eager_beside(fa, 'resnet50', run, result, launches)

    # bf16 logits against the same weights in fp32, in train mode (batch
    # statistics) on copies, so the trained model's statistics stay put.
    bf16 = copy.deepcopy(model)
    fp32 = ResNet50(dtype=torch.float32).cuda()
    fp32.load_state_dict(model.state_dict())
    g = torch.Generator(device='cuda').manual_seed(6)
    x = augment.normalize(torch.randint(0, 256, (16, 224, 224, 3), generator=g, device='cuda',
                                        dtype=torch.uint8), dtype=torch.float32)
    with torch.no_grad():
        got, want = bf16.train()(x), fp32.train()(x)
        got_eval, want_eval = bf16.eval()(x), fp32.eval()(x)
    torch.cuda.synchronize()
    for tag, a, b in (('train', got, want), ('eval', got_eval, want_eval)):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError('resnet50 %s-mode logits are not finite' % tag)
    share = max_err(got, want) / float(want.abs().max())
    log('resnet50 bf16 vs fp32 logits (same weights, batch 16, train mode): max err %.4g, '
        '%.4f of the largest logit %.4g (limit %.2f); eval mode %.4f'
        % (max_err(got, want), share, float(want.abs().max()), RESNET_BF16_SHARE,
           max_err(got_eval, want_eval) / float(want_eval.abs().max())))
    if share > RESNET_BF16_SHARE:
        raise AssertionError('resnet50 bf16 logits off the fp32 ones by %.4f of the largest'
                             % share)
    SUMMARY['resnet50']['profile'] = phase_profile(lambda n: run(n), 'resnet50', tmp)
    SUMMARY['resnet50']['profile_eager'] = phase_profile(lambda n: run(n, cuda_graph=False),
                                                  'resnet50 eager', tmp)
    eager_vs_graphed(fa, 'resnet50', lambda **kw: run(EQ_STEPS, **kw))
    # the example's --scan-steps 4: chunks of 4 batches, one transfer and one
    # graph launch each, through its command line
    scan = main(['--dataset-url', url, '--steps', str(STEPS), '--batch-size', str(BATCH),
                 '--scan-steps', '4'])
    if scan['steps'] != -(-STEPS // 4) * 4 or not np.all(np.isfinite(scan['losses'])) \
            or scan['batch_devices'] != ['cuda'] or not scan['cuda_graph']:
        raise AssertionError('resnet50 --scan-steps 4: %r' % {
            k: scan[k] for k in ('steps', 'losses', 'batch_devices', 'cuda_graph')})
    log('resnet50 --scan-steps 4: steps=%d final loss=%.4f images/s=%.1f step_ms=%.2f '
        'host_ms=%.3f (chunks 3..%d; host time per step holds the chunk\'s assembly)'
        % (scan['steps'], scan['losses'][-1], scan['images_per_s'], scan['step_ms'],
           scan['host_ms'], -(-STEPS // 4)))
    SUMMARY['resnet50_scan4'] = {'graphed': _metrics(scan)}


def phase_hbm_cache(fa, url, tmp):
    """ResNet-50 from the device cache and a profile of its step, then the
    gathered batches against the host cache at the epoch orders of
    ``jax.random`` reproduced.

    The gather check runs a second ``DeviceInMemDataLoader``, not the one
    ``train`` used: it takes ``deterministic_cache_order=True`` so that its
    cache lines up with the host cache row for row, where ``train``'s cache
    holds the rows in the order the reader's threads finished them.  Its
    reference shares the loaders' cache building and ``random.permutation``,
    so it shows that the on-card gather picks the right rows; that the
    loaders and the permutation equal the JAX package's, bit for bit, is
    held by the CPU tests."""
    from petastorm_tpu_torch import random as prng
    from petastorm_tpu_torch.gpu import DeviceInMemDataLoader, InMemDataLoader
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.train import make_transform, train
    def run(steps=16, **kwargs):
        return train(url, steps=steps, batch_size=BATCH, model_name='resnet50', hbm_cache=True,
                     **kwargs)
    reset_counts(fa)
    result = run()
    losses = result['losses']
    log('hbm cache: steps=%d epochs=%d final loss=%.4f images/s=%.1f step_ms=%.2f host_ms=%.3f '
        '(epoch 2, graphed: %s) stall_pct=%.1f'
        % (result['steps'], result['epochs'], losses[-1], result['images_per_s'],
           result['step_ms'], result['host_ms'], result['cuda_graph'], result['stall_pct']))
    log('hbm cache losses: %s' % ' '.join('%.4f' % x for x in losses))
    if result['steps'] != 16 or result['epochs'] != 2 or len(losses) != 16 \
            or not np.all(np.isfinite(losses)):
        raise AssertionError('hbm cache: %r' % {k: result[k] for k in ('steps', 'epochs',
                                                                       'losses')})
    if result['batch_devices'] != ['cuda']:
        raise AssertionError('hbm cache: batches on %s' % result['batch_devices'])
    eager_beside(fa, 'hbm_cache', run, result, counts(fa)[0])
    profile = phase_profile(lambda n: run(n), 'resnet50 hbm cache', tmp)
    SUMMARY['hbm_cache']['profile'] = profile
    SUMMARY['hbm_cache']['profile_eager'] = phase_profile(
        lambda n: run(n, cuda_graph=False), 'resnet50 hbm cache eager', tmp)
    # Between steps the host launches the graph and nothing of the step: the
    # only kernels it launches itself are the replay's fills of the augment
    # generator's seed and offset, which PyTorch writes before each replay.
    stray = [k for k in profile['host_launched'] if 'fill' not in k.lower()]
    if profile['graph_launches'] != 1 or stray or profile['kernel_launches'] > 2:
        raise AssertionError('hbm cache: %.1f graph launches per profiled step and, from the '
                             'host, %s' % (profile['graph_launches'], profile['host_launched']))
    eager_vs_graphed(fa, 'hbm_cache', run)

    def reader():
        return make_reader(url, schema_fields=['image', 'noun_id'],
                           transform_spec=make_transform((224, 224)), columnar_decode=True,
                           num_epochs=1, workers_count=8)

    # Both caches in the content-defined order, so their rows line up.
    with InMemDataLoader(reader(), BATCH, shuffle=False, drop_last=False,
                         deterministic_cache_order=True, device='cpu') as host:
        rows = list(host)
    rows = {k: torch.cat([b[k] for b in rows]) for k in rows[0]}
    n = len(rows['label'])
    with DeviceInMemDataLoader(reader(), BATCH, num_epochs=2, seed=17,
                               deterministic_cache_order=True) as loader:
        epochs = [outs for _, outs in loader.scan_epochs(lambda c, b: (c, b), None)]
    key = prng.PRNGKey(17)
    for e, outs in enumerate(epochs):
        key, sub = prng.split(key)
        order = torch.from_numpy(prng.permutation(sub, n).astype(np.int64))
        if sorted(order.tolist()) != list(range(n)):
            raise AssertionError('hbm cache: epoch %d order is no permutation' % e)
        steps = n // BATCH
        for name, column in outs.items():
            if column.device.type != 'cuda':
                raise AssertionError('hbm cache: %s gathered on %s' % (name, column.device))
            first = column[0].cpu()
            if not torch.equal(first, rows[name][order[:BATCH]]):
                raise AssertionError('hbm cache: epoch %d first batch %s differs' % (e, name))
            if not torch.equal(column.reshape((steps * BATCH,) + column.shape[2:]).cpu(),
                               rows[name][order[:steps * BATCH]]):
                raise AssertionError('hbm cache: epoch %d %s differs' % (e, name))
    log('hbm cache: %d epochs of %d rows gathered on the card equal the host cache at the '
        'epoch orders (first batch and every batch); each epoch holds every row once'
        % (len(epochs), n))


def phase_lm(fa, tmp):
    """L1: the long-context example's training at its widths, with the
    launches per step checked (4 layers under remat: each block's forward
    runs twice), and a profile of its step."""
    import petastorm_tpu_torch.train_lm as lm
    url = 'file://' + os.path.join(tmp, 'lc_tokens')
    t0 = time.monotonic()
    lm.write_token_dataset(url)
    log('lm dataset: 256 documents of 1024 tokens written in %.1f s' % (time.monotonic() - t0))
    def run(steps=STEPS, **kwargs):
        return lm.train_lm(url, steps=steps, batch_size=8, strategy='flash', **kwargs)
    reset_counts(fa)
    result = run()
    launches, by_design = counts(fa)
    losses = result['losses']
    log('lm (L1): steps=%d final loss=%.4f tokens/s=%.0f step_ms=%.2f host_ms=%.3f (over steps '
        '3..%d, graphed: %s) data_wait_ms=%.2f stall_pct=%.2f (steps 3..%d) launches=%s'
        % (result['steps'], losses[-1], result['tokens_per_s'], result['step_ms'],
           result['host_ms'], STEPS, result['cuda_graph'], result['data_wait_ms'],
           result['stall_pct'], STEPS - 1, launches))
    log('lm losses: %s' % ' '.join('%.4f' % x for x in losses))
    if len(losses) != STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError('lm: losses %s' % losses)
    if result['batch_devices'] != ['cuda']:
        raise AssertionError('lm: batches reached the model on %s' % result['batch_devices'])
    layers = lm.LONG_CONTEXT_LM['num_layers']
    check_launches('lm', launches, by_design,
                   {'flash_fwd': 2 * layers * STEPS, 'flash_bwd_dq': layers * STEPS,
                    'flash_bwd_dkv': layers * STEPS})
    eager_beside(fa, 'lm', run, result, launches)
    SUMMARY['lm']['profile'] = phase_profile(lambda n: run(n), 'lm', tmp)
    SUMMARY['lm']['profile_eager'] = phase_profile(lambda n: run(n, cuda_graph=False),
                                                  'lm eager', tmp)
    SUMMARY['lm']['profile_inline'] = phase_profile(lambda n: run(n, transfer=False),
                                                   'lm inline', tmp)
    eager_vs_graphed(fa, 'lm', lambda **kw: run(EQ_STEPS, **kw))
    return launches


def packed_checks(fa, model, batch, tag):
    """On one packed batch: the flash loss against the dense
    ``packed_attention`` loss on the same weights (bf16 tolerance), and
    every gradient of the flash loss finite and within 3e-2 of the dense
    one's in relative norm."""
    from petastorm_tpu_torch.train_lm import packed_loss
    grads = {}
    for attn in ('flash', 'dense'):
        model.zero_grad(set_to_none=True)
        before = snapshot(fa)
        loss = packed_loss(model, batch, attn)
        loss.backward()
        if attn == 'flash':
            check_designs(fa, before, 'tensor_core', tag)
        grads[attn] = (loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()})
    model.zero_grad(set_to_none=True)
    (flash, g_flash), (dense, g_dense) = grads['flash'], grads['dense']
    err = check('packed loss flash vs dense [%s]' % tag, flash, dense, TOL['bf16'])
    worst = 0.0
    for name, g in g_flash.items():
        if not torch.isfinite(g).all():
            raise AssertionError('packed [%s]: gradient of %s is not finite' % (tag, name))
        ref = g_dense[name]
        rel = float((g - ref).norm() / ref.norm().clamp_min(1e-30))
        worst = max(worst, rel)
        if rel > TOL['bf16'][1]:
            raise AssertionError('packed [%s]: gradient of %s off the dense one by %.4f in '
                                 'relative norm' % (tag, name, rel))
    seg = batch['segment_ids']
    log('packed [%s]: loss flash %.5f dense %.5f (err %.3g); gradients finite, worst relative '
        'norm vs dense %.4f; %d of %d rows all padding, %d padding tokens'
        % (tag, float(flash), float(dense), err, worst, int((seg == 0).all(dim=1).sum()),
           seg.shape[0], int((seg == 0).sum())))


def phase_packed(fa, tmp):
    """L2: the packed example's training through the flash kernels with
    segment ids, then :func:`packed_checks` on a loader batch and on a
    packer's tail batch that holds all-padding rows."""
    import petastorm_tpu_torch.train_lm as lm
    from petastorm_tpu_torch.gpu import PackedDataLoader
    from petastorm_tpu_torch.gpu.packing import StreamPacker
    from petastorm_tpu_torch.reader import make_reader
    url = 'file://' + os.path.join(tmp, 'lc_var_tokens')
    t0 = time.monotonic()
    lm.write_var_token_dataset(url)
    log('packed dataset: 512 documents of 32..512 tokens written in %.1f s'
        % (time.monotonic() - t0))
    def run(steps=STEPS, **kwargs):
        return lm.train_packed(url, steps=steps, attn='flash', **kwargs)
    reset_counts(fa)
    result = run()
    launches, by_design = counts(fa)
    losses = result['losses']
    log('packed (L2): steps=%d final loss=%.4f packing_utilization=%.2f%% tokens/s=%.0f '
        '(real tokens, from opening the reader) step_ms=%.2f host_ms=%.3f tokens/s=%.0f (real '
        'tokens, over steps 3..%d, graphed: %s) launches=%s'
        % (result['steps'], losses[-1], 100 * result['packing_utilization'],
           result['tokens_per_s'], result['step_ms'], result['host_ms'],
           result['step_tokens_per_s'], STEPS, result['cuda_graph'], launches))
    log('packed losses: %s' % ' '.join('%.4f' % x for x in losses))
    if len(losses) != STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError('packed: losses %s' % losses)
    if result['batch_devices'] != ['cuda']:
        raise AssertionError('packed: batches reached the model on %s' % result['batch_devices'])
    layers = lm.PACKED_LM['num_layers']
    check_launches('packed', launches, by_design, {name: layers * STEPS for name in launches})
    model = result['model']
    eager_beside(fa, 'packed', run, result, launches)
    SUMMARY['packed']['profile'] = phase_profile(lambda n: run(n), 'packed', tmp)
    SUMMARY['packed']['profile_eager'] = phase_profile(lambda n: run(n, cuda_graph=False),
                                                  'packed eager', tmp)
    SUMMARY['packed']['profile_inline'] = phase_profile(lambda n: run(n, transfer=False),
                                                       'packed inline', tmp)
    eager_vs_graphed(fa, 'packed', lambda **kw: run(EQ_STEPS, **kw))
    with make_reader(url, schema_fields=['tokens'], num_epochs=1, workers_count=4) as reader:
        batch = next(iter(PackedDataLoader(reader, 'tokens', max_len=lm.PACKED_MAX_LEN,
                                           rows_per_batch=4)))
    packed_checks(fa, model, batch, 'loader batch')
    packer = StreamPacker(lm.PACKED_MAX_LEN, 4)
    rng = np.random.default_rng(9)
    for length in (300, 200, 150):
        packer.add((rng.zipf(1.4, length) % lm.PACKED_VOCAB).astype(np.int32))
    tail = packer.flush()[0]
    if not (tail['segment_ids'] == 0).all(axis=1).any():
        raise AssertionError('packed: the tail batch holds no all-padding row')
    packed_checks(fa, model, {k: torch.from_numpy(v).cuda() for k, v in tail.items()},
                  'tail batch')
    return launches, model


def greedy_check(model, prompt, tag):
    """Greedy tokens against the argmax of a full forward over the growing
    prefix; a token may differ only where the full forward's top logit
    lies within bf16's tolerance of the greedy token's."""
    from petastorm_tpu_torch.models.decoding import generate
    greedy = generate(model, torch.from_numpy(prompt), 16)
    seq = torch.from_numpy(prompt).long().cuda()
    near_ties = 0
    with torch.no_grad():
        for t in range(greedy.shape[1]):
            logits = model(seq)[:, -1]
            top = logits.max(dim=-1).values
            got = greedy[:, t].long()
            for row in (logits.argmax(dim=-1) != got).nonzero().flatten().tolist():
                gap = float(top[row] - logits[row, got[row]])
                if gap > TOL['bf16'][0] + TOL['bf16'][1] * float(top[row].abs()):
                    raise AssertionError('generate [%s]: greedy token %d at step %d row %d is '
                                         '%.4f below the full forward\'s argmax'
                                         % (tag, int(got[row]), t, row, gap))
                near_ties += 1
            seq = torch.cat([seq, got[:, None]], dim=1)
    log('generate [%s]: greedy %s; equal to the stepwise full forward\'s argmax at every step '
        '(%d bf16 near ties)' % (tag, greedy.tolist(), near_ties))


def phase_generate(fa, model):
    """L3: the trained L2 model samples as ``packed_example.py::sample``
    does (one prefill forward launch per layer, then steps against the
    cache),
    repeats exactly under the same key, and :func:`greedy_check` on it
    and on fresh weights."""
    import petastorm_tpu_torch.train_lm as lm
    from petastorm_tpu_torch.models.transformer import TransformerLM
    model.eval()
    reset_counts(fa)
    prompt, tokens = lm.sample(model)
    launches, by_design = counts(fa)
    check_launches('generate', launches, by_design,   # one prefill forward per layer
                   {'flash_fwd': len(model.blocks), 'flash_bwd_dq': 0, 'flash_bwd_dkv': 0})
    log('generate (L3): launches=%s' % launches)
    for row in range(len(prompt)):
        log('  prompt %s -> %s' % (prompt[row].tolist(), tokens[row].tolist()))
    # ms per new token, the graphed token loop and the eager one in turns;
    # every run under the same key samples the same tokens
    per_token = {'graphed': [], 'eager': []}
    for mode in ('graphed', 'eager', 'eager', 'graphed'):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, again = lm.sample(model, cuda_graph=None if mode == 'graphed' else False)
        torch.cuda.synchronize()
        per_token[mode].append(1e3 * (time.perf_counter() - t0) / again.shape[1])
        if not torch.equal(tokens, again):
            raise AssertionError('generate: the %s loop sampled other tokens under the same key'
                                 % mode)
    ms = {mode: float(np.mean(v)) for mode, v in per_token.items()}
    log('generate: ms per new token (prefill of 8 and 16 tokens, batch 2, host clock): eager '
        '%.3f (%s), graphed %.3f (%s); the same tokens from both under the same key'
        % (ms['eager'], ' / '.join('%.3f' % x for x in per_token['eager']), ms['graphed'],
           ' / '.join('%.3f' % x for x in per_token['graphed'])))
    # What one more token costs, without the prefill, the noise and the
    # capture that every call pays: 64 new tokens against 16, in turns.
    totals = {}
    for mode in ('graphed', 'eager', 'eager', 'graphed'):
        for new in (16, 64):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm.sample(model, max_new=new, cuda_graph=None if mode == 'graphed' else False)
            torch.cuda.synchronize()
            totals.setdefault((mode, new), []).append(1e3 * (time.perf_counter() - t0))
    marginal = {mode: (np.mean(totals[mode, 64]) - np.mean(totals[mode, 16])) / 48
                for mode in ('graphed', 'eager')}
    SUMMARY['generate'] = {'ms_per_token': ms, 'runs': per_token,
                           'marginal_ms_per_token': marginal}
    log('generate: marginal ms per new token (64 new tokens against 16): eager %.4f, graphed %.4f'
        % (marginal['eager'], marginal['graphed']))
    if tokens.device.type != 'cuda' or tokens.dtype != torch.int32 or tokens.shape != (2, 16) \
            or not ((tokens >= 0) & (tokens < model.vocab_size)).all():
        raise AssertionError('generate: tokens %s %s %r' % (tokens.device, tokens.dtype,
                                                             tuple(tokens.shape)))
    greedy_check(model, prompt, 'trained')
    # the trained model's greedy choice is nearly always the commonest
    # token; a fresh model's varies from step to step
    fresh = TransformerLM(generator=torch.Generator().manual_seed(1), **lm.PACKED_LM)
    greedy_check(fresh.cuda().eval(), prompt, 'fresh weights')
    return launches


#: The decode-plane runs of the image paths: (label, model, pool, workers,
#: transfer).  ResNet-50 streaming at 8, 4 and 2 decode threads and 8 decode
#: processes, ViT at 8 threads and 8 processes, all through the transfer
#: plane's dispatch thread (``transfer='auto'``); and at 8 threads each with
#: the plane off (``transfer=False``: every put on the training thread),
#: right after its pumped run.  The pairs are traced.
DECODE_RUNS = (
    ('resnet50 thread 8', 'resnet50', 'thread', 8, 'auto'),
    ('resnet50 thread 8 inline', 'resnet50', 'thread', 8, False),
    ('resnet50 thread 4', 'resnet50', 'thread', 4, 'auto'),
    ('resnet50 thread 2', 'resnet50', 'thread', 2, 'auto'),
    ('resnet50 process 8', 'resnet50', 'process', 8, 'auto'),
    ('vit thread 8', 'vit', 'thread', 8, 'auto'),
    ('vit thread 8 inline', 'vit', 'thread', 8, False),
    ('vit process 8', 'vit', 'process', 8, 'auto'),
)
PUMP_PAIRS = ('resnet50 thread 8', 'resnet50 thread 8 inline', 'vit thread 8',
              'vit thread 8 inline')
#: The decode plane alone, without training: (pool, workers).
DECODE_ONLY = (('thread', 8), ('thread', 2), ('thread', 1), ('process', 8), ('process', 4),
               ('process', 1))
#: The decode plane's readings come from a warm pool: each training run
#: takes DECODE_STEPS steps (100 row groups of 64 rows, 12 or more per
#: decode process at 8) and is timed after DECODE_WARMUP of them; the
#: decode-alone runs read DECODE_EPOCHS epochs (96 row groups) and are timed
#: after the first DECODE_WARM_EPOCHS.  A spawned worker's first row group
#: carries its interpreter's imports and first touches, which threads in a
#: warm interpreter never pay.
DECODE_STEPS, DECODE_WARMUP = 100, 20
DECODE_EPOCHS, DECODE_WARM_EPOCHS = 12, 2
#: Native decode against the cv2 and np.load paths, in LSB: JPEG decode
#: (the JAX package's own bound, tests/test_native_decode.py), the fused
#: decode and resize of <= 2x reductions and upscales
#: (tests/test_resize_transform.py); PNG and .npy must be exact.
NATIVE_LSB = {'jpeg_decode': 1, 'jpeg_decode_resize': 2, 'png_decode': 0, 'npy_copy': 0,
              'zlib_npy_decompress': 0}


def live_children():
    """Pids of this process's children that have not exited (``/proc``)."""
    me, out = os.getpid(), []
    for entry in os.listdir('/proc'):
        if not entry.isdigit():
            continue
        try:
            with open('/proc/%s/stat' % entry) as f:
                fields = f.read().rsplit(')', 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me and fields[0] != 'Z':
            out.append(int(entry))
    return out


def jpeg_cells(url):
    """The image column's cells of the JPEG dataset, as bytes, in row order."""
    import pyarrow.parquet as pq
    from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups
    from petastorm_tpu_torch.fs_utils import get_filesystem_and_path
    fs, path = get_filesystem_and_path(url)
    cells = []
    for piece in load_row_groups(fs, path):
        table = pq.ParquetFile(piece.path).read_row_group(piece.row_group, columns=['image'])
        cells.extend(table.column('image').to_pylist())
    return cells


def rows_per_s(fn, rows, rounds=2):
    """Rows per second of ``fn()`` on this thread, the mean over ``rounds``."""
    t0 = time.perf_counter()
    for _ in range(rounds):
        fn()
    return rows * rounds / (time.perf_counter() - t0)


def phase_native_build():
    """Build the native decode plane (g++, at first use, like the flash
    kernels' nvcc), before any path loads it; its seconds, the compiler and
    the functions the library holds.  Absent ones are printed, with the
    paths that then decode with cv2."""
    from petastorm_tpu_torch import native
    gxx = subprocess.run(['g++', '--version'], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    mtime = lambda: os.path.getmtime(native.library_path()) \
        if os.path.exists(native.library_path()) else None  # noqa: E731
    before = mtime()
    t0 = time.monotonic()
    native.get_lib()
    build_s = time.monotonic() - t0
    fresh = mtime() != before
    caps = native.capabilities()
    absent = [name for name in native._SYMBOLS if name not in caps]
    log('native: %s %s in %.2f s by %s; capabilities %s'
        % (native.library_path(), 'built' if fresh else 'loaded (built before)', build_s, gxx,
           caps))
    if absent:
        log('native: ABSENT from the library (their headers were not found): %s; those columns '
            'decode with cv2 or np.load%s' % (absent, ': the JPEG image paths (ViT, ResNet-50, '
                                              'the HBM cache, ResizeImages) decode with cv2'
                                              if 'pt_jpeg_decode_batch' in absent else ''))
    SUMMARY['native'] = dict(build_s=build_s if fresh else None, gxx=gxx, capabilities=caps,
                             absent=absent)


def phase_native(url):
    """The native decode plane: each function the library holds against the
    cv2 or np.load path (``native.disabled()``) on the JPEG dataset's
    images, within :data:`NATIVE_LSB`; host decode rates on one thread; and
    a ``ResizeImages`` read through the columnar reader to the card, which
    must decode through the fused native function where the library holds
    it."""
    import cv2
    from petastorm_tpu_torch import native
    from petastorm_tpu_torch.codecs import (CompressedImageCodec, CompressedNdarrayCodec,
                                            NdarrayCodec)
    from petastorm_tpu_torch.gpu import DataLoader
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.train_transform import FixRow
    from petastorm_tpu_torch.transform import ResizeImages
    from petastorm_tpu_torch.unischema import UnischemaField
    caps = SUMMARY['native']['capabilities']
    cells = jpeg_cells(url)
    codec = CompressedImageCodec('jpeg')
    field = UnischemaField('image', np.uint8, (224, 224, 3), codec, False)
    with native.disabled():
        decoded = [codec.decode(field, c) for c in cells]
    square = [i for i, img in enumerate(decoded) if img.shape[:2] == (224, 224)]
    images = np.stack([decoded[i] for i in square])
    tensor = UnischemaField('x', np.uint8, images.shape[1:], NdarrayCodec(), False)
    png = [cv2.imencode('.png', img[:, :, ::-1])[1].tobytes() for img in images]
    npy = [NdarrayCodec().encode(tensor, img) for img in images]
    zlib_npy = [CompressedNdarrayCodec().encode(tensor, img) for img in images]
    with native.disabled():
        resized = np.empty((len(cells), 224, 224, 3), np.uint8)
        for i, cell in enumerate(cells):
            codec.decode_resized_into(field, cell, resized[i])
        png_ref = np.stack([CompressedImageCodec('png').decode(field, c) for c in png])
        npy_ref = np.stack([NdarrayCodec().decode(tensor, c) for c in npy])
        zlib_ref = np.stack([CompressedNdarrayCodec().decode(tensor, c) for c in zlib_npy])
    cases = [('jpeg_decode', native.jpeg_decode_batch, [cells[i] for i in square], images),
             ('png_decode', native.png_decode_batch, png, png_ref),
             ('npy_copy', native.npy_copy_batch, npy, npy_ref),
             ('zlib_npy_decompress', native.zlib_npy_decompress_batch, zlib_npy, zlib_ref),
             ('jpeg_decode_resize', native.jpeg_decode_resize_batch, cells, resized)]
    checks = {}
    for name, fn, batch_cells, ref in cases:
        if 'pt_' + name + '_batch' not in caps:
            checks[name] = 'absent'
            log('native %s: absent from the library, not checked' % name)
            continue
        got = np.empty_like(ref)
        if not fn(batch_cells, got):
            raise AssertionError('native %s rejected the batch' % name)
        err = int(np.abs(got.astype(np.int16) - ref.astype(np.int16)).max())
        if err > NATIVE_LSB[name]:
            raise AssertionError('native %s: %d LSB off the cv2 / np.load path (limit %d)'
                                 % (name, err, NATIVE_LSB[name]))
        checks[name] = err
        log('native %s: %d rows, max %d LSB off the cv2 / np.load path (limit %d)'
            % (name, len(ref), err, NATIVE_LSB[name]))
    # Host decode on one thread, rows/s: what the image paths run per row
    # (cv2 decode and the example's fix_row), and the native batch calls.
    fix = FixRow((224, 224))
    rates = {'cv2_fix_row': rows_per_s(
        lambda: [fix({'image': codec.decode(field, c), 'noun_id': 'n0'}) for c in cells],
        len(cells))}
    for name, fn, batch_cells, ref in (cases[0], cases[-1]):
        rates[name] = rows_per_s(lambda: fn(batch_cells, np.empty_like(ref)), len(ref)) \
            if checks[name] != 'absent' else None
    log('native: host decode rows/s on one thread: cv2 per cell + fix_row %.1f; native batch '
        '(224x224 rows) %s; native fused decode + resize %s'
        % (rates['cv2_fix_row'], *('%.1f' % rates[k] if rates[k] else 'absent'
                                   for k in ('jpeg_decode', 'jpeg_decode_resize'))))
    # ResizeImages through the columnar reader and the loader to the card.
    before = native.calls['jpeg_decode_resize_batch']
    reader = make_reader(url, schema_fields=['image'], columnar_decode=True, num_epochs=1,
                         transform_spec=ResizeImages({'image': (224, 224)}), workers_count=8)
    t0, rows = time.perf_counter(), 0
    with DataLoader(reader, batch_size=BATCH, drop_last=False) as loader:
        for batch in loader:
            rows += batch['image'].shape[0]
            if batch['image'].shape[1:] != (224, 224, 3) or batch['image'].device.type != 'cuda':
                raise AssertionError('ResizeImages batch %s on %s' % (
                    tuple(batch['image'].shape), batch['image'].device))
    torch.cuda.synchronize()
    resize_rate = rows / (time.perf_counter() - t0)
    fused = native.calls['jpeg_decode_resize_batch'] - before
    log('native: ResizeImages((224, 224)) columnar read of %d rows to the card, 8 threads: %.1f '
        'images/s (first epoch, reader start included); %d row groups through the fused native '
        'function' % (rows, resize_rate, fused))
    if rows != len(cells):
        raise AssertionError('ResizeImages read %d of %d rows' % (rows, len(cells)))
    if 'pt_jpeg_decode_resize_batch' in caps and fused == 0:
        raise AssertionError('ResizeImages: no row group went through the fused native function')
    SUMMARY['native'].update(max_lsb=checks, rows_per_s_one_thread=rates,
                             resize_images=dict(images_per_s=resize_rate, native_batches=fused))


def check_process_run(label, diag):
    """A process-pool run (``diag``: its reader's diagnostics): its batches
    came through /dev/shm (where the host has a usable one), and it left no
    slab of its workers and no child behind."""
    from petastorm_tpu_torch.workers_pool import shm_plane
    if shm_plane.available() and not diag['shm_results']:
        raise AssertionError('%s: no batch came through /dev/shm' % label)
    left = shm_plane.residue(diag['worker_pids'])
    if left or live_children():
        raise AssertionError('%s: left slabs %s and children %s' % (label, sorted(left),
                                                                    live_children()))


class Puts(list):
    """Seconds of each put to the card (``TransferPlane.put``, or
    ``put_inline`` where the plane is off or a structure degrades: the
    host's copy into pinned memory and the copy's dispatch), in order;
    ``stage_s``, those of each coalesced put's packing into its slab (the
    ``h2d/stage`` window), ``wait_s``, of its wait for the copy that last
    read its ring slab (the ring's ``h2d/commit``), and ``copy_s``, from the
    end of its packing to the start of its unpack on the card (the
    ``non_blocking`` copy call); ``threads``, the threads they ran on."""

    def __init__(self):
        super().__init__()
        self.stage_s = []
        self.wait_s = []
        self.copy_s = []
        self.threads = set()
        self.packed_at = threading.local()

    def ms(self, skip=0, part=None):
        values = (getattr(self, part + '_s') if part else self)[skip:]
        return 1e3 * float(np.mean(values)) if values else None

    def on(self):
        """Where the puts ran: 'consumer' (this thread) or 'pump'."""
        me = threading.get_ident()
        return '+'.join(sorted({'consumer' if t == me else 'pump' for t in self.threads}))


@contextlib.contextmanager
def timed_puts():
    """:class:`Puts` of the puts made inside.  With the transfer plane on
    they run on the loader's dispatch thread, beside the training thread's
    data wait and not inside it; with it off, on the training thread."""
    from petastorm_tpu_torch.gpu import transfer
    puts = Puts()
    originals = {name: getattr(transfer.TransferPlane, name) for name in ('put', 'put_inline')}
    pack, wait = transfer._Layout.pack, transfer.TransferPlane._wait_slot
    unpack = transfer._Layout.unpack

    def timed(fn):
        def wrapper(plane, batch):
            t0 = time.perf_counter()
            out = fn(plane, batch)
            if out is not None:
                puts.append(time.perf_counter() - t0)
                puts.threads.add(threading.get_ident())
            return out
        return wrapper

    def timed_pack(layout, leaves, slab):
        t0 = time.perf_counter()
        pack(layout, leaves, slab)
        puts.packed_at.t = time.perf_counter()
        puts.stage_s.append(puts.packed_at.t - t0)

    def timed_unpack(layout, slab):
        packed_at = getattr(puts.packed_at, 't', None)
        if packed_at is not None:   # a ring put (put_once copies on this stream)
            puts.copy_s.append(time.perf_counter() - packed_at)
            puts.packed_at.t = None
        return unpack(layout, slab)

    def timed_wait(plane, slot):
        t0 = time.perf_counter()
        out = wait(plane, slot)
        puts.wait_s.append(time.perf_counter() - t0)
        return out
    for name, fn in originals.items():
        setattr(transfer.TransferPlane, name, timed(fn))
    transfer._Layout.pack, transfer.TransferPlane._wait_slot = timed_pack, timed_wait
    transfer._Layout.unpack = timed_unpack
    try:
        yield puts
    finally:
        for name, fn in originals.items():
            setattr(transfer.TransferPlane, name, fn)
        transfer._Layout.pack, transfer.TransferPlane._wait_slot = pack, wait
        transfer._Layout.unpack = unpack


def busy_ms(diag):
    """A process pool's busy ms per row group: over every item, and over the
    items after each worker's first (the warm pool's); None for the other pools."""
    if diag.get('pool') != 'process' or not diag.get('items_processed'):
        return None, None
    return (1e3 * diag['busy_time'] / diag['items_processed'],
            1e3 * diag['warm_busy_time'] / diag['warm_items'] if diag['warm_items'] else None)


def decode_only(url, pool, workers):
    """The image paths' reader (the example's transform, ``pool`` with
    ``workers``) through the loader to the card for DECODE_EPOCHS epochs,
    with no training, timed after the first DECODE_WARM_EPOCHS: images/s,
    the host's copy of each batch into pinned memory (:func:`timed_puts`),
    and the process pool's busy ms per row group."""
    from petastorm_tpu_torch.gpu import DataLoader
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.train import make_transform
    warm_batches = DECODE_WARM_EPOCHS * IMAGE_ROWS // BATCH
    with timed_puts() as put_s:
        reader = make_reader(url, schema_fields=['image', 'noun_id'], columnar_decode=True,
                             num_epochs=DECODE_EPOCHS, transform_spec=make_transform((224, 224)),
                             reader_pool_type=pool, workers_count=workers)
        rows, t0 = 0, None
        with DataLoader(reader, batch_size=BATCH, device='cuda') as loader:
            for i, batch in enumerate(loader):
                if i == warm_batches:
                    torch.cuda.synchronize()
                    t0, rows = time.perf_counter(), 0
                rows += batch['image'].shape[0]
        torch.cuda.synchronize()
    diag = reader.diagnostics
    busy, warm_busy = busy_ms(diag)
    return dict(images_per_s=rows / (time.perf_counter() - t0),
                put_ms=put_s.ms(warm_batches), put_on=put_s.on(), diag=diag,
                shm_results=diag.get('shm_results'), busy_ms_per_row_group=busy,
                warm_busy_ms_per_row_group=warm_busy)


def phase_decode_plane(fa, url, lm_url, packed_url, tmp):
    """First the decode plane alone (:func:`decode_only` for each of
    :data:`DECODE_ONLY`), then graphed runs of DECODE_STEPS steps on the
    same data with another decode plane each (:data:`DECODE_RUNS`, timed
    after DECODE_WARMUP steps; L1 with the native plane and under
    ``native.disabled()``, timed after train_lm's own 2; L1 and L2 also
    with the transfer plane off): images/s or tokens/s, step, host and
    data-wait ms, ``stall_pct``, the put's ms per step in the same window and
    the thread it ran on (with the plane on, the dispatch thread: beside the
    data wait, not inside it) and its slab packing (``h2d/stage``), the
    process pool's busy ms per row group, the results that came through
    /dev/shm, and for the traced pumped/inline pairs the stall's top
    component and the advisor's regime.  Each run is a path of its own: its
    flash launches are counted from 0 and checked."""
    import petastorm_tpu_torch.train_lm as lm
    from petastorm_tpu_torch import native
    from petastorm_tpu_torch.train import train
    from petastorm_tpu_torch.workers_pool import shm_plane
    import cv2
    import zmq
    log('decode plane: %d host cores (%d usable by this process); /dev/shm %s; pyzmq %s; cv2 %s '
        '(%d threads of its own)'
        % (os.cpu_count(), len(os.sched_getaffinity(0)),
           'usable' if shm_plane.available() else 'NOT usable: every result takes the byte path',
           zmq.__version__, cv2.__version__, cv2.getNumThreads()))
    alone = {}
    for pool, workers in DECODE_ONLY:
        label = '%s %d' % (pool, workers)
        alone[label] = row = decode_only(url, pool, workers)
        diag = row.pop('diag')
        if pool == 'process':
            check_process_run('decode alone, ' + label, diag)
        log('decode plane alone [%s] (no training, %d epochs to the card, timed after %d): %.1f '
            'images/s; put to the card %.2f ms per batch (on the %s thread); %s'
            % (label, DECODE_EPOCHS, DECODE_WARM_EPOCHS, row['images_per_s'], row['put_ms'],
               row['put_on'],
               'busy %.1f ms per row group of 64 (%.1f after each worker\'s first), '
               'shm_results %d' % (row['busy_ms_per_row_group'],
                                   row['warm_busy_ms_per_row_group'], row['shm_results'])
               if pool == 'process' else 'decode in this process'))
    SUMMARY['decode_alone'] = alone
    rows = {}

    def record(label, result, launches, steps, warmup, put_s, transfer):
        if not result['cuda_graph'] or result['batch_devices'] != ['cuda'] \
                or not np.all(np.isfinite(result['losses'])) or len(result['losses']) != steps:
            raise AssertionError('%s: %r' % (label, {k: result[k] for k in (
                'cuda_graph', 'batch_devices', 'losses')}))
        h2d = {k: result['loader_metrics'].get(k, 0) for k in ('h2d_batches', 'h2d_degraded')}
        if (put_s.on() == 'pump') != (transfer == 'auto') \
                or (transfer == 'auto') != bool(h2d['h2d_batches'] + h2d['h2d_degraded']):
            raise AssertionError('%s (transfer=%r): puts on the %s thread, %s'
                                 % (label, transfer, put_s.on(), h2d))
        diag = result['reader_diagnostics']
        busy, warm_busy = busy_ms(diag)
        # the puts from the warm-up on (the loader yields a batch `prefetch`
        # batches after its put)
        rows[label] = dict(_metrics(result), transfer=transfer, put_ms=put_s.ms(warmup),
                           put_on=put_s.on(), stage_ms=put_s.ms(warmup, 'stage'),
                           ring_wait_ms=put_s.ms(warmup, 'wait'),
                           copy_call_ms=put_s.ms(warmup, 'copy'),
                           shm_results=diag.get('shm_results'), busy_ms_per_row_group=busy,
                           warm_busy_ms_per_row_group=warm_busy, launches=launches,
                           stall_top_component=result.get('stall_top_component'),
                           regime=(result.get('diagnosis') or {}).get('regime'), **h2d)
        row = rows[label]
        rate = result.get('images_per_s') or result.get('tokens_per_s')
        log('decode plane [%s] (%d steps, timed after %d): %s/s %.1f step_ms %.2f host_ms %.3f '
            'data_wait_ms %.2f stall_pct %.2f; put %.2f ms per batch on the %s thread (slab '
            'packing %s ms, ring wait %s ms, copy call %s ms); h2d_batches %d h2d_degraded %d; '
            'stall top %s regime %s; shm_results %s busy_ms per row group %s (warm %s) '
            'launches %s'
            % (label, steps, warmup, 'images' if 'images_per_s' in result else 'tokens', rate,
               result['step_ms'], result['host_ms'], result['data_wait_ms'],
               result['stall_pct'], row['put_ms'], row['put_on'],
               None if row['stage_ms'] is None else '%.2f' % row['stage_ms'],
               None if row['ring_wait_ms'] is None else '%.2f' % row['ring_wait_ms'],
               None if row['copy_call_ms'] is None else '%.2f' % row['copy_call_ms'],
               h2d['h2d_batches'], h2d['h2d_degraded'], row['stall_top_component'],
               row['regime'], diag.get('shm_results'),
               None if busy is None else '%.1f' % busy,
               None if warm_busy is None else '%.1f' % warm_busy, launches))

    for label, model, pool, workers, transfer in DECODE_RUNS:
        reset_counts(fa)
        trace = os.path.join(tmp, label.replace(' ', '_') + '.json') \
            if label in PUMP_PAIRS else None
        with timed_puts() as put_s:
            result = train(url, steps=DECODE_STEPS, batch_size=BATCH, model_name=model,
                           reader_pool_type=pool, workers_count=workers,
                           warmup_steps=DECODE_WARMUP, transfer=transfer, trace_path=trace)
        launches, by_design = counts(fa)
        check_launches(label, launches, by_design,
                       {name: (12 * DECODE_STEPS if model == 'vit' else 0) for name in launches})
        if pool == 'process':
            check_process_run(label, result['reader_diagnostics'])
        record(label, result, launches, DECODE_STEPS, DECODE_WARMUP, put_s, transfer)
    layers = lm.LONG_CONTEXT_LM['num_layers']
    for label, plane, transfer in (('lm native', contextlib.nullcontext(), 'auto'),
                                   ('lm native inline', contextlib.nullcontext(), False),
                                   ('lm disabled', native.disabled(), 'auto')):
        before = native.calls['npy_copy_batch']
        reset_counts(fa)
        with plane, timed_puts() as put_s:
            result = lm.train_lm(lm_url, steps=DECODE_STEPS, batch_size=8, strategy='flash',
                                 transfer=transfer)
        launches, by_design = counts(fa)
        check_launches(label, launches, by_design,
                       {'flash_fwd': 2 * layers * DECODE_STEPS,
                        'flash_bwd_dq': layers * DECODE_STEPS,
                        'flash_bwd_dkv': layers * DECODE_STEPS})
        batches = native.calls['npy_copy_batch'] - before
        if (batches == 0) == label.startswith('lm native'):
            raise AssertionError('%s: %d row groups decoded by the native plane' % (label, batches))
        record(label, result, launches, DECODE_STEPS, 2, put_s, transfer)
        rows[label]['native_batches'] = batches
    # L2: the packing runs on the dispatch thread with the plane on
    for label, transfer in (('packed', 'auto'), ('packed inline', False)):
        reset_counts(fa)
        with timed_puts() as put_s:
            result = lm.train_packed(packed_url, steps=DECODE_STEPS, attn='flash',
                                     transfer=transfer)
        launches, by_design = counts(fa)
        check_launches(label, launches, by_design,
                       {name: lm.PACKED_LM['num_layers'] * DECODE_STEPS for name in launches})
        h2d = {k: result['loader_metrics'].get(k, 0) for k in ('h2d_batches', 'h2d_degraded')}
        if len(result['losses']) != DECODE_STEPS or not np.all(np.isfinite(result['losses'])) \
                or (put_s.on() == 'pump') != (transfer == 'auto'):
            raise AssertionError('%s: %d losses, puts on the %s thread'
                                 % (label, len(result['losses']), put_s.on()))
        rows[label] = dict(step_tokens_per_s=result['step_tokens_per_s'],
                           step_ms=result['step_ms'], host_ms=result['host_ms'],
                           transfer=transfer, put_ms=put_s.ms(2), put_on=put_s.on(),
                           stage_ms=put_s.ms(2, 'stage'), ring_wait_ms=put_s.ms(2, 'wait'),
                           launches=launches, **h2d)
        log('decode plane [%s] (%d steps, timed after 2): real tokens/s %.0f step_ms %.2f '
            'host_ms %.3f; put %.2f ms per batch on the %s thread (slab packing %s ms, ring wait '
            '%s ms); h2d_batches %d h2d_degraded %d; launches %s'
            % (label, DECODE_STEPS, result['step_tokens_per_s'], result['step_ms'],
               result['host_ms'], rows[label]['put_ms'], rows[label]['put_on'],
               None if rows[label]['stage_ms'] is None else '%.2f' % rows[label]['stage_ms'],
               None if rows[label]['ring_wait_ms'] is None
               else '%.2f' % rows[label]['ring_wait_ms'],
               h2d['h2d_batches'], h2d['h2d_degraded'], launches))
    SUMMARY['decode_plane'] = rows


PARITY_SCRIPT = r"""
import json, sys
import torch
from petastorm_tpu_torch.gpu import DataLoader
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.train import make_transform
from petastorm_tpu_torch.workers_pool import shm_plane
batches, shm = {}, {}
for pool in ('thread', 'process'):
    reader = make_reader(sys.argv[1], schema_fields=['image', 'noun_id'], columnar_decode=True,
                         transform_spec=make_transform((224, 224)), reader_pool_type=pool,
                         workers_count=1, shuffle_row_groups=False, num_epochs=1)
    with DataLoader(reader, batch_size=64, drop_last=False, device='cuda') as loader:
        batches[pool] = [{k: v.cpu() for k, v in b.items()} for b in loader]
    shm[pool] = reader.diagnostics.get('shm_results')
    pids = reader.diagnostics.get('worker_pids', [])
    alive = [p.pid for p in getattr(reader._pool, '_processes', []) if p.poll() is None]
equal = len(batches['thread']) == len(batches['process']) and all(
    set(a) == set(b) and all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
    for a, b in zip(batches['thread'], batches['process']))
print(json.dumps({'batches': len(batches['process']), 'equal': equal, 'shm_results': shm,
                  'fields': sorted(batches['process'][0]), 'children_alive': alive,
                  'residue': sorted(shm_plane.residue(pids))}))
"""


def phase_pool_parity(url):
    """In a process started with PYTHONHASHSEED=0 (the example's label is
    ``hash(noun_id) % 1000``, and each decode process would seed its own
    hash otherwise): the process pool with one worker and no row-group
    shuffle delivers the thread pool's batches to the card bit for bit,
    images and labels, its batches came through /dev/shm, and after
    ``stop`` no child and no slab is left."""
    from petastorm_tpu_torch.workers_pool import shm_plane
    env = dict(os.environ, PYTHONHASHSEED='0',
               PYTHONPATH=os.pathsep.join([os.getcwd(), os.environ.get('PYTHONPATH', '')]))
    proc = subprocess.run([sys.executable, '-c', PARITY_SCRIPT, url], env=env,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError('pool parity process failed:\n%s\n%s' % (proc.stdout[-3000:],
                                                                      proc.stderr[-3000:]))
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    log('pool parity (PYTHONHASHSEED=0, one worker, no shuffle): %d batches of %s, process pool '
        'equal to the thread pool bit for bit: %s; shm_results %s; children alive after stop %s; '
        'slabs left %s' % (out['batches'], out['fields'], out['equal'], out['shm_results'],
                           out['children_alive'], out['residue']))
    if not out['equal'] or out['fields'] != ['image', 'label'] or out['children_alive'] \
            or out['residue'] or (shm_plane.available() and not out['shm_results']['process']):
        raise AssertionError('pool parity: %r' % out)
    SUMMARY['pool_parity'] = out


def phase_pump_parity(url):
    """The transfer plane on the card.  A coalesced put, unpacked on the
    card, equals the same put on the CPU bit for bit, at full width and
    with ``wire_dtypes='auto'`` (bfloat16 on the wire, cast back on the
    card).  Then with one decode thread and no row-group shuffle the pumped
    loader (``transfer=True``) delivers the inline loader's
    (``transfer=False``) batches bit for bit; its pulls and puts ran on the
    dispatch thread, the inline ones on this one, and every pumped batch
    went through one coalesced copy.  A structure the plane refuses (the
    image column alone: one full-width leaf) is counted in ``h2d_degraded``
    and still reaches the card, from the dispatch thread, equal to the
    inline images."""
    from petastorm_tpu_torch.benchmark import TraceRecorder
    from petastorm_tpu_torch.gpu import DataLoader, transfer
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.train import make_transform
    rng = np.random.default_rng(11)
    tree = {'x': rng.standard_normal((64, 1000)).astype(np.float32),
            'f64': rng.standard_normal((64,)) * 1e3,
            'image': rng.integers(0, 256, (64, 56, 56, 3), dtype=np.uint8),
            'wide': rng.integers(-2 ** 40, 2 ** 40, (64,)), 'flag': rng.random(64) < 0.5}
    for policy in (None, 'auto'):
        card = transfer.TransferPlane('cuda', wire_dtypes=policy)
        got = card.ready(*card.put(tree))
        cpu = transfer.TransferPlane('cpu', wire_dtypes=policy)
        want = cpu.ready(*cpu.put(tree))
        torch.cuda.synchronize()
        for name, value in want.items():
            if got[name].device.type != 'cuda' or got[name].dtype != value.dtype \
                    or not torch.equal(got[name].cpu(), value):
                raise AssertionError('plane put on the card, wire_dtypes=%r: %s differs from '
                                     'the CPU put' % (policy, name))
        log('transfer plane on the card, wire_dtypes=%r: one coalesced copy of %d bytes (%d '
            'logical), equal to the CPU put bit for bit'
            % (policy, card.metrics.counter('h2d_bytes_wire').value,
               card.metrics.counter('h2d_bytes_logical').value))
        card.close()
    batches, tids, h2d = {}, {}, {}
    for mode in (True, False, 'degraded'):
        rec = TraceRecorder()
        reader = make_reader(url, schema_fields=['image', 'noun_id'], columnar_decode=True,
                             transform_spec=make_transform((224, 224)), workers_count=1,
                             shuffle_row_groups=False, num_epochs=1)
        squeeze = (lambda b: {'image': b['image']}) if mode == 'degraded' else None
        with DataLoader(reader, batch_size=BATCH, drop_last=False, trace_recorder=rec,
                        transfer=mode == 'degraded' or mode, transform_fn=squeeze) as loader:
            batches[mode] = [{k: v.cpu() for k, v in b.items()} for b in loader]
            h2d[mode] = {k: loader.metrics.counter(k).value
                         for k in ('h2d_batches', 'h2d_degraded')}
        tids[mode] = {e['name']: e['tid'] for e in rec.events}
    me = threading.get_ident()
    equal = len(batches[True]) == len(batches[False]) == IMAGE_ROWS // BATCH and all(
        set(a) == set(b) and all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
        for a, b in zip(batches[True], batches[False]))
    log('pump parity (one decode thread, no shuffle): %d batches, pumped equal to inline bit for '
        'bit: %s; pumped h2d %s, pulls on the %s thread; inline pulls on the %s thread'
        % (len(batches[True]), equal, h2d[True],
           'training' if tids[True]['host_batch'] == me else 'dispatch',
           'training' if tids[False]['host_batch'] == me else 'dispatch'))
    degraded_equal = len(batches['degraded']) == len(batches[False]) and all(
        list(a) == ['image'] and torch.equal(a['image'], b['image'])
        for a, b in zip(batches['degraded'], batches[False]))
    log('pump parity, the image column alone: h2d %s, put column by column on the %s thread, '
        'equal to the inline images: %s'
        % (h2d['degraded'], 'training' if tids['degraded']['device_put'] == me else 'dispatch',
           degraded_equal))
    if not equal or tids[True]['host_batch'] == me or tids[True]['h2d/stage'] == me \
            or tids[False]['host_batch'] != me \
            or h2d[True]['h2d_batches'] != len(batches[True]) or h2d[False]['h2d_batches'] \
            or not degraded_equal or tids['degraded']['device_put'] == me \
            or h2d['degraded']['h2d_degraded'] != len(batches['degraded']):
        raise AssertionError('pump parity: equal %s / %s, h2d %s, threads %s (this one %d)'
                             % (equal, degraded_equal, h2d, tids, me))
    SUMMARY['pump_parity'] = dict(batches=len(batches[True]), equal=equal, h2d=h2d[True],
                                  degraded=h2d['degraded'])


def phase_gil_probe():
    """What another thread can do while the training thread's graph launch
    waits for the card.  Twice, with one other thread each: a Python loop
    that counts its turns per ms, then a thread that times its calls of a
    ``non_blocking`` copy of 9.6 MB of pinned memory to the card on a stream
    of its own (the call a loader's dispatch thread makes); each while this
    thread sleeps, while it replays back to back a captured graph of 3000
    elementwise kernels over 16 MB (each launch waits for room in the
    card's queue once it is full), and while it synchronizes."""
    x = torch.zeros(1 << 22, device='cuda')

    def body():
        for _ in range(3000):
            x.add_(1.0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    torch.cuda.synchronize()
    src = torch.empty(64 * 224 * 224 * 3, dtype=torch.uint8, pin_memory=True)
    copy_stream = torch.cuda.Stream()
    turns, calls = [0], []

    def spin(stop):
        while not stop.is_set():
            turns[0] += 1

    def copy(stop):
        with torch.cuda.stream(copy_stream):
            while not stop.is_set():
                t0 = time.perf_counter()
                src.to('cuda', non_blocking=True)
                calls.append((t0, time.perf_counter()))
                copy_stream.synchronize()

    def windows(worker):
        stop = threading.Event()
        thread = threading.Thread(target=worker, args=(stop,))
        thread.start()
        out = {}
        try:
            for label, fn in (('sleep', lambda: time.sleep(0.2)),
                              ('replays', lambda: [graph.replay() for _ in range(8)]),
                              ('synchronize', torch.cuda.synchronize)):
                n0, c0, t0 = turns[0], len(calls), time.perf_counter()
                fn()
                ms = 1e3 * (time.perf_counter() - t0)
                inside = [1e3 * (b - a) for a, b in calls[c0:]]
                out[label] = dict(ms=ms, turns_per_ms=(turns[0] - n0) / ms, copies=len(inside),
                                  copy_call_ms=max(inside) if inside else None)
            torch.cuda.synchronize()
        finally:
            stop.set()
            thread.join()
        return out
    spun, copied = windows(spin), windows(copy)
    for label in ('sleep', 'replays', 'synchronize'):
        a, b = spun[label], copied[label]
        log('GIL probe, while this thread %s (%.1f ms; %.1f ms): another Python thread %.1f loop '
            'turns per ms; another thread\'s non_blocking 9.6 MB copy call: %d calls, the '
            'longest %s ms'
            % ({'sleep': 'sleeps', 'replays': 'replays a 3000-kernel graph 8 times back to back',
                'synchronize': 'synchronizes after them'}[label], a['ms'], b['ms'],
               a['turns_per_ms'], b['copies'],
               None if b['copy_call_ms'] is None else '%.3f' % b['copy_call_ms']))
    SUMMARY['gil_probe'] = dict(spin=spun, copy=copied)


GRAPH_GC_SCRIPT = r"""
import gc, json, warnings
import torch
from petastorm_tpu_torch.gpu import graphs
x = torch.zeros(16, device='cuda')
side = torch.cuda.Stream()
side.wait_stream(torch.cuda.current_stream())
with torch.cuda.stream(side):
    x.add_(1)
torch.cuda.current_stream().wait_stream(side)


def orphan():
    # an unreachable graph that only the cyclic collector frees
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x.add_(1)
    holder = {'graph': graph}
    holder['self'] = holder


def capture(collect_inside):
    graph = torch.cuda.CUDAGraph()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        try:
            with torch.cuda.graph(graph):
                x.add_(1)
                if collect_inside:
                    gc.collect()
                x.add_(1)
            return dict(ok=True, warnings=[str(w.message)[:120] for w in caught])
        except Exception as e:
            return dict(ok=False, error=str(e).splitlines()[0][:160],
                        warnings=[str(w.message)[:120] for w in caught])


gc.disable()
orphan()
inside = capture(True)
torch.cuda.synchronize()
orphan()
step = graphs.StepGraph(lambda t: t * 2)
step(torch.ones(2, device='cuda'))
try:
    step(torch.ones(2, device='cuda'))
    held = dict(ok=True)
except Exception as e:
    held = dict(ok=False, error=str(e).splitlines()[0][:160])
print(json.dumps({'collect_inside_capture': inside, 'step_graph_capture': held}))
"""


def phase_graph_gc():
    """Why a step graph's capture holds off Python's cyclic garbage collector:
    in a process of its own (a failed capture stays there), an unreachable
    CUDA graph that only the collector frees, then a capture during which
    the collector runs; and a ``StepGraph`` capture with such a graph
    pending, which must succeed."""
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([os.getcwd(), os.environ.get('PYTHONPATH', '')]))
    proc = subprocess.run([sys.executable, '-c', GRAPH_GC_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError('graph gc process failed:\n%s\n%s' % (proc.stdout[-3000:],
                                                                     proc.stderr[-3000:]))
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    log('graph gc: a collection inside a capture that frees an unreachable graph: %s; a '
        'StepGraph capture with such a graph pending: %s'
        % (out['collect_inside_capture'], out['step_graph_capture']))
    if not out['step_graph_capture']['ok']:
        raise AssertionError('graph gc: the StepGraph capture failed: %r' % out)
    SUMMARY['graph_gc'] = out


def phase_disk_cache(fa, url, tmp):
    """``--decoded-cache-dir`` on ResNet-50: a run of one epoch that decodes
    and writes the cache (epoch 0: 8 steps, timed after 2), then DECODE_STEPS
    steps timed after DECODE_WARMUP served from the memory-mapped files with
    no reader; images/s and ``stall_pct`` of each.  Then two loaders over
    the complete cache, one pumped and one inline, serve the same epoch bit
    for bit."""
    from petastorm_tpu_torch.gpu import DiskCachedDataLoader
    from petastorm_tpu_torch.train import train
    cache = os.path.join(tmp, 'decoded_cache')
    rows = {}
    for label, steps, warmup in (('build', IMAGE_ROWS // BATCH, 2),
                                 ('memmap', DECODE_STEPS, DECODE_WARMUP)):
        reset_counts(fa)
        result = train(url, steps=steps, batch_size=BATCH, model_name='resnet50',
                       decoded_cache_dir=cache, warmup_steps=warmup)
        launches, _ = counts(fa)
        h2d = {k: result['loader_metrics'].get(k, 0) for k in ('h2d_batches', 'h2d_degraded')}
        if any(launches.values()) or len(result['losses']) != steps \
                or not np.all(np.isfinite(result['losses'])) or not h2d['h2d_batches'] \
                or not DiskCachedDataLoader.cache_complete(cache):
            raise AssertionError('disk cache %s: launches %s, %d losses, h2d %s, complete %s'
                                 % (label, launches, len(result['losses']), h2d,
                                    DiskCachedDataLoader.cache_complete(cache)))
        if label == 'memmap' and result['reader_diagnostics']:
            raise AssertionError('disk cache: the complete cache was read with a reader')
        rows[label] = dict(_metrics(result), regime=result['diagnosis']['regime'], **h2d)
        log('disk cache [%s] (resnet50, %d steps timed after %d): images/s %.1f step_ms %.2f '
            'data_wait_ms %.2f stall_pct %.2f regime %s h2d %s'
            % (label, steps, warmup, result['images_per_s'], result['step_ms'],
               result['data_wait_ms'], result['stall_pct'], rows[label]['regime'], h2d))
    with open(os.path.join(cache, 'manifest.json')) as f:
        manifest = json.load(f)
    sizes = {name: os.path.getsize(os.path.join(cache, spec['file']))
             for name, spec in manifest['fields'].items()}
    if manifest['rows'] != IMAGE_ROWS or sizes['image'] != IMAGE_ROWS * 224 * 224 * 3:
        raise AssertionError('disk cache manifest %r, sizes %r' % (manifest, sizes))
    served = {}
    for mode in ('auto', False):
        with DiskCachedDataLoader(None, BATCH, decoded_cache_dir=cache, num_epochs=1, seed=3,
                                  transfer=mode) as loader:
            served[mode] = [{k: v.cpu() for k, v in b.items()} for b in loader]
    equal = len(served['auto']) == IMAGE_ROWS // BATCH and all(
        all(torch.equal(a[k], b[k]) for k in a) for a, b in zip(served['auto'], served[False]))
    log('disk cache: %d rows, %s bytes per field; an epoch from the cache, pumped and inline, '
        'equal bit for bit: %s' % (manifest['rows'], sizes, equal))
    if not equal:
        raise AssertionError('disk cache: the pumped and inline epochs differ')
    SUMMARY['disk_cache'] = dict(rows, bytes=sizes)


def phase_trace(url, tmp):
    """The example's ``--trace`` on ResNet-50 streaming: the Chrome trace
    holds the monitor's ``data_wait`` and ``step``, the loader's
    ``host_batch`` and the plane's ``h2d/stage``, ``h2d/dispatch`` and
    ``h2d/commit`` spans, the loader's and the plane's on another thread
    than the monitor's."""
    from petastorm_tpu_torch.train import main
    path = os.path.join(tmp, 'resnet50_trace.json')
    result = main(['--dataset-url', url, '--steps', str(STEPS), '--batch-size', str(BATCH),
                   '--trace', path])
    with open(path) as f:
        events = json.load(f)['traceEvents']
    tids, counts_ = {}, {}
    for e in events:
        tids.setdefault(e['name'], set()).add(e['tid'])
        counts_[e['name']] = counts_.get(e['name'], 0) + 1
    want = {'data_wait', 'step', 'host_batch', 'h2d/stage', 'h2d/dispatch', 'h2d/commit'}
    log('trace: %d spans in %s: %s; stall top component %s'
        % (len(events), os.path.basename(path), counts_, result['stall_top_component']))
    if not want <= set(tids) or result['trace_events'] != len(events) \
            or (tids['host_batch'] | tids['h2d/stage']) & tids['data_wait']:
        raise AssertionError('trace: spans %s on threads %s' % (counts_, tids))
    SUMMARY['trace'] = dict(spans=counts_, stall_top_component=result['stall_top_component'])


def main():
    # The kernels' module (petastorm_tpu_torch.ops re-exports its function
    # under the same name).  Imported first: outside a checkout this fails
    # before anything is printed.
    fa = importlib.import_module('petastorm_tpu_torch.ops.flash_attention')
    smi = phase_device()
    phase_build(fa)
    phase_native_build()
    errors, repair_errors = {}, {}
    for shape, dtype, causal, segments, misaligned, design in KERNEL_CASES:
        errs = kernel_case(fa, shape, dtype, causal, segments, misaligned, design, seed=7)
        for name, err in errs.items():
            if design == MAIN_PATH_DESIGN[name]:
                errors[name] = max(errors.get(name, 0.0), err)
            if dtype == torch.float16 or shape['d'] > 128:
                repair_errors[name] = max(repair_errors.get(name, 0.0), err)
    timing = phase_timing(fa)
    timing_lm = phase_timing_lm(fa)
    timing_repair = phase_timing_repair(fa)
    phase_model(fa)
    paths = {}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as tmp:
        url = 'file://' + os.path.join(tmp, 'imagenet_jpeg')
        t0 = time.monotonic()
        write_dataset(url)
        log('dataset: 512 JPEG rows written in %.1f s' % (time.monotonic() - t0))
        for name, phase in (('vit', lambda: phase_main_path(fa, url, tmp)),
                            ('resnet50', lambda: phase_resnet(fa, url, tmp)),
                            ('hbm_cache', lambda: phase_hbm_cache(fa, url, tmp)),
                            ('lm', lambda: phase_lm(fa, tmp)),
                            ('packed', lambda: phase_packed(fa, tmp)),
                            ('generate', lambda: phase_generate(fa, paths['packed'][1])),
                            ('native', lambda: phase_native(url)),
                            ('decode_plane', lambda: phase_decode_plane(
                                fa, url, 'file://' + os.path.join(tmp, 'lc_tokens'),
                                'file://' + os.path.join(tmp, 'lc_var_tokens'), tmp)),
                            ('pool_parity', lambda: phase_pool_parity(url)),
                            ('pump_parity', lambda: phase_pump_parity(url)),
                            ('gil_probe', phase_gil_probe),
                            ('graph_gc', phase_graph_gc),
                            ('disk_cache', lambda: phase_disk_cache(fa, url, tmp)),
                            ('trace', lambda: phase_trace(url, tmp))):
            t0 = time.monotonic()
            paths[name] = phase()
            log('phase %s: %.1f s' % (name, time.monotonic() - t0))
    launches = {'vit': paths['vit'], 'lm': paths['lm'], 'packed': paths['packed'][0],
                'generate': paths['generate']}
    kernels = [dict(name=name, route='cuda', design=MAIN_PATH_DESIGN[name],
                    source=SOURCES[name], replaces=REPLACES[name],
                    launches=sum(path[name] for path in launches.values()),
                    launches_by_path={path: n[name] for path, n in launches.items()},
                    max_abs_err=errors[name], ms=timing[name]['ms'],
                    plain_ms=timing[name]['plain_ms'], bound_ms=timing[name]['bound_ms'],
                    bound_by=timing[name]['bound_by'], library_ms=timing[name]['library_ms'],
                    cuda_core_ms=timing[name]['cuda_core_ms'], host_us=timing[name]['host_us'],
                    cuda_core_host_us=timing[name]['cuda_core_host_us'], l1=timing_lm[name],
                    fp16_and_d256=dict(max_abs_err=repair_errors[name],
                                       times=timing_repair[name]))
               for name in ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')]
    log(json.dumps({'paths': SUMMARY}))
    log('chip_smoke: %.1f s in all' % (time.monotonic() - T_START))
    log(smi)
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                           'kind': torch.cuda.get_device_name(0),
                                           'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    sys.exit(main())
