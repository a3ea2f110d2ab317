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
   ``h2d/*`` spans, the loader's on the dispatch thread;
17. resume (exact data checkpoints): the MNIST example at the training
   split's size (60,000 PNG rows, batch 128, graphed) timed with its 4
   decode threads, then checkpointed with ``TrainStateManager`` at step 200
   and resumed in fresh objects, the remaining batches (sha256) and final
   parameters equal to the uninterrupted run's bit for bit on the dummy
   pool, and every row at most once on 4 threads; the pumped L1 token
   loader and the float32 image loader under ``wire_dtypes='auto'``
   resumed from tokens taken with batches in flight on the ring, bit for
   bit; the HBM cache's ``scan_epochs`` resumed from an epoch boundary and
   from mid-epoch; each ``state_dict()``'s ms and token bytes;
17b. elastic (resharded loader checkpoints): on L1's token store, two
   "hosts" (shards 0 and 1 of 2) train L1 at its widths on the card for 5
   and 7 steps and save their loader tokens through ``TrainStateManager``
   (``host_0``, ``host_1``) with batches in flight; the tokens read back
   with ``restore_latest_from`` reshard 2 -> 3 and 2 -> 1 on the dummy pool
   and 2 -> 3 on 4 threads, and the resumed loaders finish both epochs
   training on the card: every document exactly twice on the dummy pool, at
   least twice on threads; the reshard's host ms, the tokens' pickled
   bytes, the resumed tokens/s and step ms, 8 / 4 / 4 flash launches a
   step;
18. batch reader (``make_batch_reader`` over plain Parquet): a Criteo-shaped
   store of 2^20 rows read back equal to ``pq.read_table`` on the dummy
   pool, the same multiset of row groups on 4 threads and 8 processes (the
   reader's rows/s alone), a predicate and a ``filters`` case against numpy
   masks; DLRM at the Criteo example's width for one epoch graphed, eager
   and with ``--scan-steps 4`` (rows/s, step and host ms, data wait,
   ``stall_pct``, busy share, kernels per step), eager and graphed equal bit
   for bit over 20 steps; both hello-world flows; the DataFrame converter's
   example; and a pumped batch loader cut and resumed bit for bit;
19. reference footer: in a process of its own, a store whose footer holds
   upstream petastorm's frozen bytes (``petastorm.*`` classes, Spark SQL
   types, no pyspark on this host) read through ``make_reader`` on three
   pools (every codec column equal to the written rows) and
   ``make_batch_reader`` (the stored schema); neither ``petastorm`` nor
   ``petastorm_tpu`` nor ``jax`` loaded afterwards;
20. NGram (BASELINE config #5): the sensor log at 2^17 rows (1,311 row
   groups, 125,828 windows); the reader alone on the dummy pool, 4 threads
   and 8 processes (the same multiset of windows, windows/s); the
   example's loop on the card, pumped, ``predict_speed`` graphed and eager
   for one epoch (windows/s, step and host ms, data wait, ``stall_pct``, the
   device's share and kernels per step of each under the profiler) and bit for bit over 300 batches in one data order; a
   shard resumed bit for bit with the shuffling buffer and batches in
   flight; the same shard with ``echo=2``;
21. resident (``ResidentDataLoader``, the dataset in HBM in its wire
   dtypes): ViT-S/16 at full width, 4 epochs of the JPEG store, graphed
   with augment on the card: epoch 0 streams 8 host batches, epochs 1-3
   none (24 hits), slabs of 77.07 MB, 12 launches of each flash kernel a
   step, a second pass (every epoch warm) equal to a kill-switch loader's
   bit for bit; DLRM at
   the Criteo example's width, 3 epochs of the 2^20-row store with
   ``pack_columns`` in the graphed step: 134 B a row on the wire against
   160 at full width, epochs 1-2 with no host batch, rows/s, step and host
   ms, data wait, ``stall_pct`` and the kernels per step of the streamed
   and a warm epoch, the step graph alone; then a second pass (every epoch
   warm), a budget of half the wire bytes (every epoch streams, evictions
   and thrash, no hit) and the kill switch in lockstep, every batch equal
   bit for bit; each epoch's permutation host ms;
22. search: on the trained L2 model, two zipf prompts of 8 tokens, 64 new
   tokens: ``beam_search`` (4 beams, and with an ``eos_id``) and
   ``speculative_generate`` (``draft_len`` 4, greedy and sampled at 0.8
   under ``PRNGKey(0)``, the model itself and a one-layer random model as
   drafts), each graphed, eager, eager, graphed and all four equal bit for
   bit, ``flash_fwd`` once per layer of each prefill and no backward launch;
   on an fp32 copy a one-beam search and greedy speculative runs equal to
   greedy ``generate``; ms per new token, rounds, drafts accepted per round
   and host syncs per token;
23. ViT recipe: ViT-S/16 at full width with ``remat=True``, streamed and
   pumped from the JPEG store (8 threads), 24 graphed steps of crop, flip,
   ``color_jitter``, cutout 56, ``normalize`` and ``mixup`` (alpha 0.8)
   under ``mixup_loss`` and SGD momentum, 24 / 12 / 12 flash launches a step
   on the tensor cores; the same without remat and 8 steps with ``cutmix``;
   images/s, step ms and peak device memory of each; on one batch remat's
   loss and gradients against none's; eager against graphed bit for bit from
   one generator seed, two replays drawing anew; each inner augment op on
   the card against the CPU on the same draws;
24. sequence parallel (the long-context example with ``--strategy ring`` and
   ``ulysses``): an NCCL group over every visible card through a
   ``FileStore`` in the run's temporary directory (one rank in this
   process on one card; one spawned process per card where there are
   more), then ``train_lm`` at L1's full width on ``phase_lm``'s token
   store, 20 graphed steps each of ``ring``, ``ring`` with ``block_k``
   256, ``ulysses`` and ``flash``, from the same seed and rows: tokens/s,
   step ms and peak device memory of each; on one card every loss of ring
   and chunked ring against ``flash`` within ``SP_LOSS_ATOL`` (the first
   within the bf16 tolerance too), and Ulysses (whose all-to-alls are
   identities there) equal to ``flash`` bit for bit; on more cards, where
   ``flash`` reads other rows, every loss of both rings against Ulysses on
   the same mesh and rows within ``SP_LOSS_ATOL``; ring attention itself,
   whole and chunked, as the sharded step builds it at L1's attention
   shapes, its output and q/k/v gradients on each rank's block against the
   dense fp32 reference within the bf16 tolerance; 8
   forward, 4 dQ and 4 dK/dV launches a step under Ulysses and ``flash``,
   all on the tensor cores, none under ring; ring and Ulysses eager against
   graphed bit for bit; a profile of the ring and the Ulysses step, fed by
   the example's 4 decode threads;
25. multi-device (the image example on a mesh, tensor parallelism, FSDP,
   the pipeline and expert-parallel MoE): an NCCL group over every visible
   card as in 24.  (a) ``train`` on ``make_mesh()`` with ``sharding=``:
   ResNet-50 at full width (64 x 224^2, 20 graphed steps, one decode
   thread, no row-group shuffle), then ``--scan-steps 4``, then ViT-S/16,
   each beside the same run without a group on the same rows: on one card
   the losses equal bit for bit; images/s, step ms and host ms of both; 12
   launches of each flash kernel a ViT step, on the tensor cores; ResNet-50's
   kernels per step under the profiler against ``phase_resnet``'s, the
   difference being the gradient all-reduce's.  (b) At L1's width (d_model
   256, 8 heads, 4 layers, bf16): ``param_shardings``, and
   ``fsdp_shardings`` over ``megatron_spec_fn()``, placed on ``{'data':
   world / m, 'model': m}`` (m = 2 on an even number of cards, else 1): the
   logits against the unplaced model's, a train step, and ``generate``
   token-identical; a pipeline of ``{'pipe': p}`` stages (p = 2 on an even
   number of cards) against the sequential stages, output and gradients; the
   MoE on ``{'data': world / e, 'expert': e}`` against ``moe_apply``;
26. data service (``petastorm_tpu_torch.service``): 1,536 JPEG rows with
   ids served by a ``Dispatcher`` thread and two ``Worker`` processes (no
   card, no torch; 2 decode threads and the image transform each, shm
   delivery on) to ``ServiceDataLoader(consumer=0, batch_size=64)``: one
   graphed epoch of ViT-S/16 at full width (24 steps, timed after 4), every
   row once, 12 launches of each flash kernel a step, images/s, step ms,
   data wait, ``stall_pct``, the dispatcher's stats (splits, lease churn,
   each worker's rows/s, shm against byte chunks), the workers drained by
   SIGTERM with no ``/dev/shm`` slab left; the same epoch from the local
   loader (4 decode threads); and ``ordered=True`` with one worker and one
   thread equal to a local reader's host batches in dataset order, bit for
   bit; then the shared fleet (``phase_service_fleet``) and the control
   plane (``phase_service_control``) on the same store;
27. ingest (``phase_ingest``): adaptive scheduling, the loader's autotuner
   and the async ingest plane over the cold-store emulation of the 1,536-row
   store, three legs of ViT-S/16 at full width (FIFO, adaptive, adaptive
   with the plane and the tuner fed by a ``StallMonitor``), 28 graphed
   steps each, timed after 4, then the rest of two epochs: every row twice,
   the adaptive legs' ids equal in order, the plane fetching and never
   degrading.

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

import collections
import contextlib
import hashlib
import importlib
import json
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

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


def write_dataset(url, rows=IMAGE_ROWS, seed=0, ids=False):
    """Synthetic ImageNet-like JPEG Parquet: RGB images at mixed sizes (most
    not 224x224, so the transform's resize runs) and a string noun_id; with
    ``ids`` an int64 ``id``, the row's index, too."""
    import cv2
    import pyarrow as pa
    from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('ImagenetSchema', [
        UnischemaField('noun_id', np.str_, (), ScalarCodec(pa.string()), False),
        UnischemaField('image', np.uint8, (None, None, 3), CompressedImageCodec('jpeg'), False)]
        + ([UnischemaField('id', np.int64, (), None, False)] if ids else []))
    rng = np.random.default_rng(seed)
    sizes = [(224, 224), (256, 256), (300, 200), (180, 240)]
    with DatasetWriter(url, schema, rows_per_rowgroup=64) as writer:
        for i in range(rows):
            h, w = sizes[i % len(sizes)]
            # smooth content plus noise: JPEG sizes like photographs', not like noise
            img = cv2.resize(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8), (w, h),
                             interpolation=cv2.INTER_CUBIC)
            img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
            row = {'noun_id': 'n%08d' % rng.integers(0, 1000), 'image': img}
            writer.write(dict(row, id=np.int64(i)) if ids else row)


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
    metrics = result['loader_metrics']
    log('main path reader: scheduling=%s ingest=%s; autotuner gauges %s'
        % (result['reader_diagnostics'].get('scheduling'),
           result['reader_diagnostics'].get('ingest'),
           {k: metrics.get(k) for k in ('sched_window', 'sched_max_inflight', 'sched_prefetch',
                                        'sched_adjust_total')}))
    if result['reader_diagnostics'].get('scheduling') != 'adaptive' \
            or metrics.get('sched_window') is None:
        raise AssertionError("the main path's reader dispatched %r with autotuner gauges %s; "
                             "the JAX example's arguments resolve to 'adaptive' with a live tuner"
                             % (result['reader_diagnostics'].get('scheduling'),
                                metrics.get('sched_window')))
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
    """``(device time, host time)`` at which each profiled step starts, one
    per ``train_step`` range of the training thread outside a graph capture
    (``graphs.CAPTURE_RANGE``: a capture runs nothing), in order: the first
    device event launched from inside the range (matched by the launch's
    correlation id; every kernel of a graph replay carries its graph
    launch's), and the range's start.  The device time is None where the
    trace holds no device record of any launch from the range: the
    profiler's CUDA tracing loses records now and then (on the H100 a
    whole step's, once in many runs), while the ranges are the profiler's
    own host records.  Only the training thread's calls count: the
    loader's transfer thread copies meanwhile."""
    from petastorm_tpu_torch.gpu.graphs import CAPTURE_RANGE
    main_tid = _step_tid(trace)
    device_ts = {}
    for e in events:
        c = e.get('args', {}).get('correlation')
        if c is not None:
            device_ts[c] = min(e['ts'], device_ts.get(c, e['ts']))
    launches = sorted((e['ts'], e['args']['correlation']) for e in trace
                      if e.get('cat') in ('cuda_runtime', 'cuda_driver') and e['tid'] == main_tid
                      and e.get('args', {}).get('correlation') in device_ts)
    captures = [(e['ts'], e['ts'] + e['dur']) for e in trace
                if e.get('cat') == 'user_annotation' and e['name'] == CAPTURE_RANGE
                and e['tid'] == main_tid]
    starts = []
    for step in sorted((e for e in trace if e.get('cat') == 'user_annotation'
                        and e['name'] == 'train_step' and e['tid'] == main_tid),
                       key=lambda e: e['ts']):
        lo, hi = step['ts'], step['ts'] + step['dur']
        if any(c0 <= lo and hi <= c1 for c0, c1 in captures):
            continue
        inside = [device_ts[c] for t, c in launches if lo <= t <= hi]
        starts.append((min(inside) if inside else None, lo))
    return starts


def _recorded_span(starts, first, last, label):
    """``(i, j)``: the first and the last step of ``starts[first..last]``
    whose device start the trace holds (see :func:`_step_starts`); logs the
    steps of the run whose device records it lost, and raises if fewer
    than two of those steps are left."""
    lost = [k + 1 for k, (t, _) in enumerate(starts) if t is None]
    if lost:
        log('profile %s: the trace holds no device record of steps %s (lost by the '
            'profiler); measured between the recorded steps around them' % (label, lost))
    held = [k for k in range(first, last + 1) if starts[k][0] is not None]
    if len(held) < 2:
        raise AssertionError('profile %s: device records of %d of steps %d..%d'
                             % (label, len(held), first + 1, last + 1))
    return held[0], held[-1]


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
    device and on the host; a step whose device records the trace lost
    narrows the window to the recorded steps around it, and launches left
    without a device record are counted): the device busy time per step and its split by
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
        raise AssertionError('profile %s: found %d train_step ranges for %d steps'
                             % (label, len(starts), steps))
    i, j = _recorded_span(starts, 2, steps - 1, label)
    (lo, host_lo), (hi, host_hi) = starts[i], starts[j]
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
    n = j - i
    kernels = sum(1 for e in events if e.get('cat') == 'kernel' and lo <= e['ts'] < hi)
    by_name = {}
    for e in events:
        if e.get('cat') == 'kernel' and lo <= e['ts'] < hi:
            by_name[e['name']] = by_name.get(e['name'], 0) + 1
    launch_us = wait_us = 0.0
    graph_launches = kernel_launches = 0
    launched = {}    # device kernel name -> launches from the host (not by a graph)
    kernel_name = {e['args']['correlation']: e['name'] for e in events
                   if e.get('cat') == 'kernel' and 'correlation' in e.get('args', {})}
    recorded = {e['args'].get('correlation') for e in events}
    unrecorded = 0   # launches, copies and sets with no device record in the trace
    for e in runtime:   # the host's calls from the start of step 3 to that of the last
        if host_lo <= e['ts'] < host_hi:
            if any(k in e['name'] for k in ('Launch', 'Memcpy', 'Memset')) \
                    and e.get('args', {}).get('correlation') not in recorded:
                unrecorded += 1
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
    if unrecorded:
        log('profile %s: %d launches and copies of the window have no device record in the '
            'trace: the busy time below misses their work' % (label, unrecorded))
    log('profile %s (steps %d..%d under torch.profiler, %.2f ms per step): device busy %.2f ms '
        'per step (%.1f%%); kernel time by family, ms per step: %s'
        % (label, i + 1, j, (hi - lo) / n / 1e3, busy / n / 1e3, 100.0 * busy / (hi - lo),
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
                host_launched={k: v / n for k, v in launched.items()}, steps=n,
                unrecorded_launches=unrecorded,
                kernels_by_name={k: v / n for k, v in by_name.items()})


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


MNIST_ROWS = 60000      # the MNIST training split
MNIST_CUT = 200         # the step the resumed MNIST runs checkpoint at
MNIST_SNAPSHOT_EVERY = 30   # batches between two timed snapshots
SNAPSHOT_CALLS = 5


def batch_digest(batch):
    """sha256 of a device batch's bytes, fields in name order."""
    h = hashlib.sha256()
    for name in sorted(batch):
        h.update(batch[name].cpu().numpy().tobytes())
    return h.hexdigest()


def snapshot_cost(loader, batches=None, between=0):
    """Median ms of ``SNAPSHOT_CALLS`` ``state_dict()`` calls on a live loader
    (each drains the reader and keeps serving), ``between`` batches of the
    iterator ``batches`` taken before each (so that the rows a call drained
    are served before the next, as between a training job's checkpoints),
    and the median token's pickled bytes."""
    times, sizes = [], []
    for _ in range(SNAPSHOT_CALLS):
        for _ in range(between):
            next(batches)
        t0 = time.perf_counter()
        token = loader.state_dict()
        times.append(1e3 * (time.perf_counter() - t0))
        sizes.append(len(pickle.dumps(token)))
    return {'state_dict_ms': float(np.median(times)), 'token_bytes': int(np.median(sizes))}


def wait_for_pending(loader, timeout_s=30.0):
    """Until the loader's dispatch thread holds a batch on the card that
    the consumer has not taken (the case the snapshot must carry back)."""
    deadline = time.monotonic() + timeout_s
    while not loader._pump.pending and time.monotonic() < deadline:
        time.sleep(0.005)
    return len(loader._pump.pending)


def resume_pair(label, make_loader, cut):
    """``make_loader(resume_state)`` -> a loader over a fresh reader.  The
    uninterrupted stream; then ``cut`` batches, ``state_dict()`` with device
    batches in flight on the ring, every object dropped, and the remaining
    batches from fresh ones: they must equal the uninterrupted run's bit
    for bit (sha256 of every batch)."""
    with make_loader(None) as loader:
        full = [batch_digest(b) for b in loader]
    loader = make_loader(None)
    with loader:
        it = iter(loader)
        consumed = [batch_digest(next(it)) for _ in range(cut)]
        in_flight = wait_for_pending(loader)
        token = pickle.loads(pickle.dumps(loader.state_dict()))
        it.close()
    with make_loader(token) as resumed:
        rest = [batch_digest(b) for b in resumed]
    equal = consumed + rest == full
    log('resume [%s]: %d batches, token after %d with %d in flight on the ring (%d pending in '
        'the token): remaining %d equal to the uninterrupted run bit for bit: %s'
        % (label, len(full), cut, in_flight, len(token['pending']), len(rest), equal))
    if not equal or not in_flight or not token['pending']:
        raise AssertionError('resume [%s]: equal %s, in flight %d, pending %d'
                             % (label, equal, in_flight, len(token['pending'])))
    return {'batches': len(full), 'cut': cut, 'pending': len(token['pending']), 'equal': equal}


def phase_resume(fa, url, lm_url, tmp):
    """Exact data checkpoints on the card.

    (a) MNIST at the training split's size (60,000 synthetic PNG rows,
    batch 128, one epoch, graphed): ``train_mnist.train`` with the example's
    4 decode threads, timed; then on the dummy pool the epoch uninterrupted,
    and stopped after a ``TrainStateManager`` checkpoint at step 200 and
    resumed in fresh objects: the same batches (sha256) and final parameters
    bit for bit; on 4 threads, the same rows (``idx``), none lost or twice.
    (b) The pumped loader with device batches in flight: L1's token reader
    (columnar, one decode thread, no row-group shuffle), batch 8, a token
    after 10 batches; and the image path as float32 under
    ``wire_dtypes='auto'`` (narrowed on the wire), a token after 3.  (c) The
    HBM cache: ``DeviceInMemDataLoader.scan_epochs`` resumed from an epoch
    boundary and, with ``deterministic_cache_order=True``, from step 3 of an
    epoch.  (d) Each snapshot's cost (median ms of 5 ``state_dict()`` calls,
    MNIST's one every 30 batches, L1's every 4) and its token's pickled
    bytes.  No flash kernel runs here."""
    from petastorm_tpu_torch import train_mnist
    from petastorm_tpu_torch.gpu import DataLoader, DeviceInMemDataLoader
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.train import make_transform
    reset_counts(fa)
    out = {}
    # (a) MNIST
    mnist = 'file://' + os.path.join(tmp, 'mnist')
    t0 = time.monotonic()
    train_mnist.write_mnist_dataset(mnist, MNIST_ROWS)
    log('mnist dataset: %d PNG rows written in %.1f s' % (MNIST_ROWS, time.monotonic() - t0))
    idx = {}

    def record_idx(key):
        idx[key] = []
        return lambda step, batch: idx[key].append(batch['idx'].clone())

    timed = train_mnist.train(mnist, epochs=1, on_batch=record_idx('thread'))
    epoch = timed['epochs_run'][0]
    log('mnist (4 decode threads, graphed: %s): %d steps, loss %.4f, acc %.3f; rows/s %.1f '
        '(timed after 2 steps; %.1f over the whole epoch) step_ms %.3f data_wait_ms %.3f '
        'stall_pct %.2f' % (timed['cuda_graph'], epoch['steps'], epoch['loss'], epoch['acc'],
                            epoch['timed_rows_per_s'], epoch['rows_per_s'], epoch['step_ms'],
                            epoch['data_wait_ms'], epoch['stall_pct']))
    if epoch['steps'] != MNIST_ROWS // 128 or not np.isfinite(timed['losses']).all() \
            or timed['device'] != 'cuda' or not timed['cuda_graph']:
        raise AssertionError('mnist: %r' % epoch)
    out['mnist'] = {k: epoch[k] for k in ('steps', 'loss', 'acc', 'timed_rows_per_s',
                                          'rows_per_s', 'step_ms', 'data_wait_ms', 'stall_pct')}
    digests = {}

    def record(key):
        digests[key] = []
        return lambda step, batch: digests[key].append(batch_digest(batch))

    whole = train_mnist.train(mnist, epochs=1, reader_pool_type='dummy', on_batch=record('full'))
    ckpt = os.path.join(tmp, 'mnist_ckpt')
    cut = train_mnist.train(mnist, epochs=1, reader_pool_type='dummy', checkpoint_dir=ckpt,
                            save_every=MNIST_CUT, stop_after_step=MNIST_CUT,
                            on_batch=record('first'))
    del cut   # the loader, reader and model of the cut run go with it
    rest = train_mnist.train(mnist, epochs=1, reader_pool_type='dummy', checkpoint_dir=ckpt,
                             save_every=MNIST_CUT, on_batch=record('rest'))
    same_batches = digests['first'] + digests['rest'] == digests['full']
    w, r = whole['model'].state_dict(), rest['model'].state_dict()
    same_params = all(torch.equal(w[k], r[k]) for k in w)
    log('mnist resume (dummy pool): checkpoint at step %d, resumed at %s in fresh objects: '
        '%d + %d batches equal the uninterrupted %d (sha256): %s; final parameters equal bit '
        'for bit: %s' % (MNIST_CUT, rest['resumed_at'], len(digests['first']),
                         len(digests['rest']), len(digests['full']), same_batches, same_params))
    if not (same_batches and same_params and rest['resumed_at'] == MNIST_CUT):
        raise AssertionError('mnist resume: batches %s, parameters %s'
                             % (same_batches, same_params))
    ckpt = os.path.join(tmp, 'mnist_ckpt_thread')
    train_mnist.train(mnist, epochs=1, checkpoint_dir=ckpt, save_every=MNIST_CUT,
                      stop_after_step=MNIST_CUT, on_batch=record_idx('first'))
    train_mnist.train(mnist, epochs=1, checkpoint_dir=ckpt, save_every=MNIST_CUT,
                      on_batch=record_idx('rest'))
    # drop_last leaves out the epoch's last partial batch, whose rows the
    # threads' completion order picks: each run holds as many rows, none twice
    rows = {k: torch.cat(v).tolist() for k, v in idx.items()}
    got = rows['first'] + rows['rest']
    full_batches = (MNIST_ROWS // 128) * 128
    multiset = len(set(got)) == len(got) == full_batches \
        and len(set(rows['thread'])) == len(rows['thread']) == full_batches \
        and set(got) <= set(range(MNIST_ROWS))
    log('mnist resume (4 decode threads): %d + %d rows, each at most once, %d in all as in the '
        'uninterrupted run (the last %d rows of the epoch form no full batch): %s'
        % (len(rows['first']), len(rows['rest']), len(got), MNIST_ROWS - full_batches,
           multiset))
    if not multiset:
        raise AssertionError('mnist resume on 4 threads lost or repeated rows')
    out['mnist'].update(resume_bitwise=same_batches and same_params, resume_multiset=multiset)
    with DataLoader(make_reader(mnist, num_epochs=1, workers_count=4), batch_size=128,
                    shuffling_queue_capacity=2048, seed=0) as loader:
        out['mnist'].update(snapshot_cost(loader, iter(loader), MNIST_SNAPSHOT_EVERY))
    log('mnist: state_dict %.3f ms (median of %d, 4 decode threads, one every %d batches), '
        'token %d bytes' % (out['mnist']['state_dict_ms'], SNAPSHOT_CALLS, MNIST_SNAPSHOT_EVERY,
                            out['mnist']['token_bytes']))
    # (b) the pumped loader with batches in flight
    def lm_loader(token):
        reader = make_reader(lm_url, num_epochs=1, columnar_decode=True, workers_count=1,
                             shuffle_row_groups=False,
                             resume_state=None if token is None else token['reader'])
        return DataLoader(reader, batch_size=8, prefetch=2, resume_state=token)

    out['lm'] = resume_pair('L1 tokens', lm_loader, 10)
    with lm_loader(None) as loader:
        out['lm'].update(snapshot_cost(loader, iter(loader), 4))
    log('resume [L1 tokens]: state_dict %.3f ms (median of %d, one every 4 batches), token %d '
        'bytes' % (out['lm']['state_dict_ms'], SNAPSHOT_CALLS, out['lm']['token_bytes']))

    def to_float(batch):
        return dict(batch, image=batch['image'].astype(np.float32) / 255.0)

    def image_loader(token):
        reader = make_reader(url, schema_fields=['image', 'noun_id'], columnar_decode=True,
                             transform_spec=make_transform((224, 224)), workers_count=1,
                             shuffle_row_groups=False, num_epochs=1,
                             resume_state=None if token is None else token['reader'])
        return DataLoader(reader, batch_size=BATCH, prefetch=2, transform_fn=to_float,
                          wire_dtypes='auto', resume_state=token)

    out['image_wire'] = resume_pair('images, float32 narrowed on the wire', image_loader, 3)
    with image_loader(None) as loader:
        it = iter(loader)
        for _ in range(3):
            next(it)
        wait_for_pending(loader)
        narrowed = loader.metrics.counter('h2d_bytes_wire').value \
            < loader.metrics.counter('h2d_bytes_logical').value
        out['image_wire'].update(snapshot_cost(loader), narrowed=narrowed)
    log('resume [images, wire narrowed: %s]: state_dict %.3f ms (median of %d back to back '
        'after 3 batches), token %d bytes'
        % (narrowed, out['image_wire']['state_dict_ms'], SNAPSHOT_CALLS,
           out['image_wire']['token_bytes']))
    if not narrowed:
        raise AssertionError('resume [images]: the wire was not narrowed')
    # (c) the HBM cache
    def hbm_loader(token, deterministic):
        # at an epoch boundary any complete cache serves, but the same
        # batches need the same cache order: one decode thread, no shuffle
        threads = 8 if deterministic else 1
        reader = make_reader(url, schema_fields=['image', 'noun_id'], columnar_decode=True,
                             transform_spec=make_transform((224, 224)), workers_count=threads,
                             shuffle_row_groups=deterministic, num_epochs=1)
        return DeviceInMemDataLoader(reader, BATCH, num_epochs=3, seed=29, resume_state=token,
                                     deterministic_cache_order=deterministic)

    def step(carry, batch):
        pixels = batch['image'].float().sum(dim=(1, 2, 3))
        return carry + pixels.mean(), {'label': batch['label'], 'pixels': pixels}

    def scan(loader, carry, max_yields=None):
        outs = []
        gen = loader.scan_epochs(step, carry)
        for carry, o in gen:
            outs.append((carry.clone(), {k: v.clone() for k, v in o.items()}))
            if len(outs) == max_yields:
                gen.close()
                break
        return outs

    def flat(outs):
        return {k: torch.cat([o[k].reshape((-1,) + tuple(o[k].shape[2:])) for _, o in outs])
                .cpu() for k in ('label', 'pixels')}

    zero = torch.zeros((), device='cuda')
    hbm = {}
    for label, deterministic, cut in (('epoch boundary', False, None), ('mid-epoch', True, 3)):
        with hbm_loader(None, deterministic) as loader:
            full = scan(loader, zero)
        with hbm_loader(None, deterministic) as loader:
            if cut is None:   # one scan yield: the first epoch
                head = scan(loader, zero, max_yields=1)
                carry = head[-1][0]
            else:             # cut steps of the per-step iterator
                head, carry = [], None
                it = iter(loader)
                for _ in range(cut):
                    next(it)
            cost = snapshot_cost(loader)
            token = pickle.loads(pickle.dumps(loader.state_dict()))
        with hbm_loader(token, deterministic) as loader:
            rest = scan(loader, zero if carry is None else carry)
        want, got = flat(full), flat(head + rest)
        skip = 0 if cut is None else cut * BATCH
        equal = all(torch.equal(got[k], want[k][skip:]) for k in want)
        if carry is not None:   # the carry went on from the checkpointed one
            equal = equal and torch.equal(rest[-1][0], full[-1][0])
        log('resume [hbm cache, %s]: token %s; %d + %d scan yields; the outs%s equal the '
            'uninterrupted run bit for bit: %s (state_dict %.4f ms, %d bytes)'
            % (label, token['device_inmem'], len(head), len(rest),
               ' and the final carry' if carry is not None else '', equal,
               cost['state_dict_ms'], cost['token_bytes']))
        if not equal:
            raise AssertionError('resume [hbm cache, %s] differs' % label)
        hbm[label] = dict(cost, equal=equal)
    out['hbm_cache'] = hbm
    launches, _ = counts(fa)
    if any(launches.values()):
        raise AssertionError('resume: flash launches %s on a path without attention' % launches)
    SUMMARY['resume'] = out

BR_ROWS = 1 << 20       # the batch phase's Criteo-shaped store: 256 row groups of 4096
BR_GROUP = 4096
DLRM_BATCH = 2048       # the Criteo example's batch
DLRM_EQ_STEPS = 20      # eager against graphed, bit for bit
BR_RESUME_SHARDS = 8    # the resumed loader reads one shard of this many (32 row groups)


def table_digests(batches):
    """One sha256 per batch (a row group of the batch reader): its columns'
    bytes in name order, sorted; the multiset of what was read."""
    out = []
    for b in batches:
        h = hashlib.sha256()
        for name in sorted(b):
            h.update(np.ascontiguousarray(b[name]).tobytes())
        out.append(h.hexdigest())
    return sorted(out)


def read_all(url, **kwargs):
    """Every batch of ``make_batch_reader(url, **kwargs)`` as dicts, the
    reader's diagnostics and the rows/s of the read (host only)."""
    from petastorm_tpu_torch.reader import make_batch_reader
    t0 = time.perf_counter()
    reader = make_batch_reader(url, **kwargs)
    with reader:
        batches = [b._asdict() for b in reader]
    elapsed = time.perf_counter() - t0
    return batches, reader.diagnostics, sum(len(b['label']) for b in batches) / elapsed


def scan_profile(run, tmp, label, k):
    """Device busy ms and share and kernels per step of ``run()``, a
    ``scan_batches`` run of ``k`` steps a chunk, under torch.profiler, from
    the start of the second chunk replayed after the capture to the start of
    the last (:func:`_step_starts`: the warm-up chunk's ``k`` eager steps
    start first, then each replayed chunk, the capture's included)."""
    from torch.profiler import ProfilerActivity, profile
    path = os.path.join(tmp, 'trace_%s.json' % label.replace(' ', '_'))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)['traceEvents']
    events = sorted((e for e in trace if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')),
                    key=lambda e: e['ts'])
    replays = _step_starts(trace, events)[k:]
    if len(replays) < 4:
        raise AssertionError('profile %s: %d chunk replays' % (label, len(replays)))
    i, j = _recorded_span(replays, 1, len(replays) - 1, label)
    lo, hi = replays[i][0], replays[j][0]
    busy, end = 0.0, lo
    for e in events:
        t0, t1 = max(e['ts'], lo), min(e['ts'] + e['dur'], hi)
        if t1 > max(t0, end):
            busy += t1 - max(t0, end)
            end = t1
    steps = (j - i) * k
    kernels = sum(1 for e in events if e.get('cat') == 'kernel' and lo <= e['ts'] < hi)
    return dict(steps=steps, step_ms=(hi - lo) / steps / 1e3, busy_ms=busy / steps / 1e3,
                busy_pct=100.0 * busy / (hi - lo), kernels=kernels / steps)


def phase_batch_reader(fa, tmp):
    """The batch path over plain Parquet (``make_batch_reader``), BASELINE
    configs #4 and #2 and the DataFrame converter.

    (a) A Criteo-shaped store of ``BR_ROWS`` rows (``train_dlrm``'s
    generator: 13 float32, 26 int32 ids, an int32 label; row groups of
    4096).  The dummy pool without shuffle reads it back equal to
    ``pq.read_table``, column by column; 4 threads and 8 processes read
    the dummy pool's multiset of row groups (sha256 each), the processes
    through /dev/shm, leaving no slab and no child; each read's rows/s
    (the reader alone, host only).  A predicate (``in_set`` on ``cat_0``,
    evaluated per row in Python) keeps exactly the rows a numpy mask over
    the table keeps, and ``filters=[('dense_0', '>', 40.0)]`` exactly the
    row groups whose values pass (statistics prune whole row groups).
    (b) DLRM at the example's width (batch 2048, the 26 tables, embedding
    dim 16, 64-32-16 and 64-32-1) for one epoch of the store (512 steps)
    graphed, pumped, 4 decode threads: rows/s, step ms, host ms, data wait
    and ``stall_pct``; a profile of its step (``phase_profile``); the same
    eagerly (and its profile) and with ``--scan-steps 4`` (its profile over
    the chunks replayed); then eager and graphed from the same weights and data
    order (one decode thread, no shuffle) for 20 steps: losses and
    parameters equal bit for bit.  (c) Both hello-world flows on the card,
    ids and shapes against the generators.  (d) The converter example: its
    512-row frame materialized, the logistic regression trained 2 epochs on
    the card, the cache deleted and gone.  (e) A pumped batch loader (one
    thread, no shuffle, one shard of 8) cut after 10 batches with device
    batches in flight, resumed in fresh objects: the rest bit for bit.  No
    flash kernel runs here."""
    import pyarrow.parquet as pq
    from petastorm_tpu_torch import hello_world, predicates, train_dlrm
    from petastorm_tpu_torch.gpu import DataLoader
    from petastorm_tpu_torch.reader import make_batch_reader
    from petastorm_tpu_torch.spark import converter_example
    reset_counts(fa)
    out = {}
    # (a) the reader
    url = 'file://' + os.path.join(tmp, 'criteo')
    t0 = time.monotonic()
    train_dlrm.generate_criteo_parquet(url, rows_count=BR_ROWS, rows_per_group=BR_GROUP)
    table = pq.read_table(os.path.join(tmp, 'criteo', 'data.parquet'))
    out['store'] = {'rows': table.num_rows, 'row_groups': BR_ROWS // BR_GROUP,
                    'mb': os.path.getsize(os.path.join(tmp, 'criteo', 'data.parquet')) / 1e6,
                    'write_s': time.monotonic() - t0}
    log('batch reader: Criteo-shaped store, %d rows in %d row groups, %.1f MB, written in %.1f s'
        % (table.num_rows, out['store']['row_groups'], out['store']['mb'],
           out['store']['write_s']))
    columns = {name: table.column(name).to_numpy() for name in table.column_names}
    dummy, _, rate = read_all(url, reader_pool_type='dummy', shuffle_row_groups=False)
    equal = sorted(dummy[0]) == sorted(columns) and all(
        np.array_equal(np.concatenate([b[k] for b in dummy]), v) for k, v in columns.items())
    want = table_digests(dummy)
    reads = {'dummy': {'rows_per_s': rate, 'equal_to_read_table': equal}}
    log('batch reader [dummy, no shuffle]: %d batches, equal to pq.read_table column by column: '
        '%s; %.0f rows/s' % (len(dummy), equal, rate))
    if not equal or len(dummy) != BR_ROWS // BR_GROUP:
        raise AssertionError('batch reader: the dummy pool does not read the table back')
    del dummy
    for pool, workers in (('thread', 4), ('process', 8)):
        got, diag, rate = read_all(url, reader_pool_type=pool, workers_count=workers)
        same = table_digests(got) == want
        del got
        reads['%s %d' % (pool, workers)] = {'rows_per_s': rate, 'multiset_equal': same,
                                             'shm_results': diag.get('shm_results')}
        log('batch reader [%s %d]: the dummy pool\'s multiset of row groups: %s; %.0f rows/s%s'
            % (pool, workers, same, rate, '; %d tables through /dev/shm' % diag['shm_results']
               if pool == 'process' else ''))
        if not same:
            raise AssertionError('batch reader [%s %d]: another multiset' % (pool, workers))
        if pool == 'process':
            check_process_run('batch reader [process 8]', diag)
    keep = set(range(0, 1000, 100))
    t0 = time.perf_counter()
    got, _, _ = read_all(url, reader_pool_type='dummy', shuffle_row_groups=False,
                         predicate=predicates.in_set(keep, 'cat_0'))
    pred_rate = BR_ROWS / (time.perf_counter() - t0)
    mask = np.isin(columns['cat_0'], list(keep))
    same_pred = all(np.array_equal(np.concatenate([b[k] for b in got]), v[mask])
                    for k, v in columns.items())
    groups = np.unique(np.nonzero(columns['dense_0'] > 40.0)[0] // BR_GROUP)
    got_f, _, _ = read_all(url, reader_pool_type='dummy', shuffle_row_groups=False,
                           filters=[('dense_0', '>', 40.0)])
    rows_f = np.isin(np.arange(BR_ROWS) // BR_GROUP, groups)
    same_filter = len(got_f) == len(groups) and all(
        np.array_equal(np.concatenate([b[k] for b in got_f]), v[rows_f])
        for k, v in columns.items())
    reads['predicate'] = {'rows_kept': int(mask.sum()), 'equal_to_mask': same_pred,
                          'rows_per_s': pred_rate}
    reads['filters'] = {'row_groups_kept': len(got_f), 'equal_to_mask': same_filter}
    log('batch reader: predicate in_set(cat_0) kept %d rows, equal to the numpy mask: %s (%.0f '
        'rows/s read, Python per row); filters dense_0 > 40 kept %d of %d row groups, equal to '
        'the mask of row groups: %s' % (mask.sum(), same_pred, pred_rate, len(got_f),
                                        BR_ROWS // BR_GROUP, same_filter))
    if not (same_pred and same_filter):
        raise AssertionError('batch reader: predicate %s, filters %s' % (same_pred, same_filter))
    del got, got_f, columns, table
    out['reads'] = reads
    # (b) DLRM
    def dlrm(**kwargs):
        return train_dlrm.train(url, epochs=1, batch_size=DLRM_BATCH, **kwargs)

    dlrm_out = {}
    for mode, kwargs in (('graphed', {}), ('eager', dict(cuda_graph=False)),
                         ('scan 4', dict(scan_steps=4))):
        result = dlrm(**kwargs)
        e = result['epochs_run'][0]
        row = {k: e[k] for k in ('steps', 'loss', 'rows_per_s', 'timed_rows_per_s', 'step_ms',
                                 'host_ms', 'data_wait_ms', 'stall_pct')}
        dlrm_out[mode] = row
        log('dlrm [%s, pumped, 4 decode threads, graph: %s]: %d steps, loss %.4f; rows/s %.1f '
            '(timed after the warm-up; %.1f over the epoch) step_ms %.4f host_ms %.4f '
            'data_wait_ms %s stall_pct %s'
            % (mode, result['cuda_graph'], e['steps'], e['loss'], e['timed_rows_per_s'],
               e['rows_per_s'], e['step_ms'], e['host_ms'], e['data_wait_ms'], e['stall_pct']))
        if e['steps'] != BR_ROWS // DLRM_BATCH or not np.isfinite(result['losses']).all() \
                or result['device'] != 'cuda' or result['cuda_graph'] != (mode != 'eager'):
            raise AssertionError('dlrm [%s]: %r' % (mode, row))
    for mode, flag in (('graphed', None), ('eager', False)):
        dlrm_out[mode]['profile'] = phase_profile(
            lambda steps: dlrm(max_steps=steps, cuda_graph=flag), 'dlrm ' + mode, tmp)
    scan_busy = scan_profile(lambda: dlrm(scan_steps=4, max_steps=64), tmp, 'dlrm scan', 4)
    dlrm_out['scan 4']['profile'] = scan_busy
    log('profile dlrm scan 4 (the chunks replayed after the capture\'s, %d steps under '
        'torch.profiler, %.3f ms per step): device busy %.3f ms per step (%.1f%%); %.1f kernels '
        'per step' % (scan_busy['steps'], scan_busy['step_ms'], scan_busy['busy_ms'],
                      scan_busy['busy_pct'], scan_busy['kernels']))
    ordered = dict(reader_kwargs=dict(workers_count=1, shuffle_row_groups=False),
                   max_steps=DLRM_EQ_STEPS)
    eager, graphed = dlrm(cuda_graph=False, **ordered), dlrm(**ordered)
    loss_rel, differ, worst, n_state = _differences(graphed, eager)
    bitwise = loss_rel == 0.0 and differ == 0
    dlrm_out['eager_vs_graphed'] = dict(steps=len(eager['losses']), loss_rel=loss_rel,
                                        state_differ=differ, state_rel=worst, bitwise=bitwise)
    log('dlrm eager vs graphed, same weights and data order, %d steps: %s; losses %s'
        % (len(eager['losses']), 'equal bit for bit' if bitwise else
           'loss off by %.3g (relative), %d of %d state tensors differ, worst %.3g'
           % (loss_rel, differ, n_state, worst),
           ' '.join('%.6f' % x for x in graphed['losses'])))
    if not bitwise:
        raise AssertionError('dlrm: the graphed run is not the eager one bit for bit')
    out['dlrm'] = dlrm_out
    # (c) hello world
    hw = os.path.join(tmp, 'hello_world')
    seen = hello_world.petastorm_hello_world(hello_world.generate_petastorm_dataset(
        'file://' + os.path.join(hw, 'petastorm')), device='cuda')
    ids = sorted(int(i) for batch_ids, _ in seen for i in batch_ids)
    shapes = {shape for _, shape in seen}
    external = hello_world.python_hello_world(hello_world.generate_external_dataset(
        'file://' + os.path.join(hw, 'external')))
    ext_ids = sorted(int(i) for b in external for i in b)
    ok = len(seen) == 2 and len(set(ids)) == 8 and set(ids) <= set(range(10)) \
        and shapes == {(4, 128, 256, 3)} and ext_ids == list(range(100)) and len(external) == 4
    log('hello world: petastorm flow %d batches on the card, ids %s, image1 %s; external flow %d '
        'batches, ids 0..99 once each: %s' % (len(seen), ids, sorted(shapes), len(external),
                                              ext_ids == list(range(100))))
    if not ok:
        raise AssertionError('hello world: %r %r' % (ids, shapes))
    out['hello_world'] = {'petastorm_batches': len(seen), 'external_batches': len(external)}
    # (d) the converter
    conv = converter_example.main(['--parent-cache-dir-url',
                                   'file://' + os.path.join(tmp, 'converter_cache')])
    gone = not os.path.exists(conv['cache_dir_url'][len('file://'):])
    log('converter: %d steps on %s, loss %.4f -> %.4f, cache deleted and gone: %s'
        % (conv['steps'], conv['w'].device, conv['losses'][0], conv['losses'][-1], gone))
    if conv['steps'] != 16 or conv['w'].device.type != 'cuda' or not gone \
            or not np.isfinite(conv['losses']).all():
        raise AssertionError('converter: %r' % {k: conv[k] for k in ('steps', 'losses')})
    out['converter'] = {'steps': conv['steps'], 'loss_first': conv['losses'][0],
                        'loss_last': conv['losses'][-1], 'deleted': gone}
    # (e) a resume on the batch path
    def batch_loader(token):
        reader = make_batch_reader(url, num_epochs=1, workers_count=1, shuffle_row_groups=False,
                                   cur_shard=0, shard_count=BR_RESUME_SHARDS,
                                   resume_state=None if token is None else token['reader'])
        return DataLoader(reader, batch_size=DLRM_BATCH, prefetch=2,
                          transform_fn=train_dlrm.pack_columns, resume_state=token)

    out['resume'] = resume_pair('criteo batch reader', batch_loader, 10)
    launches, _ = counts(fa)
    if any(launches.values()):
        raise AssertionError('batch reader: flash launches %s on a path without attention'
                             % launches)
    SUMMARY['batch_reader'] = out


FOOTER_FIXTURE = os.path.join('tests', 'data', 'reference_unischema_footer.b64')
FOOTER_ROWS = 12


def footer_rows():
    """The rows of ``tests/test_reference_compat.py``'s store: an int32 id,
    a nullable string, a Decimal, a (4, 3) float32 ``NdarrayCodec``, an (8,)
    float64 ``CompressedNdarrayCodec`` and a 6x5x3 PNG."""
    from decimal import Decimal
    rng = np.random.default_rng(7)
    return [{'id': np.int32(i), 'label': 'item-%d' % i if i % 3 else None,
             'price': Decimal('%d.%02d' % (i, i)),
             'matrix': rng.standard_normal((4, 3)).astype(np.float32),
             'sparse': rng.standard_normal(8).astype(np.float64),
             'image': rng.integers(0, 255, (6, 5, 3), dtype=np.uint8)}
            for i in range(FOOTER_ROWS)]


def footer_reads(root):
    """Write the store of ``tests/test_reference_compat.py`` under ``root``
    with the port's writer, put the frozen upstream footer bytes in its
    ``_common_metadata``, and read it through ``make_reader`` (dummy, 4
    threads, 2 processes) and ``make_batch_reader``; returns what matched
    the written rows."""
    import base64
    from decimal import Decimal
    import pyarrow.parquet as pq
    from petastorm_tpu_torch.etl import dataset_metadata as dm
    from petastorm_tpu_torch.reader import make_batch_reader, make_reader
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), FOOTER_FIXTURE)) as f:
        blob = base64.b64decode(f.read())
    path = os.path.join(root, 'reference_footer')
    rows = footer_rows()
    with dm.DatasetWriter('file://' + path, dm._loads_schema(blob), rows_per_rowgroup=4) as w:
        w.write_many(rows)
    meta = os.path.join(path, '_common_metadata')
    arrow_schema = pq.read_schema(meta)
    metadata = dict(arrow_schema.metadata)
    metadata[dm.UNISCHEMA_KEY] = blob
    pq.write_metadata(arrow_schema.with_metadata(metadata), meta)
    out = {'upstream_bytes': b'petastorm.unischema' in blob and b'petastorm_tpu' not in blob}
    for pool, workers in (('dummy', 1), ('thread', 4), ('process', 2)):
        with make_reader('file://' + path, reader_pool_type=pool, workers_count=workers) as r:
            got = sorted((x._asdict() for x in r), key=lambda x: int(x['id']))
        out['make_reader ' + pool] = len(got) == len(rows) and all(
            int(g['id']) == int(w['id']) and g['label'] == w['label']
            and Decimal(g['price']) == w['price']
            and all(g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
                    for k in ('matrix', 'sparse', 'image'))
            for g, w in zip(got, rows))
    with make_batch_reader('file://' + path, reader_pool_type='dummy',
                           shuffle_row_groups=False) as r:
        batches = list(r)
    out['make_batch_reader'] = r.schema.name == 'RefSchema' and \
        np.concatenate([b.id for b in batches]).tolist() == list(range(len(rows))) and \
        [Decimal(p) for b in batches for p in b.price] == [w['price'] for w in rows] and \
        [s for b in batches for s in b.label] == [w['label'] for w in rows]
    return out


FOOTER_SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
out = chip_smoke.footer_reads(sys.argv[2])
out['loaded'] = sorted(m for m in sys.modules
                       if m.split('.')[0] in ('petastorm', 'petastorm_tpu', 'jax', 'pyspark'))
print(json.dumps(out))
"""


def phase_reference_footer(tmp):
    """A store whose footer is upstream petastorm's (the frozen bytes of
    ``tests/data/reference_unischema_footer.b64``: ``petastorm.unischema``
    and ``petastorm.codecs`` classes, Spark SQL types in ``ScalarCodec``)
    on this host, which has no pyspark, in a process of its own: every
    column of ``make_reader`` decoded equal to the written rows (the
    Decimal and the nullable string included) on the dummy pool, 4 threads
    and 2 processes, ``make_batch_reader`` with the stored schema, and
    afterwards neither ``petastorm`` nor ``petastorm_tpu`` nor ``jax`` (nor
    ``pyspark``) in ``sys.modules``."""
    root = os.path.join(tmp, 'footer')
    os.makedirs(root)
    proc = subprocess.run([sys.executable, '-c', FOOTER_SCRIPT,
                           os.path.dirname(os.path.abspath(__file__)), root],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError('reference footer: the reads failed:\n' + proc.stdout
                             + proc.stderr[-4000:])
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    log('reference footer: upstream bytes %s; make_reader rows equal to the written ones '
        '(every codec column decoded) on dummy %s, 4 threads %s, 2 processes %s; '
        'make_batch_reader with the stored schema %s; modules loaded of petastorm, '
        'petastorm_tpu, jax, pyspark: %s'
        % (out['upstream_bytes'], out['make_reader dummy'], out['make_reader thread'],
           out['make_reader process'], out['make_batch_reader'], out['loaded'] or 'none'))
    if out['loaded'] or not all(v for k, v in out.items() if k != 'loaded'):
        raise AssertionError('reference footer: %r' % out)
    SUMMARY['reference_footer'] = out
    return out


NGRAM_ROWS = 1 << 17        # 3.6 h of a 10 Hz sensor log: 1,311 row groups of up to 100
NGRAM_WINDOWS = 125828      # the windows of one epoch, from the example's generator
NGRAM_BATCH = 32            # the example's batch
NGRAM_EQ_STEPS = 300        # eager against graphed, bit for bit
NGRAM_SHARDS = 8            # the resume and echo runs read one shard of this many


def loop_profile(run, label, tmp, steps=64):
    """The device's share of a loop of small steps: ``run(steps)`` under
    torch.profiler, over the host window of steps 3..steps, from the start
    of their first ``train_step`` range to the end of the last (the loop's
    thread's; a graphed run's capture adds one range of its own before the
    second step's replay): the kernels that start in it per step and the
    union of device activity in it.  No launch is matched to its step (:func:`phase_profile` does that,
    and with steps of a few microsecond kernels a run can lose some of
    those records): the card, almost idle, runs each kernel right after its
    launch."""
    from torch.profiler import ProfilerActivity, profile
    path = os.path.join(tmp, 'trace_%s.json' % label.replace(' ', '_'))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(steps)
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)['traceEvents']
    tid = _step_tid(trace)
    ranges = sorted((e['ts'], e['ts'] + e['dur']) for e in trace
                    if e.get('cat') == 'user_annotation' and e['name'] == 'train_step'
                    and e['tid'] == tid)
    if len(ranges) < steps:
        raise AssertionError('profile %s: %d train_step ranges for %d steps'
                             % (label, len(ranges), steps))
    n = steps - 2
    lo, hi = ranges[-n][0], ranges[-1][1]
    events = sorted((e for e in trace if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')
                     and lo <= e['ts'] < hi), key=lambda e: e['ts'])
    busy, end = 0.0, lo
    for e in events:
        t1 = min(e['ts'] + e['dur'], hi)
        if t1 > end:
            busy += t1 - max(e['ts'], end)
            end = t1
    kernels = sum(1 for e in events if e['cat'] == 'kernel')
    out = dict(step_ms=(hi - lo) / n / 1e3, busy_ms=busy / n / 1e3,
               busy_pct=100.0 * busy / (hi - lo), kernels=kernels / n)
    log('profile %s (steps 3..%d under torch.profiler, %.3f ms per step): device busy %.4f ms '
        'per step (%.2f%%); %.2f kernels per step'
        % (label, steps, out['step_ms'], out['busy_ms'], out['busy_pct'], out['kernels']))
    return out


def window_digests(reader):
    """One blake2b per window of an NGram reader (each offset's fields, in
    order, name and bytes), sorted: the multiset of what was read; and
    the windows/s of the read (the reader alone, host only)."""
    t0 = time.perf_counter()
    out = []
    for window in reader:
        h = hashlib.blake2b(digest_size=16)
        for offset in sorted(window):
            for name, value in window[offset]._asdict().items():
                h.update(b'%d %s ' % (offset, name.encode()))
                h.update(np.ascontiguousarray(value).tobytes())
        out.append(h.digest())
    rate = len(out) / (time.perf_counter() - t0)
    return sorted(out), rate


def phase_ngram(fa, tmp):
    """NGram windows over the sensor log (BASELINE config #5,
    ``examples/ngram_sensor/jax_example.py``) through
    ``petastorm_tpu_torch.ngram_sensor``.

    (a) The example's generator at ``NGRAM_ROWS`` rows (its schema, widths,
    100-row row groups and dropout every 50 rows as they are).  (b) The
    reader alone (host only): the example's NGram over one epoch on the
    dummy pool, 4 threads and 8 processes, each ``NGRAM_WINDOWS`` windows,
    the pools' multisets of windows (digests of each offset's fields)
    equal to the dummy pool's, windows/s each; the processes through
    /dev/shm, leaving no slab and no child.  (c) The example's loop on the
    card: ``DataLoader(batch_size=32, transform_fn=collate)``, pumped, 4
    decode threads, ``predict_speed`` graphed and eager over one epoch
    (3,932 batches): windows/s, step ms, host ms, data wait and
    ``stall_pct``; the device's share and kernels per step of each
    (:func:`loop_profile`); then
    eager and graphed over ``NGRAM_EQ_STEPS`` batches in one data order
    (the dummy pool): equal bit for bit.  (d) One shard of ``NGRAM_SHARDS``
    with ``shuffling_queue_capacity=2048, seed=0``, pumped: a token taken
    with batches in flight resumes bit for bit.  (e) The same shard with
    ``echo=2``: twice the batches, each repeat equal to its batch, and the
    batches once each equal to the run without echo.  No flash kernel runs
    here."""
    from petastorm_tpu_torch import ngram_sensor
    from petastorm_tpu_torch.gpu import DataLoader
    from petastorm_tpu_torch.reader import make_reader
    reset_counts(fa)
    out = {}
    url = 'file://' + os.path.join(tmp, 'ngram_sensor')
    t0 = time.monotonic()
    ngram_sensor.generate(url, rows=NGRAM_ROWS)
    size = sum(os.path.getsize(os.path.join(tmp, 'ngram_sensor', f))
               for f in os.listdir(os.path.join(tmp, 'ngram_sensor')))
    with make_reader(url, reader_pool_type='dummy') as reader:
        row_groups = len(reader._worker_args.pieces)
        rows = reader.num_local_rows()
    out['store'] = {'rows': rows, 'row_groups': row_groups, 'mb': size / 1e6,
                    'write_s': time.monotonic() - t0}
    log('ngram: sensor log of %d rows in %d row groups, %.1f MB, written in %.1f s'
        % (rows, row_groups, size / 1e6, out['store']['write_s']))
    if rows != NGRAM_ROWS or row_groups != -(-NGRAM_ROWS // 100):
        raise AssertionError('ngram: the store holds %d rows in %d row groups'
                             % (rows, row_groups))
    # (b) the reader alone
    reads, want = {}, None
    for pool, workers in (('dummy', 1), ('thread', 4), ('process', 8)):
        reader = make_reader(url, schema_fields=ngram_sensor.make_ngram(),
                             reader_pool_type=pool, workers_count=workers,
                             shuffle_row_groups=False)
        with reader:
            digests, rate = window_digests(reader)
        want = digests if want is None else want
        same = digests == want
        reads['%s %d' % (pool, workers)] = {'windows': len(digests), 'windows_per_s': rate,
                                             'multiset_equal': same}
        log('ngram reader [%s %d]: %d windows, the dummy pool\'s multiset: %s; %.0f windows/s'
            % (pool, workers, len(digests), same, rate))
        if len(digests) != NGRAM_WINDOWS or not same:
            raise AssertionError('ngram reader [%s %d]: %d windows, same %s'
                                 % (pool, workers, len(digests), same))
        if pool == 'process':
            # a row group's windows (100 rows of 140 B of arrays) stay under
            # the shm plane's 32 kB floor: they take the byte path
            from petastorm_tpu_torch.workers_pool import shm_plane
            diag = reader.diagnostics
            reads['process 8']['shm_results'] = diag['shm_results']
            left = shm_plane.residue(diag['worker_pids'])
            if left or live_children():
                raise AssertionError('ngram reader [process 8]: left slabs %s and children %s'
                                     % (sorted(left), live_children()))
    del want
    out['reads'] = reads
    # (c) the example's loop on the card
    loops = {}
    batches = NGRAM_WINDOWS // NGRAM_BATCH
    for mode, flag in (('graphed', None), ('eager', False)):
        result = ngram_sensor.run(url, device='cuda', cuda_graph=flag, verbose=mode == 'graphed',
                                  reader_kwargs=dict(workers_count=4))
        row = {k: result[k] for k in ('batches', 'windows', 'windows_per_s', 'step_ms',
                                      'host_ms', 'data_wait_ms', 'stall_pct')}
        loops[mode] = row
        log('ngram [%s, pumped, 4 decode threads, graph: %s]: %d batches of %d windows; '
            'windows/s %.1f (timed after the warm-up) step_ms %.4f host_ms %.4f data_wait_ms '
            '%.4f stall_pct %s'
            % (mode, result['cuda_graph'], result['batches'], NGRAM_BATCH,
               result['windows_per_s'], result['step_ms'], result['host_ms'],
               result['data_wait_ms'], result['stall_pct']))
        finite = all(bool(torch.isfinite(o).all()) for o in result['outputs'])
        if result['batches'] != batches or result['cuda_graph'] != (mode == 'graphed') \
                or not finite or result['outputs'][0].device.type != 'cuda':
            raise AssertionError('ngram [%s]: %r, finite %s' % (mode, row, finite))
    for mode, flag in (('graphed', None), ('eager', False)):
        loops[mode]['profile'] = loop_profile(
            lambda steps: ngram_sensor.run(url, device='cuda', cuda_graph=flag, verbose=False,
                                           reader_kwargs=dict(workers_count=4),
                                           max_steps=steps), 'ngram ' + mode, tmp)
    ordered = dict(reader_kwargs=dict(reader_pool_type='dummy'), max_steps=NGRAM_EQ_STEPS,
                   verbose=False, device='cuda')
    eager = ngram_sensor.run(url, cuda_graph=False, **ordered)['outputs']
    graphed = ngram_sensor.run(url, **ordered)['outputs']
    bitwise = len(eager) == len(graphed) == NGRAM_EQ_STEPS and all(
        torch.equal(a, b) for a, b in zip(eager, graphed))
    loops['eager_vs_graphed'] = {'steps': len(eager), 'bitwise': bitwise}
    log('ngram eager vs graphed, one data order, %d batches: %s'
        % (len(eager), 'equal bit for bit' if bitwise else 'DIFFERENT'))
    if not bitwise:
        raise AssertionError('ngram: the graphed run is not the eager one bit for bit')
    out['loop'] = loops
    # (d) a resume with the shuffling buffer, (e) echo
    def shard_loader(token, **loader_kwargs):
        reader = make_reader(url, schema_fields=ngram_sensor.make_ngram(), num_epochs=1,
                             workers_count=1, shuffle_row_groups=False, cur_shard=0,
                             shard_count=NGRAM_SHARDS,
                             resume_state=None if token is None else token['reader'])
        return DataLoader(reader, batch_size=NGRAM_BATCH, transform_fn=ngram_sensor.collate,
                          resume_state=token, **loader_kwargs)

    out['resume'] = resume_pair('ngram, shuffling buffer 2048', lambda token: shard_loader(
        token, shuffling_queue_capacity=2048, seed=0), 40)
    with shard_loader(None) as loader:
        plain = [batch_digest(b) for b in loader]
    with shard_loader(None, echo=2) as loader:
        echoed = [batch_digest(b) for b in loader]
    pairs = echoed[::2] == echoed[1::2] == plain and len(echoed) == 2 * len(plain)
    out['echo'] = {'batches': len(plain), 'echoed': len(echoed), 'pairs_equal': pairs}
    log('ngram echo=2: %d batches -> %d, each repeat equal to its batch and the batches those '
        'of the run without echo: %s' % (len(plain), len(echoed), pairs))
    if not pairs:
        raise AssertionError('ngram echo: %r' % out['echo'])
    launches, _ = counts(fa)
    if any(launches.values()):
        raise AssertionError('ngram: flash launches %s on a path without attention' % launches)
    SUMMARY['ngram'] = out
    return out


RES_SEED = 17           # the resident loaders' epoch orders: fold_in(PRNGKey(17), epoch)
RES_VIT_EPOCHS = 4      # 8 batches of 64 an epoch: epoch 0 streams, 1-3 are warm
RES_DLRM_EPOCHS = 3     # 512 batches of 2048 an epoch
RES_PROFILE_STEPS = 16  # DLRM steps profiled at the end of epochs 0 and 1


def kill_switched(loader):
    """``iter(loader)`` with the resident tier's kill switch set: the loader
    reads it there, once."""
    from petastorm_tpu_torch.gpu import residency
    os.environ[residency.KILL_SWITCH] = '1'
    try:
        return iter(loader)
    finally:
        del os.environ[residency.KILL_SWITCH]


def device_window(prof, wall_s, steps, tmp, label):
    """Kernels, copies and device busy time per step of a window of ``steps``
    steps under ``prof`` (every device record of it, the transfer thread's
    included), and the host's ms per step inside graph launch, kernel launch
    and copy calls (every thread's); ``wall_s`` is the window's host time."""
    path = os.path.join(tmp, 'trace_%s.json' % label.replace(' ', '_'))
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)['traceEvents']
    events = sorted((e for e in trace if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')),
                    key=lambda e: e['ts'])
    busy, end = 0.0, float('-inf')
    for e in events:
        t0, t1 = e['ts'], e['ts'] + e['dur']
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    kernels = sum(1 for e in events if e['cat'] == 'kernel')
    calls = {'graph_launch': 'GraphLaunch', 'kernel_launch': 'LaunchKernel', 'copy': 'Memcpy'}
    host = {k: sum(e.get('dur', 0) for e in trace if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                   and name in e['name']) / steps / 1e3 for k, name in calls.items()}
    return dict(kernels=kernels / steps, copies=(len(events) - kernels) / steps,
                busy_ms=busy / steps / 1e3, busy_pct=100.0 * busy / 1e6 / wall_s,
                host_call_ms=host)


def resident_epochs(loader, step, epochs, per_epoch, rows, label, tmp, warmup=2,
                    profile_epochs=()):
    """Run ``step`` on every batch of ``epochs`` epochs of ``per_epoch``
    batches from a ``ResidentDataLoader`` (keeping none: a training loop
    drops each batch after its step); returns the losses and a row per
    epoch: rows/s, step ms, host ms per step inside ``step``, data wait per
    step and ``stall_pct`` (the waits' share of wait plus step, as the stall
    monitor counts it) over the steps after the first ``warmup`` of epoch 0
    (the eager warm-up and the capture) and before a profiled window, with
    the device synchronized at both ends; the residency counters the epoch
    moved; with ``profile_epochs``, :func:`device_window` of the epoch's
    last ``RES_PROFILE_STEPS`` steps under torch.profiler; the warm epochs
    together.  The cache build (``iter``), each admission's host time and a
    streamed batch's slice-and-narrow and put-and-widen host times (the
    loader's ``stats``) are timed too."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    it = iter(loader)
    build_s = time.perf_counter() - t0
    admits = []
    if loader.tier is not None:
        admit = loader.tier.admit

        def timed_admit(*args):
            ta = time.perf_counter()
            out = admit(*args)
            admits.append(time.perf_counter() - ta)
            return out
        loader.tier.admit = timed_admit
    losses, table = [], []
    for epoch in range(epochs):
        skip = warmup if epoch == 0 else 0
        timed_end = per_epoch - (RES_PROFILE_STEPS if epoch in profile_epochs else 0)
        before = loader.residency_stats
        wait_s = host_s = 0.0
        prof = None
        for i in range(per_epoch):
            if i == skip:
                torch.cuda.synchronize()
                t_start = time.perf_counter()
            if i == timed_end:
                torch.cuda.synchronize()
                t_end = time.perf_counter()
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.__enter__()
            tw = time.perf_counter()
            batch = next(it)
            tb = time.perf_counter()
            losses.append(step(batch))
            if skip <= i < timed_end:
                wait_s += tb - tw
                host_s += time.perf_counter() - tb
        torch.cuda.synchronize()
        if prof is None:
            t_end = time.perf_counter()
        else:
            window_s = time.perf_counter() - t_end
            prof.__exit__(None, None, None)
        timed = timed_end - skip
        wall = t_end - t_start
        after = loader.residency_stats
        row = dict(epoch=epoch, steps=per_epoch, timed_steps=timed,
                   rows_per_s=timed * rows / wall, step_ms=1e3 * wall / timed,
                   host_ms=1e3 * host_s / timed, data_wait_ms=1e3 * wait_s / timed,
                   stall_pct=100.0 * wait_s / (wait_s + host_s),
                   residency={k: after[k] - before[k] for k in after})
        if prof is not None:
            row['profile'] = device_window(prof, window_s, RES_PROFILE_STEPS, tmp,
                                           '%s epoch %d' % (label, epoch))
        table.append(row)
        log('%s epoch %d (%s): %.1f rows/s, step_ms %.3f, host_ms %.3f, data_wait_ms %.3f, '
            'stall_pct %.1f over %d steps; residency %s%s'
            % (label, epoch, 'streamed' if row['residency']['host_batches'] else 'warm',
               row['rows_per_s'], row['step_ms'], row['host_ms'], row['data_wait_ms'],
               row['stall_pct'], timed, row['residency'],
               '; profile of its last %d steps: %.1f kernels and %.1f copies per step, device '
               'busy %.3f ms per step (%.1f%%); host ms per step in launch and copy calls %s'
               % (RES_PROFILE_STEPS, row['profile']['kernels'], row['profile']['copies'],
                  row['profile']['busy_ms'], row['profile']['busy_pct'],
                  {k: round(v, 3) for k, v in row['profile']['host_call_ms'].items()})
               if prof is not None else ''))
    if next(it, None) is not None:
        raise AssertionError('%s: the loader yields more than %d epochs' % (label, epochs))
    warm = [e for e in table if not e['residency']['host_batches']]
    together = None
    if warm:
        wall = sum(e['timed_steps'] * e['step_ms'] for e in warm)
        steps = sum(e['timed_steps'] for e in warm)
        together = dict(timed_steps=steps, rows_per_s=1e3 * steps * rows / wall,
                        step_ms=wall / steps, **{k: sum(e['timed_steps'] * e[k] for e in warm)
                                                  / steps for k in ('host_ms', 'data_wait_ms')})
        log('%s warm epochs together: %.1f rows/s, step_ms %.3f, host_ms %.3f, data_wait_ms '
            '%.3f over %d steps'
            % (label, together['rows_per_s'], together['step_ms'], together['host_ms'],
               together['data_wait_ms'], steps))
    stats = loader.stats
    streamed = loader.residency_stats['host_batches']
    losses = torch.stack(losses).float().cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError('%s: non-finite losses %s' % (label, losses))
    return losses, dict(build_s=build_s, epochs=table, warm=together,
                              admit_ms=1e3 * float(np.mean(admits)) if admits else None,
                              admissions=len(admits),
                              narrow_ms=1e3 * stats['host_batch_s'] / streamed,
                              put_ms=1e3 * stats['device_put_s'] / streamed)


def replay_ms(step, label, replays=20):
    """The step's graph alone, replayed back to back on its last inputs: the
    device's time for it (a replay costs the host microseconds), which a
    step at the device's pace cannot beat.  Call it after the path's launch
    counts are read: each replay counts its launches."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(replays):
        step.replay()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / replays
    log('%s: the step graph replayed alone, %.3f ms a replay' % (label, ms))
    return ms


def gather_host_ms(tier, n, batch, calls=200):
    """Host ms of one warm gather with the card idle (nothing to wait for),
    over ``calls`` gathers along an epoch order."""
    from petastorm_tpu_torch.gpu import residency
    order = torch.from_numpy(residency.epoch_permutation(RES_SEED, 1, n).astype(np.int64))
    order = order.cuda()
    tier.gather(order, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        tier.gather(order, (i % (n // batch)) * batch)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * host / calls


def same_batches(label, got, want):
    """Every batch of ``got`` equal to ``want``'s bit for bit on the card,
    field names and dtypes included."""
    if len(got) != len(want):
        raise AssertionError('%s: %d batches against %d' % (label, len(got), len(want)))
    for i, (g, w) in enumerate(zip(got, want)):
        if sorted(g) != sorted(w) or any(
                g[k].device.type != 'cuda' or g[k].dtype != w[k].dtype
                or not torch.equal(g[k], w[k]) for k in w):
            raise AssertionError('%s: batch %d differs' % (label, i))


def permutation_ms(n, epochs):
    """Host ms of each epoch's order, ``epoch_permutation(RES_SEED, e, n)``."""
    from petastorm_tpu_torch.gpu import residency
    out = []
    for e in range(epochs):
        t0 = time.perf_counter()
        residency.epoch_permutation(RES_SEED, e, n)
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def vit_resident_step():
    """The ViT-S/16 step as ``train`` builds it (seed-0 weights, SGD with
    momentum 0.9, crop, flip and normalize on the card from generator seed
    17, softmax cross-entropy), graphed."""
    from petastorm_tpu_torch.gpu import augment, graphs
    from petastorm_tpu_torch.train import _make_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hw = (224, 224)
    model = _make_model('vit', hw, {}).cuda().train()
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, dampening=0, nesterov=False)
    aug_gen = torch.Generator(device='cuda').manual_seed(17)

    def train_step(batch):
        with torch.profiler.record_function('train_step'):
            x = augment.random_crop(batch['image'], hw, padding=4, generator=aug_gen)
            x = augment.random_flip_left_right(x, generator=aug_gen)
            x = augment.normalize(x, dtype=torch.float32)
            loss = F.cross_entropy(model(x), batch['label'].long())
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return loss.detach()
    return graphs.StepGraph(train_step, generators=[aug_gen])


def dlrm_resident_step():
    """The Criteo example's DLRM step (seed-0 weights, Adagrad 1e-3, mean
    sigmoid cross-entropy) with its ``pack_columns`` moved onto the card:
    the widened dense columns stacked and ``log1p``-ed, the ids stacked, the
    label cast; graphed."""
    from petastorm_tpu_torch.gpu import graphs
    from petastorm_tpu_torch.models.dlrm import DLRM
    from petastorm_tpu_torch.optim import Adagrad
    from petastorm_tpu_torch.train_dlrm import NUM_CATEGORICAL, NUM_DENSE, VOCAB_SIZES
    torch.backends.cuda.matmul.allow_tf32 = False
    model = DLRM(VOCAB_SIZES, generator=torch.Generator().manual_seed(0)).cuda()
    opt = Adagrad(model.parameters(), lr=1e-3)
    dense = ['dense_%d' % i for i in range(NUM_DENSE)]
    cats = ['cat_%d' % i for i in range(NUM_CATEGORICAL)]

    def train_step(batch):
        with torch.profiler.record_function('train_step'):
            x = torch.log1p(torch.stack([batch[k] for k in dense], dim=1))
            ids = torch.stack([batch[k] for k in cats], dim=1)
            loss = F.binary_cross_entropy_with_logits(model(x, ids), batch['label'].float())
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return loss.detach()
    return graphs.StepGraph(train_step)


def phase_resident(fa, url, tmp):
    """The device-resident loader (``ResidentDataLoader``: the dataset in HBM
    in its wire dtypes, ``fold_in`` epoch orders, the batch LRU).

    (a) ViT-S/16 at full width from the 512-row JPEG store (8 decode
    threads, the content-sorted cache), batch 64, 4 epochs, seed 17, the
    ``train`` step graphed: epoch 0 streams 8 host batches, epochs 1-3 none
    (24 hits); the slabs hold 512 x 150,532 B (uint8 images, int32 labels,
    ``hbm_ratio`` 1.0); the losses are finite; 12 launches of each flash
    kernel a step, all on the tensor cores; the step graph replayed alone.
    Then a second pass over the loader (the same epochs, every one served
    from the tier): every batch equal, bit for bit on the card, to that of
    a kill-switch loader at the same (seed, epoch).  The timed pass keeps no
    batch, as a training loop does not.
    (b) DLRM at the Criteo example's width from ``phase_batch_reader``'s
    store of 2^20 rows (4 threads, the content-sorted cache), batch 2048,
    ``wire_dtypes='auto'``, 3 epochs, ``pack_columns`` in the graphed step:
    the loader with no budget (epochs 1-2 fetch no host batch; 160 B a row
    at full width, 134 on the wire, 13 float32 columns as bfloat16), timed
    per epoch with the kernels per step of the streamed epoch 0 and of the
    warm epoch 1, the step graph replayed alone, a warm gather's host time
    and a streamed batch's on the dispatch thread; then in lockstep a second
    pass of that loader (every epoch from the tier), a loader with a budget
    of half the wire bytes (every epoch streams, the LRU evicts and
    thrashes, no hit) and a kill-switch loader, every batch equal bit for
    bit.  Each epoch's permutation on the host is timed at both sizes."""
    from petastorm_tpu_torch.gpu import ResidentDataLoader, residency
    from petastorm_tpu_torch.reader import make_batch_reader, make_reader
    from petastorm_tpu_torch.train import make_transform
    out = {}
    # (a) ViT-S/16
    def vit_loader():
        reader = make_reader(url, schema_fields=['image', 'noun_id'],
                             transform_spec=make_transform((224, 224)), columnar_decode=True,
                             workers_count=8, num_epochs=1)
        return ResidentDataLoader(reader, BATCH, num_epochs=RES_VIT_EPOCHS, seed=RES_SEED,
                                  deterministic_cache_order=True)

    per_epoch = IMAGE_ROWS // BATCH
    step = vit_resident_step()
    reset_counts(fa)
    with vit_loader() as loader:
        losses, vit = resident_epochs(loader, step, RES_VIT_EPOCHS, per_epoch, BATCH,
                                      'resident vit', tmp)
        launches, by_design = counts(fa)
        vit['replay_ms'] = replay_ms(step, 'resident vit')
        stats = loader.residency_stats
        slab_bytes = sum(t.nbytes for t in loader.tier.slabs.values())
        plan = loader._plan
        on_card = {t.device.type for t in loader.tier.slabs.values()}
        # a second pass replays the same epochs, every one from the tier
        warm_pass = list(loader)
        second = {k: v - stats[k] for k, v in loader.residency_stats.items()}
        vit['gather_host_ms'] = gather_host_ms(loader.tier, IMAGE_ROWS, BATCH)
    check_launches('resident vit', launches, by_design,
                   {name: 12 * RES_VIT_EPOCHS * per_epoch for name in launches})
    with vit_loader() as killed:
        plain = list(kill_switched(killed))
        killed_stats = killed.residency_stats
    same_batches('resident vit, every epoch warm, against the kill switch', warm_pass, plain)
    if second != dict(admitted=0, evictions=0, hits=RES_VIT_EPOCHS * per_epoch, bypass=0,
                      thrash=0, host_batches=0):
        raise AssertionError('resident vit: the second pass moved %r' % second)
    vit.update(stats=stats, killed_stats=killed_stats, slab_mb=slab_bytes / 1e6,
               hbm_ratio=plan.logical_row_nbytes / plan.wire_row_nbytes,
               launches=launches, losses=[float(x) for x in losses],
               permutation_ms=permutation_ms(IMAGE_ROWS, RES_VIT_EPOCHS))
    del warm_pass, plain
    log('resident vit: cache built in %.2f s; %s; slabs %.2f MB on %s (hbm_ratio %.3f); a '
        'second pass (every epoch warm) equal to the kill-switch loader\'s bit for bit (%s); '
        'losses %s; flash launches '
        '%s; a streamed batch on the dispatch thread: slice and narrow %.3f, put and widen '
        '%.3f, admission %.3f host ms; a warm gather %.3f host ms (card idle); permutation of '
        '%d rows %s host ms per epoch'
        % (vit['build_s'], stats, vit['slab_mb'], on_card, vit['hbm_ratio'], killed_stats,
           ' '.join('%.4f' % x for x in losses), launches, vit['narrow_ms'], vit['put_ms'],
           vit['admit_ms'], vit['gather_host_ms'], IMAGE_ROWS,
           ' '.join('%.3f' % x for x in vit['permutation_ms'])))
    epochs = vit['epochs']
    if epochs[0]['residency']['host_batches'] != per_epoch \
            or any(e['residency']['host_batches'] for e in epochs[1:]) \
            or stats['hits'] != (RES_VIT_EPOCHS - 1) * per_epoch \
            or stats['admitted'] != per_epoch or stats['evictions'] or stats['bypass']:
        raise AssertionError('resident vit: %r' % [e['residency'] for e in epochs])
    if slab_bytes != IMAGE_ROWS * (224 * 224 * 3 + 4) or plan.narrowed or on_card != {'cuda'}:
        raise AssertionError('resident vit: slabs of %d B on %s, narrowed %s'
                             % (slab_bytes, on_card, plan.narrowed))
    if killed_stats['host_batches'] != RES_VIT_EPOCHS * per_epoch or killed_stats['hits']:
        raise AssertionError('resident vit: the kill-switch loader %r' % killed_stats)
    out['vit'] = vit
    # (b) Criteo -> DLRM
    criteo = 'file://' + os.path.join(tmp, 'criteo')
    dlrm_per_epoch = BR_ROWS // DLRM_BATCH

    def dlrm_loader(**kwargs):
        reader = make_batch_reader(criteo, num_epochs=1, workers_count=4)
        return ResidentDataLoader(reader, DLRM_BATCH, num_epochs=RES_DLRM_EPOCHS,
                                  seed=RES_SEED, wire_dtypes='auto',
                                  deterministic_cache_order=True, **kwargs)

    step = dlrm_resident_step()
    reset_counts(fa)
    total = RES_DLRM_EPOCHS * dlrm_per_epoch
    with dlrm_loader() as loader:
        losses, dlrm = resident_epochs(loader, step, RES_DLRM_EPOCHS, dlrm_per_epoch,
                                       DLRM_BATCH, 'resident dlrm', tmp, profile_epochs=(0, 1))
        dlrm['replay_ms'] = replay_ms(step, 'resident dlrm')
        stats = loader.residency_stats
        slab_bytes = sum(t.nbytes for t in loader.tier.slabs.values())
        plan = loader._plan
        dlrm['gather_host_ms'] = gather_host_ms(loader.tier, BR_ROWS, DLRM_BATCH)
        wire_fields = {k: str(f.wire).replace('torch.', '') for k, f in plan.fields.items()}
        dlrm.update(stats=stats, wire_bytes_per_row=plan.wire_row_nbytes,
                    logical_bytes_per_row=plan.logical_row_nbytes,
                    hbm_ratio=plan.logical_row_nbytes / plan.wire_row_nbytes,
                    slab_mb=slab_bytes / 1e6,
                    full_width_mb=BR_ROWS * plan.logical_row_nbytes / 1e6,
                    losses_first_last=[float(losses[0]), float(losses[-1])],
                    permutation_ms=permutation_ms(BR_ROWS, RES_DLRM_EPOCHS))
        log('resident dlrm: cache built in %.2f s; %s; %d B a row on the wire, %d at full width '
            '(hbm_ratio %.4f), slabs %.2f MB against %.2f MB at full width; bfloat16 fields %s; '
            'a streamed batch on the dispatch thread: slice and narrow %.3f, put and widen %.3f, '
            'admission %.3f host ms (over %d); a warm gather %.3f host ms (card idle); loss '
            '%.4f -> %.4f; permutation of %d rows %s host ms per epoch'
            % (dlrm['build_s'], stats, plan.wire_row_nbytes, plan.logical_row_nbytes,
               dlrm['hbm_ratio'], dlrm['slab_mb'], dlrm['full_width_mb'],
               sorted(k for k, w in wire_fields.items() if w == 'bfloat16'), dlrm['narrow_ms'],
               dlrm['put_ms'], dlrm['admit_ms'], dlrm['admissions'], dlrm['gather_host_ms'],
               losses[0], losses[-1], BR_ROWS,
               ' '.join('%.1f' % x for x in dlrm['permutation_ms'])))
        epochs = dlrm['epochs']
        if epochs[0]['residency']['host_batches'] != dlrm_per_epoch \
                or any(e['residency']['host_batches'] for e in epochs[1:]) \
                or stats['hits'] != (RES_DLRM_EPOCHS - 1) * dlrm_per_epoch:
            raise AssertionError('resident dlrm: %r' % [e['residency'] for e in epochs])
        if (plan.wire_row_nbytes, plan.logical_row_nbytes) != (134, 160) \
                or slab_bytes != BR_ROWS * 134:
            raise AssertionError('resident dlrm: %d and %d B a row, slabs %d B'
                                 % (plan.wire_row_nbytes, plan.logical_row_nbytes, slab_bytes))
        # the three regimes in lockstep: a second pass of this loader (the same
        # epochs, every one from the tier), a half budget and the kill switch
        budget = BR_ROWS * plan.wire_row_nbytes // 2
        with dlrm_loader(hbm_budget_bytes=budget) as tight, dlrm_loader() as killed:
            t0 = time.perf_counter()
            tight_it = iter(tight)
            tight_build = time.perf_counter() - t0
            t0 = time.perf_counter()
            killed_it = kill_switched(killed)
            killed_build = time.perf_counter() - t0
            before = loader.residency_stats
            t0 = time.perf_counter()
            for i, want in enumerate(loader):
                same_batches('resident dlrm step %d: half budget' % i, [next(tight_it)], [want])
                same_batches('resident dlrm step %d: kill switch' % i, [next(killed_it)], [want])
            lockstep_s = time.perf_counter() - t0
            if i + 1 != total or next(tight_it, None) is not None \
                    or next(killed_it, None) is not None:
                raise AssertionError('resident dlrm: the lockstep loaders yield other counts')
            tight_stats, killed_stats = tight.residency_stats, killed.residency_stats
        second = {k: v - before[k] for k, v in loader.residency_stats.items()}
    dlrm.update(half_budget=dict(budget_bytes=budget, build_s=tight_build, stats=tight_stats),
                killed=dict(build_s=killed_build, stats=killed_stats), lockstep_s=lockstep_s,
                second_pass=second)
    log('resident dlrm, three regimes in lockstep over %d batches (%.1f s): no budget (a second '
        'pass, every epoch warm: %s), a budget of %d B (half the wire bytes; cache built in '
        '%.2f s) %s, the kill switch (built in %.2f s) %s: every batch equal bit for bit'
        % (total, lockstep_s, second, budget, tight_build, tight_stats, killed_build,
           killed_stats))
    if second != dict(admitted=0, evictions=0, hits=total, bypass=0, thrash=0, host_batches=0):
        raise AssertionError('resident dlrm: the second pass moved %r' % second)
    if tight_stats['hits'] or tight_stats['host_batches'] != total \
            or not tight_stats['evictions'] or not tight_stats['thrash']:
        raise AssertionError('resident dlrm half budget: %r' % tight_stats)
    if killed_stats != dict(admitted=0, evictions=0, hits=0, bypass=0, thrash=0,
                            host_batches=total):
        raise AssertionError('resident dlrm kill switch: %r' % killed_stats)
    launches, _ = counts(fa)
    if any(launches.values()):
        raise AssertionError('resident dlrm: flash launches %s on a path without attention'
                             % launches)
    out['dlrm'] = dlrm
    SUMMARY['resident'] = out
    return vit['launches']


SEARCH_NEW = 64         # new tokens of each search, after two zipf prompts of 8
SEARCH_BEAMS = 4
SEARCH_DRAFT_LEN = 4
SEARCH_TEMPERATURE = 0.8


def share_equal(a, b):
    """The share of tokens two searches agree on."""
    return float((a == b).float().mean())


def search_turns(label, call, counted, expect):
    """``call(cuda_graph, new)`` graphed, eager, eager, graphed (a search
    returns tokens or ``(tokens, scores)``; all four must be equal bit for
    bit: graphed and eager, and under one key), the first graphed call
    counted by ``counted`` and its launches checked against ``expect``.
    Returns the result and ms per new token of each mode (host clock around
    the call, device synchronized)."""
    results, ms = [], {'graphed': [], 'eager': []}
    launches = None
    for i, mode in enumerate(('graphed', 'eager', 'eager', 'graphed')):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            out, launches = counted(lambda: call(None, SEARCH_NEW))
        else:
            out = call(False if mode == 'eager' else None, SEARCH_NEW)
        torch.cuda.synchronize()
        ms[mode].append(1e3 * (time.perf_counter() - t0) / SEARCH_NEW)
        results.append(out if isinstance(out, tuple) else (out,))
    for i, other in enumerate(results[1:], 1):
        for a, b in zip(results[0], other):
            if not torch.equal(a, b):
                raise AssertionError('search [%s]: call %d (%s) differs from the first graphed '
                                     'call' % (label, i + 1, ('graphed', 'eager', 'eager',
                                                              'graphed')[i]))
    check_launches('search [%s]' % label, launches[0], launches[1], expect)
    return results[0], {m: float(np.mean(v)) for m, v in ms.items()}


@contextlib.contextmanager
def graph_times():
    """The host ms of each ``StepGraph`` capture and replay made inside,
    the device synchronized before and after each (two lists, filled as
    they run)."""
    from petastorm_tpu_torch.gpu import graphs
    original = {name: getattr(graphs.StepGraph, name) for name in ('capture', 'replay')}
    times = {name: [] for name in original}

    def timed(name):
        def call(self, *inputs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = original[name](self, *inputs)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
            return out
        return call
    for name in original:
        setattr(graphs.StepGraph, name, timed(name))
    try:
        yield times
    finally:
        for name, fn in original.items():
            setattr(graphs.StepGraph, name, fn)


def search_costs(call):
    """Where a search's time goes.  Eager: what one more new token costs,
    ``call(False, new)`` at 16 and 64 new tokens in turns, ``(ms at 64 - ms
    at 16) / 48``, and the rest of a call ``ms at 64 - 64 * marginal``.
    Graphed (two calls at 64 new tokens; a capture's time varies from call
    to call by more than 48 tokens take, so no difference is taken): each
    capture's ms and the median ms of a replayed step (a token step or a
    round), the device synchronized around each."""
    totals = {}
    for new in (16, SEARCH_NEW, SEARCH_NEW, 16):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(False, new)
        torch.cuda.synchronize()
        totals.setdefault(new, []).append(1e3 * (time.perf_counter() - t0))
    marginal = (np.mean(totals[SEARCH_NEW]) - np.mean(totals[16])) / (SEARCH_NEW - 16)
    with graph_times() as times:
        for _ in range(2):
            call(None, SEARCH_NEW)
    return dict(eager_marginal_ms=float(marginal),
                eager_fixed_ms=float(np.mean(totals[SEARCH_NEW]) - SEARCH_NEW * marginal),
                capture_ms=[float(t) for t in times['capture']],
                replay_ms=float(np.median(times['replay'])), replays=len(times['replay']))


def costs_text(costs, step):
    return ('eager: %.4f ms per further token, %.1f ms of the rest of a call; graphed: a replayed '
            '%s %.4f ms (median of %d), captures %s ms'
            % (costs['eager_marginal_ms'], costs['eager_fixed_ms'], step, costs['replay_ms'],
               costs['replays'], ' / '.join('%.1f' % t for t in costs['capture_ms'])))


def gc_ms(calls=3):
    """Host ms of each of ``calls`` full garbage collections (one runs in
    every capture, :func:`graphs._collector_held`'s)."""
    import gc
    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        gc.collect()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def phase_search(fa, model):
    """Beam search and speculative decoding on the trained L2 model (the one
    ``phase_generate`` samples), two zipf prompts of 8 tokens as
    ``train_lm.sample`` makes them, 64 new tokens.

    ``beam_search`` with 4 beams, and again with an ``eos_id`` the first
    search emits; ``speculative_generate`` with ``draft_len`` 4, greedy and
    sampled (temperature 0.8, ``PRNGKey(0)``), against the model itself and
    a one-layer model of its width and vocabulary at random weights (seed
    99).  Each search graphed, eagerly twice and graphed again: all equal
    bit for bit (the sampled ones under one key); ``flash_fwd`` launched
    once per layer of each prefill (the beams' one prefill; the target's and
    the draft's), no backward kernel.  On an fp32 copy of the weights (and
    of the one-layer draft) a one-beam search and both greedy speculative
    runs equal greedy ``generate``; in bf16 the share of tokens that agree
    is logged.  Logged: ms per new token graphed and eager, rounds, drafts
    accepted per round and host syncs per token.  Returns the flash
    launches of the graphed searches."""
    import petastorm_tpu_torch.train_lm as lm
    from petastorm_tpu_torch import random as prng
    from petastorm_tpu_torch.models.decoding import beam_search, generate, speculative_generate
    from petastorm_tpu_torch.models.transformer import TransformerLM
    model.eval()
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy((rng.zipf(1.4, (2, 8)) % model.vocab_size).astype(np.int32)).cuda()
    layers = len(model.blocks)
    draft = TransformerLM(generator=torch.Generator().manual_seed(99),
                          **dict(lm.PACKED_LM, num_layers=1)).cuda().eval()
    drafts = {'self': model, 'one-layer': draft}
    total = {kernel.__name__: 0 for kernel in fa.KERNELS}
    out = {}

    def counted(fn):
        reset_counts(fa)
        result = fn()
        launches, by_design = counts(fa)
        for name, n in launches.items():
            total[name] += n
        return result, (launches, by_design)

    def expect(fwd):
        return {'flash_fwd': fwd, 'flash_bwd_dq': 0, 'flash_bwd_dkv': 0}

    def beam(cg, new, **kw):
        return beam_search(model, prompt, new, SEARCH_BEAMS, cuda_graph=cg, **kw)
    (tokens, scores), ms = search_turns('beam', beam, counted, expect(layers))
    eos = int(tokens[0, 1])
    (eos_tokens, eos_scores), eos_ms = search_turns(
        'beam eos', lambda cg, new: beam(cg, new, eos_id=eos), counted, expect(layers))
    costs = search_costs(beam)
    out['beam'] = dict(ms_per_token=ms, costs=costs, scores=scores.tolist(),
                       eos_ms_per_token=eos_ms, eos_id=eos, eos_scores=eos_scores.tolist())
    log('search beam (%d beams, %d new): graphed / eager equal bit for bit; ms per new token '
        '(whole call) graphed %.4f, eager %.4f; %s; scores %s; with eos_id %d: %.4f / %.4f ms '
        'per new token, scores %s, pad tokens %d'
        % (SEARCH_BEAMS, SEARCH_NEW, ms['graphed'], ms['eager'], costs_text(costs, 'step'),
           scores.tolist(), eos, eos_ms['graphed'], eos_ms['eager'], eos_scores.tolist(),
           int((eos_tokens == 0).sum())))
    greedy = generate(model, prompt, SEARCH_NEW)
    agree = {'beam1': share_equal(beam_search(model, prompt, SEARCH_NEW, 1)[0], greedy)}
    for name, dm in drafts.items():
        for mode, kw in (('greedy', {}),
                         ('sampled', dict(temperature=SEARCH_TEMPERATURE, rng=prng.PRNGKey(0)))):
            stats = {}

            def call(cg, new, dm=dm, kw=kw, stats=stats):
                stats.clear()
                return speculative_generate(model, dm, prompt, new, SEARCH_DRAFT_LEN,
                                            cuda_graph=cg, stats=stats, **kw)
            # stats: those of the last call, a graphed one
            (spec,), ms = search_turns('speculative %s %s' % (mode, name), call, counted,
                                          expect(layers + len(dm.blocks)))
            row = dict(ms_per_token=ms, rounds=stats['rounds'],
                       accepted_per_round=stats['accepted'] / stats['rounds'],
                       host_syncs_per_token=stats['host_syncs'] / SEARCH_NEW)
            row['costs'] = search_costs(call)
            if mode == 'greedy':
                agree['speculative ' + name] = row['greedy_agree'] = share_equal(spec, greedy)
            out['speculative %s %s' % (mode, name)] = row
            log('search speculative %s, draft %s (draft_len %d, %d new): graphed / eager equal '
                'bit for bit; ms per new token (whole call) graphed %.4f, eager %.4f; %s; %d '
                'rounds, %.2f drafts accepted per round, %.4f host syncs per token'
                % (mode, name, SEARCH_DRAFT_LEN, SEARCH_NEW, ms['graphed'], ms['eager'],
                   costs_text(row['costs'], 'round'), row['rounds'],
                   row['accepted_per_round'], row['host_syncs_per_token']))
    log('search bf16: share of tokens equal to greedy generate: %s'
        % ', '.join('%s %.4f' % kv for kv in agree.items()))
    # fp32 copies: the searches' greedy paths are greedy generate
    f32 = TransformerLM(compute_dtype=torch.float32, **lm.PACKED_LM).cuda().eval()
    f32.load_state_dict(model.state_dict())
    f32_draft = TransformerLM(compute_dtype=torch.float32,
                              **dict(lm.PACKED_LM, num_layers=1)).cuda().eval()
    f32_draft.load_state_dict(draft.state_dict())
    want = generate(f32, prompt, SEARCH_NEW)
    for name, got in (('beam_search(num_beams=1)', beam_search(f32, prompt, SEARCH_NEW, 1)[0]),
                      ('speculative, draft self', speculative_generate(
                          f32, f32, prompt, SEARCH_NEW, SEARCH_DRAFT_LEN)),
                      ('speculative, draft one-layer', speculative_generate(
                          f32, f32_draft, prompt, SEARCH_NEW, SEARCH_DRAFT_LEN))):
        if not torch.equal(got, want):
            raise AssertionError('search fp32: %s differs from greedy generate at %d of %d '
                                 'tokens' % (name, int((got != want).sum()), want.numel()))
    log('search fp32: beam_search(num_beams=1) and greedy speculative (both drafts) equal '
        'greedy generate, %d tokens each' % want.numel())
    out['bf16_agree_with_greedy'] = agree
    out['gc_ms'] = gc_ms()
    log('search: a full garbage collection takes %s ms at this point of the script'
        % ' / '.join('%.1f' % t for t in out['gc_ms']))
    SUMMARY['search'] = out
    log('search: launches of the graphed searches %s' % total)
    return total


RECIPE_HW = (224, 224)
RECIPE_STEPS = 24       # graphed recipe steps, mixup
RECIPE_CUTMIX_STEPS = 8
RECIPE_EQ_STEPS = 6     # eager against graphed, bit for bit, on kept batches
RECIPE_LR = 0.1


def recipe_loss(model, batch, mix, generator):
    """The recipe's augment on the card, ``random_crop(padding=4)``, flip,
    ``color_jitter``, ``random_cutout(56)``, ``normalize``, then ``mixup``
    (alpha 0.8) or ``cutmix`` (alpha 1.0), all drawn from ``generator``;
    returns the ``mixup_loss`` and what the step drew (``lam``, the partner
    labels, each mixed image's sum)."""
    from petastorm_tpu_torch.gpu import augment
    x = augment.random_crop(batch['image'], RECIPE_HW, padding=4, generator=generator)
    x = augment.random_flip_left_right(x, generator=generator)
    x = augment.color_jitter(x, generator=generator)
    x = augment.random_cutout(x, 56, generator=generator)
    x = augment.normalize(x, dtype=torch.float32)
    if mix == 'mixup':
        x, la, lb, lam = augment.mixup(x, batch['label'], alpha=0.8, generator=generator)
    else:
        x, la, lb, lam = augment.cutmix(x, batch['label'], alpha=1.0, generator=generator)
    loss = augment.mixup_loss(model(x), la, lb, lam)
    return loss, {'lam': lam, 'labels_b': lb, 'image_sums': x.sum(dim=(1, 2, 3))}


def recipe_model(remat):
    """ViT-S/16 at 224² from seed 0 (``train``'s), bf16, ``remat`` as given."""
    from petastorm_tpu_torch.train import _make_model
    return _make_model('vit', RECIPE_HW, {'remat': remat}).cuda().train()


def recipe_step(model, mix, generator):
    """One SGD step (momentum 0.9, as ``train``'s) of :func:`recipe_loss`;
    returns the loss and the draws."""
    opt = torch.optim.SGD(model.parameters(), lr=RECIPE_LR, momentum=0.9, dampening=0,
                          nesterov=False)

    def train_step(batch):
        with torch.profiler.record_function('train_step'):
            loss, drawn = recipe_loss(model, batch, mix, generator)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return dict(drawn, loss=loss.detach())
    return train_step


def recipe_run(fa, url, steps, remat, mix, keep=0):
    """``steps`` graphed recipe steps streamed from the JPEG store through
    the pumped loader (8 decode threads), the counts set to 0 just before:
    the losses, images/s and step ms over steps 3..``steps``, the peak
    device memory, the flash launches, and the first ``keep`` batches."""
    from petastorm_tpu_torch.gpu import DataLoader, graphs
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.train import make_transform
    model = recipe_model(remat)
    gen = torch.Generator(device='cuda').manual_seed(17)
    step = graphs.StepGraph(recipe_step(model, mix, gen), generators=[gen])
    reader = make_reader(url, num_epochs=None, schema_fields=['image', 'noun_id'],
                         transform_spec=make_transform(RECIPE_HW), columnar_decode=True,
                         workers_count=8)
    kept, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()   # the weights, and what earlier phases keep
    reset_counts(fa)
    with DataLoader(reader, batch_size=BATCH, device='cuda') as loader:
        batches = iter(loader)
        for i in range(steps):
            if i == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            batch = next(batches)
            if batch['image'].device.type != 'cuda':
                raise AssertionError('recipe: a batch reached the step on %s'
                                     % batch['image'].device)
            if len(kept) < keep:
                kept.append({k: v.clone() for k, v in batch.items()})
            losses.append(step(batch)['loss'])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        batches.close()   # ends the iteration (and its transfer thread) here
        h2d = loader.metrics.as_dict()
    launches, by_design = counts(fa)
    losses = [float(v) for v in torch.stack(losses).cpu()]
    if not np.all(np.isfinite(losses)):
        raise AssertionError('recipe: non-finite loss %s' % losses)
    if not h2d.get('h2d_batches', 0) + h2d.get('h2d_degraded', 0):
        raise AssertionError('recipe: the batches did not go through the transfer plane: %s'
                             % h2d)
    per_step = 2 if remat else 1
    check_launches('recipe %s remat=%s' % (mix, remat), launches, by_design,
                   {'flash_fwd': 12 * per_step * steps, 'flash_bwd_dq': 12 * steps,
                    'flash_bwd_dkv': 12 * steps})
    return dict(losses=losses, images_per_s=(steps - 2) * BATCH / elapsed,
                step_ms=1e3 * elapsed / (steps - 2),
                peak_mb=torch.cuda.max_memory_allocated() / 1e6,
                run_peak_mb=(torch.cuda.max_memory_allocated() - base) / 1e6, launches=launches,
                kept=kept)


def recipe_grads(batch, remat):
    """The recipe's loss and gradients on one batch from seed-0 weights and
    generator seed 5, with or without remat."""
    model = recipe_model(remat)
    loss, _ = recipe_loss(model, batch, 'mixup', torch.Generator(device='cuda').manual_seed(5))
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


def recipe_eager_vs_graphed(batches):
    """The recipe step from one generator seed over the same kept batches,
    eagerly and graphed: every step's draws, mixed images' sums and loss,
    and the parameters after, bit for bit; then two replays on one batch
    must draw another ``lam``, partner and images."""
    from petastorm_tpu_torch.gpu import graphs
    outs, params = {}, {}
    for mode in ('eager', 'graphed'):
        model = recipe_model(True)
        gen = torch.Generator(device='cuda').manual_seed(23)
        step = recipe_step(model, 'mixup', gen)
        if mode == 'graphed':
            step = graphs.StepGraph(step, generators=[gen])
        outs[mode] = [step(b) for b in batches]
        params[mode] = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i, (e, g) in enumerate(zip(outs['eager'], outs['graphed'])):
        for k in e:
            if not torch.equal(e[k], g[k]):
                raise AssertionError('recipe eager vs graphed: step %d %s differs' % (i + 1, k))
    differ = [n for n, p in params['eager'].items() if not torch.equal(p, params['graphed'][n])]
    if differ:
        raise AssertionError('recipe eager vs graphed: %d parameters differ, e.g. %s'
                             % (len(differ), differ[:3]))
    again = [step(batches[0]) for _ in range(2)]
    for k in ('lam', 'labels_b', 'image_sums'):
        if torch.equal(again[0][k], again[1][k]):
            raise AssertionError('recipe: two replays on one batch drew the same %s' % k)
    log('recipe eager vs graphed (%d steps, generator seed 23): draws, mixed images, losses and '
        'parameters equal bit for bit; two replays on one batch drew lam %.4f / %.4f and other '
        'partners and images' % (len(batches), float(again[0]['lam']), float(again[1]['lam'])))
    return [float(o['loss']) for o in outs['graphed']]


COLOR_ATOL = 1e-4   # the color ops and mixup, card against CPU, on the 0..255 scale


def recipe_inner_ops(batch):
    """Each inner augment op on the card against the same op on the CPU,
    fed the same draws (made on the card): crops, flips, cutout and cutmix
    exact, the color ops and mixup within ``COLOR_ATOL``."""
    from petastorm_tpu_torch.gpu import augment
    g = torch.Generator(device='cuda').manual_seed(31)
    images, labels = batch['image'], batch['label']
    n, h, w, _ = images.shape
    pad_h, pad_w = h + 8, w + 8

    def uniform(lo, hi):
        return torch.empty(n, device='cuda').uniform_(lo, hi, generator=g)

    x = augment.normalize(images, dtype=torch.float32) * 40.0 + 120.0   # a float batch
    draws = {
        'center_crop': (images, (192, 160)),
        'crop_at': (images, torch.randint(0, pad_h - h + 1, (n,), generator=g, device='cuda'),
                    torch.randint(0, pad_w - w + 1, (n,), generator=g, device='cuda'),
                    RECIPE_HW, 4),
        'flip_where': (images, torch.rand(n, generator=g, device='cuda') < 0.5),
        'adjust_brightness': (images, uniform(-0.125, 0.125)),
        'adjust_contrast': (x, uniform(0.8, 1.2)),
        'adjust_saturation': (x, uniform(0.8, 1.2)),
        'cutout_at': (x, torch.randint(0, h, (n,), generator=g, device='cuda'),
                      torch.randint(0, w, (n,), generator=g, device='cuda'), 56),
        'mixup_with': (x, labels, augment.sample_beta(0.8, 0.8, generator=g, device='cuda'),
                       augment.random_permutation(n, g, images.device)),
        'cutmix_with': (x, labels, augment.sample_beta(1.0, 1.0, generator=g, device='cuda'),
                        augment.random_permutation(n, g, images.device),
                        torch.randint(0, h, (), generator=g, device='cuda'),
                        torch.randint(0, w, (), generator=g, device='cuda')),
    }
    errs = {}
    for name, args in draws.items():
        op = getattr(augment, name)
        on_card = op(*args)
        on_cpu = op(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
        on_card = on_card if isinstance(on_card, tuple) else (on_card,)
        on_cpu = on_cpu if isinstance(on_cpu, tuple) else (on_cpu,)
        exact = name not in ('adjust_brightness', 'adjust_contrast', 'adjust_saturation',
                             'mixup_with')
        errs[name] = 0.0
        for a, b in zip(on_card, on_cpu):
            a = a.cpu()
            if exact or not a.is_floating_point():
                if not torch.equal(a, b):
                    raise AssertionError('recipe: %s on the card differs from the CPU' % name)
            else:
                errs[name] = max(errs[name], check('recipe %s card vs CPU' % name, a, b,
                                                   (COLOR_ATOL, 0.0)))
    log('recipe inner ops, card against CPU on the same draws: %s'
        % ', '.join('%s %s' % (k, 'equal' if v == 0 else 'max err %.3g' % v)
                    for k, v in errs.items()))
    return errs


def phase_vit_recipe(fa, url):
    """ViT-S/16 at full width (224², bf16, batch 64) with ``remat=True``,
    streamed and pumped from the 512-row JPEG store with 8 decode threads,
    24 graphed steps of the augment recipe (crop with padding 4, flip,
    ``color_jitter``, cutout 56, ``normalize``, ``mixup`` alpha 0.8) under
    ``mixup_loss`` and SGD with momentum: 24 ``flash_fwd``, 12
    ``flash_bwd_dq`` and 12 ``flash_bwd_dkv`` launches a step on the tensor
    cores; the same without remat (12 of each); 8 steps with ``cutmix``
    (alpha 1.0).  Then on one batch the loss and gradients of remat=True
    against remat=False, within the kernels' bf16 tolerance; eager against
    graphed from one generator seed, bit for bit, and two replays that draw
    anew; each inner augment op on the card against the CPU.  Logged:
    images/s, step ms and the peak device memory, with and without remat.
    Returns the flash launches of the remat mixup run."""
    runs = {}
    for label, steps, remat, mix in (('remat', RECIPE_STEPS, True, 'mixup'),
                                     ('no remat', RECIPE_STEPS, False, 'mixup'),
                                     ('remat cutmix', RECIPE_CUTMIX_STEPS, True, 'cutmix')):
        runs[label] = recipe_run(fa, url, steps, remat, mix,
                                 keep=RECIPE_EQ_STEPS if label == 'remat' else 0)
        r = runs[label]
        log('recipe %s (%s, %d graphed steps): images/s %.1f, step_ms %.2f (steps 3..%d), peak '
            'memory %.1f MB allocated, %.1f MB above what was allocated before the run, '
            'launches %s; losses %s'
            % (label, mix, steps, r['images_per_s'], r['step_ms'], steps, r['peak_mb'],
               r['run_peak_mb'], r['launches'], ' '.join('%.4f' % v for v in r['losses'])))
    batches = runs['remat']['kept']
    for r in runs.values():
        del r['kept']
    losses, grads = {}, {}
    for remat in (False, True):
        losses[remat], grads[remat] = recipe_grads(batches[0], remat)
    err = check('recipe loss, remat vs none', losses[True], losses[False], TOL['bf16_vs_plain'])
    for name, g in grads[False].items():
        err = max(err, check('recipe grad %s, remat vs none' % name, grads[True][name], g,
                             TOL['bf16_vs_plain']))
    log('recipe remat vs none on one batch: loss %.6f / %.6f, loss and %d gradients max err %.3g '
        '(limit %s)' % (float(losses[True]), float(losses[False]), len(grads[False]), err,
                        TOL['bf16_vs_plain']))
    recipe_eager_vs_graphed(batches)
    inner = recipe_inner_ops(batches[0])
    SUMMARY['vit_recipe'] = dict(
        {label: {k: v for k, v in r.items() if k != 'launches'} for label, r in runs.items()},
        remat_vs_none_max_err=err, inner_ops_max_err=inner,
        remat_memory_share=runs['remat']['run_peak_mb'] / runs['no remat']['run_peak_mb'])
    return runs['remat']['launches']


SP_BLOCK_K = 256        # the chunked ring's block_k
#: Every loss of a ring run against the reference strategy's over the same
#: rows: 1e-2, some 30 times the largest gap of the 20 steps on an H100
#: (bf16 rounding in other places, carried through AdamW).  At random init
#: every loss starts near ln(4096) whatever the attention computes, so a
#: wrong mask is left to sp_attention_check; this holds the training curve.
SP_LOSS_ATOL = 1e-2
#: label -> (strategy, block_k), in the order they run
SP_RUNS = (('ring', 'ring', None), ('ring block_k', 'ring', SP_BLOCK_K),
           ('ulysses', 'ulysses', None), ('flash', 'flash', None))


def sp_attention_check(mesh, device, seed=11):
    """Ring attention as the sharded step builds it (``make_attn_fn(mesh,
    'ring', head_axis=None)``, causal), whole and chunked by ``SP_BLOCK_K``,
    at L1's attention shapes in bf16: this rank's block of the output and of
    the q, k, v gradients of ``sum(out * dO)`` against the dense fp32
    reference on the global arrays (the same on every rank, from ``seed``),
    within the bf16 tolerance.  Returns the max errors by variant."""
    import petastorm_tpu_torch.train_lm as lm
    from petastorm_tpu_torch.models.transformer import make_attn_fn
    from petastorm_tpu_torch.ops.flash_attention import full_attention
    from petastorm_tpu_torch.parallel import NamedSharding
    h = lm.LONG_CONTEXT_LM['num_heads']
    shape = (8, lm.SEQ_LEN, h, lm.LONG_CONTEXT_LM['d_model'] // h)
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g).to(device, torch.bfloat16) for _ in range(4))
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref = full_attention(*ref_leaves, causal=True)
    ref.backward(do.float())
    index = NamedSharding(mesh, ('data', 'seq', None, None)).index(shape)
    errs = {}
    for label, block_k in (('ring', None), ('ring block_k', SP_BLOCK_K)):
        fn = make_attn_fn(mesh, 'ring', head_axis=None, block_k=block_k)
        leaves = [t[index].contiguous().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, causal=True)
        out.backward(do[index].contiguous())
        errs[label] = max([check('sequence parallel %s attention out' % label, out, ref[index],
                                 TOL['bf16'])]
                          + [check('sequence parallel %s attention d%s' % (label, name),
                                   leaf.grad, ref_leaf.grad[index], TOL['bf16'])
                             for name, leaf, ref_leaf in zip('qkv', leaves, ref_leaves)])
    return errs


def sp_rank(rank, world, store, url, tmp):
    """One rank of the sequence-parallel phase (see ``phase_sequence_parallel``):
    joins the NCCL group, runs every strategy, checks it, and returns what
    rank 0 reports; leaves the group."""
    import torch.distributed as dist

    import petastorm_tpu_torch.train_lm as lm
    from petastorm_tpu_torch.parallel import init_distributed
    fa = importlib.import_module('petastorm_tpu_torch.ops.flash_attention')
    init_distributed('cuda', store, rank, world)
    try:
        if dist.get_backend() != 'nccl':
            raise AssertionError('the group runs %s, not nccl' % dist.get_backend())
        layers = lm.LONG_CONTEXT_LM['num_layers']
        runs, launches = {}, {}

        def run(strategy, block_k, steps=STEPS, **kwargs):
            return lm.train_lm(url, steps, batch_size=8, strategy=strategy, block_k=block_k,
                               **kwargs)

        with same_data_order():
            for label, strategy, block_k in SP_RUNS:
                reset_counts(fa)
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                r = run(strategy, block_k)
                torch.cuda.synchronize()
                r['peak_mb'] = torch.cuda.max_memory_allocated() / 2 ** 20
                r['run_peak_mb'] = (torch.cuda.max_memory_allocated() - before) / 2 ** 20
                launches[label], by_design = counts(fa)
                per_step = 0 if strategy == 'ring' else 1
                check_launches('sequence parallel %s' % label, launches[label], by_design,
                               {'flash_fwd': per_step * 2 * layers * STEPS,
                                'flash_bwd_dq': per_step * layers * STEPS,
                                'flash_bwd_dkv': per_step * layers * STEPS})
                if not r['cuda_graph'] or len(r['losses']) != STEPS \
                        or not np.all(np.isfinite(r['losses'])):
                    raise AssertionError('sequence parallel %s: graphed %s, losses %s'
                                         % (label, r['cuda_graph'], r['losses']))
                runs[label] = r
                if rank == 0:
                    log('sequence parallel %s (mesh %s, %d ranks, %d graphed steps): tokens/s '
                        '%.0f, step_ms %.2f (steps 3..%d), peak memory %.1f MB allocated, '
                        '%.1f MB above what was allocated before the run, launches %s; losses '
                        '%s' % (label, r['mesh'], world, STEPS, r['tokens_per_s'], r['step_ms'],
                                STEPS, r['peak_mb'], r['run_peak_mb'], launches[label],
                                ' '.join('%.4f' % x for x in r['losses'])))
        # The reference over the same rows: flash on one card; on more, flash
        # runs a pure data mesh and reads other rows, and Ulysses shares the
        # rings' mesh.
        ref_label = 'flash' if world == 1 else 'ulysses'
        ref = runs[ref_label]['losses']
        first = {label: abs(runs[label]['losses'][0] - ref[0])
                 for label in ('ring', 'ring block_k', 'ulysses') if label != ref_label}
        curve = {label: float(np.abs(np.subtract(runs[label]['losses'], ref)).max())
                 for label in ('ring', 'ring block_k')}
        atol, rtol = TOL['bf16']
        for label in first:
            if first[label] > atol + rtol * abs(ref[0]):
                raise AssertionError('sequence parallel %s: first loss %.6f, %s %.6f'
                                     % (label, runs[label]['losses'][0], ref_label, ref[0]))
        for label, err in curve.items():
            if err > SP_LOSS_ATOL:
                raise AssertionError('sequence parallel %s: losses %s off %s\'s %s by up to %.4g '
                                     '(limit %g)' % (label, runs[label]['losses'], ref_label,
                                                     ref, err, SP_LOSS_ATOL))
        if world == 1:
            loss_rel, differ, worst, n_state = _differences(runs['ulysses'], runs['flash'])
            if loss_rel or differ:
                raise AssertionError('sequence parallel: Ulysses on one rank is not flash bit '
                                     'for bit (losses off by %.3g, %d of %d state tensors '
                                     'differ, worst %.3g)' % (loss_rel, differ, n_state, worst))
        attention = sp_attention_check(lm._mesh_for('ring', world), torch.device('cuda'))
        if rank == 0:
            log('sequence parallel: first losses against %s %s (limit %s); every loss of the '
                'rings against %s within %s (limit %g)%s; ring attention against the fp32 '
                'reference at %s, max abs err %s (limit %s)'
                % (ref_label, first, TOL['bf16'], ref_label, curve, SP_LOSS_ATOL,
                   '; Ulysses equal to flash bit for bit over %d steps' % STEPS
                   if world == 1 else '', (8, lm.SEQ_LEN, lm.LONG_CONTEXT_LM['num_heads'],
                                           lm.LONG_CONTEXT_LM['d_model']
                                           // lm.LONG_CONTEXT_LM['num_heads']),
                   attention, TOL['bf16']))
        rows = {label: eager_vs_graphed(fa, 'sequence parallel %s' % label,
                                        lambda s=strategy, b=block_k, **kw: run(s, b, EQ_STEPS,
                                                                                 **kw))
                for label, strategy, block_k in SP_RUNS if strategy != 'flash'}
        # where a graphed step's time goes, fed by the example's 4 decode threads
        profiles = {label: phase_profile(lambda n, s=strategy, b=block_k: run(s, b, n),
                                         'sequence parallel %s rank %d' % (label, rank), tmp)
                    for label, strategy, block_k in SP_RUNS if label in ('ring', 'ulysses')}
        return dict(world=world, launches=launches['ulysses'], loss_reference=ref_label,
                    first_loss_err=first, loss_curve_err=curve, attention_err=attention,
                    eager_vs_graphed=rows, profiles=profiles,
                    runs={label: {k: r[k] for k in ('mesh', 'tokens_per_s', 'step_ms', 'host_ms',
                                                    'data_wait_ms', 'peak_mb', 'run_peak_mb',
                                                    'losses')}
                          for label, r in runs.items()})
    finally:
        dist.destroy_process_group()


def _sp_spawned(rank, world, store, url, tmp, out):
    result = sp_rank(rank, world, store, url, tmp)
    if rank == 0:
        with open(out, 'w') as f:
            json.dump(result, f)


def phase_sequence_parallel(fa, tmp):
    """The long-context example's sequence-parallel strategies over an NCCL
    group of every visible card (see the module docstring, phase 24);
    returns the Ulysses run's flash launches."""
    url = 'file://' + os.path.join(tmp, 'lc_tokens')     # phase_lm's store
    store = os.path.join(tmp, 'sp_store')
    world = torch.cuda.device_count()
    if world == 1:
        result = sp_rank(0, 1, store, url, tmp)
    else:
        import torch.multiprocessing as mp
        out = os.path.join(tmp, 'sp_result.json')
        mp.start_processes(_sp_spawned, args=(world, store, url, tmp, out), nprocs=world,
                           start_method='spawn')
        with open(out) as f:
            result = json.load(f)
    SUMMARY['sequence_parallel'] = result
    return result['launches']


MD_SCAN_STEPS = 4
#: (label, model, scan_steps) of the image runs on the mesh, in order
MD_IMAGE_RUNS = (('resnet50', 'resnet50', 0), ('resnet50 scan 4', 'resnet50', MD_SCAN_STEPS),
                 ('vit', 'vit', 0))
#: Name parts of the kernels the data-parallel step adds: the flat
#: gradient buffer's concatenation, NCCL's all-reduce, the copies back.
MD_ALL_REDUCE_KERNELS = ('nccl', 'Cat', 'foreach', 'multi_tensor', 'copy', 'Copy')
MD_PROMPT, MD_NEW = 8, 16          # generate: two random prompts of 8, 16 new tokens
MD_LM_BATCH = 2                    # the train step's rows of L1's 1024 tokens
MD_MOE = dict(d=256, f=1024, experts=8, tokens=2048)


def md_image_run(url, model_name, scan_steps, steps=STEPS):
    from petastorm_tpu_torch.train import train
    return train(url, steps=steps, batch_size=BATCH, model_name=model_name,
                 scan_steps=scan_steps)


def md_image_unsharded(url):
    """The image runs without a group, on the rows the mesh runs read on one
    card (one decode thread, no row-group shuffle)."""
    out = {}
    with same_data_order():
        for label, model_name, scan_steps in MD_IMAGE_RUNS:
            out[label] = md_image_run(url, model_name, scan_steps)
    return out


MD_KEYS = ('images_per_s', 'step_ms', 'host_ms', 'data_wait_ms', 'stall_pct')


def _md_text(run, other):
    fmt = lambda m, k: '%.3f' % m[k] if m.get(k) is not None else 'n/a'  # noqa: E731
    return ', '.join('%s %s / %s' % (k, fmt(run, k), fmt(other, k)) for k in MD_KEYS)


def md_image_mesh(fa, url, unsharded, tmp, rank, world):
    """(a): the image runs on the mesh against the unsharded ones; returns
    the rows and the ViT run's flash launches."""
    rows, vit_launches = {}, None
    with same_data_order():
        for label, model_name, scan_steps in MD_IMAGE_RUNS:
            reset_counts(fa)
            r = md_image_run(url, model_name, scan_steps)
            launches, by_design = counts(fa)
            want = unsharded[label]
            if not r['cuda_graph'] or r['data_ranks'] != world or r['batch_devices'] != ['cuda'] \
                    or not np.all(np.isfinite(r['losses'])):
                raise AssertionError('multi-device %s: graphed %s, data ranks %s, batches on %s, '
                                     'losses %s' % (label, r['cuda_graph'], r['data_ranks'],
                                                    r['batch_devices'], r['losses']))
            if model_name == 'vit':
                check_launches('multi-device vit', launches, by_design,
                               {name: 12 * len(r['losses']) for name in launches})
                vit_launches = launches
            elif any(launches.values()):
                raise AssertionError('multi-device %s launched flash kernels: %s'
                                     % (label, launches))
            equal = r['losses'] == want['losses']
            if world == 1 and not equal:
                raise AssertionError('multi-device %s on one card: losses %s, unsharded %s'
                                     % (label, r['losses'], want['losses']))
            rows[label] = dict(mesh={k: r[k] for k in MD_KEYS if r.get(k) is not None},
                               unsharded={k: want[k] for k in MD_KEYS
                                          if want.get(k) is not None},
                               losses_equal=equal, steps=len(r['losses']), launches=launches)
            if rank == 0:
                log('multi-device %s (mesh {data: %d}, global batch %d, %d graphed steps, one '
                    'decode thread): mesh / unsharded %s; losses %s the unsharded run\'s; flash '
                    'launches %s' % (label, world, BATCH, len(r['losses']), _md_text(r, want),
                                     'equal bit for bit to' if equal else 'differ from',
                                     launches))
    # ViT is decode-bound on one thread: timed again with the example's 8,
    # against phase 5's unsharded graphed run (same model, batch, steps, store)
    r = md_image_run(url, 'vit', 0)
    base = SUMMARY.get('vit', {}).get('graphed', {})
    rows['vit']['mesh_8_threads'] = {k: r[k] for k in MD_KEYS if r.get(k) is not None}
    rows['vit']['unsharded_8_threads'] = base
    if rank == 0:
        log('multi-device vit with 8 decode threads, mesh / phase 5\'s unsharded graphed run: %s'
            % _md_text(r, base))
    # kernels per step against phase_resnet's graphed profile (same model)
    prof = phase_profile(lambda n: md_image_run(url, 'resnet50', 0, steps=n),
                         'multi-device resnet50 rank %d' % rank, tmp)
    base = SUMMARY.get('resnet50', {}).get('profile')
    if base is not None:
        extra = {k: v - base['kernels_by_name'].get(k, 0.0)
                 for k, v in prof['kernels_by_name'].items()
                 if v - base['kernels_by_name'].get(k, 0.0) > 1e-9}
        missing = {k: v for k, v in base['kernels_by_name'].items()
                   if v - prof['kernels_by_name'].get(k, 0.0) > 1e-9}
        delta = prof['kernels'] - base['kernels']
        rows['resnet50']['kernels_per_step'] = dict(mesh=prof['kernels'],
                                                    unsharded=base['kernels'],
                                                    added=extra, missing=missing)
        if rank == 0:
            log('multi-device resnet50 kernels per step: %.1f on the mesh, %.1f unsharded '
                '(phase_resnet); %+.1f, the kernels the mesh step adds: %s; kernels it lacks: %s'
                % (prof['kernels'], base['kernels'], delta, extra, missing or 'none'))
        lost = prof['unrecorded_launches'] or base['unrecorded_launches']
        foreign = [k for k in extra if not any(f in k for f in MD_ALL_REDUCE_KERNELS)]
        if not extra or foreign or (missing and not lost):
            raise AssertionError('multi-device resnet50: the mesh step\'s kernels are not the '
                                 'unsharded step\'s plus the all-reduce\'s: added %s (not the '
                                 'all-reduce\'s: %s), missing %s' % (extra, foreign, missing))
    rows['resnet50']['profile'] = {k: v for k, v in prof.items() if k != 'kernels_by_name'}
    return rows, vit_launches


def md_model_axes(rank, world):
    """(b): L1's width placed by the Megatron and FSDP rules, the pipeline
    and the MoE, each against its unplaced twin; returns the rows."""
    import petastorm_tpu_torch.train_lm as lm
    from petastorm_tpu_torch import parallel
    from petastorm_tpu_torch.models.decoding import generate
    from petastorm_tpu_torch.models.moe import make_expert_parallel_moe, moe_apply, moe_init
    from petastorm_tpu_torch.models.transformer import (TransformerLM, megatron_spec_fn,
                                                        param_shardings)
    from petastorm_tpu_torch.parallel.mesh import axis_index, axis_size
    model_axis = 2 if world % 2 == 0 else 1
    mesh = parallel.make_mesh({'data': world // model_axis, 'model': model_axis})
    data, data_index = axis_size(mesh, 'data'), axis_index(mesh, 'data')
    g = torch.Generator().manual_seed(23)
    tokens = torch.randint(0, lm.VOCAB, (MD_LM_BATCH * data, lm.SEQ_LEN), generator=g).cuda()
    mine = tokens[MD_LM_BATCH * data_index:MD_LM_BATCH * (data_index + 1)]
    prompt = torch.randint(0, lm.VOCAB, (2, MD_PROMPT), generator=g)

    def lm_model():
        return TransformerLM(**lm.LONG_CONTEXT_LM,
                             generator=torch.Generator().manual_seed(0)).cuda().train()
    dense = lm_model()
    with torch.no_grad():
        want = dense(mine)
    want_tokens = generate(dense, prompt, MD_NEW)
    rows = {}
    rules = (('megatron', lambda m: param_shardings(m, mesh)),
             ('fsdp x megatron', lambda m: parallel.fsdp_shardings(
                 m, mesh, base_spec_fn=megatron_spec_fn())))
    for label, rule in rules:
        model = lm_model()
        shardings = rule(model)
        report = parallel.fsdp_size_report(model, shardings)
        parallel.place(model, shardings)
        with torch.no_grad():
            got = model(mine)
        err = check('multi-device %s logits' % label, got, want, TOL['bf16'])
        bitwise = bool(torch.equal(got, want))
        tokens_out = generate(model, prompt, MD_NEW)
        same_tokens = bool(torch.equal(tokens_out.cpu(), want_tokens.cpu()))
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
        logits = model(mine)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                               torch.roll(mine, -1, 1).reshape(-1).long())
        opt.zero_grad()
        loss.backward()
        parallel.reduce_gradients(model, ('data',))
        opt.step()
        torch.cuda.synchronize()
        loss = loss.item()
        grads_finite = all(bool(torch.isfinite(p.grad).all())
                           for p in parallel.local_blocks(model).values())
        if not (np.isfinite(loss) and grads_finite and same_tokens):
            raise AssertionError('multi-device %s: loss %s, gradients finite %s, generate '
                                 'token-identical %s' % (label, loss, grads_finite,
                                                         same_tokens))
        rows[label] = dict(logits_max_err=err, logits_bitwise=bitwise, loss=loss,
                           size_report=report, generate_identical=same_tokens)
        if rank == 0:
            log('multi-device %s on %s: logits max err %.4g against the unplaced model%s '
                '(limit %s), train step loss %.4f, gradients finite, generate token-identical '
                'over %d new tokens; size report %s'
                % (label, dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)), err,
                   ' (equal bit for bit)' if bitwise else '', TOL['bf16'], loss, MD_NEW,
                   report))
    # the pipeline: tanh(x w + b) stages at d_model 256
    stages = 2 if world % 2 == 0 else 1
    pmesh = parallel.make_mesh({'data': world // stages, 'pipe': stages})
    d = lm.LONG_CONTEXT_LM['d_model']
    stacked = {'w': torch.randn(stages, d, d, generator=g) * d ** -0.5,
               'b': torch.randn(stages, d, generator=g) * 0.1}
    micro = torch.randn(6, 8, d, generator=g).cuda()

    def stage_fn(p, x):
        return torch.tanh(x @ p['w'] + p['b'])
    fn, stage_sharding = parallel.make_pipeline(pmesh, stage_fn)
    mine_p = {k: v.requires_grad_() for k, v in
              parallel.device_put(stacked, stage_sharding).items()}
    out = fn(mine_p, micro)
    (out ** 2).sum().backward()
    seq = {k: v.cuda().requires_grad_() for k, v in stacked.items()}
    ref = micro
    for i in range(stages):
        ref = stage_fn({k: v[i] for k, v in seq.items()}, ref)
    (ref ** 2).sum().backward()
    stage = axis_index(pmesh, 'pipe')
    errs = [check('multi-device pipeline out', out, ref, TOL['grad_f32'])]
    errs += [check('multi-device pipeline d%s' % k, mine_p[k].grad, seq[k].grad[stage:stage + 1],
                   TOL['grad_f32']) for k in ('w', 'b')]
    rows['pipeline'] = dict(stages=stages, max_err=max(errs))
    # the MoE
    emesh = parallel.make_mesh({'data': world // stages, 'expert': stages})
    params = moe_init(MD_MOE['d'], MD_MOE['f'], MD_MOE['experts'], generator=g)
    x = torch.randn(MD_MOE['tokens'], MD_MOE['d'], generator=g).cuda()
    # ample capacity (one slot per token and expert): no token drops, so the
    # sharded MoE equals the oracle on the global tokens on any mesh
    ample = float(MD_MOE['experts'])
    fn, shardings_fn, token_sharding = make_expert_parallel_moe(
        emesh, MD_MOE['experts'], capacity_factor=ample)
    placed = parallel.device_put(params, shardings_fn(params))
    index = token_sharding.index(tuple(x.shape))
    got = fn(placed, x[index])
    want = moe_apply({k: v.cuda() for k, v in params.items()}, x, capacity_factor=ample)[index]
    rows['moe'] = dict(experts=MD_MOE['experts'], expert_axis=stages, max_err=check(
        'multi-device moe against moe_apply', got, want, TOL['fwd_f32']))
    if rank == 0:
        log('multi-device pipeline of %d stages against the sequential stages: max err %.3g '
            '(limit %s); MoE on an expert axis of %d against moe_apply: %s'
            % (stages, rows['pipeline']['max_err'], TOL['grad_f32'], stages, rows['moe']))
    return rows


def md_rank(rank, world, store, url, tmp, unsharded):
    """One rank of the multi-device phase: joins the NCCL group, runs (a)
    and (b), and leaves the group."""
    import torch.distributed as dist

    from petastorm_tpu_torch.parallel import init_distributed
    fa = importlib.import_module('petastorm_tpu_torch.ops.flash_attention')
    init_distributed('cuda', store, rank, world)
    try:
        if dist.get_backend() != 'nccl':
            raise AssertionError('the group runs %s, not nccl' % dist.get_backend())
        image, vit_launches = md_image_mesh(fa, url, unsharded, tmp, rank, world)
        reset_counts(fa)
        axes = md_model_axes(rank, world)
        launches, _ = counts(fa)
        total = {k: vit_launches[k] + launches[k] for k in launches}
        return dict(world=world, image=image, model_axes=axes, launches=total,
                    model_axes_launches=launches)
    finally:
        dist.destroy_process_group()


def _md_spawned(rank, world, store, url, tmp, unsharded, out):
    result = md_rank(rank, world, store, url, tmp, unsharded)
    if rank == 0:
        with open(out, 'w') as f:
            json.dump(result, f)


def phase_multi_device(fa, url, tmp):
    """The multi-device paths over an NCCL group of every visible card (see
    the module docstring, phase 25); returns the phase's flash launches."""
    world = torch.cuda.device_count()
    unsharded = md_image_unsharded(url)
    store = os.path.join(tmp, 'md_store')
    if world == 1:
        result = md_rank(0, 1, store, url, tmp, unsharded)
    else:
        import torch.multiprocessing as mp
        out = os.path.join(tmp, 'md_result.json')
        slim = {k: {m: v[m] for m in ('losses', 'images_per_s', 'step_ms', 'host_ms')}
                for k, v in unsharded.items()}
        mp.start_processes(_md_spawned, args=(world, store, url, tmp, slim, out), nprocs=world,
                           start_method='spawn')
        with open(out) as f:
            result = json.load(f)
    SUMMARY['multi_device'] = result
    return result['launches']


EL_SEED = 23            # the elastic readers' seed (every host's the same)
EL_EPOCHS = 2
EL_BATCH = 8            # L1's batch
EL_HOST_STEPS = (5, 7)  # steps each of the two old hosts trains before its checkpoint
EL_RESHARDS = ((3, 'dummy'), (1, 'dummy'), (3, 'thread'))


class LmStepper(object):
    """L1's model (``train_lm``'s: seed 0, remat, flash, AdamW 3e-4) and
    ``train_lm``'s one-device step on the card: a full batch replays one
    captured graph, a shorter one (a shard's last) runs eagerly, its loss
    over its own tokens.  Both launch 2 * layers forward and layers dQ and
    dK/dV kernels."""

    def __init__(self):
        import petastorm_tpu_torch.train_lm as lm
        from petastorm_tpu_torch.gpu import graphs
        from petastorm_tpu_torch.models.transformer import make_attn_fn
        self.layers = lm.LONG_CONTEXT_LM['num_layers']
        self.model = lm._model(lm.LONG_CONTEXT_LM, attn_fn=make_attn_fn(None, 'flash'),
                               remat=True).cuda().train()
        opt = lm._adamw(self.model, 3e-4, torch.device('cuda'))
        positions = torch.arange(lm.SEQ_LEN, device='cuda')

        def step_for(rows):
            return lm._train_step(self.model, opt, positions.expand(rows, lm.SEQ_LEN),
                                  rows * lm.SEQ_LEN)
        self._step_for = step_for
        self.graphed = graphs.StepGraph(step_for(EL_BATCH))
        self.eager = {}
        self.steps = 0

    def __call__(self, batch):
        self.steps += 1
        step = {'tokens': batch['tokens'], 'labels': batch['labels']}
        rows = batch['tokens'].shape[0]
        if rows == EL_BATCH:
            return self.graphed(step)
        if rows not in self.eager:
            self.eager[rows] = self._step_for(rows)
        return self.eager[rows](step)


def el_transform(batch):
    """``train_lm``'s host transform (next-token labels over the whole row),
    keeping ``doc_id`` for the row accounting."""
    import petastorm_tpu_torch.train_lm as lm
    return dict(lm._with_labels(batch), doc_id=batch['doc_id'])


def el_loader(lm_url, shard, count, pool, token=None):
    from petastorm_tpu_torch.gpu import DataLoader
    from petastorm_tpu_torch.reader import make_reader
    kwargs = dict(workers_count=4) if pool == 'thread' else {}
    reader = make_reader(lm_url, columnar_decode=True, shuffle_row_groups=True, seed=EL_SEED,
                         num_epochs=EL_EPOCHS, cur_shard=shard, shard_count=count,
                         reader_pool_type=pool,
                         resume_state=None if token is None else token['reader'], **kwargs)
    return DataLoader(reader, batch_size=EL_BATCH, prefetch=2, drop_last=token is None,
                      device='cuda', transform_fn=el_transform, resume_state=token)


def el_train(stepper, batches, steps=None):
    """Train L1 on the iterator ``batches`` (``steps`` batches, or to its
    end); returns the doc ids, the losses, and the tokens/s and step ms of
    the steps after the first two."""
    ids, losses = [], []
    t0 = None
    for i, batch in enumerate(batches):
        if batch['tokens'].device.type != 'cuda':
            raise AssertionError('elastic: a batch reached the step on %s'
                                 % batch['tokens'].device)
        if i == 2:
            torch.cuda.synchronize()
            t0, timed_tokens = time.perf_counter(), 0
        ids.append(batch['doc_id'].clone())
        losses.append(stepper(batch))
        if t0 is not None:
            timed_tokens += batch['tokens'].numel()
        if steps is not None and i + 1 == steps:
            break
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0 if t0 is not None else None
    timed = len(losses) - 2
    losses = [float(v) for v in torch.stack(losses).cpu()] if losses else []
    if not np.all(np.isfinite(losses)):
        raise AssertionError('elastic: non-finite loss %s' % losses)
    return {'ids': [int(i) for i in torch.cat(ids).cpu()] if ids else [], 'losses': losses,
            'tokens_per_s': timed_tokens / elapsed if elapsed else None,
            'step_ms': 1e3 * elapsed / timed if elapsed else None}


def phase_elastic(fa, lm_url, tmp):
    """Elastic resharding of loader checkpoints (``petastorm_tpu_torch.elastic``)
    on L1's token store (256 documents of 1024 tokens, 8 row groups; the
    columnar reader, row groups shuffled from seed ``EL_SEED``, 2 epochs,
    batch 8).  For each case of ``EL_RESHARDS``: two "hosts" (``cur_shard`` 0
    and 1 of 2) train L1 (d_model 256, 8 heads, 4 layers, remat, flash) on
    the card for 5 and 7 steps, each saves its loader token and weights
    through ``TrainStateManager`` under ``host_0``/``host_1``; the tokens are
    read back with ``restore_latest_from``, resharded onto M loaders
    (``reshard_loader_states``, 2 -> 3 and 2 -> 1), and the M resumed
    loaders finish both epochs training on the card.  The rows the hosts
    took plus the resumed rows must be every document exactly twice on the
    dummy pool, at least twice on 4 threads.  Prints the reshard's host ms,
    each token's pickled bytes, the resumed tokens/s and step ms and the
    flash launches (8 forward, 4 dQ, 4 dK/dV a step)."""
    from petastorm_tpu_torch.checkpoint import TrainStateManager
    from petastorm_tpu_torch.elastic import reshard_loader_states
    stepper = LmStepper()
    reset_counts(fa)
    runs = []
    for m, pool in EL_RESHARDS:
        consumed, root = [], os.path.join(tmp, 'elastic_%d_%s' % (m, pool))
        for host, steps in enumerate(EL_HOST_STEPS):
            with el_loader(lm_url, host, 2, pool) as loader:
                batches = iter(loader)
                consumed += el_train(stepper, batches, steps)['ids']
                token = loader.state_dict()   # with batches in flight on the card
                batches.close()
            with TrainStateManager(os.path.join(root, 'host_%d' % host),
                                   async_save=False) as mgr:
                mgr.save(steps, {'model': stepper.model.state_dict()}, data_state=token,
                         force=True)
        tokens = [TrainStateManager.restore_latest_from(os.path.join(root, 'host_%d' % h))[2]
                  for h in range(2)]
        t0 = time.perf_counter()
        new = reshard_loader_states(tokens, m)
        reshard_ms = 1e3 * (time.perf_counter() - t0)
        resumed = []
        for shard, token in enumerate(new):
            with el_loader(lm_url, shard, m, pool, token) as loader:
                resumed.append(el_train(stepper, iter(loader)))
        total = collections.Counter(consumed + [i for r in resumed for i in r['ids']])
        exact = total == collections.Counter({i: EL_EPOCHS for i in range(256)})
        covered = all(total.get(i, 0) >= EL_EPOCHS for i in range(256))
        run = {'reshard': '2->%d' % m, 'pool': pool, 'reshard_ms': reshard_ms,
               'old_token_bytes': [len(pickle.dumps(t)) for t in tokens],
               'new_token_bytes': [len(pickle.dumps(t)) for t in new],
               'pending': [len(t['pending']) for t in tokens], 'old_rows': len(consumed),
               'resumed_rows': [len(r['ids']) for r in resumed],
               'resumed_tokens_per_s': [r['tokens_per_s'] for r in resumed],
               'resumed_step_ms': [r['step_ms'] for r in resumed],
               'exact': exact, 'covered': covered}
        log('elastic %s on %s: reshard %.3f ms, old tokens %s B, new %s B; %d rows before, '
            'resumed %s rows at %s tokens/s, step ms %s; every document exactly %d times: %s, '
            'at least: %s' % (run['reshard'], pool, reshard_ms, run['old_token_bytes'],
                              run['new_token_bytes'], len(consumed), run['resumed_rows'],
                              ['%.0f' % v if v else None for v in run['resumed_tokens_per_s']],
                              ['%.2f' % v if v else None for v in run['resumed_step_ms']],
                              EL_EPOCHS, exact, covered))
        if not covered or (pool == 'dummy' and not exact):
            raise AssertionError('elastic %s on %s: rows %s' % (run['reshard'], pool,
                                                               sorted(total.items())))
        runs.append(run)
    launches, by_design = counts(fa)
    check_launches('elastic', launches, by_design,
                   {'flash_fwd': 2 * stepper.layers * stepper.steps,
                    'flash_bwd_dq': stepper.layers * stepper.steps,
                    'flash_bwd_dkv': stepper.layers * stepper.steps})
    log('elastic: %d L1 steps, launches %s' % (stepper.steps, launches))
    SUMMARY['elastic'] = {'runs': runs, 'steps': stepper.steps, 'launches': launches}
    return launches



SVC_ROWS = 1536         # 24 row groups of 64: one epoch is 24 ViT steps of 64
SVC_WARMUP = 4          # steps before the timed window (the eager step, the capture, ...)
SVC_WORKERS = 2
SVC_THREADS = 2         # each worker's decode threads
SVC_LOCAL_THREADS = 4
SVC_WORKER_SCRIPT = r"""
import sys
from petastorm_tpu_torch.service.worker import Worker
worker = Worker(sys.argv[1])
worker.install_signal_handlers()
worker.run()
assert 'torch' not in sys.modules and 'jax' not in sys.modules, 'a worker loaded torch or jax'
"""


def svc_spawn_worker(addr):
    """A decode worker in a process of its own: no card, no torch (labels
    hash with ``PYTHONHASHSEED=0``)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', PYTHONHASHSEED='0',
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    return subprocess.Popen([sys.executable, '-c', SVC_WORKER_SCRIPT, addr], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def svc_stop_workers(procs):
    """SIGTERM (each worker drains and exits), then each must have exited 0."""
    import signal
    for proc in procs:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
    failed = []
    for proc in procs:
        try:
            code = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            code = proc.wait()
        if code != 0:
            failed.append((proc.pid, code, proc.stderr.read().decode()[-2000:]))
    if failed:
        raise AssertionError('service workers exited badly: %s' % failed)


def svc_epoch(fa, loader, label, step=None, on_step=None):
    """One epoch of graphed ViT-S/16 steps from ``loader`` (the counts set
    to 0 just before; ``step`` a ``vit_resident_step()`` to reuse, else a
    new one; ``on_step(i)`` called after step ``i``): the row ids, losses,
    images/s, step ms and host ms in the step call after ``SVC_WARMUP``
    steps, the data wait per step and ``stall_pct``, and each step's wall
    and data wait."""
    from petastorm_tpu_torch.benchmark.stall_profiler import StallMonitor
    step = step or vit_resident_step()
    monitor = StallMonitor(warmup_steps=SVC_WARMUP)
    ids, losses, walls, waits = [], [], [], []
    host_s = 0.0
    torch.cuda.synchronize()
    reset_counts(fa)
    with loader:
        t_end = time.perf_counter()
        for i, batch in enumerate(monitor.wrap(loader)):
            waits.append(time.perf_counter() - t_end)
            if i == SVC_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if batch['image'].device.type != 'cuda':
                raise AssertionError('%s: a batch reached the step on %s'
                                     % (label, batch['image'].device))
            ids.append(batch['id'].clone())
            t1 = time.perf_counter()
            losses.append(step(batch))
            if i >= SVC_WARMUP:
                host_s += time.perf_counter() - t1
            if on_step is not None:
                on_step(i)
            walls.append(time.perf_counter() - t_end)
            t_end = time.perf_counter()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    launches, by_design = counts(fa)
    steps = len(losses)
    ids = [int(i) for i in torch.cat(ids).cpu()]
    losses = [float(v) for v in torch.stack(losses).cpu()]
    if sorted(ids) != list(range(SVC_ROWS)):
        raise AssertionError('%s: rows lost or repeated (%d delivered, %d distinct)'
                             % (label, len(ids), len(set(ids))))
    if not np.all(np.isfinite(losses)):
        raise AssertionError('%s: non-finite loss %s' % (label, losses))
    check_launches(label, launches, by_design, {name: 12 * steps for name in launches})
    timed = steps - SVC_WARMUP
    report = monitor.report()
    return {'steps': steps, 'losses': losses, 'launches': launches,
            'images_per_s': timed * BATCH / elapsed, 'step_ms': 1e3 * elapsed / timed,
            'host_ms': 1e3 * host_s / timed,
            'data_wait_ms': 1e3 * monitor.wait_time / monitor.steps if monitor.steps else None,
            'stall_pct': report['stall_pct'], 'walls_ms': [1e3 * w for w in walls],
            'waits_ms': [1e3 * w for w in waits]}


def svc_brief(run):
    """An epoch's numbers without its per-step lists."""
    return {k: v for k, v in run.items() if k not in ('losses', 'walls_ms', 'waits_ms')}


def svc_counted(stats):
    """The workers' counters, as their last heartbeats gave them to the
    dispatcher's ``stats``, against the epoch the client received: rows and
    splits decoded, shm and byte chunks sent, and the count of each stage's
    latency histogram.  Equal with no lease moved; at least as many when one
    did (a moved split is decoded again).  Returns (ok, got, want)."""
    workers = stats['workers'].values()
    stages = stats['stages']
    got = {key: sum(int(w.get(key, 0)) for w in workers)
           for key in ('rows_decoded', 'splits_decoded', 'shm_chunks', 'byte_chunks')}
    got.update({'%s_count' % name: stages.get(name, {}).get('count', 0)
                for name in ('decode_split', 'shm_publish', 'serialize')})
    want = {'rows_decoded': SVC_ROWS, 'splits_decoded': stats['num_splits'],
            'shm_chunks': stats['client']['shm_chunks'],
            'byte_chunks': stats['client']['byte_chunks'],
            'decode_split_count': got['splits_decoded'],
            'shm_publish_count': got['shm_chunks'], 'serialize_count': got['byte_chunks']}
    if stats['lease_churn']:
        return all(got[k] >= want[k] for k in want), got, want
    return got == want, got, want


def phase_service(fa, tmp):
    """The data service's single-tenant core feeding ViT-S/16 on the card.

    A store of 1,536 synthetic JPEG rows with ids; a ``Dispatcher`` thread
    here and two ``Worker`` processes (no card, no torch), each reading its
    leased splits (2 row groups) with 2 decode threads and the image path's
    transform (``make_transform``: resize to 224² and the label), shm
    delivery on.  ``ServiceDataLoader(consumer=0, batch_size=64)`` feeds one
    graphed epoch of ViT-S/16 at full width (24 steps, timed after 4):
    every row id once, the losses finite, 12 launches of each flash kernel a
    step; images/s, step ms, data wait, ``stall_pct``; the dispatcher's
    stats (splits, lease churn, each worker's rows/s, shm against byte
    chunks), whose worker counters must add up to what the client received
    (``svc_counted``); the workers drain on SIGTERM and leave no ``/dev/shm`` slab.
    Beside it the same epoch fed by the local ``DataLoader`` (4 decode
    threads).  Then ``ordered=True`` with one worker reading with one
    thread and ``ResizeImages``: its host batches equal a local reader's in
    dataset order, bit for bit."""
    from petastorm_tpu_torch.gpu import DataLoader
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.service import Dispatcher, ServiceConfig, ServiceDataLoader
    from petastorm_tpu_torch.train import make_transform
    from petastorm_tpu_torch.transform import ResizeImages
    from petastorm_tpu_torch.workers_pool import shm_plane
    url = 'file://' + os.path.join(tmp, 'service_jpeg')
    t0 = time.monotonic()
    write_dataset(url, rows=SVC_ROWS, ids=True)
    log('service dataset: %d JPEG rows written in %.1f s' % (SVC_ROWS, time.monotonic() - t0))
    fields = ['id', 'image', 'noun_id']
    config = ServiceConfig(url, rowgroups_per_split=2, lease_ttl_s=2.0, reader_kwargs=dict(
        schema_fields=fields, transform_spec=make_transform((224, 224)),
        workers_count=SVC_THREADS))
    result = {}
    with Dispatcher(config) as dispatcher:
        procs = [svc_spawn_worker(dispatcher.addr) for _ in range(SVC_WORKERS)]
        try:
            loader = ServiceDataLoader(dispatcher.addr, batch_size=BATCH, consumer=0,
                                       device='cuda')
            deadline = time.monotonic() + 120
            while len(loader.service_diagnostics()['workers']) < SVC_WORKERS:
                if time.monotonic() > deadline:
                    raise AssertionError('service: the workers did not register')
                time.sleep(0.05)
            result['service'] = svc_epoch(fa, loader, 'service')
            # the workers' counters reach the dispatcher on their heartbeats
            deadline = time.monotonic() + 10
            while True:
                stats = loader.service_diagnostics()
                counted, got, want = svc_counted(stats)
                if counted or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
            if not counted:
                raise AssertionError('service: the workers\' counters %s do not add up to '
                                     'what the client received %s (lease churn %d)'
                                     % (got, want, stats['lease_churn']))
        finally:
            svc_stop_workers(procs)
        probe = loader.reader._conn._shm_probe
        residue = shm_plane.residue([p.pid for p in procs])
        if probe and os.path.exists(os.path.join(shm_plane.SHM_DIR, probe)):
            residue.add(probe)
    workers = {wid: {k: w.get(k) for k in ('rows_decoded', 'splits_decoded', 'rows_per_s',
                                            'shm_chunks', 'byte_chunks', 'shm_degraded')}
               for wid, w in stats['workers'].items()}
    result['stats'] = {k: stats[k] for k in ('num_splits', 'done', 'failed', 'lease_churn')}
    result['stats'].update(workers=workers, client=stats['client'],
                           stages=stats['stages'], residue=sorted(residue))
    log('service: %s' % json.dumps(svc_brief(result['service'])))
    log('service stats: %s' % json.dumps(result['stats']))
    if residue or stats['done'] != stats['num_splits'] or stats['failed']:
        raise AssertionError('service: residue %s, %d of %d splits done, %d failed'
                             % (residue, stats['done'], stats['num_splits'], stats['failed']))
    if not stats['client']['shm_chunks']:
        raise AssertionError('service: no chunk went through /dev/shm: %s' % stats['client'])
    local_reader = make_reader(url, num_epochs=1, schema_fields=fields,
                               transform_spec=make_transform((224, 224)), columnar_decode=True,
                               workers_count=SVC_LOCAL_THREADS)
    result['local'] = svc_epoch(fa, DataLoader(local_reader, batch_size=BATCH, device='cuda'),
                                'service local')
    log('service local: %s' % json.dumps(svc_brief(result['local'])))
    # ordered: one worker, one decode thread, and no hash in the transform
    resize = ResizeImages({'image': (224, 224)})
    config = ServiceConfig(url, rowgroups_per_split=2, lease_ttl_s=2.0, reader_kwargs=dict(
        schema_fields=fields, transform_spec=resize, workers_count=1))
    with Dispatcher(config) as dispatcher:
        procs = [svc_spawn_worker(dispatcher.addr)]
        try:
            with ServiceDataLoader(dispatcher.addr, batch_size=BATCH, consumer=0, ordered=True,
                                   device='cuda') as loader:
                got = [{k: np.array(v) for k, v in b.items()}
                       for b in loader.iter_host_batches()]
        finally:
            svc_stop_workers(procs)
    local_reader = make_reader(url, num_epochs=1, schema_fields=fields, transform_spec=resize,
                               columnar_decode=True, shuffle_row_groups=False,
                               reader_pool_type='dummy')
    with DataLoader(local_reader, batch_size=BATCH, device='cuda') as loader:
        want = [{k: np.array(v) for k, v in b.items()} for b in loader.iter_host_batches()]
    equal = len(got) == len(want) == SVC_ROWS // BATCH and all(
        sorted(g) == sorted(w) and all(g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
                                       for k in w) for g, w in zip(got, want))
    in_order = [i for b in got for i in b['id'].tolist()] == list(range(SVC_ROWS))
    log('service ordered: %d host batches equal to the local reader\'s bit for bit: %s, ids in '
        'dataset order: %s' % (len(got), equal, in_order))
    if not equal or not in_order:
        raise AssertionError('service ordered: equal %s, in order %s' % (equal, in_order))
    result['ordered'] = {'batches': len(got), 'equal': equal}
    SUMMARY['service'] = {k: (svc_brief(v) if k in ('service', 'local') else v)
                          for k, v in result.items()}
    return result['service']['launches']


# -- the shared fleet: tenancy, the ledger, the cache plane and the cluster cache --

FLEET_SHM_QUOTA = 1 << 20   # vit-b's shm quota: below one chunk (64 x 224 x 224 x 3 B)
FLEET_KILL_AFTER = 8        # the dispatcher is SIGKILLed after this many steps
FLEET_WORKER_SCRIPT = r"""
import sys
from petastorm_tpu_torch.service.worker import Worker
worker = Worker(sys.argv[1], cache_plane_dir=sys.argv[2] or None)
worker.install_signal_handlers()
worker.run()
assert 'torch' not in sys.modules and 'jax' not in sys.modules, 'a worker loaded torch or jax'
"""
FLEET_DISPATCHER_SCRIPT = r"""
import json, pickle, sys
from petastorm_tpu_torch.service.config import ServiceConfig
from petastorm_tpu_torch.service.dispatcher import Dispatcher


class Grants(object):
    # each lease grant of this dispatcher, one JSON line in argv[3]
    def __init__(self, path):
        self._f = open(path, 'a')

    def instant(self, name, **args):
        if name == 'service/lease_grant':
            self._f.write(json.dumps(args) + '\n')
            self._f.flush()


with open(sys.argv[2], 'rb') as f:
    config = ServiceConfig(**pickle.load(f))
dispatcher = Dispatcher(config, bind=sys.argv[1], trace_recorder=Grants(sys.argv[3])).start()
print('READY', flush=True)
dispatcher.join()
assert 'torch' not in sys.modules and 'jax' not in sys.modules, 'the dispatcher loaded torch'
"""


def fleet_spawn_worker(addr, plane_dir=None):
    """A decode worker process (no card, no torch) over its own plane."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', PYTHONHASHSEED='0',
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    return subprocess.Popen([sys.executable, '-c', FLEET_WORKER_SCRIPT, addr, plane_dir or ''],
                            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def fleet_spawn_dispatcher(addr, config_path, grants_path):
    """A dispatcher in a process of its own (no card, no torch) on ``addr``;
    returns once it serves."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='',
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, '-c', FLEET_DISPATCHER_SCRIPT, addr, config_path,
                             grants_path], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    if proc.stdout.readline().strip() != b'READY':
        proc.kill()
        raise AssertionError('fleet: the dispatcher did not start: %s'
                             % proc.stderr.read().decode()[-2000:])
    return proc


def fleet_rpc(addr, request):
    """One dispatcher RPC from this process."""
    import zmq
    from petastorm_tpu_torch.service.worker import _Rpc
    context = zmq.Context()
    try:
        rpc = _Rpc(context, addr, timeout_s=10.0)
        try:
            return rpc.call(request)
        finally:
            rpc.close()
    finally:
        context.term()


def fleet_wait(what, predicate, timeout_s=120):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError('fleet: timed out waiting for %s' % what)
        time.sleep(0.05)


def fleet_labels(batch):
    """The label from ``noun_id`` on the host (a stable hash), for the runs
    whose reader transform is the declared resize alone."""
    import zlib
    batch = dict(batch)
    names = batch.pop('noun_id')
    batch['label'] = np.array([zlib.crc32(str(n).encode()) % 1000 for n in names], np.int32)
    return batch


def fleet_grant_ratio(grants, tenants):
    """Grants of the first tenant over the second's while both still had
    pending splits: the grant sequence (``grants``, a tenant a grant) up to
    the first split count (``tenants``: {tenant: splits}) reached."""
    counts, ratio = collections.Counter(), None
    for tenant in grants:
        counts[tenant] += 1
        if counts[tenant] >= tenants[tenant]:
            break
    names = list(tenants)
    if counts[names[1]]:
        ratio = counts[names[0]] / counts[names[1]]
    return ratio, dict(counts)


class FleetGrantLog(object):
    """A dispatcher's trace recorder keeping each grant's tenant."""

    def __init__(self, split_base):
        self._split_base = split_base
        self.tenants = []

    def instant(self, name, **args):
        if name == 'service/lease_grant':
            self.tenants.append('vit-a' if args['split'] < self._split_base else 'vit-b')


def fleet_two_tenants(fa, url, fields, transform):
    """(a) Two tenants on one fleet: 'vit-a' (weight 2) is the dispatcher's
    own job, 'vit-b' (weight 1, an shm quota below one chunk) joins through
    ``register_tenant_job``; two worker processes of 2 threads serve both,
    and two ViT-S/16 models take their steps in turns here."""
    from petastorm_tpu_torch.benchmark.stall_profiler import StallMonitor
    from petastorm_tpu_torch.service import (Dispatcher, ServiceConfig, ServiceDataLoader,
                                             register_tenant_job)
    reader_kwargs = dict(schema_fields=fields, transform_spec=transform,
                         workers_count=SVC_THREADS)
    config = ServiceConfig(url, rowgroups_per_split=2, lease_ttl_s=2.0, tenant='vit-a',
                           tenant_weight=2.0, reader_kwargs=reader_kwargs)
    splits = SVC_ROWS // 64 // 2
    grant_log = FleetGrantLog(splits)
    with Dispatcher(config, trace_recorder=grant_log) as dispatcher:
        job = register_tenant_job(dispatcher.addr, 'vit-b', dict(
            dataset_url=url, rowgroups_per_split=2, lease_ttl_s=2.0,
            reader_kwargs=reader_kwargs, tenant_shm_quota_bytes=FLEET_SHM_QUOTA), weight=1.0)
        if job['split_base'] != splits:
            raise AssertionError('fleet: vit-b registered at %s' % job['split_base'])
        procs = [fleet_spawn_worker(dispatcher.addr) for _ in range(SVC_WORKERS)]
        try:
            fleet_wait('the workers to register',
                       lambda: len(dispatcher._op_stats({})['workers']) == SVC_WORKERS)
            tenants = ('vit-a', 'vit-b')
            steps = {t: vit_resident_step() for t in tenants}
            monitors = {t: StallMonitor(warmup_steps=SVC_WARMUP) for t in tenants}
            ids = {t: [] for t in tenants}
            losses = {t: [] for t in tenants}
            with contextlib.ExitStack() as stack:
                loaders = {t: stack.enter_context(ServiceDataLoader(
                    dispatcher.addr, batch_size=BATCH, consumer=0, tenant=t, device='cuda'))
                    for t in tenants}
                its = {t: iter(monitors[t].wrap(loaders[t])) for t in tenants}
                torch.cuda.synchronize()
                reset_counts(fa)
                for i in range(SVC_ROWS // BATCH):
                    if i == SVC_WARMUP:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                    for t in tenants:   # the steps alternate between the tenants
                        batch = next(its[t])
                        ids[t].append(batch['id'].clone())
                        losses[t].append(steps[t](batch))
                for t in tenants:
                    if next(its[t], None) is not None:
                        raise AssertionError('fleet: %s delivered more than an epoch' % t)
                torch.cuda.synchronize()
                elapsed = time.perf_counter() - t0
                launches, by_design = counts(fa)
            clients = {t: loaders[t].reader.diagnostics for t in tenants}
            # the workers' counters reach the dispatcher on their heartbeats
            chunks = SVC_ROWS // 64
            try:
                fleet_wait('the workers\' quota counters', lambda: dispatcher._op_stats({})[
                    'shm']['shm_quota_degraded'] >= clients['vit-b']['byte_chunks'], 10)
            except AssertionError:
                pass   # printed as it stands
            stats = dispatcher._op_stats({})
        finally:
            svc_stop_workers(procs)
    total_steps = 2 * (SVC_ROWS // BATCH)
    check_launches('fleet two tenants', launches, by_design,
                   {name: 12 * total_steps for name in launches})
    timed = SVC_ROWS // BATCH - SVC_WARMUP
    out = {'launches': launches, 'elapsed_s': elapsed}
    for t in tenants:
        got = [int(i) for i in torch.cat(ids[t]).cpu()]
        if sorted(got) != list(range(SVC_ROWS)):
            raise AssertionError('fleet %s: rows lost or repeated (%d, %d distinct)'
                                 % (t, len(got), len(set(got))))
        values = [float(v) for v in torch.stack(losses[t]).cpu()]
        if not np.all(np.isfinite(values)):
            raise AssertionError('fleet %s: non-finite loss %s' % (t, values))
        report = monitors[t].report()
        out[t] = {'images_per_s': timed * BATCH / elapsed,
                  'data_wait_ms': 1e3 * monitors[t].wait_time / monitors[t].steps,
                  'stall_pct': report['stall_pct'], 'grants': stats['tenants'][t]['grants'],
                  'shm_chunks': clients[t]['shm_chunks'],
                  'byte_chunks': clients[t]['byte_chunks']}
    out['images_per_s'] = 2 * timed * BATCH / elapsed
    out['step_ms'] = 1e3 * elapsed / (2 * timed)
    out['grant_ratio_while_both_pending'], out['grants_then'] = fleet_grant_ratio(
        grant_log.tenants, {'vit-a': splits, 'vit-b': splits})
    out['shm_quota_degraded'] = stats['shm']['shm_quota_degraded']
    if (out['vit-a']['shm_chunks'], out['vit-a']['byte_chunks']) != (chunks, 0) \
            or (out['vit-b']['shm_chunks'], out['vit-b']['byte_chunks']) != (0, chunks):
        raise AssertionError('fleet: vit-a shm/byte %d/%d and vit-b %d/%d chunks; expected '
                             'vit-a all shm, vit-b all bytes'
                             % (out['vit-a']['shm_chunks'], out['vit-a']['byte_chunks'],
                                out['vit-b']['shm_chunks'], out['vit-b']['byte_chunks']))
    return out


def fleet_restart(fa, url, fields, transform, tmp):
    """(b) The dispatcher, a process of its own on a fixed address with a
    ledger, SIGKILLed after ``FLEET_KILL_AFTER`` of 24 steps and started again
    on the same address and ledger; two worker processes of 2 threads."""
    import socket
    from petastorm_tpu_torch.service import ServiceDataLoader
    from petastorm_tpu_torch.service.ledger import DispatcherLedger
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        addr = 'tcp://127.0.0.1:%d' % sock.getsockname()[1]
    ledger_path = os.path.join(tmp, 'fleet_ledger.json')
    config_path = os.path.join(tmp, 'fleet_config.pkl')
    grants = [os.path.join(tmp, 'fleet_grants_%d.jsonl' % i) for i in range(2)]
    with open(config_path, 'wb') as f:
        # drain_timeout_s: a split whose complete was lost in the outage is
        # decoded again for no consumer, and its worker's drain waits it out
        pickle.dump(dict(dataset_url=url, rowgroups_per_split=2, lease_ttl_s=2.0,
                         ledger_path=ledger_path, drain_timeout_s=5.0,
                         reader_kwargs=dict(schema_fields=fields, transform_spec=transform,
                                            workers_count=SVC_THREADS)), f)
    procs, dispatchers, killed = [], [], {}
    try:
        dispatchers.append(fleet_spawn_dispatcher(addr, config_path, grants[0]))
        procs = [fleet_spawn_worker(addr) for _ in range(SVC_WORKERS)]
        fleet_wait('the workers to register',
                   lambda: len(fleet_rpc(addr, {'op': 'stats'})['workers']) == SVC_WORKERS)
        loader = ServiceDataLoader(addr, batch_size=BATCH, consumer=0, rpc_timeout_s=2.0,
                                   device='cuda')

        def on_step(i):
            if i + 1 != FLEET_KILL_AFTER:
                return
            ledger = DispatcherLedger(ledger_path)
            killed['journal_lines'] = ledger.journal_lines()
            dispatchers[0].kill()
            dispatchers[0].wait(timeout=30)
            killed['t'] = time.perf_counter()
            killed['done'] = sorted(i for i, (code, _) in enumerate(ledger.load()['splits'])
                                    if code == 'd')
            dispatchers.append(fleet_spawn_dispatcher(addr, config_path, grants[1]))
            killed['restart_s'] = time.perf_counter() - killed['t']
        run = svc_epoch(fa, loader, 'fleet restart', on_step=on_step)
        # the client's epoch ends at its last ack, a hop before the worker's
        # complete; a complete sent while no dispatcher served is lost (its
        # split is not done, and may be decoded again for no one)
        try:
            fleet_wait('every split done', lambda: fleet_rpc(addr, {'op': 'stats'})['done']
                       == SVC_ROWS // 64 // 2, 5)
        except AssertionError:
            pass   # reported as it stands
        stats = fleet_rpc(addr, {'op': 'stats'})
    finally:
        for proc in dispatchers:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        if procs:
            svc_stop_workers(procs)
    with open(grants[1]) as f:
        after = [json.loads(line) for line in f]
    released = sorted({g['split'] for g in after})
    again = sorted(set(released) & set(killed['done']))
    if again:
        raise AssertionError('fleet restart: splits %s, done before the kill, leased again'
                             % again)
    if stats['control_plane']['ledger_restores'] != 1 or stats['failed']:
        raise AssertionError('fleet restart: restores %d, %d splits failed'
                             % (stats['control_plane']['ledger_restores'], stats['failed']))
    # the longest step from the one the kill and the restart ran in
    gap = FLEET_KILL_AFTER - 1 + int(np.argmax(run['walls_ms'][FLEET_KILL_AFTER - 1:]))
    run.update(done_at_kill=killed['done'], journal_lines_at_kill=killed['journal_lines'],
               restart_s=killed['restart_s'], released_after=released,
               adopted=stats['control_plane']['ledger_adoptions'],
               requeued=stats['control_plane']['ledger_requeues'],
               lease_churn=stats['lease_churn'], done_after=stats['done'], gap_step=gap,
               gap_wall_ms=run['walls_ms'][gap], gap_wait_ms=run['waits_ms'][gap])
    return run


def fleet_plane_bytes(root):
    total = 0
    for where, _, files in os.walk(root):
        total += sum(os.path.getsize(os.path.join(where, f)) for f in files
                     if f.endswith(('.cpe', '.pkl')))
    return total


def fleet_cache(fa, url, fields, tmp):
    """(c) The cache plane and the cluster cache, workers of one decode
    thread: epoch 1 one worker over plane A (every piece a miss); epoch 2 that
    worker and a cold joiner over plane B (no miss: the warm worker's pieces
    from its plane, the joiner's fetched from it).  Beside them the local
    loader over ``make_reader(cache_type='plane')`` twice (the second all
    hits) and once over ``'local-disk'``."""
    import shutil

    from petastorm_tpu_torch.cache_plane.plane import default_ram_dir
    from petastorm_tpu_torch.gpu import DataLoader
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.service import Dispatcher, ServiceConfig, ServiceDataLoader
    from petastorm_tpu_torch.transform import ResizeImages
    resize = ResizeImages({'image': (224, 224)})
    planes = {name: os.path.join(tmp, 'fleet_plane_' + name) for name in ('A', 'B', 'local')}
    disk_dir = os.path.join(tmp, 'fleet_local_disk')
    config = ServiceConfig(url, rowgroups_per_split=2, lease_ttl_s=2.0, cache_plane=True,
                           cache_plane_dir=planes['A'],
                           reader_kwargs=dict(schema_fields=fields, transform_spec=resize,
                                              workers_count=1))
    step = vit_resident_step()
    runs, counters = {}, {}
    pieces = SVC_ROWS // 64
    try:
        for epoch, worker_planes in (('cluster 1', ['A']), ('cluster 2', ['A', 'B'])):
            with Dispatcher(config) as dispatcher:
                procs = [fleet_spawn_worker(dispatcher.addr, planes[p]) for p in worker_planes]
                try:
                    def ready():
                        stats = dispatcher._op_stats({})
                        cluster = stats['cluster_cache']
                        return len(stats['workers']) == len(worker_planes) \
                            and cluster['directory_workers'] == len(worker_planes) \
                            and (epoch == 'cluster 1' or (
                                cluster['piece_map'] and cluster['directory_digests'] >= pieces))
                    fleet_wait('the %s fleet\'s cluster identities' % epoch, ready)
                    loader = ServiceDataLoader(dispatcher.addr, batch_size=BATCH, consumer=0,
                                               device='cuda', transform_fn=fleet_labels)
                    runs[epoch] = svc_epoch(fa, loader, 'fleet ' + epoch, step=step)
                    keys = ('cache_hits', 'cache_misses', 'cache_degraded', 'cache_remote_hits',
                            'cache_peer_fills', 'cache_peer_degraded', 'splits_decoded')

                    def settled():
                        workers = dispatcher._op_stats({})['workers']
                        total = sum(int(w.get('splits_decoded', 0)) for w in workers.values())
                        return total >= pieces // 2
                    fleet_wait('the %s workers\' counters' % epoch, settled, 30)
                    stats = dispatcher._op_stats({})
                    counters[epoch] = {wid: {k: w.get(k) for k in keys}
                                       for wid, w in stats['workers'].items()}
                    counters[epoch]['directory'] = stats['cluster_cache']
                finally:
                    svc_stop_workers(procs)
        for epoch in ('local plane 1', 'local plane 2', 'local disk'):
            cache = dict(cache_type='plane', cache_location=planes['local']) \
                if 'plane' in epoch else dict(cache_type='local-disk', cache_location=disk_dir)
            reader = make_reader(url, num_epochs=1, schema_fields=fields, transform_spec=resize,
                                 columnar_decode=True, workers_count=1, **cache)
            runs[epoch] = svc_epoch(fa, DataLoader(reader, batch_size=BATCH, device='cuda',
                                                   transform_fn=fleet_labels),
                                    'fleet ' + epoch, step=step)
            counters[epoch] = {k: v for k, v in reader.diagnostics.items()
                               if k.startswith('cache_')}
        sizes = {name: fleet_plane_bytes(path) for name, path in planes.items()}
        sizes['local disk'] = fleet_plane_bytes(disk_dir)
    finally:
        for path in planes.values():   # the hot tiers live in /dev/shm
            shutil.rmtree(default_ram_dir(path), ignore_errors=True)
    one = [w for k, w in counters['cluster 1'].items() if k != 'directory']
    two = [w for k, w in counters['cluster 2'].items() if k != 'directory']
    total = {k: sum(int(w[k] or 0) for w in two)
             for k in ('cache_misses', 'cache_remote_hits', 'cache_peer_fills')}
    if sum(int(w['cache_misses'] or 0) for w in one) != pieces:
        raise AssertionError('fleet cluster 1: misses %s, expected %d' % (one, pieces))
    if total['cache_misses'] or total['cache_remote_hits'] != pieces:
        raise AssertionError('fleet cluster 2: %s; expected no miss and %d pieces served from '
                             'the planes' % (two, pieces))
    if counters['local plane 2'].get('cache_hits') != pieces \
            or counters['local plane 2'].get('cache_misses'):
        raise AssertionError('fleet local plane 2: %s; expected %d hits'
                             % (counters['local plane 2'], pieces))
    return runs, counters, sizes


def phase_service_fleet(fa, tmp):
    """The data service's shared fleet feeding ViT-S/16 on the card, on
    ``phase_service``'s 1,536-row JPEG store: (a) two tenants on one fleet,
    (b) the dispatcher SIGKILLed and restarted from its ledger, (c) the cache
    plane and the cluster cache (:func:`fleet_two_tenants`,
    :func:`fleet_restart`, :func:`fleet_cache`).  Every run is one epoch of
    24 graphed steps at full width, batch 64, timed after 4: every row id
    once, finite losses, 12 launches of each flash kernel a step."""
    from petastorm_tpu_torch.train import make_transform
    url = 'file://' + os.path.join(tmp, 'service_jpeg')
    fields = ['id', 'image', 'noun_id']
    transform = make_transform((224, 224))
    launches = collections.Counter()
    t0 = time.monotonic()
    tenants = fleet_two_tenants(fa, url, fields, transform)
    launches.update(tenants['launches'])
    log('fleet two tenants (%.1f s): %s' % (time.monotonic() - t0, json.dumps(
        {k: v for k, v in tenants.items() if k != 'launches'})))
    t0 = time.monotonic()
    restart = fleet_restart(fa, url, fields, transform, tmp)
    launches.update(restart['launches'])
    log('fleet restart (%.1f s): %s' % (time.monotonic() - t0, json.dumps(svc_brief(restart))))
    log('fleet restart steps: walls ms %s, waits ms %s'
        % ([round(w, 2) for w in restart['walls_ms']], [round(w, 2) for w in restart['waits_ms']]))
    t0 = time.monotonic()
    runs, counters, sizes = fleet_cache(fa, url, fields, tmp)
    for run in runs.values():
        launches.update(run['launches'])
    cold = runs['cluster 1']['images_per_s']
    log('fleet cache (%.1f s): %s' % (time.monotonic() - t0, json.dumps(
        {epoch: dict(svc_brief(run), vs_cold=run['images_per_s'] / cold)
         for epoch, run in runs.items()})))
    log('fleet cache counters: %s' % json.dumps(counters))
    log('fleet cache bytes on disk: %s' % json.dumps(sizes))
    SUMMARY['service_fleet'] = {
        'two_tenants': {k: v for k, v in tenants.items() if k != 'launches'},
        'restart': svc_brief(restart),
        'cache': {epoch: svc_brief(run) for epoch, run in runs.items()},
        'cache_counters': counters, 'plane_bytes': sizes}
    return dict(launches)


# -- the control plane: the autoscaler, the command line, the journal, spans, chaos --

CTL_MAX_EPOCHS = 6      # epochs until three warm workers lived through a whole one, at most
CTL_MAX_WORKERS = 3
CTL_CONFIG = dict(autoscale=True, autoscale_min_workers=1, autoscale_max_workers=CTL_MAX_WORKERS,
                  autoscale_step=1, autoscale_cooldown_s=1.0, autoscale_starve_s=0.3,
                  autoscale_idle_s=3.0)
CTL_WORKER_SPANS = ('service/decode_split', 'service/serialize', 'service/shm_publish',
                    'service/serve_cached_split')


def ctl_env():
    """A child of the control plane's: no card, labels hashed alike, the
    checkout on its path."""
    return dict(os.environ, CUDA_VISIBLE_DEVICES='', PYTHONHASHSEED='0',
                PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))


def ctl_cli(*argv, timeout=60):
    """One run of ``python -m petastorm_tpu_torch.service.cli``; fails on a
    non-zero exit."""
    proc = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.service.cli'] + list(argv),
                          env=ctl_env(), capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError('control: cli %s exited %d: %s'
                             % (argv[0], proc.returncode, proc.stderr[-2000:]))
    return proc.stdout


class CtlGrants(object):
    """The dispatcher's trace recorder: each lease grant's worker and time,
    and each lease expiry's time."""

    def __init__(self):
        self.grants = []
        self.expiries = []

    def instant(self, name, **args):
        if name == 'service/lease_grant':
            self.grants.append((args['worker'], time.monotonic()))
        elif name == 'service/lease_expired':
            self.expiries.append(time.monotonic())

    def between(self, t0, t1):
        """Grants by worker, and expiries, inside [t0, t1]."""
        by_worker = collections.Counter(w for w, t in self.grants if t0 <= t <= t1)
        return dict(sorted(by_worker.items())), sum(1 for t in self.expiries if t0 <= t <= t1)


def ctl_fleet(dispatcher, pids):
    """The live, not draining workers; records each one's pid in ``pids``."""
    stats = dispatcher._op_stats({})
    for wid, row in stats['workers'].items():
        if row.get('pid'):
            pids[wid] = row['pid']
    return sorted(wid for wid, row in stats['workers'].items() if not row.get('draining')), stats


def ctl_spans(recorder, t_start, t_end, base, splits):
    """The workers' spans of one epoch's splits (split ids ``base`` ..
    ``base + splits``) by name, and how many lie outside the client's window
    [t_start, t_end]."""
    lo, hi = 1e6 * (t_start - recorder._t0), 1e6 * (t_end - recorder._t0)
    names, outside = collections.Counter(), 0
    for ev in recorder.events:
        if ev['name'] not in CTL_WORKER_SPANS:
            continue
        split = int(str(ev.get('args', {}).get('cid', '-1')).split('/')[0])
        if not base <= split < base + splits:
            continue
        names[ev['name']] += 1
        outside += not (lo <= ev['ts'] and ev['ts'] + ev['dur'] <= hi)
    return dict(names), outside


def ctl_autoscaled_fleet(fa, url, fields, transform, tmp):
    """(a) A dispatcher with the autoscaler, its first worker started by the
    command line and the others by the autoscaler's launcher (the same
    command), feeding epochs of graphed ViT-S/16 (each epoch a tenant job of
    its own over the store: a job is one epoch) until three workers that each
    served a lease before it were alive for a whole epoch, or six epochs; then the idle fleet drains to one
    worker, and ``status``, ``clock`` and ``stop`` run against the
    dispatcher.  Fails unless the fleet scaled out and back in within
    [1, 3] workers, every journal record replays clean, ``/metrics`` holds
    the autoscaler's gauges, the workers' spans reached each epoch's trace,
    and no slab or child process is left."""
    from petastorm_tpu_torch.benchmark import TraceRecorder
    from petastorm_tpu_torch.service import (Dispatcher, ServiceConfig, ServiceDataLoader,
                                             register_tenant_job)
    from petastorm_tpu_torch.service.autoscaler import SubprocessWorkerLauncher
    from petastorm_tpu_torch.telemetry import decisions, scrape
    from petastorm_tpu_torch.workers_pool import shm_plane
    job = dict(dataset_url=url, rowgroups_per_split=2, lease_ttl_s=2.0,
               reader_kwargs=dict(schema_fields=fields, transform_spec=transform,
                                  workers_count=1))
    config = ServiceConfig(**dict(job, **CTL_CONFIG))
    launcher = SubprocessWorkerLauncher(env={'PYTHONHASHSEED': '0', 'CUDA_VISIBLE_DEVICES': ''})
    grants, pids, epochs, spawned = CtlGrants(), {}, [], []
    step = vit_resident_step()
    first = server = None
    with Dispatcher(config, launcher=launcher, trace_recorder=grants) as dispatcher:
        try:
            server = scrape.start_metrics_server(0, host='127.0.0.1',
                                                 refresh=lambda: dispatcher._op_stats({}))
            first = subprocess.Popen([sys.executable, '-m', 'petastorm_tpu_torch.service.cli',
                                      'worker', '--dispatcher', dispatcher.addr],
                                     env=ctl_env(), stdout=subprocess.DEVNULL,
                                     stderr=subprocess.DEVNULL)
            fleet_wait('the first worker', lambda: ctl_fleet(dispatcher, pids)[0])
            base, splits = 0, dispatcher._job['num_splits']
            for epoch in range(CTL_MAX_EPOCHS):
                if epoch:
                    base = register_tenant_job(dispatcher.addr, 'epoch%d' % epoch,
                                               job)['split_base']
                alive_before, _ = ctl_fleet(dispatcher, pids)
                recorder = TraceRecorder()
                t_start = time.monotonic()
                loader = ServiceDataLoader(dispatcher.addr, batch_size=BATCH, consumer=0,
                                           tenant='epoch%d' % epoch if epoch else None,
                                           device='cuda', trace_recorder=recorder)
                run = svc_epoch(fa, loader, 'control epoch %d' % epoch, step=step)
                t_end = time.monotonic()
                alive_after, _ = ctl_fleet(dispatcher, pids)
                names, outside = ctl_spans(recorder, t_start, t_end, base, splits)
                client = loader.reader.diagnostics
                by_worker, expiries = grants.between(t_start, t_end)
                longest = max(range(len(run['waits_ms'])), key=run['waits_ms'].__getitem__)
                run.update(alive_before=len(alive_before), alive_after=len(alive_after),
                           spans=names, spans_outside=outside,
                           spans_merged=client['spans_merged'],
                           clock_offset_s=client['clock_offset_s'], grants=by_worker,
                           expiries=expiries, longest_wait=(longest,
                                                            round(run['waits_ms'][longest], 2)))
                epochs.append(run)
                # a worker's first splits carry its start-up (the reader's and
                # cv2's first calls): the last epoch is one every worker of
                # three served before it began, and lived through
                warm = {w for w, t in grants.grants if t < t_start} & set(alive_before)
                run['warm_before'] = len(warm)
                log('control epoch %d: %.1f images/s, step %.2f ms, data wait %.2f ms, stall '
                    '%.1f%%, workers alive %d (%d warm) -> %d, grants %s, expiries %d, longest '
                    'wait %.1f ms (step %d), worker spans %s (%d outside the window)'
                    % (epoch, run['images_per_s'], run['step_ms'], run['data_wait_ms'],
                       run['stall_pct'], len(alive_before), len(warm), len(alive_after),
                       by_worker, expiries, run['waits_ms'][longest], longest, names, outside))
                if len(warm) >= CTL_MAX_WORKERS and len(alive_after) >= CTL_MAX_WORKERS:
                    break
            reached = max(max(r['alive_before'], r['alive_after']) for r in epochs)
            if reached > CTL_MAX_WORKERS:
                raise AssertionError('control: %d workers alive, over autoscale_max_workers %d'
                                     % (reached, CTL_MAX_WORKERS))
            t_idle = time.monotonic()
            fleet_wait('the idle fleet to drain to one worker',
                       lambda: len(ctl_fleet(dispatcher, pids)[1]['workers']) == 1, 60)
            drained_s = time.monotonic() - t_idle
            _, stats = ctl_fleet(dispatcher, pids)
            body = urllib.request.urlopen('http://127.0.0.1:%d/metrics'
                                          % server.server_address[1], timeout=10).read().decode()
            journal = dispatcher._op_decisions({})['journal']
            status = json.loads(ctl_cli('status', '--dispatcher', dispatcher.addr))
            clock = json.loads(ctl_cli('clock', '--dispatcher', dispatcher.addr))
            spawned = launcher.procs   # its list empties when the dispatcher closes it
            ctl_cli('stop', '--dispatcher', dispatcher.addr)
            dispatcher.join()
        finally:
            if server is not None:
                server.shutdown()
                server.server_close()
            if first is not None:
                svc_stop_workers([first])
    t0 = grants.grants[0][1]
    first_lease = {}
    for wid, t in grants.grants:
        first_lease.setdefault(wid, t)
    wid_of = {pid: wid for wid, pid in pids.items()}
    records = journal['records']
    actions, spawns = [], []
    for rec in records:
        if rec['actor'] != 'autoscaler':
            continue
        actions.append({'action': rec['action'], 'rule': rec['rule'],
                        'suppressed': rec['suppressed'], 'worker_id': rec.get('worker_id'),
                        'at_s': round(rec['t_mono'] - t0, 3)})
        if rec['action'] == 'scale_out' and not rec['suppressed']:
            spawns.append(rec)
    # the launcher spawns one worker a scale-out (autoscale_step 1), in order
    spawn_to_lease = {}
    for rec, proc in zip(spawns, spawned):
        wid = wid_of.get(proc.pid)
        if wid in first_lease:
            spawn_to_lease[wid] = round(first_lease[wid] - rec['t_mono'], 3)
    verdicts = [(r['actor'], r['action'], r['rule'], decisions.replay_decision(r)['verdict'])
                for r in records]
    auto = status['autoscale']
    offsets = {wid: {'clock_offset_s': row.get('clock_offset'),
                     'clock_rtt_ms': row.get('clock_rtt_ms'),
                     'clock_drift_ms': row.get('clock_drift_ms')}
               for wid, row in stats['workers'].items()}
    gauges = [line for line in body.splitlines() if line.startswith('petastorm_tpu_decisions_')]
    residue = shm_plane.residue(list(pids.values()) + [os.getpid()])
    left = [p.pid for p in [first] + spawned if p.poll() is None]
    result = {'epochs': [svc_brief(r) for r in epochs], 'autoscale': auto,
              'actions': actions, 'spawn_to_first_lease_s': spawn_to_lease,
              'drained_to_one_s': round(drained_s, 3), 'journal': verdicts,
              'worker_clocks': offsets, 'cli_clock': clock, 'metrics_gauges': gauges,
              'metrics_lines': len(body.splitlines()), 'residue': sorted(residue),
              'children_left': left, 'spawned': [p.pid for p in spawned],
              'workers_reached': reached}
    log('control actions (s from the first lease): %s' % json.dumps(actions))
    log('control spawn to first lease (s): %s; %d workers at most; drained to one worker in '
        '%.1f s; autoscale %s' % (json.dumps(spawn_to_lease), reached, drained_s,
                                  json.dumps(auto)))
    log('control journal (actor, action, rule, replay): %s' % json.dumps(verdicts))
    log('control clocks: workers %s, cli clock %s' % (json.dumps(offsets), json.dumps(clock)))
    log('control /metrics: %d lines, decision gauges %s' % (len(body.splitlines()),
                                                            json.dumps(gauges)))
    if any(v[3] == 'divergent' for v in verdicts):
        raise AssertionError('control: a journal record replays divergent: %s' % verdicts)
    if not auto['scale_outs'] or not auto['scale_ins'] or auto['actions'] > 2 * CTL_MAX_WORKERS:
        raise AssertionError('control: autoscale %s' % auto)
    if not any('actor="autoscaler"' in g for g in gauges):
        raise AssertionError('control: /metrics holds no autoscaler gauge: %s' % gauges)
    if not all(r['spans'].get('service/decode_split') for r in epochs):
        raise AssertionError('control: the workers\' spans did not reach the client\'s trace: '
                             '%s' % [r['spans'] for r in epochs])
    if residue or left:
        raise AssertionError('control: /dev/shm residue %s, children left %s' % (residue, left))
    return result, epochs


def ctl_chaos_smoke():
    """(b) The chaos smoke set through the port's runner, on this host at
    the runner's own store: each scenario's invariants, seams and
    autoscale actions."""
    from petastorm_tpu_torch.test_util import chaos
    reports, ok = chaos.run_matrix(list(chaos.SMOKE_SCENARIOS))
    out = {}
    for report in reports:
        out[report['scenario']] = {'ok': report['ok'], 'checks': report['checks'],
                                   'injections': report['injections'],
                                   'autoscale': report.get('autoscale'),
                                   'elapsed_s': report.get('elapsed_s')}
        log('control chaos %s: %s' % (report['scenario'], json.dumps(out[report['scenario']])))
    if not ok:
        raise AssertionError('control: a chaos scenario broke an invariant:\n%s'
                             % chaos.render_report(reports))
    return out


def phase_service_control(fa, tmp):
    """The data service's control plane feeding ViT-S/16 on the card, on
    ``phase_service``'s 1,536-row JPEG store: (a) an autoscaled fleet run
    through the command line (:func:`ctl_autoscaled_fleet`: one decode
    thread a worker keeps a one-worker fleet host-bound, so the scale-out
    shows in images/s), every epoch 24 graphed steps at full width, batch
    64, timed after 4, every row id once, finite losses, 12 launches of each
    flash kernel a step; (b) the chaos smoke set (:func:`ctl_chaos_smoke`)."""
    from petastorm_tpu_torch.train import make_transform
    url = 'file://' + os.path.join(tmp, 'service_jpeg')
    t0 = time.monotonic()
    fleet, epochs = ctl_autoscaled_fleet(fa, url, ['id', 'image', 'noun_id'],
                                         make_transform((224, 224)), tmp)
    log('control fleet (%.1f s): %s' % (time.monotonic() - t0, json.dumps(
        {k: v for k, v in fleet.items() if k != 'epochs'})))
    t0 = time.monotonic()
    smoke = ctl_chaos_smoke()
    log('control chaos smoke: %.1f s' % (time.monotonic() - t0))
    SUMMARY['service_control'] = dict(fleet, chaos=smoke)
    launches = collections.Counter()
    for run in epochs:
        launches.update(run['launches'])
    return dict(launches)


ING_STEPS = 28          # graphed ViT-S/16 steps a leg, timed after ING_WARMUP
ING_WARMUP = 4
ING_EPOCHS = 2          # each leg's reader: two epochs, read to the end after the steps
ING_PIECE_FETCH_S = 1.0  # one row group's read through one handle of the emulated store
ING_COLD_LATENCY_S = 0.05   # a cold GET: paid once by each handle (a plane fetch opens one)
ING_COLD_THRESHOLD = 1 << 20   # the store's one data file is far above it
ING_LEGS = (('fifo', dict(scheduling='fifo', ingest='off'), 'auto'),
            ('adaptive', dict(scheduling='adaptive', ingest='off'), 'auto'),
            ('adaptive+plane', dict(scheduling='adaptive', ingest='plane'), True))
ING_GAUGES = ('sched_window', 'sched_max_inflight', 'sched_prefetch', 'sched_ingest_window')
ING_COUNTERS = ('ingest_fetches', 'ingest_fetch_bytes', 'ingest_gets', 'ingest_degraded',
                'ingest_hedges', 'ingest_hedge_wins', 'ingest_window')


def ing_bps(url):
    """The emulated store's bandwidth a handle: the mean row group's
    compressed bytes over ``ING_PIECE_FETCH_S``."""
    from petastorm_tpu_torch.etl.dataset_metadata import (load_row_groups,
                                                          read_row_group_byte_sizes)
    from petastorm_tpu_torch.fs_utils import LocalFilesystem, get_filesystem_and_path
    fs, path = get_filesystem_and_path(url)
    pieces = load_row_groups(fs, path)
    sizes = read_row_group_byte_sizes(LocalFilesystem(), {p.path for p in pieces})
    mean = sum(sizes.values()) / len(sizes)
    return mean / ING_PIECE_FETCH_S, mean, len(sizes)


def ing_leg(fa, url, fields, transform, step, label, bps, reader_kwargs, autotune):
    """One leg: ViT-S/16 fed by ``make_reader`` over the emulated cold store
    (8 decode threads, columnar) and ``DataLoader``: ``ING_STEPS`` graphed
    steps (the counts set to 0 just before), then the rest of the reader's
    two epochs read without steps.  Returns the leg's numbers and every
    delivered row id in order."""
    from petastorm_tpu_torch.benchmark.stall_profiler import StallMonitor
    from petastorm_tpu_torch.fs_utils import LocalFilesystem
    from petastorm_tpu_torch.gpu import DataLoader
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.telemetry import decisions
    from petastorm_tpu_torch.test_util.emulation import BandwidthLimitedFilesystem
    fs = BandwidthLimitedFilesystem(LocalFilesystem(), bps=bps, cold_latency=ING_COLD_LATENCY_S,
                                    cold_threshold=ING_COLD_THRESHOLD)
    journal = decisions.default_journal()
    before = journal.counts()
    monitor = StallMonitor(warmup_steps=ING_WARMUP)
    ids, losses = [], []
    host_s = 0.0
    torch.cuda.synchronize()
    t_open = time.perf_counter()
    with make_reader(url, schema_fields=fields, transform_spec=transform, filesystem=fs,
                     workers_count=8, columnar_decode=True, num_epochs=ING_EPOCHS,
                     **reader_kwargs) as reader:
        loader = DataLoader(reader, BATCH, autotune=autotune)
        if autotune is True:
            loader.attach_stall_monitor(monitor)
        gauges = {}
        with loader:
            batches = monitor.wrap(loader)
            reset_counts(fa)
            for i in range(ING_STEPS):
                batch = next(batches)
                if i == 0:
                    first_batch_s = time.perf_counter() - t_open
                    gauges['start'] = {k: loader.metrics.as_dict().get(k) for k in ING_GAUGES}
                if i == ING_WARMUP:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                if batch['image'].device.type != 'cuda':
                    raise AssertionError('%s: a batch reached the step on %s'
                                         % (label, batch['image'].device))
                ids.append(batch['id'].clone())
                t1 = time.perf_counter()
                losses.append(step(batch))
                if i >= ING_WARMUP:
                    host_s += time.perf_counter() - t1
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            launches, by_design = counts(fa)
            report = monitor.report()
            waited = (monitor.wait_time, monitor.steps)
            gauges['end'] = {k: loader.metrics.as_dict().get(k) for k in ING_GAUGES}
            for batch in batches:    # the rest of the two epochs, no steps
                ids.append(batch['id'].clone())
        diag = reader.diagnostics
        hists = reader.metrics.as_dict() if reader.metrics is not None else {}
    after = journal.counts()
    ids = [int(i) for i in torch.cat(ids).cpu()]
    losses = [float(v) for v in torch.stack(losses).cpu()]
    if not np.all(np.isfinite(losses)):
        raise AssertionError('%s: non-finite loss %s' % (label, losses))
    check_launches(label, launches, by_design, {name: 12 * ING_STEPS for name in launches})
    counted = collections.Counter(ids)
    if len(ids) != ING_EPOCHS * SVC_ROWS or set(counted) != set(range(SVC_ROWS)) \
            or set(counted.values()) != {ING_EPOCHS}:
        raise AssertionError('%s: rows lost or repeated in an epoch (%d delivered, %d distinct, '
                             'counts %s)' % (label, len(ids), len(counted),
                                             sorted(set(counted.values()))))
    timed = ING_STEPS - ING_WARMUP
    decisions_by_actor = {actor: {k: c[k] - before.get(actor, {}).get(k, 0) for k in c}
                          for actor, c in after.items()
                          if c != before.get(actor)}
    run = {'steps': ING_STEPS, 'launches': launches,
           'images_per_s': timed * BATCH / elapsed, 'step_ms': 1e3 * elapsed / timed,
           'host_ms': 1e3 * host_s / timed,
           'data_wait_ms': 1e3 * waited[0] / waited[1] if waited[1] else None,
           'stall_pct': report['stall_pct'], 'first_batch_s': first_batch_s,
           'scheduling': diag['scheduling'], 'ingest': diag['ingest'],
           'counters': {k: diag.get(k) for k in ING_COUNTERS},
           'ingest_wait_ms': {q: hists.get('ingest_wait_%s_ms' % q) for q in ('p50', 'p99')},
           'ingest_wait_count': hists.get('ingest_wait_count'),
           'ingest_fetch_ms': {q: hists.get('ingest_fetch_%s_ms' % q) for q in ('p50', 'p99')},
           'decode_ms': {q: hists.get('decode_%s_ms' % q) for q in ('p50', 'p99')},
           'gauges': gauges, 'decisions': decisions_by_actor,
           'fetch_bound': bool(waited[1] and waited[0] / waited[1] > 0.5 * elapsed / timed)}
    return run, ids


def phase_ingest(fa, tmp):
    """Adaptive scheduling, the autotuner and the async ingest plane feeding
    ViT-S/16 on the card, over the cold-store emulation
    (``BandwidthLimitedFilesystem``) of ``phase_service``'s 1,536-row JPEG
    store (24 row groups of 64, one file): each handle reads at the mean row
    group's bytes per ``ING_PIECE_FETCH_S`` and pays ``ING_COLD_LATENCY_S``
    once.  Three legs of ``make_reader(..., filesystem=, workers_count=8,
    columnar_decode=True)`` and ``DataLoader``, each ``ING_STEPS`` graphed
    steps at full width, batch 64, timed after ``ING_WARMUP``: (a) FIFO, (b)
    adaptive, (c) adaptive with the ingest plane, the autotuner on and a
    ``StallMonitor`` attached.  Each prints images/s, step ms, data wait,
    ``stall_pct``, the ingest counters, ``ingest_wait``/``ingest_fetch``
    p50/p99, the ``sched_*`` gauges at the first batch and at the last step,
    and the decision records by actor.  Fails when a loss is not finite, a
    kernel was not launched 12 times a step, a row is lost or repeated in
    one of the two epochs, (b) and (c) differ in delivered ids or order, or
    (c) has no plane, no fetch or a degraded piece."""
    from petastorm_tpu_torch.train import make_transform
    url = 'file://' + os.path.join(tmp, 'service_jpeg')
    bps, mean_bytes, pieces = ing_bps(url)
    log('ingest store: %d row groups, mean %.0f bytes; emulated bps %.0f a handle, cold latency '
        '%.3f s a handle (files >= %d bytes)' % (pieces, mean_bytes, bps, ING_COLD_LATENCY_S,
                                                 ING_COLD_THRESHOLD))
    fields, transform = ['id', 'image', 'noun_id'], make_transform((224, 224))
    step = vit_resident_step()
    runs, delivered = {}, {}
    for label, reader_kwargs, autotune in ING_LEGS:
        t0 = time.monotonic()
        runs[label], delivered[label] = ing_leg(fa, url, fields, transform, step, label, bps,
                                                reader_kwargs, autotune)
        log('ingest %s (%.1f s): %s' % (label, time.monotonic() - t0,
                                         json.dumps({k: v for k, v in runs[label].items()
                                                     if k != 'launches'})))
    plane = runs['adaptive+plane']
    if delivered['adaptive'] != delivered['adaptive+plane']:
        raise AssertionError('ingest: the adaptive legs with and without the plane delivered '
                             'different ids or orders')
    if plane['ingest'] != 'plane' or not plane['counters']['ingest_fetches'] \
            or plane['counters']['ingest_degraded']:
        raise AssertionError('ingest: the plane leg ran ingest=%r with %s'
                             % (plane['ingest'], plane['counters']))
    log('ingest: images/s fifo %.1f, adaptive %.1f, adaptive+plane %.1f; data wait ms %s; '
        'fetch-bound fifo: %s' % (runs['fifo']['images_per_s'], runs['adaptive']['images_per_s'],
                                 plane['images_per_s'],
                                 [runs[k]['data_wait_ms'] for k, _, _ in ING_LEGS],
                                 runs['fifo']['fetch_bound']))
    SUMMARY['ingest'] = dict(runs, bps=bps, mean_row_group_bytes=mean_bytes,
                             cold_latency_s=ING_COLD_LATENCY_S)
    launches = collections.Counter()
    for run in runs.values():
        launches.update(run['launches'])
    return dict(launches)


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
                            ('trace', lambda: phase_trace(url, tmp)),
                            ('resume', lambda: phase_resume(
                                fa, url, 'file://' + os.path.join(tmp, 'lc_tokens'), tmp)),
                            ('elastic', lambda: phase_elastic(
                                fa, 'file://' + os.path.join(tmp, 'lc_tokens'), tmp)),
                            ('batch_reader', lambda: phase_batch_reader(fa, tmp)),
                            ('reference_footer', lambda: phase_reference_footer(tmp)),
                            ('ngram', lambda: phase_ngram(fa, tmp)),
                            ('resident', lambda: phase_resident(fa, url, tmp)),
                            ('search', lambda: phase_search(fa, paths['packed'][1])),
                            ('vit_recipe', lambda: phase_vit_recipe(fa, url)),
                            ('sequence_parallel', lambda: phase_sequence_parallel(fa, tmp)),
                            ('multi_device', lambda: phase_multi_device(fa, url, tmp)),
                            ('service', lambda: phase_service(fa, tmp)),
                            ('service_fleet', lambda: phase_service_fleet(fa, tmp)),
                            ('service_control', lambda: phase_service_control(fa, tmp)),
                            ('ingest', lambda: phase_ingest(fa, tmp))):
            t0 = time.monotonic()
            paths[name] = phase()
            log('phase %s: %.1f s' % (name, time.monotonic() - t0))
    launches = {'vit': paths['vit'], 'lm': paths['lm'], 'packed': paths['packed'][0],
                'generate': paths['generate'], 'resident': paths['resident'],
                'search': paths['search'], 'vit_recipe': paths['vit_recipe'],
                'sequence_parallel': paths['sequence_parallel'],
                'multi_device': paths['multi_device'], 'elastic': paths['elastic'],
                'service': paths['service'], 'service_fleet': paths['service_fleet'],
                'service_control': paths['service_control'], 'ingest': paths['ingest']}
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
