"""Token Parquet -> ``TransformerLM`` training steps and KV-cache sampling on
the card.

Counterpart of the JAX package's long-context examples, on one device:

* :func:`train_lm` is ``examples/long_context/jax_example.py`` with
  ``--strategy flash`` (what ``auto`` resolves to on one device) or
  ``dense``: fixed-length documents (:func:`write_token_dataset`, the
  schema of ``generate_token_parquet.py``) read columnar with 4 decode
  threads, batches of 8 through :class:`~petastorm_tpu_torch.gpu.DataLoader`,
  a ``TransformerLM`` of 4 layers at d_model 256 with ``remat=True``, and
  AdamW under the next-token cross entropy against ``roll(tokens, -1)``.
* :func:`train_packed` is ``packed_example.py::train``: documents of 32 to
  512 tokens (:func:`write_var_token_dataset`) read by a row reader and
  packed into ``(4, 512)`` batches by
  :class:`~petastorm_tpu_torch.gpu.PackedDataLoader`; attention restricted
  to each document (``'dense'``: ``packing.packed_attention``, the
  example's; ``'flash'``: the flash kernels with segment ids), per-document
  positions, and a loss weighted by ``packing.next_token_targets``.
* :func:`sample` is ``packed_example.py::sample``: KV-cache generation from
  a corpus-style prompt (``models.decoding.generate``).

Parameters are fp32 with bf16 compute, as flax's; ``optax.adamw(lr)`` is
``torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)``
(optax's decay, on every parameter; on the card ``capturable=True``, its
step count on the device).  Each step runs inside a
``torch.profiler.record_function`` range named ``train_step``.

On the card the train steps and the sampler's token steps replay CUDA
graphs, the counterpart of the examples' ``jax.jit`` and of ``generate``'s
``lax.scan`` (:mod:`petastorm_tpu_torch.gpu.graphs`); the CPU runs them
eagerly, and so does the card with ``cuda_graph=False``.

Run ``python -m petastorm_tpu_torch.train_lm --dataset-url URL [--generate]``
with the examples' ``--steps``, ``--batch-size``, ``--strategy``,
``--packed`` and ``--sample`` (card only).
"""

import argparse
import functools
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from petastorm_tpu_torch import random as prng
from petastorm_tpu_torch.benchmark import StallMonitor
from petastorm_tpu_torch.codecs import NdarrayCodec
from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
from petastorm_tpu_torch.gpu import DataLoader, PackedDataLoader, graphs, packing
from petastorm_tpu_torch.gpu.transfer import resolve_device
from petastorm_tpu_torch.models.decoding import generate
from petastorm_tpu_torch.models.transformer import TransformerLM, make_attn_fn
from petastorm_tpu_torch.parallel import mesh as mesh_lib
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.train import _check_replicated, _sync
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

__all__ = ['LONG_CONTEXT_LM', 'PACKED_LM', 'write_token_dataset', 'write_var_token_dataset',
           'train_lm', 'train_packed', 'packed_loss', 'sample', 'main']

#: generate_token_parquet.py: documents of SEQ_LEN tokens over VOCAB.
SEQ_LEN, VOCAB = 1024, 4096
#: jax_example.py:74-78
LONG_CONTEXT_LM = dict(vocab_size=VOCAB, d_model=256, num_heads=8, num_layers=4, d_ff=1024,
                       max_seq_len=SEQ_LEN)
#: packed_example.py:37-44
PACKED_VOCAB, PACKED_MAX_LEN = 1024, 512
PACKED_LM = dict(vocab_size=PACKED_VOCAB, d_model=128, num_heads=4, num_layers=2, d_ff=256,
                 max_seq_len=PACKED_MAX_LEN)

TokenSchema = Unischema('TokenSchema', [
    UnischemaField('doc_id', np.int64, (), None, False),
    UnischemaField('tokens', np.int32, (SEQ_LEN,), NdarrayCodec(), False),
])
VarTokenSchema = Unischema('VarTokenSchema', [
    UnischemaField('doc_id', np.int64, (), None, False),
    # wildcard first dim: every document has its own length
    UnischemaField('tokens', np.int32, (None,), NdarrayCodec(), False),
])


def write_token_dataset(url, num_docs=256):
    """``generate_token_parquet.py``: ``num_docs`` documents of 1024 int32
    tokens (zipf 1.3 mod 4096), 32 rows per row group, from seed 0."""
    rng = np.random.default_rng(0)
    with DatasetWriter(url, TokenSchema, rows_per_rowgroup=32) as writer:
        for i in range(num_docs):
            tokens = (rng.zipf(1.3, SEQ_LEN) % VOCAB).astype(np.int32)
            writer.write({'doc_id': np.int64(i), 'tokens': tokens})
    return url


def write_var_token_dataset(url, num_docs=512):
    """``packed_example.py::generate``: ``num_docs`` documents of 32 to 512
    int32 tokens (zipf 1.4 mod 1024), 64 rows per row group, from seed 0."""
    rng = np.random.default_rng(0)
    with DatasetWriter(url, VarTokenSchema, rows_per_rowgroup=64) as writer:
        for i in range(num_docs):
            length = int(rng.integers(32, PACKED_MAX_LEN + 1))
            tokens = (rng.zipf(1.4, length) % PACKED_VOCAB).astype(np.int32)
            writer.write({'doc_id': np.int64(i), 'tokens': tokens})
    return url


def _adamw(model, lr, device):
    # optax.adamw(lr): b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on
    # every parameter (torch's default decay is 1e-2).  On the card the step
    # count lives on the device, so that a captured step advances it, eager
    # or graphed alike; the CPU keeps the host count.
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4, capturable=device.type == 'cuda')


def _model(config, **kwargs):
    return TransformerLM(generator=torch.Generator().manual_seed(0), **config, **kwargs)


def _check_batch(tokens, device, batch_devices):
    batch_devices.add(tokens.device.type)
    if tokens.device.type != device.type:
        raise RuntimeError('batch reached the model on %s, expected %s' % (tokens.device, device))


def _with_labels(batch):
    """The loader's host batch -> ``tokens`` and their next-token ``labels``,
    ``roll(tokens, -1, axis=1)`` over each whole row (jax_example.py:90),
    before the sequence is split: a roll of a block is wrong at its edge."""
    tokens = batch['tokens']
    return {'tokens': tokens, 'labels': np.roll(tokens, -1, axis=1)}


def _all_reduce_grads(params):
    """Sum every gradient over the world: one all-reduce over a flat buffer."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _train_step(model, opt, positions, token_count, params=None):
    """The example's step: the model on ``batch['tokens']`` at
    ``positions``, the next-token cross-entropy summed and divided by
    ``token_count`` (the global batch's tokens), AdamW.  With ``params``
    (every rank's parameters, a group up) each gradient is summed over the
    world before the update and the returned loss is all-reduced."""
    def train_step(batch):
        with torch.profiler.record_function('train_step'):
            logits = model(batch['tokens'].long(), positions=positions)
            per_tok = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                      batch['labels'].long().reshape(-1), reduction='none')
            loss = per_tok.sum() / token_count
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if params is not None:
                _all_reduce_grads(params)
            opt.step()
            loss = loss.detach()
            if params is not None:
                loss = loss.clone()      # the all-reduce writes in place
                dist.all_reduce(loss)
            return loss
    return train_step


def _mesh_for(strategy, world):
    """jax_example.py:58-61: ``{'data': world // sp, 'seq': sp}`` with ``sp``
    2 for ring and Ulysses on an even world, else 1."""
    seq_shards = 2 if strategy in ('ring', 'ulysses') and world % 2 == 0 else 1
    return mesh_lib.make_mesh({'data': world // seq_shards, 'seq': seq_shards})


def train_lm(dataset_url, steps, batch_size=8, strategy='flash', device=None, cuda_graph=None, *,
             block_k=None, reader_pool_type='thread', workers_count=None, transfer='auto'):
    """Run ``steps`` steps of the long-context example; returns the losses,
    the timings and the trained ``model``.

    tokens/s and step time are taken over the steps after the first two
    (warm-up and, graphed, the capture), on the host clock with the device
    synchronized at both ends; ``host_ms`` is the host's time per step
    inside the step call; the data wait per step and ``stall_pct`` are the
    ``StallMonitor``'s (warm-up 2).  The model is :data:`LONG_CONTEXT_LM`.
    ``cuda_graph``, ``reader_pool_type``, ``workers_count`` (default 4
    threads, the example's) and ``transfer`` (the loader's transfer plane)
    as in :func:`petastorm_tpu_torch.train.train`; ``loader_metrics`` holds
    the loader's counters.

    The loader moves ``tokens`` and their labels, rolled over the whole row
    on the host; the model gets the tokens' global positions; the loss is
    the sum over this rank's tokens divided by the global batch's token
    count.  With a ``torch.distributed`` group up
    (:func:`parallel.init_distributed
    <petastorm_tpu_torch.parallel.init_distributed>`, or torchrun) this is
    the example's sharded loop over every rank: ``strategy`` ``'auto'`` is
    ring on more than one rank and flash on one; the mesh is ``{'data':
    world // sp, 'seq': sp}`` with ``sp`` 2 for ring and Ulysses on an even
    world, else 1; ``batch_size`` is the global batch, rounded up to a
    multiple of the data axis.  Each rank reads the row groups of its data
    coordinate (``cur_shard``/``shard_count``), so the ranks of one seq group
    read the same rows in the same order (one decode thread by default when
    ``sp`` > 1: more would deliver row groups in the order they finish); the
    loader moves this rank's columns of the batch; every gradient is summed
    over the world in one all-reduce before AdamW, and the reported loss is
    all-reduced.  ``block_k`` chunks the ring's score tiles.  Without a group
    only flash and dense run, on one device.
    """
    if steps < 1:
        raise ValueError('steps must be at least 1, got %r' % (steps,))
    device = resolve_device(device)
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    if strategy == 'auto':
        strategy = 'ring' if world > 1 else 'flash'
    if block_k is not None and strategy != 'ring':
        raise ValueError('block_k only applies to the ring strategy (resolved strategy: %s)'
                         % strategy)
    if strategy in ('ring', 'ulysses') and not grouped:
        raise ValueError('strategy %r shards the sequence over ranks: start the process group '
                         'first (parallel.init_distributed, or torchrun)' % (strategy,))
    mesh = _mesh_for(strategy, world) if grouped else None
    data_size, data_index = 1, 0
    seq_split, seq_index = 1, 0
    if grouped:
        data_size, data_index = mesh_lib.axis_size(mesh, 'data'), mesh_lib.axis_index(mesh, 'data')
        seq_split, seq_index = mesh_lib.axis_size(mesh, 'seq'), mesh_lib.axis_index(mesh, 'seq')
    if workers_count is None:
        workers_count = 1 if seq_split > 1 else 4
    elif seq_split > 1 and workers_count > 1 and reader_pool_type != 'dummy':
        raise ValueError('the %d ranks of a seq group must read the same rows in the same '
                         'order: read with one decode worker or the dummy pool' % seq_split)
    model = _model(LONG_CONTEXT_LM, attn_fn=make_attn_fn(mesh, strategy, head_axis=None,
                                                          block_k=block_k), remat=True)
    model = model.to(device).train()
    opt = _adamw(model, 3e-4, device)   # jax_example.py: optax.adamw(3e-4)
    params = list(model.parameters())
    batch_devices = set()
    batch_size = -(-batch_size // data_size) * data_size
    s_local = SEQ_LEN // seq_split
    positions = (seq_index * s_local
                 + torch.arange(s_local, device=device)).expand(batch_size // data_size, s_local)
    token_count = batch_size * SEQ_LEN
    loader_kwargs = dict(batch_size=batch_size // data_size, transform_fn=_with_labels)
    reader_kwargs = {}
    if grouped:
        _check_replicated(model, mesh_lib.group_device())
        reader_kwargs = dict(cur_shard=data_index, shard_count=data_size)
        loader_kwargs['sharding'] = mesh_lib.NamedSharding(mesh, ('data', 'seq'))

    train_step = _train_step(model, opt, positions, token_count, params if grouped else None)
    graphed = graphs.resolve(cuda_graph, device)
    step_fn = graphs.StepGraph(train_step) if graphed else train_step
    warmup = min(2, steps - 1)
    losses, t_start, host_s = [], None, 0.0
    monitor = StallMonitor(warmup_steps=2)
    reader = make_reader(dataset_url, num_epochs=None, columnar_decode=True,
                         reader_pool_type=reader_pool_type, workers_count=workers_count,
                         **reader_kwargs)
    with DataLoader(reader, prefetch=2, drop_last=True, device=device, transfer=transfer,
                    **loader_kwargs) as loader:
        batches = monitor.wrap(loader)
        for step in range(steps):
            if step == warmup:
                _sync(device)
                t_start = time.perf_counter()
            batch = next(batches)
            if grouped:
                batch = {name: value.to_local() for name, value in batch.items()}
            _check_batch(batch['tokens'], device, batch_devices)
            t0 = time.perf_counter()
            losses.append(step_fn(batch))
            if step >= warmup:
                host_s += time.perf_counter() - t0
    _sync(device)
    elapsed = time.perf_counter() - t_start
    timed = steps - warmup
    return {'steps': steps, 'strategy': strategy,
            'mesh': dict(zip(mesh.mesh_dim_names, mesh.shape)) if grouped else None,
            'batch_size': batch_size,
            'losses': [float(v) for v in torch.stack(losses).cpu()],
            'tokens_per_s': timed * token_count / elapsed,
            'step_ms': 1e3 * elapsed / timed,
            'host_ms': 1e3 * host_s / timed,
            'data_wait_ms': 1e3 * monitor.wait_time / monitor.steps if monitor.steps else None,
            'stall_pct': monitor.report()['stall_pct'],
            'reader_diagnostics': reader.diagnostics,
            'loader_metrics': loader.metrics.as_dict(),
            'batch_devices': sorted(batch_devices), 'device': str(device), 'model': model,
            'cuda_graph': graphed}


def _packed_attn(attn, segment_ids):
    if attn == 'dense':
        return functools.partial(packing.packed_attention, segment_ids=segment_ids)
    if attn == 'flash':
        return make_attn_fn(None, 'flash', segment_ids=segment_ids)
    raise ValueError("attn must be 'dense' or 'flash', got %r" % (attn,))


def packed_loss(model, batch, attn='dense'):
    """The packed example's loss on one batch: per-document positions,
    attention inside each document, cross entropy weighted by
    ``next_token_targets`` and divided by the weights' sum (at least 1)."""
    tokens = batch['tokens'].long()
    segment_ids = batch['segment_ids']
    targets, weights = packing.next_token_targets(tokens, segment_ids)
    logits = model(tokens, positions=batch['positions'].long(),
                   attn_fn=_packed_attn(attn, segment_ids))
    per_tok = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                              reduction='none').reshape(targets.shape)
    return (per_tok * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def train_packed(dataset_url, steps=20, rows_per_batch=4, attn='dense', device=None,
                 cuda_graph=None, transfer='auto'):
    """Run ``steps`` steps of the packed example (model :data:`PACKED_LM`);
    returns the losses, the packing utilisation and real tokens/s as the
    example computes them (non-padding tokens over the tokens of every
    batch packed, and real tokens over the wall time from opening the
    reader to the last loss), the step time and real tokens/s over the
    steps after the first two (warm-up), timed as :func:`train_lm` times
    them, and the trained ``model`` (whose own ``attn_fn`` stays the flash
    kernels, as ``sample`` uses it).  ``cuda_graph`` and ``transfer`` as in
    :func:`petastorm_tpu_torch.train.train` (with the plane on, the packing
    runs on the loader's transfer thread); ``loader_metrics`` holds the
    loader's counters."""
    if steps < 1:
        raise ValueError('steps must be at least 1, got %r' % (steps,))
    device = resolve_device(device)
    model = _model(PACKED_LM).to(device).train()
    opt = _adamw(model, 3e-3, device)   # packed_example.py::train's lr
    stats = {'seen': 0, 'real': 0}
    real_per_batch = []             # per batch, in the order the loader yields them
    batch_devices = set()

    def count_tokens(batch):
        # runs on the host batch before transfer: no device readback
        real = int((batch['segment_ids'] > 0).sum())
        stats['seen'] += batch['segment_ids'].size
        stats['real'] += real
        real_per_batch.append(real)
        return batch

    def train_step(batch):
        with torch.profiler.record_function('train_step'):
            loss = packed_loss(model, batch, attn)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return loss.detach()

    graphed = graphs.resolve(cuda_graph, device)
    step_fn = graphs.StepGraph(train_step) if graphed else train_step
    warmup = min(2, steps - 1)
    losses, t_start, timed_real, host_s = [], None, 0, 0.0
    t0 = time.monotonic()
    with make_reader(dataset_url, schema_fields=['tokens'], num_epochs=None,
                     workers_count=4) as reader:
        loader = PackedDataLoader(reader, 'tokens', max_len=model.max_seq_len,
                                  rows_per_batch=rows_per_batch, prefetch=2,
                                  transform_fn=count_tokens, device=device, transfer=transfer)
        for step, batch in enumerate(loader):
            if step == warmup:
                _sync(device)
                t_start = time.perf_counter()
            _check_batch(batch['tokens'], device, batch_devices)
            t_step = time.perf_counter()
            losses.append(step_fn(batch))
            if step >= warmup:
                host_s += time.perf_counter() - t_step
                timed_real += real_per_batch[step]
            if len(losses) >= steps:
                break
    _sync(device)
    elapsed = time.perf_counter() - t_start
    losses = [float(v) for v in torch.stack(losses).cpu()]
    return {'steps': len(losses), 'losses': losses,
            'packing_utilization': stats['real'] / stats['seen'],
            'tokens_per_s': stats['real'] / (time.monotonic() - t0),
            'step_ms': 1e3 * elapsed / (len(losses) - warmup),
            'host_ms': 1e3 * host_s / (len(losses) - warmup),
            'step_tokens_per_s': timed_real / elapsed,
            'loader_metrics': loader.metrics.as_dict(),
            'batch_devices': sorted(batch_devices), 'device': str(device), 'model': model,
            'cuda_graph': graphed}


def sample(model, prompt_len=8, max_new=16, seed=0, cuda_graph=None):
    """``packed_example.py::sample``: continue two zipf prompts of
    ``prompt_len`` tokens with the KV-cache decoder (temperature 0.8, top-p
    0.95, key ``PRNGKey(seed)``); returns ``(prompt, tokens)``, numpy int32
    and an int32 tensor on the model's device.  ``cuda_graph`` as in
    :func:`petastorm_tpu_torch.models.decoding.generate`."""
    rng = np.random.default_rng(seed)
    prompt = (rng.zipf(1.4, (2, prompt_len)) % model.vocab_size).astype(np.int32)
    tokens = generate(model, torch.from_numpy(prompt), max_new, temperature=0.8, top_p=0.95,
                      rng=prng.PRNGKey(seed), cuda_graph=cuda_graph)
    return prompt, tokens


def main(argv=None):
    """The examples' command line (card only)."""
    parser = argparse.ArgumentParser(
        description='Train a TransformerLM on the card from token Parquet.')
    parser.add_argument('--dataset-url', required=True, help='e.g. file:///tmp/lc_tokens')
    parser.add_argument('--generate', action='store_true',
                        help="first write the example's synthetic dataset to --dataset-url")
    parser.add_argument('--packed', action='store_true',
                        help='the packed example: variable-length documents packed into '
                             '(rows, 512) batches')
    parser.add_argument('--strategy', choices=['auto', 'flash', 'ring', 'ulysses', 'dense'],
                        default=None,
                        help='attention; long-context: default auto (ring on more than one '
                             'rank, else flash); packed: flash or dense (the default)')
    parser.add_argument('--block-k', type=int, default=None,
                        help='chunk ring-attention score tiles (memory cap for very long '
                             'local sequences)')
    parser.add_argument('--batch-size', type=int, default=None,
                        help='documents per batch (default 8), or packed rows (default 4)')
    parser.add_argument('--steps', type=int, default=None,
                        help='default 30 (long-context) or 20 (packed)')
    parser.add_argument('--sample', action='store_true',
                        help='after training, sample continuations with the KV-cache decoder')
    args = parser.parse_args(argv)
    if args.packed and args.strategy not in (None, 'flash', 'dense'):
        parser.error('--packed takes --strategy flash or dense')
    strategy = args.strategy or ('dense' if args.packed else 'auto')
    if args.block_k is not None and strategy not in ('auto', 'ring'):
        parser.error('--block-k only applies to the ring strategy')
    rank, started = 0, False
    if not dist.is_initialized() and ('RANK' in os.environ or strategy in ('ring', 'ulysses')):
        # torchrun's ranks, or a group of one for ring or Ulysses on one card
        rank, _ = mesh_lib.init_distributed()
        started = True
    if args.packed:
        if args.generate:
            write_var_token_dataset(args.dataset_url)
        result = train_packed(args.dataset_url, steps=args.steps or 20,
                              rows_per_batch=args.batch_size or 4,
                              attn=strategy)
        print('steps=%d loss=%.3f packing_utilization=%.0f%% tokens/s=%.0f (%s); after '
              'warm-up: step_ms=%.2f tokens/s=%.0f'
              % (result['steps'], result['losses'][-1], 100 * result['packing_utilization'],
                 result['tokens_per_s'], result['device'], result['step_ms'],
                 result['step_tokens_per_s']))
    else:
        if args.generate and rank == 0:
            write_token_dataset(args.dataset_url)
        if args.generate:
            mesh_lib.sync_hosts('token dataset written')
        result = train_lm(args.dataset_url, args.steps or 30, args.batch_size or 8,
                          strategy=strategy, block_k=args.block_k)
        if rank == 0:
            print('done: %d steps of seq_len=%d with %s attention over %s on %s: loss %.4f, '
                  'tokens/s %.0f' % (result['steps'], SEQ_LEN, result['strategy'],
                                     result['mesh'] or 'one device', result['device'],
                                     result['losses'][-1], result['tokens_per_s']))
    if args.sample:
        prompt, tokens = sample(result['model'])
        for row in range(len(prompt)):
            print('prompt %s -> %s' % (prompt[row].tolist(), tokens[row].tolist()))
    if started:
        dist.destroy_process_group()
    return result


if __name__ == '__main__':
    main()
