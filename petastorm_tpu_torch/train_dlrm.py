"""Criteo-shaped Parquet -> DLRM on the card through the batch reader.

Counterpart of ``examples/criteo/jax_example.py::train`` (BASELINE.json
config #4): ``make_batch_reader(url, num_epochs=1, workers_count=4)`` over
plain Parquet (no petastorm metadata), a
:class:`~petastorm_tpu_torch.gpu.DataLoader` at batch 2048 whose
``transform_fn=pack_columns`` assembles the dense, categorical and label
arrays on the host, the :class:`~petastorm_tpu_torch.models.dlrm.DLRM`,
the mean of ``binary_cross_entropy_with_logits`` (optax's
``sigmoid_binary_cross_entropy``, to fp32 rounding) and
:class:`~petastorm_tpu_torch.optim.Adagrad` (optax's ``adagrad(1e-3)``).
On the card the step replays a CUDA graph
(:class:`~petastorm_tpu_torch.gpu.graphs.StepGraph`) after one eager
warm-up step; the CPU, and the card with ``cuda_graph=False``, run it
eagerly.  ``scan_steps=k`` consumes ``k`` batches per chunk through
:meth:`~petastorm_tpu_torch.gpu.DataLoader.scan_batches`, as the example's
``--scan-steps`` does with ``lax.scan``.

:func:`generate_criteo_parquet` writes the example's synthetic store
(``examples/criteo/generate_criteo_parquet.py``): 13 lognormal float32
dense columns, 26 int32 id columns with ``VOCAB_SIZES``, an int32 label, in
row groups of 4096.  Run ``python -m petastorm_tpu_torch.train_dlrm
--dataset-url URL [--write-rows N] [--epochs 2] [--batch-size 2048]
[--scan-steps K] [--device cpu]``.
"""

import argparse
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch
import torch.nn.functional as F

from petastorm_tpu_torch.benchmark import StallMonitor
from petastorm_tpu_torch.fs_utils import get_filesystem_and_path
from petastorm_tpu_torch.gpu import DataLoader, graphs
from petastorm_tpu_torch.gpu.transfer import resolve_device
from petastorm_tpu_torch.models.dlrm import DLRM
from petastorm_tpu_torch.optim import Adagrad
from petastorm_tpu_torch.reader import make_batch_reader

__all__ = ['NUM_DENSE', 'NUM_CATEGORICAL', 'VOCAB_SIZES', 'generate_criteo_parquet',
           'pack_columns', 'train', 'main']

NUM_DENSE = 13
NUM_CATEGORICAL = 26
#: Steps left out of the timings and the stall monitor: the eager warm-up
#: and, graphed, the capture.
_WARMUP_STEPS = 2
VOCAB_SIZES = [1000 + 37 * i for i in range(NUM_CATEGORICAL)]


def generate_criteo_parquet(output_url, rows_count=20000, rows_per_group=4096, seed=0):
    """The example's synthetic Criteo-shaped store at ``output_url``
    (``data.parquet``), the same values for the same seed."""
    rng = np.random.default_rng(seed)
    fs, path = get_filesystem_and_path(output_url)
    fs.makedirs(path, exist_ok=True)
    columns = {'label': pa.array(rng.integers(0, 2, rows_count).astype(np.int32))}
    for i in range(NUM_DENSE):
        columns['dense_%d' % i] = pa.array(rng.lognormal(0, 1, rows_count).astype(np.float32))
    for i in range(NUM_CATEGORICAL):
        columns['cat_%d' % i] = pa.array(
            rng.integers(0, VOCAB_SIZES[i], rows_count).astype(np.int32))
    with fs.open(path + '/data.parquet', 'wb') as f:
        pq.write_table(pa.table(columns), f, row_group_size=rows_per_group)
    return output_url


def pack_columns(batch):
    """The example's host transform: (B, 13) ``log1p`` dense float32, (B, 26)
    ids, float32 labels."""
    dense = np.stack([batch['dense_%d' % i] for i in range(NUM_DENSE)], axis=1)
    cats = np.stack([batch['cat_%d' % i] for i in range(NUM_CATEGORICAL)], axis=1)
    return {'dense': np.log1p(dense).astype(np.float32), 'cats': cats,
            'label': batch['label'].astype(np.float32)}


def train(dataset_url, epochs=1, batch_size=2048, lr=1e-3, scan_steps=0, device=None, *,
          cuda_graph=None, reader_kwargs=None, transfer='auto', max_steps=None, params=None):
    """Train DLRM for ``epochs`` epochs; returns a dict with the ``losses``
    of every step, the ``model``, ``device``, ``cuda_graph`` and per epoch
    (``epochs_run``) its ``loss`` (the mean of the last 10, as printed),
    ``steps``, wall ``rows_per_s`` and, over the steps after the first two
    (the eager warm-up and the capture) with the device
    synchronized at both ends, ``timed_rows_per_s``, ``step_ms``,
    ``host_ms`` (the host's time per step inside the step call; with
    ``scan_steps``, per step of a chunk's call, its transfer included),
    and, streaming, the ``StallMonitor``'s ``data_wait_ms`` and
    ``stall_pct``.

    ``reader_kwargs`` update the example's reader arguments
    (``num_epochs=1, workers_count=4``; a test passes the dummy pool with
    no shuffle).  ``params`` is a state_dict to start from (a flax DLRM's
    through ``convert.dlrm_params_from_flax``), else the weights come from
    seed 0.  ``max_steps`` ends the run after that many steps (a profile's
    short run).  ``cuda_graph``: see
    :func:`petastorm_tpu_torch.gpu.graphs.resolve`.
    """
    device = resolve_device(device)
    graphed = graphs.resolve(cuda_graph, device)
    # fp32 products in full fp32, as flax computes them (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = DLRM(VOCAB_SIZES, generator=torch.Generator().manual_seed(0))
    if params is not None:
        model.load_state_dict(params)
    model = model.to(device)
    opt = Adagrad(model.parameters(), lr=lr)

    def train_step(dense, cats, label):
        with torch.profiler.record_function('train_step'):
            loss = F.binary_cross_entropy_with_logits(model(dense, cats), label)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return loss.detach()

    def scan_step(carry, batch):
        return carry, train_step(batch['dense'], batch['cats'], batch['label'])

    step_fn = graphs.StepGraph(train_step) if graphed else train_step
    result = {'losses': [], 'epochs_run': [], 'model': model, 'device': str(device),
              'cuda_graph': graphed}
    kwargs = dict(num_epochs=1, workers_count=4)
    kwargs.update(reader_kwargs or {})
    steps = 0
    for epoch in range(epochs):
        t_wall = time.monotonic()
        # the loader stops the reader when its epoch ends
        loader = DataLoader(make_batch_reader(dataset_url, **kwargs), batch_size=batch_size,
                            transform_fn=pack_columns, device=device, transfer=transfer)
        if scan_steps >= 1:
            row = _scan_epoch(loader, scan_step, scan_steps, graphed, device, max_steps)
        else:
            row = _stream_epoch(loader, step_fn, device, max_steps)
        steps += row['steps']
        losses = row.pop('losses')
        result['losses'].extend(losses)
        row.update(epoch=epoch, loss=float(np.mean(losses[-10:])) if losses else float('nan'),
                   rows_per_s=row['steps'] * batch_size / (time.monotonic() - t_wall))
        for key in ('timed_rows_per_s', 'step_ms', 'host_ms', 'data_wait_ms'):
            row.setdefault(key, None)
        if row.get('timed_steps'):
            row['timed_rows_per_s'] = row['timed_steps'] * batch_size / row['elapsed_s']
            row['step_ms'] = 1e3 * row['elapsed_s'] / row['timed_steps']
            row['host_ms'] = 1e3 * row['host_s'] / row['timed_steps']
        result['epochs_run'].append(row)
        print('epoch %d: loss=%.4f (%.1fs) stall=%s'
              % (epoch, row['loss'], time.monotonic() - t_wall, row['stall']))
        if max_steps is not None and steps >= max_steps:
            break
    return result


def _stream_epoch(loader, step_fn, device, max_steps):
    """One epoch batch by batch under the stall monitor."""
    losses = []
    monitor = StallMonitor(warmup_steps=_WARMUP_STEPS)
    t_start = None
    host_s = 0.0
    with loader:
        batches = monitor.wrap(loader)
        for batch in batches:
            if len(losses) == _WARMUP_STEPS:
                _sync(device)
                t_start = time.perf_counter()
            t0 = time.perf_counter()
            losses.append(step_fn(batch['dense'], batch['cats'], batch['label']))
            if t_start is not None:
                host_s += time.perf_counter() - t0
            if max_steps is not None and len(losses) >= max_steps:
                break
        batches.close()
    _sync(device)
    report = monitor.report()
    row = {'steps': len(losses), 'losses': [float(v) for v in torch.stack(losses).cpu()]
           if losses else [], 'stall': report, 'stall_pct': report['stall_pct'],
           'data_wait_ms': 1e3 * monitor.wait_time / monitor.steps if monitor.steps else None}
    if t_start is not None and len(losses) > _WARMUP_STEPS:
        row.update(timed_steps=len(losses) - _WARMUP_STEPS, host_s=host_s,
                   elapsed_s=time.perf_counter() - t_start)
    return row


def _scan_epoch(loader, scan_step, scan_steps, graphed, device, max_steps):
    """One epoch ``scan_steps`` batches per chunk through ``scan_batches``;
    timed over the chunks after the first two (the warm-up and the
    capture)."""
    outs_all = []
    t_start = None
    host_s = 0.0
    timed = done = 0
    with loader:
        chunks = loader.scan_batches(scan_step, None, steps_per_call=scan_steps,
                                     cuda_graph=graphed)
        while True:
            t0 = time.perf_counter()
            try:
                _, outs = next(chunks)
            except StopIteration:
                break
            if t_start is not None:
                host_s += time.perf_counter() - t0
                timed += int(outs.shape[0])
            outs_all.append(outs)
            done += int(outs.shape[0])
            if len(outs_all) == 2:
                _sync(device)
                t_start = time.perf_counter()
            if max_steps is not None and done >= max_steps:
                break
        chunks.close()
    _sync(device)
    row = {'steps': done, 'losses': [float(v) for v in torch.cat(outs_all).cpu()]
           if outs_all else [], 'stall': '(fused scan: per-step stall n/a)', 'stall_pct': None}
    if timed:
        row.update(timed_steps=timed, host_s=host_s, elapsed_s=time.perf_counter() - t_start)
    return row


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def main(argv=None):
    """The example's command line, plus ``--device`` and ``--write-rows``."""
    parser = argparse.ArgumentParser(
        description='Train DLRM on the card from Criteo-shaped plain Parquet.')
    parser.add_argument('--dataset-url', default='file:///tmp/criteo_parquet')
    parser.add_argument('--write-rows', type=int, default=0,
                        help='first write this many synthetic Criteo-shaped rows to '
                             '--dataset-url (0: read an existing store)')
    parser.add_argument('--epochs', type=int, default=2)
    parser.add_argument('--batch-size', type=int, default=2048)
    parser.add_argument('--scan-steps', type=int, default=0,
                        help='consume via scan_batches: K steps per stacked transfer and one '
                             'graph replay (when dispatch, not compute, is the stall)')
    parser.add_argument('--device', default=None, help='cuda (the default) or cpu')
    args = parser.parse_args(argv)
    if args.write_rows:
        generate_criteo_parquet(args.dataset_url, args.write_rows)
    return train(args.dataset_url, args.epochs, args.batch_size, scan_steps=args.scan_steps,
                 device=args.device)


if __name__ == '__main__':
    main()
