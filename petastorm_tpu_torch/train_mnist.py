"""MNIST Parquet -> the MLP on the card, with exact mid-epoch checkpoints.

Counterpart of ``examples/mnist/jax_example.py::train`` (BASELINE.json
config #1): a row reader (``make_reader(url, num_epochs=1,
workers_count=4)``, PNG-decoded 28x28 images) into a
:class:`~petastorm_tpu_torch.gpu.DataLoader` at batch 128 with the row
readers' shuffling buffer (``shuffling_queue_capacity=2048``, seeded by the
epoch), the :class:`~petastorm_tpu_torch.models.mlp.MLP`, softmax
cross-entropy over the integer labels and ``torch.optim.Adam(lr=1e-3)``,
the counterpart of ``optax.adam`` (the same bias corrections, eps outside
the square root).  On the card the step replays a CUDA graph
(:class:`~petastorm_tpu_torch.gpu.graphs.StepGraph`) after one eager
warm-up step; the CPU, and the card with ``cuda_graph=False``, run it
eagerly.

``checkpoint_dir`` keeps a
:class:`~petastorm_tpu_torch.checkpoint.TrainStateManager` there (every
``save_every`` steps, the latest two kept): the model and the optimizer
state through ``torch.save``, the epoch and the loader's exact mid-epoch
token as the data state.  A rerun with the same directory resumes at the
batch the last save saw, with the example's messages.

``synthetic_mnist_rows`` and :func:`write_mnist_dataset` write the
example's synthetic dataset (``examples/mnist/generate_petastorm_mnist.py``)
with the port's writer.  Run ``python -m petastorm_tpu_torch.train_mnist
--dataset-url URL [--write-rows N] [--epochs 3] [--batch-size 128]
[--checkpoint-dir DIR --save-every 100] [--device cpu]``.
"""

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from petastorm_tpu_torch.benchmark import StallMonitor
from petastorm_tpu_torch.checkpoint import TrainStateManager
from petastorm_tpu_torch.codecs import CompressedImageCodec
from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
from petastorm_tpu_torch.gpu import DataLoader, graphs
from petastorm_tpu_torch.gpu.transfer import resolve_device
from petastorm_tpu_torch.models.mlp import MLP
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

__all__ = ['MnistSchema', 'synthetic_mnist_rows', 'write_mnist_dataset', 'train', 'main']

#: Steps left out of the timings and the stall monitor: the eager warm-up
#: and, graphed, the capture.
_WARMUP_STEPS = 2

MnistSchema = Unischema('MnistSchema', [
    UnischemaField('idx', np.int64, (), None, False),
    UnischemaField('digit', np.int64, (), None, False),
    UnischemaField('image', np.uint8, (28, 28), CompressedImageCodec('png'), False),
])


def synthetic_mnist_rows(num_rows, seed=0):
    """Label-dependent synthetic digits: a bright patch whose position is the
    label; trivially learnable, MNIST-shaped."""
    rng = np.random.default_rng(seed)
    for i in range(num_rows):
        digit = int(rng.integers(0, 10))
        image = rng.integers(0, 50, (28, 28), dtype=np.uint8)
        r, c = divmod(digit, 5)
        image[4 + r * 12: 12 + r * 12, 2 + c * 5: 7 + c * 5] += 180
        yield {'idx': np.int64(i), 'digit': np.int64(digit), 'image': image}


def write_mnist_dataset(url, num_rows=10000, seed=0):
    """The example's synthetic dataset at ``url``: ``num_rows`` rows in row
    groups of 1000."""
    with DatasetWriter(url, MnistSchema, rows_per_rowgroup=1000) as writer:
        for row in synthetic_mnist_rows(num_rows, seed):
            writer.write(row)
    return url


def train(dataset_url, epochs=3, batch_size=128, lr=1e-3, checkpoint_dir=None, save_every=100,
          device=None, *, cuda_graph=None, reader_pool_type='thread', workers_count=4,
          stop_after_step=None, on_batch=None):
    """Train the MLP for ``epochs`` epochs; returns a dict with
    ``final_accuracy`` (the mean accuracy of the last 20 steps, NaN when no
    step ran), the ``losses`` and ``accuracies`` of the steps run, the
    ``model`` and the optimizer (``opt``), ``steps_run``, ``global_step``
    (the next step's number), ``resumed_at`` (the restored step, or None)
    and ``epochs_run``: per epoch its ``loss``, ``acc``, ``rows_per_s``
    (wall, as the example prints it) and, over the steps after the first
    two (the eager warm-up and the capture) with the device synchronized at
    both ends,
    ``timed_rows_per_s``, ``step_ms``, the ``StallMonitor``'s
    ``data_wait_ms`` and ``stall_pct``.

    The reader decodes with ``workers_count`` workers of
    ``reader_pool_type`` (4 threads, as in the example; ``'dummy'`` gives a
    seeded, exactly reproducible order); the initial weights come from
    seed 0.  ``stop_after_step=k`` ends the run once global step ``k`` has
    run and its checkpoint, when due, is written, as a preempted job
    would; ``on_batch(step, batch)`` sees every batch before its step.
    """
    device = resolve_device(device)
    graphed = graphs.resolve(cuda_graph, device)
    # fp32 products in full fp32, as flax computes them (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = MLP(generator=torch.Generator().manual_seed(0)).to(device)
    # optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8 outside the square root.  On
    # the card the step count lives on the device, so that a captured step
    # advances it.
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           capturable=device.type == 'cuda')

    def train_step(images, labels):
        logits = model(images)
        labels = labels.long()
        loss = F.cross_entropy(logits, labels)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss.detach(), acc

    step_fn = graphs.StepGraph(train_step) if graphed else train_step
    result = {'losses': [], 'accuracies': [], 'epochs_run': [], 'resumed_at': None,
              'model': model, 'opt': opt, 'device': str(device), 'cuda_graph': graphed}
    mgr = None
    start_epoch, loader_token, global_step = 0, None, 0
    if checkpoint_dir:
        mgr = TrainStateManager(checkpoint_dir, save_interval_steps=save_every, max_to_keep=2)
        step, model_state, data_state = mgr.restore_latest()
        if step is not None:
            model.load_state_dict(model_state['params'])
            opt.load_state_dict(model_state['opt'])
            start_epoch, loader_token = data_state['epoch'], data_state['loader']
            global_step = step + 1
            result['resumed_at'] = step
            print('resumed at step %d (epoch %d, mid-epoch token: %s)'
                  % (step, start_epoch, loader_token is not None))
    steps_run = 0
    try:
        if start_epoch >= epochs:
            print('checkpoint already covers all %d epochs — nothing to train' % epochs)
            return _finish(result, steps_run, global_step)
        for epoch in range(start_epoch, epochs):
            resume = loader_token if epoch == start_epoch else None
            loader_token = None   # consumed: later epochs start fresh
            losses, accs = [], []
            monitor = StallMonitor(warmup_steps=_WARMUP_STEPS)
            t_wall = time.monotonic()
            t_start = None
            reader = make_reader(dataset_url, num_epochs=1, reader_pool_type=reader_pool_type,
                                 workers_count=workers_count,
                                 resume_state=(resume or {}).get('reader'))
            with DataLoader(reader, batch_size=batch_size, shuffling_queue_capacity=2048,
                            seed=epoch, resume_state=resume, device=device) as loader:
                batches = monitor.wrap(loader)
                for batch in batches:
                    if len(losses) == _WARMUP_STEPS:
                        _sync(device)
                        t_start = time.perf_counter()
                    if on_batch is not None:
                        on_batch(global_step, batch)
                    loss, acc = step_fn(batch['image'], batch['digit'])
                    losses.append(loss)
                    accs.append(acc)
                    if mgr is not None and mgr.should_save(global_step):
                        mgr.save(global_step, {'params': model.state_dict(),
                                               'opt': opt.state_dict()},
                                 data_state={'epoch': epoch, 'loader': loader.state_dict()})
                    global_step += 1
                    steps_run += 1
                    if stop_after_step is not None and global_step > stop_after_step:
                        break
                batches.close()
            _sync(device)
            _epoch_summary(result, epoch, losses, accs, batch_size, time.monotonic() - t_wall,
                           t_start, monitor)
            if stop_after_step is not None and global_step > stop_after_step:
                return _finish(result, steps_run, global_step)
        if mgr is not None:
            mgr.save(global_step, {'params': model.state_dict(), 'opt': opt.state_dict()},
                     data_state={'epoch': epochs, 'loader': None}, force=True)
        return _finish(result, steps_run, global_step)
    finally:
        if mgr is not None:
            mgr.close()


def _epoch_summary(result, epoch, losses, accs, batch_size, wall_s, t_start, monitor):
    if not losses:
        # a token taken at the stream's end yields no batches
        print('epoch %d: already complete at resume' % epoch)
        result['epochs_run'].append({'epoch': epoch, 'steps': 0})
        return
    losses = [float(v) for v in torch.stack(losses).cpu()]
    accs = [float(v) for v in torch.stack(accs).cpu()]
    result['losses'].extend(losses)
    result['accuracies'].extend(accs)
    row = {'epoch': epoch, 'steps': len(losses), 'loss': float(np.mean(losses)),
           'acc': float(np.mean(accs[-20:])), 'rows_per_s': len(losses) * batch_size / wall_s,
           'timed_rows_per_s': None, 'step_ms': None, 'data_wait_ms': None, 'stall_pct': None}
    timed = len(losses) - _WARMUP_STEPS
    if t_start is not None and timed > 0:
        elapsed = time.perf_counter() - t_start
        report = monitor.report()
        row.update(timed_rows_per_s=timed * batch_size / elapsed, step_ms=1e3 * elapsed / timed,
                   data_wait_ms=(1e3 * monitor.wait_time / monitor.steps
                                 if monitor.steps else None),
                   stall_pct=report['stall_pct'])
    result['epochs_run'].append(row)
    print('epoch %d: loss=%.4f acc=%.3f (%.0f rows/s)'
          % (epoch, row['loss'], row['acc'], row['rows_per_s']))


def _finish(result, steps_run, global_step):
    accs = result['accuracies']
    result.update(steps_run=steps_run, global_step=global_step,
                  final_accuracy=float(np.mean(accs[-20:])) if accs else float('nan'))
    return result


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def main(argv=None):
    """The example's command line, plus ``--device`` and ``--write-rows``."""
    parser = argparse.ArgumentParser(
        description='Train the MNIST MLP on the card from a PNG Parquet dataset.')
    parser.add_argument('--dataset-url', default='file:///tmp/mnist_petastorm')
    parser.add_argument('--write-rows', type=int, default=0,
                        help='first write this many synthetic MNIST rows to --dataset-url '
                             '(0: read an existing dataset)')
    parser.add_argument('--epochs', type=int, default=3)
    parser.add_argument('--batch-size', type=int, default=128)
    parser.add_argument('--checkpoint-dir', default=None,
                        help="checkpoint the model, the optimizer and the loader's exact "
                             'mid-epoch token every --save-every steps; rerun with the same '
                             'directory to resume at the batch the last save saw')
    parser.add_argument('--save-every', type=int, default=100)
    parser.add_argument('--device', default=None, help='cuda (the default) or cpu')
    args = parser.parse_args(argv)
    if args.write_rows:
        write_mnist_dataset(args.dataset_url, args.write_rows)
    result = train(args.dataset_url, args.epochs, args.batch_size,
                   checkpoint_dir=args.checkpoint_dir, save_every=args.save_every,
                   device=args.device)
    print('final accuracy: %.3f' % result['final_accuracy'])
    return result


if __name__ == '__main__':
    main()
