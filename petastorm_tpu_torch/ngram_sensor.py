"""The NGram sensor example (BASELINE.json config #5) on the card.

Counterpart of ``examples/ngram_sensor/jax_example.py``: :func:`generate`
writes the example's timestamped sensor log (``SensorSchema``: an int64
``timestamp``, a float32 ``lidar`` (32,) and a float32 ``velocity`` (3,)
under ``NdarrayCodec``; 100-row row groups; a 100-tick dropout every 50
rows), :func:`make_ngram` is the example's window (``lidar`` at offsets
-2, -1 and 0, ``velocity`` at 0, ``delta_threshold=10``), and :func:`run`
reads the windows with ``make_reader(schema_fields=ngram,
shuffle_row_groups=False)``, batches them with
:class:`~petastorm_tpu_torch.gpu.DataLoader` (``batch_size=32``,
``transform_fn=collate``) and runs :func:`predict_speed` on each batch: on
the card as a CUDA graph of the step
(:class:`~petastorm_tpu_torch.gpu.graphs.StepGraph`, the port's
``jax.jit``), eagerly on the CPU or with ``cuda_graph=False``.
:func:`main` writes the store and runs the path, printing what the
reference prints.  Run ``python -m petastorm_tpu_torch.ngram_sensor
--dataset-url URL [--device cpu]``.
"""

import argparse
import time

import numpy as np
import torch

from petastorm_tpu_torch.benchmark.stall_profiler import StallMonitor
from petastorm_tpu_torch.codecs import NdarrayCodec
from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
from petastorm_tpu_torch.gpu import DataLoader, graphs
from petastorm_tpu_torch.gpu.transfer import resolve_device
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

__all__ = ['SensorSchema', 'generate', 'make_ngram', 'collate', 'predict_speed', 'run', 'main']

SensorSchema = Unischema('SensorSchema', [
    UnischemaField('timestamp', np.int64, (), None, False),
    UnischemaField('lidar', np.float32, (32,), NdarrayCodec(), False),
    UnischemaField('velocity', np.float32, (3,), NdarrayCodec(), False),
])

#: Steps left out of the timings and the stall monitor: the eager warm-up
#: and, graphed, the capture.
_WARMUP_STEPS = 2


def generate(url, rows=600, seed=0):
    """The example's sensor log at ``url``: ``rows`` rows, the same values
    for the same seed."""
    rng = np.random.default_rng(seed)
    t = 0

    def row_gen():
        nonlocal t
        for i in range(rows):
            t += int(rng.integers(1, 3)) if i % 50 else 100  # dropouts every 50
            yield {'timestamp': np.int64(t),
                   'lidar': rng.standard_normal(32).astype(np.float32),
                   'velocity': rng.standard_normal(3).astype(np.float32)}
    with DatasetWriter(url, SensorSchema, rows_per_rowgroup=100) as w:
        w.write_many(row_gen())
    return url


def make_ngram():
    """The example's window: two ``lidar`` frames of history and the
    current frame with its ``velocity``, gaps of at most 10 ticks."""
    return NGram(fields={-2: ['lidar'], -1: ['lidar'], 0: ['lidar', 'velocity']},
                 delta_threshold=10, timestamp_field='timestamp')


def collate(batch):
    """A batch of windows -> ``history`` (B, 2, 32) and ``velocity`` (B, 3)."""
    history = np.stack([batch[-2]['lidar'], batch[-1]['lidar']], axis=1)
    return {'history': history, 'velocity': batch[0]['velocity']}


def predict_speed(history, velocity):
    return history.mean(dim=(1, 2)) + torch.linalg.vector_norm(velocity, dim=1)


def _step(history, velocity):
    with torch.profiler.record_function('train_step'):
        return predict_speed(history, velocity)


def run(url, batch_size=32, device=None, cuda_graph=None, reader_kwargs=None,
        loader_kwargs=None, max_steps=None, verbose=True):
    """Read the windows of the store at ``url`` through the loader and run
    :func:`predict_speed` on each batch.  Returns a dict with the
    ``outputs`` (one tensor per batch, on the device), ``batches``,
    ``windows``, ``cuda_graph`` and, over the steps after the first two
    (the eager warm-up and the capture) with the device synchronized at
    both ends, ``windows_per_s``, ``step_ms``, ``host_ms`` (the host's time
    per step inside the step call), and the ``StallMonitor``'s
    ``data_wait_ms`` and ``stall_pct``.  ``reader_kwargs`` go to
    ``make_reader`` (after ``shuffle_row_groups=False``), ``loader_kwargs``
    to the loader; ``max_steps`` ends the run after that many batches.
    Each step runs inside a ``torch.profiler.record_function`` range named
    ``train_step``."""
    device = resolve_device(device)
    graphed = graphs.resolve(cuda_graph, device)
    step = graphs.StepGraph(_step) if graphed else _step
    reader_kwargs = dict(dict(shuffle_row_groups=False), **(reader_kwargs or {}))
    monitor = StallMonitor(warmup_steps=_WARMUP_STEPS)
    outputs = []
    windows = 0
    t_start = None
    host_s = 0.0
    with make_reader(url, schema_fields=make_ngram(), **reader_kwargs) as reader:
        with DataLoader(reader, batch_size=batch_size, transform_fn=collate, device=device,
                        **(loader_kwargs or {})) as loader:
            batches = monitor.wrap(loader)
            for batch in batches:
                if len(outputs) == _WARMUP_STEPS:
                    _sync(device)
                    t_start = time.perf_counter()
                t0 = time.perf_counter()
                out = step(batch['history'], batch['velocity'])
                if t_start is not None:
                    host_s += time.perf_counter() - t0
                if verbose and not outputs:
                    print('window batch: history', tuple(batch['history'].shape),
                          'velocity', tuple(batch['velocity'].shape), '->', tuple(out.shape))
                outputs.append(out)
                windows += int(out.shape[0])
                if max_steps is not None and len(outputs) >= max_steps:
                    break
            batches.close()
    _sync(device)
    result = {'outputs': outputs, 'batches': len(outputs), 'windows': windows,
              'cuda_graph': graphed, 'device': str(device)}
    timed = len(outputs) - _WARMUP_STEPS
    if t_start is not None and timed > 0:
        elapsed = time.perf_counter() - t_start
        report = monitor.report()
        result.update(windows_per_s=timed * batch_size / elapsed,
                      step_ms=1e3 * elapsed / timed, host_ms=1e3 * host_s / timed,
                      data_wait_ms=1e3 * monitor.wait_time / monitor.steps
                      if monitor.steps else None,
                      stall_pct=report['stall_pct'])
    if verbose:
        print('done')
    return result


def main(url, device=None):
    """The example: write the 600-row store at ``url``, then :func:`run`
    (without a card, and without ``device='cpu'``, it raises before it
    writes)."""
    device = resolve_device(device)
    generate(url)
    return run(url, device=device)


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _cli(argv=None):
    parser = argparse.ArgumentParser(
        description='NGram windows over a sensor log, batched to the card.')
    parser.add_argument('--dataset-url', default='file:///tmp/ngram_sensor')
    parser.add_argument('--device', default=None, help='cuda (the default) or cpu')
    args = parser.parse_args(argv)
    return main(args.dataset_url, device=args.device)


if __name__ == '__main__':
    _cli()
