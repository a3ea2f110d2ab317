"""JPEG Parquet -> ResNet-50 or ViT-S/16 training steps on the card.

Counterpart of ``examples/imagenet/jax_example.py::train`` (BASELINE.json
config #3) for the branches ported: ``model_name='resnet50'`` (the
example's default) or ``'vit'`` (ViT-S/16, whose attention runs the
hand-written flash kernels), streaming or with ``hbm_cache=True``.  JPEG
decode + resize run in the reader's worker pool (the TransformSpec; 8
threads, or with ``reader_pool_type='process'`` processes of their own),
``random_crop(padding=4)``, ``random_flip_left_right`` and ``normalize``
run on the device, and the model takes SGD steps (momentum 0.9) under
softmax cross-entropy; ResNet-50 trains with its BatchNorms in train mode.

Streaming, batches are assembled columnar and moved to the device by
:class:`~petastorm_tpu_torch.gpu.DataLoader` under a
:class:`~petastorm_tpu_torch.benchmark.StallMonitor`; with ``scan_steps=k``
they go ``k`` at a time through
:meth:`~petastorm_tpu_torch.gpu.DataLoader.scan_batches`.  With
``hbm_cache=True`` the dataset is decoded once into device memory by
:class:`~petastorm_tpu_torch.gpu.DeviceInMemDataLoader` and whole epochs
run through :meth:`~petastorm_tpu_torch.gpu.DeviceInMemDataLoader.scan_epochs`.

On the card every mode replays a CUDA graph of the step, the counterpart of
the example's ``jax.jit`` and ``lax.scan`` (:mod:`petastorm_tpu_torch.gpu.graphs`):
one graph launch per step (per chunk of ``k`` steps with ``scan_steps``).
The CPU runs the same step eagerly, and so does the card with
``cuda_graph=False``, the loop the replay is held against.

Streaming, the loader's transfer plane (``transfer='auto'``) moves each
batch to the card from a thread of its own, in one coalesced copy.  With
``decoded_cache_dir`` the loader is a
:class:`~petastorm_tpu_torch.gpu.DiskCachedDataLoader`: epoch 0 decodes and
writes the cache, later epochs (and later runs, with no reader at all once
the cache is complete) stream from it.  With ``trace_path`` the loader,
its transfer plane and the stall monitor record into a
:class:`~petastorm_tpu_torch.benchmark.TraceRecorder` dumped there as a
Chrome trace.  After every streaming run the example's bottleneck report
(:func:`~petastorm_tpu_torch.benchmark.diagnose`) is printed and returned.

Run ``python -m petastorm_tpu_torch.train --dataset-url URL`` with the
example's ``--steps``, ``--batch-size``, ``--model``, ``--hbm-cache``,
``--scan-steps``, ``--decoded-cache-dir`` and ``--trace``.
"""

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from petastorm_tpu_torch.benchmark import StallMonitor, TraceRecorder, diagnose, format_report
from petastorm_tpu_torch.gpu import (DataLoader, DeviceInMemDataLoader, DiskCachedDataLoader,
                                     augment, graphs)
from petastorm_tpu_torch.gpu.transfer import resolve_device
from petastorm_tpu_torch.models.resnet import ResNet50
from petastorm_tpu_torch.models.vit import ViT
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.train_transform import FixRow
from petastorm_tpu_torch.transform import TransformSpec

__all__ = ['make_transform', 'train', 'main', 'VIT_S16']

#: ViT-S/16 as the JAX example builds it (jax_example.py:69-70).
VIT_S16 = dict(num_classes=1000, patch_size=16, d_model=384, num_heads=6, num_layers=12,
               d_ff=1536)


def make_transform(image_hw):
    """Worker-side decode fix-up: resize to ``image_hw`` and turn ``noun_id``
    into an int32 ``label`` (the JAX example's, as the picklable
    :class:`~petastorm_tpu_torch.train_transform.FixRow`)."""
    image_hw = tuple(image_hw)
    return TransformSpec(FixRow(image_hw),
                         edit_fields=[('image', np.uint8, image_hw + (3,), False),
                                      ('label', np.int32, (), False)],
                         removed_fields=['noun_id'])


def _make_model(model_name, image_hw, model_kwargs):
    generator = torch.Generator().manual_seed(0)
    if model_name == 'resnet50':
        return ResNet50(generator=generator, **dict(dict(num_classes=1000), **model_kwargs))
    if model_name == 'vit':
        return ViT(image_hw=image_hw, generator=generator, **dict(VIT_S16, **model_kwargs))
    raise ValueError("model_name must be 'resnet50' or 'vit', got %r" % (model_name,))


def train(dataset_url, steps, batch_size=64, image_hw=(224, 224), lr=0.1, device=None, *,
          model_name='resnet50', hbm_cache=False, scan_steps=0, model_kwargs=None,
          cuda_graph=None, reader_pool_type='thread', workers_count=8, warmup_steps=2,
          decoded_cache_dir=None, trace_path=None, transfer='auto'):
    """Run ``steps`` training steps; returns the losses, the timings and the
    trained ``model``.

    The reader decodes with ``workers_count`` workers of
    ``reader_pool_type`` (8 threads, as in the JAX example; ``'process'``
    decodes outside this interpreter's lock; ``reader_diagnostics`` in the
    result holds the pool's counters, :attr:`Reader.diagnostics`), and the
    initial weights come from seed 0.  ``model_kwargs`` overrides
    constructor arguments of the model (:data:`VIT_S16` for ViT,
    ``num_classes=1000`` for ResNet-50; a CPU run shrinks the model with
    it).  ``cuda_graph`` (see :func:`petastorm_tpu_torch.gpu.graphs.resolve`):
    ``None`` replays a CUDA graph of the step on the card, after one eager
    warm-up step, and runs eagerly on the CPU; ``False`` runs eagerly on the
    card too.  Each step runs inside a ``torch.profiler.record_function``
    range named ``train_step`` (a replayed step: around its replay).

    Streaming: images/s and step time are taken over the steps after the
    first ``warmup_steps`` (at least the eager warm-up and, graphed, the
    capture: keep it at 2 or more), on the host clock with the device
    synchronized at both ends; ``host_ms`` is the host's time per step
    inside the step call; ``stall_pct`` and the mean data wait per step are
    the ``StallMonitor``'s (warm-up ``warmup_steps``; it closes a step at
    the next batch, so it counts ``steps - warmup_steps - 1`` of them; the
    wait is None when it counted none).  A larger ``warmup_steps`` leaves
    the decode workers' start out of these readings.  ``scan_steps=k`` runs
    chunks of ``k`` steps through ``DataLoader.scan_batches`` (whole
    chunks: ``steps`` rounds up), timed
    over the chunks after the first two, with no stall monitor (its
    ``host_ms`` holds the chunk's assembly and transfer).
    ``hbm_cache=True`` runs whole epochs (the last one may take ``steps``
    past the request, as in the JAX example); images/s, step time and host
    time are taken over the epochs after the first, whose time holds the
    one read of the dataset (None when only one epoch ran), and
    ``stall_pct`` is 0: no step waits for the host's data path.

    Streaming and ``scan_steps`` runs take the example's last flags:
    ``transfer`` is the loader's (``'auto'``: the transfer plane and its
    dispatch thread on the card; ``False``: every put on the training
    thread); ``decoded_cache_dir`` reads through a
    :class:`~petastorm_tpu_torch.gpu.DiskCachedDataLoader` (with no reader
    once the cache there is complete); ``trace_path`` dumps a Chrome trace of
    the run there (``trace_events`` in the result; skipped with a message
    under ``hbm_cache``, which has no host spans).  Their results also hold
    the bottleneck ``report`` (printed) and its ``diagnosis``, the loader's
    ``loader_stats`` and ``loader_metrics`` (``h2d_degraded`` among them)
    and, traced, ``stall_top_component``.
    """
    if steps < 1:
        raise ValueError('steps must be at least 1, got %r' % (steps,))
    device = resolve_device(device)
    graphed = graphs.resolve(cuda_graph, device)
    image_hw = tuple(image_hw)
    # fp32 matmuls and convolutions in full fp32, as the flax models compute
    # them: no TF32 for the fp32 head, nor for cuDNN's fp32 convolutions
    # (whose default is TF32).  The bf16 products are unaffected.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _make_model(model_name, image_hw, model_kwargs or {}).to(device).train()
    # optax.sgd(lr, momentum=0.9): trace = g + 0.9 trace; p -= lr * trace.
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9, dampening=0,
                          nesterov=False)
    aug_gen = torch.Generator(device=device).manual_seed(17)
    batch_devices = set()

    def check_batch(batch):
        images = batch['image']
        batch_devices.add(str(images.device.type))
        if images.device.type != device.type:
            raise RuntimeError('batch reached the model on %s, expected %s'
                               % (images.device, device))

    def train_step(batch):
        with torch.profiler.record_function('train_step'):
            x = augment.random_crop(batch['image'], image_hw, padding=4, generator=aug_gen)
            x = augment.random_flip_left_right(x, generator=aug_gen)
            x = augment.normalize(x, dtype=torch.float32)
            loss = F.cross_entropy(model(x), batch['label'].long())
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return loss.detach()

    def scan_step(carry, batch):
        # Python here runs at the eager steps and at capture, not per replay
        check_batch(batch)
        return carry, train_step(batch)

    reader_kwargs = dict(schema_fields=['image', 'noun_id'],
                         transform_spec=make_transform(image_hw), columnar_decode=True,
                         reader_pool_type=reader_pool_type, workers_count=workers_count)
    scan_kwargs = dict(cuda_graph=graphed, generators=[aug_gen])
    if hbm_cache:
        result = _train_hbm_cache(dataset_url, steps, batch_size, device, scan_step,
                                  reader_kwargs, scan_kwargs)
        if trace_path:
            print('trace skipped: --hbm-cache folds whole epochs into on-device scans (no '
                  'host-side spans); no trace file written to %s' % trace_path)
        result.update(trace_events=None)
    else:
        tracer = TraceRecorder() if trace_path else None
        stream = _Stream(dataset_url, batch_size, device, reader_kwargs, decoded_cache_dir,
                         tracer, transfer)
        if scan_steps:
            result = _train_scan(stream, steps, device, scan_step,
                                 dict(scan_kwargs, steps_per_call=scan_steps))
        else:
            step = graphs.StepGraph(train_step, generators=[aug_gen]) if graphed else train_step
            result = _train_streaming(stream, steps, batch_size, device, step, check_batch,
                                      warmup_steps)
        print(result['report'])
        result.update(trace_events=None)
        if tracer is not None:
            result['trace_events'] = tracer.dump(trace_path)
            print('trace: %d spans -> %s (open in chrome://tracing)'
                  % (result['trace_events'], trace_path))
    result.update(batch_devices=sorted(batch_devices), device=str(device), model=model,
                  cuda_graph=graphed)
    return result


class _Stream(object):
    """The streaming runs' reader and loader: a ``DataLoader`` over an
    endless reader, or with ``decoded_cache_dir`` a ``DiskCachedDataLoader``
    (whose reader reads one epoch, and which takes none once the cache is
    complete)."""

    def __init__(self, dataset_url, batch_size, device, reader_kwargs, decoded_cache_dir,
                 tracer, transfer):
        self.tracer = tracer
        cached = decoded_cache_dir and DiskCachedDataLoader.cache_complete(decoded_cache_dir)
        self.reader = None if cached else make_reader(
            dataset_url, num_epochs=1 if decoded_cache_dir else None, **reader_kwargs)
        kwargs = dict(batch_size=batch_size, device=device, trace_recorder=tracer,
                      transfer=transfer)
        if decoded_cache_dir:
            self.loader = DiskCachedDataLoader(self.reader, decoded_cache_dir=decoded_cache_dir,
                                               num_epochs=None, **kwargs)
        else:
            self.loader = DataLoader(self.reader, **kwargs)

    def results(self, monitor=None):
        """What every streaming result holds besides its timings."""
        diagnosis = diagnose(self.loader, monitor)
        return {'reader_diagnostics': self.reader.diagnostics if self.reader else {},
                'report': format_report(diagnosis), 'diagnosis': diagnosis,
                'loader_stats': self.loader.stats,
                'loader_metrics': self.loader.metrics.as_dict()}


def _train_streaming(stream, steps, batch_size, device, step, check_batch, warmup_steps):
    warmup = min(warmup_steps, steps - 1)
    losses = []
    t_start = None
    host_s = 0.0
    monitor = StallMonitor(warmup_steps=warmup_steps, trace_recorder=stream.tracer)
    with stream.loader as loader:
        batches = monitor.wrap(loader)
        for i in range(steps):
            if i == warmup:
                _sync(device)
                t_start = time.perf_counter()
            batch = next(batches)
            check_batch(batch)
            t0 = time.perf_counter()
            losses.append(step(batch))
            if i >= warmup:
                host_s += time.perf_counter() - t0
        batches.close()   # ends the loader's iteration (and its transfer thread) here
    _sync(device)
    elapsed = time.perf_counter() - t_start
    timed = steps - warmup
    report = monitor.report()
    return dict(stream.results(monitor), steps=steps,
                losses=[float(v) for v in torch.stack(losses).cpu()],
                images_per_s=timed * batch_size / elapsed,
                step_ms=1e3 * elapsed / timed,
                host_ms=1e3 * host_s / timed,
                data_wait_ms=1e3 * monitor.wait_time / monitor.steps if monitor.steps else None,
                stall_pct=report['stall_pct'],
                stall_top_component=report.get('stall_top_component'))


def _train_scan(stream, steps, device, scan_step, scan_kwargs):
    losses = []
    done = timed = 0
    t_start = None
    host_s = 0.0
    batch_size = stream.loader.batch_size
    with stream.loader as loader:
        chunks = loader.scan_batches(scan_step, None, **scan_kwargs)
        while done < steps:
            t0 = time.perf_counter()
            _, outs = next(chunks)
            if t_start is not None:
                host_s += time.perf_counter() - t0
                timed += int(outs.shape[0])
            losses.append(outs)
            done += int(outs.shape[0])
            if len(losses) == 2:   # after the warm-up chunk and the capture
                _sync(device)
                t_start = time.perf_counter()
        chunks.close()
    _sync(device)
    elapsed = time.perf_counter() - t_start if timed else None
    return dict(stream.results(), steps=done,
                losses=[float(v) for v in torch.cat(losses).cpu()],
                images_per_s=timed * batch_size / elapsed if timed else None,
                step_ms=1e3 * elapsed / timed if timed else None,
                host_ms=1e3 * host_s / timed if timed else None,
                data_wait_ms=None, stall_pct=None, stall_top_component=None)


def _train_hbm_cache(dataset_url, steps, batch_size, device, scan_step, reader_kwargs,
                     scan_kwargs):
    losses = []
    done = timed = epochs = 0
    t_start = None
    host_s = 0.0
    with make_reader(dataset_url, num_epochs=1, **reader_kwargs) as reader:
        loader = DeviceInMemDataLoader(reader, batch_size, num_epochs=None, seed=17,
                                       device=device)
        t_resume = time.perf_counter()
        for _, outs in loader.scan_epochs(scan_step, None, **scan_kwargs):
            if t_start is not None:
                host_s += time.perf_counter() - t_resume
                timed += int(outs.shape[0])
            losses.append(outs)
            done += int(outs.shape[0])
            epochs += 1
            _sync(device)
            if t_start is None:
                t_start = time.perf_counter()
            if done >= steps:
                break
            t_resume = time.perf_counter()
    if not epochs:
        raise ValueError('the dataset holds fewer rows than batch_size=%d: no step to run'
                         % batch_size)
    elapsed = time.perf_counter() - t_start
    return {'steps': done,
            'epochs': epochs,
            'losses': [float(v) for v in torch.cat(losses).cpu()],
            'images_per_s': timed * batch_size / elapsed if timed else None,
            'step_ms': 1e3 * elapsed / timed if timed else None,
            'host_ms': 1e3 * host_s / timed if timed else None,
            'stall_pct': 0.0,
            'reader_diagnostics': reader.diagnostics}


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def main(argv=None):
    """The example's command line for the ported branches."""
    parser = argparse.ArgumentParser(
        description='Train ResNet-50 or ViT-S/16 on the card from a JPEG Parquet dataset.')
    parser.add_argument('--dataset-url', required=True,
                        help='petastorm dataset with image and noun_id fields, e.g. file:///path')
    parser.add_argument('--steps', type=int, default=50)
    parser.add_argument('--batch-size', type=int, default=64)
    parser.add_argument('--model', choices=['resnet50', 'vit'], default='resnet50')
    parser.add_argument('--hbm-cache', action='store_true',
                        help='decode the dataset once into device memory and run whole '
                             'epochs from there (DeviceInMemDataLoader.scan_epochs)')
    parser.add_argument('--scan-steps', type=int, default=0,
                        help='stream k batches per transfer and per graph launch '
                             '(DataLoader.scan_batches); 0 runs one step per batch')
    parser.add_argument('--decoded-cache-dir', default=None,
                        help='decode once into per-field files here (DiskCachedDataLoader) '
                             'and stream later epochs from them; a complete cache is read '
                             'with no reader')
    parser.add_argument('--trace', default=None, metavar='PATH',
                        help='write a Chrome trace of the loader, its transfer plane and the '
                             'stall monitor to PATH (not with --hbm-cache)')
    args = parser.parse_args(argv)
    result = train(args.dataset_url, args.steps, args.batch_size, model_name=args.model,
                   hbm_cache=args.hbm_cache, scan_steps=args.scan_steps,
                   decoded_cache_dir=args.decoded_cache_dir, trace_path=args.trace)
    rate, stall = result['images_per_s'], result['stall_pct']
    print('%s on %s: steps=%d loss=%.3f images/s=%s stall=%s'
          % (args.model, result['device'], result['steps'], result['losses'][-1],
             'n/a' if rate is None else '%.1f' % rate,
             'n/a' if stall is None else '%.2f%%' % stall))
    return result


if __name__ == '__main__':
    main()
