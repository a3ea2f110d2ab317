"""JPEG Parquet -> ViT-S/16 training steps on the card.

Counterpart of ``examples/imagenet/jax_example.py::train`` with
``--model vit`` (BASELINE.json config #3 on the model that runs the flash
kernels): JPEG decode + resize run in the reader's thread pool (the
TransformSpec), batches are assembled columnar and moved to the device by
:class:`~petastorm_tpu_torch.gpu.DataLoader`, ``random_crop(padding=4)``,
``random_flip_left_right`` and ``normalize`` run on the device, and the
model takes SGD steps (momentum 0.9) under softmax cross-entropy.  Every
attention call goes through the hand-written flash kernels.

The ResNet-50 branch (no kernel on its path), the disk and HBM caches,
``scan_batches``, the stall monitor and the example's command line are
later slices of the port.
"""

import time

import numpy as np
import torch
import torch.nn.functional as F

from petastorm_tpu_torch.gpu import DataLoader, augment
from petastorm_tpu_torch.gpu.transfer import resolve_device
from petastorm_tpu_torch.models.vit import ViT
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.transform import TransformSpec

__all__ = ['make_transform', 'train', 'VIT_S16']

#: ViT-S/16 as the JAX example builds it (jax_example.py:69-70).
VIT_S16 = dict(num_classes=1000, patch_size=16, d_model=384, num_heads=6, num_layers=12,
               d_ff=1536)


def make_transform(image_hw):
    """Worker-side decode fix-up: resize to ``image_hw`` and turn ``noun_id``
    into an int32 ``label`` (copied from the JAX example)."""
    import cv2

    def fix_row(row):
        row = dict(row)
        img = row.pop('image')
        if img.shape[:2] != image_hw:
            img = cv2.resize(img, (image_hw[1], image_hw[0]))
        row['image'] = img
        row['label'] = np.int32(hash(row.pop('noun_id')) % 1000)
        return row

    return TransformSpec(fix_row,
                         edit_fields=[('image', np.uint8, image_hw + (3,), False),
                                      ('label', np.int32, (), False)],
                         removed_fields=['noun_id'])


def train(dataset_url, steps, batch_size=64, image_hw=(224, 224), lr=0.1, device=None, *,
          model_kwargs=None):
    """Run ``steps`` training steps; returns the losses and the timings.

    The reader decodes with 8 worker threads and the initial weights come
    from seed 0, as in the JAX example.  ``model_kwargs`` overrides entries
    of :data:`VIT_S16` (a CPU run shrinks the model with it).  Images/s and
    step time are taken over the steps after the first two (warm-up), on
    the host clock with the device synchronized at both ends.
    """
    if steps < 1:
        raise ValueError('steps must be at least 1, got %r' % (steps,))
    device = resolve_device(device)
    image_hw = tuple(image_hw)
    # fp32 matmuls and convolutions in full fp32, as the flax model computes
    # them: no TF32 for the fp32 head, nor for cuDNN's fp32 convolutions
    # (whose default is TF32).  The bf16 products are unaffected.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = dict(VIT_S16, **(model_kwargs or {}))
    model = ViT(image_hw=image_hw, generator=torch.Generator().manual_seed(0),
                **config).to(device)
    # optax.sgd(lr, momentum=0.9): trace = g + 0.9 trace; p -= lr * trace.
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9, dampening=0,
                          nesterov=False)
    aug_gen = torch.Generator(device=device).manual_seed(17)
    warmup = min(2, steps - 1)
    losses = []
    batch_devices = set()
    data_wait = 0.0
    t_start = None
    reader = make_reader(dataset_url, schema_fields=['image', 'noun_id'],
                         transform_spec=make_transform(image_hw), columnar_decode=True,
                         num_epochs=None, workers_count=8)
    with DataLoader(reader, batch_size=batch_size, device=device) as loader:
        batches = iter(loader)
        for step in range(steps):
            if step == warmup:
                _sync(device)
                t_start = time.perf_counter()
                data_wait = 0.0
            t0 = time.perf_counter()
            batch = next(batches)
            data_wait += time.perf_counter() - t0
            images, labels = batch['image'], batch['label']
            batch_devices.add(str(images.device.type))
            if images.device.type != device.type:
                raise RuntimeError('batch reached the model on %s, expected %s'
                                   % (images.device, device))
            x = augment.random_crop(images, image_hw, padding=4, generator=aug_gen)
            x = augment.random_flip_left_right(x, generator=aug_gen)
            x = augment.normalize(x, dtype=torch.float32)
            loss = F.cross_entropy(model(x), labels.long())
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
    _sync(device)
    elapsed = time.perf_counter() - t_start
    timed = steps - warmup
    return {'steps': steps,
            'losses': [float(v) for v in torch.stack(losses).cpu()],
            'images_per_s': timed * batch_size / elapsed,
            'step_ms': 1e3 * elapsed / timed,
            'data_wait_ms': 1e3 * data_wait / timed,
            'batch_devices': sorted(batch_devices),
            'device': str(device)}


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)

