"""DataFrame -> training data in two lines, on the card.

Counterpart of ``examples/dataframe_converter/jax_example.py``: a pandas
frame of 512 rows (16 float features as array cells, a 0/1 label) is
materialized once with :func:`make_pandas_converter`, and a logistic
regression trains on the card for 2 epochs of batches of 64 read back
through the converter's loader (2 decode threads); then the cache is
deleted.  Run ``python -m petastorm_tpu_torch.spark.converter_example
[--parent-cache-dir-url URL] [--device cpu]``.
"""

import argparse
import os
import tempfile

import numpy as np
import pandas as pd
import torch

from petastorm_tpu_torch.gpu.transfer import resolve_device
from petastorm_tpu_torch.spark.spark_dataset_converter import make_pandas_converter

__all__ = ['example_frame', 'logreg_loss', 'main']


def example_frame(rows=512, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        'features': [rng.standard_normal(16) for _ in range(rows)],
        'label': rng.integers(0, 2, rows).astype(np.int64),
    })


def logreg_loss(w, x, y):
    logits = x @ w
    return torch.mean(torch.logaddexp(torch.zeros_like(logits), logits) - y * logits)


def main(argv=None):
    """Returns the ``losses`` of every step, ``steps``, the
    ``cache_dir_url`` and the final weights ``w``."""
    parser = argparse.ArgumentParser(description='pandas DataFrame -> logistic regression on '
                                                 'the card through the converter.')
    parser.add_argument('--parent-cache-dir-url', default='file://' + os.path.join(
        tempfile.gettempdir(), 'converter_cache'))
    parser.add_argument('--device', default=None, help='cuda (the default) or cpu')
    parser.add_argument('--workers-count', type=int, default=2)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    converter = make_pandas_converter(example_frame(),
                                      parent_cache_dir_url=args.parent_cache_dir_url)
    print('materialized %d rows to %s' % (len(converter), converter.cache_dir_url))
    w = torch.zeros(16, device=device)
    losses = []
    steps = 0
    with converter.make_loader(batch_size=64, num_epochs=2, workers_count=args.workers_count,
                               loader_kwargs=dict(device=device)) as loader:
        for step, batch in enumerate(loader):
            x = batch['features'].float()   # a rectangular list column: (B, 16)
            y = batch['label'].float()
            w.requires_grad_(True)
            loss = logreg_loss(w, x, y)
            (grad,) = torch.autograd.grad(loss, w)
            w = (w - 0.1 * grad).detach()
            losses.append(loss.detach())
            if step % 5 == 0:
                print('step %d loss %.4f' % (step, float(logreg_loss(w, x, y))))
            steps += 1
    converter.delete()
    print('cache deleted')
    return {'losses': [float(v) for v in losses], 'steps': steps,
            'cache_dir_url': converter.cache_dir_url, 'w': w}


if __name__ == '__main__':
    main()
