"""Two checkouts of the port against each other on one card: the streaming
training paths, in turns (first, second, second, first), each run in a
process of its own.

    python3 ab_streaming.py FIRST_DIR [SECOND_DIR] [--pairs N] [--paths resnet50,mnist]

``SECOND_DIR`` defaults to this script's checkout.  The JPEG, token and
MNIST datasets are written once, by the second checkout's writers.  Each
turn runs ResNet-50 and ViT-S/16 streaming (8 decode threads, the transfer
plane on), L1 and L2 (``train_lm``, ``train_packed`` with flash), 100 steps
timed after 20 (L1 and L2 after 2), as ``chip_smoke.py``'s decode-plane
phase runs them, and the MNIST example's row path (``train_mnist.train``,
60,000 PNG rows, one epoch, 4 decode threads, timed after 2 steps), and
prints one JSON line per run, then each metric's readings side by side.
``--pairs N`` runs N such pairs of turns, alternating which checkout goes
first in each (default 2: first, second, second, first); ``--paths`` runs
only the named paths (``resnet50``, ``vit``, ``lm``, ``packed``, ``mnist``).
"""

import json
import os
import subprocess
import sys
import tempfile

CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import petastorm_tpu_torch.train_lm as lm
from petastorm_tpu_torch import train_mnist
from petastorm_tpu_torch.train import train
url, lm_url, packed_url, mnist_url, paths = sys.argv[2:7]
paths = paths.split(',')
out = {}
for model in ('resnet50', 'vit'):
    if model in paths:
        r = train(url, steps=120, batch_size=64, model_name=model, warmup_steps=20)
        out[model] = {k: r[k] for k in ('images_per_s', 'step_ms', 'data_wait_ms', 'stall_pct')}
if 'lm' in paths:
    r = lm.train_lm(lm_url, steps=100, batch_size=8, strategy='flash')
    out['lm'] = {k: r[k] for k in ('tokens_per_s', 'step_ms', 'data_wait_ms', 'stall_pct')}
if 'packed' in paths:
    r = lm.train_packed(packed_url, steps=100, attn='flash')
    out['packed'] = {k: r[k] for k in ('step_tokens_per_s', 'step_ms')}
if 'mnist' in paths:
    e = train_mnist.train(mnist_url, epochs=1)['epochs_run'][0]
    out['mnist'] = {k: e[k] for k in ('timed_rows_per_s', 'step_ms', 'data_wait_ms',
                                      'stall_pct')}
print('RESULT ' + json.dumps(out))
'''


def run(root, urls):
    proc = subprocess.run([sys.executable, '-c', CHILD, root] + urls, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError('%s failed:\n%s' % (root, proc.stderr[-4000:]))
    line = [x for x in proc.stdout.splitlines() if x.startswith('RESULT ')][-1]
    return json.loads(line[len('RESULT '):])


PATHS = ('resnet50', 'vit', 'lm', 'packed', 'mnist')


def main(argv):
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('first')
    parser.add_argument('second', nargs='?', default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument('--pairs', type=int, default=2)
    parser.add_argument('--paths', default=','.join(PATHS))
    args = parser.parse_args(argv)
    first, second = os.path.abspath(args.first), os.path.abspath(args.second)
    sys.path.insert(0, second)
    import chip_smoke
    import petastorm_tpu_torch.train_lm as lm
    from petastorm_tpu_torch import train_mnist
    with tempfile.TemporaryDirectory(prefix='ab_streaming_') as tmp:
        urls = ['file://' + os.path.join(tmp, name)
                for name in ('imagenet_jpeg', 'lc_tokens', 'lc_var_tokens', 'mnist')]
        chip_smoke.write_dataset(urls[0])
        lm.write_token_dataset(urls[1])
        lm.write_var_token_dataset(urls[2])
        train_mnist.write_mnist_dataset(urls[3], 60000)
        turns = []
        order = []
        for pair in range(args.pairs):
            order += [('first', first), ('second', second)][::1 if pair % 2 == 0 else -1]
        for label, root in order:
            result = run(root, urls + [args.paths])
            turns.append((label, result))
            print(json.dumps({'turn': label, 'root': root, 'result': result}), flush=True)
    for path in sorted(turns[0][1]):
        for metric in sorted(turns[0][1][path]):
            readings = {label: [r[path][metric] for lab, r in turns if lab == label]
                        for label in ('first', 'second')}
            print('%-8s %-18s first %s  second %s' % (path, metric, readings['first'],
                                                      readings['second']))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
