"""Two checkouts of the port against each other on one card: the streaming
training paths, in turns (first, second, second, first), each run in a
process of its own.

    python3 ab_streaming.py FIRST_DIR [SECOND_DIR]

``SECOND_DIR`` defaults to this script's checkout.  The JPEG and token
datasets are written once, by the second checkout's writers.  Each turn runs
ResNet-50 and ViT-S/16 streaming (8 decode threads, the transfer plane on),
L1 and L2 (``train_lm``, ``train_packed`` with flash), 100 steps timed after
20 (L1 and L2 after 2), as ``chip_smoke.py``'s decode-plane phase runs them,
and prints one JSON line per run, then each metric's readings side by side.
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
from petastorm_tpu_torch.train import train
url, lm_url, packed_url = sys.argv[2:5]
out = {}
for model in ('resnet50', 'vit'):
    r = train(url, steps=120, batch_size=64, model_name=model, warmup_steps=20)
    out[model] = {k: r[k] for k in ('images_per_s', 'step_ms', 'data_wait_ms', 'stall_pct')}
r = lm.train_lm(lm_url, steps=100, batch_size=8, strategy='flash')
out['lm'] = {k: r[k] for k in ('tokens_per_s', 'step_ms', 'data_wait_ms', 'stall_pct')}
r = lm.train_packed(packed_url, steps=100, attn='flash')
out['packed'] = {k: r[k] for k in ('step_tokens_per_s', 'step_ms')}
print('RESULT ' + json.dumps(out))
'''


def run(root, urls):
    proc = subprocess.run([sys.executable, '-c', CHILD, root] + urls, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError('%s failed:\n%s' % (root, proc.stderr[-4000:]))
    line = [x for x in proc.stdout.splitlines() if x.startswith('RESULT ')][-1]
    return json.loads(line[len('RESULT '):])


def main(argv):
    first = os.path.abspath(argv[0])
    second = os.path.abspath(argv[1]) if len(argv) > 1 else os.path.dirname(
        os.path.abspath(__file__))
    sys.path.insert(0, second)
    import chip_smoke
    import petastorm_tpu_torch.train_lm as lm
    with tempfile.TemporaryDirectory(prefix='ab_streaming_') as tmp:
        urls = ['file://' + os.path.join(tmp, name)
                for name in ('imagenet_jpeg', 'lc_tokens', 'lc_var_tokens')]
        chip_smoke.write_dataset(urls[0])
        lm.write_token_dataset(urls[1])
        lm.write_var_token_dataset(urls[2])
        turns = []
        for label, root in (('first', first), ('second', second), ('second', second),
                            ('first', first)):
            result = run(root, urls)
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
