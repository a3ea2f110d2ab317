"""Rules the port keeps: it imports nothing of JAX or of the JAX package, its
entry points run on the card unless asked for the CPU, and its kernels
never fall back to another implementation."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, 'petastorm_tpu_torch')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'petastorm_tpu', 'petastorm')


def _port_sources():
    paths = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, files in os.walk(PACKAGE):
        paths.extend(os.path.join(root, f) for f in files if f.endswith('.py'))
    return sorted(paths)


def _imported_modules(tree):
    """Every module an ``import``/``from`` statement or an
    ``importlib.import_module``/``__import__`` call with a literal names."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and (getattr(node.func, 'attr', None) == 'import_module'
                     or getattr(node.func, 'id', None) == '__import__'):
            yield node.args[0].value


def test_port_imports_nothing_of_jax_or_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 20
    for module in ('native.py', 'train_transform.py', 'workers_pool/process_pool.py',
                   'workers_pool/process_worker.py', 'workers_pool/shm_plane.py',
                   'workers_pool/exec_in_new_process.py', 'reader_impl/pickle_serializer.py',
                   'reader_impl/arrow_table_serializer.py', 'gpu/transfer.py', 'gpu/loader.py',
                   'telemetry/__init__.py', 'telemetry/registry.py', 'telemetry/spans.py',
                   'benchmark/trace.py', 'benchmark/advisor.py', 'benchmark/stall_profiler.py',
                   'train.py'):
        assert os.path.join(PACKAGE, module) in sources, module
    offenders = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for module in _imported_modules(tree):
            if module.split('.')[0] in FORBIDDEN:
                offenders.append('%s: %s' % (os.path.relpath(path, REPO), module))
    assert not offenders, offenders


def test_training_on_cpu_never_loads_jax(tmp_path):
    """ViT and ResNet-50 training on the CPU, streaming and from the epoch
    cache, load nothing of JAX."""
    script = textwrap.dedent('''
        import sys
        import numpy as np, pyarrow as pa
        import petastorm_tpu_torch
        from petastorm_tpu_torch import codecs, unischema
        from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
        schema = unischema.Unischema('S', [
            unischema.UnischemaField('noun_id', np.str_, (), codecs.ScalarCodec(pa.string()), False),
            unischema.UnischemaField('image', np.uint8, (None, None, 3),
                                     codecs.CompressedImageCodec('jpeg'), False)])
        url = 'file://' + sys.argv[1]
        rng = np.random.default_rng(0)
        with DatasetWriter(url, schema, rows_per_rowgroup=4) as w:
            for i in range(12):
                w.write({'noun_id': 'n%d' % i,
                         'image': rng.integers(0, 256, (32, 40 if i % 2 else 32, 3),
                                               dtype=np.uint8)})
        # (losses expected, train kwargs): streaming runs take exactly the
        # steps asked for; the HBM cache runs whole epochs, and one epoch of
        # 12 rows at batch 4 is 3 steps.
        runs = [(2, dict(model_name='vit', model_kwargs=dict(num_layers=1, d_model=32,
                                                             num_heads=2, d_ff=64))),
                (2, dict(model_name='resnet50')),
                (3, dict(model_name='resnet50', hbm_cache=True))]
        for expected, kwargs in runs:
            result = petastorm_tpu_torch.train(url, steps=2, batch_size=4, image_hw=(32, 32),
                                               device='cpu', **kwargs)
            assert len(result['losses']) == expected and all(np.isfinite(result['losses'])), \
                result
            assert result['batch_devices'] == ['cpu']
        loaded = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)
        print('LOADED', loaded)
        sys.exit(1 if loaded else 0)
    ''').replace('FORBIDDEN', repr(FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', script, str(tmp_path / 'ds')], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


def test_pumped_disk_cached_traced_training_on_cpu(tmp_path):
    """The example's last flags on the CPU: ``train`` streaming through the
    pumped loader (``transfer=True``) from a decoded disk cache (built, then
    read with no reader) with a trace, and ``--scan-steps``: nothing of JAX
    is loaded, no transfer thread outlives a run, and the trace holds the
    monitor's ``data_wait``, the loader's ``host_batch`` and the plane's
    ``h2d/stage`` spans, the loader's on the transfer thread."""
    script = textwrap.dedent('''
        import json, sys, threading
        import numpy as np, pyarrow as pa
        import petastorm_tpu_torch
        from petastorm_tpu_torch import codecs, unischema
        from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
        schema = unischema.Unischema('S', [
            unischema.UnischemaField('noun_id', np.str_, (), codecs.ScalarCodec(pa.string()), False),
            unischema.UnischemaField('image', np.uint8, (None, None, 3),
                                     codecs.CompressedImageCodec('jpeg'), False)])
        root = sys.argv[1]
        url = 'file://' + root + '/ds'
        rng = np.random.default_rng(0)
        with DatasetWriter(url, schema, rows_per_rowgroup=4) as w:
            for i in range(12):
                w.write({'noun_id': 'n%d' % i,
                         'image': rng.integers(0, 256, (32, 40 if i % 2 else 32, 3),
                                               dtype=np.uint8)})
        vit = dict(model_name='vit', model_kwargs=dict(num_layers=1, d_model=32, num_heads=2,
                                                       d_ff=64))
        cache = root + '/cache'
        for i, extra in enumerate([dict(decoded_cache_dir=cache), dict(decoded_cache_dir=cache),
                                   dict(scan_steps=2)]):
            trace = root + '/trace%d.json' % i
            result = petastorm_tpu_torch.train(url, steps=4, batch_size=4, image_hw=(32, 32),
                                               device='cpu', transfer=True, trace_path=trace,
                                               **dict(vit, **extra))
            assert len(result['losses']) == 4 and all(np.isfinite(result['losses'])), result
            assert result['report'].startswith('pipeline regime: ')
            # a batch per put streaming, a chunk of two per put with scan_steps=2
            assert result['loader_metrics']['h2d_batches'] >= (2 if i == 2 else 4), \
                result['loader_metrics']
            assert petastorm_tpu_torch.DiskCachedDataLoader.cache_complete(cache)
            events = json.load(open(trace))['traceEvents']
            assert result['trace_events'] == len(events)
            tids = {}
            for e in events:
                tids.setdefault(e['name'], set()).add(e['tid'])
            want = {'host_batch', 'h2d/stage'} | ({'data_wait'} if i < 2 else set())
            assert want <= set(tids), sorted(tids)
            if i < 2:
                assert not (tids['host_batch'] | tids['h2d/stage']) & tids['data_wait']
                assert result['stall_top_component'] is not None
            left = [t.name for t in threading.enumerate() if t.name.endswith('h2d-dispatch')]
            assert not left, left
        loaded = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)
        print('LOADED', loaded)
        sys.exit(1 if loaded else 0)
    ''').replace('FORBIDDEN', repr(FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', script, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


def test_decode_workers_load_neither_torch_nor_jax(tmp_path):
    """What a process-pool child imports and unpickles (its main loop, the
    reader's worker and its arguments, the image example's transform, the
    native plane) loads neither torch nor JAX."""
    import pickle
    from petastorm_tpu_torch.py_dict_reader_worker import PyDictReaderWorker, RowWorkerArgs
    from petastorm_tpu_torch.train import make_transform
    from petastorm_tpu_torch.transform import ResizeImages
    from petastorm_tpu_torch.workers_pool.process_worker import worker_main
    payload = tmp_path / 'payload.pkl'
    payload.write_bytes(pickle.dumps(
        (worker_main, PyDictReaderWorker,
         RowWorkerArgs(pieces=[], schema_view=None, transform_spec=make_transform((32, 32))),
         ResizeImages({'image': (8, 8)}))))
    script = textwrap.dedent('''
        import pickle, sys
        import petastorm_tpu_torch.py_dict_reader_worker
        import petastorm_tpu_torch.workers_pool.process_worker
        from petastorm_tpu_torch import native
        with open(sys.argv[1], 'rb') as f:
            worker_main, worker, args, resize = pickle.load(f)
        assert args.transform_spec.func({'image': __import__('numpy').zeros((4, 4, 3), 'uint8'),
                                         'noun_id': 'n0'})['image'].shape == (32, 32, 3)
        native.capabilities()
        loaded = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN + ('torch',))
        print('LOADED', loaded)
        sys.exit(1 if loaded else 0)
    ''').replace('FORBIDDEN', repr(FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', script, str(payload)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


def test_process_pool_training_on_cpu_equals_the_thread_pools(tmp_path):
    """ViT (one layer) trained 2 steps on the CPU with the process pool
    gives the thread pool's losses, one worker each (one data order), under
    one PYTHONHASHSEED for the parent and its children (the example's label
    is ``hash(noun_id) % 1000``); its batches came through ``/dev/shm``,
    and no slab or child is left behind."""
    script = textwrap.dedent('''
        import sys
        import numpy as np, pyarrow as pa
        import petastorm_tpu_torch
        from petastorm_tpu_torch import codecs, unischema
        from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
        from petastorm_tpu_torch.workers_pool import shm_plane
        schema = unischema.Unischema('S', [
            unischema.UnischemaField('noun_id', np.str_, (), codecs.ScalarCodec(pa.string()),
                                     False),
            unischema.UnischemaField('image', np.uint8, (None, None, 3),
                                     codecs.CompressedImageCodec('png'), False)])
        url = 'file://' + sys.argv[1]
        rng = np.random.default_rng(0)
        with DatasetWriter(url, schema, rows_per_rowgroup=12) as w:
            for i in range(24):
                w.write({'noun_id': 'n%d' % i,
                         'image': rng.integers(0, 256, (32, 40 if i % 2 else 32, 3),
                                               dtype=np.uint8)})
        results = {}
        for pool in ('thread', 'process'):
            results[pool] = petastorm_tpu_torch.train(
                url, steps=2, batch_size=4, image_hw=(32, 32), device='cpu', model_name='vit',
                model_kwargs=dict(num_layers=1), reader_pool_type=pool, workers_count=1)
        print('LOSSES', results['thread']['losses'], results['process']['losses'])
        assert results['thread']['losses'] == results['process']['losses']
        thread_diag = results['thread']['reader_diagnostics']
        assert thread_diag['pool'] == 'thread' and 'shm_results' not in thread_diag
        diag = results['process']['reader_diagnostics']
        assert diag['shm_results'] > 0, diag
        assert shm_plane.residue(diag['worker_pids']) == set()
    ''')
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONHASHSEED='0')
    proc = subprocess.run([sys.executable, '-c', script, str(tmp_path / 'ds')], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_lm_training_and_sampling_on_cpu_never_load_jax(tmp_path):
    """The LM paths on the CPU (long-context training, packed training
    with dense and flash attention, KV-cache sampling) load nothing of
    JAX: the same subprocess check, in a process of its own."""
    script = textwrap.dedent('''
        import sys
        import numpy as np
        import petastorm_tpu_torch.train_lm as lm
        url = 'file://' + sys.argv[1]
        small = dict(d_model=32, num_heads=4, num_layers=1, d_ff=64)
        lm.LONG_CONTEXT_LM.update(small)
        lm.PACKED_LM.update(small)
        lm.write_token_dataset(url + '_tokens', num_docs=8)
        result = lm.train_lm(url + '_tokens', steps=2, batch_size=2, device='cpu')
        assert len(result['losses']) == 2 and all(np.isfinite(result['losses'])), result
        assert result['batch_devices'] == ['cpu']
        lm.write_var_token_dataset(url + '_var_tokens', num_docs=16)
        for attn in ('dense', 'flash'):
            result = lm.train_packed(url + '_var_tokens', steps=2, attn=attn, device='cpu')
            assert len(result['losses']) == 2 and all(np.isfinite(result['losses'])), result
            assert result['step_ms'] > 0 and result['step_tokens_per_s'] > 0, result
            assert result['batch_devices'] == ['cpu'] and 0 < result['packing_utilization'] <= 1
        prompt, tokens = lm.sample(result['model'], max_new=4)
        assert prompt.shape == (2, 8) and tuple(tokens.shape) == (2, 4)
        loaded = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)
        print('LOADED', loaded)
        sys.exit(1 if loaded else 0)
    ''').replace('FORBIDDEN', repr(FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', script, str(tmp_path / 'ds')], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    from petastorm_tpu_torch.gpu import (DataLoader, DeviceInMemDataLoader, InMemDataLoader,
                                         PackedDataLoader, resolve_device)
    from petastorm_tpu_torch.train import main, train
    import petastorm_tpu_torch.train_lm as lm

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device('cuda')
    assert resolve_device('cpu') == torch.device('cpu')

    class ColumnarReader(object):
        batched_output = True

    for loader in (DataLoader, InMemDataLoader, DeviceInMemDataLoader):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            loader(ColumnarReader(), 4)
        assert loader(ColumnarReader(), 4, device='cpu').device.type == 'cpu'
    for kwargs in (dict(), dict(model_name='resnet50'), dict(model_name='vit'),
                   dict(hbm_cache=True)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            train('file://%s' % tmp_path, steps=1, **kwargs)
    for flags in ([], ['--model', 'vit'], ['--hbm-cache']):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            main(['--dataset-url', 'file://%s' % tmp_path, '--steps', '1'] + flags)

    class RowReader(object):
        batched_output = False

    with pytest.raises(RuntimeError, match='device="cpu"'):
        PackedDataLoader(RowReader(), 'tokens', 64, 4)
    assert PackedDataLoader(RowReader(), 'tokens', 64, 4, device='cpu').device.type == 'cpu'
    for entry in (lm.train_lm, lm.train_packed):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            entry('file://%s' % tmp_path, steps=1)
    for flags in ([], ['--packed'], ['--packed', '--strategy', 'flash', '--sample']):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            lm.main(['--dataset-url', 'file://%s' % tmp_path, '--steps', '1'] + flags)


def test_kernel_wrappers_never_fall_back():
    """No ``try`` anywhere in the kernel module (so nothing catches a failed
    launch), every wrapper launches, each route of each wrapper (tensor
    cores, CUDA cores) reaches its own launch, and nothing in the package
    reaches PyTorch's fused attention or torch.compile."""
    path = os.path.join(PACKAGE, 'ops', 'flash_attention.py')
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    wrappers = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name in ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')}
    assert sorted(wrappers) == ['flash_bwd_dkv', 'flash_bwd_dq', 'flash_fwd']
    routes = {'flash_fwd': ['pt_flash_fwd', 'pt_flash_fwd_sm90'],
              'flash_bwd_dq': ['pt_flash_bwd_dq', 'pt_flash_bwd_dq_sm90'],
              'flash_bwd_dkv': ['pt_flash_bwd_dkv', 'pt_flash_bwd_dkv_sm90']}
    for name, fn in wrappers.items():
        launched = sorted(c.args[0].value for c in ast.walk(fn)
                          if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)
                          and c.func.id == '_launch' and isinstance(c.args[0], ast.Constant))
        assert launched == routes[name], name
    for source in _port_sources():
        if source.endswith('chip_smoke.py'):
            continue   # times one library call as a yardstick, outside the package
        with open(source) as f:
            text = f.read()
        for banned in ('scaled_dot_product_attention', 'torch.compile', 'cudnn_attention'):
            assert banned not in text, (source, banned)
