"""Ranks for the port's multi-process tests (``tests/test_torch_mesh.py``,
``test_torch_parallel_attention.py``, ``test_torch_sequence_parallel.py``).

:func:`run_ranks` spawns ``world`` processes that join one gloo group
through a ``dist.FileStore`` under the test's ``tmp_path`` (no TCP port is
chosen, so modules running side by side under xdist do not collide) and run
one of the functions below, which does all of a module's cases in one
start.  Each rank is joined with its own time limit: a hung collective fails
its test and does not run the suite into its limit.  The ranks import torch
and the port only; the JAX side of each comparison runs in the test process.
"""

import multiprocessing
import os
import pickle
import traceback

import numpy as np

#: Per-rank join limit, seconds.
RANK_TIMEOUT_S = 120


def run_ranks(tmp_path, world, fn_name, payload, timeout_s=RANK_TIMEOUT_S):
    """Run ``fn_name(rank, world, payload)`` on ``world`` spawned ranks of a
    gloo group; returns the results, by rank.  A rank that raises or does
    not finish in ``timeout_s`` fails the call."""
    ctx = multiprocessing.get_context('spawn')
    store = os.path.join(str(tmp_path), 'store')
    outs = [os.path.join(str(tmp_path), 'rank%d.pkl' % r) for r in range(world)]
    procs = [ctx.Process(target=_rank_main, args=(r, world, store, fn_name, payload, outs[r]),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    hung = []
    for r, p in enumerate(procs):
        p.join(timeout_s)
        if p.is_alive():
            hung.append(r)
            p.kill()
            p.join()
    results, errors = [], []
    for r, path in enumerate(outs):
        if not os.path.exists(path):
            errors.append('rank %d left no result (exit code %s)' % (r, procs[r].exitcode))
            results.append(None)
            continue
        with open(path, 'rb') as f:
            out = pickle.load(f)
        if 'error' in out:
            errors.append('rank %d raised:\n%s' % (r, out['error']))
        results.append(out.get('result'))
    if hung:
        errors.insert(0, 'ranks %s did not finish within %d s' % (hung, timeout_s))
    if errors:
        raise AssertionError('\n'.join(errors))
    return results


def _rank_main(rank, world, store, fn_name, payload, out):
    os.environ['GLOO_SOCKET_IFNAME'] = 'lo'    # the ranks of one host talk over loopback
    import torch
    import torch.distributed as dist
    torch.set_num_threads(2)
    from petastorm_tpu_torch.parallel import init_distributed
    try:
        init_distributed('cpu', store, rank, world)
        result = {'result': globals()[fn_name](rank, world, payload)}
    except BaseException:   # noqa: B036 - reported to the test, which fails
        result = {'error': traceback.format_exc()}
    with open(out, 'wb') as f:
        pickle.dump(result, f)
    if dist.is_initialized():
        dist.destroy_process_group()


def _error(fn):
    """The message of the ``ValueError`` ``fn()`` raises (None if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# test_torch_parallel_attention.py
# ---------------------------------------------------------------------------

def attention_cases(rank, world, payload):
    """Each case's output and q/k/v gradients (of ``sum(out * ct)``) on this
    rank's blocks, with the slices of the global arrays they are; then the
    refusals' messages."""
    import torch
    from petastorm_tpu_torch.models.transformer import make_attn_fn
    from petastorm_tpu_torch.ops import flash_attention
    from petastorm_tpu_torch.parallel import make_mesh, make_ring_attention, \
        make_ulysses_attention
    meshes, out = {}, {}
    arrays = {k: payload[k] for k in ('q', 'k', 'v', 'ct', 'seg')}
    for case in payload['cases']:
        shape = tuple(case['mesh'].items())
        if shape not in meshes:
            meshes[shape] = make_mesh(dict(case['mesh']))
        mesh = meshes[shape]
        if case['kind'] == 'ring':
            fn, sharding = make_ring_attention(mesh, causal=case['causal'],
                                               block_k=case.get('block_k'),
                                               packed=case['packed'])
        else:
            fn, sharding = make_ulysses_attention(
                mesh, causal=case['causal'], packed=case['packed'],
                attn_fn=flash_attention if case.get('attn') == 'flash' else None)
        index = sharding.index(arrays['q'].shape)
        q, k, v = (torch.tensor(arrays[n][index], requires_grad=True) for n in 'qkv')
        args = (q, k, v, torch.tensor(arrays['seg'][index[:2]])) if case['packed'] \
            else (q, k, v)
        o = fn(*args)
        (o * torch.tensor(arrays['ct'][index])).sum().backward()
        out[case['name']] = dict(index=index, out=_np(o), dq=_np(q.grad), dk=_np(k.grad),
                                 dv=_np(v.grad))
    mesh = meshes[(('data', 1), ('seq', 2))]
    q3 = torch.zeros(1, 4, 3, 8)
    ring_fn = make_attn_fn(mesh, 'ring', head_axis=None, causal=True)
    refusals = {
        'ulysses_heads': _error(lambda: make_ulysses_attention(mesh)[0](q3, q3, q3)),
        'block_k': _error(lambda: make_ring_attention(mesh, block_k=0)[0](q3, q3, q3)),
        'curried_causal': _error(lambda: ring_fn(q3, q3, q3, causal=False)),
        'ring_causal_ok': _np(ring_fn(q3, q3, q3, causal=True)).shape,
    }
    return {'cases': out, 'refusals': refusals}


# ---------------------------------------------------------------------------
# test_torch_mesh.py
# ---------------------------------------------------------------------------

def _labels(batch):
    return {'tokens': batch['tokens'], 'labels': np.roll(batch['tokens'], -1, axis=1)}


def _odd_width(batch):
    return {'tokens': batch['tokens'][:, 1:]}


def mesh_cases(rank, world, payload):
    """make_mesh's shapes and errors, global_batch_from_local's blocks, the
    host helpers, the default shard, epoch_steps, and DataLoader(sharding=)
    batches (inline and through the transfer plane)."""
    import itertools

    from petastorm_tpu_torch import parallel
    from petastorm_tpu_torch.gpu import DataLoader, DeviceInMemDataLoader, ResidentDataLoader
    from petastorm_tpu_torch.reader import make_reader
    res = {'errors': [_error(lambda s=shape: parallel.make_mesh(s))
                      for shape in payload['bad_meshes']]}
    meshes = {}

    def mesh_of(axes):
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = parallel.make_mesh(dict(axes))
        return meshes[key]

    res['minus_one'] = tuple(mesh_of({'data': 2, 'seq': -1}).shape)
    res['blocks'] = []
    for axes, spec, local in payload['assembly']:
        sharding = parallel.NamedSharding(mesh_of(axes), spec)
        arr = parallel.global_batch_from_local({'x': local[rank]}, sharding)['x']
        res['blocks'].append((tuple(arr.shape), _np(arr.to_local()), str(arr.to_local().dtype)))
    res['host_shard_info'] = parallel.host_shard_info()
    parallel.sync_hosts('mesh cases')
    res['min_over_hosts'] = parallel.min_over_hosts(rank + 3)
    url, batch = payload['url'], payload['batch']
    with make_reader(url, reader_pool_type='dummy', columnar_decode=True) as reader:
        state = reader.state_dict()
        res['default_shard'] = (state['cur_shard'], state['shard_count'])
        res['epoch_steps'] = parallel.epoch_steps(reader, batch)
        res['drop_last_false'] = _error(lambda: parallel.epoch_steps(reader, batch,
                                                                     drop_last=False))
    mesh = mesh_of({'data': 2, 'seq': 2})
    i = parallel.mesh.axis_index(mesh, 'data')
    res['loader'] = {}
    for label, axes, spec, shards, transform, transfer in (
            ('data_seq inline', {'data': 2, 'seq': 2}, ('data', 'seq'), 2, _labels, False),
            ('data_seq plane', {'data': 2, 'seq': 2}, ('data', 'seq'), 2, _labels, True),
            ('data inline', {'data': 4}, ('data',), 4, None, False)):
        cur = parallel.mesh.axis_index(mesh_of(axes), 'data')
        reader = make_reader(url, reader_pool_type='dummy', columnar_decode=True, seed=1,
                             cur_shard=cur, shard_count=shards)
        with DataLoader(reader, batch, device='cpu', transform_fn=transform, transfer=transfer,
                        sharding=parallel.NamedSharding(mesh_of(axes), spec)) as loader:
            res['loader'][label] = [
                {k: (tuple(v.shape), _np(v.to_local()), str(v.to_local().dtype))
                 for k, v in b.items()} for b in itertools.islice(loader, payload['batches'])]
    sharding = parallel.NamedSharding(mesh, ('data', 'seq'))
    reader = make_reader(url, reader_pool_type='dummy', columnar_decode=True, cur_shard=i,
                         shard_count=2)
    with DataLoader(reader, batch, device='cpu', transform_fn=_odd_width,
                    sharding=sharding) as loader:
        res['indivisible'] = _error(lambda: next(iter(loader)))
    res['cache_refusals'] = {}
    for cls in (DeviceInMemDataLoader, ResidentDataLoader):
        with make_reader(url, reader_pool_type='dummy', columnar_decode=True,
                         num_epochs=1) as reader:
            res['cache_refusals'][cls.__name__] = _error(
                lambda c=cls: c(reader, batch, device='cpu', sharding=sharding))
    return res


# ---------------------------------------------------------------------------
# test_torch_sequence_parallel.py
# ---------------------------------------------------------------------------

def sequence_parallel_cases(rank, world, payload):
    """``train_lm`` at each (strategy, seq_shards) of the payload, from the
    payload's parameters: the losses, this rank's token blocks per step, its
    mesh coordinate and the parameters after the run.  The example's own
    mesh rule gives ring and Ulysses ``seq`` 2 on two ranks; the runs at
    ``seq`` 1 replace ``train_lm``'s ``_mesh_for``.  The parameters are
    loaded into the model ``_model`` builds, and the batches are read where
    ``_check_batch`` sees them."""
    import torch

    import petastorm_tpu_torch.train_lm as lm
    from petastorm_tpu_torch.parallel import mesh as mesh_lib
    lm.LONG_CONTEXT_LM.update(payload['config'], compute_dtype=torch.float32)
    params = {k: torch.tensor(v) for k, v in payload['params'].items()}
    example_mesh, seeded_model, check_batch = lm._mesh_for, lm._model, lm._check_batch

    def model_from_params(config, **kwargs):
        model = seeded_model(config, **kwargs)
        model.load_state_dict(params)
        return model

    lm._model = model_from_params
    out = {}
    for name, strategy, seq_shards, block_k in payload['runs']:
        seen = []

        def record_batch(tokens, device, devices, seen=seen):
            seen.append(_np(tokens))
            check_batch(tokens, device, devices)

        lm._check_batch = record_batch
        lm._mesh_for = example_mesh if seq_shards == 2 else (
            lambda strategy, world, sp=seq_shards: mesh_lib.make_mesh(
                {'data': world // sp, 'seq': sp}))
        result = lm.train_lm(payload['url'], payload['steps'], batch_size=payload['batch'],
                             strategy=strategy, device='cpu', block_k=block_k)
        mesh = mesh_lib.make_mesh(result['mesh'])
        out[name] = dict(losses=result['losses'], tokens=seen, mesh=result['mesh'],
                         coord=(mesh_lib.axis_index(mesh, 'data'),
                                mesh_lib.axis_index(mesh, 'seq')),
                         params={k: _np(v) for k, v in result['model'].state_dict().items()})
    return out


def ring_step_imports(rank, world, payload):
    """One 2-rank ring step, then the names of the modules loaded."""
    import sys

    import torch
    from petastorm_tpu_torch.parallel import make_mesh, make_ring_attention
    fn, _ = make_ring_attention(make_mesh({'seq': world}), causal=True)
    q = torch.randn(1, 8, 2, 4, requires_grad=True)
    fn(q, q, q).sum().backward()
    return sorted(sys.modules)
