"""Ranks for the port's multi-process tests (``tests/test_torch_mesh.py``,
``test_torch_parallel_attention.py``, ``test_torch_sequence_parallel.py``,
``test_torch_data_parallel.py``, ``test_torch_tensor_parallel.py``,
``test_torch_pipeline_moe.py``).

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


# ---------------------------------------------------------------------------
# test_torch_tensor_parallel.py
# ---------------------------------------------------------------------------

def _specs(model, shardings):
    from petastorm_tpu_torch.convert import flax_leaves
    leaves = flax_leaves(model)
    return {name: (leaves[name].path, tuple(s.spec)) for name, s in shardings.items()}


def _case_model(case):
    """A case's port model in fp32, from the case's parameters."""
    import torch

    from petastorm_tpu_torch.models.transformer import TransformerLM
    from petastorm_tpu_torch.models.vit import ViT
    if case['kind'] == 'vit':
        model = ViT(**case['config'], image_hw=case['inputs'].shape[1:3],
                    compute_dtype=torch.float32)
    else:
        model = TransformerLM(**case['config'], compute_dtype=torch.float32)
    model.load_state_dict({k: torch.tensor(v) for k, v in case['state'].items()})
    return model


def tensor_parallel_cases(rank, world, payload):
    """Each model case placed on ``{'data': 2, 'model': 2}`` by its rules:
    the specs by parameter, this rank's stored blocks, the logits of its
    data rows, and the blocks' gradients of the global mean loss (summed
    over the data axis); then the FSDP rules on a tree of dicts and TP
    ``generate``."""
    import torch
    import torch.nn.functional as F

    from petastorm_tpu_torch import parallel
    from petastorm_tpu_torch.models.decoding import generate
    from petastorm_tpu_torch.models.transformer import (TransformerLM, megatron_spec_fn,
                                                        param_shardings)
    mesh = parallel.make_mesh({'data': 2, 'model': 2})
    data_index = parallel.mesh.axis_index(mesh, 'data')
    rules = {'tp': lambda m: param_shardings(m, mesh),
             'tp_fsdp': lambda m: parallel.fsdp_shardings(
                 m, mesh, min_shard_elements=256, base_spec_fn=megatron_spec_fn())}
    out = {}
    for case in payload['cases']:
        dense, placed = _case_model(case), _case_model(case)
        shardings = rules[case['rule']](placed)
        specs = _specs(placed, shardings)
        report = parallel.fsdp_size_report(placed, shardings)
        parallel.place(placed, shardings)
        x = torch.tensor(case['inputs'])
        rows = x.shape[0] // 2
        mine = slice(data_index * rows, (data_index + 1) * rows)
        labels = torch.tensor(case['labels']).long()
        logits = placed(x[mine])
        want = dense(x[mine])
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels[mine].reshape(-1), reduction='sum') / labels.numel()
        loss.backward()
        parallel.reduce_gradients(placed, ('data',))
        blocks = parallel.local_blocks(placed)
        out[case['name']] = dict(
            specs=specs, report=report, rows=(mine.start, mine.stop),
            logits=_np(logits), unplaced_max_err=float((logits - want).abs().max().detach()),
            blocks={n: _np(t) for n, t in blocks.items()},
            grads={n: _np(t.grad) for n, t in blocks.items()},
            stored_bytes=sum(t.numel() * t.element_size() for t in blocks.values()))
    out['fsdp_tree'] = _fsdp_tree_cases(mesh, payload['fsdp_tree'])
    gen = payload['generate']
    model = TransformerLM(**gen['config'], compute_dtype=torch.float32)
    model.load_state_dict({k: torch.tensor(v) for k, v in gen['state'].items()})
    parallel.place(model, param_shardings(model, mesh))
    out['generate'] = _np(generate(model, torch.tensor(gen['prompt']), gen['new']))
    out['cache_heads'] = model.init_cache(1)[0].key.shape[2]
    return out


def _fsdp_tree_cases(mesh, params):
    """test_fsdp.py's cases on a tree of dicts: specs under each rule, the
    placed blocks, a product through the gathered kernel, the size report
    and the missing-axis refusal."""
    import torch

    from petastorm_tpu_torch import parallel
    from petastorm_tpu_torch.parallel import collectives
    from petastorm_tpu_torch.parallel.ring_attention import SeqAxis
    params = {k: {n: torch.tensor(v) for n, v in leaves.items()} for k, leaves in params.items()}

    def specs(tree):
        return {k: {n: tuple(s.spec) for n, s in v.items()} if isinstance(v, dict)
                else tuple(v.spec) for k, v in tree.items()}

    def base(path):
        return (None, 'model') if path[-1] == 'kernel' else ()

    shardings = parallel.fsdp_shardings(params, mesh)
    placed = parallel.device_put(params, shardings)
    kernel = placed['dense']['kernel']
    full = collectives.all_gather(kernel, SeqAxis(mesh, 'data'), 0)
    product = torch.ones(8, 512) @ full + placed['dense']['bias']
    return dict(
        default=specs(shardings),
        composed=specs(parallel.fsdp_shardings(params, mesh, base_spec_fn=base)),
        base_data=specs(parallel.fsdp_shardings(params, mesh, base_spec_fn=lambda p: ('data',))),
        indivisible=specs(parallel.fsdp_shardings({'odd': torch.zeros(17, 33)}, mesh,
                                                  min_shard_elements=1)),
        report=parallel.fsdp_size_report(params, shardings),
        kernel_block=tuple(kernel.shape), product=_np(product),
        stored_bytes=sum(t.numel() * t.element_size()
                         for v in placed.values() for t in v.values()),
        missing=_error(lambda: parallel.fsdp_shardings(params, mesh, data_axis='nope')))


# ---------------------------------------------------------------------------
# test_torch_pipeline_moe.py
# ---------------------------------------------------------------------------

def _stage_fn(params, x):
    import torch
    return torch.tanh(x @ params['w'] + params['b'])


def pipeline_moe_cases(rank, world, payload):
    """The 4-stage pipeline (outputs, this rank's stage gradients of
    ``sum(out ** 2)``, and Adam steps' losses) and the expert-parallel MoE
    on each mesh (this rank's outputs; on ``{'data': 2, 'expert': 2}`` the
    gradients of ``sum(out ** 2)`` summed over both axes, and a tight
    capacity), then the indivisible refusal."""
    import torch

    from petastorm_tpu_torch import parallel
    from petastorm_tpu_torch.models.moe import make_expert_parallel_moe
    pipe = payload['pipeline']
    mesh = parallel.make_mesh({'pipe': world})
    fn, stage_sharding = parallel.make_pipeline(mesh, _stage_fn)
    x = torch.tensor(pipe['x'])
    stacked = {k: torch.tensor(v) for k, v in pipe['params'].items()}
    mine = {k: v.requires_grad_() for k, v in parallel.device_put(stacked, stage_sharding).items()}
    out = fn(mine, x)
    (out ** 2).sum().backward()
    res = {'pipeline': dict(out=_np(out), grads={k: _np(v.grad) for k, v in mine.items()},
                            block={k: _np(v) for k, v in mine.items()})}
    mine = {k: v.detach().clone().requires_grad_() for k, v in
            parallel.device_put(stacked, stage_sharding).items()}
    opt = torch.optim.Adam(mine.values(), lr=1e-2)
    y = torch.tensor(pipe['y'])
    losses = []
    for _ in range(pipe['steps']):
        loss = ((fn(mine, x) - y) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss))
    res['pipeline']['losses'] = losses
    moe = payload['moe']
    params = {k: torch.tensor(v) for k, v in moe['params'].items()}
    tokens = torch.tensor(moe['tokens'])
    res['moe'] = {}
    for label, axes, factor, grads in moe['cases']:
        mesh = parallel.make_mesh(dict(axes))
        fn, shardings_fn, token_sharding = make_expert_parallel_moe(
            mesh, moe['experts'], capacity_factor=factor)
        shardings = shardings_fn(params)
        placed = {k: v.requires_grad_() for k, v in
                  parallel.device_put(params, shardings).items()}
        index = token_sharding.index(tuple(tokens.shape))
        y = fn(placed, tokens[index])
        case = dict(index=index, out=_np(y))
        if grads:
            (y ** 2).sum().backward()
            parallel.reduce_gradients(placed, ('data', 'expert'), shardings)
            case['grads'] = {k: _np(v.grad) for k, v in placed.items()}
            case['param_index'] = {k: s.index(tuple(params[k].shape))
                                   for k, s in shardings.items()}
        res['moe'][label] = case
    res['indivisible'] = _error(lambda: make_expert_parallel_moe(
        parallel.make_mesh({'expert': world}), num_experts=6))
    return res


# ---------------------------------------------------------------------------
# test_torch_data_parallel.py
# ---------------------------------------------------------------------------

def ordered_image_training(payload, patch=setattr):
    """Make ``train.train`` read in row-group order on the dummy pool,
    start from the payload's parameters and record each batch its step
    takes (this rank's rows); returns the list the batches go to.
    ``patch(module, name, value)`` sets each replacement (a test passes
    ``monkeypatch.setattr``)."""
    import torch

    import petastorm_tpu_torch.train as image_train
    from petastorm_tpu_torch.reader import make_reader
    seen = []
    seeded, check = image_train._make_model, image_train._check_batch

    def ordered(*args, **kwargs):
        kwargs.update(reader_pool_type='dummy', shuffle_row_groups=False)
        return make_reader(*args, **kwargs)

    def model_from_params(*args):
        model = seeded(*args)
        model.load_state_dict({k: torch.tensor(v) for k, v in payload['state'].items()})
        return model

    def record(batch, device, devices):
        seen.append({k: _np(v) for k, v in batch.items()})
        check(batch, device, devices)

    patch(image_train, 'make_reader', ordered)
    patch(image_train, '_make_model', model_from_params)
    patch(image_train, '_check_batch', record)
    return seen


def data_parallel_cases(rank, world, payload):
    """``train.train`` at world 2 (losses, batches seen, final state), the
    BatchNorm on this rank's half (output, input and parameter gradients,
    running statistics), ``scan_batches(sharding=)``'s blocks, and the
    refusals."""
    import torch

    import petastorm_tpu_torch.train as image_train
    from petastorm_tpu_torch import parallel
    from petastorm_tpu_torch.gpu import DataLoader
    from petastorm_tpu_torch.models.resnet import BatchNorm, sync_batch_norm
    from petastorm_tpu_torch.parallel.ring_attention import SeqAxis
    from petastorm_tpu_torch.reader import make_reader
    seen = ordered_image_training(payload)
    run = image_train.train(payload['url'], payload['steps'], batch_size=payload['batch'],
                            image_hw=payload['hw'], device='cpu', workers_count=1,
                            model_kwargs=dict(num_classes=10, dtype=torch.float32))
    res = dict(losses=run['losses'], batches=list(seen), data_ranks=run['data_ranks'],
               state={k: _np(v) for k, v in run['model'].state_dict().items()})
    del seen[:]
    scan = image_train.train(payload['url'], payload['scan_k'], batch_size=payload['batch'],
                             image_hw=payload['hw'], device='cpu', workers_count=1,
                             scan_steps=payload['scan_k'],
                             model_kwargs=dict(num_classes=10, dtype=torch.float32))
    res['scan_run'] = dict(losses=scan['losses'], batches=list(seen))

    mesh = parallel.make_mesh()
    axis = SeqAxis(mesh, 'data')
    bn = payload['bn']
    norm = BatchNorm(bn['x'].shape[1], torch.float32)
    norm.load_state_dict({k: torch.tensor(v) for k, v in bn['state'].items()})
    sync_batch_norm(norm, axis)
    half = bn['x'].shape[0] // world
    rows = slice(rank * half, (rank + 1) * half)
    x = torch.tensor(bn['x'][rows], requires_grad=True)
    y = norm(x)
    (y * torch.tensor(bn['ct'][rows])).sum().backward()
    grads = torch.cat([norm.scale.grad, norm.bias.grad])
    torch.distributed.all_reduce(grads)
    res['bn'] = dict(y=_np(y), dx=_np(x.grad), dscale=_np(grads[:norm.scale.numel()]),
                     dbias=_np(grads[norm.scale.numel():]),
                     running_mean=_np(norm.running_mean), running_var=_np(norm.running_var))

    reader = make_reader(payload['url'], schema_fields=['image', 'noun_id'],
                         transform_spec=image_train.make_transform(payload['hw']),
                         columnar_decode=True, reader_pool_type='dummy',
                         shuffle_row_groups=False, num_epochs=1)
    sharding = parallel.data_parallel_sharding(mesh)
    chunks = []
    with DataLoader(reader, payload['batch'] // world, device='cpu', sharding=sharding) as loader:
        for _, outs in loader.scan_batches(
                lambda carry, batch: (carry, {k: v.to_local() for k, v in batch.items()}),
                None, steps_per_call=payload['scan_k']):
            chunks.append({k: _np(v) for k, v in outs.items()})
            if len(chunks) == payload['scan_chunks']:
                break
    res['scan'] = chunks
    res['refusals'] = dict(
        hbm_cache=_error(lambda: image_train.train(payload['url'], 1, batch_size=4,
                                                   device='cpu', hbm_cache=True)),
        indivisible=_error(lambda: image_train.train(payload['url'], 1, batch_size=3,
                                                     device='cpu')))
    return res
