"""Elastic resharding of reader and loader checkpoints.

Counterpart of ``petastorm_tpu/elastic.py`` (a copy: the port imports
nothing of the JAX package).  Static ``cur_shard``/``shard_count`` sharding
means a job checkpointed on K hosts resumes only on K hosts; this module
maps the K reader tokens (:meth:`petastorm_tpu_torch.reader.Reader.state_dict`)
or loader tokens (:meth:`petastorm_tpu_torch.gpu.DataLoader.state_dict`) of
one checkpoint onto any new shard count M.  Every remaining row group is
read by exactly one new shard; row groups in flight at snapshot time may
repeat, as on a same-topology resume.

How it works
------------

A reader token carries its shard topology (``cur_shard``, ``shard_count``,
``num_global_pieces``, ``drop_partitions``, ``shuffle``, ``seed``,
``num_epochs``) beside the ventilator position ``(epoch, cursor)``.  The
per-epoch work order is a pure function of ``(seed, epoch)`` over a
deterministic item list, so the remaining work of every old shard is
rebuilt offline, with no reader alive:

1. For each old shard, rebuild its item list (global piece indices of the
   shard, through :func:`petastorm_tpu_torch.reader._shard_indices`, ×
   drop partitions) and replay its epoch permutations up to the resume
   horizon; everything past the token is remaining.
2. Epochs that no old shard has touched (``>= e_cont``) resume as regular
   epochs under the new topology: each new shard permutes its own items
   as a fresh run would.
3. The ragged part, the current epochs' tails and any epochs some shards
   already finished, becomes a **prologue**: a flat list of global work
   items dealt round-robin across the M new tokens.  The new readers
   dispatch it first (the ventilator's prologue positions), then fall into
   the regular epochs.

The new tokens plug into ``make_reader(..., cur_shard=m, shard_count=M,
resume_state=token_m)``.  Readers keep the global piece list in their
worker arguments so that a prologue can name any row group.

Loader tokens also carry decoded rows drained out of the worker pool;
:func:`reshard_loader_states` deals those out too, so nothing is lost when
checkpoints are taken mid-stream through the exact-resume path.
"""

import numpy as np

_TOPOLOGY_KEYS = ('num_global_pieces', 'drop_partitions', 'shuffle')


def _as_int(value):
    return None if value is None else int(value)


def _local_items(num_global_pieces, drop_partitions, cur_shard, shard_count,
                 shard_seed=None):
    """The work-item list of one shard: the readers' own sharding
    (``reader._shard_indices``) derives the indices, so the reconstruction
    cannot drift from what they ran (items = sharded global indices × drop
    partitions)."""
    from petastorm_tpu_torch.reader import _shard_indices
    indices = _shard_indices(num_global_pieces, cur_shard, shard_count,
                             shard_seed=shard_seed)
    return [(i, p) for i in indices for p in range(max(1, drop_partitions))]


def _epoch_order(items, shuffle, seed, epoch):
    """The ventilator's own order (the seed normalized as
    ``ConcurrentVentilator.__init__`` does)."""
    from petastorm_tpu_torch.workers_pool.ventilator import epoch_order
    return epoch_order(items, shuffle, seed or 0, epoch)


def _normalized(states):
    """Validate + order the K old tokens by cur_shard; returns (ordered
    states, shared topology dict)."""
    if not states:
        raise ValueError('need at least one reader state')
    for s in states:
        missing = [k for k in _TOPOLOGY_KEYS + ('shard_count', 'cur_shard')
                   if k not in s]
        if missing:
            raise ValueError(
                'state lacks topology keys %s — tokens must come from '
                'Reader.state_dict() of this framework (the reference-style '
                'bare (epoch, cursor) token is not re-shardable)' % missing)
    shard_count = _as_int(states[0]['shard_count'])
    if shard_count is None and len(states) != 1:
        raise ValueError('unsharded readers (shard_count=None) checkpoint '
                         'as a single state')
    if shard_count is not None and len(states) != shard_count:
        raise ValueError('got %d states for shard_count=%s — pass every '
                         'shard\'s token' % (len(states), shard_count))
    shared = {k: states[0][k] for k in _TOPOLOGY_KEYS}
    shared['num_epochs'] = states[0].get('num_epochs')
    # Tokens predating shard_seed simply lack the key (None = unpermuted).
    shared['shard_seed'] = _as_int(states[0].get('shard_seed'))
    shared['shard_scheme'] = states[0].get('shard_scheme')
    if shared['shard_seed'] is not None \
            and shared['shard_scheme'] != 'rs-perm-v1':
        raise ValueError(
            'tokens carry shard_seed=%r under permutation scheme %r, but '
            'this build computes rs-perm-v1 — resharding them would '
            'reconstruct the wrong old-shard partitions'
            % (shared['shard_seed'], shared['shard_scheme']))
    for s in states:
        if _as_int(s['shard_count']) != shard_count:
            raise ValueError('states disagree on shard_count')
        if bool(s['shuffle']) != bool(shared['shuffle']) \
                or _as_int(s['num_global_pieces']) != _as_int(shared['num_global_pieces']) \
                or _as_int(s['drop_partitions']) != _as_int(shared['drop_partitions']):
            raise ValueError('states disagree on dataset topology')
        if s.get('num_epochs') != shared['num_epochs']:
            raise ValueError('states disagree on num_epochs')
        if s.get('shard_scheme') != shared['shard_scheme']:
            # every state must agree, or input order would decide whether
            # an unmarked token turns into a marked one
            raise ValueError('states disagree on shard_scheme (%r vs %r)'
                             % (s.get('shard_scheme'),
                                shared['shard_scheme']))
        if _as_int(s.get('shard_seed')) != shared['shard_seed']:
            raise ValueError('states disagree on shard_seed — the shard '
                             'partition itself would differ')
        if s.get('seed') != states[0].get('seed'):
            # every new token gets shard 0's seed: per-shard seeds would
            # change the regular epochs' orders against a same-topology
            # resume (the coverage stays exact, the order does not)
            raise ValueError('states disagree on seed (%r vs %r) — '
                             'per-shard seeds cannot be resharded '
                             'faithfully' % (s.get('seed'),
                                             states[0].get('seed')))
    if shard_count is None:
        return list(states), shared
    by_shard = {}
    for s in states:
        cs = _as_int(s['cur_shard'])
        if cs in by_shard:
            raise ValueError('duplicate state for shard %d' % cs)
        by_shard[cs] = s
    if sorted(by_shard) != list(range(shard_count)):
        raise ValueError('states cover shards %s, expected 0..%d'
                         % (sorted(by_shard), shard_count - 1))
    return [by_shard[s] for s in range(shard_count)], shared


def reshard_reader_states(states, new_shard_count):
    """Map the K tokens of one checkpoint onto ``new_shard_count`` tokens.

    Args:
        states: one ``Reader.state_dict()`` per old shard (any order).
            For a handoff without loss take them after
            ``drain_in_flight()``, or reshard the loader states
            (:func:`reshard_loader_states`), which are drained.
        new_shard_count: the new topology's shard count (M >= 1).

    Returns:
        A list of M resume-state dicts; build the new readers with
        ``make_reader(url, cur_shard=m, shard_count=M,
        resume_state=result[m], ...)`` and the same dataset-shaping
        arguments (``filters``, ``num_epochs``) as the original readers:
        the global piece list must be identical for global indices to
        line up.

    Every remaining (epoch, row-group) work item lands in exactly one new
    token: ragged current-epoch tails as prologue work, fully-unstarted
    epochs as regular epochs under the new sharding.
    """
    if new_shard_count < 1:
        raise ValueError('new_shard_count must be >= 1')
    ordered, shared = _normalized(states)
    num_pieces = _as_int(shared['num_global_pieces'])
    drop = _as_int(shared['drop_partitions'])
    shuffle = bool(shared['shuffle'])
    num_epochs = shared['num_epochs']
    num_epochs = None if num_epochs is None else int(num_epochs)
    old_count = _as_int(ordered[0]['shard_count'])

    # First epoch that NO old shard has touched: those resume as regular
    # epochs under the new topology.
    def _touched_through(s):
        e, c = int(s['epoch']), int(s['cursor'])
        return e + 1 if (c > 0 or s.get('prologue')) else e

    e_cont = max(_touched_through(s) for s in ordered)
    if num_epochs is not None:
        e_cont = min(e_cont, num_epochs)

    prologue = []
    for idx, s in enumerate(ordered):
        cur_shard = None if old_count is None else idx
        items = _local_items(num_pieces, drop, cur_shard, old_count,
                             shard_seed=shared['shard_seed'])
        seed = s.get('seed') or 0
        prologue.extend(tuple(map(int, it)) for it in (s.get('prologue') or ()))
        epoch, cursor = int(s['epoch']), int(s['cursor'])
        for e in range(epoch, e_cont):
            order = _epoch_order(items, shuffle, seed, e)
            prologue.extend(order[cursor if e == epoch else 0:])

    seed = ordered[0].get('seed')
    out = []
    for m in range(new_shard_count):
        token = {'epoch': e_cont, 'cursor': 0, 'seed': seed,
                 'prologue': prologue[m::new_shard_count],
                 'cur_shard': m, 'shard_count': new_shard_count,
                 'num_epochs': num_epochs}
        token.update({k: shared[k] for k in _TOPOLOGY_KEYS})
        token['shard_seed'] = shared['shard_seed']
        token['shard_scheme'] = shared['shard_scheme']
        out.append(token)
    return out


def reshard_weighted_states(states, new_shard_count, seed=None):
    """Re-shard the JAX package's ``WeightedSamplingReader.state_dict()``
    checkpoints (a pure function of the tokens; the mixer itself is not in
    the port yet).

    Each constituent source's K tokens reshard independently through
    :func:`reshard_reader_states`; the mixer's draw stream restarts fresh
    on every new host (seeded ``(seed, shard)`` when ``seed`` is given) —
    mixing is probabilistic, so the contractual object is the
    constituent-row multiset, which the resharded tokens preserve exactly
    as in the single-reader case.  A source stays active if ANY old host
    still had it active; relative weights are recovered from the old
    states (every host renormalizes the same original probabilities, so
    overlapping actives agree on ratios).

    Each new host's mixer resumes from ``result[m]``, its source ``j``
    built with ``resume_state=result[m]['constituents'][j]`` and the new
    shard topology.
    """
    if not states:
        raise ValueError('need at least one mixer state')
    n_sources = {len(s['constituents']) for s in states}
    if len(n_sources) != 1:
        raise ValueError('mixer states disagree on constituent count')
    n = n_sources.pop()
    new_constituents = [
        reshard_reader_states([s['constituents'][j] for s in states],
                              new_shard_count)
        for j in range(n)]
    active = sorted({int(i) for s in states for i in s['active']})
    # the ratios come from the mixture before normalization, the same on
    # every host: per-host 'weights' are renormalized over that host's
    # surviving sources
    orig = next((s.get('orig_weights') for s in states
                 if s.get('orig_weights') is not None), None)
    if orig is None:
        raise ValueError(
            "mixer states lack 'orig_weights' (pre-dating the elastic "
            'protocol); re-checkpoint with a current '
            'WeightedSamplingReader before resharding')
    weights = np.asarray([float(orig[i]) for i in active], np.float64)
    weights = (weights / weights.sum()).tolist() if len(weights) else []
    out = []
    for m in range(new_shard_count):
        rng = np.random.default_rng(None if seed is None else (seed, m))
        out.append({
            'constituents': [new_constituents[j][m] for j in range(n)],
            'rng_state': rng.bit_generator.state,
            'weights': weights,
            # a second reshard before training resumes is legal
            'orig_weights': [float(v) for v in orig],
            'active': list(active),
        })
    return out


def reshard_loader_states(states, new_shard_count, batched=None):
    """Re-shard ``DataLoader.state_dict()`` checkpoints onto M loaders.

    Loader states are exact (the reader was drained into them), so this is
    the elastic path without loss: reader tokens go through
    :func:`reshard_reader_states`; every buffered datum is dealt out
    round-robin.  Batches already moved to the device stay whole batches
    (host copies, filtered to numeric fields) and re-enter through the new
    loaders' ``pending``; host-side rows and chunks (drained pushback, the
    partial batch, the shuffling buffer, the columnar chunk residue and
    the columnar shuffle's rows) re-enter through ``pushback``.

    Args:
        states: one ``DataLoader.state_dict()`` per old shard.
        new_shard_count: M.
        batched: True for columnar loaders (``make_batch_reader`` or
            ``columnar_decode`` underneath), False for row loaders.
            Defaults to the ``'batched'`` flag stored in the states.

    Returns M loader resume-state dicts: pass ``resume_state=result[m]``
    to the new ``DataLoader`` built over
    ``make_reader(..., cur_shard=m, shard_count=M,
    resume_state=result[m]['reader'])``.

    Dealing rows out changes the delivery order (rows buffered on one host
    may surface on another), so a seeded resume keeps its order only on an
    unchanged topology; no row is lost for any M.  NGram loader states are
    rejected (windows are not flat rows).
    """
    for s in states:
        if 'reader' not in s:
            raise ValueError('not a DataLoader state (no reader token); for '
                             'bare reader tokens use reshard_reader_states')
    if batched is None:
        flags = {bool(s.get('batched', False)) for s in states}
        if len(flags) != 1:
            raise ValueError('states disagree on batched=; pass it explicitly')
        batched = flags.pop()

    new_readers = reshard_reader_states([s['reader'] for s in states],
                                        new_shard_count)

    loose = []    # row dicts (row mode) or chunk dicts (columnar mode)
    pending = []  # whole prefetched batches, redistributed batch-wise
    for s in states:
        loose.extend(s.get('pushback') or ())
        pending.extend(s.get('pending') or ())
        if not batched:
            loose.extend(s.get('partial_rows') or ())
            buf = s.get('shuffle_buffer')
            if buf:
                loose.extend(buf.get('items') or ())
        else:
            for chunk in s.get('chunks') or ():
                loose.append(chunk)
            colsh = s.get('col_shuffle')
            if colsh and colsh.get('columns') is not None:
                loose.append(dict(colsh['columns']))
    if not batched:
        for item in loose:
            if isinstance(item, dict) \
                    and any(isinstance(v, dict) for v in item.values()):
                raise ValueError('elastic reshard does not support NGram '
                                 'loader states (windows are nested, not '
                                 'flat rows)')

    out = []
    for m in range(new_shard_count):
        out.append({
            'version': 1,
            'batched': batched,
            'reader': new_readers[m],
            'pushback': loose[m::new_shard_count],
            'pending': pending[m::new_shard_count],
            'partial_rows': [],
            'shuffle_buffer': None,
            'chunks': [],
            'col_shuffle': None,
        })
    return out
