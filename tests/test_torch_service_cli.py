"""The port's command line (``python -m petastorm_tpu_torch.service.cli``)
and worker knobs against the JAX package's, on the CPU.

Against JAX: every subcommand's flags, each set away from its default, parse
to the same arguments, and the ``dispatcher`` and ``worker`` subcommands
build the same ``ServiceConfig`` (its ``job_info``, fingerprint and every
knob, ``--ingest`` among them) and the same ``Worker`` arguments.  As processes: a dispatcher of the
command line with ``--autoscale`` spawns its worker (``cli worker``) and
serves ``/metrics``, and ``status``, ``drain``, ``clock`` and ``stop`` run
against it.  The knobs: a worker with ``max_inflight_splits=1`` never holds
two leases (the default holds up to three), and ``reader_factory=
'batch_reader'`` on plain Parquet delivers the rows of JAX's batch reader.
"""

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.service import cli as jax_cli

from petastorm_tpu_torch.service import Dispatcher, ServiceConfig, ServiceDataLoader, Worker
from petastorm_tpu_torch.service import cli

from torch_plane_common import write_dataset
from torch_service_common import REPO, free_tcp_addr, watched, write_raw

ROWS = 96
BATCH = 8


def _subcommands(parser):
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _flag_cases():
    """(subcommand, flag) for every optional flag of the reference."""
    cases = []
    for name, sub in sorted(_subcommands(jax_cli._build_parser()).items()):
        for action in sub._actions:
            if action.option_strings and action.dest != 'help':
                cases.append((name, action.option_strings[0]))
    return cases


_REQUIRED = {'dispatcher': ['--dataset-url', 'file:///data/train'],
             'worker': ['--dispatcher', 'tcp://d:1'], 'status': ['--dispatcher', 'tcp://d:1'],
             'drain': ['--dispatcher', 'tcp://d:1', '--worker', 'w3'],
             'stop': ['--dispatcher', 'tcp://d:1'], 'clock': ['--dispatcher', 'tcp://d:1']}


def _argv(command, flag):
    """The subcommand's required flags and ``flag`` away from its default."""
    action = next(a for a in _subcommands(jax_cli._build_parser())[command]._actions
                  if flag in a.option_strings)
    argv = [command] + [a for a in _REQUIRED[command]]
    if flag in argv:
        i = argv.index(flag)
        argv[i + 1] = argv[i + 1] + 'x'
        return argv
    if isinstance(action, argparse._StoreTrueAction):
        return argv + [flag]
    if action.choices:
        return argv + [flag, [c for c in action.choices if c != action.default][-1]]
    if action.type is int:
        return argv + [flag, '3']
    if action.type is float:
        return argv + [flag, '2.5']
    return argv + [flag, 'tcp://127.0.0.1:9' if 'bind' in flag else '/tmp/%s' % flag[2:]]


def test_the_subcommands_and_flags_are_jax_s():
    ours, ref = _subcommands(cli._build_parser()), _subcommands(jax_cli._build_parser())
    assert sorted(ours) == sorted(ref) == ['clock', 'dispatcher', 'drain', 'status', 'stop',
                                           'worker']
    for name in ref:
        flags = [(a.option_strings, a.default, a.required, a.choices, a.type)
                 for a in ref[name]._actions]
        assert [(a.option_strings, a.default, a.required, a.choices, a.type)
                for a in ours[name]._actions] == flags


class _Built(Exception):
    pass


def _captured(main, monkeypatch, module, name, argv):
    """What ``main(argv)`` hands ``module.name`` (patched to capture it)."""
    seen = {}

    def capture(*args, **kwargs):
        seen.update(args=args, kwargs=kwargs)
        raise _Built()
    monkeypatch.setattr(module, name, capture)
    with pytest.raises(_Built):
        main(argv)
    return seen


@pytest.mark.parametrize('command,flag', _flag_cases())
def test_each_flag_parses_and_builds_as_jax(command, flag, monkeypatch):
    import petastorm_tpu.service as jax_service

    import petastorm_tpu_torch.service.dispatcher as port_dispatcher
    import petastorm_tpu_torch.service.worker as port_worker
    argv = _argv(command, flag)
    assert vars(cli._build_parser().parse_args(argv)) == \
        vars(jax_cli._build_parser().parse_args(argv))
    if command == 'dispatcher':
        ours = _captured(cli.main, monkeypatch, port_dispatcher, 'Dispatcher', argv)
        ref = _captured(jax_cli.main, monkeypatch, jax_service, 'Dispatcher', argv)
        assert ours['kwargs'] == ref['kwargs']
        (ours,), (ref,) = ours['args'], ref['args']
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.job_info(4) == ref.job_info(4)
        assert ours.fingerprint(4) == ref.fingerprint(4)
    elif command == 'worker':
        ours = _captured(cli.main, monkeypatch, port_worker, 'Worker', argv)
        ref = _captured(jax_cli.main, monkeypatch, jax_service, 'Worker', argv)
        assert ours == ref


# -- the command line's processes ------------------------------------------------

def _cli(*argv, timeout=60):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES='')
    return subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.service.cli'] + list(argv),
                          env=env, capture_output=True, text=True, timeout=timeout)


def _read_line(proc, pattern, deadline):
    """The first stdout line of ``proc`` matching ``pattern``."""
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        match = re.search(pattern, line)
        if match:
            return match
    raise AssertionError('no line matching %r' % pattern)


@watched(120)
def test_the_command_line_runs_and_inspects_an_autoscaled_fleet(tmp_path):
    url = write_dataset('file://%s' % (tmp_path / 'ds'), rows=ROWS)
    addr = free_tcp_addr()
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES='')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'petastorm_tpu_torch.service.cli', 'dispatcher', '--bind', addr,
         '--dataset-url', url, '--lease-ttl-s', '2', '--autoscale', '--autoscale-max-workers',
         '1', '--autoscale-starve-s', '0', '--metrics-port', '0'],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        deadline = time.monotonic() + 60
        port = int(_read_line(proc, r'metrics on http://0.0.0.0:(\d+)/metrics', deadline)
                   .group(1))
        assert _read_line(proc, r'dispatcher serving (\S+) \(6 splits', deadline).group(1) == addr
        # nothing alive and work pending: the autoscaler spawns a `cli worker`
        while time.monotonic() < deadline:
            status = json.loads(_cli('status', '--dispatcher', addr).stdout)
            if status['workers']:
                break
            time.sleep(0.2)
        assert list(status['workers']) == ['w0'], status['workers']
        assert status['autoscale']['scale_outs'] == 1
        assert status['decisions']['autoscaler']['actions'] == 1
        body = urllib.request.urlopen('http://127.0.0.1:%d/metrics' % port, timeout=10).read()
        assert b'petastorm_tpu_decisions_actions_total{actor="autoscaler"} 1' in body
        clock = json.loads(_cli('clock', '--dispatcher', addr, '--samples', '3').stdout)
        assert clock['samples'] == 3 and clock['rtt_s'] > 0 and abs(clock['offset_s']) < 1.0
        refused = _cli('drain', '--dispatcher', addr, '--worker', 'w9')
        assert refused.returncode == 1 and 'drain refused' in refused.stderr
        drained = _cli('drain', '--dispatcher', addr, '--worker', 'w0')
        assert drained.returncode == 0 and 'worker w0 draining' in drained.stdout
        while time.monotonic() < deadline:
            if 'w0' not in json.loads(_cli('status', '--dispatcher', addr).stdout)['workers']:
                break
            time.sleep(0.2)
        stats = json.loads(_cli('status', '--dispatcher', addr).stdout)
        assert stats['control_plane']['drains'] == 1
        stopped = _cli('stop', '--dispatcher', addr)
        assert stopped.returncode == 0 and 'stopped' in stopped.stdout
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


# -- the worker knobs -------------------------------------------------------------

def _leases_held(url, max_inflight_splits):
    """The most leases one worker held while a slow consumer read an epoch;
    the ids it read."""
    config = ServiceConfig(url, rowgroups_per_split=1, lease_ttl_s=2.0,
                           reader_kwargs={'workers_count': 1})
    most, ids, done = 0, [], threading.Event()
    with Dispatcher(config) as dispatcher:
        with Worker(dispatcher.addr, max_inflight_splits=max_inflight_splits,
                    max_buffered_chunks=2) as worker:
            assert worker._decode_out.maxsize == 2

            def watch():
                nonlocal most
                while not done.is_set():
                    most = max(most, dispatcher._op_stats({})['leased'])
                    time.sleep(0.01)
            watcher = threading.Thread(target=watch, daemon=True)
            watcher.start()
            loader = ServiceDataLoader(dispatcher.addr, BATCH, consumer=0, device='cpu',
                                       queue_splits=1, credits=1)
            with loader:
                for batch in loader.iter_host_batches():
                    ids.extend(batch['id'].tolist())
                    time.sleep(0.05)
            done.set()
            watcher.join()
    return most, ids


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    return write_dataset('file://%s' % tmp_path_factory.mktemp('torch_cli'), rows=ROWS)


@watched(60)
def test_max_inflight_splits_bounds_a_workers_leases(url):
    one, ids = _leases_held(url, 1)
    assert one == 1 and sorted(ids) == list(range(ROWS))
    three, ids = _leases_held(url, 3)
    assert 2 <= three <= 3 and sorted(ids) == list(range(ROWS))


@watched(60)
def test_the_batch_reader_factory_delivers_jax_s_rows(tmp_path):
    raw = write_raw(str(tmp_path / 'raw'), rows=48, group=8)
    with jax_make_batch_reader(raw, reader_pool_type='dummy', shuffle_row_groups=False,
                               scheduling='fifo', ingest='off') as reader:
        want = {}
        for chunk in reader:
            for i, img in zip(chunk.id.tolist(), chunk.img):
                want[i] = np.asarray(img)
    config = ServiceConfig(raw, rowgroups_per_split=2, lease_ttl_s=2.0,
                           reader_factory='batch_reader', reader_kwargs={'workers_count': 1})
    got = {}
    with Dispatcher(config) as dispatcher, Worker(dispatcher.addr) as worker:
        with ServiceDataLoader(dispatcher.addr, BATCH, consumer=0, device='cpu') as loader:
            for batch in loader.iter_host_batches():
                for i, img in zip(batch['id'].tolist(), batch['img']):
                    got[i] = np.asarray(img)
        assert worker._reader_factories['default'].__name__ == 'make_batch_reader'
    assert sorted(got) == sorted(want) == list(range(48))
    assert all(np.array_equal(got[i], want[i]) for i in want)
