"""The data service's chaos plane: named injection seams, seeded scenarios,
and the matrix runner.

Counterpart of ``petastorm_tpu/test_util/chaos.py`` (with the flaky
filesystems its ``fault_injection.py`` re-exports).

* **Seams**: named injection points in the service where faults enter (the
  table below is the contract).  An inert seam is one ``is None`` check;
  a fault spec is armed in-process (:func:`activate`) or through the
  ``PETASTORM_TPU_CHAOS`` environment variable (a JSON spec: how faults
  reach the worker processes), seeded so that a scenario replays the same.
* **Scenarios**: a seeded spec of faults (seam, action, probability,
  budget), process kills at named phases of an epoch (read from the
  dispatcher's ``stats``, never from sleeps), and config overrides (a tiny
  shm arena is ENOSPC, tiny plane tiers a full plane).
* **The runner**: one epoch of a real service (a dispatcher, decode workers
  in processes of their own, a ``ServiceDataLoader`` on the CPU) under each
  scenario, holding three invariants: the **delivery digest** equals the
  direct read's, every row id arrives **exactly once**, and **zero
  residue** (no shm slab of the run's processes, no ledger tmp file).

========================  =======================  ======================
seam                      fired from               actions
========================  =======================  ======================
``rpc.request``           ``_Rpc.call`` (worker    ``drop`` (a timeout on
                          and client RPCs)         a rebuilt socket),
                                                   ``delay``
``dispatcher.rpc``        the dispatcher's serve   ``delay`` (a REP socket
                          loop, before dispatch    may not drop a reply)
``worker.chunk``          a chunk's send (byte-    ``drop``, ``dup``,
                          path frames only)        ``delay``
``worker.decode``         the decode of each       ``delay``, ``error``
                          leased split             (the lease expires)
``fs.open`` / ``fs.read`` the flaky filesystems    raise ``OSError``
========================  =======================  ======================

``materialize_kill`` runs no fleet: it SIGKILLs a materialize controller in
a child process mid-publish, restarts it on its ledger, and reads the store
through the warmed plane (:func:`run_scenario` hands it to its own runner).
``fetch_latency_spike`` puts the cold-store
emulation (:mod:`~petastorm_tpu_torch.test_util.emulation`) under every
split reader.  Run as ``python -m
petastorm_tpu_torch.test_util.chaos list|run|matrix``.  The module's imports
are standard library only (the service imports it); numpy and pyarrow load
inside the runner.
"""

import json
import logging
import os
import random
import threading
import time

logger = logging.getLogger(__name__)

__all__ = ['activate', 'deactivate', 'active', 'inject', 'ChaosState', 'SEAMS', 'SCENARIOS',
           'SMOKE_SCENARIOS', 'FILESYSTEM_FAULTS', 'DeliveryDigest', 'direct_read_digest',
           'run_scenario', 'run_matrix', 'render_report', 'main', 'is_data_file',
           'FlakyOpenFilesystem', 'FlakyReadFilesystem', 'make_chaos_dataset']

#: The seams the instrumentation fires.  A spec naming another warns: a
#: typo'd seam injecting nothing is the least debuggable chaos of all.
SEAMS = ('rpc.request', 'dispatcher.rpc', 'worker.chunk', 'worker.decode', 'fs.open', 'fs.read')

_ACTIONS = ('drop', 'dup', 'delay', 'error')

#: The seams whose caller models a failure (a decode error expires the
#: lease; a filesystem error meets the retries).  ``error`` elsewhere would
#: unwind a loop with no handler, so such a spec is refused.
_ERROR_SEAMS = ('worker.decode', 'fs.open', 'fs.read')

#: The environment variable carrying a JSON fault spec into child processes,
#: the per-process salt of their RNG streams, and the path prefix under
#: which an armed process dumps its injection counts at a clean exit
#: (``<prefix>.<pid>.json``).
CHAOS_ENV = 'PETASTORM_TPU_CHAOS'
CHAOS_SALT_ENV = 'PETASTORM_TPU_CHAOS_SALT'
CHAOS_COUNTS_ENV = 'PETASTORM_TPU_CHAOS_COUNTS'


class ChaosInjectedError(OSError):
    """The failure an ``error`` action raises."""


class ChaosState(object):
    """One armed fault spec: a seeded RNG and per-fault budgets and counts.

    ``spec``: ``{'seed': int, 'faults': [{'seam', 'action', 'p', 'delay_s',
    'max', 'ops'}, ...]}``: ``p`` the probability per call (1), ``max`` the
    budget (unbounded), ``ops`` the seam contexts' ``op`` values it fires on
    (all).  The same spec and salt fire the same sequence as the
    reference's.
    """

    def __init__(self, spec, salt=0):
        self.spec = dict(spec or {})
        self.seed = int(self.spec.get('seed', 0))
        self.rng = random.Random((self.seed, int(salt)).__repr__())
        self.counts = {}
        self._lock = threading.Lock()
        self._by_seam = {}
        for fault in self.spec.get('faults') or ():
            seam = fault.get('seam')
            action = fault.get('action')
            if seam not in SEAMS:
                logger.warning('chaos fault names unknown seam %r (known: %s); it will never '
                               'fire', seam, ', '.join(SEAMS))
            if action not in _ACTIONS:
                raise ValueError('chaos fault action must be one of %s, got %r'
                                 % (_ACTIONS, action))
            if action == 'error' and seam not in _ERROR_SEAMS:
                raise ValueError("action 'error' is only injectable at %s (seams whose caller "
                                 'models the failure); %r has no handler and the raise would '
                                 'kill the process, not fault it' % (_ERROR_SEAMS, seam))
            self._by_seam.setdefault(seam, []).append(dict(fault))

    def fire(self, seam, ctx):
        """The first matching fault's action for one pass through a seam
        (None: nothing).  ``delay`` sleeps here and returns ``'delay'``;
        ``error`` raises :class:`ChaosInjectedError`; ``drop`` and ``dup``
        return the word for the seam to act on."""
        faults = self._by_seam.get(seam)
        if not faults:
            return None
        for fault in faults:
            ops = fault.get('ops')
            if ops is not None and ctx.get('op') not in ops:
                continue
            with self._lock:
                budget = fault.get('max')
                key = (seam, fault.get('action'))
                if budget is not None and self.counts.get(key, 0) >= int(budget):
                    continue
                if self.rng.random() >= float(fault.get('p', 1.0)):
                    continue
                self.counts[key] = self.counts.get(key, 0) + 1
            action = fault['action']
            if action == 'delay':
                time.sleep(float(fault.get('delay_s', 0.05)))
                return 'delay'
            if action == 'error':
                raise ChaosInjectedError('chaos: injected error at seam %r (%r)' % (seam, ctx))
            return action
        return None

    def fired(self):
        """Injections across every fault."""
        with self._lock:
            return sum(self.counts.values())

    def dump_counts(self, prefix):
        """Write the counts to ``<prefix>.<pid>.json`` (best effort)."""
        from petastorm_tpu_torch.service.ledger import atomic_json_dump
        with self._lock:
            counts = {'%s/%s' % key: n for key, n in self.counts.items()}
        atomic_json_dump('%s.%d.json' % (prefix, os.getpid()), counts)


_ACTIVE = None


def activate(spec, salt=None):
    """Arm this process's chaos state (in place of any before); returns the
    :class:`ChaosState`."""
    global _ACTIVE
    if salt is None:
        salt = int(os.environ.get(CHAOS_SALT_ENV, '0') or 0)
    _ACTIVE = ChaosState(spec, salt=salt)
    return _ACTIVE


def deactivate():
    global _ACTIVE
    _ACTIVE = None


def active():
    """The armed :class:`ChaosState`, or None."""
    return _ACTIVE


def inject(seam, **ctx):
    """The call of an instrumentation point: None unless a spec is armed."""
    state = _ACTIVE
    if state is None:
        return None
    return state.fire(seam, ctx)


def _arm_from_env():
    """Arm from ``PETASTORM_TPU_CHAOS`` at import: how a fault spec reaches
    the processes the runner starts."""
    raw = os.environ.get(CHAOS_ENV)
    if not raw:
        return
    try:
        state = activate(json.loads(raw))
    except (ValueError, TypeError) as e:
        logger.warning('ignoring unparseable %s (%s)', CHAOS_ENV, e)
        return
    prefix = os.environ.get(CHAOS_COUNTS_ENV)
    if prefix:
        import atexit
        atexit.register(state.dump_counts, prefix)


_arm_from_env()


# -- the flaky filesystems -----------------------------------------------------

def is_data_file(path):
    """True for a row-group data file (``*.parquet``, not ``_``-prefixed):
    only those fail (the footer reads at a reader's construction have no
    retries)."""
    name = path.rsplit('/', 1)[-1]
    return name.endswith('.parquet') and not name.startswith('_')


class FlakyOpenFilesystem(object):
    """A delegating filesystem whose first ``fail_times`` opens of each data
    file raise ``OSError`` (the ``fs.open`` seam).  Pickles without its lock
    and its counts (the parent's footer read does not spend a child's
    budget)."""

    def __init__(self, real_fs, fail_times):
        self._real = real_fs
        self._fail_times = fail_times
        self._counts = {}
        self._lock = threading.Lock()

    def __getstate__(self):
        state = self.__dict__.copy()
        del state['_lock']
        del state['_counts']
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._counts = {}
        self._lock = threading.Lock()

    def open(self, path, *args, **kwargs):
        if is_data_file(path):
            with self._lock:
                n = self._counts.get(path, 0)
                self._counts[path] = n + 1
            if n < self._fail_times:
                inject('fs.open', path=path)
                raise OSError('injected transient open failure #%d on %s' % (n, path))
        return self._real.open(path, *args, **kwargs)

    def __getattr__(self, name):
        if name == '_real':   # mid-unpickle: not restored yet
            raise AttributeError(name)
        return getattr(self._real, name)


class FlakyReadFilesystem(FlakyOpenFilesystem):
    """The first open of each data file succeeds, and its handle dies at its
    first read (the ``fs.read`` seam)."""

    def open(self, path, *args, **kwargs):
        handle = self._real.open(path, *args, **kwargs)
        if is_data_file(path):
            with self._lock:
                n = self._counts.get(path, 0)
                self._counts[path] = n + 1
            if n < self._fail_times:
                return _DyingFile(handle)
        return handle


class _DyingFile(object):
    def __init__(self, inner):
        self._inner = inner

    def read(self, *args, **kwargs):
        inject('fs.read')
        raise OSError('injected read failure')

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _bandwidth_limited(*args, **kwargs):
    from petastorm_tpu_torch.test_util.emulation import BandwidthLimitedFilesystem
    return BandwidthLimitedFilesystem(*args, **kwargs)


#: The storage faults by name (a scenario's ``filesystem`` key).
FILESYSTEM_FAULTS = {
    'flaky_open': FlakyOpenFilesystem,
    'flaky_read': FlakyReadFilesystem,
    'bandwidth_limited': _bandwidth_limited,
}


# -- the delivery digest -------------------------------------------------------

class DeliveryDigest(object):
    """An order-independent, bit-exact digest of a delivered row stream.

    Per row, blake2b over each column's name and bytes; rows add modulo
    2^128 (so service delivery and the direct read digest alike), and the
    row count rides in the digest, so a duplicated row never cancels a
    missing one.  The reference's, byte for byte."""

    def __init__(self):
        self._sum = 0
        self.rows = 0

    def update(self, chunk):
        import hashlib

        import numpy as np
        names = sorted(chunk)
        cols = [np.asarray(chunk[name]) for name in names]
        for i in range(len(cols[0])):
            h = hashlib.blake2b(digest_size=16)
            for name, col in zip(names, cols):
                h.update(name.encode())
                h.update(np.ascontiguousarray(col[i]).tobytes())
            self._sum = (self._sum + int.from_bytes(h.digest(), 'little')) % (1 << 128)
            self.rows += 1

    def hexdigest(self):
        return '%032x:%d' % (self._sum, self.rows)


def direct_read_digest(dataset_url, reader_kwargs=None):
    """The truth: the dataset read directly (no service, no fault) through
    the port's batch reader, which the workers use too."""
    from petastorm_tpu_torch.reader import make_batch_reader
    digest = DeliveryDigest()
    kwargs = dict(reader_kwargs or {})
    kwargs.setdefault('workers_count', 1)
    with make_batch_reader(dataset_url, num_epochs=1, shuffle_row_groups=False,
                           **kwargs) as reader:
        for item in reader:
            digest.update(item._asdict() if hasattr(item, '_asdict') else dict(item))
    return digest.hexdigest()


# -- the scenarios -------------------------------------------------------------

#: The phases of an epoch a kill waits for, read from ``stats``:
#: ``registered`` (the fleet is up), ``leases`` (work in flight),
#: ``mid_epoch`` (some done and some left), ``tail`` (nothing pending).
PHASES = ('registered', 'leases', 'mid_epoch', 'tail')

_AUTOSCALE_STORM = {'autoscale': True, 'autoscale_min_workers': 1, 'autoscale_max_workers': 3,
                    'autoscale_step': 1, 'autoscale_cooldown_s': 1.0, 'autoscale_starve_s': 0.3,
                    'autoscale_idle_s': 3600.0}

#: The reference's scenarios.  Each runs one epoch and keeps the digest,
#: exactly-once and zero residue under its seed.
SCENARIOS = {
    'dispatcher_kill': {
        'summary': 'SIGKILL the dispatcher mid-epoch; restart it on the same port and ledger; '
                   'the epoch completes with no re-decode of done splits',
        'kills': [{'role': 'dispatcher', 'phase': 'mid_epoch', 'signal': 'kill',
                   'restart': True}],
        'dispatcher_subprocess': True,
    },
    'worker_kill': {
        'summary': 'SIGKILL one decode worker mid-epoch; the lease expires and the survivor '
                   're-decodes',
        'kills': [{'role': 'worker', 'phase': 'mid_epoch', 'signal': 'kill', 'restart': False}],
    },
    'worker_drain': {
        'summary': 'SIGTERM one decode worker mid-epoch; it drains gracefully: finishes or '
                   'hands back, zero residue',
        'kills': [{'role': 'worker', 'phase': 'mid_epoch', 'signal': 'term', 'restart': False}],
    },
    'message_drop': {
        'summary': 'drop data-plane chunks and control RPCs; resend and retry/backoff recover',
        'faults': [
            {'seam': 'worker.chunk', 'action': 'drop', 'p': 0.15, 'max': 30},
            {'seam': 'rpc.request', 'action': 'drop', 'p': 0.1, 'max': 15,
             'ops': ['heartbeat', 'workers', 'lease']},
        ],
        'config': {'shm': False},
    },
    'message_delay': {
        'summary': 'delay data-plane chunks and dispatcher RPC handling; nothing times out '
                   'into wrongness',
        'faults': [
            {'seam': 'worker.chunk', 'action': 'delay', 'p': 0.3, 'delay_s': 0.03, 'max': 60},
            {'seam': 'dispatcher.rpc', 'action': 'delay', 'p': 0.3, 'delay_s': 0.03,
             'max': 60},
        ],
        'config': {'shm': False},
    },
    'message_dup': {
        'summary': 'duplicate data-plane chunks; seq-keyed reassembly dedupes',
        'faults': [{'seam': 'worker.chunk', 'action': 'dup', 'p': 0.25, 'max': 40}],
        'config': {'shm': False},
    },
    'fetch_latency_spike': {
        'summary': 'cold-object-store GETs via the emulation filesystem under every split '
                   'reader',
        'filesystem': {'kind': 'bandwidth_limited', 'bps': 20e6, 'cold_latency': 0.25,
                       'cold_threshold': 1},
    },
    'shm_enospc': {
        'summary': 'shm arena with no headroom: every descriptor publish refuses and degrades '
                   'to the byte path',
        'config': {'shm_capacity_bytes': 1},
    },
    'plane_enospc': {
        'summary': 'cache plane with full tiers: every publish refuses (cache_degraded) and '
                   'decodes direct',
        'cache_plane': True,
        'config': {'cache_plane_ram_bytes': 1, 'cache_plane_disk_bytes': 1},
    },
    'autoscale_storm': {
        'summary': 'one-worker fleet under the closed-loop autoscaler: lease starvation scales '
                   'out mid-epoch, hysteresis keeps the action count inside the damping bound, '
                   'and delivery stays exactly-once',
        'n_workers': 1,
        'config': dict(_AUTOSCALE_STORM),
        'max_autoscale_actions': 6,
    },
    'autoscale_worker_kill': {
        'summary': 'autoscaled fleet loses a worker to SIGKILL mid-epoch: the lease expires, '
                   'the controller backfills capacity, exactly-once holds through the churn '
                   'and the damping bound still holds',
        'n_workers': 2,
        'config': dict(_AUTOSCALE_STORM),
        'kills': [{'role': 'worker', 'phase': 'mid_epoch', 'signal': 'kill', 'restart': False}],
        'max_autoscale_actions': 6,
    },
    'tenant_fair_share': {
        'summary': 'two tenants (weights 1:3) share one fleet over the same dataset under '
                   'WDRR lease scheduling; both delivery digests equal the ground truth',
        'tenants': [{'tenant': 'burst', 'weight': 3.0}],
    },
    'tenant_worker_kill': {
        'summary': 'two tenants share the fleet and one worker dies to SIGKILL mid-epoch: '
                   'both tenants stay exactly-once through the lease churn',
        'tenants': [{'tenant': 'burst', 'weight': 3.0}],
        'kills': [{'role': 'worker', 'phase': 'mid_epoch', 'signal': 'kill', 'restart': False}],
    },
    'decision_journal_kill': {
        'summary': 'SIGKILL the dispatcher mid-scale-storm; the restart restores the decision '
                   'journal from the ledger, so the pre-kill scale-out is still explained '
                   '(rule and inputs, replay-clean) and delivery stays exactly-once with zero '
                   'residue',
        'n_workers': 1,
        'dispatcher_subprocess': True,
        # one lease slot on one worker and single-row-group splits: the lone
        # worker is saturated for the whole epoch, so the starve window
        # ripens across the autoscaler's 1 Hz ticks
        'config': dict(_AUTOSCALE_STORM, autoscale_max_workers=2, max_inflight_splits=1,
                       rowgroups_per_split=1),
        'kills': [{'role': 'dispatcher', 'phase': 'mid_epoch', 'signal': 'kill',
                   'restart': True}],
        'max_autoscale_actions': 6,
        'check_decision_journal': True,
    },
    'materialize_kill': {
        'summary': 'SIGKILL the materialize controller and its warming worker mid-publish: no '
                   'torn cache entries, the restarted controller resumes from the ledger, and '
                   'a plane-cached consumer still delivers the ground-truth digest',
        'runner': 'materialize',
        'throttle_s': 0.25,
        'min_entries_before_kill': 3,
    },
}

#: The fast set: one kill, one drain, one message fault, one scale storm.
SMOKE_SCENARIOS = ('worker_kill', 'worker_drain', 'message_drop', 'autoscale_storm')

#: Every key a scenario (of the catalogue or ``--spec-json``) may carry.
_SPEC_KEYS = frozenset([
    'name', 'summary', 'protocol', 'kills', 'faults', 'config', 'filesystem', 'cache_plane',
    'n_workers', 'dispatcher_subprocess', 'runner', 'tenants', 'max_autoscale_actions',
    'throttle_s', 'min_entries_before_kill', 'check_decision_journal'])

_KILL_ROLES = ('dispatcher', 'worker', 'materialize')
_KILL_SIGNALS = ('kill', 'term')


def ported_scenarios():
    """The catalogue's scenarios this runner can run: every one."""
    return list(SCENARIOS)


def load_spec_json(path):
    """Load and validate a ``--spec-json`` scenario file; ``(name,
    scenario)`` for :func:`run_scenario`.  An invalid spec raises
    ``ValueError``, so a typo'd seam, action or phase fails loudly."""
    with open(path, 'rb') as f:
        spec = json.loads(f.read().decode('utf-8'))
    if not isinstance(spec, dict):
        raise ValueError('spec must be a JSON object, got %s' % type(spec).__name__)
    unknown = sorted(set(spec) - _SPEC_KEYS)
    if unknown:
        raise ValueError('unknown spec key(s) %s (known: %s)'
                         % (', '.join(unknown), ', '.join(sorted(_SPEC_KEYS))))
    for kill in spec.get('kills') or ():
        if not isinstance(kill, dict):
            raise ValueError('each kill must be an object, got %r' % (kill,))
        if kill.get('role') not in _KILL_ROLES:
            raise ValueError('kill role must be one of %s, got %r' % (_KILL_ROLES,
                                                                      kill.get('role')))
        if kill.get('phase') not in PHASES:
            raise ValueError('kill phase must be one of %s, got %r' % (PHASES, kill.get('phase')))
        if kill.get('signal', 'kill') not in _KILL_SIGNALS:
            raise ValueError('kill signal must be one of %s, got %r'
                             % (_KILL_SIGNALS, kill.get('signal')))
    # ChaosState's constructor validates the faults
    ChaosState({'seed': 0, 'faults': spec.get('faults') or []})
    runner = spec.get('runner')
    if runner not in (None, 'materialize'):
        raise ValueError("runner must be 'materialize' when set, got %r" % (runner,))
    name = str(spec.get('name') or 'spec:%s' % os.path.splitext(os.path.basename(path))[0])
    scenario = {key: value for key, value in spec.items() if key != 'name'}
    scenario.setdefault('summary', 'replayed --spec-json scenario')
    return name, scenario


# -- the runner ----------------------------------------------------------------

_WORKER_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[2])
from petastorm_tpu_torch.service.worker import Worker
w = Worker(sys.argv[1])
w.install_signal_handlers()
w.run()
"""

_DISPATCHER_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[3])
from petastorm_tpu_torch.service.config import ServiceConfig
from petastorm_tpu_torch.service.dispatcher import Dispatcher
spec = json.loads(sys.argv[2])
with Dispatcher(ServiceConfig(**spec), bind=sys.argv[1]) as d:
    while d._thread.is_alive():
        time.sleep(0.2)
"""

_MATERIALIZE_CHILD = r"""
import json, os, sys
sys.path.insert(0, sys.argv[2])
from petastorm_tpu_torch.materialize import MaterializeController
spec = json.loads(sys.argv[1])
summary_path = spec.pop('summary_path')
with MaterializeController(**spec) as controller:
    summary = controller.run()
tmp = summary_path + '.part'
with open(tmp, 'w') as f:
    json.dump(summary, f)
os.replace(tmp, summary_path)
"""


def _repo_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _spawn(child_src, args, spec_env=None):
    """A child process of the run, on no card."""
    import subprocess
    import sys
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    env.pop('PYTHONPATH', None)
    if spec_env:
        env.update(spec_env)
    return subprocess.Popen([sys.executable, '-c', child_src] + list(args), env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def _shm_residue(pids):
    """The shm slabs in ``/dev/shm`` of the run's processes (other users of
    the host make and unlink slabs of their own meanwhile)."""
    from petastorm_tpu_torch.workers_pool import shm_plane
    return shm_plane.residue(pids)


def make_chaos_dataset(directory, rows=96, row_group_size=4, payload_bytes=2048, seed=0):
    """A small plain-Parquet store for runs without one: ``id`` int64 and a
    seeded fixed-width payload, sized so that an epoch lasts long enough for
    a kill to land mid-epoch.  The reference's, byte for byte."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 255, (rows, payload_bytes), dtype=np.uint8)
    pq.write_table(pa.table({'id': np.arange(rows, dtype=np.int64), 'payload': list(payload)}),
                   os.path.join(directory, 'data.parquet'), row_group_size=row_group_size)
    return 'file://' + os.path.abspath(directory), rows


class _Stats(object):
    """Polls the dispatcher's RPCs, returning None while it is dead or
    restarting; remembers the pid of every worker it saw."""

    def __init__(self, addr):
        import zmq

        from petastorm_tpu_torch.service.worker import _Rpc
        self._context = zmq.Context()
        self._addr = addr
        self._rpc_cls = _Rpc
        self.worker_pids = set()

    def poll(self):
        stats = self.call({'op': 'stats'})
        for row in ((stats or {}).get('workers') or {}).values():
            if row.get('pid'):
                self.worker_pids.add(int(row['pid']))
        return stats

    def call(self, request, timeout_s=2.0):
        from petastorm_tpu_torch.errors import ServiceError
        rpc = self._rpc_cls(self._context, self._addr, timeout_s=timeout_s)
        try:
            return rpc.call(request)
        except ServiceError:
            return None
        finally:
            rpc.close()

    def close(self):
        self._context.term()


def _phase_reached(stats, phase, n_workers):
    if stats is None:
        return False
    if phase == 'registered':
        return len(stats.get('workers') or {}) >= n_workers
    if phase == 'leases':
        return stats.get('leased', 0) >= 1
    if phase == 'mid_epoch':
        return stats.get('done', 0) >= 1 and (stats.get('pending', 0)
                                              + stats.get('leased', 0)) >= 1
    if phase == 'tail':
        return stats.get('pending', 0) == 0
    raise ValueError('unknown phase %r (known: %s)' % (phase, PHASES))


def _journal_records(reply):
    """The dispatcher's journal records (ring and kept actions, deduped by
    seq) of a ``decisions`` reply, by ``(unix_time, seq)``, and its
    restores."""
    journal = (reply or {}).get('journal') or {}
    if journal.get('kind') != 'decision_journal':
        raise ValueError('the reply holds no decision journal')
    seen, records = set(), []
    for rec in list(journal.get('records') or ()) + list(journal.get('notable') or ()):
        if isinstance(rec, dict) and rec.get('seq') not in seen:
            seen.add(rec.get('seq'))
            records.append(rec)
    records.sort(key=lambda r: (r.get('unix_time', 0.0), r.get('seq', 0)))
    return records, int(journal.get('restores', 0) or 0)


def _run_materialize_scenario(name, scenario, dataset_url, workdir, seed=7,
                              expected_digest=None, timeout_s=240.0):
    """The materialization crash drill: SIGKILL the controller (one process,
    scheduler and warming worker both) while publishes are in flight, then
    hold (1) no torn ``.cpe`` entry (a publish is a tmp file and a rename),
    (2) the ledger carries the progress and a restarted controller resumes
    it instead of warming again, and (3) a consumer reading through the
    warmed plane delivers the ground-truth digest with no decode miss; and
    zero residue.  A report, as :func:`run_scenario`'s; never raises."""
    import signal as _signal

    import numpy as np

    from petastorm_tpu_torch.cache_plane.plane import ENTRY_SUFFIX, decode_entry
    from petastorm_tpu_torch.materialize import MATERIALIZE_LEDGER_KIND
    from petastorm_tpu_torch.reader import make_batch_reader
    from petastorm_tpu_torch.service.ledger import DispatcherLedger, decode_splits

    report = {'scenario': name, 'seed': int(seed), 'ok': False, 'checks': {},
              'injections': {}}
    plane_dir = os.path.join(workdir, 'mat_plane_%s' % name)
    ledger_path = os.path.join(workdir, 'mat_ledger_%s.json' % name)
    summary_path = os.path.join(workdir, 'mat_summary_%s.json' % name)
    # a disk-only plane (no hot tier): every publish is a file to inspect,
    # and the drill leaves nothing in /dev/shm
    spec = {'dataset_url': dataset_url, 'cache_plane_dir': plane_dir,
            'ledger_path': ledger_path, 'cache_plane_ram_bytes': 0,
            'throttle_s': float(scenario.get('throttle_s', 0.25)),
            'summary_path': summary_path}
    pids = {os.getpid()}
    proc = None

    def entries():
        try:
            return sorted(n for n in os.listdir(plane_dir) if n.endswith(ENTRY_SUFFIX))
        except OSError:
            return []

    try:
        # phase 1: warm under the throttle, SIGKILL mid-publish
        proc = _spawn(_MATERIALIZE_CHILD, [json.dumps(spec), _repo_root()])
        pids.add(proc.pid)
        deadline = time.monotonic() + timeout_s
        want = int(scenario.get('min_entries_before_kill', 3))
        while len(entries()) < want:
            if proc.poll() is not None or time.monotonic() > deadline:
                report['checks']['kill_controller'] = (
                    'controller finished (%d entr(ies)) before the kill window'
                    % len(entries()))
                return report
            time.sleep(0.02)
        proc.send_signal(_signal.SIGKILL)
        proc.wait(timeout=30)
        report['checks']['kill_controller'] = ('SIGKILL pid %d with %d entr(ies) published'
                                               % (proc.pid, len(entries())))

        # invariant 1: no torn entry
        torn = []
        for entry_name in entries():
            try:
                with open(os.path.join(plane_dir, entry_name), 'rb') as f:
                    decode_entry(f.read())
            except Exception as e:  # noqa: BLE001 — any failure is the finding
                torn.append('%s: %r' % (entry_name, e))
        report['checks']['zero_torn_entries'] = (
            'ok (%d entr(ies) decode cleanly)' % len(entries()) if not torn
            else '; '.join(torn[:4]))

        # invariant 2a: the kill left durable progress in the ledger
        state = DispatcherLedger(ledger_path, kind=MATERIALIZE_LEDGER_KIND).load()
        done_before = 0
        if state and isinstance(state.get('splits'), list):
            try:
                done_before = sum(1 for st, _ in decode_splits(state['splits']) if st == 'done')
            except (ValueError, KeyError, TypeError):
                pass
        report['checks']['ledger_progress'] = (
            'ok (%d piece(s) durably done)' % done_before if done_before >= 1
            else 'ledger shows no completed piece after the kill')

        # invariant 2b: the restart resumes instead of warming again
        proc = _spawn(_MATERIALIZE_CHILD, [json.dumps(dict(spec, throttle_s=0.0)),
                                           _repo_root()])
        pids.add(proc.pid)
        proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        try:
            with open(summary_path) as f:
                summary = json.load(f)
        except (OSError, ValueError) as e:
            report['checks']['resume'] = 'no restart summary: %r' % e
            return report
        report['restart_summary'] = summary
        resumed = int(summary.get('resumed', 0) or 0)
        resumed_ok = (resumed >= max(1, done_before)
                      and summary.get('done') == summary.get('total_pieces')
                      and not summary.get('failed_pieces'))
        report['checks']['resume'] = (
            'ok (resumed %d from the ledger, warmed the remaining %d of %d)'
            % (resumed, int(summary.get('done', 0)) - resumed, summary.get('total_pieces', 0))
            if resumed_ok else 'summary %r' % summary)

        # invariant 3: the consumer's delivery digest, with no decode miss
        if expected_digest is None:
            expected_digest = direct_read_digest(dataset_url)
        digest = DeliveryDigest()
        with make_batch_reader(dataset_url, num_epochs=1, shuffle_row_groups=False,
                               workers_count=1, cache_type='plane', cache_location=plane_dir,
                               cache_extra_settings={'ram_bytes': 0}) as reader:
            for item in reader:
                digest.update({k: np.asarray(v) for k, v in item._asdict().items()})
            diag = reader.diagnostics
        digest_ok = digest.hexdigest() == expected_digest
        report['checks']['digest'] = ('ok' if digest_ok else '%s != expected %s'
                                      % (digest.hexdigest(), expected_digest))
        report['digest'] = digest.hexdigest()
        misses = int(diag.get('cache_misses', -1))
        served_warm = misses == 0 and int(diag.get('cache_hits', 0)) >= 1
        report['checks']['served_from_plane'] = (
            'ok (%d hit(s), 0 misses)' % int(diag.get('cache_hits', 0)) if served_warm
            else 'consumer decoded: hits=%s misses=%s'
            % (diag.get('cache_hits'), diag.get('cache_misses')))
        report['ok'] = bool(not torn and done_before >= 1 and resumed_ok and digest_ok
                            and served_warm)
        return report
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            try:
                proc.wait(timeout=20)
            except Exception:  # noqa: BLE001 — never hang the matrix
                pass
        shm_left = _shm_residue(pids)
        tmp_left = _ledger_tmp_residue(ledger_path)
        # a SIGKILL mid-write leaves ``.tmp.<pid>.*`` beside the entries: the
        # restart must have swept it
        plane_tmp = [n for n in (os.listdir(plane_dir) if os.path.isdir(plane_dir) else [])
                     if n.startswith('.tmp.')]
        report['checks']['zero_residue'] = (
            'ok' if not shm_left and not tmp_left and not plane_tmp else
            'shm=%s tmp=%s plane_tmp=%s' % (sorted(shm_left)[:4], tmp_left[:4], plane_tmp[:4]))
        if report.get('ok'):
            report['ok'] = not shm_left and not tmp_left and not plane_tmp


def run_scenario(name, dataset_url, rows, workdir, seed=7, n_workers=2, expected_digest=None,
                 timeout_s=240.0, scenario=None):
    """One scenario end to end; a report dict (``ok``, each invariant's
    verdict, the injection counts).  A failure lands in the report (the
    matrix must finish).  ``scenario`` replaces the catalogue's
    entry (``name`` then only labels the report)."""
    import numpy as np

    from petastorm_tpu_torch.service.client import ServiceDataLoader
    from petastorm_tpu_torch.service.config import ServiceConfig
    from petastorm_tpu_torch.service.dispatcher import Dispatcher
    from petastorm_tpu_torch.workers_pool import shm_plane

    if scenario is None:
        scenario = SCENARIOS[name]
    if scenario.get('runner') == 'materialize':
        # the materialization drill runs no fleet: one controller process,
        # killed and restarted, then a plane-cached consumer's read
        return _run_materialize_scenario(name, scenario, dataset_url, workdir, seed=seed,
                                         expected_digest=expected_digest, timeout_s=timeout_s)
    n_workers = int(scenario.get('n_workers', n_workers))
    spec = {'seed': int(seed), 'faults': scenario.get('faults') or []}
    ledger_path = os.path.join(workdir, 'ledger_%s.json' % name)
    overrides = dict(scenario.get('config') or {})
    reader_kwargs = {'workers_count': 1}
    fs_spec = scenario.get('filesystem')
    if fs_spec is not None:
        reader_kwargs['filesystem'] = _build_fault_fs(fs_spec)
    config_kwargs = dict(dataset_url=dataset_url, num_consumers=1, rowgroups_per_split=2,
                         lease_ttl_s=2.0, reader_kwargs=reader_kwargs,
                         ledger_path=ledger_path, drain_timeout_s=20.0)
    if scenario.get('cache_plane'):
        config_kwargs.update(cache_plane=True,
                             cache_plane_dir=os.path.join(workdir, 'plane_%s' % name))
    config_kwargs.update(overrides)
    config = ServiceConfig(**config_kwargs)

    report = {'scenario': name, 'seed': int(seed), 'ok': False, 'checks': {},
              'injections': {}}
    counts_prefix = os.path.join(workdir, 'chaos_counts_%s' % name)
    spec_env = ({CHAOS_ENV: json.dumps(spec), CHAOS_COUNTS_ENV: counts_prefix}
                if spec['faults'] else None)
    state = activate(spec) if spec['faults'] else None

    dispatcher = None
    dispatcher_proc = None
    workers = []
    stats = None
    pids = {os.getpid()}
    try:
        use_subproc = bool(scenario.get('dispatcher_subprocess'))
        if use_subproc:
            dispatcher_addr = 'tcp://127.0.0.1:%d' % _free_port()
            # JSON cannot carry a filesystem object into the child (no
            # subprocess-dispatcher scenario has one)
            child_spec = dict(config_kwargs, reader_kwargs={'workers_count': 1})
            dispatcher_proc = _spawn(_DISPATCHER_CHILD,
                                     [dispatcher_addr, json.dumps(child_spec), _repo_root()],
                                     spec_env=spec_env)
            pids.add(dispatcher_proc.pid)
        else:
            dispatcher = Dispatcher(config).start()
            dispatcher_addr = dispatcher.addr
        stats = _Stats(dispatcher_addr)
        for salt in range(1, n_workers + 1):
            env = dict(spec_env or {}, **{CHAOS_SALT_ENV: str(salt)})
            workers.append(_spawn(_WORKER_CHILD, [dispatcher_addr, _repo_root()], spec_env=env))
        pids.update(p.pid for p in workers)
        deadline = time.monotonic() + timeout_s
        while not _phase_reached(stats.poll(), 'registered', n_workers):
            if time.monotonic() > deadline:
                report['checks']['fleet_up'] = 'workers never registered'
                return report
            time.sleep(0.1)

        # the co-tenants' jobs, on the same dataset and fleet, before any
        # consumption: the whole epoch runs under the fair-share schedule
        for entry in scenario.get('tenants') or ():
            from petastorm_tpu_torch.service.client import register_tenant_job
            try:
                register_tenant_job(dispatcher_addr, entry['tenant'], dict(
                    dataset_url=dataset_url, num_consumers=1, rowgroups_per_split=2,
                    lease_ttl_s=2.0, reader_kwargs={'workers_count': 1}),
                    weight=entry.get('weight', 1.0))
            except Exception as e:  # noqa: BLE001 — reported, the matrix goes on
                report['checks']['register_%s' % entry['tenant']] = 'failed: %r' % e
                return report

        # one stream per tenant, each with its digest and ids: the invariants
        # hold per tenant (an aggregate could hide one's loss behind
        # another's duplicate)
        streams = [{'tenant': None, 'digest': DeliveryDigest(), 'ids': [], 'errors': []}]
        streams += [{'tenant': entry['tenant'], 'digest': DeliveryDigest(), 'ids': [],
                     'errors': []} for entry in scenario.get('tenants') or ()]

        def consume(stream):
            try:
                loader = ServiceDataLoader(dispatcher_addr, batch_size=8, consumer=0,
                                           drop_last=False, queue_splits=1, credits=2,
                                           tenant=stream['tenant'], device='cpu')
                with loader:
                    for batch in loader.iter_host_batches():
                        chunk = {k: np.asarray(v) for k, v in batch.items()}
                        stream['digest'].update(chunk)
                        stream['ids'].extend(chunk['id'].tolist())
                        # throttled, so that splits stay in flight long enough
                        # for a phase's kill to land mid-epoch
                        time.sleep(0.1)
            except Exception as e:  # noqa: BLE001 — reported, the matrix goes on
                stream['errors'].append(e)

        consumers = [threading.Thread(target=consume, args=(stream,), daemon=True)
                     for stream in streams]
        for thread in consumers:
            thread.start()

        # the kills, in this thread: their phases are ordered
        for kill in scenario.get('kills') or ():
            while not _phase_reached(stats.poll(), kill['phase'], n_workers):
                if time.monotonic() > deadline or not any(t.is_alive() for t in consumers):
                    break
                time.sleep(0.05)
            if not any(t.is_alive() for t in consumers):
                report['checks'].setdefault('kill_%s' % kill['role'],
                                            'epoch finished before phase %r' % kill['phase'])
                continue
            import signal as _signal
            signum = _signal.SIGKILL if kill['signal'] == 'kill' else _signal.SIGTERM
            if kill['role'] == 'dispatcher':
                if dispatcher_proc is None:
                    report['checks']['kill_dispatcher'] = \
                        'scenario did not run a dispatcher subprocess'
                    continue
                if scenario.get('check_decision_journal'):
                    # the kill lands after the autoscaler acted and the serve
                    # loop's next ledger save persisted the record
                    while time.monotonic() < deadline and any(t.is_alive() for t in consumers):
                        auto = (stats.poll() or {}).get('autoscale') or {}
                        if int(auto.get('scale_outs', 0) or 0) >= 1:
                            break
                        time.sleep(0.1)
                    time.sleep(0.6)   # more than one 100 ms serve-loop turn
                dispatcher_proc.send_signal(signum)
                dispatcher_proc.wait(timeout=30)
                report['checks']['kill_dispatcher'] = 'killed'
                report['kill_unix'] = time.time()
                if kill.get('restart'):
                    dispatcher_proc = _spawn(
                        _DISPATCHER_CHILD,
                        [dispatcher_addr, json.dumps(config_kwargs), _repo_root()],
                        spec_env=spec_env)
                    pids.add(dispatcher_proc.pid)
                    report['checks']['restart_dispatcher'] = 'restarted'
            else:
                victim = workers[0]
                victim.send_signal(signum)
                victim.wait(timeout=30)
                report['checks']['kill_worker'] = ('sig%s pid %d, exit %r'
                                                   % (kill['signal'], victim.pid,
                                                      victim.returncode))
                if kill.get('restart'):
                    workers[0] = _spawn(_WORKER_CHILD, [dispatcher_addr, _repo_root()],
                                        spec_env=spec_env)
                    pids.add(workers[0].pid)

        while any(t.is_alive() for t in consumers) and time.monotonic() < deadline:
            stats.poll()   # learns the pids of the workers the autoscaler spawns
            for thread in consumers:
                thread.join(0.25)
        if any(t.is_alive() for t in consumers):
            report['checks']['liveness'] = ('epoch wedged (> %.0fs); %s rows delivered'
                                            % (timeout_s, [s['digest'].rows for s in streams]))
            return report
        errors = [e for s in streams for e in s['errors']]
        if errors:
            report['checks']['consumer'] = 'raised: %r' % errors[0]
            return report

        # the three invariants, per tenant stream
        want_ids = list(range(rows))
        if expected_digest is None:
            expected_digest = direct_read_digest(dataset_url)
        all_ok = True
        for stream in streams:
            suffix = '' if stream['tenant'] is None else '_%s' % stream['tenant']
            ids = stream['ids']
            exactly_once = sorted(ids) == want_ids
            report['checks']['exactly_once%s' % suffix] = (
                'ok' if exactly_once else 'lost=%s dup=%s' % (
                    sorted(set(want_ids) - set(ids))[:8],
                    sorted(i for i in set(ids) if ids.count(i) > 1)[:8]))
            digest_ok = stream['digest'].hexdigest() == expected_digest
            report['checks']['digest%s' % suffix] = (
                'ok' if digest_ok else '%s != expected %s' % (stream['digest'].hexdigest(),
                                                              expected_digest))
            all_ok = all_ok and exactly_once and digest_ok
        report['digest'] = streams[0]['digest'].hexdigest()

        # the autoscaler's damping bound
        bound = scenario.get('max_autoscale_actions')
        if bound is not None:
            auto = (stats.poll() or {}).get('autoscale') or {}
            actions = int(auto.get('actions', 0) or 0)
            damped = actions <= int(bound)
            report['autoscale'] = {k: auto.get(k) for k in ('scale_outs', 'scale_ins', 'actions',
                                                             'suppressed')}
            report['autoscale']['bound'] = int(bound)
            report['checks']['autoscale_damped'] = (
                'ok (%d action(s): outs %d ins %d, suppressed %d)'
                % (actions, int(auto.get('scale_outs', 0) or 0),
                   int(auto.get('scale_ins', 0) or 0), int(auto.get('suppressed', 0) or 0))
                if damped else 'flapping: %d action(s) > damping bound %d' % (actions,
                                                                               int(bound)))
            all_ok = all_ok and damped

        # the restarted dispatcher still explains the scale-out before the
        # kill from its restored journal, and the replay agrees with it
        if scenario.get('check_decision_journal'):
            from petastorm_tpu_torch.telemetry import decisions as _decisions
            try:
                records, restores = _journal_records(
                    stats.call({'op': 'decisions'}, timeout_s=10.0))
            except ValueError as e:
                report['checks']['decision_journal'] = 'no journal: %s' % e
                records, restores = [], 0
                all_ok = False
            if records:
                kill_unix = report.get('kill_unix')
                pre_kill = [r for r in records if r.get('actor') == 'autoscaler'
                            and (kill_unix is None or r.get('unix_time', 0.0) < kill_unix)]
                spawns = [r for r in pre_kill
                          if r.get('action') == 'scale_out' and not r.get('suppressed')]
                verdicts = [_decisions.replay_decision(r)['verdict'] for r in spawns]
                journal_ok = restores >= 1 and bool(spawns) and 'divergent' not in verdicts
                report['checks']['decision_journal'] = (
                    'ok (restores %d, %d pre-kill spawn record(s), replay %s)'
                    % (restores, len(spawns), verdicts) if journal_ok else
                    'restores=%s pre_kill_autoscaler=%d spawns=%d replay=%s'
                    % (restores, len(pre_kill), len(spawns), verdicts))
                all_ok = all_ok and journal_ok

        # workers an autoscaling dispatcher spawned and that outlived it (a
        # killed one never closed its launcher): drained through the control
        # plane before the teardown
        if overrides.get('autoscale') and use_subproc:
            for wid in sorted((stats.poll() or {}).get('workers') or {}):
                stats.call({'op': 'drain', 'worker_id': wid}, timeout_s=5.0)
            drain_deadline = time.monotonic() + 25.0
            while time.monotonic() < drain_deadline:
                if not (stats.poll() or {}).get('workers'):
                    break
                time.sleep(0.25)
        report['ok'] = bool(all_ok)
        return report
    finally:
        deactivate()
        if state is not None:
            report['injections'] = {('%s/%s' % key): n for key, n in state.counts.items()}
        if dispatcher is not None and dispatcher.autoscaler is not None:
            pids.update(p.pid for p in getattr(dispatcher.autoscaler.launcher, 'procs', ()))
        children = workers + ([dispatcher_proc] if dispatcher_proc else [])
        for proc in children:
            if proc.poll() is None:
                proc.send_signal(15)
        for proc in children:
            try:
                proc.wait(timeout=20)
            except Exception:  # noqa: BLE001 — escalate, never hang the matrix
                proc.kill()
                proc.wait(timeout=20)
        if dispatcher is not None:
            dispatcher.stop()
            dispatcher.join()
        if stats is not None:
            pids.update(stats.worker_pids)
            stats.close()
        # the children's injection counts, dumped at their clean exit (a
        # SIGKILLed victim's die with it)
        for path in _ledger_tmp_siblings(counts_prefix):
            try:
                with open(path) as f:
                    for key, n in (json.load(f) or {}).items():
                        report['injections'][key] = report['injections'].get(key, 0) + int(n)
            except (OSError, ValueError):
                pass
        # zero residue: a verdict of the report, not an exception
        shm_plane.sweep_orphans()
        shm_left = _shm_residue(pids)
        tmp_left = _ledger_tmp_residue(ledger_path)
        report['checks']['zero_residue'] = (
            'ok' if not shm_left and not tmp_left else
            'shm=%s tmp=%s' % (sorted(shm_left)[:4], tmp_left[:4]))
        if report.get('ok'):
            report['ok'] = not shm_left and not tmp_left


def _ledger_tmp_siblings(prefix):
    """The files ``<prefix>.<pid>.json`` (the children's injection counts)."""
    directory = os.path.dirname(os.path.abspath(prefix))
    base = os.path.basename(prefix)
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return [os.path.join(directory, n) for n in names
            if n.startswith(base + '.') and n.endswith('.json')]


def _ledger_tmp_residue(ledger_path):
    directory = os.path.dirname(os.path.abspath(ledger_path))
    base = os.path.basename(ledger_path)
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return [n for n in names if n.startswith(base + '.') and n.endswith('.tmp')]


def _build_fault_fs(fs_spec):
    """The storage fault a scenario's ``filesystem`` entry names, over the
    local disk."""
    from petastorm_tpu_torch.fs_utils import LocalFilesystem
    kwargs = {k: v for k, v in fs_spec.items() if k != 'kind'}
    return FILESYSTEM_FAULTS[fs_spec['kind']](LocalFilesystem(), **kwargs)


def run_matrix(names, dataset_url=None, rows=None, workdir=None, seed=7,
               scenario_overrides=None):
    """Run each named scenario against one dataset and one truth digest;
    ``(reports, all_ok)``.  ``scenario_overrides`` maps a name to a scenario
    used in place of the catalogue's (``--spec-json``)."""
    import shutil
    import tempfile
    overrides = scenario_overrides or {}
    owned = workdir is None
    ok = False
    if owned:
        workdir = tempfile.mkdtemp(prefix='petastorm-tpu-chaos-')
    try:
        if dataset_url is None:
            dataset_url, rows = make_chaos_dataset(os.path.join(workdir, 'dataset'), seed=seed)
        expected = direct_read_digest(dataset_url)
        reports = []
        for name in names:
            t0 = time.monotonic()
            report = run_scenario(name, dataset_url, rows, workdir, seed=seed,
                                  expected_digest=expected, scenario=overrides.get(name))
            report['elapsed_s'] = round(time.monotonic() - t0, 1)
            reports.append(report)
            logger.info('scenario %-20s %s (%.1fs)', name, 'PASS' if report['ok'] else 'FAIL',
                        report['elapsed_s'])
        ok = all(r['ok'] for r in reports)
        return reports, ok
    finally:
        if owned:
            if ok:
                shutil.rmtree(workdir, ignore_errors=True)
            else:
                # a failed matrix's ledgers and dataset are its repro
                logger.info('matrix artifacts kept at %s', workdir)


def render_report(reports):
    lines = ['petastorm-tpu-chaos — %d scenario(s)' % len(reports)]
    for report in reports:
        lines.append('%-20s %s  (%.1fs)  digest=%s'
                     % (report['scenario'], 'PASS' if report['ok'] else 'FAIL',
                        report.get('elapsed_s', 0.0), report.get('digest', '-')))
        for check, verdict in sorted(report['checks'].items()):
            lines.append('    %-14s %s' % (check, verdict))
        if report.get('injections'):
            lines.append('    injections     %s' % ', '.join(
                '%s=%d' % kv for kv in sorted(report['injections'].items())))
    return '\n'.join(lines)


def main(argv=None):
    """List the scenarios, run one, or run a set.  Exit 0: every scenario
    run kept its invariants; 1: one failed; 2: a usage error."""
    import argparse
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(name)s %(levelname)s %(message)s')
    parser = argparse.ArgumentParser(
        prog='petastorm-tpu-chaos',
        description='Fleet chaos harness: run the data service under seeded fault scenarios '
                    'and assert delivery digest, exactly-once, and zero residue.')
    sub = parser.add_subparsers(dest='command', required=True)
    sub.add_parser('list', help='print the scenario catalogue')
    for cmd in ('run', 'matrix'):
        p = sub.add_parser(cmd, help='run one scenario' if cmd == 'run' else 'run a scenario set')
        if cmd == 'run':
            p.add_argument('scenario', nargs='?', default=None, choices=sorted(SCENARIOS))
            p.add_argument('--spec-json', default=None, metavar='PATH',
                           help='run a scenario from a JSON spec file instead of the catalogue')
        else:
            p.add_argument('--scenarios', default=None,
                           help='comma-separated names (default: every one the port runs)')
            p.add_argument('--smoke', action='store_true',
                           help='the fast set: %s' % ', '.join(SMOKE_SCENARIOS))
        p.add_argument('--dataset-url', default=None,
                       help='existing dataset (default: generate a small one in a temp dir)')
        p.add_argument('--rows', type=int, default=None,
                       help='row count of --dataset-url (required with it; the exactly-once '
                            'check needs ids 0..rows-1)')
        p.add_argument('--seed', type=int, default=7)
        p.add_argument('--json', action='store_true')
    args = parser.parse_args(argv)

    if args.command == 'list':
        for name, scenario in SCENARIOS.items():
            print('%-20s %s' % (name, scenario['summary']))
        return 0
    if args.dataset_url is not None and args.rows is None:
        parser.error('--dataset-url requires --rows')
    scenario_overrides = None
    if args.command == 'run':
        if (args.scenario is None) == (args.spec_json is None):
            parser.error('run takes a scenario name or --spec-json (exactly one)')
        if args.spec_json is not None:
            try:
                name, scenario = load_spec_json(args.spec_json)
            except (OSError, ValueError) as e:
                parser.error('bad --spec-json %s: %s' % (args.spec_json, e))
            names = [name]
            scenario_overrides = {name: scenario}
        else:
            names = [args.scenario]
    elif args.smoke:
        names = list(SMOKE_SCENARIOS)
    elif args.scenarios:
        names = [n.strip() for n in args.scenarios.split(',') if n.strip()]
        unknown = sorted(set(names) - set(SCENARIOS))
        if unknown:
            parser.error('unknown scenario(s): %s' % ', '.join(unknown))
    else:
        names = ported_scenarios()
    try:
        reports, ok = run_matrix(names, dataset_url=args.dataset_url, rows=args.rows,
                                 seed=args.seed, scenario_overrides=scenario_overrides)
    except ValueError as e:
        parser.error(str(e))
    if args.json:
        print(json.dumps(reports, sort_keys=True, default=str))
    else:
        print(render_report(reports))
    return 0 if ok else 1


if __name__ == '__main__':
    import sys
    sys.exit(main())
