"""The dispatcher's durable ledger: the control plane survives its own death.

Counterpart of ``petastorm_tpu/service/ledger.py``, its file format the
reference's, so that either package's dispatcher restores the other's
ledger.  What persists: each split's state and attempt count, the tenant
table (version 2), the cluster cache's digest directory keyed by data
address (the one identity of a worker that survives a restart) and the
piece-digest map, and the partition geometry's fingerprint that gates every
restore.  How:

* a **snapshot** written with :func:`atomic_json_dump` (a tmp file and
  ``os.replace``: a SIGKILL mid-write leaves the previous one) whenever the
  dispatcher's state is dirty;
* a **write-ahead journal**, ``<path>.journal``: the transitions that
  retire work (``complete``, ``mark_consumed``) append one line before
  their reply.  :meth:`DispatcherLedger.load` replays it over the snapshot,
  skipping a line a SIGKILL tore; each snapshot truncates it;
* a **single writer**: the dispatcher holds an exclusive ``flock`` on
  ``<path>.owner`` for its life; a second one on the same path fails at
  construction.  The kernel drops the lock at any death.

The restore lives in the dispatcher: done and failed splits stay retired;
a leased split comes back as an **orphan lease** that a re-registering
worker's ``held`` heartbeat claim adopts (attempt intact), or that requeues
unclaimed after one lease TTL, its attempt intact (the restart was not the
worker's failure).  The reference's ledger also keeps its decision journal
(``decisions``), which the port does not hold: it writes the key empty and
ignores it on restore.  Standard library only.
"""

import fcntl
import json
import logging
import os

from petastorm_tpu_torch.errors import ServiceError

logger = logging.getLogger(__name__)

__all__ = ['DispatcherLedger', 'LedgerHeldError', 'LEDGER_KIND', 'LEDGER_VERSION',
           'encode_splits', 'decode_splits', 'atomic_json_dump']

LEDGER_KIND = 'dispatcher_ledger'
#: Version 1 is single-tenant; version 2 adds the ``tenants`` table.  Both
#: load (a version 1 file restores as the default tenant's job); a newer one
#: cold-starts.
LEDGER_VERSION = 2
_COMPAT_VERSIONS = (1, 2)

_STATE_CODES = {'pending': 'p', 'leased': 'l', 'done': 'd', 'failed': 'f'}
_CODE_STATES = {code: state for state, code in _STATE_CODES.items()}


def atomic_json_dump(path, state):
    """Write ``state`` as JSON to ``path`` through a tmp file and
    ``os.replace``; the tmp file goes on failure, and every error is
    swallowed.  Returns the path, or None."""
    tmp = None
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = '%s.%d.tmp' % (path, os.getpid())
        with open(tmp, 'w') as f:
            json.dump(state, f, default=str)
        os.replace(tmp, path)
        return path
    except Exception:  # noqa: BLE001 — a failed snapshot must not kill the dispatcher
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return None


class LedgerHeldError(ServiceError):
    """A live dispatcher holds this ledger's owner lock."""


def encode_splits(splits):
    """``[[state code, attempt], ...]`` by split id (the ids are dense)."""
    return [[_STATE_CODES[s.state], int(s.attempt)] for s in splits]


def decode_splits(records):
    """``[(state, attempt), ...]``; an unknown code raises ``KeyError`` (a
    corrupt ledger is rejected whole)."""
    return [(_CODE_STATES[code], int(attempt)) for code, attempt in records]


class DispatcherLedger(object):
    """One dispatcher's snapshot file, its journal and its owner lock:
    :meth:`acquire` at construction, :meth:`load`, :meth:`save` per
    snapshot, :meth:`append` per retiring transition, :meth:`release` at a
    clean stop (the files stay: they are the next dispatcher's)."""

    def __init__(self, path, kind=LEDGER_KIND):
        self.path = str(path)
        self.kind = str(kind)
        self._owner_fd = None
        self._journal_f = None
        #: snapshots written
        self.saves = 0

    def acquire(self):
        """Take the exclusive lifetime flock on ``<path>.owner``."""
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        fd = os.open(self.path + '.owner', os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            raise LedgerHeldError('ledger %r is owned by a live dispatcher (the exclusive '
                                  'flock on %s.owner is held elsewhere): two control planes '
                                  'on one ledger would split the lease state'
                                  % (self.path, self.path))
        self._owner_fd = fd
        return self

    def release(self):
        """Drop the owner lock and its file, and close the journal."""
        journal, self._journal_f = self._journal_f, None
        if journal is not None:
            try:
                journal.close()
            except OSError:
                pass
        fd, self._owner_fd = self._owner_fd, None
        if fd is None:
            return
        try:
            os.close(fd)
        except OSError:
            pass
        try:
            os.unlink(self.path + '.owner')
        except OSError:
            pass

    def load(self):
        """The last snapshot with the journal replayed over its splits, or
        None (missing, unreadable, another kind, another version: each logs
        why and cold-starts; never raises)."""
        try:
            with open(self.path) as f:
                state = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            logger.warning('ledger %s unreadable (%s); cold start', self.path, e)
            return None
        if not isinstance(state, dict) or state.get('kind') != self.kind:
            logger.warning('ledger %s is not a %s file; cold start', self.path, self.kind)
            return None
        try:
            version = int(state.get('version', -1))
        except (TypeError, ValueError):
            version = -1
        if version > LEDGER_VERSION:
            logger.warning('ledger %s is version %d, newer than this dispatcher reads (v%d); '
                           'cold start (the file is left as it is)', self.path, version,
                           LEDGER_VERSION)
            return None
        if version not in _COMPAT_VERSIONS:
            logger.warning('ledger %s is not a v%s %s file; cold start', self.path,
                           '/'.join(map(str, _COMPAT_VERSIONS)), self.kind)
            return None
        splits = state.get('splits')
        for entry in self._replay_journal():
            split_id = entry.get('split')
            if entry.get('op') == 'done' and isinstance(splits, list) \
                    and isinstance(split_id, int) and 0 <= split_id < len(splits) \
                    and isinstance(splits[split_id], (list, tuple)) \
                    and len(splits[split_id]) == 2:
                splits[split_id] = [_STATE_CODES['done'], splits[split_id][1]]
        return state

    def _replay_journal(self):
        """The journal's entries, oldest first; a torn line (the last one,
        cut by a SIGKILL mid-append) is skipped."""
        try:
            with open(self.path + '.journal') as f:
                lines = f.read().splitlines()
        except OSError:
            return []
        entries = []
        for line in lines:
            try:
                entry = json.loads(line)
            except ValueError:
                continue
            if isinstance(entry, dict):
                entries.append(entry)
        return entries

    def append(self, entry):
        """One journal line, flushed before returning; whether it landed."""
        try:
            if self._journal_f is None:
                os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
                self._journal_f = open(self.path + '.journal', 'a')
            self._journal_f.write(json.dumps(entry) + '\n')
            self._journal_f.flush()
            return True
        except (OSError, ValueError):
            return False

    def save(self, state):
        """Write a snapshot atomically and truncate the journal it absorbs;
        the path, or None."""
        path = atomic_json_dump(self.path, dict(state, kind=self.kind, version=LEDGER_VERSION))
        if path is not None:
            self.saves += 1
            try:
                if self._journal_f is not None:
                    self._journal_f.truncate(0)
                    self._journal_f.seek(0)
                else:
                    os.truncate(self.path + '.journal', 0)
            except OSError:
                pass   # stale lines only mark done splits done again
        return path

    def journal_lines(self):
        """The journal's line count now (what a restart would replay)."""
        try:
            with open(self.path + '.journal') as f:
                return sum(1 for _ in f)
        except OSError:
            return 0
