"""Content fingerprints for the cache plane's keys.

Counterpart of ``petastorm_tpu/cache_plane/fingerprint.py``, equal to it
digest for digest.  A plane entry is valid as long as the bytes it was
decoded from and the code that decoded them: the fingerprint folds in the
dataset's data-file identity (path, size, mtime: a rewritten file changes
the digest, so its old entries become unreachable and age out by LRU) and
the decode identity (selected columns, predicate, transform).  The
per-piece part of a key (file, row group, partition) comes from the reader
workers' cache keys; the fingerprint is the prefix mixed into every digest.
Standard library and numpy only: the decode workers import it.
"""

import hashlib
import logging
import uuid

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ['dataset_fingerprint', 'spec_token']


def _hash_code(code, h):
    """Feed a code object's identity into ``h``: its bytecode, the names it
    calls (``lambda r: brighten(r)`` and ``lambda r: darken(r)`` share
    bytecode), and its constants, nested code objects recursed (their repr
    holds an address) and sets sorted (their repr follows hash
    randomization)."""
    h.update(code.co_code)
    h.update(repr(code.co_names).encode('utf-8', 'replace'))
    for const in code.co_consts:
        if hasattr(const, 'co_code'):
            _hash_code(const, h)
        else:
            h.update(_stable_value(const).encode('utf-8', 'replace'))


def _stable_value(value):
    """A rendering of a predicate's or transform's attribute that is the same
    in every process: sets sorted, callables by name and bytecode digest,
    arrays by their bytes (repr truncates past 1,000 elements), containers
    recursed."""
    if isinstance(value, (set, frozenset)):
        return 'set:[%s]' % ','.join(sorted(repr(v) for v in value))
    if isinstance(value, dict):
        return 'dict:{%s}' % ','.join(
            '%r:%s' % (k, _stable_value(v))
            for k, v in sorted(value.items(), key=lambda kv: repr(kv[0])))
    if isinstance(value, (list, tuple)):
        return 'seq:[%s]' % ','.join(_stable_value(v) for v in value)
    if isinstance(value, np.ndarray):
        if value.dtype.hasobject:
            return 'nd-obj:%s:%s' % (value.shape, _stable_value(list(value.ravel())))
        return 'nd:%s:%s:%s' % (
            value.dtype.str, value.shape,
            hashlib.blake2b(np.ascontiguousarray(value).tobytes(), digest_size=8).hexdigest())
    if callable(value):
        return _stable_callable(value)
    return repr(value)


def _stable_callable(value, depth=0):
    """A callable's identity: bytecode, names and constants, defaults,
    closure cells; for a ``functools.partial`` the wrapped function and its
    pinned arguments, for a callable instance its class's ``__call__`` and
    its state."""
    if depth > 6:
        return 'fn-deep:%s' % type(value).__qualname__
    h = hashlib.blake2b(digest_size=6)

    def mix(v):
        h.update(_stable_value(v).encode('utf-8', 'replace'))

    code = getattr(value, '__code__', None)
    if code is not None:
        _hash_code(code, h)
    for cell in getattr(value, '__closure__', None) or ():
        try:
            mix(cell.cell_contents)
        except ValueError:   # an empty cell
            pass
    for attr in ('__defaults__', '__kwdefaults__'):
        bound = getattr(value, attr, None)
        if bound:
            mix(bound)
    inner = getattr(value, 'func', None)
    if inner is not None and callable(inner):
        h.update(_stable_callable(inner, depth + 1).encode())
        mix(getattr(value, 'args', ()))
        mix(getattr(value, 'keywords', None) or {})
    elif code is None:
        call = getattr(type(value), '__call__', None)
        call_code = getattr(call, '__code__', None)
        if call_code is not None:
            _hash_code(call_code, h)
        mix(getattr(value, '__dict__', {}))
    return 'fn:%s.%s:%s' % (getattr(value, '__module__', '?'),
                            getattr(value, '__qualname__', type(value).__qualname__),
                            h.hexdigest())


#: Per-process salt of a file whose identity cannot be established: its
#: entries are not shared across processes rather than risked stale.
_UNSTAT_SALT = uuid.uuid4().hex
_warned_unstat = set()


def _file_stamp(fs, path):
    """``(path, size, mtime-ish)`` of one data file; any field that changes
    when the file is rewritten serves (mtime, ``LastModified``, an etag).
    A file with neither a size nor such a field gets a per-process random
    stamp."""
    try:
        info = fs.info(path)
    except Exception:  # noqa: BLE001 — unstattable: do not risk staleness
        info = {}
    mtime = None
    for key in ('mtime', 'LastModified', 'last_modified', 'ETag', 'etag'):
        if info.get(key) is not None:
            mtime = str(info[key])
            break
    size = info.get('size')
    if size is None and mtime is None:
        if path not in _warned_unstat:
            _warned_unstat.add(path)
            logger.warning('cache plane: no size/mtime/etag for %r; its entries are not shared '
                           'across processes', path)
        return (path, _UNSTAT_SALT, None)
    return (path, size, mtime)


def dataset_fingerprint(fs, paths):
    """Digest of the data files' identity (``paths``: the distinct files a
    reader touches).  Rewriting any of them changes it.  Not memoized: a
    stale digest would serve a rewritten dataset's old rows."""
    h = hashlib.blake2b(digest_size=12)
    for stamp in sorted(_file_stamp(fs, p) for p in set(paths)):
        h.update(repr(stamp).encode('utf-8', 'replace'))
    return h.hexdigest()


def spec_token(schema_view=None, predicate=None, transform_spec=None):
    """Digest of the decode identity: the columns, the row filter and the
    transform (its ``cache_token`` when it declares one, else its function's
    stable identity)."""
    parts = []
    if schema_view is not None:
        parts.append('cols=%s' % ','.join(sorted(schema_view.fields)))
    if predicate is not None:
        fields = sorted(getattr(predicate, 'get_fields', lambda: ())() or ())
        parts.append('pred=%s:%s:%s' % (type(predicate).__name__, fields,
                                        _stable_value(getattr(predicate, '__dict__', {}))))
    if transform_spec is not None:
        token = getattr(transform_spec, 'cache_token', None)
        if not token:
            func = getattr(transform_spec, 'func', None)
            token = _stable_value(func) if func is not None else 'none'
        parts.append('tf=%s:%s:%s' % (
            token,
            sorted(getattr(transform_spec, 'removed_fields', ()) or ()),
            sorted(getattr(transform_spec, 'selected_fields', ()) or ())))
    return hashlib.blake2b('|'.join(parts).encode('utf-8', 'replace'),
                           digest_size=8).hexdigest()
