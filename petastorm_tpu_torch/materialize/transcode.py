"""Wire-format pre-transcode: publish entries already narrowed.

Counterpart of ``petastorm_tpu/materialize/transcode.py``.  A raw
materialized entry saves the decode; a consumer's transfer plane still
collates and narrows it by the wire policy every epoch.  This module builds
a second entry per piece, the stacked columns already cast to their wire
dtypes, published under the key suffix ``:w{policy}``.

The narrowing rules are the transfer plane's
(:func:`petastorm_tpu_torch.gpu.transfer.wire_dtype_for`), copied here in
numpy because this module loads no torch (the controller runs beside the
decode workers): a column's device dtype is JAX's without x64 (int64 ->
int32, uint64 -> uint32, float64 -> float32); ``'auto'`` narrows floats of
32 bits or more to bfloat16; a ``{field: dtype}`` dict names fields.
numpy has no bfloat16, so a bfloat16 column is kept as the ``uint16`` of
its bits (fp32 rounded to nearest even, NaN quieted with its sign, as
``ml_dtypes`` rounds), and the entry names each column's wire dtype under
``'wire'``: widening is then an exact shift.  The narrowed bits are the
JAX entry's bfloat16 array's, and :func:`widen_entry` returns the JAX
function's arrays bit for bit.

Entries describe themselves (the policy token, each column's wire and
output dtype), so a serve needs no side channel to widen.  Columns outside
the support matrix, or a policy that narrows nothing, publish no wire entry:
the raw entry covers them.
"""

import hashlib
import logging

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ['policy_token', 'wire_key', 'wire_entry', 'widen_entry', 'is_wire_entry',
           'verify_wire_identity', 'to_bfloat16_bits', 'from_bfloat16_bits']

_WIRE_SUFFIX = ':w{%s}'

BFLOAT16 = 'bfloat16'

#: ``np.dtype(ml_dtypes.bfloat16).str``: how the JAX package's policy token
#: spells bfloat16.
_BF16_STR = '<V2'

#: A column's device dtype (JAX's canonical dtype without x64).
_CANONICAL = {np.dtype('int64'): np.dtype('int32'),
              np.dtype('uint64'): np.dtype('uint32'),
              np.dtype('float64'): np.dtype('float32')}

_SUPPORTED = frozenset(np.dtype(name) for name in (
    'bool', 'uint8', 'int8', 'int16', 'int32', 'int64', 'uint16', 'uint32', 'uint64',
    'float16', 'float32', 'float64'))


def _is_bf16(dtype):
    return str(dtype) == BFLOAT16 or getattr(dtype, '__name__', None) == BFLOAT16


def _dtype_str(dtype):
    return _BF16_STR if _is_bf16(dtype) else np.dtype(dtype).str


def policy_token(policy):
    """The stable string identity of a wire policy (``'auto'`` or a
    per-field dtype map), part of the cache key, so that a change of policy
    publishes anew: the JAX package's token for the same policy."""
    if not policy:
        return 'none'
    if isinstance(policy, str):
        return policy
    if isinstance(policy, dict):
        body = ','.join('%s=%s' % (k, _dtype_str(v)) for k, v in sorted(policy.items()))
        return hashlib.blake2b(body.encode('utf-8'), digest_size=6).hexdigest()
    return hashlib.blake2b(repr(policy).encode('utf-8'), digest_size=6).hexdigest()


def wire_key(cache_key, policy):
    """The plane key of a piece's wire entry: the piece's raw result-cache
    key plus the policy suffix."""
    return cache_key + _WIRE_SUFFIX % policy_token(policy)


def to_bfloat16_bits(values):
    """float -> the ``uint16`` bits of bfloat16, rounded to nearest even
    (through float32, as ``ml_dtypes`` casts a float64); a NaN becomes the
    quiet NaN of its sign."""
    bits = np.ascontiguousarray(values, dtype=np.float32).view(np.uint32)
    rounded = (bits + (np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))))
    out = (rounded >> np.uint32(16)).astype(np.uint16)
    nan = (bits & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    if nan.any():
        out[nan] = np.where((bits[nan] >> np.uint32(31)) != 0, 0xFFC0, 0x7FC0).astype(np.uint16)
    return out


def from_bfloat16_bits(bits):
    """The ``uint16`` bits of bfloat16 -> float32, exactly."""
    return (np.asarray(bits, dtype=np.uint16).astype(np.uint32) << np.uint32(16)).view(np.float32)


def _plan(columns, policy):
    """``{name: (wire, out)}`` per column (wire ``'bfloat16'`` or a numpy
    dtype), or None when a column falls outside the support matrix."""
    plan = {}
    for name in sorted(columns):
        arr = np.asarray(columns[name])
        if arr.ndim < 1 or arr.dtype not in _SUPPORTED:
            return None
        out = _CANONICAL.get(arr.dtype, arr.dtype)
        if not policy:
            wire = out
        elif policy == 'auto':
            wire = BFLOAT16 if out.kind == 'f' and out.itemsize >= 4 else out
        else:
            want = policy.get(name)
            wire = out if want is None else (BFLOAT16 if _is_bf16(want) else np.dtype(want))
        if wire != BFLOAT16 and wire not in _SUPPORTED:
            return None
        plan[name] = (wire, out)
    return plan


def _narrow(col, wire):
    if wire == BFLOAT16:
        return to_bfloat16_bits(col)
    return np.asarray(col).astype(wire, copy=False)


def wire_entry(columns, policy='auto'):
    """The wire entry of one piece's stacked columns, or None when the piece
    cannot ride (an unsupported dtype, no columns, or a policy that narrows
    nothing: a copy equal to the raw entry would only take plane space).

    ``{'__wire__': 1, 'policy', 'columns', 'out', 'wire'}``: the narrowed
    columns, each one's output dtype and its wire dtype's name."""
    if not isinstance(columns, dict) or not columns:
        return None
    if not all(isinstance(v, np.ndarray) for v in columns.values()):
        return None
    plan = _plan(columns, policy)
    if plan is None or not any(wire != out for wire, out in plan.values()):
        return None
    return {'__wire__': 1,
            'policy': policy_token(policy),
            'columns': {name: _narrow(columns[name], wire) for name, (wire, _) in plan.items()},
            'out': {name: out.str for name, (_, out) in plan.items()},
            'wire': {name: BFLOAT16 if wire == BFLOAT16 else wire.str
                     for name, (wire, _) in plan.items()}}


def is_wire_entry(value):
    return isinstance(value, dict) and value.get('__wire__') == 1


def widen_entry(entry):
    """The host-side inverse of the narrow: every column in its output dtype
    (exact for bfloat16 -> float32 and every exact wire)."""
    wires = entry.get('wire') or {}
    out = {}
    for name, col in entry['columns'].items():
        dtype = np.dtype(entry['out'][name])
        if wires.get(name) == BFLOAT16:
            out[name] = from_bfloat16_bits(col).astype(dtype, copy=False)
        else:
            out[name] = np.asarray(col).astype(dtype, copy=False)
    return out


def _nearest_bf16_bits(values):
    """The bfloat16 bits nearest each float32 value (ties to even),
    computed from the float64 distances to the two bfloat16 neighbours
    rather than by :func:`to_bfloat16_bits`' carry trick; NaN lanes come
    back as the quiet NaN of their sign."""
    bits = np.ascontiguousarray(values, dtype=np.float32).ravel().view(np.uint32)
    sign = (bits >> np.uint32(16)) & np.uint32(0x8000)
    mag = bits & np.uint32(0x7FFFFFFF)
    lo = mag & np.uint32(0xFFFF0000)
    hi = lo + np.uint32(0x10000)
    lo_f = lo.view(np.float32).astype(np.float64)
    with np.errstate(over='ignore', invalid='ignore'):
        # past the largest bfloat16 the upper neighbour is 2^128 (overflow
        # rounds to infinity from half an ulp above the largest value)
        hi_f = np.where(hi == np.uint32(0x7F800000), 2.0 ** 128,
                        hi.view(np.float32).astype(np.float64))
        m = mag.view(np.float32).astype(np.float64)
        dl, dh = m - lo_f, hi_f - m
    up = (dh < dl) | ((dh == dl) & (((lo >> np.uint32(16)) & np.uint32(1)) == 1))
    out = (np.where(up, hi, lo) >> np.uint32(16)) | sign
    out = np.where(mag == np.uint32(0x7F800000), (mag >> np.uint32(16)) | sign, out)
    out = np.where(mag > np.uint32(0x7F800000), np.where(sign != 0, 0xFFC0, 0x7FC0), out)
    return out.astype(np.uint16).reshape(np.shape(values))


def verify_wire_identity(columns, entry, policy='auto'):
    """Check a freshly built wire entry against its source columns: every
    exact column is the source cast to its wire dtype, and widens to its
    output dtype bit for bit; every bfloat16 column holds the nearest
    bfloat16 of each source value (ties to even, found from the distances
    to its two neighbours) and widens to exactly those values.  True or
    False, never raises: a failed check refuses the wire publish, it must
    not stop the controller."""
    try:
        plan = _plan(columns, policy)
        if plan is None or set(plan) != set(entry['columns']):
            return False
        widened = widen_entry(entry)
        with np.errstate(over='ignore', invalid='ignore'):
            for name, (wire, out) in plan.items():
                src = np.asarray(columns[name])
                got, narrow = widened[name], np.asarray(entry['columns'][name])
                if got.dtype != out or got.shape != src.shape:
                    return False
                if wire != BFLOAT16:
                    expect = src.astype(wire)
                    if narrow.dtype != expect.dtype or narrow.tobytes() != expect.tobytes() \
                            or got.tobytes() != expect.astype(out).tobytes():
                        return False
                    continue
                if narrow.dtype != np.uint16 \
                        or not np.array_equal(narrow, _nearest_bf16_bits(src)):
                    return False
                exact = (narrow.astype(np.uint32) << np.uint32(16)).view(np.float32)
                if got.tobytes() != exact.astype(out).tobytes():
                    return False
        return True
    except Exception:  # noqa: BLE001 — a verify failure degrades, never raises
        logger.warning('materialize: wire identity verify failed', exc_info=True)
        return False
