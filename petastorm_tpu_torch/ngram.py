"""NGram: windows of consecutive rows over timestamp-sorted data (sensor logs).

Counterpart of ``petastorm_tpu/ngram.py``.  ``fields`` maps a relative
offset to the fields read at that timestep; the row worker sorts each row
group by ``timestamp_field`` after decode and transform and emits sliding
windows ``{offset: row}``, leaving out a window with a gap between two
consecutive timestamps above ``delta_threshold``.  Windows never span row
groups, which keeps row groups independent across workers.

``timestamp_overlap=False`` takes the timestamp-range rule: a stable window
is emitted only when its first timestamp is strictly greater than the last
emitted window's final timestamp, so emitted windows never overlap in time
(with duplicate timestamps this is stricter than a stride of the window
length).  An instance pickles, so it reaches process-pool workers.
"""

import numbers

from petastorm_tpu_torch.unischema import UnischemaField, match_unischema_fields

__all__ = ['NGram']


class NGram(object):
    def __init__(self, fields, delta_threshold, timestamp_field, timestamp_overlap=True):
        if not isinstance(fields, dict) or not fields:
            raise ValueError('fields must be a non-empty {offset: [fields]} dict')
        for offset in fields:
            if not isinstance(offset, numbers.Integral):
                raise ValueError('NGram offsets must be integers, got %r' % (offset,))
        self._fields = {int(k): list(v) for k, v in fields.items()}
        self._delta_threshold = delta_threshold
        self._timestamp_field = timestamp_field
        self._timestamp_overlap = timestamp_overlap
        self._min_offset = min(self._fields)
        self._max_offset = max(self._fields)

    # -- introspection -------------------------------------------------------

    @property
    def fields(self):
        return self._fields

    @property
    def delta_threshold(self):
        return self._delta_threshold

    @property
    def length(self):
        """Window length in timesteps (offsets may be sparse within it)."""
        return self._max_offset - self._min_offset + 1

    @property
    def timestamp_field_name(self):
        f = self._timestamp_field
        return f.name if isinstance(f, UnischemaField) else f

    def get_field_names_at_timestep(self, offset):
        return [f.name if isinstance(f, UnischemaField) else f
                for f in self._fields.get(offset, [])]

    def get_field_names_at_all_timesteps(self):
        """Every field (or regex) any timestep needs, plus the timestamp."""
        names = {f.name if isinstance(f, UnischemaField) else f
                 for flist in self._fields.values() for f in flist}
        names.add(self.timestamp_field_name)
        return sorted(names)

    def resolve_regex_field_names(self, schema):
        """Replace regex/str entries with concrete UnischemaFields from schema."""
        resolved = {}
        for offset, flist in self._fields.items():
            out = []
            for f in flist:
                if isinstance(f, UnischemaField):
                    out.append(f)
                else:
                    matched = match_unischema_fields(schema, [f])
                    if not matched:
                        raise ValueError('NGram field pattern %r matches nothing in schema %r'
                                         % (f, schema.name))
                    out.extend(matched)
            resolved[offset] = out
        self._fields = resolved
        if not isinstance(self._timestamp_field, UnischemaField):
            matched = match_unischema_fields(schema, [self._timestamp_field])
            if len(matched) != 1:
                raise ValueError('timestamp_field %r must match exactly one field'
                                 % (self._timestamp_field,))
            self._timestamp_field = matched[0]

    def get_schema_at_timestep(self, schema, offset):
        names = set(self.get_field_names_at_timestep(offset))
        return schema.create_schema_view(
            [f for name, f in schema.fields.items() if name in names])

    # -- window assembly (runs in the worker) --------------------------------

    def form_sequences(self, rows, schema_view):
        """Sort rows by timestamp and emit the stable windows as
        ``{offset: row_dict}``, each row cut to its offset's fields."""
        ts_name = self.timestamp_field_name
        rows = sorted(rows, key=lambda r: r[ts_name])
        length = self.length
        names = {offset: set(self.get_field_names_at_timestep(offset)) for offset in self._fields}
        windows = []
        prev_end_ts = None
        for i in range(len(rows) - length + 1):
            window = rows[i:i + length]
            if not self._window_is_stable(window, ts_name):
                continue
            if (not self._timestamp_overlap and prev_end_ts is not None
                    and window[0][ts_name] <= prev_end_ts):
                # Timestamp ranges may not overlap: this window starts at or
                # before the last emitted window's final timestamp.
                continue
            windows.append({offset: {k: v for k, v in window[offset - self._min_offset].items()
                                     if k in names[offset]}
                            for offset in self._fields})
            prev_end_ts = window[-1][ts_name]
        return windows

    def _window_is_stable(self, window, ts_name):
        if self._delta_threshold is None:
            return True
        for a, b in zip(window, window[1:]):
            if b[ts_name] - a[ts_name] > self._delta_threshold:
                return False
        return True
