"""Sequence packing: fixed-shape batches from variable-length sequences.

Counterpart of ``petastorm_tpu/jax/packing.py``.  Several sequences lie end
to end in one row of length ``max_len`` and ``segment_ids`` records which
sequence owns each position (1-based per row, 0 marks padding), so a batch
has one shape whatever the documents' lengths.

Host side (numpy, bit for bit the JAX package's, dtypes included):

* :func:`pack_sequences` -- first-fit-decreasing over a list of sequences;
* :func:`pack_stream` -- the streaming best-fit packer over an iterator;
* :class:`StreamPacker` -- its engine, with ``state_dict`` /
  ``load_state_dict`` for the residue (open rows, closed rows, sticky
  dtype).

Device side (torch):

* :func:`segment_mask` -- the block-diagonal (optionally causal) mask;
* :func:`packed_attention` -- dense attention restricted to segments, a
  drop-in ``attn_fn`` for ``TransformerLM``;
* :func:`next_token_targets` -- LM targets and loss weights that never
  cross a packing boundary.

Segments within a row are contiguous, so "causal within the segment" is
"row-causal and same segment".
"""

import numpy as np
import torch

__all__ = ['pack_sequences', 'pack_stream', 'StreamPacker', 'segment_mask',
           'packed_attention', 'next_token_targets']


def _emit(rows, max_len, dtype, pad_id):
    """Render packed rows (lists of sequences) to the batch dict;
    ``dtype=None`` promotes over this batch's sequences."""
    n = len(rows)
    if dtype is None:
        dtype = np.result_type(*[s.dtype for seqs in rows for s in seqs])
    tokens = np.full((n, max_len), pad_id, dtype)
    segment_ids = np.zeros((n, max_len), np.int32)
    positions = np.zeros((n, max_len), np.int32)
    for r, seqs in enumerate(rows):
        off = 0
        for s, seq in enumerate(seqs):
            length = len(seq)
            tokens[r, off:off + length] = seq
            segment_ids[r, off:off + length] = s + 1
            positions[r, off:off + length] = np.arange(length)
            off += length
    return {'tokens': tokens, 'segment_ids': segment_ids, 'positions': positions}


def pack_sequences(sequences, max_len, pad_id=0):
    """Pack 1-D arrays into ``(rows, max_len)`` by first-fit-decreasing.

    Returns ``{'tokens', 'segment_ids', 'positions'}``; ``positions``
    restarts at 0 for each sequence.  Raises if a sequence exceeds
    ``max_len``.
    """
    seqs = [np.asarray(s) for s in sequences]
    if not seqs:
        raise ValueError('no sequences to pack')
    for s in seqs:
        if s.ndim != 1:
            raise ValueError('expected 1-D sequences, got shape %r' % (s.shape,))
        if len(s) > max_len:
            raise ValueError('sequence of length %d exceeds max_len=%d; truncate upstream'
                             % (len(s), max_len))
    order = sorted(range(len(seqs)), key=lambda i: -len(seqs[i]))
    rows, room = [], []
    for i in order:
        length = len(seqs[i])
        for r in range(len(rows)):          # first fit
            if room[r] >= length:
                rows[r].append(seqs[i])
                room[r] -= length
                break
        else:
            rows.append([seqs[i]])
            room.append(max_len - length)
    return _emit(rows, max_len, np.result_type(*seqs), pad_id)


def pack_stream(seq_iter, max_len, rows_per_batch, pad_id=0, open_rows=32, drop_last=False):
    """Greedy streaming packer: yields fixed-shape batches from an iterator
    of sequences (best fit among up to ``open_rows`` open rows).  The tail
    is flushed as a final batch padded with all-padding rows unless
    ``drop_last``.  The token dtype is sticky: each batch takes the
    promotion of every sequence dtype seen so far."""
    packer = StreamPacker(max_len, rows_per_batch, pad_id=pad_id, open_rows=open_rows,
                          drop_last=drop_last)
    for seq in seq_iter:
        yield from packer.add(seq)
    yield from packer.flush()


class StreamPacker(object):
    """The stateful engine under :func:`pack_stream`: ``add(seq)`` returns
    the batches that became ready, ``flush()`` drains the tail."""

    def __init__(self, max_len, rows_per_batch, pad_id=0, open_rows=32, drop_last=False):
        if rows_per_batch < 1 or open_rows < 1:
            raise ValueError('rows_per_batch and open_rows must be >= 1')
        self._max_len = max_len
        self._rows_per_batch = rows_per_batch
        self._pad_id = pad_id
        self._open_rows = open_rows
        self._drop_last = drop_last
        self._open = []      # list of (room, [seqs])
        self._closed = []
        self._dtype = None   # promoted over everything seen; never narrows

    def _close_fullest(self):
        i = min(range(len(self._open)), key=lambda j: self._open[j][0])
        self._closed.append(self._open.pop(i)[1])

    def _ready_batches(self):
        out = []
        while len(self._closed) >= self._rows_per_batch:
            out.append(_emit(self._closed[:self._rows_per_batch], self._max_len, self._dtype,
                             self._pad_id))
            self._closed = self._closed[self._rows_per_batch:]
        return out

    def add(self, seq):
        """Fold one sequence in; returns the batches that became ready."""
        seq = np.asarray(seq)
        if seq.ndim != 1:
            raise ValueError('expected 1-D sequences, got %r' % (seq.shape,))
        self._dtype = seq.dtype if self._dtype is None else np.result_type(self._dtype,
                                                                            seq.dtype)
        max_len = self._max_len
        if len(seq) > max_len:
            raise ValueError('sequence of length %d exceeds max_len=%d' % (len(seq), max_len))
        if len(seq) == max_len:     # exactly-full row: close it now
            self._closed.append([seq])
        else:
            fits = [i for i, (room, _) in enumerate(self._open) if room >= len(seq)]
            if fits:
                i = min(fits, key=lambda j: self._open[j][0])   # best fit
                room, seqs = self._open[i]
                seqs.append(seq)
                self._open[i] = (room - len(seq), seqs)
                if self._open[i][0] == 0:
                    self._closed.append(self._open.pop(i)[1])
            else:
                self._open.append((max_len - len(seq), [seq]))
                if len(self._open) > self._open_rows:
                    self._close_fullest()
        return self._ready_batches()

    def flush(self):
        """Drain open rows; returns the final batches (the tail padded with
        all-padding rows to full shape unless ``drop_last``)."""
        self._closed.extend(seqs for _, seqs in sorted(self._open, key=lambda e: e[0]))
        self._open = []
        out = self._ready_batches()
        if self._closed and not self._drop_last:
            pad_rows = self._rows_per_batch - len(self._closed)
            batch = _emit(self._closed, self._max_len, self._dtype, self._pad_id)
            if pad_rows:
                batch = {k: np.concatenate([v, np.zeros((pad_rows,) + v.shape[1:], v.dtype)])
                         for k, v in batch.items()}
                if self._pad_id != 0:
                    batch['tokens'][-pad_rows:] = self._pad_id
            out.append(batch)
        self._closed = []
        return out

    def state_dict(self):
        """The residue: open rows, closed rows and the sticky dtype."""
        return {'open': [(room, [np.asarray(s) for s in seqs]) for room, seqs in self._open],
                'closed': [[np.asarray(s) for s in seqs] for seqs in self._closed],
                'dtype': None if self._dtype is None else np.dtype(self._dtype).str}

    def load_state_dict(self, state):
        self._open = [(room, list(seqs)) for room, seqs in state['open']]
        self._closed = [list(seqs) for seqs in state['closed']]
        self._dtype = None if state['dtype'] is None else np.dtype(state['dtype'])


def segment_mask(segment_ids_q, segment_ids_kv, causal=False):
    """Boolean mask ``[batch, 1, len_q, len_kv]``: a query attends a key iff
    both carry the same nonzero segment id (and, with ``causal``, the key
    is not after the query)."""
    q = torch.as_tensor(segment_ids_q)
    kv = torch.as_tensor(segment_ids_kv, device=q.device)
    mask = (q[:, :, None] == kv[:, None, :]) & (q[:, :, None] != 0)
    if causal:
        lq, lkv = q.shape[-1], kv.shape[-1]
        mask = mask & (torch.arange(lkv, device=q.device)[None, :]
                       <= torch.arange(lq, device=q.device)[:, None])
    return mask[:, None, :, :]


def packed_attention(q, k, v, segment_ids, causal=True, scale=None):
    """Dense attention over packed rows (``[batch, seq, heads, head_dim]``):
    segments never attend each other.  Scores and softmax in fp32, the
    weights cast to q's dtype for the product with ``v``.  Fully masked
    query rows (padding) get a finite row and are zeroed after."""
    if q.dim() != 4:
        raise ValueError('expected [batch, seq, heads, head_dim], got %r' % (tuple(q.shape),))
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    mask = segment_mask(segment_ids, segment_ids, causal=causal)
    scores = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    scores = scores.masked_fill(~mask, float('-inf'))
    any_valid = mask.any(dim=-1, keepdim=True)
    scores = torch.where(any_valid, scores, 0.0)
    weights = torch.where(any_valid, torch.softmax(scores, dim=-1), 0.0)
    return torch.einsum('bhqk,bkhd->bqhd', weights.to(q.dtype), v)


def next_token_targets(tokens, segment_ids):
    """LM ``(targets, weights)`` that never cross a packing boundary:
    ``targets[t] = tokens[t+1]``, ``weights[t] = 1`` only where ``t`` and
    ``t+1`` share a nonzero segment.  numpy in, numpy out; torch in, torch
    out (float32 weights either way)."""
    if isinstance(tokens, torch.Tensor):
        segment_ids = torch.as_tensor(segment_ids, device=tokens.device)
        targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
        seg_next = torch.cat([segment_ids[:, 1:], torch.zeros_like(segment_ids[:, :1])], dim=1)
        return targets, ((segment_ids == seg_next) & (segment_ids != 0)).float()
    targets = np.concatenate([tokens[:, 1:], np.zeros_like(tokens[:, :1])], axis=1)
    seg_next = np.concatenate([segment_ids[:, 1:], np.zeros_like(segment_ids[:, :1])], axis=1)
    return targets, ((segment_ids == seg_next) & (segment_ids != 0)).astype(np.float32)
