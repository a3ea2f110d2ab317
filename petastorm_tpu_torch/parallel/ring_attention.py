"""Sequence parallelism over ``torch.distributed``: ring attention and
all-to-all (Ulysses) attention.

Counterpart of ``petastorm_tpu/parallel/ring_attention.py``.  The JAX
functions run inside ``shard_map`` on local blocks; here each rank runs them
on its own local blocks ``[batch, seq_local, heads, head_dim]``, and the
collectives the JAX package gets from ``ppermute`` and ``all_to_all`` are
written out:

* :func:`ring_attention`: the sequence is split over a mesh axis; each rank
  holds one contiguous Q/K/V block, and K/V blocks rotate one hop down the
  ring per step (``batch_isend_irecv`` in a differentiable rotation whose
  backward rotates the gradient back up, ``ppermute``'s transpose).  The
  softmax is folded online (running max and sum) with plain products, as
  the JAX package's ``_online_block`` is plain ``einsum`` outside any
  kernel.  ``block_k`` chunks each hop's block; chunks and hops then run
  under ``torch.utils.checkpoint``, as the JAX package's ``jax.checkpoint``.
* :func:`ulysses_attention`: each rank trades its sequence block for a head
  block (a differentiable ``all_to_all_single``), runs local attention over
  the whole sequence (the flash kernels, through ``make_attn_fn``), and
  trades back.

On an axis of one rank neither moves anything: the JAX package's
``ppermute`` to itself and ``all_to_all`` over one device are identities,
and a one-rank group cannot send to itself.  The rank's coordinate on the
axis is a host integer, so the causal masks are fixed per rank and a step
that runs them can be captured in a CUDA graph.
"""

import functools

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from petastorm_tpu_torch.ops.flash_attention import NEG_INF, full_attention
from petastorm_tpu_torch.parallel.mesh import NamedSharding, axis_index, axis_size

__all__ = ['full_attention', 'ring_attention', 'ulysses_attention', 'make_ring_attention',
           'make_ulysses_attention', 'SeqAxis']


class SeqAxis(object):
    """One mesh axis as the ring sees it: ``size``, this rank's ``index``
    on it, the global ``ranks`` along it and its process ``group``
    (``None`` for an axis of one rank)."""

    def __init__(self, mesh=None, name='seq'):
        if mesh is None:
            self.size, self.index, self.ranks, self.group = 1, 0, None, None
            return
        if name not in mesh.mesh_dim_names:
            raise ValueError('axis %r is not in the mesh %r' % (name, mesh.mesh_dim_names))
        self.size, self.index = axis_size(mesh, name), axis_index(mesh, name)
        self.group = mesh.get_group(name)
        self.ranks = dist.get_process_group_ranks(self.group)
        dim = mesh.mesh_dim_names.index(name)
        along = mesh.mesh.movedim(dim, -1).reshape(-1, self.size)
        mine = [row.tolist() for row in along if dist.get_rank() in row.tolist()][0]
        if mine != self.ranks:
            # all_to_all_single orders its chunks by group rank
            raise ValueError('the ranks along axis %r are %s; the group orders them %s: '
                             'lay the mesh out in ascending rank order' % (name, mine, self.ranks))

    def neighbour(self, hops):
        """The global rank ``hops`` positions down the ring."""
        return self.ranks[(self.index + hops) % self.size]


def _exchange(tensors, send_to, recv_from, group):
    """Send each tensor to ``send_to`` and receive its like from
    ``recv_from``, all posted together."""
    tensors = [t.contiguous() for t in tensors]
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, send_to, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, recv_from, group) for r in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Rotate(torch.autograd.Function):
    """One hop of the ring (``ppermute`` with ``perm = [(j, j + 1)]``); its
    gradient travels the other way."""

    @staticmethod
    def forward(ctx, axis, tensor):
        ctx.axis = axis
        return _exchange([tensor], axis.neighbour(1), axis.neighbour(-1), axis.group)[0]

    @staticmethod
    def backward(ctx, grad):
        axis = ctx.axis
        return None, _exchange([grad], axis.neighbour(-1), axis.neighbour(1), axis.group)[0]


def _rotate(axis, tensor, differentiable=True):
    if axis.size == 1:
        return tensor
    if differentiable:
        return _Rotate.apply(axis, tensor)
    return _exchange([tensor], axis.neighbour(1), axis.neighbour(-1), axis.group)[0]


def _segment_mask(seg_q, seg_k):
    """[b, q, k] bool: same NONZERO segment (the packed-row attention rule)."""
    return (seg_q[:, :, None] == seg_k[:, None, :]) & (seg_q[:, :, None] != 0)


def _online_block(q, k, v, o, l, m, q_offset, kv_offset, causal, scale,
                  kv_valid=None, seg_q=None, seg_k=None):
    """Fold one K/V block into the running (o, l, m) accumulator.

    o: [b, q, h, d] unnormalised output, l: [b, h, q] running softmax
    denominator, m: [b, h, q] running max, all fp32.  ``q_offset`` and
    ``kv_offset`` are the blocks' global sequence positions (for the causal
    mask).  ``kv_valid``: positions >= it in this K block are padding.
    ``seg_q``/``seg_k``: [b, q]/[b, k] packed segment ids (0 = padding).
    The products take their inputs' values in fp32 (JAX's
    ``preferred_element_type=float32``)."""
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    k_pos = torch.arange(k.shape[1], device=q.device)
    if kv_valid is not None:
        s = torch.where(k_pos[None, :] < kv_valid, s, NEG_INF)
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        s = torch.where(q_pos[:, None] >= (kv_offset + k_pos)[None, :], s, NEG_INF)
    if seg_q is not None:
        s = torch.where(_segment_mask(seg_q, seg_k)[:, None, :, :], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # exp(NEG_INF - NEG_INF) would be 1 for fully-masked rows; gate to 0.
    alpha = torch.where(m == NEG_INF, 0.0, torch.exp(m - m_new))
    p = torch.where(m_new[..., None] == NEG_INF, 0.0, torch.exp(s - m_new[..., None]))
    l_new = l * alpha + p.sum(dim=-1)
    o_new = (o * alpha.permute(0, 2, 1)[..., None]
             + torch.einsum('bhqk,bkhd->bqhd', p.to(v.dtype).float(), v.float()))
    return o_new, l_new, m_new


def _remat(fn, *args):
    # no RNG to stash, and a stash would read the card's generator inside a
    # CUDA-graph capture
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def ring_attention(q, k, v, axis=None, causal=False, scale=None, block_k=None,
                   segment_ids=None):
    """Ring attention over a sequence split along ``axis`` (a
    :class:`SeqAxis`; ``None`` is an axis of one rank).

    Arguments are this rank's blocks ``[batch, seq_local, heads,
    head_dim]``.  Runs ``axis.size`` hops: hop i folds the K/V block that
    started i hops up the ring, at its global offset, then K/V rotate one
    hop down (the last hop keeps its block).

    ``block_k`` chunks each hop's block: K/V are padded and laid out in
    chunks once, only the last padded chunk pays a validity mask, and every
    chunk and every hop is recomputed in the backward pass rather than
    stored.  ``segment_ids`` (this rank's ``[batch, seq_local]`` packed
    ids, 0 = padding) rotate with their K/V block.  Fully masked rows give
    0.  The result has q's dtype."""
    axis = axis if axis is not None else SeqAxis()
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    n, my_idx = axis.size, axis.index
    b, q_len, h, d = q.shape
    kv_len = k.shape[1]
    packed = segment_ids is not None
    seg_q = segment_ids.to(device=q.device, dtype=torch.int32) if packed else None
    seg_kv = seg_q
    kv = torch.stack([k, v])          # one message a hop

    if block_k is not None:
        if block_k < 1:
            raise ValueError('block_k must be >= 1, got %r' % (block_k,))
        pad = (-kv_len) % block_k
        if pad:
            kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, pad))
        n_chunks = (kv_len + pad) // block_k
        # [2, n_chunks, b, block_k, h, d]: chunked once; the ring rotates this layout
        kv = kv.reshape(2, b, n_chunks, block_k, h, d).movedim(2, 1)
        if packed:
            seg_kv = torch.nn.functional.pad(seg_kv, (0, pad)).reshape(
                b, n_chunks, block_k).movedim(1, 0)

        def one_chunk(qc, kc, vc, skc, oc, lc, mc, kv_offset, kv_valid):
            return _online_block(qc, kc, vc, oc, lc, mc, q_offset=my_idx * q_len,
                                 kv_offset=kv_offset, causal=causal, scale=scale,
                                 kv_valid=kv_valid, seg_q=seg_q, seg_k=skc)

        def hop_fold(q_, kv_blk, sk_blk, o, l, m, kv_idx):
            acc = (o, l, m)
            for j in range(n_chunks):
                last = pad and j == n_chunks - 1
                fold = functools.partial(one_chunk, kv_offset=kv_idx * kv_len + j * block_k,
                                         kv_valid=kv_len - j * block_k if last else None)
                acc = _remat(fold, q_, kv_blk[0, j], kv_blk[1, j],
                             sk_blk[j] if packed else None, *acc)
            return acc

    o = torch.zeros((b, q_len, h, d), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, q_len), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, q_len), NEG_INF, dtype=torch.float32, device=q.device)
    kv_blk, sk_blk = kv, seg_kv
    for i in range(n):
        kv_idx = (my_idx - i) % n     # origin of the block in hand
        # Every hop folds, also one the causal mask hides whole: its block's
        # gradient (zero) must travel back, since the rank that sent it waits
        # in the same rotation's backward.
        if block_k is not None:
            o, l, m = _remat(functools.partial(hop_fold, kv_idx=kv_idx),
                             q, kv_blk, sk_blk, o, l, m)
        else:
            o, l, m = _online_block(q, kv_blk[0], kv_blk[1], o, l, m,
                                    q_offset=my_idx * q_len, kv_offset=kv_idx * kv_len,
                                    causal=causal, scale=scale, seg_q=seg_q,
                                    seg_k=sk_blk if packed else None)
        if i + 1 < n:
            kv_blk = _rotate(axis, kv_blk)
            if packed:
                sk_blk = _rotate(axis, sk_blk, differentiable=False)
    l = torch.where(l == 0.0, 1.0, l)     # fully-masked rows yield 0, not NaN
    out = o / l.permute(0, 2, 1)[..., None]
    return out.to(q.dtype)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over dim 0 of ``[n, ...]`` (chunk j to and from
    rank j of the group); its gradient is the same exchange."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return None, _all_to_all(grad, ctx.group)


def _all_to_all(x, group):
    x = x.contiguous()           # the collective reads and writes dense memory
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _seq_to_heads(axis, x):
    """[b, s/n, h, d] -> [b, s, h/n, d] (JAX's tiled all_to_all with
    split_axis=2, concat_axis=1)."""
    n = axis.size
    b, s_loc, h, d = x.shape
    chunks = x.reshape(b, s_loc, n, h // n, d).permute(2, 0, 1, 3, 4)
    got = _AllToAll.apply(axis.group, chunks)         # got[j]: rank j's block, my heads
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * s_loc, h // n, d)


def _heads_to_seq(axis, x):
    """[b, s, h/n, d] -> [b, s/n, h, d] (split_axis=1, concat_axis=2)."""
    n = axis.size
    b, s, h_loc, d = x.shape
    chunks = x.reshape(b, n, s // n, h_loc, d).permute(1, 0, 2, 3, 4)
    got = _AllToAll.apply(axis.group, chunks)         # got[j]: my block, rank j's heads
    return got.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * h_loc, d)


def ulysses_attention(q, k, v, axis=None, causal=False, scale=None, attn_fn=None,
                      segment_ids=None):
    """All-to-all sequence parallelism over ``axis`` (a :class:`SeqAxis`).

    This rank's blocks ``[batch, seq_local, heads, head_dim]``; ``heads``
    must be divisible by the axis size.  Re-shards seq -> heads, runs
    ``attn_fn`` (default :func:`full_attention`) over the whole sequence,
    re-shards back.  ``segment_ids`` (this rank's ``[batch, seq_local]``)
    are all-gathered along the axis; ``attn_fn`` must then take a
    ``segment_ids`` keyword."""
    axis = axis if axis is not None else SeqAxis()
    h = q.shape[2]
    if h % axis.size:
        raise ValueError('heads=%d not divisible by axis size %d' % (h, axis.size))
    attn_fn = attn_fn or full_attention
    kwargs = {}
    if segment_ids is not None:
        seg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
        if axis.size > 1:
            parts = [torch.empty_like(seg) for _ in range(axis.size)]
            dist.all_gather(parts, seg, group=axis.group)
            seg = torch.cat(parts, dim=1)
        kwargs['segment_ids'] = seg
    if axis.size == 1:
        return attn_fn(q, k, v, causal=causal, scale=scale, **kwargs)
    out = attn_fn(_seq_to_heads(axis, q), _seq_to_heads(axis, k), _seq_to_heads(axis, v),
                  causal=causal, scale=scale, **kwargs)
    return _heads_to_seq(axis, out)


def _make_sp_fn(inner, mesh, seq_axis, batch_axis, head_axis=None, packed=False):
    names = mesh.mesh_dim_names
    batch_spec = batch_axis if batch_axis in names else None
    head_spec = head_axis if head_axis in names else None
    sharding = NamedSharding(mesh, (batch_spec, seq_axis, head_spec, None))
    axis = SeqAxis(mesh, seq_axis)
    if packed:
        # fn(q, k, v, segment_ids): ids are split like the sequence
        def fn(q, k, v, segment_ids):
            return inner(q, k, v, axis, segment_ids=segment_ids)
    else:
        def fn(q, k, v):
            return inner(q, k, v, axis)
    return fn, sharding


def make_ring_attention(mesh, seq_axis='seq', batch_axis='data', head_axis=None, causal=False,
                        scale=None, block_k=None, packed=False):
    """Ring attention over ``mesh``'s ``seq_axis``.

    Returns ``(fn, sharding)``: ``fn(q, k, v)`` on this rank's blocks
    ``[batch, seq_local, heads, head_dim]`` of global arrays whose seq dim
    is split over ``seq_axis`` (and batch and heads over ``batch_axis`` and
    ``head_axis`` when the mesh has them: heads are independent, so a head
    split composes with the ring); ``sharding`` is the
    :class:`~petastorm_tpu_torch.parallel.mesh.NamedSharding` of those
    arrays.  With ``packed=True`` the fn is ``fn(q, k, v, segment_ids)``,
    the ids split along the sequence like it."""
    inner = functools.partial(ring_attention, causal=causal, scale=scale, block_k=block_k)
    return _make_sp_fn(inner, mesh, seq_axis, batch_axis, head_axis, packed=packed)


def make_ulysses_attention(mesh, seq_axis='seq', batch_axis='data', head_axis=None,
                           causal=False, scale=None, attn_fn=None, packed=False):
    """All-to-all attention over ``mesh`` (see :func:`make_ring_attention`).
    With ``head_axis`` the local head count must still be divisible by the
    ``seq_axis`` size; with ``packed=True`` ``attn_fn`` must take
    ``segment_ids``."""
    inner = functools.partial(ulysses_attention, causal=causal, scale=scale, attn_fn=attn_fn)
    return _make_sp_fn(inner, mesh, seq_axis, batch_axis, head_axis, packed=packed)
