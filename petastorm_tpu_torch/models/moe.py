"""Mixture-of-Experts FFN with all-to-all expert parallelism.

Counterpart of ``petastorm_tpu/models/moe.py``, the Switch pattern:

* **Routing**: Switch top-1.  A replicated router picks one expert per
  token, and the gate probability scales the expert's output (so the
  router's gradient flows through the gate).
* **Capacity**: each expert takes ``capacity`` token slots per rank and
  step (``capacity_factor`` times the fair share of the rank's tokens);
  tokens past it are dropped (contribute zero), in arrival order.
* **Dispatch**: one-hot dispatch and combine tensors turn routing into
  products, and two all-to-alls (``ring_attention._AllToAll``, whose
  backward is the reverse exchange, as JAX's ``_a2a``) move the slot
  buffers to the ranks that own the experts and back.

:func:`moe_apply` is the single-device oracle (every expert on every
token's device); :func:`make_expert_parallel_moe` returns the sharded
twin, which runs on this rank's tokens and experts.  Parameters are a dict
``{'router': [d, E], 'w1': [E, d, f], 'w2': [E, f, d]}``
(``convert.moe_params_from_flax`` carries the JAX package's across).
"""

import math

import torch
import torch.nn.functional as F

from petastorm_tpu_torch.parallel.mesh import NamedSharding
from petastorm_tpu_torch.parallel.ring_attention import SeqAxis, _AllToAll

__all__ = ['moe_init', 'moe_apply', 'make_expert_parallel_moe']


def moe_init(d_model, d_ff, num_experts, dtype=torch.float32, generator=None):
    """``{'router': [d, E], 'w1': [E, d, f], 'w2': [E, f, d]}``: normal draws
    scaled by ``1 / sqrt(fan_in)``, as the JAX package's ``moe_init``."""
    scale1, scale2 = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)

    def normal(*shape):
        return torch.randn(shape, generator=generator)
    return {'router': (normal(d_model, num_experts) * scale1).to(dtype),
            'w1': (normal(num_experts, d_model, d_ff) * scale1).to(dtype),
            'w2': (normal(num_experts, d_ff, d_model) * scale2).to(dtype)}


def _route(params, x, capacity):
    """Switch top-1 dispatch ``[T, E, C]`` (one-hot slots) and combine
    (dispatch times the gate) for the tokens ``x`` ``[T, d]``; a token past
    its expert's capacity gets an all-zero row (dropped)."""
    logits = x @ params['router']                                    # [T, E]
    probs = torch.softmax(logits.float(), dim=-1)
    expert = probs.argmax(dim=-1)                                    # first maximum, as jnp's
    gate = probs.gather(-1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, params['router'].shape[1]).float()    # [T, E]
    slot = (torch.cumsum(onehot, dim=0) - 1.0) * onehot              # arrival order
    kept = onehot * (slot < capacity)
    # jax.nn.one_hot of a slot past the capacity is all zeros
    slots = (slot[:, :, None] == torch.arange(capacity, device=x.device)).float()
    dispatch = kept[:, :, None] * slots                              # [T, E, C]
    return dispatch, dispatch * gate[:, None, None]


def _expert_ffn(w1, w2, xs):
    """Each expert's FFN over its slot buffer ``xs`` ``[E, C, d]``."""
    return torch.bmm(torch.relu(torch.bmm(xs, w1)), w2)


def _capacity(tokens, num_experts, capacity_factor):
    return max(1, int(math.ceil(tokens * capacity_factor / num_experts)))


def moe_apply(params, x, capacity_factor=2.0):
    """Single-device oracle: dense dispatch to every expert, no collective.
    ``x``: ``[T, d]`` tokens; returns ``[T, d]`` in x's dtype."""
    num_experts = params['router'].shape[1]
    capacity = _capacity(x.shape[0], num_experts, capacity_factor)
    dispatch, combine = _route(params, x, capacity)
    xs = torch.einsum('tec,td->ecd', dispatch, x.float())
    ys = _expert_ffn(params['w1'].float(), params['w2'].float(), xs)
    return torch.einsum('tec,ecd->td', combine, ys).to(x.dtype)


def make_expert_parallel_moe(mesh, num_experts, expert_axis='expert', batch_axis='data',
                             capacity_factor=2.0):
    """The MoE over ``mesh``: experts split over ``expert_axis`` (the leading
    E axis of ``w1``/``w2``), tokens over ``batch_axis`` and
    ``expert_axis`` (the expert axis doubles as data parallelism, the
    GShard layout), the router replicated.

    Returns ``(fn, param_shardings_fn, token_sharding)``: ``fn(params, x)``
    on this rank's parameter blocks and its tokens ``x`` ``[T_local, d]``
    (place them with :func:`petastorm_tpu_torch.parallel.device_put`,
    ``param_shardings_fn(params)`` and ``token_sharding``), returning this
    rank's outputs.  Capacity is computed per rank from its own token count,
    as the JAX package's.  ``num_experts`` must be divisible by the
    expert-axis size."""
    names = mesh.mesh_dim_names
    ep = SeqAxis(mesh, expert_axis).size if expert_axis in names else 1
    if num_experts % max(ep, 1):
        raise ValueError('num_experts=%d not divisible by %r axis size %d'
                         % (num_experts, expert_axis, ep))
    axis = SeqAxis(mesh, expert_axis) if ep > 1 else None
    experts_local = num_experts // ep

    def fn(params, x):
        capacity = _capacity(x.shape[0], num_experts, capacity_factor)
        dispatch, combine = _route(params, x, capacity)
        xs = torch.einsum('tec,td->ecd', dispatch, x.float())       # [E, C, d]
        d = xs.shape[-1]
        if ep > 1:
            # each expert block to its owner: [ep, El, C, d], got[i] from peer i
            got = _AllToAll.apply(axis.group, xs.reshape(ep, experts_local, capacity, d))
            xs = got.permute(1, 0, 2, 3).reshape(experts_local, ep * capacity, d)
        ys = _expert_ffn(params['w1'].float(), params['w2'].float(), xs)
        if ep > 1:
            # results back to the tokens' ranks, in the same expert-major order
            back = ys.reshape(experts_local, ep, capacity, d).permute(1, 0, 2, 3)
            ys = _AllToAll.apply(axis.group, back).reshape(num_experts, capacity, d)
        return torch.einsum('tec,ecd->td', combine, ys).to(x.dtype)

    expert_spec = expert_axis if expert_axis in names else None
    token_axes = tuple(a for a in (batch_axis, expert_axis) if a in names)
    token_spec = (token_axes,) if token_axes else ()

    def param_shardings(params):
        return {'router': NamedSharding(mesh, ()),
                'w1': NamedSharding(mesh, (expert_spec,)),
                'w2': NamedSharding(mesh, (expert_spec,))}

    return fn, param_shardings, NamedSharding(mesh, token_spec)
