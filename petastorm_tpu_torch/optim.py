"""optax's Adagrad as a ``torch.optim.Optimizer``.

``optax.adagrad(lr)`` (optax 0.2.6: ``scale_by_rss`` then the learning
rate) starts each accumulator at ``initial_accumulator_value`` (0.1), adds
``g**2``, and moves the parameter by ``-lr * where(s > 0, rsqrt(s + eps),
0) * g`` with ``eps`` (1e-7) inside the root.  ``torch.optim.Adagrad``
starts at 0, puts eps outside the root and keeps a step count, so it is not
the same optimizer.  All of this one's state lives on the parameter's
device and ``step`` makes no host sync: a CUDA graph captures it whole, as
``Adam(capturable=True)``.
"""

import torch

__all__ = ['Adagrad']


class Adagrad(torch.optim.Optimizer):
    def __init__(self, params, lr=1e-3, initial_accumulator_value=0.1, eps=1e-7):
        if lr < 0 or initial_accumulator_value < 0 or eps < 0:
            raise ValueError('lr, initial_accumulator_value and eps must be >= 0')
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value,
                                      eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state['sum_of_squares'] = torch.full_like(
                        p, group['initial_accumulator_value'], memory_format=torch.preserve_format)
                s = state['sum_of_squares']
                g = p.grad
                s.add_(g * g)
                inv = torch.where(s > 0, torch.rsqrt(s + group['eps']), torch.zeros_like(s))
                # the update as optax rounds it: (inv * g) * -lr, then added
                p.add_(inv * g * -group['lr'])
        return loss
