"""The MNIST example's MLP as an ``nn.Module``.

Counterpart of ``petastorm_tpu/models/mlp.py``: the images, flattened and
scaled to [0, 1] in fp32 (``x.reshape(B, -1).float() / 255``), through
Dense 128, relu, Dense 64, relu, Dense 10.  Each ``Dense`` is flax's (the
product, then the bias; lecun-normal kernels, zero biases), so that
``convert.mlp_params_from_flax`` carries a flax MLP's parameters over.
"""

import torch
from torch import nn

from petastorm_tpu_torch.models.transformer import Dense


class MLP(nn.Module):
    def __init__(self, hidden_sizes=(128, 64), num_classes=10, in_features=28 * 28,
                 generator=None):
        super().__init__()
        sizes = (in_features,) + tuple(hidden_sizes) + (num_classes,)
        self.layers = nn.ModuleList(Dense(a, b, generator=generator)
                                    for a, b in zip(sizes[:-1], sizes[1:]))

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(torch.float32) / 255.0
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)
