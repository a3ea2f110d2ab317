"""DLRM (Deep Learning Recommendation Model) as an ``nn.Module``: the
Criteo example's model (BASELINE.json config #4).

Counterpart of ``petastorm_tpu/models/dlrm.py`` in flax's numerics: both
MLPs are flax ``Dense`` layers computing in ``dtype`` (bf16) from fp32
parameters (the product, then the bias), ReLU between layers and none
after the last; one fp32 table per categorical feature, initialised
``N(0, 0.01^2)`` and looked up in fp32 (flax ``nn.Embed`` with no dtype);
the features stacked as ``(B, F, D)`` in fp32 and cast to ``dtype``; the
pairwise interaction as one batched product in ``dtype``, its upper
triangle taken in ``jnp.triu_indices``' row-major order; the top MLP on
``cat([dense_emb, pairwise])``, and the logits ``[:, 0]`` in fp32.
``convert.dlrm_params_from_flax`` carries a flax DLRM's parameters over.
The products run as ``F.linear`` and ``bmm`` and the lookups as
``F.embedding``: the JAX package computes them outside any Pallas kernel.
"""

import torch
from torch import nn

from petastorm_tpu_torch.models.transformer import Dense

__all__ = ['DLRM', 'MLP']


class MLP(nn.Module):
    """flax ``Dense`` layers in ``dtype`` with ReLU between them."""

    def __init__(self, in_features, layer_sizes, dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.dtype = dtype
        sizes = (in_features,) + tuple(layer_sizes)
        self.layers = nn.ModuleList(Dense(a, b, compute_dtype=dtype, generator=generator)
                                    for a, b in zip(sizes[:-1], sizes[1:]))

    def forward(self, x):
        x = x.to(self.dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class DLRM(nn.Module):
    """``num_dense`` continuous features and one categorical id per
    embedding table; ``forward(dense (B, num_dense), ids (B, tables))``
    returns fp32 logits ``(B,)``."""

    def __init__(self, vocab_sizes, embedding_dim=16, bottom_mlp=(64, 32, 16),
                 top_mlp=(64, 32, 1), dtype=torch.bfloat16, num_dense=13, generator=None):
        super().__init__()
        if bottom_mlp[-1] != embedding_dim:
            raise ValueError('bottom MLP must end at embedding_dim')
        self.dtype = dtype
        self.bottom = MLP(num_dense, bottom_mlp, dtype, generator)
        self.tables = nn.ModuleList(nn.Embedding(int(v), embedding_dim) for v in vocab_sizes)
        with torch.no_grad():
            for table in self.tables:
                nn.init.normal_(table.weight, 0.0, 0.01, generator=generator)
        num_feats = len(vocab_sizes) + 1
        iu, ju = torch.triu_indices(num_feats, num_feats, 1)
        # flat indices into the (F, F) interaction matrix, row-major
        self.register_buffer('pair_index', iu * num_feats + ju, persistent=False)
        self.top = MLP(embedding_dim + len(self.pair_index), top_mlp, dtype, generator)

    def forward(self, dense_features, categorical_ids):
        dense_emb = self.bottom(dense_features)
        ids = categorical_ids.long()
        feats = torch.stack([dense_emb.float()]
                            + [table(ids[:, i]) for i, table in enumerate(self.tables)],
                            dim=1).to(self.dtype)
        interactions = torch.bmm(feats, feats.transpose(1, 2))
        pairwise = interactions.flatten(1).index_select(1, self.pair_index)
        top_in = torch.cat([dense_emb, pairwise.to(self.dtype)], dim=1)
        return self.top(top_in)[:, 0].float()
