"""The example models, as ``nn.Module``s holding the JAX package's numerics.

* ``mlp`` - MNIST (config #1)
* ``resnet`` - ResNet-50 for ImageNet-Parquet (config #3)
* ``vit`` - Vision Transformer on the same image pipeline (encoder blocks
  shared with ``transformer``, so the tensor-parallel and FSDP rules apply
  unchanged)
* ``dlrm`` - Criteo embedding tables (config #4)
* ``transformer`` - the long-context LM (sequence- and tensor-parallel)
* ``moe`` - the Switch expert-parallel FFN
"""

from petastorm_tpu_torch.models.mlp import MLP  # noqa: F401
from petastorm_tpu_torch.models.resnet import ResNet50  # noqa: F401
from petastorm_tpu_torch.models.transformer import (  # noqa: F401
    TransformerLM, param_shardings, make_attn_fn)
from petastorm_tpu_torch.models.decoding import beam_search, generate  # noqa: F401
from petastorm_tpu_torch.models.vit import ViT  # noqa: F401
