"""The port's modules (``tensorlink_tpu/nn`` counterpart) and the
spec-shipping registry: every type registered here can be rebuilt from a
``config()`` dict, the port's or the JAX package's, by
``module_from_config``; the activations are registered by the names the
reference uses."""

import torch as _torch

from tensorlink_tpu_torch.nn.module import (  # noqa: F401
    Module,
    Sequential,
    init_module,
    module_from_config,
    register_activation,
    register_module_type,
)
from tensorlink_tpu_torch.nn.layers import (  # noqa: F401
    Dense,
    Dropout,
    Embedding,
    LayerNorm,
    RMSNorm,
)
from tensorlink_tpu_torch.nn.attention import (  # noqa: F401
    MultiHeadAttention,
    dot_product_attention,
)
from tensorlink_tpu_torch.nn.transformer import (  # noqa: F401
    ACTIVATIONS,
    FeedForward,
    TransformerBlock,
    TransformerStack,
)

for _cls in (
    Dense,
    Embedding,
    LayerNorm,
    RMSNorm,
    Dropout,
    MultiHeadAttention,
    FeedForward,
    TransformerBlock,
):
    register_module_type(_cls)

for _name, _fn in {
    **ACTIVATIONS,
    "tanh": _torch.tanh,
    "sigmoid": _torch.sigmoid,
    "flatten": lambda x: x.reshape(x.shape[0], -1),
}.items():
    register_activation(_name, _fn)
