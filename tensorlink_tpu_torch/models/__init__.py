from tensorlink_tpu_torch.models.mlp import MLP, MLPConfig  # noqa: F401
from tensorlink_tpu_torch.models.bert import Bert, BertClassifier, BertConfig  # noqa: F401
from tensorlink_tpu_torch.models.gpt2 import GPT2, GPT2Config  # noqa: F401
from tensorlink_tpu_torch.models.vit import ViT, ViTClassifier, ViTConfig  # noqa: F401
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig  # noqa: F401
from tensorlink_tpu_torch.models.t5 import T5, T5Config  # noqa: F401
