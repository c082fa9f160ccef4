"""Models of the port: the ResNet family (the ``--model`` registry of the
synthetic benchmark), the test MLP, and the Transformer families (BERT
encoder, GPT decoder).  VGG, Inception and ViT come in a later slice."""

from .bert import BertEncoder, bert_base, bert_tiny  # noqa: F401
from .gpt import (  # noqa: F401
    GPT, causal_flash_attention_fn, gpt2_small, gpt_tiny, next_token_loss,
)
from .mlp import MLP  # noqa: F401
from .resnet import MODELS  # noqa: F401
from .resnet import (  # noqa: F401
    ResNet, ResNet18, ResNet34, ResNet50, ResNet101, ResNet152,
)
