"""Models of the port: the image-classification registry of the
reference (``MODELS``: the ResNets, VGG, Inception V3 and the ViTs, the
``--model`` choices of the synthetic benchmark), the test MLP, and the
Transformer families (BERT encoder, GPT decoder)."""

from .bert import BertEncoder, bert_base, bert_tiny  # noqa: F401
from .gpt import (  # noqa: F401
    GPT, causal_flash_attention_fn, gpt2_small, gpt_tiny, next_token_loss,
)
from .inception import InceptionV3  # noqa: F401
from .mlp import MLP  # noqa: F401
from .resnet import MODELS as _RESNET_MODELS
from .resnet import (  # noqa: F401
    ResNet, ResNet18, ResNet34, ResNet50, ResNet101, ResNet152,
)
from .vgg import VGG, VGG11, VGG16, VGG19  # noqa: F401
from .vit import ViT, ViT_B16, ViT_L16, ViT_S16  # noqa: F401

#: the --model registry, the reference's (horovod_tpu/models/__init__.py)
MODELS = {
    **_RESNET_MODELS,
    "VGG11": VGG11,
    "VGG16": VGG16,
    "VGG19": VGG19,
    "InceptionV3": InceptionV3,
    "ViT-S16": ViT_S16,
    "ViT-B16": ViT_B16,
    "ViT-L16": ViT_L16,
}

#: registry names whose models keep no BatchNorm statistics
BATCH_STATS_FREE = frozenset({"ViT-S16", "ViT-B16", "ViT-L16"})
