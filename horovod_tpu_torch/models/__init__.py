"""Image-classification models of the port: the ResNet family (the
``--model`` registry of the synthetic benchmark) and the test MLP.  VGG,
Inception and ViT come in a later slice."""

from .mlp import MLP  # noqa: F401
from .resnet import MODELS  # noqa: F401
from .resnet import (  # noqa: F401
    ResNet, ResNet18, ResNet34, ResNet50, ResNet101, ResNet152,
)
