"""Models of the port (ports of ``chainermn_tpu/models``).  The convnets
load on first use, as the reference's lazy names do."""

from .mlp import MLP  # noqa: F401
from .transformer import TransformerLM  # noqa: F401
from .vit import ViT  # noqa: F401


def __getattr__(name):
    if name in ("ResNet50", "ResNet18", "ResNet101", "ResNet"):
        from . import resnet

        return getattr(resnet, name)
    if name in ("AlexNet", "NiN", "GoogLeNet"):
        from . import convnets

        return getattr(convnets, name)
    raise AttributeError(name)
