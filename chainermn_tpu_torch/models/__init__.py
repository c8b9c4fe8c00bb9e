"""Models of the port (ports of ``chainermn_tpu/models``)."""

from .mlp import MLP  # noqa: F401
from .transformer import TransformerLM  # noqa: F401
