"""Models of the port (ports of ``chainermn_tpu/models``)."""

from .transformer import TransformerLM  # noqa: F401
