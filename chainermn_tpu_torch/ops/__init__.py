"""The hot ops: flash attention on hand-written Hopper kernels and the
chunked fused cross-entropy (ports of ``chainermn_tpu/ops``)."""

from .flash_attention import (  # noqa: F401
    flash_attention,
    make_flash_attention_fn,
)
from .fused_ce import (  # noqa: F401
    fused_cross_entropy,
    fused_cross_entropy_with_lse,
)
