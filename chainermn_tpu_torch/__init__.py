"""chainermn_tpu_torch — the PyTorch/CUDA port of ``chainermn_tpu``.

The JAX package beside it stays the reference; this package keeps its
module layout and public names so each counterpart is easy to find, and
runs on an NVIDIA GPU (NCCL between ranks, hand-written CUDA kernels for
what the reference wrote in Pallas).  It imports torch, numpy and the
standard library only.

Facade mirroring ``chainermn_tpu/__init__.py`` for the names this port
carries so far; everything loads lazily so ``import chainermn_tpu_torch``
stays cheap.
"""

__version__ = "0.1.0"

_LAZY = {
    "create_communicator": "chainermn_tpu_torch.communicators",
    "CommunicatorBase": "chainermn_tpu_torch.communicators",
    "create_multi_node_optimizer": "chainermn_tpu_torch.optimizers",
    "MultiNodeOptimizer": "chainermn_tpu_torch.optimizers",
    "scatter_dataset": "chainermn_tpu_torch.datasets",
    "create_empty_dataset": "chainermn_tpu_torch.datasets",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'chainermn_tpu_torch' has no attribute {name!r}"
        )
    import importlib

    return getattr(importlib.import_module(mod), name)
