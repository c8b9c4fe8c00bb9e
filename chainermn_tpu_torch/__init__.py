"""chainermn_tpu_torch — the PyTorch/CUDA port of ``chainermn_tpu``.

The JAX package beside it stays the reference; this package keeps its
module layout and public names so each counterpart is easy to find, and
runs on an NVIDIA GPU (NCCL between ranks, hand-written CUDA kernels for
what the reference wrote in Pallas).  It imports torch, numpy and the
standard library only.

Facade mirroring ``chainermn_tpu/__init__.py`` for the names this port
carries so far (the data-parallel surface: communicators, the multi-node
optimizer, dataset scattering, evaluator, checkpointer, iterators and the
except hook); everything loads lazily so ``import chainermn_tpu_torch``
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
    "create_multi_node_evaluator": "chainermn_tpu_torch.extensions",
    "create_multi_node_checkpointer": "chainermn_tpu_torch.extensions",
    "create_multi_node_iterator": "chainermn_tpu_torch.iterators",
    "create_synchronized_iterator": "chainermn_tpu_torch.iterators",
    "create_prefetch_iterator": "chainermn_tpu_torch.iterators",
}
_MODULES = ("global_except_hook", "extensions", "iterators", "datasets",
            "models", "communicators")


def __getattr__(name):
    import importlib

    if name in _MODULES:
        return importlib.import_module(f"chainermn_tpu_torch.{name}")
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'chainermn_tpu_torch' has no attribute {name!r}"
        )
    return getattr(importlib.import_module(mod), name)
