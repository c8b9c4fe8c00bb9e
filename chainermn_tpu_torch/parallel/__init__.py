"""Parallelism strategies beyond plain data parallelism — the port of
``chainermn_tpu/parallel``: :mod:`.pipeline` (GPipe, 1F1B, interleaved
and circular schedules, one process a stage), :mod:`.ring_attention` and
:mod:`.ulysses` (sequence parallelism), :mod:`.sharding` (the
vocab-parallel embedding and cross-entropy) and :mod:`.moe` (expert
parallelism)."""

_MODULES = ("pipeline", "ring_attention", "ulysses", "sharding", "moe")


def __getattr__(name):
    import importlib

    if name in _MODULES:
        return importlib.import_module(f"chainermn_tpu_torch.parallel.{name}")
    raise AttributeError(name)
