"""Parallelism strategies beyond plain data parallelism — the port of
``chainermn_tpu/parallel``.  So far: :mod:`.pipeline` (GPipe, 1F1B,
interleaved and circular schedules, one process a stage)."""


def __getattr__(name):
    import importlib

    if name == "pipeline":
        return importlib.import_module(f"chainermn_tpu_torch.parallel.{name}")
    raise AttributeError(name)
