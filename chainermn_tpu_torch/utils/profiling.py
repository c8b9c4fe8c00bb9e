"""Profiling hooks — port of ``chainermn_tpu/utils/profiling.py``.

``trace()`` wraps ``torch.profiler`` (a Chrome/Perfetto trace of the
host and, on CUDA, of the device's kernels, NCCL collectives included),
``annotate()`` stamps named regions with ``record_function``, and
``StepTimer`` gives the in-loop throughput numbers.
:func:`allreduce_bus_bandwidth_gbs` is the ring-allreduce bus-bandwidth
formula of ``BASELINE.json``'s ``allreduce bus-bw GB/s`` metric.

The reference's ``setup_compilation_cache`` points XLA's persistent
compilation cache at a directory; eager PyTorch compiles nothing, so it
has no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Mapping, Optional

import torch


def slope_time(run, n1: int, n2: Optional[int] = None) -> float:
    """Per-iteration time via the two-point slope ``(T2 - T1) / (n2 - n1)``.

    ``run(n)`` must execute ``n`` iterations, end with ONE :func:`sync`
    and return its wall time; a constant cost of the run (the final
    synchronisation, a launch queue draining) cancels in the slope."""
    if n2 is None:
        n2 = 5 * n1
    t1, t2 = run(n1), run(n2)
    return (t2 - t1) / (n2 - n1)


def median_slope(run, n1: int = 5, repeats: int = 3):
    """Median of ``repeats`` independent :func:`slope_time` measurements,
    with the sorted samples: ``(median_seconds_per_iter, samples)``."""
    samples = sorted(slope_time(run, n1) for _ in range(repeats))
    return samples[len(samples) // 2], samples


def _tensor_leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)


def sync(tree):
    """Execution barrier: wait until the work producing every tensor in
    ``tree`` (a tensor, or nested mappings, lists and tuples of them) has
    finished, and return ``tree``.  CUDA launches are asynchronous, so a
    timing region must end here; each CUDA device holding a leaf is
    synchronised once.  CPU tensors are ready when they exist."""
    seen = set()
    for leaf in _tensor_leaves(tree):
        dev = leaf.device
        if dev.type == "cuda" and dev.index not in seen:
            seen.add(dev.index)
            torch.cuda.synchronize(dev)
    return tree


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile the with-block with ``torch.profiler`` (CPU activity, and
    CUDA activity when a device is present) and write a Chrome trace into
    ``logdir`` (default: ``chainermn_tpu_torch_trace`` under the system
    temporary directory) when the block ends.  Yields the directory.

    Degrades to a no-op (the block still runs, the directory is still
    yielded) when the profiler cannot start, as the reference does when
    ``jax.profiler`` refuses: a run that asked for visibility must not
    fail for it."""
    import tempfile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "chainermn_tpu_torch_trace")
    prof = None
    try:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception:
        prof = None
    try:
        yield logdir
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(logdir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(logdir, f"trace_{os.getpid()}.json"))
            except Exception:
                pass


def annotate(name: str):
    """Named region for profiler timelines, usable as a context manager
    (``torch.profiler.record_function``); a null context when that cannot
    be built."""
    try:
        return torch.profiler.record_function(name)
    except Exception:
        return contextlib.nullcontext()


class StepTimer:
    """Steady-state step timing with warm-up discard: each ``with`` block
    is one step; the first ``warmup`` are not counted."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)
        return False

    @property
    def mean_s(self) -> float:
        return sum(self._times) / max(len(self._times), 1)

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.mean_s if self._times else 0.0


def allreduce_bus_bandwidth_gbs(
    nbytes: int, n_devices: int, seconds_per_allreduce: float
) -> float:
    """Ring-allreduce bus bandwidth in GB/s: each device moves
    2(n-1)/n of the buffer over its links per allreduce."""
    if seconds_per_allreduce <= 0:
        return 0.0
    moved = 2 * (n_devices - 1) / max(n_devices, 1) * nbytes
    return moved / seconds_per_allreduce / 1e9
