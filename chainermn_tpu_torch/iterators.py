"""Multi-node iterators — port of ``chainermn_tpu/iterators.py``
(reference: ChainerMN's ``iterators``).

* :func:`create_multi_node_iterator`: the master rank draws batches and
  broadcasts them over the object plane, so every rank sees the same
  batch (model-parallel ranks); a sentinel ends every rank's epoch
  together.
* :func:`create_synchronized_iterator`: ranks draw from their own
  iterators but stop together when any runs dry.
* :func:`create_prefetch_iterator`: a background thread drains the host
  iterator and stages each batch on the device (pinned host memory, a
  copy stream, ``non_blocking`` copies) ahead of the step that uses it.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from ._device import resolve_device

_STOP = "__chainermn_tpu_stop__"


def create_multi_node_iterator(actual_iterator: Iterable, communicator,
                               rank_master: int = 0) -> Iterator:
    """Master draws; every rank receives the same batches."""

    def gen():
        if communicator.rank == rank_master:
            for batch in actual_iterator:
                communicator.bcast_obj(batch, root=rank_master)
                yield batch
            communicator.bcast_obj(_STOP, root=rank_master)
        else:
            while True:
                batch = communicator.bcast_obj(None, root=rank_master)
                if isinstance(batch, str) and batch == _STOP:
                    return
                yield batch

    return gen()


def create_synchronized_iterator(actual_iterator: Iterable,
                                 communicator) -> Iterator:
    """Each step every rank agrees (an object-plane allreduce) whether all
    still have data; the first to run dry ends the epoch for all."""

    def gen():
        it = iter(actual_iterator)
        while True:
            try:
                batch = next(it)
                have = 1
            except StopIteration:
                batch, have = None, 0
            if communicator.allreduce_obj(have) < communicator.size:
                return
            yield batch

    return gen()


def _map(fn, batch):
    if isinstance(batch, (torch.Tensor, np.ndarray)):
        return fn(batch)
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, v) for v in batch)
    return batch


def create_prefetch_iterator(actual_iterator: Iterable, size: int = 2,
                             device="cuda",
                             close_join_timeout: float | None = 1.0
                             ) -> Iterator:
    """Overlap host-side batch production and the host-to-device copy
    with the step.

    A daemon thread iterates ``actual_iterator`` (numpy arrays or tensors,
    in tuples, lists or dicts) and stages each batch on ``device``: on a
    CUDA device through pinned host memory with ``non_blocking`` copies
    on its own stream, the consumer's stream waiting on each batch's
    event; on the CPU as tensors.  Up to ``size`` staged batches wait in a
    bounded queue.  Order is kept, an exception in the producer re-raises
    at the consuming ``next()``, and closing or abandoning the iterator
    stops the producer (joined for at most ``close_join_timeout`` seconds,
    ``None`` for no bound) and drops the staged batches."""
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    dev = resolve_device(device)
    q: _queue.Queue = _queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def stage(batch):
        def one(x):
            t = torch.as_tensor(x)
            if stream is None:
                return t.to(dev)
            return t.pin_memory().to(dev, non_blocking=True)

        if stream is None:
            return _map(one, batch), None
        with torch.cuda.stream(stream):
            out = _map(one, batch)
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready

    def put_or_stop(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in actual_iterator:
                if not put_or_stop(stage(batch)):
                    return
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            put_or_stop((end, e))
            return
        put_or_stop((end, None))

    t = threading.Thread(target=producer, daemon=True)

    def gen():
        # The producer starts on the first next(): an abandoned, never
        # started generator owns no thread.
        t.start()
        try:
            while True:
                item, extra = q.get()
                if item is end:
                    if extra is not None:
                        raise extra
                    return
                if extra is not None:
                    current = torch.cuda.current_stream(dev)
                    current.wait_event(extra)
                    _map(lambda x: x.record_stream(current), item)
                yield item
        finally:
            stop.set()
            # Join before draining: a producer inside its 0.1 s put could
            # otherwise land one more batch after the drain.
            t.join(timeout=close_join_timeout)
            try:
                while True:
                    q.get_nowait()
            except _queue.Empty:
                pass

    return gen()
