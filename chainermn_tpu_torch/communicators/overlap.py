"""Backward-overlapped bucket allreduce — port of
``chainermn_tpu/communicators/overlap.py``.

Each gradient bucket's allreduce starts as soon as its last member
gradient exists, so the early buckets' communication runs under the rest
of the backward pass (PyTorch DDP's design; the reference gets the same
overlap from XLA's scheduler).  Here the mechanism is hooks:
:class:`BackwardOverlap` registers ``register_post_accumulate_grad_hook``
on every parameter; when a bucket is complete it is packed and its
collective launched (``async_op=True`` where the communicator's pattern is
one collective); :meth:`BackwardOverlap.finish` waits on every handle and
unpacks before the update.

Buckets launch in the order of :func:`build_overlap_schedule` — by their
last member leaf, descending, the order backward produces them — and a
stage launches only after every earlier stage, so every rank issues the
same collectives in the same order whatever order its hooks fire in.
Bit-exact with the eager path: the same buckets, the same operands, the
same sum-then-divide.

``CHAINERMN_TPU_OVERLAP=0`` restores the eager pack-all-then-reduce-all
path; ``CHAINERMN_TPU_OVERLAP_GRANULARITY`` sets the buckets per stage.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence, Tuple

import torch

#: ``0``/``false``/``off``/``no`` disables the overlapped schedule on
#: every communicator; unset or anything else keeps it ON (the default).
ENV_OVERLAP = "CHAINERMN_TPU_OVERLAP"

#: Buckets launched per stage; unset resolves ctor -> 1 (finest overlap).
ENV_OVERLAP_GRANULARITY = "CHAINERMN_TPU_OVERLAP_GRANULARITY"

DEFAULT_GRANULARITY = 1


def overlap_enabled(default: bool = True) -> bool:
    """The :data:`ENV_OVERLAP` gate."""
    raw = os.environ.get(ENV_OVERLAP, "").strip().lower()
    if not raw:
        return default
    return raw not in ("0", "false", "off", "no")


def resolve_granularity(default: int = DEFAULT_GRANULARITY) -> int:
    """The :data:`ENV_OVERLAP_GRANULARITY` override, clamped to >= 1."""
    raw = os.environ.get(ENV_OVERLAP_GRANULARITY, "").strip()
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            pass
    return max(1, int(default))


@dataclasses.dataclass(frozen=True)
class OverlapSchedule:
    """Launch plan over a :class:`~.packing.GradPacker`'s buckets:
    ``stages`` lists bucket indices in launch order, ``granularity``
    buckets a stage."""

    stages: Tuple[Tuple[int, ...], ...]
    granularity: int

    @property
    def order(self) -> Tuple[int, ...]:
        return tuple(i for stage in self.stages for i in stage)

    @property
    def n_buckets(self) -> int:
        return sum(len(s) for s in self.stages)

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def describe(self) -> dict:
        return {
            "granularity": self.granularity,
            "n_stages": self.n_stages,
            "n_buckets": self.n_buckets,
            "order": list(self.order),
        }


def build_overlap_schedule(
    packer, granularity: int = DEFAULT_GRANULARITY
) -> OverlapSchedule:
    """Buckets ordered by their last member leaf, descending (ties by
    descending bucket index), grouped ``granularity`` to a stage."""
    g = max(1, int(granularity))
    order: List[int] = sorted(
        range(len(packer.buckets)),
        key=lambda i: (max(packer.buckets[i].leaf_indices), i),
        reverse=True,
    )
    stages = tuple(
        tuple(order[i : i + g]) for i in range(0, len(order), g)
    )
    return OverlapSchedule(stages=stages, granularity=g)


class BackwardOverlap:
    """Bucket allreduces launched from gradient hooks.

    ``arm(n_accum)`` before the backward pass whose gradients are final
    (the last microbatch); the hooks do nothing while disarmed.
    ``finish()`` after it: parameters that got no gradient get zeros (as
    the eager path gives them), the remaining buckets launch, every handle
    is waited on, and each ``p.grad`` holds the mean.  ``remove()`` takes
    the hooks off."""

    def __init__(self, comm, params: Sequence[torch.Tensor],
                 granularity: int, wire=None):
        self.comm = comm
        self.params = list(params)
        self.wire = wire
        dt = comm.allreduce_grad_dtype
        self.packer = comm._packer_for(
            [p.shape for p in self.params],
            [p.dtype if dt is None else dt for p in self.params],
            comm.resolve_bucket_bytes(),
        )
        self.schedule = build_overlap_schedule(self.packer, granularity)
        self._bucket_of = {}
        for b, bucket in enumerate(self.packer.buckets):
            for j in bucket.leaf_indices:
                self._bucket_of[j] = b
        self._handles = [
            p.register_post_accumulate_grad_hook(self._make_hook(j))
            for j, p in enumerate(self.params)
        ]
        self._armed = False

    def _make_hook(self, j):
        def hook(_param):
            if self._armed:
                self._ready(j)
        return hook

    def arm(self, n_accum: int = 1) -> None:
        self.comm._report_plan(self.packer, self.wire)
        self._n_accum = n_accum
        self._missing = [len(b.leaf_indices) for b in self.packer.buckets]
        self._seen = [False] * len(self.params)
        self._next_stage = 0
        self._pending = [None] * self.packer.n_buckets
        self._armed = True

    def _ready(self, j: int) -> None:
        if self._seen[j]:
            return
        self._seen[j] = True
        self._missing[self._bucket_of[j]] -= 1
        stages = self.schedule.stages
        while (self._next_stage < len(stages) and all(
                self._missing[b] == 0 for b in stages[self._next_stage])):
            stage = stages[self._next_stage]
            bufs = [self._pack(b) for b in stage]
            for b, buf in zip(stage, bufs):
                self._pending[b] = self.comm._launch_bucket(buf, self.wire)
            self._next_stage += 1

    def _pack(self, b: int) -> torch.Tensor:
        dt = self.comm.allreduce_grad_dtype
        work = {}
        for j in self.packer.buckets[b].leaf_indices:
            g = self.params[j].grad
            if self._n_accum > 1:
                g.div_(self._n_accum)
            work[j] = g if dt is None else g.to(dt)
        return self.packer.pack_bucket(work, b)

    def finish(self) -> None:
        for j, p in enumerate(self.params):
            if not self._seen[j]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                self._ready(j)
        self._armed = False
        with torch.no_grad():
            for b, done in enumerate(self._pending):
                for j, view in self.packer.unpack_bucket(done(), b):
                    self.params[j].grad.copy_(view)
        self._pending = []

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []
