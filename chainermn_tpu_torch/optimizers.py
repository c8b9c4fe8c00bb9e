"""Multi-node optimizer — the data-parallel hot path.

Port of ``chainermn_tpu/optimizers.py`` at ``zero_stage=0`` (reference:
ChainerMN's ``create_multi_node_optimizer``): wrap a ``torch.optim``
optimizer; at ``init`` broadcast the parameters from rank 0; each step
runs local forward/backward, ``communicator.allreduce_grad`` (the mean
over ranks) and the inner optimizer's update.

Batch contract, as in the reference's ``make_train_step``: the step takes
the GLOBAL batch, and rank ``r`` of ``n`` computes on the contiguous
slice ``r`` of its leading axis — the reference's ``P(world)`` batch
sharding, one process per rank.  ``loss_fn(local_batch)`` returns the
local mean loss; the step returns the mean of the ranks' losses.

AdamW note: ``torch.optim.AdamW`` decays the parameter multiplicatively
before the Adam step, ``optax.adamw`` adds ``weight_decay * param`` to the
update before the learning-rate scale.  The two agree to fp32 rounding;
``torch.optim.AdamW`` also defaults to ``weight_decay=0.01`` where
``optax.adamw`` defaults to 1e-4, so pass every argument explicitly.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from .communicators.base import CommunicatorBase


def _tree_map(fn, batch):
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if isinstance(batch, Mapping):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_tree_map(fn, v) for v in batch)
    return batch


def _batch_leaves(batch):
    out = []
    _tree_map(out.append, batch)
    return out


def _check_batch_divisibility(batch, n_dev, n_accum=1):
    quantum = n_dev * n_accum
    for leaf in _batch_leaves(batch):
        if leaf.dim() and leaf.shape[0] % quantum:
            raise ValueError(
                f"global batch axis ({leaf.shape[0]}) must be divisible by "
                f"device count x n_accum ({n_dev} x {n_accum} = {quantum}); "
                f"pad or drop the remainder"
            )


class MultiNodeOptimizer:
    """Wrap a ``torch.optim.Optimizer`` with distributed gradient
    averaging — the reference's ``MultiNodeOptimizer`` at stage 0.

    ``double_buffering``: step ``t`` applies step ``t-1``'s averaged
    gradients (the first step only reduces and leaves the parameters
    unchanged) — the reference's one-step-stale semantics."""

    def __init__(self, actual_optimizer: torch.optim.Optimizer,
                 communicator: CommunicatorBase,
                 double_buffering: bool = False, zero_stage: int = 0):
        if zero_stage not in (0, 1, 2, 3):
            raise ValueError("zero_stage must be 0, 1, 2 or 3")
        if zero_stage > 0:
            raise NotImplementedError(
                "zero_stage > 0 is not ported yet (ROADMAP A5)"
            )
        self.actual_optimizer = actual_optimizer
        self.communicator = communicator
        self.double_buffering = double_buffering
        self.zero_stage = zero_stage
        self.step_count = 0
        self._stale = None      # double buffering: last step's mean grads

    @property
    def params(self):
        return [p for group in self.actual_optimizer.param_groups
                for p in group["params"] if p.requires_grad]

    def init(self):
        """Replicate the parameters from rank 0 (the reference's
        first-update ``broadcast_data``)."""
        self.communicator.broadcast_data(self.params)
        self.step_count = 0
        self._stale = None

    def make_train_step(self, loss_fn: Callable, n_accum: int = 1,
                        loss_scale: float | None = None):
        """Build ``step(batch) -> loss``.

        ``n_accum > 1`` splits this rank's slice into that many equal
        microbatches and sums their gradients before dividing by
        ``n_accum`` — the reference's mean of microbatch gradients.
        ``loss_scale`` multiplies the loss before backward; gradients stay
        scaled through the allreduce and are unscaled once, just before
        the update.  The returned loss is unscaled."""
        if n_accum < 1:
            raise ValueError(f"n_accum must be >= 1, got {n_accum}")
        comm = self.communicator

        def step(batch):
            _check_batch_divisibility(batch, comm.size, n_accum)
            params = self.params
            for p in params:
                p.grad = None

            def shard(x, r, n):
                per = x.shape[0] // n
                return x[r * per:(r + 1) * per]

            local = _tree_map(lambda x: shard(x, comm.rank, comm.size), batch)
            loss_sum = None
            for i in range(n_accum):
                mb = _tree_map(lambda x: shard(x, i, n_accum), local)
                loss = loss_fn(mb)
                scaled = loss if loss_scale is None else loss * loss_scale
                scaled.backward()
                loss = loss.detach().float()
                loss_sum = loss if loss_sum is None else loss_sum + loss
            loss = loss_sum / n_accum
            grads = []
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                if n_accum > 1:
                    p.grad.div_(n_accum)
                grads.append(p.grad)
            comm.allreduce_grad(grads)
            if comm.size > 1:
                loss = loss.reshape(1).to(comm.device)
                torch.distributed.all_reduce(loss)
                loss = loss[0] / comm.size
            if self.double_buffering:
                stale, self._stale = self._stale, grads
                if stale is None:            # first step: reduce only
                    self.step_count += 1
                    for p in params:
                        p.grad = None
                    return loss
                for p, g in zip(params, stale):
                    p.grad = g
            if loss_scale is not None:
                for p in params:
                    p.grad.div_(loss_scale)
            self.actual_optimizer.step()
            self.step_count += 1
            return loss

        return step


def create_multi_node_optimizer(actual_optimizer: torch.optim.Optimizer,
                                communicator: CommunicatorBase,
                                double_buffering: bool = False,
                                zero_stage: int = 0) -> MultiNodeOptimizer:
    """Reference-parity factory (ChainerMN's ``create_multi_node_optimizer``)."""
    return MultiNodeOptimizer(actual_optimizer, communicator,
                              double_buffering=double_buffering,
                              zero_stage=zero_stage)
