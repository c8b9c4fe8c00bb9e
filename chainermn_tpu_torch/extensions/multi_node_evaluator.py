"""Multi-node evaluator — distributed validation metric averaging.

Port of ``chainermn_tpu/extensions/multi_node_evaluator.py`` (reference:
ChainerMN's ``create_multi_node_evaluator``): each rank evaluates its shard
of the validation set, takes the mean over its batches, and the ranks'
means are averaged through the object plane (``allreduce_obj``), so every
rank's result covers the whole set.  With telemetry installed the
result is published as ``eval/<name>`` scalars and one ``eval`` row, and
:meth:`Evaluator.evaluate` runs under ``span("evaluate")``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..observability import spans as _spans


def _publish_eval_metrics(metrics: Dict[str, float]) -> None:
    """Report the rank-averaged metrics into whatever telemetry is
    installed: ``eval/<name>`` scalars on the current Reporter and one
    ``{"event": "eval", ...}`` row on the current StepRecorder.  Free
    when telemetry is off."""
    if not _spans.telemetry_active():
        return
    from ..observability import reporter as _rep
    from ..observability import step_log as _step_log

    _rep.report({f"eval/{k}": v for k, v in metrics.items()})
    rec = _step_log.current_recorder()
    if rec is not None:
        rec.record("eval", metrics=metrics)


def _mean_over_ranks(comm, local: Dict[str, float]) -> Dict[str, float]:
    if comm.size <= 1:
        return local
    summed = comm.allreduce_obj(
        local, op=lambda a, b: {k: a[k] + b[k] for k in a})
    return {k: v / comm.size for k, v in summed.items()}


def create_multi_node_evaluator(actual_evaluator, communicator):
    """Wrap ``actual_evaluator.evaluate`` (anything returning a dict of
    scalars) with the mean over the ranks; returns the same object."""
    actual_evaluate = actual_evaluator.evaluate

    def evaluate(*args, **kwargs):
        local = {k: float(v)
                 for k, v in actual_evaluate(*args, **kwargs).items()}
        result = _mean_over_ranks(communicator, local)
        _publish_eval_metrics(result)
        return result

    actual_evaluator.evaluate = evaluate
    return actual_evaluator


class Evaluator:
    """``metric_fn(model, batch) -> dict[str, scalar]`` on this rank's
    batch; :meth:`evaluate` takes the mean over the batches (gradient-free)
    and then over the ranks.  Every rank must see the same number of
    batches (``scatter_dataset``'s equal-length default)."""

    def __init__(self, metric_fn: Callable, communicator):
        self.metric_fn = metric_fn
        self.comm = communicator

    def evaluate(self, model, batches) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        count = 0
        with _spans.span("evaluate"), torch.no_grad():
            for batch in batches:
                for k, v in self.metric_fn(model, batch).items():
                    totals[k] = totals.get(k, 0.0) + float(v)
                count += 1
            local = {k: v / max(count, 1) for k, v in totals.items()}
            local = _mean_over_ranks(self.comm, local)
        _publish_eval_metrics(local)
        return local
