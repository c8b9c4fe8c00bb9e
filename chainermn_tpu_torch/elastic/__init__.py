"""Elastic training's liveness core and fault injection — port of
``chainermn_tpu/elastic``'s :mod:`~chainermn_tpu_torch.elastic.heartbeat`
(the serving cluster's failover detector) and
:mod:`~chainermn_tpu_torch.elastic.chaos` (the fault-schedule grammar, the
worker-side :class:`ChaosEngine` and the serving-side :class:`TimedChaos`).
The supervisor and the worker runtime are a later slice (ROADMAP A.7)."""

from .chaos import (
    ENV_SCHEDULE,
    ChaosEngine,
    ChaosSchedule,
    Fault,
    TimedChaos,
    engine_from_env,
    validate_grammar,
)
from .heartbeat import BeatInfo, FileBeat, HeartbeatMonitor

__all__ = ["BeatInfo", "ChaosEngine", "ChaosSchedule", "ENV_SCHEDULE",
           "Fault", "FileBeat", "HeartbeatMonitor", "TimedChaos",
           "engine_from_env", "validate_grammar"]
