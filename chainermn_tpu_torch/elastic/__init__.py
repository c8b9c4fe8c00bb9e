"""Elastic training — the port of ``chainermn_tpu/elastic``: the
supervisor, the fault-injection (chaos) harness, the heartbeat core the
serving cluster shares, and the worker-side runtime.

Launch::

    python -m chainermn_tpu_torch.tools.elastic --nproc 2 -- \\
        python -m chainermn_tpu_torch.examples.train_mnist \\
        --communicator pure_nccl --elastic --checkpoint-dir ckpt

Training scripts opt in with :func:`init_from_env` (a no-op outside a
supervised run) and one :meth:`ElasticContext.beat` per step.  The
package imports no torch until a rank joins its world.
"""

from .chaos import (
    ENV_SCHEDULE,
    ChaosEngine,
    ChaosSchedule,
    Fault,
    TimedChaos,
    engine_from_env,
    validate_grammar,
)
from .heartbeat import (
    BeatInfo,
    FileBeat,
    HeartbeatMonitor,
    read_beat,
    read_beat_info,
)
from .supervisor import (
    EXIT_PREEMPTED,
    ElasticSupervisor,
    SupervisorConfig,
    run_supervised,
)
from .worker import ElasticContext, active, init_from_env

__all__ = ["BeatInfo", "ChaosEngine", "ChaosSchedule", "ENV_SCHEDULE",
           "EXIT_PREEMPTED", "ElasticContext", "ElasticSupervisor", "Fault",
           "FileBeat", "HeartbeatMonitor", "SupervisorConfig", "TimedChaos",
           "active", "engine_from_env", "init_from_env", "read_beat",
           "read_beat_info", "run_supervised", "validate_grammar"]
