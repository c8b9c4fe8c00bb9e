"""Serving on one device — port of ``chainermn_tpu/serving``: paged KV
cache, continuous batching, bucketed prefill/decode/chunk steps.

* :mod:`~chainermn_tpu_torch.serving.kv_cache` — paged KV accounting:
  block tables, alloc/free/defragment, copy-on-write prefix sharing with a
  token-run-keyed index and an LRU cached pool (host numpy);
* :mod:`~chainermn_tpu_torch.serving.engine` — prefill, single-token
  decode and multi-token chunk steps over the device pages, padded to
  static buckets; the paged data plane of
  :mod:`~chainermn_tpu_torch.ops.decode_attention`; host sampling;
* :mod:`~chainermn_tpu_torch.serving.spec` — n-gram and truncated-model
  draft sources for speculative decoding;
* :mod:`~chainermn_tpu_torch.serving.scheduler` — iteration-level
  continuous batching: FCFS admission with a free-page watermark, tenant
  DRR, one batched decode/verify per step, preemption with recompute;
* :mod:`~chainermn_tpu_torch.serving.frontend` — bounded-queue submission
  with backpressure, deadlines and streaming callbacks;
* :mod:`~chainermn_tpu_torch.serving.workload` — seeded heavy-tailed
  traffic.

The contract, as the reference's: a token stream is the same whether a
request runs alone through :meth:`engine.InferenceEngine.generate` or
shares continuous-batched iterations, across preemption, prefix-cache
hits and speculative accept/reject.  Across ranks the engine takes a
tensor-parallel plan and a sequence-parallel chunk prefill, and
:mod:`~chainermn_tpu_torch.serving.cluster` routes over several replicas:
in one process, or across processes through its service loops
(``serving.cluster.service``), shard groups
(``serving.cluster.shard_group``) and autoscaler
(``serving.cluster.autoscaler``) over the host transport of
:mod:`~chainermn_tpu_torch.communicators.kvtransport`.
"""

from .engine import (  # noqa: F401
    EngineConfig,
    InferenceEngine,
    SamplingParams,
)
from .frontend import (  # noqa: F401
    QueueFull,
    RequestHandle,
    ServeFrontend,
)
from .kv_cache import (  # noqa: F401
    CacheStats,
    OutOfBlocks,
    PagedKVCache,
    prefix_digest,
    prompt_digests,
)
from .scheduler import (  # noqa: F401
    ContinuousBatchingScheduler,
    Request,
    RequestState,
)
from .spec import DraftModel  # noqa: F401
from .workload import (  # noqa: F401
    Arrival,
    TrafficSpec,
)
