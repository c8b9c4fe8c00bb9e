"""Model-parallel autograd API — port of ``chainermn_tpu/functions``
(ChainerMN's ``chainermn.functions``): ``send``/``recv``/``pseudo_connect``
and the differentiable collectives, as ``torch.autograd.Function``s over
the communicator's process group."""

from .collectives import (  # noqa: F401
    allgather,
    allreduce,
    alltoall,
    bcast,
    gather,
    scatter,
)
from .point_to_point import (  # noqa: F401
    DelegateVariable,
    recv,
    ring_exchange,
    send,
    send_recv,
)
from .pseudo_connect import pseudo_connect  # noqa: F401
