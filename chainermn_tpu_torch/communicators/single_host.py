"""Single-host communicator — port of
``chainermn_tpu/communicators/single_host.py`` (reference: ChainerMN's
``single_node_communicator.py``, which asserts ``size == intra_size``):
one sum-allreduce per bucket within one node, and a loud error at
construction over several nodes instead of silent inter-node traffic.
"""

from __future__ import annotations

from .xla_ici import XlaIciCommunicator


class SingleHostCommunicator(XlaIciCommunicator):
    name = "single_host"

    def __init__(self, topology, **kwargs):
        super().__init__(topology, **kwargs)
        if self.inter_size != 1:
            raise ValueError(
                "single_host communicator requires inter_size == 1 "
                f"(got {self.inter_size}); use 'hierarchical'/'xla_ici' "
                "for several nodes"
            )


class SingleNodeCommunicator(SingleHostCommunicator):
    """The reference's name, ``single_node``."""

    name = "single_node"
