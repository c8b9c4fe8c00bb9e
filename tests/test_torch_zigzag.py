"""The port's zigzag ring attention against the JAX package's.

Each zigzag case of ``_torch_sp_worker.SP_CASES`` runs on the port at 1
rank (in this process), 2 and 4 gloo ranks (workers from
``_torch_sp_worker.py``), and on the reference inside ``shard_map`` over
as many CPU devices, on the same seeded numpy inputs in the zigzag
layout (S 32: chunks of 4 at four ranks): the dense inner blocks, and
the flash inner — the port's kernel twins (the kernels' plain versions
on the CPU) against the reference's Pallas kernels in interpret mode —
each plain and with packed segment ids crossing chunk boundaries
together with GQA (``Hk`` 2 dense, 1 flash).  The port computes only the live half-block
of each ring step (a host branch on its rank) where the reference
selects it by data; each rank's output shard and gradients must agree
within ``_sp_reference``'s fp32 bounds (2e-5 output, 1e-4 gradients).
"""

import pytest

import _torch_sp_worker as worker
from _sp_reference import check_case, world  # noqa: F401


#: The ``SP_CASES`` kinds this file's worlds run.
SP_KINDS = ("zigzag",)


@pytest.mark.parametrize("name", sorted(
    name for name, c in worker.SP_CASES.items() if c["kind"] == "zigzag"))
def test_matches_reference(world, name):
    check_case(world, name)
