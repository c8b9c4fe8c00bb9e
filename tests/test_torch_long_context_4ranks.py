"""The port's long-context example against the reference example, 4
gloo ranks against 4 CPU devices (the harness and bounds of
``test_torch_long_context.py``).

At 4 ranks: ``--sp ulysses --packed --window 12`` over four sequence
shards, ``--sp none --packed`` over four data ranks, and the data x
sequence layouts ``--dp 2`` (``--sp ring``; ``--sp zigzag --vocab-tp``,
the table's gradients summed over the data axis only).
"""

import pytest

import _torch_sp_worker as worker
from _lm_reference import check_config, layouts  # noqa: F401


@pytest.mark.parametrize("name", sorted(worker.lm_configs(4)))
def test_example_matches_reference(layouts, name):
    check_config(layouts(4), name, 4)
