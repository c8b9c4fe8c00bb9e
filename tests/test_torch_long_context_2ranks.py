"""The port's long-context example against the reference example, 2
gloo ranks against 2 CPU devices (the harness and bounds of
``test_torch_long_context.py``).

At 2 ranks (one data row, a sequence of two): ``--sp ring``, ``zigzag``
and ``ulysses``, each plain, with ``--vocab-tp``, and with ``--packed
--kv-heads 2`` (and ``--window 12`` but for zigzag, which refuses one).
``--sp none --packed`` over several data ranks runs at four.
"""

import pytest

import _torch_sp_worker as worker
from _lm_reference import check_config, layouts  # noqa: F401


@pytest.mark.parametrize("name", sorted(worker.lm_configs(2)))
def test_example_matches_reference(layouts, name):
    check_config(layouts(2), name, 2)
