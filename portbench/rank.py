"""One rank of a run on several cards: ``python portbench/rank.py <spec
file> <rank>``, started by :func:`portbench.harness.spawn`."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.rank_entry(sys.argv[1:]))
