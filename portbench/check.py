"""The comparison that decides ``correct`` for a training cell.

Both sides (the program, and the plain reference given the same weights
and batches) yield the same readings of the first three steps:

* ``losses``: each step's loss;
* ``grad``: the norm of each leaf of the first step's gradient as the
  optimizer got it (the program's worked out from its optimizer state
  after one step);
* ``change``: the norm of each parameter's change after three steps;
* ``state``: the norm of each state buffer's change after three steps
  (BatchNorm's running statistics), where the model has any.

The numbers (``numbers``) take a gap of norms by the worst leaf:
|program's norm - reference's norm| over the larger of the reference's
norm of that leaf and of the median leaf; the ``_median`` numbers take
the median leaf's gap instead, which stays steady from seed to seed where
a few small leaves carry the rounding noise of a sum that nearly cancels
(BatchNorm's shifts and scales).  Leaves whose reference gradient is
under a thousandth of the median leaf's move under Adam by round-off
alone; they are left out of ``change``.  A cell's limits name the numbers
it compares.
"""

from __future__ import annotations

import dataclasses
import math
import statistics

NEGLIGIBLE_GRAD = 1e-3


@dataclasses.dataclass
class Readings:
    losses: list
    grad: dict
    change: dict
    state: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "Readings":
        return cls(**d)


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def leaf_gaps(prog: dict, ref: dict, keep=None) -> list:
    """Each leaf's gap of norms (inf where a norm is missing or not
    finite)."""
    names = [n for n in ref if keep is None or n in keep]
    if not names:
        return [math.inf]
    med = statistics.median(ref[n] for n in names)
    gaps = []
    for n in names:
        p, r = prog.get(n), ref[n]
        if not (_finite(p) and _finite(r)):
            gaps.append(math.inf)
            continue
        den = max(r, med)
        gaps.append(abs(p - r) / den if den > 0 else
                    (0.0 if p == 0 else math.inf))
    return gaps


def worst_leaf(prog: dict, ref: dict, keep=None) -> float:
    return max(leaf_gaps(prog, ref, keep))


def median_leaf(prog: dict, ref: dict, keep=None) -> float:
    return statistics.median(leaf_gaps(prog, ref, keep))


def numbers(prog: Readings, ref: Readings) -> dict:
    """The numbers compared, each a relative gap (0 is exact)."""
    if len(prog.losses) != len(ref.losses) or not all(
            _finite(a) and _finite(b) for a, b in zip(prog.losses,
                                                      ref.losses)):
        loss_gap = math.inf
    else:
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog.losses,
                                                           ref.losses))
    med = statistics.median(ref.grad.values()) if ref.grad else 0.0
    moving = {n for n, g in ref.grad.items() if g >= NEGLIGIBLE_GRAD * med}
    out = {"loss_gap": loss_gap}
    parts = [("grad", prog.grad, ref.grad, None),
             ("change", prog.change, ref.change, moving)]
    if ref.state:
        parts.append(("state", prog.state, ref.state, None))
    for name, p, r, keep in parts:
        out[f"{name}_gap"] = worst_leaf(p, r, keep)
        out[f"{name}_gap_median"] = median_leaf(p, r, keep)
    return out


def verdict(nums: dict, limits: dict):
    """``(correct, checks)``: every number that ``limits`` names at or
    under its limit; ``checks`` pairs each with its limit."""
    checks = {}
    for name, limit in limits.items():
        if name not in nums:
            raise KeyError(f"a limit names no number: {name!r}")
        checks[name] = {"value": nums[name], "limit": limit}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
