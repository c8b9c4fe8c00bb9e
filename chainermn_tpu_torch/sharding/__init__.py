"""Declarative sharding-plan subsystem — the port of
``chainermn_tpu/sharding``.

One ordered ``(name, pattern, PartitionSpec)`` rule table — a
:class:`ShardingPlan` — resolves parameters, gradients and optimizer
moments by parameter name.  See :mod:`chainermn_tpu_torch.sharding.plan`
for the resolution contract and the DTensor placements a plan lifts to,
:mod:`chainermn_tpu_torch.sharding.registry` for the built-in ``dp`` /
``tp`` / ``dp_tp`` / ``sp`` / ``fsdp`` / ``zero`` plans, and ``python -m
chainermn_tpu_torch.tools.shardplan`` for the browser and linter CLI.
"""

from .plan import (  # noqa: F401
    P,
    PartitionSpec,
    PlanRule,
    PlanValidation,
    ShardingPlan,
    validate,
)
from .registry import (  # noqa: F401
    get_plan,
    list_plans,
    plans_for_mesh,
    register_plan,
)

__all__ = [
    "P",
    "PartitionSpec",
    "PlanRule",
    "PlanValidation",
    "ShardingPlan",
    "validate",
    "get_plan",
    "list_plans",
    "plans_for_mesh",
    "register_plan",
]
