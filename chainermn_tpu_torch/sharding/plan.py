"""Declarative sharding plans: one ordered rule table drives parameters,
gradients and optimizer moments — the port of
``chainermn_tpu/sharding/plan.py``.

A :class:`ShardingPlan` is a named, ordered list of ``(name, pattern,
PartitionSpec)`` rules.  A leaf's path is its ``named_parameters`` /
``state_dict`` name (``layers.0.attention.query.weight``), the
counterpart of the reference's ``/``-joined flax path.  Resolution takes
the FIRST rule whose regex ``re.search``-matches the name and whose
optional rank gate matches the leaf's shape; scalar leaves replicate
before any rule is consulted.  The same table resolves:

* **parameters** of an ``nn.Module`` (or a state dict, or a name →
  shape mapping);
* **gradients** — the same names;
* **optimizer moments** — a ``torch.optim`` state is keyed by parameter
  index, so each moment resolves through its parameter's NAME (the index
  mapped back through the param groups); ``moment_rules`` (ZeRO-style
  plans) replace the table for them.

A spec is the port's own :class:`PartitionSpec`: one entry per tensor
dimension, each ``None``, a mesh-axis name or a tuple of names.
:meth:`ShardingPlan.shardings` lifts specs to DTensor placements over a
``torch.distributed.device_mesh.DeviceMesh`` (one ``Shard(d)`` or
``Replicate()`` per mesh dimension), what
:func:`~chainermn_tpu_torch.parallel.sharding.make_gspmd_train_step`
distributes the parameters with.  :func:`validate` reports coverage and
conflicts without raising.
"""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Sequence, Tuple


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (not sharded), a mesh-axis
    name, or a tuple of names (the dimension sharded over their product,
    major to minor).  Trailing dimensions without an entry replicate."""

    def __new__(cls, *entries):
        return super().__new__(cls, (tuple(e) if isinstance(e, list) else e
                                     for e in entries))

    def __repr__(self):
        return "PartitionSpec(" + ", ".join(map(repr, self)) + ")"

    __str__ = __repr__


P = PartitionSpec


def spec_axes(spec) -> List[str]:
    """Every mesh-axis name ``spec`` mentions, in entry order."""
    axes = []
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            axes.extend(str(a) for a in entry)
        else:
            axes.append(str(entry))
    return axes


def _shape(leaf) -> Tuple[int, ...]:
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    if isinstance(leaf, (tuple, list)):
        return tuple(int(d) for d in leaf)
    return ()


def named_leaves(tree) -> List[Tuple[str, Tuple[int, ...]]]:
    """``(name, shape)`` of every leaf of ``tree``: an ``nn.Module`` (its
    ``named_parameters``), or a mapping of names to tensors, shapes or
    nested mappings (joined with ``.``, the module naming)."""
    if hasattr(tree, "named_parameters"):
        return [(n, tuple(p.shape)) for n, p in tree.named_parameters()]
    out = []

    def walk(node, prefix):
        for key, value in node.items():
            name = f"{prefix}{key}"
            if isinstance(value, Mapping):
                walk(value, name + ".")
            else:
                out.append((name, _shape(value)))

    walk(tree, "")
    return out


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (its ``mesh_dim_names``
    and shape) or of a mapping that already is one."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the device mesh has no mesh_dim_names: build it "
                         "with names so plans can address its axes")
    return dict(zip(names, (int(s) for s in mesh.mesh.shape)))


def placements_for(spec, axis_names: Sequence[str]):
    """DTensor placements of ``spec`` over a mesh with ``axis_names``: for
    each mesh dimension ``Shard(d)`` when entry ``d`` names it, else
    ``Replicate()``.  A tuple entry shards its dimension over several mesh
    dimensions, major first (DTensor's left-to-right order)."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis in where:
                raise ValueError(f"mesh axis {axis!r} appears twice in {spec}")
            where[axis] = dim
    missing = sorted(set(where) - set(axis_names))
    if missing:
        raise ValueError(f"spec {spec} names axes {missing} absent from the "
                         f"mesh {tuple(axis_names)}")
    return [Shard(where[a]) if a in where else Replicate()
            for a in axis_names]


@dataclasses.dataclass(frozen=True)
class PlanRule:
    """One row of the table: ``pattern`` is ``re.search``-ed against the
    leaf's name; ``ndim`` (when set) also gates on the leaf's rank (a 1-D
    bias of a matched layer falls through)."""

    name: str
    pattern: str
    spec: PartitionSpec
    ndim: Optional[int] = None

    def matches(self, path: str, shape: Tuple[int, ...]) -> bool:
        if self.ndim is not None and len(shape) != self.ndim:
            return False
        return re.search(self.pattern, path) is not None


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """An ordered rule table with a name, the mesh axes it shards over, and
    (optionally) a separate table for optimizer moments (ZeRO-style plans,
    whose parameters stay replicated while the moments shard)."""

    name: str
    rules: Tuple[PlanRule, ...]
    axes: Tuple[str, ...] = ()
    description: str = ""
    moment_rules: Optional[Tuple[PlanRule, ...]] = None

    # -- matching ------------------------------------------------------
    def match(self, path: str, shape: Tuple[int, ...],
              rules: Optional[Tuple[PlanRule, ...]] = None
              ) -> Optional[PlanRule]:
        """First rule matching ``(path, shape)``, or None (scalars are not
        special-cased here)."""
        for rule in (self.rules if rules is None else rules):
            if rule.matches(path, shape):
                return rule
        return None

    def spec_for(self, path: str, shape: Tuple[int, ...],
                 rules: Optional[Tuple[PlanRule, ...]] = None
                 ) -> PartitionSpec:
        if len(shape) == 0:
            return P()
        rule = self.match(path, shape, rules)
        if rule is None:
            raise ValueError(
                f"sharding plan {self.name!r} has no rule matching leaf "
                f"'{path}' (shape {tuple(shape)}) — every non-scalar "
                "leaf must match a rule (add one, or a terminal "
                "catch-all like PlanRule('replicate', r'.*', P()))"
            )
        return rule.spec

    # -- resolution ----------------------------------------------------
    def resolve(self, tree) -> Dict[str, PartitionSpec]:
        """``{name: spec}`` for an ``nn.Module``, a state dict or a name →
        shape mapping.  Scalars resolve to ``P()``; a non-scalar leaf no
        rule matches raises."""
        return {name: self.spec_for(name, shape)
                for name, shape in named_leaves(tree)}

    def resolve_moments(self, optimizer, names=None
                        ) -> Dict[str, Dict[str, PartitionSpec]]:
        """``{parameter name: {state key: spec}}`` for a ``torch.optim``
        optimizer (or its ``state_dict()``).  Each moment resolves through
        its parameter's name, with ``moment_rules`` where the plan has
        them; scalar state (Adam's ``step``) replicates.  Names come from
        the param groups' ``param_names`` (an optimizer built over
        ``named_parameters()``), else from ``names``: the module the
        optimizer's parameters belong to, or the names in the
        optimizer's parameter order.  A state entry whose index names no
        parameter is an error."""
        rules = self.moment_rules if self.moment_rules is not None \
            else self.rules
        out = {}
        for name, state in moment_entries(optimizer, names):
            out[name] = {key: self.spec_for(name, _shape(value), rules)
                         for key, value in state.items()}
        return out

    def shardings(self, mesh, tree) -> Dict[str, list]:
        """``resolve`` lifted to DTensor placements over ``mesh`` (a
        ``DeviceMesh`` with ``mesh_dim_names``): ``{name: [placement per
        mesh dimension]}``."""
        names = list(mesh_axis_sizes(mesh))
        return {n: placements_for(s, names)
                for n, s in self.resolve(tree).items()}

    def explain(self, tree) -> List[Dict[str, Any]]:
        """Leaf-by-leaf resolution table (the ``tools.shardplan --show``
        payload): ``[{"path", "shape", "rule", "spec"}]`` in parameter
        order; unmatched leaves get ``rule=None, spec=None``."""
        rows = []
        for path, shape in named_leaves(tree):
            if len(shape) == 0:
                rows.append({"path": path, "shape": shape,
                             "rule": "<scalar>", "spec": str(P())})
                continue
            rule = self.match(path, shape)
            rows.append({
                "path": path, "shape": shape,
                "rule": rule.name if rule else None,
                "spec": str(rule.spec) if rule else None,
            })
        return rows


def moment_entries(optimizer, names=None):
    """``[(parameter name, state mapping)]`` of an optimizer's state (or
    its ``state_dict()``), each index mapped back to its parameter's name
    through the param groups (see :meth:`ShardingPlan.resolve_moments`)."""
    if isinstance(optimizer, Mapping):
        sd, by_index = optimizer, None
    else:
        sd = optimizer.state_dict()
        by_index = [p for g in optimizer.param_groups for p in g["params"]]
    index_name = {}
    flat = [i for g in sd["param_groups"] for i in g["params"]]
    group_names = [n for g in sd["param_groups"]
                   for n in g.get("param_names", ())]
    if len(group_names) == len(flat):
        index_name = dict(zip(flat, group_names))
    elif hasattr(names, "named_parameters"):
        if by_index is None:
            raise ValueError("a state dict without param_names maps to "
                             "names by order: pass the names as a list")
        ident = {id(p): n for n, p in names.named_parameters()}
        index_name = {i: ident[id(p)] for i, p in zip(flat, by_index)
                      if id(p) in ident}
    elif names is not None:
        index_name = dict(zip(flat, list(names)))
    else:
        raise ValueError(
            "optimizer param groups carry no param_names: build the "
            "optimizer over named_parameters(), or pass names= (the module "
            "or the parameter names in the optimizer's order)"
        )
    out = []
    for idx, state in sd["state"].items():
        name = index_name.get(idx)
        if name is None:
            shapes = {k: _shape(v) for k, v in state.items()}
            raise ValueError(
                f"optimizer state entry {idx!r} ({shapes}) names no "
                "parameter of the param groups — cannot infer its "
                "placement.  Moments follow their parameter's name, never "
                "its shape: resolve the optimizer built over the module's "
                "parameters"
            )
        out.append((name, state))
    return out


@dataclasses.dataclass
class PlanValidation:
    """Structured :func:`validate` result.  ``unmatched`` and ``conflicts``
    are the error classes; ``shadowed`` rules are advisory (every leaf
    they match was claimed by an earlier rule)."""

    plan: str
    unmatched: List[str] = dataclasses.field(default_factory=list)
    shadowed: List[str] = dataclasses.field(default_factory=list)
    #: ``[{"path", "rule", "reason"}]`` — a matched rule whose spec cannot
    #: apply to the leaf (rank overflow, a mesh axis used twice, an axis
    #: missing from the mesh, indivisible dims or heads).
    conflicts: List[Dict[str, str]] = dataclasses.field(
        default_factory=list)
    n_leaves: int = 0
    n_sharded: int = 0

    @property
    def ok(self) -> bool:
        return not self.unmatched and not self.conflicts

    def summary(self) -> dict:
        return {
            "plan": self.plan,
            "ok": self.ok,
            "unmatched": list(self.unmatched),
            "shadowed": list(self.shadowed),
            "conflicts": [dict(c) for c in self.conflicts],
            "n_leaves": self.n_leaves,
            "n_sharded": self.n_sharded,
        }

    def render(self) -> str:
        lines = [f"plan {self.plan!r}: "
                 f"{'ok' if self.ok else 'FINDINGS'} "
                 f"({self.n_sharded}/{self.n_leaves} leaves sharded)"]
        for p in self.unmatched:
            lines.append(f"  unmatched leaf: {p}")
        for c in self.conflicts:
            lines.append(
                f"  conflict at {c['path']} (rule {c['rule']}): "
                f"{c['reason']}"
            )
        for r in self.shadowed:
            lines.append(f"  shadowed rule: {r}")
        return "\n".join(lines)


def head_dims(module) -> Dict[str, Tuple[int, int]]:
    """``{parameter name: (heads dimension, d_head)}`` for the attention
    projections of ``module``: each submodule with a ``HEAD_DIMS`` table
    (``models.transformer.MultiHeadAttention``) lists its weights whose
    dimension packs whole heads of ``d_head`` rows."""
    out = {}
    for prefix, m in module.named_modules():
        table = getattr(type(m), "HEAD_DIMS", None)
        if not table:
            continue
        for suffix, dim in table.items():
            out[f"{prefix}.{suffix}" if prefix else suffix] = (dim, m.d_head)
    return out


def _conflict(path, spec, shape, axis_sizes, heads):
    if len(tuple(spec)) > len(shape):
        return (f"spec {spec} has {len(tuple(spec))} entries for a "
                f"rank-{len(shape)} leaf")
    axes = spec_axes(spec)
    dupes = {a for a in axes if axes.count(a) > 1}
    if dupes:
        return (f"mesh axis {sorted(dupes)} appears in more than one entry "
                f"of spec {spec}")
    if axis_sizes is None:
        return None
    missing = [a for a in axes if a not in axis_sizes]
    if missing:
        return (f"spec {spec} names axes {missing} absent from the mesh "
                f"{tuple(axis_sizes)}")
    for dim, (extent, entry) in enumerate(zip(shape, tuple(spec))):
        if entry is None:
            continue
        names = entry if isinstance(entry, (tuple, list)) else (entry,)
        size = 1
        for a in names:
            size *= axis_sizes[str(a)]
        if size and extent % size:
            return (f"dim {extent} not divisible by axis size {size} "
                    f"({'×'.join(map(str, names))})")
        head = heads.get(path)
        if head is not None and head[0] == dim and size \
                and (extent // head[1]) % size:
            return (f"{extent // head[1]} heads of {head[1]} not divisible "
                    f"by axis size {size} ({'×'.join(map(str, names))})")
    return None


def validate(plan: ShardingPlan, params, mesh=None) -> PlanValidation:
    """Check ``plan`` against ``params`` (an ``nn.Module``, possibly on the
    meta device, a state dict or a name → shape mapping; only names and
    shapes are read).

    Reported:

    * **unmatched** — non-scalar leaves no rule matches;
    * **conflicts** — a matched spec that cannot apply: more entries than
      the leaf has dims, the same mesh axis in two entries, or — when
      ``mesh`` (a ``DeviceMesh`` or ``{axis: size}``) is given — an axis
      the mesh lacks, a sharded dim the axis size does not divide, or
      (for an ``nn.Module``'s attention projections) a head count it does
      not divide, so query and kv heads (GQA) both stay whole;
    * **shadowed** — rules whose every candidate leaf an earlier rule
      claimed (advisory).
    """
    leaves = named_leaves(params)
    heads = head_dims(params) if hasattr(params, "named_modules") else {}
    out = PlanValidation(plan=plan.name)
    claimed: Dict[str, set] = {r.name: set() for r in plan.rules}
    candidates: Dict[str, set] = {r.name: set() for r in plan.rules}
    axis_sizes = mesh_axis_sizes(mesh) if mesh is not None else None

    for p, shape in leaves:
        out.n_leaves += 1
        if len(shape) == 0:
            continue
        hit = None
        for rule in plan.rules:
            if not rule.matches(p, shape):
                continue
            candidates[rule.name].add(p)
            if hit is None:
                hit = rule
                claimed[rule.name].add(p)
        if hit is None:
            out.unmatched.append(p)
            continue
        if spec_axes(hit.spec):
            out.n_sharded += 1
        reason = _conflict(p, hit.spec, shape, axis_sizes, heads)
        if reason is not None:
            out.conflicts.append({"path": p, "rule": hit.name,
                                  "reason": reason})

    for rule in plan.rules:
        if candidates[rule.name] and not claimed[rule.name]:
            out.shadowed.append(rule.name)
    return out
