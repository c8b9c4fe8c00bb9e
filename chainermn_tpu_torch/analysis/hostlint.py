"""Host-plane static analysis — lock discipline, mirror contract, wire
schemas, determinism taint (rules H001–H005).

Port of ``chainermn_tpu/analysis/hostlint.py`` over the port's own
sources (AST only; nothing is imported or run).  R001–R006 lint the
*device* plane: the captured op stream of a step program.
This module gives the threaded *host* plane — router, shard groups,
gossip, heartbeats, migration — the same treatment: parse the package's
cluster-tier sources with :mod:`ast` and evaluate protocol contracts
that were previously proven only by runtime soaks.

* **H001 lock-discipline** — per class, infer the guarded-by set of
  every attribute (accessed inside ``with <owner>.lock`` vs bare) and
  flag attributes that are written AND accessed both with and without
  the lock; additionally build a cross-class lock-order graph from
  nested acquisitions and report cycles (potential deadlocks).
* **H002 blocking-under-lock** — socket send/recv, ``Queue.get/put``
  without timeout, ``time.sleep``, and subprocess waits while a lock
  is held.
* **H003 mirror-before-execute** — in any class defining ``_mirror``
  (the shard-group replay tap from the serving engine), every method
  that calls one of the engine's device steps — ``self._run``,
  ``self._<mode>_run``, ``self._cow``, ``self._permute``, the port's
  counterparts of the reference's ``self.*_jit`` steps and
  ``self._cache`` assignments, which it still reads (the snippets spell
  them) — must emit to the mirror *first*; replaying followers fall out
  of lock-step otherwise.  The steps themselves, ``apply_step``,
  ``_mirror`` and ``__init__`` are exempt.
* **H004 wire-schema-lock** — extract the wire structs (``@dataclass``
  heartbeat payloads, ``{"op": ...}`` CMD dicts, string-tagged EVT/GRP
  tuple frames, the migration metadata dict) and diff them against the
  committed lockfile ``tests/golden/torch_wire_schemas.json``: removed or
  reordered fields, defaults lost, and default-less trailing appends
  are errors; genuinely new structs surface as warnings until blessed
  via ``tools.lint --host --regen-schemas``.
* **H005 determinism-taint** — ``random.*`` / unseeded ``np.random.*``
  / ``time.time()`` / set-iteration in the scheduler, sampling, and
  defrag paths, outside the blessed injectable-clock and counter-RNG
  (``np.random.default_rng((seed, counter))``) helpers.

Rules register through the same :func:`~.core.register_rule` machinery as R001–R006 with ``requires=("host",)``, so
they are skipped (not errored) on jaxpr/plan entry points and vice
versa.  Entry point: :func:`analyze_host`.  Suppression: the shared
``disable=`` / env surfaces, plus line-scoped ``# hostlint:
disable=H00x`` comments on the finding's line or the line above —
every in-tree suppression must carry a justifying comment.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .core import (
    Finding,
    LintContext,
    LintReport,
    SEVERITY_ERROR,
    SEVERITY_WARNING,
    _run_rules,
    register_rule,
)

_HOST_DISABLE_RE = re.compile(
    r"#\s*hostlint:\s*disable=([A-Za-z0-9_, \t]+)"
)

#: host-plane corpus: (package-relative path, wire-schema scope (H004),
#: determinism scope (H005)).  H001–H003 run on every file.
HOST_PLANE_FILES: Tuple[Tuple[str, bool, bool], ...] = (
    ("serving/cluster/router.py", False, False),
    ("serving/cluster/service.py", True, False),
    ("serving/cluster/replica.py", True, False),
    ("serving/cluster/health.py", False, False),
    ("serving/cluster/driver.py", False, False),
    ("serving/cluster/shard_group.py", True, False),
    ("serving/cluster/migration.py", True, False),
    ("serving/cluster/prefix_gossip.py", True, False),
    ("serving/cluster/metrics_gossip.py", True, False),
    ("observability/exporter.py", False, False),
    ("serving/engine.py", False, True),
    ("serving/scheduler.py", False, True),
    ("serving/kv_cache.py", False, True),
    ("serving/frontend.py", False, True),
    ("serving/spec.py", False, True),
    # Resource fabric: the chip ledger's lease frames and the heartbeat
    # payload cross the supervisor/rank version boundary (wire scope);
    # ledger/policy/arbiter decisions must be pure functions of their
    # inputs (determinism scope).
    ("elastic/heartbeat.py", True, False),
    ("fabric/ledger.py", True, True),
    ("fabric/policy.py", False, True),
    ("fabric/arbiter.py", False, True),
)


@dataclasses.dataclass
class HostFile:
    """One parsed host-plane source, plus its line-scoped suppressions
    (``{lineno: frozenset of rule ids}``) and per-rule scope flags."""

    name: str
    source: str
    tree: ast.Module
    wire: bool = False
    det: bool = False
    suppressions: Dict[int, frozenset] = dataclasses.field(
        default_factory=dict
    )


def make_host_file(name: str, source: str, wire: bool = False,
                   det: bool = False) -> HostFile:
    supp: Dict[int, frozenset] = {}
    for lineno, line in enumerate(source.splitlines(), start=1):
        m = _HOST_DISABLE_RE.search(line)
        if m:
            supp[lineno] = frozenset(
                t.strip() for t in m.group(1).split(",") if t.strip()
            )
    return HostFile(
        name=name, source=source, tree=ast.parse(source, filename=name),
        wire=wire, det=det, suppressions=supp,
    )


def package_host_files() -> List[HostFile]:
    """The default corpus: every host-plane file of the installed
    package, with its H004/H005 scope flags."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = []
    for rel, wire, det in HOST_PLANE_FILES:
        path = os.path.join(pkg_root, rel)
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        out.append(make_host_file(
            "chainermn_tpu_torch/" + rel, src, wire=wire, det=det,
        ))
    return out


@dataclasses.dataclass
class HostContext:
    """The ``ctx.host`` piece H-rules require."""

    files: List[HostFile]
    wire_lock: Optional[dict] = None
    _lock_info: Any = None

    def lock_info(self) -> "_LockInfo":
        if self._lock_info is None:
            self._lock_info = _collect_lock_info(self.files)
        return self._lock_info


# ----------------------------------------------------------------------
# AST helpers
# ----------------------------------------------------------------------
def _dotted(node) -> Optional[str]:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _looks_like_lock(attr: str) -> bool:
    a = attr.lower()
    return a == "lock" or "_lock" in a or a.startswith("lock") \
        or a.endswith("lock")


def _is_lock_expr(expr) -> Optional[Tuple[str, str]]:
    """``(owner, attr)`` when ``expr`` is ``<name>.<lock-ish attr>``."""
    if isinstance(expr, ast.Attribute) and _looks_like_lock(expr.attr) \
            and isinstance(expr.value, ast.Name):
        return expr.value.id, expr.attr
    return None


def _fmt_lines(lines: Sequence[int]) -> str:
    uniq = sorted(set(lines))
    shown = ", ".join(str(n) for n in uniq[:5])
    return shown + (", …" if len(uniq) > 5 else "")


def _local_types(fn) -> Dict[str, str]:
    """Best-effort var → class-name map from annotations and
    ``v = ClassName(...)`` assignments, for lock identity."""
    types: Dict[str, str] = {}
    for a in list(fn.args.args) + list(fn.args.kwonlyargs):
        ann = a.annotation
        if isinstance(ann, ast.Name):
            types[a.arg] = ann.id
        elif isinstance(ann, ast.Attribute):
            types[a.arg] = ann.attr
        elif isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            types[a.arg] = ann.value.rsplit(".", 1)[-1]
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            f = n.value.func
            cname = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) else None
            )
            if cname and cname[:1].isupper():
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        types[t.id] = cname
    return types


# ----------------------------------------------------------------------
# Shared lock-region walk (feeds H001 and H002)
# ----------------------------------------------------------------------
class _LockInfo:
    def __init__(self):
        #: (file, class, owner, attr) -> {"guarded": [ln], "bare": [ln],
        #: "write": bool}
        self.access: Dict[tuple, dict] = {}
        #: (held lock id, acquired lock id) -> (file, lineno)
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        #: file -> [(lineno, message)]
        self.blocking: Dict[str, List[Tuple[int, str]]] = {}


_SOCKET_METHODS = frozenset(
    {"send", "sendall", "recv", "recv_into", "accept", "connect"}
)
_SUBPROCESS_CALLS = frozenset({
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output",
})


def _blocking_message(node: ast.Call) -> Optional[str]:
    dotted = _dotted(node.func)
    kw = {k.arg for k in node.keywords}
    if dotted == "time.sleep":
        return "time.sleep() while holding a lock"
    if dotted in _SUBPROCESS_CALLS and "timeout" not in kw:
        return f"{dotted}() without timeout= while holding a lock"
    if isinstance(node.func, ast.Attribute):
        a = node.func.attr
        if a in _SOCKET_METHODS:
            return f".{a}() socket/channel I/O while holding a lock"
        recv = _dotted(node.func.value) or ""
        if a in ("get", "put") and "timeout" not in kw \
                and "queue" in recv.rsplit(".", 1)[-1].lower():
            return (f".{a}() on a queue without timeout= while holding "
                    f"a lock")
        if a in ("wait", "communicate") and "timeout" not in kw \
                and not node.args:
            return f".{a}() without a timeout while holding a lock"
    return None


def _collect_lock_info(files: Sequence[HostFile]) -> _LockInfo:
    info = _LockInfo()
    for hf in files:
        blocking = info.blocking.setdefault(hf.name, [])

        def walk_fn(fn, cls_name):
            types = _local_types(fn)

            def lock_id(owner, attr):
                if owner == "self" and cls_name:
                    return f"{cls_name}.{attr}"
                t = types.get(owner)
                return f"{t}.{attr}" if t else f"{owner}.{attr}"

            def record(node, held):
                if not isinstance(node.value, ast.Name):
                    return
                owner, attr = node.value.id, node.attr
                if _looks_like_lock(attr):
                    return
                guarded = any(h[0] == owner for h in held)
                key = (hf.name, cls_name or "<module>", owner, attr)
                rec = info.access.setdefault(
                    key, {"guarded": [], "bare": [], "write": False}
                )
                (rec["guarded"] if guarded else rec["bare"]).append(
                    node.lineno
                )
                if isinstance(node.ctx, (ast.Store, ast.Del)):
                    rec["write"] = True

            def visit(node, held):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    new = []
                    for item in node.items:
                        visit(item.context_expr, held)
                        li = _is_lock_expr(item.context_expr)
                        if li:
                            owner, attr = li
                            lid = lock_id(owner, attr)
                            for h in held + new:
                                if h[1] != lid:
                                    info.edges.setdefault(
                                        (h[1], lid),
                                        (hf.name, node.lineno),
                                    )
                            new.append((owner, lid))
                    for stmt in node.body:
                        visit(stmt, held + new)
                    return
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.Lambda)):
                    # a nested def runs later — the lock is NOT
                    # guaranteed held at call time
                    body = node.body if isinstance(node.body, list) \
                        else [node.body]
                    for stmt in body:
                        visit(stmt, [])
                    return
                if isinstance(node, ast.Attribute):
                    record(node, held)
                if isinstance(node, ast.Call) and held:
                    msg = _blocking_message(node)
                    if msg:
                        blocking.append((node.lineno, msg))
                for child in ast.iter_child_nodes(node):
                    visit(child, held)

            for stmt in fn.body:
                visit(stmt, [])

        for top in hf.tree.body:
            if isinstance(top, ast.ClassDef):
                for item in top.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)) \
                            and item.name != "__init__":
                        walk_fn(item, top.name)
            elif isinstance(top, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk_fn(top, None)
    return info


def _cycle_findings(edges: Dict[Tuple[str, str], Tuple[str, int]]
                    ) -> List[Finding]:
    graph: Dict[str, List[str]] = {}
    for a, b in edges:
        graph.setdefault(a, []).append(b)
    findings, seen = [], set()

    def dfs(node, path):
        for nxt in sorted(graph.get(node, ())):
            if nxt in path:
                cyc = path[path.index(nxt):] + [nxt]
                key = frozenset(cyc)
                if key in seen:
                    continue
                seen.add(key)
                loc = edges.get((node, nxt), ("", 0))
                findings.append(Finding(
                    rule="H001", severity=SEVERITY_ERROR,
                    message=("lock-order cycle (potential deadlock): "
                             + " -> ".join(cyc)),
                    eqn_path=f"{loc[0]}:{loc[1]}",
                    fix_hint=("pick one global acquisition order for "
                              "these locks and take them in that order "
                              "everywhere"),
                ))
            else:
                dfs(nxt, path + [nxt])

    for start in sorted(graph):
        dfs(start, [start])
    return findings


# ----------------------------------------------------------------------
# H001 / H002
# ----------------------------------------------------------------------
@register_rule(
    "H001", "lock-discipline",
    "attributes accessed both under and outside their owner's lock, "
    "and lock-order cycles across classes",
    requires=("host",),
)
def check_h001(ctx: LintContext) -> List[Finding]:
    info = ctx.host.lock_info()
    findings = []
    for (fname, cls, owner, attr), rec in sorted(info.access.items()):
        if rec["guarded"] and rec["bare"] and rec["write"]:
            findings.append(Finding(
                rule="H001", severity=SEVERITY_ERROR,
                message=(
                    f"{cls}: {owner}.{attr} is written and accessed "
                    f"both under {owner}'s lock (lines "
                    f"{_fmt_lines(rec['guarded'])}) and bare (lines "
                    f"{_fmt_lines(rec['bare'])})"
                ),
                eqn_path=f"{fname}:{min(rec['bare'])}",
                fix_hint=("hold the lock on every access, or document "
                          "single-thread confinement with "
                          "'# hostlint: disable=H001' + a comment"),
            ))
    findings.extend(_cycle_findings(info.edges))
    return findings


@register_rule(
    "H002", "blocking-under-lock",
    "sleeps, socket I/O, timeout-less queue ops and subprocess waits "
    "while a lock is held",
    requires=("host",),
)
def check_h002(ctx: LintContext) -> List[Finding]:
    info = ctx.host.lock_info()
    findings = []
    for fname in sorted(info.blocking):
        for lineno, msg in sorted(info.blocking[fname]):
            findings.append(Finding(
                rule="H002", severity=SEVERITY_ERROR, message=msg,
                eqn_path=f"{fname}:{lineno}",
                fix_hint=("move the blocking call outside the lock, or "
                          "bound it with a timeout"),
            ))
    return findings


# ----------------------------------------------------------------------
# H003 mirror-before-execute
# ----------------------------------------------------------------------
_DEVICE_STEPS = frozenset({"_run", "_cow", "_permute"})


def _is_device_step(name: str) -> bool:
    """The engine's device steps: ``_run``, ``_<mode>_run`` (prefill,
    decode, chunk), ``_cow`` (the copy-on-write page copy) and
    ``_permute`` (the defragment page permutation); and the reference's
    ``*_jit`` steps, which its snippets and fixtures spell."""
    return name in _DEVICE_STEPS or name.endswith("_jit") or (
        name.startswith("_") and name.endswith("_run"))


def _is_self_step(node) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and _is_device_step(node.attr))


#: replay/plumbing methods exempt from the mirror contract:
#: ``apply_step`` IS the follower's replay of mirrored ops, ``_mirror``
#: is the tap itself, ``__init__`` runs before any follower attaches, and
#: the device steps themselves are what the mirrored callers run.
_H003_EXEMPT = frozenset({"__init__", "_mirror", "apply_step"})


@register_rule(
    "H003", "mirror-before-execute",
    "device-mutating engine paths must emit to mirror_sink before "
    "mutating cache state (shard-group replay contract)",
    requires=("host",),
)
def check_h003(ctx: LintContext) -> List[Finding]:
    findings = []
    for hf in ctx.host.files:
        for cls in [n for n in ast.walk(hf.tree)
                    if isinstance(n, ast.ClassDef)]:
            names = {m.name for m in cls.body
                     if isinstance(m, ast.FunctionDef)}
            if "_mirror" not in names:
                continue
            for m in cls.body:
                if not isinstance(m, ast.FunctionDef) \
                        or m.name in _H003_EXEMPT \
                        or _is_device_step(m.name):
                    continue
                aliases = set()
                for n in ast.walk(m):
                    if isinstance(n, ast.Assign) and any(
                            _is_self_step(d) for d in ast.walk(n.value)):
                        for t in n.targets:
                            if isinstance(t, ast.Name):
                                aliases.add(t.id)
                mirrors, mutations = [], []
                for n in ast.walk(m):
                    if isinstance(n, ast.Call):
                        if _dotted(n.func) == "self._mirror":
                            mirrors.append(n.lineno)
                        elif _is_self_step(n.func) or (
                                isinstance(n.func, ast.Name)
                                and n.func.id in aliases):
                            mutations.append(n.lineno)
                    if isinstance(n, (ast.Assign, ast.AugAssign)):
                        targets = n.targets if isinstance(n, ast.Assign) \
                            else [n.target]
                        for t in targets:
                            for tt in ast.walk(t):
                                if isinstance(tt, ast.Attribute) \
                                        and isinstance(tt.ctx, ast.Store) \
                                        and _dotted(tt) == "self._cache":
                                    mutations.append(n.lineno)
                if not mutations:
                    continue
                first = min(mutations)
                if not mirrors:
                    msg = (f"{cls.name}.{m.name} mutates device cache "
                           f"state without emitting to mirror_sink — "
                           f"replaying followers will diverge")
                elif min(mirrors) > first:
                    msg = (f"{cls.name}.{m.name} emits to mirror_sink "
                           f"only AFTER mutating (mirror at line "
                           f"{min(mirrors)}, mutation at line {first})")
                else:
                    continue
                findings.append(Finding(
                    rule="H003", severity=SEVERITY_ERROR, message=msg,
                    eqn_path=f"{hf.name}:{first}",
                    fix_hint=("call self._mirror(op, *payload) before "
                              "the device step"),
                ))
    return findings


# ----------------------------------------------------------------------
# H004 wire-schema lock
# ----------------------------------------------------------------------
def _is_dataclass(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        d = _dotted(target) or ""
        if d.rsplit(".", 1)[-1] == "dataclass":
            return True
    return False


def _maybe_frame(t, out: dict, hf: HostFile) -> None:
    if not (isinstance(t, ast.Tuple) and t.elts
            and isinstance(t.elts[0], ast.Constant)
            and isinstance(t.elts[0].value, str)
            and t.elts[0].value.isidentifier()):
        return
    key = f"frame:{t.elts[0].value}"
    prev = out.get(key)
    arity = sorted({len(t.elts)} | set(prev["arity"] if prev else ()))
    out[key] = {
        "arity": arity,
        "loc": prev["loc"] if prev else (hf.name, t.lineno),
    }


def extract_wire_schemas(files: Sequence[HostFile]) -> dict:
    """Schema registry from the ``wire=True`` files: ``dataclass:<name>``
    (ordered ``[field, has_default]`` pairs), ``cmd:<op>`` (dict-literal
    key sets), ``frame:<tag>`` (string-tagged tuple arities) and
    ``meta:kv_snapshot`` (the migration metadata frame).  Each entry
    carries a ``loc`` (file, line) dropped on serialization."""
    out: dict = {}
    for hf in files:
        if not hf.wire:
            continue
        for node in ast.walk(hf.tree):
            if isinstance(node, ast.ClassDef) and _is_dataclass(node):
                fields = [
                    [st.target.id, st.value is not None]
                    for st in node.body
                    if isinstance(st, ast.AnnAssign)
                    and isinstance(st.target, ast.Name)
                ]
                if fields:
                    out[f"dataclass:{node.name}"] = {
                        "fields": fields, "loc": (hf.name, node.lineno),
                    }
            elif isinstance(node, ast.Dict):
                keys = [k.value for k in node.keys
                        if isinstance(k, ast.Constant)
                        and isinstance(k.value, str)]
                if len(keys) != len(node.keys):
                    continue  # computed keys: not a literal frame
                if "op" in keys:
                    opv = node.values[keys.index("op")]
                    if isinstance(opv, ast.Constant) \
                            and isinstance(opv.value, str):
                        key = f"cmd:{opv.value}"
                        prev = out.get(key)
                        merged = sorted(
                            set(keys)
                            | set(prev["keys"] if prev else ())
                        )
                        out[key] = {
                            "keys": merged,
                            "loc": (prev["loc"] if prev
                                    else (hf.name, node.lineno)),
                        }
                elif "leaves" in keys and "seq_len" in keys:
                    out["meta:kv_snapshot"] = {
                        "keys": sorted(set(keys)),
                        "loc": (hf.name, node.lineno),
                    }
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) \
                        and f.attr in ("append", "send") and node.args:
                    _maybe_frame(node.args[0], out, hf)
            elif isinstance(node, ast.List):
                for elt in node.elts:
                    _maybe_frame(elt, out, hf)
    return out


def _locstr(entry: dict) -> str:
    loc = entry.get("loc")
    return f"{loc[0]}:{loc[1]}" if loc else ""


def compare_wire_schemas(current: dict, lock: dict) -> List[Finding]:
    """Diff an extraction against the committed lockfile.  Breaking
    changes (removal, reorder, lost default, default-less trailing
    append, arity change) are errors; unknown-to-the-lockfile structs
    are warnings until blessed by ``--regen-schemas``."""
    locked = lock.get("schemas", lock)
    regen = ("bless intended changes: python -m chainermn_tpu_torch.tools."
             "lint --host --regen-schemas")
    findings = []

    def err(key, msg, loc=""):
        findings.append(Finding(
            rule="H004", severity=SEVERITY_ERROR,
            message=f"{key}: {msg}", eqn_path=loc,
            fix_hint=("keep the wire layout append-only with defaults "
                      "(receivers may be a release behind); " + regen),
        ))

    for key in sorted(locked):
        if key not in current:
            err(key, "wire struct removed from source")
            continue
        cur, lk = current[key], locked[key]
        loc = _locstr(cur)
        if "fields" in lk:
            cf = [list(p) for p in cur.get("fields", [])]
            lf = [list(p) for p in lk["fields"]]
            broke = False
            for i, (lname, ldef) in enumerate(lf):
                if i >= len(cf) or cf[i][0] != lname:
                    err(key, f"locked field #{i} {lname!r} removed or "
                             f"reordered", loc)
                    broke = True
                    break
                if ldef and not cf[i][1]:
                    err(key, f"field {lname!r} lost its default", loc)
                    broke = True
                    break
            if not broke:
                for name, has_default in cf[len(lf):]:
                    if not has_default:
                        err(key, f"new trailing field {name!r} has no "
                                 f"default — old senders cannot omit "
                                 f"it", loc)
        elif "keys" in lk:
            missing = [k for k in lk["keys"]
                       if k not in cur.get("keys", ())]
            if missing:
                err(key, f"locked key(s) {missing} removed", loc)
        elif "arity" in lk:
            if list(cur.get("arity", ())) != list(lk["arity"]):
                err(key, f"frame arity changed: locked {lk['arity']} "
                         f"vs current {list(cur.get('arity', ()))}", loc)
    for key in sorted(set(current) - set(locked)):
        findings.append(Finding(
            rule="H004", severity=SEVERITY_WARNING,
            message=f"new wire struct {key} is not in the lockfile",
            eqn_path=_locstr(current[key]), fix_hint=regen,
        ))
    return findings


@register_rule(
    "H004", "wire-schema-lock",
    "wire structs (heartbeat dataclasses, CMD/EVT/GRP frames, "
    "migration metadata) must match the committed lockfile",
    requires=("host",),
)
def check_h004(ctx: LintContext) -> List[Finding]:
    if ctx.host.wire_lock is None:
        return []
    return compare_wire_schemas(
        extract_wire_schemas(ctx.host.files), ctx.host.wire_lock
    )


def load_wire_lock(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def regen_wire_schemas(path: str,
                       files: Optional[Sequence[HostFile]] = None) -> dict:
    """Re-extract and (over)write the lockfile — the bless step after an
    intentional wire change, mirroring the lint-fixtures golden flow."""
    current = extract_wire_schemas(
        list(files) if files is not None else package_host_files()
    )
    data = {
        "version": 1,
        "schemas": {
            key: {k: v for k, v in entry.items() if k != "loc"}
            for key, entry in sorted(current.items())
        },
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return data


# ----------------------------------------------------------------------
# H005 determinism taint
# ----------------------------------------------------------------------
_BLESSED_RNG = frozenset(
    {"np.random.default_rng", "numpy.random.default_rng"}
)


@register_rule(
    "H005", "determinism-taint",
    "global RNG, wall-clock, and set-iteration hazards in scheduler / "
    "sampling / defrag paths",
    requires=("host",),
)
def check_h005(ctx: LintContext) -> List[Finding]:
    findings = []
    for hf in ctx.host.files:
        if not hf.det:
            continue
        for node in ast.walk(hf.tree):
            msg = hint = None
            lineno = getattr(node, "lineno", 0)
            if isinstance(node, ast.Call):
                d = _dotted(node.func) or ""
                if d == "time.time":
                    msg = ("time.time() is wall-clock — ranks disagree "
                           "and replays drift")
                    hint = ("use time.monotonic() for durations or the "
                            "injected clock for timestamps")
                elif d == "random" or d.startswith("random."):
                    # a seeded private stream (random.Random(seed)) is
                    # the blessed injectable-RNG pattern, not a taint
                    if not (d == "random.Random"
                            and (node.args or node.keywords)):
                        msg = f"{d}() draws from the global process RNG"
                        hint = ("derive randomness from "
                                "np.random.default_rng((seed, counter)) "
                                "or a seeded random.Random(seed) stream")
                elif d.startswith(("np.random.", "numpy.random.")):
                    if not (d in _BLESSED_RNG
                            and (node.args or node.keywords)):
                        msg = (f"{d}() is seeded from global process "
                               f"state")
                        hint = ("use np.random.default_rng((seed, "
                                "counter)) with an explicit seed")
                elif d in ("os.urandom", "uuid.uuid4"):
                    msg = f"{d}() is nondeterministic across replays"
                    hint = ("derive ids from the injected seed/counter "
                            "instead")
            elif isinstance(node, ast.For):
                it = node.iter
                if isinstance(it, ast.Set) or (
                        isinstance(it, ast.Call)
                        and isinstance(it.func, ast.Name)
                        and it.func.id == "set"):
                    msg = ("iterating a set — element order varies "
                           "across processes (PYTHONHASHSEED)")
                    hint = "iterate sorted(...) instead"
                    lineno = it.lineno
            if msg:
                findings.append(Finding(
                    rule="H005", severity=SEVERITY_ERROR, message=msg,
                    eqn_path=f"{hf.name}:{lineno}", fix_hint=hint,
                ))
    return findings


# ----------------------------------------------------------------------
# Entry point
# ----------------------------------------------------------------------
def analyze_host(files: Sequence, rules: Optional[Sequence[str]] = None,
                 disable: Sequence[str] = (),
                 wire_lock: Optional[dict] = None) -> LintReport:
    """Run the host-plane rules over ``files`` (``HostFile``s or
    ``(name, source)`` pairs).  ``wire_lock`` is the parsed
    ``wire_schemas.json`` dict; without it H004 has nothing to diff
    against and reports nothing.  Line-scoped ``# hostlint:
    disable=H00x`` comments (on the finding's line or the line above)
    are filtered here and counted in ``report.suppressed``."""
    hfiles = [
        f if isinstance(f, HostFile) else make_host_file(*f)
        for f in files
    ]
    ctx = LintContext(host=HostContext(files=hfiles, wire_lock=wire_lock))
    report = _run_rules(ctx, rules, disable)

    supp_by_name = {f.name: f.suppressions for f in hfiles}
    kept, n_supp = [], 0
    for finding in report.findings:
        name, _, lineno = finding.eqn_path.rpartition(":")
        smap = supp_by_name.get(name, {})
        try:
            ln = int(lineno)
        except ValueError:
            ln = -1
        ids = smap.get(ln, frozenset()) | smap.get(ln - 1, frozenset())
        if finding.rule in ids:
            n_supp += 1
        else:
            kept.append(finding)
    return dataclasses.replace(
        report, findings=kept, suppressed=report.suppressed + n_supp,
    )
