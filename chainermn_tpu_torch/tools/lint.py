"""Collective-correctness lint CLI — port of ``chainermn_tpu/tools/lint.py``.

Runs the linter (:mod:`chainermn_tpu_torch.analysis`) from the shell: the
pre-launch gate a CI job or an operator runs before committing a
multi-GPU job.

Usage::

    # clean gate: lint the default bucketed train step on every
    # communicator, on every card of this host (exit 0 when clean):
    python -m chainermn_tpu_torch.tools.lint

    # the same on two gloo ranks of this CPU:
    python -m chainermn_tpu_torch.tools.lint --device cpu --world 2

    # the seeded-violation corpus — every rule must fire (exit 1):
    python -m chainermn_tpu_torch.tools.lint --fixtures --device cpu --world 2

    # one rule subset, machine-readable:
    python -m chainermn_tpu_torch.tools.lint --rules R001,R004 --format json

    # lint YOUR step: point at a zero-arg builder (called on every rank)
    # returning dict(fn=..., args=..., kwargs=..., comm=..., state=...):
    python -m chainermn_tpu_torch.tools.lint --entry mypkg.train:lint_target

    # host-plane rules (H001–H005) package-wide, against the committed
    # wire-schema lockfile tests/golden/torch_wire_schemas.json:
    python -m chainermn_tpu_torch.tools.lint --host

    # bless an intentional wire change into the lockfile:
    python -m chainermn_tpu_torch.tools.lint --host --regen-schemas

    # source hygiene of chainermn_tpu_torch/ (ruff, or the builtin AST
    # check when ruff is absent), the chaos grammar, the host-plane rules:
    python -m chainermn_tpu_torch.tools.lint --self

The device-plane targets (the clean gate, the R fixtures, ``--entry``)
run on ``--world`` ranks: by default one a card for ``--device cuda``
(refused without a card, exit 2) and 2 for ``--device cpu``.  The CLI
starts the ranks as processes joined by a ``file://`` rendezvous and
waits for each under :data:`RANK_TIMEOUT_S`; a world of one runs in this
process.  Every rank lints the same targets (R001 and R002 compare across
ranks over the communicator's object plane); the report is the union of
the ranks' findings, target by target.  Host-plane snippets and plan
targets run here, without ranks.

Exit status: 0 clean, 1 when an error-severity finding (or a self-check
problem) survives the ``--rules``/``--disable`` filters, 2 when the lint
could not run (no card, a rank that failed or timed out).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Tuple

_PKG = "chainermn_tpu_torch"
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NOQA_RE = re.compile(r"#\s*noqa\b")
#: seconds every rank may take before the CLI kills the ranks (exit 2).
RANK_TIMEOUT_S = 600.0


def _split_csv(raw: Optional[str]) -> Optional[List[str]]:
    if raw is None:
        return None
    return [t.strip() for t in raw.split(",") if t.strip()]


def _summary(target: dict, report) -> dict:
    return {"target": target["target"], "expect": target.get("expect"),
            **report.summary()}


def _lint_one(target: dict, rules, disable) -> dict:
    from ..analysis import analyze_fn, analyze_plan

    if "source" in target:  # host-plane source snippet (H-rule fixtures)
        from ..analysis import hostlint

        hf = hostlint.make_host_file(
            target.get("target", "<host>"), target["source"],
            wire=target.get("wire", False), det=target.get("det", False),
        )
        report = hostlint.analyze_host(
            [hf], rules=rules, disable=disable or (),
            wire_lock=target.get("wire_lock"),
        )
        target.setdefault("target", "<host>")
        return _summary(target, report)
    if "plan" in target:  # sharding-plan coverage (R006 fixtures)
        report = analyze_plan(target["plan"], target["params"], rules=rules,
                              disable=disable or ())
        target.setdefault("target", "<plan>")
    else:
        report = analyze_fn(
            target["fn"], *target.get("args", ()),
            comm=target.get("comm"), rules=rules, disable=disable or (),
            state=target.get("state", ()), **target.get("kwargs", {}),
        )
        target.setdefault("target", getattr(target["fn"], "__name__",
                                            "<fn>"))
    return _summary(target, report)


def _wire_schemas_path() -> str:
    return os.path.join(_REPO_ROOT, "tests", "golden",
                        "torch_wire_schemas.json")


def _host_result(rules, disable) -> dict:
    """Lint the host plane package-wide (H001–H005) against the committed
    wire-schema lockfile."""
    from ..analysis import hostlint

    report = hostlint.analyze_host(
        hostlint.package_host_files(), rules=rules,
        disable=disable or (),
        wire_lock=hostlint.load_wire_lock(_wire_schemas_path()),
    )
    return {"target": "host", "expect": None, **report.summary()}


def _entry_target(spec: str) -> dict:
    """``module.path:builder`` — import and call the zero-arg builder; it
    returns ``dict(fn=..., args=..., kwargs=..., comm=..., state=...)``
    (or a bare callable, linted with no args)."""
    import importlib

    mod_name, _, attr = spec.partition(":")
    if not attr:
        raise SystemExit(f"--entry wants MODULE:BUILDER, got {spec!r}")
    built = getattr(importlib.import_module(mod_name), attr)()
    if callable(built):
        built = dict(fn=built, args=(), kwargs={})
    built.setdefault("target", spec)
    return built


# ----------------------------------------------------------------------
# Which targets need ranks
# ----------------------------------------------------------------------
def _plan(args) -> List[Tuple[str, str]]:
    """The device-plane and local targets in report order:
    ``("fixture"|"clean"|"entry", name)``."""
    from ..analysis.fixtures import CLEAN_COMMUNICATORS, FIXTURES

    out: List[Tuple[str, str]] = []
    if args.fixtures is not None:
        picks = args.fixtures or sorted(FIXTURES)
        unknown = [n for n in picks if n not in FIXTURES]
        if unknown:
            raise SystemExit(
                f"unknown fixture(s) {unknown}; known: {sorted(FIXTURES)}")
        out += [("fixture", n) for n in picks]
    out += [("entry", spec) for spec in args.entry]
    if args.fixtures is None and not args.entry and not args.host \
            and not args.self_check:
        comms = _split_csv(args.communicators) or list(CLEAN_COMMUNICATORS)
        out += [("clean", c) for c in comms]
    return out


def _needs_ranks(kind: str, name: str) -> bool:
    from ..analysis.fixtures import LOCAL_FIXTURES

    return not (kind == "fixture" and name in LOCAL_FIXTURES)


def _build(kind: str, name: str) -> dict:
    from ..analysis.fixtures import FIXTURES, clean_train_step

    if kind == "fixture":
        return FIXTURES[name]()
    if kind == "clean":
        return clean_train_step(name)
    return _entry_target(name)


def _rank_main(args) -> int:
    """One rank: join the world, lint every rank target in order, write
    the summaries to ``--out``."""
    import torch
    import torch.distributed as dist

    rank, world = args.rank_of, args.world
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=f"file://{args.rdv}",
        rank=rank, world_size=world)
    rules, disable = _split_csv(args.rules), _split_csv(args.disable)
    results = []
    try:
        for kind, name in _plan(args):
            if _needs_ranks(kind, name):
                results.append(_lint_one(_build(kind, name), rules,
                                         disable))
    finally:
        dist.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(results, f)
    return 0


def _merge(per_rank: List[List[dict]]) -> List[dict]:
    """Target by target, the union of the ranks' findings (rank 0's rules
    run/skipped and suppression count)."""
    merged = []
    for rows in zip(*per_rank):
        base = dict(rows[0])
        seen, findings = set(), []
        for r in rows:
            for f in r["findings"]:
                key = json.dumps(f, sort_keys=True)
                if key not in seen:
                    seen.add(key)
                    findings.append(f)
        findings.sort(key=lambda f: (f["rule"], f["eqn_path"]))
        base["findings"] = findings
        base["ok"] = all(r["ok"] for r in rows)
        merged.append(base)
    return merged


def _run_ranks(args, argv) -> List[dict]:
    """Start ``--world`` rank processes (or lint here at world 1) and
    return the merged summaries of the rank targets."""
    if args.world == 1:
        return _in_process(args)
    tmp = tempfile.mkdtemp(prefix="chainermn_lint_")
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if args.device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    procs = []
    try:
        for r in range(args.world):
            cmd = [sys.executable, "-m", f"{_PKG}.tools.lint", *argv,
                   "--device", args.device, "--world", str(args.world),
                   "--rank-of", str(r), "--rdv", os.path.join(tmp, "rdv"),
                   "--out", os.path.join(tmp, f"rank{r}.json")]
            procs.append(subprocess.Popen(cmd, env=env))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(max(0.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
        if any(c != 0 for c in codes):
            raise RuntimeError(
                f"lint ranks exited {codes} (None: killed at the "
                f"{RANK_TIMEOUT_S:.0f}s limit)")
        per_rank = []
        for r in range(args.world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                per_rank.append(json.load(f))
        return _merge(per_rank)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _in_process(args) -> List[dict]:
    import torch
    import torch.distributed as dist

    tmp = tempfile.mkdtemp(prefix="chainermn_lint_")
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    own = not dist.is_initialized()
    if own:
        dist.init_process_group(
            "nccl" if cuda else "gloo",
            init_method=f"file://{os.path.join(tmp, 'rdv')}", rank=0,
            world_size=1)
    rules, disable = _split_csv(args.rules), _split_csv(args.disable)
    try:
        return [_lint_one(_build(kind, name), rules, disable)
                for kind, name in _plan(args) if _needs_ranks(kind, name)]
    finally:
        if own:
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# --self: source-level checks (ruff when installed, AST fallback)
# ----------------------------------------------------------------------
def _iter_py_files(roots):
    for root in roots:
        if os.path.isfile(root):
            yield root
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames
                           if not d.startswith((".", "__pycache__"))]
            for f in sorted(filenames):
                if f.endswith(".py"):
                    yield os.path.join(dirpath, f)


def _builtin_source_check(roots) -> List[str]:
    """No-dependency fallback when ruff is absent: syntax errors plus
    module-level imports never referenced (skipping ``__init__.py``
    re-export facades and ``# noqa`` lines)."""
    problems: List[str] = []
    for path in _iter_py_files(roots):
        try:
            with open(path, encoding="utf-8") as f:
                src = f.read()
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            problems.append(f"{path}:{e.lineno}: syntax error: {e.msg}")
            continue
        if os.path.basename(path) == "__init__.py":
            continue
        lines = src.splitlines()
        imported: List[Tuple[str, int]] = []
        for node in tree.body:
            names = []
            if isinstance(node, ast.Import):
                names = [(a.asname or a.name.split(".")[0], node.lineno)
                         for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                names = [(a.asname or a.name, node.lineno)
                         for a in node.names if a.name != "*"]
            for name, lineno in names:
                line = lines[lineno - 1] if lineno <= len(lines) else ""
                if not _NOQA_RE.search(line) and not name.startswith("_"):
                    imported.append((name, lineno))
        if not imported:
            continue
        used = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        for node in ast.walk(tree):  # __all__-style string re-exports
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                used.add(node.value)
        for name, lineno in imported:
            if name not in used:
                problems.append(f"{path}:{lineno}: unused import {name!r}")
    return problems


def _chaos_grammar_check() -> List[str]:
    """Round-trip the port's chaos grammar corpus so a grammar regression
    fails the same smoke that guards source hygiene."""
    try:
        from ..elastic import chaos
    except Exception as e:  # noqa: BLE001 — import rot is a finding
        return [f"chaos-grammar: import failed: {e!r}"]
    try:
        return chaos.validate_grammar()
    except Exception as e:  # noqa: BLE001
        return [f"chaos-grammar: validator crashed: {e!r}"]


def _self_check(repo_root: str = _REPO_ROOT) -> Tuple[List[str], str]:
    roots = [os.path.join(repo_root, _PKG)]
    ruff = shutil.which("ruff")
    if ruff:
        proc = subprocess.run([ruff, "check", *roots], capture_output=True,
                              text=True)
        out = (proc.stdout + proc.stderr).strip()
        problems = out.splitlines() if proc.returncode else []
        return problems + _chaos_grammar_check(), "ruff"
    return _builtin_source_check(roots) + _chaos_grammar_check(), \
        "builtin-ast"


# ----------------------------------------------------------------------
def _render_text(results: List[dict]) -> str:
    lines = []
    for r in results:
        status = "clean" if r["ok"] else "FINDINGS"
        lines.append(f"{r['target']}: {status}")
        for f in r["findings"]:
            loc = f" at {f['eqn_path']}" if f["eqn_path"] else ""
            lines.append(
                f"  {f['rule']} [{f['severity']}]{loc}: {f['message']}"
            )
            if f["fix_hint"]:
                lines.append(f"    fix: {f['fix_hint']}")
    return "\n".join(lines)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=f"python -m {_PKG}.tools.lint",
        description="Collective-correctness linter for the port's steps "
                    "and host plane.",
    )
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule allowlist (e.g. R001,R004)")
    ap.add_argument("--disable", default=None,
                    help="comma-separated rule ids to suppress")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--fixtures", nargs="*", default=None, metavar="NAME",
                    help="lint the fixture corpus (all fixtures when no "
                         "names given); the full run exits nonzero — the "
                         "seeded violations must fire, while the clean "
                         "entries (expect=None) must stay finding-free")
    ap.add_argument("--communicators", default=None,
                    help="clean-gate communicator list (default: all five)")
    ap.add_argument("--entry", action="append", default=[],
                    metavar="MODULE:BUILDER",
                    help="lint a user step from a zero-arg builder "
                         "returning dict(fn=, args=, kwargs=, comm=, "
                         "state=), called on every rank")
    ap.add_argument("--self", dest="self_check", action="store_true",
                    help="source checks (ruff or builtin fallback) over "
                         "chainermn_tpu_torch/, the chaos grammar and the "
                         "host-plane rules")
    ap.add_argument("--host", action="store_true",
                    help="lint the host plane package-wide (H001–H005) "
                         "against tests/golden/torch_wire_schemas.json")
    ap.add_argument("--regen-schemas", action="store_true",
                    help="with --host: re-extract the wire structs and "
                         "rewrite tests/golden/torch_wire_schemas.json")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the device-plane targets run (default "
                         "cuda; refused without a card)")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks for the device-plane targets (default: "
                         "the number of cards for cuda, 2 for cpu)")
    ap.add_argument("--rank-of", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rdv", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = _parser()
    args = ap.parse_args(argv)
    if args.rank_of is not None:
        return _rank_main(args)

    if args.regen_schemas:
        if not args.host:
            ap.error("--regen-schemas requires --host")
        from ..analysis import hostlint

        path = _wire_schemas_path()
        data = hostlint.regen_wire_schemas(path)
        print(f"wrote {path} ({len(data['schemas'])} wire schemas)")
        return 0

    if args.list_rules:
        from ..analysis import list_rules

        rows = [{"id": i, "name": n, "summary": s}
                for i, n, s in list_rules()]
        if args.format == "json":
            print(json.dumps({"rules": rows}, indent=2))
        else:
            for r in rows:
                print(f"{r['id']}  {r['name']}: {r['summary']}")
        return 0

    rules = _split_csv(args.rules)
    disable = _split_csv(args.disable)
    self_problems: List[str] = []
    self_engine = None
    if args.self_check:
        self_problems, self_engine = _self_check()

    plan = _plan(args)
    rank_results: List[dict] = []
    if any(_needs_ranks(k, n) for k, n in plan):
        from .._device import resolve_device

        try:
            resolve_device(args.device)
        except RuntimeError as e:
            print(f"lint: {e}", file=sys.stderr)
            return 2
        if args.world is None:
            import torch

            args.world = (torch.cuda.device_count() if args.device == "cuda"
                          else 2)
        if args.world < 1:
            ap.error("--world must be >= 1")
        try:
            rank_results = _run_ranks(args, argv)
        except RuntimeError as e:
            print(f"lint: {e}", file=sys.stderr)
            return 2
    results, it = [], iter(rank_results)
    for kind, name in plan:
        if _needs_ranks(kind, name):
            results.append(next(it))
        else:
            results.append(_lint_one(_build(kind, name), rules, disable))
    if args.host or args.self_check:
        results.append(_host_result(rules, disable))
    ok = all(r["ok"] for r in results) and not self_problems

    if args.format == "json":
        out = {"ok": ok, "targets": results}
        if self_engine is not None:
            out["self"] = {"engine": self_engine,
                           "problems": self_problems}
        print(json.dumps(out, indent=2, sort_keys=True))
    else:
        if self_engine is not None:
            print(f"self-check ({self_engine}): "
                  f"{len(self_problems)} problem(s)")
            for p in self_problems:
                print(f"  {p}")
        if results:
            print(_render_text(results))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
