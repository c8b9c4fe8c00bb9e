"""Sharding-plan browser / linter CLI — the port of
``chainermn_tpu/tools/shardplan.py``.

Front-end for :mod:`chainermn_tpu_torch.sharding`: list the registry,
print a model's resolved name → spec table for a plan, or lint plan
coverage (the reference's rule R006: unmatched leaves and conflicting
specs) across the model zoo.

Usage::

    # the registry, one line per plan:
    python -m chainermn_tpu_torch.tools.shardplan --list

    # resolved name -> spec table (the model on the meta device):
    python -m chainermn_tpu_torch.tools.shardplan --show transformer_lm tp

    # coverage lint over every model x every registry plan
    # (exit nonzero on any unmatched leaf / spec conflict):
    python -m chainermn_tpu_torch.tools.shardplan --lint
    python -m chainermn_tpu_torch.tools.shardplan --lint vit mlp --plan tp

    # machine-readable:
    python -m chainermn_tpu_torch.tools.shardplan --list --format json

The models are the port's, at the reference builders' sizes, built on
the ``meta`` device: resolution reads only names and shapes, so no
weight is allocated and no GPU is needed.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict


def _meta(cls, **kwargs):
    import torch

    with torch.device("meta"):
        return cls(**kwargs, device="meta")


def _build_transformer_lm():
    import torch

    from ..models.transformer import TransformerLM

    return _meta(TransformerLM, vocab=64, d_model=32, n_heads=4, d_ff=64,
                 n_layers=2, max_len=16, dtype=torch.float32)


def _build_transformer():
    import torch

    from ..models.transformer import Transformer

    return _meta(Transformer, vocab=64, d_model=32, n_heads=4, d_ff=64,
                 n_enc_layers=2, n_dec_layers=2, max_len=16,
                 dtype=torch.float32)


def _build_vit():
    import torch

    from ..models.vit import ViT

    return _meta(ViT, num_classes=10, patch=4, d_model=32, n_heads=4,
                 d_ff=64, n_layers=2, dtype=torch.float32, image_size=16)


def _build_resnet18():
    import torch

    from ..models.resnet import ResNet18

    return _meta(ResNet18, num_classes=10, dtype=torch.float32)


def _build_alexnet():
    import torch

    from ..models.convnets import AlexNet

    return _meta(AlexNet, num_classes=10, dtype=torch.float32)


def _build_nin():
    import torch

    from ..models.convnets import NiN

    return _meta(NiN, num_classes=10, dtype=torch.float32)


def _build_googlenet():
    import torch

    from ..models.convnets import GoogLeNet

    return _meta(GoogLeNet, num_classes=10, dtype=torch.float32)


def _build_mlp():
    from ..models.mlp import MLP

    return _meta(MLP, n_units=32, n_in=64)


def _build_seq2seq():
    from ..models.seq2seq import Seq2seq

    return _meta(Seq2seq, vocab=64, d_model=32, n_layers=2)


#: model name → zero-arg builder of the port's model on the meta device
#: (the reference builders' configs; the zoo the coverage lint runs over).
MODEL_BUILDERS: Dict[str, object] = {
    "transformer_lm": _build_transformer_lm,
    "transformer": _build_transformer,
    "vit": _build_vit,
    "resnet18": _build_resnet18,
    "alexnet": _build_alexnet,
    "nin": _build_nin,
    "googlenet": _build_googlenet,
    "mlp": _build_mlp,
    "seq2seq": _build_seq2seq,
}


def model_params(name: str):
    """The ``nn.Module`` of model ``name`` on the meta device."""
    try:
        builder = MODEL_BUILDERS[name]
    except KeyError:
        raise SystemExit(
            f"unknown model {name!r}; known: {sorted(MODEL_BUILDERS)}"
        ) from None
    return builder()


def lint_findings(plan, params) -> list:
    """The reference's rule R006 over :func:`~..sharding.validate`: one
    error finding per unmatched leaf and per conflicting spec (shadowed
    rules stay advisory, in the summary)."""
    from ..sharding import validate

    v = validate(plan, params)
    findings = []
    for path in v.unmatched:
        findings.append({
            "rule": "R006", "severity": "error",
            "message": (f"plan {plan.name!r} has no rule matching parameter "
                        f"leaf '{path}': resolution raises and the layout "
                        "is undefined for this model"),
            "eqn_path": path,
            "fix_hint": ("add a rule whose regex matches this path, or end "
                         "the plan with a terminal catch-all "
                         "PlanRule('replicate', r'.*', P())"),
        })
    for c in v.conflicts:
        findings.append({
            "rule": "R006", "severity": "error",
            "message": (f"plan {plan.name!r} rule {c['rule']!r} resolves "
                        f"leaf '{c['path']}' to a conflicting spec: "
                        f"{c['reason']}"),
            "eqn_path": c["path"],
            "fix_hint": ("fix the rule's PartitionSpec (one mesh axis per "
                         "entry, no more entries than the leaf has dims, "
                         "axes that exist on the target mesh)"),
        })
    return findings, v


def lint(models=None, plan_name=None) -> dict:
    """The ``--lint --format json`` payload: ``{"ok", "targets": [...]}``,
    one target per model × plan."""
    from ..sharding import get_plan, list_plans

    models = models or sorted(MODEL_BUILDERS)
    plans = [get_plan(plan_name)] if plan_name else list_plans()
    results = []
    for model_name in models:
        params = model_params(model_name)
        for plan in plans:
            findings, v = lint_findings(plan, params)
            results.append({
                "target": f"{model_name}×{plan.name}", "expect": None,
                "ok": not findings, "findings": findings,
                "rules_run": ["R006"], "suppressed": 0,
                "n_leaves": v.n_leaves, "n_sharded": v.n_sharded,
                "shadowed": v.shadowed,
            })
    return {"ok": all(r["ok"] for r in results), "targets": results}


def _cmd_list(args) -> int:
    from ..sharding import list_plans

    plans = list_plans()
    if args.format == "json":
        rows = [{
            "name": p.name, "axes": list(p.axes),
            "n_rules": len(p.rules),
            "moment_rules": p.moment_rules is not None,
            "description": p.description,
            "rules": [{"name": r.name, "pattern": r.pattern,
                       "spec": str(r.spec), "ndim": r.ndim}
                      for r in p.rules],
        } for p in plans]
        print(json.dumps({"plans": rows}, indent=2))
    else:
        for p in plans:
            axes = ",".join(p.axes) or "-"
            print(f"{p.name:8s} axes={axes:12s} rules={len(p.rules)}  "
                  f"{p.description}")
    return 0


def _cmd_show(args) -> int:
    from ..sharding import get_plan

    model_name, plan_name = args.show
    plan = get_plan(plan_name)
    rows = plan.explain(model_params(model_name))
    if args.format == "json":
        print(json.dumps({
            "model": model_name, "plan": plan.name,
            "rows": [{**r, "shape": list(r["shape"])} for r in rows],
        }, indent=2))
    else:
        print(f"# {model_name} × plan {plan.name!r}")
        width = max(len(r["path"]) for r in rows) if rows else 0
        for r in rows:
            spec = r["spec"] if r["spec"] is not None else "<UNMATCHED>"
            rule = r["rule"] if r["rule"] is not None else "-"
            print(f"{r['path']:{width}s}  {str(r['shape']):16s} "
                  f"{spec:32s} [{rule}]")
    return 0


def _cmd_lint(args) -> int:
    out = lint(args.lint, args.plan)
    if args.format == "json":
        print(json.dumps(out, indent=2, sort_keys=True))
    else:
        for r in out["targets"]:
            print(f"{r['target']}: {'clean' if r['ok'] else 'FINDINGS'}")
            for f in r["findings"]:
                print(f"  {f['rule']} [{f['severity']}]: {f['message']}")
                print(f"    fix: {f['fix_hint']}")
    return 0 if out["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m chainermn_tpu_torch.tools.shardplan",
        description="Sharding-plan registry browser and coverage linter.",
    )
    ap.add_argument("--list", action="store_true",
                    help="list registered plans")
    ap.add_argument("--show", nargs=2, metavar=("MODEL", "PLAN"),
                    help="resolved name→spec table for MODEL under PLAN")
    ap.add_argument("--lint", nargs="*", default=None, metavar="MODEL",
                    help="coverage lint (all models when no names given); "
                         "exit nonzero on findings")
    ap.add_argument("--plan", default=None,
                    help="restrict --lint to one registry plan")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)

    if args.list:
        return _cmd_list(args)
    if args.show:
        return _cmd_show(args)
    if args.lint is not None:
        return _cmd_lint(args)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
