"""Gloo worker processes for the port's linter tests
(``tests/test_torch_analysis.py``): every fixture of
``chainermn_tpu_torch.analysis.fixtures`` that needs ranks, the clean gate
on the five communicators, a step whose ranks diverge, the 64-leaf census,
and the LM's unreduced-gradient case through the flash custom ops.

Imports only torch, numpy and the port, so a spawned child never loads
JAX.  ``run`` joins a ``file://`` rendezvous, runs every case and writes
its results as JSON to ``<out_dir>/rank<r>.json``.  ``lint_target`` is a
builder for ``tools.lint --entry``.
"""

from __future__ import annotations

import json
import os
import time

import torch
import torch.distributed as dist

#: the 64-leaf census tree of tests/golden/allreduce_census_64leaf.json.
N_LEAVES, TOTAL_BYTES, BUCKET_BYTES = 64, 8 * 1024 * 1024, 256 * 1024
CENSUS_COMMUNICATORS = ("naive", "flat", "xla_ici")

LM = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_len=128)


def _rules(report):
    return sorted({f.rule for f in report.findings})


def fixtures_case():
    from chainermn_tpu_torch.analysis.fixtures import (FIXTURES,
                                                       LOCAL_FIXTURES)
    from chainermn_tpu_torch.tools.lint import _lint_one

    out = {}
    for name in sorted(FIXTURES):
        if name in LOCAL_FIXTURES:
            continue
        s = _lint_one(FIXTURES[name](), None, None)
        out[name] = {"rules": sorted({f["rule"] for f in s["findings"]}),
                     "rules_run": s["rules_run"], "ok": s["ok"]}
    return out


def clean_case():
    from chainermn_tpu_torch.analysis import analyze_fn
    from chainermn_tpu_torch.analysis.fixtures import (CLEAN_COMMUNICATORS,
                                                       clean_train_step)

    out = {}
    for name in CLEAN_COMMUNICATORS:
        t = clean_train_step(name)
        rep = analyze_fn(t["fn"], *t["args"], comm=t["comm"],
                         state=t["state"])
        out[name] = {"ok": rep.ok, "rules": _rules(rep),
                     "rules_run": list(rep.rules_run),
                     "events": len(rep.program.events)}
    return out


def diverge_case():
    """Rank 1 alone all-reduces twice more than rank 0: were any
    collective run on the group during the capture, the ranks would hang
    here (the test joins under its limit)."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.analysis import analyze_fn

    comm = create_communicator("naive", device="cpu")
    x = torch.ones(8)

    def step(batch):
        y = batch * 2
        dist.all_reduce(y, group=comm.group)
        if comm.rank == 1:
            dist.all_reduce(y, group=comm.group)
            dist.all_reduce(y, group=comm.group)
        return y

    t0 = time.perf_counter()
    rep = analyze_fn(step, x, comm=comm)
    return {"rules": _rules(rep), "seconds": time.perf_counter() - t0,
            "events": len(rep.program.events)}


def census_case():
    """``allreduce_grad`` of the 64-leaf tree at bucket bytes 262144: the
    explicit reductions, with no loss mean (the golden has none)."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.analysis import capture_step
    from chainermn_tpu_torch.communicators.packing import synthetic_grad_tree

    out = {}
    for name in CENSUS_COMMUNICATORS:
        comm = create_communicator(name, device="cpu",
                                   bucket_bytes=BUCKET_BYTES, overlap=False)
        tree = synthetic_grad_tree(N_LEAVES, TOTAL_BYTES)
        prog = capture_step(lambda t: comm.allreduce_grad(list(t.values())),
                            tree, comm=comm)
        out[name] = {"reduction_collectives":
                     prog.census.reduction_collectives(),
                     "census": prog.census.census()}
    return out


def lm_step(skip_allreduce: bool, seed: int = 0):
    """The port's TransformerLM on the CPU route of the flash kernels
    (their custom ops) under a multi-node AdamW step; with
    ``skip_allreduce`` the gradients are never averaged.  Returns the
    built step, the optimizer, a global batch and the communicator."""
    opt, loss_fn, _, batch, comm = lm_setup(skip_allreduce, seed)
    return opt.make_train_step(loss_fn), opt, batch, comm


def lm_setup(skip_allreduce: bool, seed: int = 0):
    """``(optimizer, loss_fn, model, batch, comm)`` of :func:`lm_step`."""
    import numpy as np

    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.models.transformer import TransformerLM
    from chainermn_tpu_torch.ops import make_flash_attention_fn

    comm = create_communicator("xla_ici", device="cpu", overlap=False)
    if skip_allreduce:
        comm.allreduce_grad = lambda grads: grads
    model = TransformerLM(**LM, dtype=torch.float32,
                          attention_fn=make_flash_attention_fn(causal=True),
                          device="cpu", seed=seed)
    opt = create_multi_node_optimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.1),
        comm)
    opt.init()

    def loss_fn(batch):
        toks, labs = batch
        logits = model(toks).float()
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, LM["vocab"]), labs.reshape(-1))

    rng = np.random.RandomState(0)
    B, S = 2 * comm.size, LM["max_len"]
    batch = (torch.from_numpy(rng.randint(0, LM["vocab"], (B, S))),
             torch.from_numpy(rng.randint(0, LM["vocab"], (B, S))))
    return opt, loss_fn, model, batch, comm


def lm_case():
    from chainermn_tpu_torch.analysis import analyze_fn, dataflow
    from chainermn_tpu_torch.analysis.core import LintContext

    out = {}
    for skip in (False, True):
        step, opt, batch, comm = lm_step(skip)
        rep = analyze_fn(step, batch, comm=comm, state=opt)
        prog = rep.program
        ctx = LintContext(program=prog, comm=comm)
        res = dataflow.propagate(prog, ctx.labels(), dist.get_rank())
        flash = {}
        for op in prog.ops:
            if op.name.startswith("chainermn_torch."):
                flash.setdefault(op.name, []).append(
                    sorted(res.op_out[op.index]))
        out["skip" if skip else "reduced"] = {
            "rules": _rules(rep), "flash": flash,
            "messages": [f.message for f in rep.findings]}
    return out


def all_cases(out_dir):
    return {"fixtures": fixtures_case(), "clean": clean_case(),
            "diverge": diverge_case(), "census": census_case(),
            "lm": lm_case()}


def lint_target():
    """A ``tools.lint --entry`` builder: the LM step with its gradients
    never averaged (R002 fires at two ranks and more)."""
    step, opt, batch, comm = lm_step(skip_allreduce=True)
    return dict(fn=step, args=(batch,), kwargs={}, comm=comm, state=opt)


def run(rank: int, size: int, init_file: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=size)
    try:
        res = all_cases(out_dir)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()
