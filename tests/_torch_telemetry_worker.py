"""Gloo worker processes for the port's training-telemetry tests
(``tests/test_torch_telemetry.py``): the instrumented train step, the
packing and quantization plans the communicator publishes, the
``comm/quant_abs_err`` gauge and the evaluator's ``eval/*`` metrics, each
under a ``Reporter`` and a ``StepRecorder``.

Imports only torch, numpy and the port, so a spawned child never loads
JAX; the test process calls the same case functions in-process for one
rank.  ``run`` joins a ``file://`` rendezvous, runs every case and writes
its results as JSON to ``<out_dir>/rank<r>.json``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

#: Parameter names in the reference's leaf order (sorted keys), shapes.
SHAPES = (("a", (4, 3)), ("b", (3,)), ("c", (3, 1)))
BUCKET_BYTES = 48       # two fp32 buckets: [a] and [b, c]
STEPS = 3
N, N_EVAL = 16, 8


def problem(seed: int = 0):
    """Parameters, one global training batch and two eval batches."""
    rng = np.random.RandomState(seed)
    params = {k: (0.5 * rng.randn(*s)).astype(np.float32) for k, s in SHAPES}
    x = rng.randn(N, 4).astype(np.float32)
    y = rng.randn(N, 1).astype(np.float32)
    evals = [(rng.randn(N_EVAL, 4).astype(np.float32),
              rng.randn(N_EVAL, 1).astype(np.float32)) for _ in range(2)]
    return params, (x, y), evals


def _forward(ps, x):
    return torch.relu(x @ ps[0] + ps[1]) @ ps[2]


def _comm(comm_dtype=None):
    from chainermn_tpu_torch import create_communicator

    return create_communicator("xla_ici", device="cpu",
                               bucket_bytes=BUCKET_BYTES,
                               comm_dtype=comm_dtype)


def _installed(tmp, tag, rank, body):
    """``body()`` under a fresh Reporter and StepRecorder: the reporter's
    summary, the log's rows and ``body``'s result."""
    from chainermn_tpu_torch import observability as obs

    rep = obs.Reporter()
    path = os.path.join(tmp, f"{tag}.rank{rank}.jsonl")
    with obs.scope(rep), obs.StepRecorder(path, rank=rank, mem_every=0):
        res = body()
    return rep.summary(), obs.read_records(path), res


def train_case(tmp, comm_dtype=None):
    """``STEPS`` steps of the multi-node optimizer (SGD) on the global
    batch, each recorded."""
    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.observability import step_log

    comm = _comm(comm_dtype)
    params, (x, y), _ = problem()
    ps = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
          for k, _ in SHAPES]
    mno = create_multi_node_optimizer(torch.optim.SGD(ps, lr=0.1), comm)
    mno.init()
    step = mno.make_train_step(
        lambda b: ((_forward(ps, b[0]) - b[1]) ** 2).mean())
    batch = (torch.from_numpy(x), torch.from_numpy(y))

    def body():
        rec = step_log.current_recorder()
        losses = []
        for _ in range(STEPS):
            losses.append(float(step(batch)))
            rec.step(loss=losses[-1])
        return losses

    summary, rows, losses = _installed(tmp, f"train{comm_dtype}",
                                       comm.rank, body)
    spans = sorted({n for r in rows if r["event"] == "step"
                    for n in r.get("spans", {})})
    return {"summary": summary, "span_names": spans, "losses": losses}


def quant_case(tmp):
    """``measure_comm_quant_error`` on the parameters (the same on every
    rank) on the int8 wire, published and not."""
    from chainermn_tpu_torch.communicators.quant import (
        measure_comm_quant_error)

    comm = _comm("int8")
    params, _, _ = problem()
    tensors = [torch.from_numpy(params[k].copy()) for k, _ in SHAPES]
    summary, _, err = _installed(
        tmp, "quant", comm.rank,
        lambda: measure_comm_quant_error(comm, tensors))
    silent, _, _ = _installed(
        tmp, "quant_silent", comm.rank,
        lambda: measure_comm_quant_error(comm, tensors, publish=False))
    return {"err": err, "gauges": summary["gauges"],
            "silent_gauges": silent["gauges"]}


def eval_case(tmp):
    """The evaluator over this rank's slice of each eval batch."""
    from chainermn_tpu_torch.extensions import Evaluator

    comm = _comm()
    params, _, evals = problem()
    ps = [torch.from_numpy(params[k].copy()) for k, _ in SHAPES]
    n = N_EVAL // comm.size
    lo = comm.rank * n

    def metric_fn(model, b):
        x, y = b
        err = _forward(ps, x) - y
        return {"val/mse": (err ** 2).mean(),
                "val/pos": (err > 0).float().mean()}

    batches = [(torch.from_numpy(x[lo:lo + n]), torch.from_numpy(y[lo:lo + n]))
               for x, y in evals]
    summary, rows, metrics = _installed(
        tmp, "eval", comm.rank,
        lambda: Evaluator(metric_fn, comm).evaluate(None, batches))
    return {"metrics": metrics, "scalars": summary["scalars"],
            "eval_rows": [r["metrics"] for r in rows
                          if r["event"] == "eval"]}


def all_cases(tmp):
    return {"plain": train_case(tmp), "int8": train_case(tmp, "int8"),
            "quant": quant_case(tmp), "eval": eval_case(tmp)}


def debug_case(tmp):
    """``CollectiveTrace.verify_across_hosts`` with the same op sequence on
    every rank, then with rank 1 recording one more entry."""
    from chainermn_tpu_torch.utils.debug import CollectiveTrace

    comm = _comm()
    trace = CollectiveTrace(comm)
    trace.allreduce_grad([torch.ones(3), torch.zeros(2, 2)])
    trace.allreduce_obj(1)
    out = {"common": trace.verify_across_hosts(),
           "fingerprint": trace.fingerprint()}
    if comm.rank == 1:
        trace._record("allgather", torch.ones(5))
    try:
        trace.verify_across_hosts()
        out["mismatch"] = None
    except RuntimeError as e:
        out["mismatch"] = str(e)
    return out


def run(rank: int, size: int, init_file: str, out_dir: str,
        which: str = "all"):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=size)
    try:
        res = (debug_case if which == "debug" else all_cases)(out_dir)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()
