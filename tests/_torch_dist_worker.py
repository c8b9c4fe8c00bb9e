"""Worker processes for the multi-rank gloo tests of ``chainermn_tpu_torch``.

Imports only torch, numpy and the port, so a spawned child never loads
JAX.  Each worker joins a ``file://`` rendezvous, runs one check, and
writes its result as JSON to ``<out_dir>/rank<r>.json``; an assertion
failure exits the process non-zero.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

GRAD_SHAPES = [(3, 5), (7,), (2, 3, 4), (1,), (16, 8)]


def rank_grads(rank: int, seed: int = 0):
    """Rank ``r``'s gradients: seeded numpy draws, fp32 plus one fp64."""
    rng = np.random.RandomState(seed + 1000 * rank)
    out = [rng.randn(*s).astype(np.float32) for s in GRAD_SHAPES]
    out.append(rng.randn(6).astype(np.float64))
    return out


def linear_problem(n=16, d=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    y = rng.randn(n, 1).astype(np.float32)
    w = rng.randn(d, 1).astype(np.float32)
    return x, y, w


def _allreduce(comm_name, bucket_bytes, dtype_name, rank, size):
    from chainermn_tpu_torch import create_communicator

    kw = {}
    if comm_name == "hierarchical":
        kw = dict(inter_size=2, intra_size=size // 2)
    dtype = None if dtype_name is None else getattr(torch, dtype_name)
    comm = create_communicator(comm_name, device="cpu", bucket_bytes=bucket_bytes,
                               allreduce_grad_dtype=dtype, **kw)
    assert comm.rank == rank and comm.size == size
    if comm_name == "hierarchical":
        assert (comm.inter_rank, comm.intra_rank) == divmod(rank, size // 2)
    grads = [torch.from_numpy(g.copy()) for g in rank_grads(rank)]
    comm.allreduce_grad(grads)
    want = [np.mean([rank_grads(r)[i] for r in range(size)], axis=0)
            for i in range(len(grads))]
    err = max(float(np.abs(g.numpy() - w).max()) for g, w in zip(grads, want))
    # A second step on the same shapes: every rank now holds the mean, so
    # the mean is unchanged, and the bucket plan of the first step serves.
    comm.allreduce_grad(grads)
    err = max(err, *(float(np.abs(g.numpy() - w).max())
                     for g, w in zip(grads, want)))
    dtypes = [str(g.dtype) for g in grads]
    comm.barrier()
    return {"max_err": err, "dtypes": dtypes, "plans": len(comm._packers),
            "topology": [comm.inter_rank, comm.inter_size, comm.intra_rank,
                         comm.intra_size]}


def _sgd_step(comm_name, rank, size):
    """Three SGD steps of the multi-node optimizer on the global batch;
    returns the final weights (every rank must hold the same)."""
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)

    comm = create_communicator(comm_name, device="cpu")
    x, y, w = linear_problem()
    # Rank 0's initial weights win the first broadcast.
    w_param = torch.nn.Parameter(torch.from_numpy(w + 0.5 * rank))
    opt = create_multi_node_optimizer(torch.optim.SGD([w_param], lr=0.1), comm)
    opt.init()
    step = opt.make_train_step(
        lambda b: ((b[0] @ w_param - b[1]) ** 2).mean())
    losses = [float(step((torch.from_numpy(x), torch.from_numpy(y))))
              for _ in range(3)]
    return {"w": w_param.detach().numpy().ravel().tolist(), "losses": losses}


def run(kind: str, rank: int, size: int, init_file: str, out_dir: str,
        args: dict):
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=size)
    try:
        if kind == "allreduce":
            res = _allreduce(args["comm"], args.get("bucket_bytes"),
                             args.get("dtype"), rank, size)
        elif kind == "sgd":
            res = _sgd_step(args["comm"], rank, size)
        else:
            raise ValueError(kind)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()
