"""Gloo worker processes for the data-parallel surface tests of
``chainermn_tpu_torch`` (ZeRO, the quantized and overlapped gradient
wire, every communicator, the object plane and ``split``, the evaluator,
the iterators, the checkpointer, the except hook, the MNIST example and
``make_train_step_with_state`` on a small ResNet).

Imports only torch, numpy and the port, so a spawned child never loads
JAX.  Each ``run`` joins a ``file://`` rendezvous, runs a batch of checks
and writes its results as JSON to ``<out_dir>/rank<r>.json``; an
exception exits the process non-zero.  Run as a script
(``python _torch_dp_worker.py hook RANK SIZE INIT_FILE``) it is the
except-hook case: rank 1 raises, rank 0 waits in a barrier.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ALL_NAMES = ("naive", "flat", "xla_ici", "pure_nccl", "hierarchical",
             "non_cuda_aware", "two_dimensional", "single_host",
             "single_node")
GRAD_SHAPES = [(3, 5), (7,), (2, 3, 4), (1,), (16, 8)]

# ZeRO cases: (stage, optimizer, variant); each runs 3 steps.
ZERO_STAGES = (1, 2, 3)
ZERO_OPTS = ("sgd", "adam")
ZERO_VARIANTS = ("plain", "n_accum2", "double_buffering", "loss_scale")
ZERO_STEPS = 3


def rank_grads(rank: int, seed: int = 0):
    """Rank ``r``'s gradients: seeded numpy draws, fp32 plus one fp64."""
    rng = np.random.RandomState(seed + 1000 * rank)
    out = [rng.randn(*s).astype(np.float32) for s in GRAD_SHAPES]
    out.append(rng.randn(6).astype(np.float64))
    return out


def linear_problem(n=64, d=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    y = rng.randn(n, 1).astype(np.float32)
    w = rng.randn(d, 1).astype(np.float32)
    return x, y, w


def _comm(name, device="cpu", **kw):
    from chainermn_tpu_torch import create_communicator

    size = dist.get_world_size()
    if name in ("hierarchical", "non_cuda_aware", "two_dimensional") \
            and size % 2 == 0:
        kw.update(inter_size=2, intra_size=size // 2)
    return create_communicator(name, device=device, **kw)


# -- ZeRO ---------------------------------------------------------------

def make_torch_opt(name, params):
    if name == "sgd":
        return torch.optim.SGD(params, lr=0.1, momentum=0.9)
    return torch.optim.Adam(params, lr=1e-2)


def zero_run(stage, opt_name, variant, comm):
    """Three steps of the linear problem through the port's optimizer at
    ``stage`` (0 = replicated): final w, b and the losses."""
    from chainermn_tpu_torch import create_multi_node_optimizer

    x, y, w = linear_problem()
    dev = comm.device
    wp = torch.nn.Parameter(torch.from_numpy(w.copy()).to(dev))
    bp = torch.nn.Parameter(torch.zeros(1, device=dev))
    mno = create_multi_node_optimizer(
        make_torch_opt(opt_name, [wp, bp]), comm,
        double_buffering=variant == "double_buffering", zero_stage=stage)
    mno.init()
    kw = {}
    if variant == "n_accum2":
        kw["n_accum"] = 2
    if variant == "loss_scale":
        kw["loss_scale"] = 1024.0
    step = mno.make_train_step(
        lambda b: ((b[0] @ wp + bp - b[1]) ** 2).mean(), **kw)
    batch = (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
    losses = [float(step(batch)) for _ in range(ZERO_STEPS)]
    mno.materialize()
    return {"w": wp.detach().cpu().numpy().ravel().tolist(),
            "b": bp.detach().cpu().numpy().ravel().tolist(), "losses": losses,
            "shard": None if mno._shard is None else mno._shard.numel()}


def _zero(rank, size):
    comm = _comm("xla_ici")
    return {f"{s}/{o}/{v}": zero_run(s, o, v, comm)
            for s in ZERO_STAGES for o in ZERO_OPTS for v in ZERO_VARIANTS}


# -- communicators --------------------------------------------------------

def _quant_cases(rank, size, device="cpu", names=ALL_NAMES):
    from chainermn_tpu_torch.communicators import quant

    grads_all = [rank_grads(r) for r in range(size)]
    want = [np.mean([g[i] for g in grads_all], axis=0)
            for i in range(len(grads_all[0]))]
    amax = max(float(np.abs(g).max()) for gs in grads_all for g in gs)

    def mine():
        return [torch.from_numpy(g).to(device) for g in rank_grads(rank)]

    out = {}
    for name in names:
        for cd in ("int8", "fp8"):
            comm = _comm(name, device, bucket_bytes=256, comm_dtype=cd)
            grads = mine()
            comm.allreduce_grad(grads)
            err = max(float(np.abs(g.cpu().numpy() - w).max())
                      for g, w in zip(grads, want))
            out[f"{name}/{cd}"] = {
                "err": err,
                "bound": float(quant.error_bound(cd, amax, size)),
                "wire": str(comm.wire_dtype()).split(".")[1],
                "dtypes": [str(g.dtype) for g in grads],
                "self_err": quant.measure_comm_quant_error(comm, mine()),
            }
    return out


def _full_precision_means(rank, size):
    grads_all = [rank_grads(r) for r in range(size)]
    want = [np.mean([g[i] for g in grads_all], axis=0)
            for i in range(len(grads_all[0]))]
    out = {}
    for name in ("two_dimensional", "single_node"):
        for bb in (None, 0, 256):
            comm = _comm(name, bucket_bytes=bb)
            grads = [torch.from_numpy(g.copy()) for g in rank_grads(rank)]
            comm.allreduce_grad(grads)
            out[f"{name}/{bb}"] = {
                "err": max(float(np.abs(g.numpy() - w).max())
                           for g, w in zip(grads, want)),
                "topology": [comm.inter_rank, comm.inter_size,
                             comm.intra_rank, comm.intra_size]}
    try:
        _comm("single_node", inter_size=2, intra_size=size // 2)
        out["single_node_multi_node_raises"] = False
    except ValueError:
        out["single_node_multi_node_raises"] = True
    return out


class _Net(torch.nn.Module):
    """A few differently shaped parameters, so small buckets split them."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.a = torch.nn.Linear(6, 8)
        self.b = torch.nn.Linear(8, 8)
        self.c = torch.nn.Linear(8, 3)
        self.unused = torch.nn.Parameter(torch.ones(4))  # never gets a grad
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g))

    def forward(self, x):
        return self.c(torch.tanh(self.b(torch.tanh(self.a(x)))))


OVERLAP_CASES = {
    "naive": dict(name="naive"),
    "xla_ici_g3": dict(name="xla_ici", granularity=3),
    "hierarchical": dict(name="hierarchical"),
    "two_dimensional": dict(name="two_dimensional"),
    "n_accum2": dict(name="xla_ici", n_accum=2),
    "double_buffering_loss_scale": dict(name="naive", db=True,
                                        loss_scale=64.0),
    "int8": dict(name="xla_ici", comm_dtype="int8"),
    "fp8_two_dimensional": dict(name="two_dimensional", comm_dtype="fp8"),
    "grad_dtype_f64": dict(name="naive", grad_dtype=torch.float64),
}


def _train_bytes(case, overlap, device="cpu"):
    from chainermn_tpu_torch import create_multi_node_optimizer

    net = _Net().to(device)
    comm = _comm(case["name"], device, bucket_bytes=96, overlap=overlap,
                 overlap_granularity=case.get("granularity"),
                 comm_dtype=case.get("comm_dtype"),
                 allreduce_grad_dtype=case.get("grad_dtype"))
    mno = create_multi_node_optimizer(
        torch.optim.Adam(net.parameters(), lr=1e-2), comm,
        double_buffering=case.get("db", False))
    mno.init()
    step = mno.make_train_step(
        lambda b: ((net(b[0]) - b[1]) ** 2).mean(),
        n_accum=case.get("n_accum", 1), loss_scale=case.get("loss_scale"))
    hooked = mno._overlap is not None
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(16, 6).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.randn(16, 3).astype(np.float32)).to(device)
    losses = [float(step((x, y))) for _ in range(3)]
    raw = b"".join(p.detach().cpu().numpy().tobytes()
                   for p in net.parameters())
    return raw, losses, hooked


def _overlap_cases(rank, size, device="cpu"):
    out = {}
    for key, case in OVERLAP_CASES.items():
        on, l_on, hooked_on = _train_bytes(case, True, device)
        off, l_off, hooked_off = _train_bytes(case, False, device)
        out[key] = {"equal": on == off, "losses_equal": l_on == l_off,
                    "hooked": [hooked_on, hooked_off], "losses": l_on}
    return out


def _tensor_collectives(comm, tag):
    """Results of every tensor collective on ``comm`` with inputs that name
    their rank; the test rebuilds the expected values with numpy."""
    r, n = comm.rank, comm.size
    x = torch.arange(2 * n, dtype=torch.float32) + 100 * r
    root = n - 1
    return {
        f"{tag}/allreduce_sum": comm.allreduce(x).tolist(),
        f"{tag}/allreduce_mean": comm.allreduce(x, "mean").tolist(),
        f"{tag}/allreduce_max": comm.allreduce(x, "max").tolist(),
        f"{tag}/allreduce_min": comm.allreduce(x, "min").tolist(),
        f"{tag}/allgather": comm.allgather(x).tolist(),
        f"{tag}/allgather_tiled": comm.allgather(x, tiled=True).tolist(),
        f"{tag}/gather": comm.gather(x, root=root).tolist(),
        f"{tag}/scatter": comm.scatter(
            torch.arange(2 * n, dtype=torch.float32) * (r + 1),
            root=root).tolist(),
        f"{tag}/alltoall": comm.alltoall(x).tolist(),
        f"{tag}/reduce_scatter": comm.reduce_scatter(x).tolist(),
        f"{tag}/bcast": comm.bcast(x.clone(), root=root).tolist(),
    }


def _object_plane(rank, size):
    comm = _comm("naive")
    out = {}
    # Point to point around the ring, with a tag.
    nxt, prv = (rank + 1) % size, (rank - 1) % size
    if rank % 2 == 0:
        comm.send_obj({"from": rank}, nxt, tag=5)
        got = comm.recv_obj(prv, tag=5)
    else:
        got = comm.recv_obj(prv, tag=5)
        comm.send_obj({"from": rank}, nxt, tag=5)
    out["ring"] = got["from"]
    # A receive that times out keeps the stream: the retry gets the message.
    if rank == 0:
        try:
            comm.recv_obj(1, tag=9, timeout_ms=200)
            out["timeout"] = "no"
        except TimeoutError:
            out["timeout"] = "raised"
        comm.barrier()
        out["retry"] = comm.recv_obj(1, tag=9, timeout_ms=20000)
    else:
        comm.barrier()
        if rank == 1:
            comm.send_obj("late", 0, tag=9)
    out["bcast_obj"] = comm.bcast_obj({"root": rank}, root=2)["root"]
    out["gather_root"] = comm.gather_obj(rank * 10, root=1)
    out["gather_timeout"] = comm.gather_obj(rank * 10, root=2,
                                            timeout_ms=20000)
    out["allgather_timeout"] = comm.gather_obj(rank, timeout_ms=20000)
    out["allgather"] = comm.allgather_obj(rank * rank)
    out["allreduce_obj"] = comm.allreduce_obj(rank + 1)
    out["allreduce_obj_op"] = comm.allreduce_obj(
        [rank], op=lambda a, b: a + b)
    out["scatter_obj"] = comm.scatter_obj(
        [f"to{r}" for r in range(size)] if rank == 3 else None, root=3)
    comm.barrier(timeout_s=20)
    out.update(_tensor_collectives(comm, "world"))

    # split: colors by parity, keys reverse the order inside each color.
    sub = comm.split(rank % 2, key=-rank)
    out["sub"] = [sub.rank, sub.size, type(sub).__name__]
    out["sub_allgather"] = sub.allgather_obj(rank)
    out["sub_bcast"] = sub.bcast_obj(rank, root=1)
    out["sub_gather"] = sub.gather_obj(rank, root=1)
    out["sub_scatter"] = sub.scatter_obj(
        [f"s{r}" for r in range(sub.size)] if sub.rank == 1 else None,
        root=1)
    sub.barrier(timeout_s=20)
    grads = [torch.from_numpy(g.copy()) for g in rank_grads(rank)]
    sub.allreduce_grad(grads)
    members = [r for r in range(size) if r % 2 == rank % 2]
    want = [np.mean([rank_grads(m)[i] for m in members], axis=0)
            for i in range(len(grads))]
    out["sub_grad_err"] = max(float(np.abs(g.numpy() - w).max())
                              for g, w in zip(grads, want))
    out.update(_tensor_collectives(sub, "sub"))
    # Split of a split, and MPI_UNDEFINED.
    solo = sub.split(sub.rank)
    out["solo"] = [solo.rank, solo.size, solo.allgather_obj(rank)]
    none = comm.split(None if rank == 3 else 0)
    out["undefined"] = None if none is None else [none.rank, none.size]
    # A class whose constraint the subgroup breaks degrades to xla_ici.
    single = _comm("single_node").split(0)
    out["degraded"] = type(single).__name__
    return out


def _evaluator_and_iterators(rank, size):
    from chainermn_tpu_torch.extensions import (
        Evaluator, create_multi_node_evaluator)
    from chainermn_tpu_torch.iterators import (
        create_multi_node_iterator, create_synchronized_iterator)

    comm = _comm("naive")
    batches = [torch.full((4,), float(rank * 10 + i)) for i in range(3)]
    ev = Evaluator(lambda model, b: {"m": b.mean(), "s": b.sum()}, comm)
    out = {"evaluator": ev.evaluate(None, batches)}

    class Local:
        def evaluate(self):
            return {"v": float(rank)}

    out["wrapped"] = create_multi_node_evaluator(Local(), comm).evaluate()
    mine = [[rank, i] for i in range(2 + rank)]
    out["multi_node"] = list(create_multi_node_iterator(mine, comm,
                                                        rank_master=1))
    out["synchronized"] = list(create_synchronized_iterator(mine, comm))
    return out


def int8_payload(rank: int):
    """Rank ``r``'s int8 values for the raw int8 sum check (|sum| <= 127
    at 4 ranks)."""
    return np.arange(-15, 16, dtype=np.int64) * (rank + 1) // 4


def _comm_suite(rank, size):
    q = torch.from_numpy(int8_payload(rank).astype(np.int8))
    dist.all_reduce(q)
    out = {"int8_sum": q.tolist(),
           "quant": _quant_cases(rank, size),
           "overlap": _overlap_cases(rank, size)}
    if size == 4:
        out["full"] = _full_precision_means(rank, size)
        out["objects"] = _object_plane(rank, size)
        out["eval_iter"] = _evaluator_and_iterators(rank, size)
    return out


# -- checkpointer ----------------------------------------------------------

def _checkpoint(rank, size, path):
    """Consistency across ranks: a generation corrupt on one rank is
    skipped by all; ZeRO-3 shards save per rank and resume the same
    trajectory."""
    import warnings

    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.extensions.checkpoint import _MAGIC

    comm = _comm("naive")
    cp = create_multi_node_checkpointer("job", comm, path=path)
    state = {"w": torch.arange(4.0) + rank}
    cp.save(state, 1)
    cp.save({"w": state["w"] + 1}, 2)
    comm.barrier()
    if rank == 1:
        snap = cp._snap(2, 1)
        data = bytearray(open(snap, "rb").read())
        data[len(_MAGIC) + 40] ^= 0xFF
        open(snap, "wb").write(bytes(data))
    comm.barrier()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got, it = cp.maybe_load(state)
    out = {"it": it, "w": got["w"].tolist(), "warned": len(caught) > 0}

    x, y, w = linear_problem()
    wp = torch.nn.Parameter(torch.from_numpy(w.copy()))
    bp = torch.nn.Parameter(torch.zeros(1))
    mno = create_multi_node_optimizer(torch.optim.Adam([wp, bp], lr=1e-2),
                                      comm, zero_stage=3)
    mno.init()
    step = mno.make_train_step(lambda b: ((b[0] @ wp + bp - b[1]) ** 2)
                               .mean())
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    step(batch)
    z3 = create_multi_node_checkpointer("z3", comm, path=path)
    z3.save({"opt": mno.state_dict()}, 1)
    l_next = float(step(batch))
    loaded, _ = z3.maybe_load({"opt": mno.state_dict()})
    mno.load_state_dict(loaded["opt"])
    out["z3_shard_numel"] = mno._shard.numel()
    out["z3_resumed_loss_equal"] = float(step(batch)) == l_next
    return out


# -- make_train_step_with_state ------------------------------------------

# Each variant runs STATE_STEPS fp32 steps of a small Bottleneck ResNet on
# one global batch, SGD (or LARS) with momentum 0.9 under a 2-update
# linear warm-up to lr 0.1.
STATE_VARIANTS = {
    "stage0": {}, "overlap_off": {"overlap": False},
    "double_buffering": {"double_buffering": True},
    "zero1": {"stage": 1}, "zero3": {"stage": 3},
    "lars_zero1": {"stage": 1, "optimizer": "lars"},
    "lars_zero3": {"stage": 3, "optimizer": "lars"},
}
STATE_NET = dict(stage_sizes=[1, 1], num_filters=4, num_classes=10)
STATE_STEPS, STATE_BATCH, STATE_SIZE = 4, 16, 16
STATE_LR, STATE_WARMUP = 0.1, 2


def state_model(device="cpu", seed=0):
    from chainermn_tpu_torch.models.resnet import BottleneckBlock, ResNet

    return ResNet(block_cls=BottleneckBlock, dtype=torch.float32,
                  device=device, seed=seed, **STATE_NET)


def state_batch():
    rng = np.random.RandomState(0)
    x = rng.randn(STATE_BATCH, STATE_SIZE, STATE_SIZE, 3).astype(np.float32)
    return x, rng.randint(0, 10, STATE_BATCH).astype(np.int32)


def state_run(variant, comm):
    """The variant's steps from ``state_model()``'s weights: the losses and
    the final ``state_dict`` (parameters and BatchNorm buffers) as lists."""
    import torch.nn.functional as F

    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.convert import flax_flat_layout
    from chainermn_tpu_torch.optim import LARS, linear_schedule

    cfg = {"stage": 0, "overlap": None, "double_buffering": False,
           "optimizer": "sgd", **STATE_VARIANTS[variant]}
    model = state_model(comm.device)
    # The reference's leaf order, so that each rank's ZeRO shard holds the
    # reference shard's elements; LARS's per-shard trust ratio also needs
    # them in flax's layouts.  SGD's update is elementwise, so the other
    # variants keep the module's layouts: on the card cuDNN takes other
    # weight-gradient kernels for a permuted (HWIO) view, which would move
    # ZeRO-3 further from stage 0 than the NCCL test's bound.
    params, layout = flax_flat_layout(model)
    lars = cfg["optimizer"] == "lars"
    inner = (LARS(params, momentum=0.9, weight_decay=1e-4) if lars
             else torch.optim.SGD(params, lr=0.0, momentum=0.9))
    mno = create_multi_node_optimizer(
        inner, comm, double_buffering=cfg["double_buffering"],
        zero_stage=cfg["stage"],
        lr_schedule=linear_schedule(0.0, STATE_LR, STATE_WARMUP),
        flat_layout=layout if lars else None)
    mno.init()
    step = mno.make_train_step_with_state(
        lambda b: F.cross_entropy(model(b[0]), b[1].long()), model,
        overlap=cfg["overlap"])
    batch = tuple(torch.from_numpy(a).to(comm.device) for a in state_batch())
    losses = [float(step(batch)) for _ in range(STATE_STEPS)]
    mno.materialize()
    return {"losses": losses, "updates": mno.update_count,
            "state": {k: v.detach().cpu().numpy().ravel().tolist()
                      for k, v in model.state_dict().items()}}


def state_local_mean_err(comm):
    """After one with-state step, the largest distance between a rank's
    BatchNorm buffers and the mean over the ranks of the buffers each
    rank's own train-mode forward on its slice would have left."""
    import torch.nn.functional as F

    from chainermn_tpu_torch import create_multi_node_optimizer

    x, y = (torch.from_numpy(a).to(comm.device) for a in state_batch())
    per = STATE_BATCH // comm.size
    local = state_model(comm.device)
    with torch.no_grad():
        local(x[comm.rank * per:(comm.rank + 1) * per], train=True)
    flat = torch.cat([b.reshape(-1) for b in local.buffers()])
    want = comm.allgather(flat[None]).mean(0)
    model = state_model(comm.device)
    mno = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), comm)
    mno.init()
    mno.make_train_step_with_state(
        lambda b: F.cross_entropy(model(b[0]), b[1].long()), model)((x, y))
    got = torch.cat([b.reshape(-1) for b in model.buffers()])
    return float((got - want).abs().max())


def _state(rank, size, variants):
    torch.set_num_threads(1)        # one core a rank: no oversubscription
    comm = _comm("xla_ici")
    return {v: state_run(v, comm) for v in variants}


MNIST_SMALL = ["--device", "cpu", "--communicator", "naive", "--unit", "32",
               "--batchsize", "64", "--train-size", "256", "--val-size", "64",
               "--epochs", "3"]


def _mnist(rank, size, path):
    """The example's ``main`` on every rank: stage 0, ZeRO-3, overlap
    off, and a run stopped after one epoch and resumed."""
    import contextlib
    import io

    from chainermn_tpu_torch.examples.train_mnist import main

    def run(*extra):
        with contextlib.redirect_stdout(io.StringIO()) as out:
            res = main(MNIST_SMALL + list(extra))
        return {"digest": res["params_digest"], "gstep": res["gstep"],
                "accuracy": res["metrics"]["val/accuracy"],
                "losses": res["epoch_mean_losses"],
                "resumed_from": res["resumed_from"],
                "printed": out.getvalue()}

    out = {"zero0": run(), "zero3": run("--zero-stage", "3"),
           "int8": run("--comm-dtype", "int8")}
    os.environ["CHAINERMN_TPU_OVERLAP"] = "0"
    out["overlap_off"] = run()
    del os.environ["CHAINERMN_TPU_OVERLAP"]
    ck = ["--checkpoint-dir", path, "--checkpoint-every", "3"]
    out["stopped"] = run(*ck, "--epochs", "1")
    # A relaunch starts after every rank of the stopped job has exited, so
    # every rank's asynchronous save has landed; the barrier stands in.
    dist.barrier()
    out["resumed"] = run(*ck)
    return out


NCCL_QUANT_NAMES = ("xla_ici", "hierarchical", "two_dimensional")
NCCL_STATE_VARIANTS = ("stage0", "zero3", "double_buffering")
NCCL_ZERO_VARIANTS = ("plain", "n_accum2", "double_buffering")


def _nccl(rank, size, path):
    """The data-parallel surface over NCCL, one GPU a rank: quantized and
    full-precision means, overlap on against off, ZeRO 1-3 against stage
    0, the object plane (on its gloo side group) and ``split``, and the
    MNIST example at its defaults."""
    import contextlib
    import io

    from chainermn_tpu_torch.examples.train_mnist import main

    dev = torch.device("cuda", rank)
    out = {"backend": dist.get_backend(),
           "quant": _quant_cases(rank, size, dev, NCCL_QUANT_NAMES),
           "overlap": _overlap_cases(rank, size, dev), "full": {}}
    grads_all = [rank_grads(r) for r in range(size)]
    for name in NCCL_QUANT_NAMES:
        for bb in (None, 0):
            grads = [torch.from_numpy(g).to(dev) for g in rank_grads(rank)]
            _comm(name, dev, bucket_bytes=bb).allreduce_grad(grads)
            out["full"][f"{name}/{bb}"] = max(
                float(np.abs(g.cpu().numpy()
                             - np.mean([ga[i] for ga in grads_all], 0)).max())
                for i, g in enumerate(grads))
    comm = _comm("pure_nccl", dev)
    out["zero"] = {f"{s}/{o}/{v}": zero_run(s, o, v, comm)
                   for s in (0,) + ZERO_STAGES for o in ZERO_OPTS
                   for v in NCCL_ZERO_VARIANTS}
    out["objects"] = {
        "bcast_obj": comm.bcast_obj({"root": rank}, root=size - 1)["root"],
        "gather_root": comm.gather_obj(rank * 10, root=1),
        "allreduce_obj": comm.allreduce_obj(rank + 1),
        "scatter_obj": comm.scatter_obj(
            list(range(100, 100 + size)) if rank == 0 else None),
    }
    comm.barrier(timeout_s=60)
    sub = comm.split(rank % 2, key=-rank)
    grads = [torch.from_numpy(g).to(dev) for g in rank_grads(rank)]
    sub.allreduce_grad(grads)
    members = [r for r in range(size) if r % 2 == rank % 2]
    want = [np.mean([rank_grads(m)[i] for m in members], axis=0)
            for i in range(len(grads))]
    out["objects"]["sub"] = [sub.rank, sub.size, sub.allgather_obj(rank)]
    out["objects"]["sub_grad_err"] = max(
        float(np.abs(g.cpu().numpy() - w).max()) for g, w in zip(grads, want))

    def example(*extra):
        with contextlib.redirect_stdout(io.StringIO()):
            res = main(["--communicator", "pure_nccl"] + list(extra))
        return {"digest": res["params_digest"], "gstep": res["gstep"],
                "accuracy": res["metrics"]["val/accuracy"],
                "losses": res["epoch_mean_losses"], "wire": res["wire"],
                "resumed_from": res["resumed_from"]}

    runs = {"zero0": example(), "zero3": example("--zero-stage", "3"),
            "int8": example("--comm-dtype", "int8"),
            "fp8": example("--comm-dtype", "fp8")}
    os.environ["CHAINERMN_TPU_OVERLAP"] = "0"
    runs["overlap_off"] = example()
    del os.environ["CHAINERMN_TPU_OVERLAP"]
    ck = ["--checkpoint-dir", path, "--checkpoint-every", "10"]
    runs["stopped"] = example(*ck, "--epochs", "3")
    dist.barrier()           # the relaunch starts after every save landed
    runs["resumed"] = example(*ck)
    out["mnist"] = runs
    out["state"] = {v: state_run(v, comm) for v in NCCL_STATE_VARIANTS}
    out["state_local_mean_err"] = state_local_mean_err(comm)
    return out


def run(kind: str, rank: int, size: int, init_file: str, out_dir: str,
        args: dict):
    if kind == "nccl":
        # One GPU a rank, as a launcher would set it up.
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if kind == "nccl" else "gloo",
                            init_method=f"file://{init_file}",
                            rank=rank, world_size=size)
    try:
        if kind == "zero":
            res = _zero(rank, size)
        elif kind == "comm":
            res = _comm_suite(rank, size)
        elif kind == "ckpt":
            res = _checkpoint(rank, size, args["path"])
        elif kind == "mnist":
            res = _mnist(rank, size, args["path"])
        elif kind == "nccl":
            res = _nccl(rank, size, args["path"])
        elif kind == "state":
            res = _state(rank, size, args["variants"])
        else:
            raise ValueError(kind)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _hook_main(rank: int, size: int, init_file: str):
    from chainermn_tpu_torch.global_except_hook import add_hook

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=size)
    comm = _comm("naive")
    add_hook()
    comm.barrier()
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    comm.barrier(timeout_s=20)      # never passes: rank 1 is gone
    print("rank 0 passed a barrier rank 1 never reached", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "hook":
        _hook_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
