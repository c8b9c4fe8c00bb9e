"""Worker processes for the multi-rank gloo tests of ``chainermn_tpu_torch``
(communicators, the multi-node optimizer, the model-parallel functions
and ``MultiNodeChainList``).

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


def _broadcast_params(rank, size):
    """Rank-divergent parameters, then ``broadcast_params``: every rank
    ends with rank 0's values, through the argument and by default."""
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)

    comm = create_communicator("naive", device="cpu")
    w = torch.nn.Parameter(torch.full((3, 2), float(rank + 1)))
    b = torch.nn.Parameter(torch.arange(4.0) * (rank + 1))
    opt = create_multi_node_optimizer(torch.optim.SGD([w, b], lr=0.1), comm)
    before = [w.detach().numpy().ravel().tolist(),
              b.detach().numpy().ravel().tolist()]
    extra = {"v": torch.full((2,), 10.0 * (rank + 1))}
    opt.broadcast_params(extra)
    with torch.no_grad():
        w.add_(rank)                    # diverge again, then the default
    opt.broadcast_params()
    return {"before": before, "w": w.detach().numpy().ravel().tolist(),
            "b": b.detach().numpy().ravel().tolist(),
            "extra": extra["v"].numpy().tolist()}


# -- the model-parallel functions ------------------------------------------

# Per-rank inputs of the collective cases: (4, 3), divisible by 2 and 4.
COLL_SHAPE = (4, 3)


def coll_cases(size):
    """Each differentiable collective with its arguments and output
    shape, at ``size`` ranks."""
    n, (a, b) = size, COLL_SHAPE
    return {
        "allgather": ({}, (n, a, b)),
        "allgather_tiled": ({"tiled": True}, (n * a, b)),
        "allgather_axis1": ({"axis": 1}, (a, n, b)),
        "alltoall": ({"split_axis": 0, "concat_axis": 1}, (a // n, b * n)),
        "bcast": ({"root": n - 1}, (a, b)),
        "gather": ({"root": 0}, (n, a, b)),
        "gather_axis1": ({"root": n - 1, "axis": 1}, (a, n, b)),
        "scatter": ({"root": 0}, (a // n, b)),
        "allreduce": ({}, (a, b)),
    }


def coll_inputs(size, name):
    """Every rank's input and loss weights for one collective case."""
    rng = np.random.RandomState(len(name) + 7 * size)
    shape = coll_cases(size)[name][1]
    xs = rng.randn(size, *COLL_SHAPE).astype(np.float32)
    ws = rng.randn(size, *shape).astype(np.float32)
    return xs, ws


def _functions(rank, size, device="cpu"):
    """Forward values and the gradients each rank's input gets, for the
    total objective (the sum over the ranks of each rank's loss)."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch import functions as F
    from chainermn_tpu_torch.functions import DelegateVariable, pseudo_connect

    comm = create_communicator("naive", device=device)
    dev = comm.device
    n, last = size, size - 1
    out = {}

    # send_recv: the destination gets the source's value, the rest zeros;
    # the loss lives on the destination (the others take 0 x the output).
    x = torch.tensor([10.0 + rank], requires_grad=True, device=dev)
    got = F.send_recv(x, comm, src=0, dst=last)
    (got * got * (3.0 if rank == last else 0.0)).sum().backward()
    out["send_recv"] = {"value": got.item(), "grad": x.grad.item()}

    # send/recv: the gradient of a loss on the receiver lands on the sender.
    x = torch.tensor([1.0 + rank], requires_grad=True, device=dev)
    if rank == 0:
        d = F.send(x * 3.0, comm, last, src=0)
        assert isinstance(d, DelegateVariable) and d.token.numel() == 0
        pseudo_connect(d, torch.zeros((), device=dev)).backward()
        out["sender_grad"] = x.grad.item()
    elif rank == last:
        r = F.recv(comm, 0)
        out["received"] = r.item()
        (r ** 2).sum().backward()

    # pseudo_connect: the send's value has no local consumer on rank 0.
    v = torch.tensor(5.0, requires_grad=True, device=dev)
    if rank == 0:
        d = F.send(v * 2.0, comm, 1)
        grafted = pseudo_connect(d, v * 0.0)
        grafted.backward()
        out["grafted_grad"] = v.grad.item()
    elif rank == 1:
        (F.recv(comm, 0) ** 2).backward()

    # Delegate merging, and a tuple payload with an integer leaf.
    a = torch.tensor([1.0, 2.0], requires_grad=True, device=dev)
    b = torch.tensor([3.0], requires_grad=True, device=dev)
    if rank == 0:
        d1 = F.send((a * 2.0, torch.tensor([7, 8], device=dev)), comm, 1)
        d2 = F.send(b * b, comm, 1)
        merged = d1 + d2
        out["merged_is_delegate"] = isinstance(merged, DelegateVariable)
        pseudo_connect(merged, torch.zeros((), device=dev)).backward()
        out["merged_grads"] = [a.grad.tolist(), b.grad.tolist()]
    elif rank == 1:
        (fa, ints), fb = F.recv(comm, 0), F.recv(comm, 0)
        out["tuple_payload"] = [fa.tolist(), ints.tolist(), str(ints.dtype),
                                ints.requires_grad, fb.tolist()]
        (fa.sum() * 5.0 + fb.sum() * 7.0).backward()

    # A send to this rank itself is a pass-through with the gradient path.
    s = torch.tensor([2.0], requires_grad=True, device=dev)
    d = F.send(s * 4.0, comm, rank)
    (F.recv(comm, rank, delegate_variable=d) ** 2).sum().backward()
    out["self_grad"] = s.grad.item()

    # ring_exchange forward and gradient.
    shift = 2 if n > 2 else 1
    r = torch.tensor([float(rank)], requires_grad=True, device=dev)
    got = F.ring_exchange(r, comm, shift=shift)
    (got * (rank + 1.0)).sum().backward()
    out["ring"] = {"value": got.item(), "grad": r.grad.item()}

    # The collectives.
    out["coll"] = {}
    for name, (kw, _) in coll_cases(n).items():
        xs, ws = coll_inputs(n, name)
        x = torch.from_numpy(xs[rank]).to(dev).requires_grad_(True)
        fn = getattr(F, name.split("_")[0])
        y = fn(comm, x, **kw)
        (y * torch.from_numpy(ws[rank]).to(dev)).sum().backward()
        out["coll"][name] = {"y": y.detach().cpu().numpy().tolist(),
                             "grad": x.grad.cpu().numpy().tolist()}
    return out


# -- MultiNodeChainList ------------------------------------------------------

def chain_params(seed, d_in, d_out):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(d_in, d_out) * 0.3).astype(np.float32),
            "b": (rng.randn(d_out) * 0.1).astype(np.float32)}


def chain_input(seed, rows, d):
    return np.random.RandomState(seed).randn(rows, d).astype(np.float32)


def _dense(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _merge(p, xs):
    return xs[0] + xs[1]


# name -> (components (fn, rank, rank_in, rank_out), parameter shapes),
# ranks as functions of the world size.
def chain_specs(n):
    return {
        "two_stage": (((_dense, 0, None, n - 1), (_dense, n - 1, 0, None)),
                      [(4, 8), (8, 2)]),
        # These two name rank 2, so they raise below 3 ranks.
        "three_stage": (((_dense, 0, None, 1), (_dense, 1, 0, 2),
                         (_dense, 2, 1, None)), [(4, 8), (8, 8), (8, 3)]),
        "branching": (((_dense, 0, None, 2), (_dense, 1, None, 2),
                       (_merge, 2, (0, 1), None)), [(4, 6), (4, 6), None]),
    }


def _tensors(p, grad=True, device="cpu"):
    if p is None:
        return ()
    return {k: torch.from_numpy(v.copy()).to(device).requires_grad_(grad)
            for k, v in p.items()}


def _build_chain(comm, comps):
    from chainermn_tpu_torch.links import MultiNodeChainList

    chain = MultiNodeChainList(comm)
    for fn, owner, rin, rout in comps:
        chain.add_link(fn, rank=owner, rank_in=rin, rank_out=rout)
    return chain


def _chains(rank, size, device="cpu"):
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.links import MultiNodeChainList

    comm = create_communicator("naive", device=device)
    dev = comm.device
    out = {}
    for name, (comps, shapes) in chain_specs(size).items():
        chain = _build_chain(comm, comps)
        params = [_tensors(None if s is None else chain_params(i, *s),
                           device=dev)
                  for i, s in enumerate(shapes)]
        x = torch.from_numpy(chain_input(9, 5, 4)).to(dev)
        try:
            y = chain.apply(params, x)
        except ValueError as e:
            out[name] = {"error": str(e)}
            continue
        (y ** 2).sum().backward()
        out[name] = {"y": y.detach().cpu().numpy().tolist(), "grads": [
            {k: None if v.grad is None else v.grad.cpu().numpy().tolist()
             for k, v in p.items()} if p != () else {} for p in params]}

    # The sharded tier: the same forward, a row of this rank's own
    # component only, and materialize's round trip.
    comps, shapes = chain_specs(size)["two_stage"]
    chain = _build_chain(comm, comps)
    np_params = [chain_params(10 + i, *s) for i, s in enumerate([(4, 16),
                                                                  (16, 2)])]
    x = torch.from_numpy(chain_input(2, 5, 4)).to(dev)
    params = [_tensors(p, grad=False, device=dev) for p in np_params]
    row = chain.shard_params(params)
    with torch.no_grad():
        rep = chain.apply(params, x)
        shd = chain.apply_sharded(row, x)
    back = chain.materialize_params(row)
    out["sharded"] = {
        "row_numel": row.numel(), "equal": bool(torch.equal(rep, shd)),
        "y": shd.cpu().numpy().tolist(),
        "roundtrip": all(torch.equal(back[i][k], params[i][k])
                         for i in range(2) for k in params[i])}

    # Sharded training (Adam, 4 steps, every rank the same batch) against
    # the replicated tier with the gradients summed over the ranks.
    y_np = chain_input(3, 6, 2)
    batch = (torch.from_numpy(chain_input(2, 6, 4)).to(dev),
             torch.from_numpy(y_np).to(dev))
    comps = ((lambda p, b: _dense(p, b[0]), 0, None, size - 1),
             (_dense, size - 1, 0, None))

    def loss_fn(o, b):
        return ((o - b[1]) ** 2).mean()

    def adam(ps):
        return torch.optim.Adam(ps, lr=1e-2)

    chain = _build_chain(comm, comps)
    row = chain.shard_params([_tensors(p, False, dev) for p in np_params])
    opt_state = chain.init_sharded_opt_state(adam, row)
    step = chain.make_sharded_train_step(adam, loss_fn)
    sharded_losses = []
    for _ in range(4):
        row, opt_state, loss = step(row, opt_state, batch)
        sharded_losses.append(loss.item())
    sharded = [{k: v.cpu().numpy().tolist() for k, v in p.items()}
               for p in chain.materialize_params(row)]
    rep_params = [_tensors(p, device=dev) for p in np_params]
    flat = [v for p in rep_params for v in p.values()]
    opt = adam(flat)
    rep_losses = []
    for _ in range(4):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(chain.apply(rep_params, batch), batch)
        loss.backward()
        for v in flat:
            v.grad = comm.allreduce(torch.zeros_like(v) if v.grad is None
                                    else v.grad, "sum")
        opt.step()
        rep_losses.append(loss.item())
    out["train"] = {"sharded_losses": sharded_losses,
                    "replicated_losses": rep_losses, "sharded": sharded,
                    "replicated": [{k: v.detach().cpu().numpy().tolist()
                                    for k, v in p.items()}
                                   for p in rep_params]}

    # Chains that cannot run raise before any transfer, on every rank.
    errors = {}
    bad = {"miswired": [(_dense, 1, 0, None)],
           "no_output": [(_dense, 0, None, 1)],
           "never_received": [(_dense, 0, None, 1), (_dense, 0, None,
                                                     None)]}
    p1 = _tensors(chain_params(0, 4, 4), device=dev)
    for key, comps in bad.items():
        try:
            _build_chain(comm, comps).apply([p1] * len(comps),
                                            torch.zeros(2, 4, device=dev))
        except ValueError as e:
            errors[key] = str(e)
    try:
        MultiNodeChainList(comm).add_link(_dense, rank=0).apply(
            [], torch.zeros(2, 4, device=dev))
    except ValueError as e:
        errors["length"] = str(e)
    out["errors"] = errors
    comm.barrier()
    return out


# -- the WMT example's pipeline --------------------------------------------

# The reference smoke's widths (tests/test_examples.py), a larger learning
# rate so that the warm-up's first updates move the weights.
WMT_FLAGS = ["--device", "cpu", "--communicator", "two_dimensional",
             "--epochs", "1", "--batchsize", "8", "--d-model", "32",
             "--n-heads", "2", "--d-ff", "64", "--layers", "1",
             "--vocab", "64", "--seq-len", "8", "--lr", "0.05"]
WMT_TRAIN, WMT_STEPS = 64, 4


def wmt_batches(batchsize=8, seq_len=8, vocab=64):
    """The reference example's first global batches: its one process's
    scattered set (a seed-0 permutation), epoch 0."""
    from chainermn_tpu_torch.datasets.scatter_dataset import SubDataset
    from chainermn_tpu_torch.datasets.toy import (SyntheticSeqDataset,
                                                  batch_iterator)

    full = SyntheticSeqDataset(n=WMT_TRAIN, src_len=seq_len,
                               tgt_len=seq_len, vocab=vocab)
    train = SubDataset(full, np.random.RandomState(0).permutation(WMT_TRAIN))
    return list(batch_iterator(train, batchsize, seed=0))[:WMT_STEPS]


def wmt_pipeline(state_dict, dtype_name):
    """The example's model, loss, schedule and multi-node optimizer (the
    two-dimensional communicator on a bf16 wire), from ``state_dict``, on
    the global batches: the losses and the final parameters."""
    from chainermn_tpu_torch.examples import train_transformer as ex
    from chainermn_tpu_torch.models.transformer import Transformer

    args = ex.parser().parse_args(WMT_FLAGS)
    comm = ex.make_communicator(args)
    model = Transformer(vocab=args.vocab, d_model=args.d_model,
                        n_heads=args.n_heads, d_ff=args.d_ff,
                        n_enc_layers=args.layers, n_dec_layers=args.layers,
                        max_len=args.seq_len, dtype=getattr(torch,
                                                            dtype_name),
                        device="cpu")
    model.load_state_dict(state_dict)
    opt = ex.make_optimizer(model, comm, args, WMT_TRAIN)
    step = opt.make_train_step(ex.make_loss_fn(model))
    losses = [float(step((torch.from_numpy(s).long(),
                          torch.from_numpy(t).long())))
              for s, t in wmt_batches()]
    return {"losses": losses, "updates": opt.update_count,
            "lr": opt.actual_optimizer.param_groups[0]["lr"],
            "params": {k: v.detach().numpy().ravel().tolist()
                       for k, v in model.state_dict().items()}}


def _wmt(rank, size, args):
    """The pipeline in each dtype, from that dtype's weights."""
    out = {}
    for dtype, path in args["weights"].items():
        sd = {k: torch.from_numpy(v) for k, v in np.load(path).items()}
        out[dtype] = wmt_pipeline(sd, dtype)
    return out


# -- the seq2seq example ----------------------------------------------------

# The reference smoke's flags (tests/test_examples.py).
S2S_FLAGS = ["--device", "cpu", "--communicator", "naive", "--epochs", "1",
             "--batchsize", "8", "--unit", "32", "--vocab", "64",
             "--seq-len", "8", "--train-size", "32"]
S2S_STEPS = 4


def s2s_batches():
    """The reference example's global batches of epoch 0 (its one
    process's seed-0 permutation of the set)."""
    from chainermn_tpu_torch.datasets.scatter_dataset import SubDataset
    from chainermn_tpu_torch.datasets.toy import (SyntheticSeqDataset,
                                                  batch_iterator)

    full = SyntheticSeqDataset(n=32, src_len=8, tgt_len=8, vocab=64)
    train = SubDataset(full, np.random.RandomState(0).permutation(32))
    return list(batch_iterator(train, 8, seed=0))[:S2S_STEPS]


def s2s_pipeline(enc_sd, dec_sd):
    """The example's chain and both tiers' steps from the given weights on
    the global batches: each tier's losses and final parameters."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.examples import seq2seq as ex
    from chainermn_tpu_torch.models.seq2seq import Decoder, Encoder

    comm = create_communicator("naive", device="cpu")
    out = {}
    for tier in ("replicated", "sharded"):
        encoder = Encoder(64, 32, device="cpu")
        decoder = Decoder(64, 32, device="cpu")
        encoder.load_state_dict(enc_sd)
        decoder.load_state_dict(dec_sd)
        params = (dict(encoder.named_parameters()),
                  dict(decoder.named_parameters()))
        chain = ex.build_chain(comm, encoder, decoder)
        losses = []
        if tier == "replicated":
            step = ex.make_replicated_step(chain, params, comm, 3e-3)
        else:
            def adam(ps):
                return torch.optim.Adam(ps, lr=3e-3)

            row = chain.shard_params(params)
            state = chain.init_sharded_opt_state(adam, row)
            sharded_step = chain.make_sharded_train_step(adam, ex.ce_loss)
        for src, tgt in s2s_batches():
            batch = (torch.from_numpy(src).long(), torch.from_numpy(tgt).long())
            if tier == "replicated":
                loss = step(batch)
            else:
                row, state, loss = sharded_step(row, state, batch)
            losses.append(float(loss))
        if tier == "sharded":
            params = chain.materialize_params(row)
        out[tier] = {"losses": losses, "params": [
            {k: v.detach().numpy().ravel().tolist() for k, v in p.items()}
            for p in params]}
    return out


def _s2s_main(extra=()):
    import contextlib
    import io

    from chainermn_tpu_torch.examples import seq2seq as ex

    with contextlib.redirect_stdout(io.StringIO()) as printed:
        res = ex.run(ex.parser().parse_args(S2S_FLAGS + list(extra)))
    return {"accuracy": res["accuracy"], "bleu": res["bleu"],
            "losses": res["losses"], "printed": printed.getvalue()}


def _seq2seq(rank, size, args):
    sds = [{k: torch.from_numpy(v) for k, v in np.load(p).items()}
           for p in args["weights"]]
    out = s2s_pipeline(*sds)
    out["main"] = {"replicated": _s2s_main(),
                   "sharded": _s2s_main(["--sharded-params"])}
    return out


# -- model parallelism over NCCL, one GPU a rank -----------------------------

# The seq2seq example at full width: Chainer's seq2seq width, its 2
# layers, a 32k vocabulary and 50-token sentences, 10 steps.
S2S_WIDE = ["--communicator", "pure_nccl", "--device", "cuda", "--unit",
            "1024", "--vocab", "32768", "--seq-len", "50", "--batchsize",
            "64", "--train-size", "640", "--epochs", "1"]
WMT_CARD_STEPS = 8


def wmt_card_pipeline():
    """The WMT example at its default widths over NCCL: its model, loss,
    schedule and optimizer on the reference's first global batches."""
    from chainermn_tpu_torch.datasets.scatter_dataset import SubDataset
    from chainermn_tpu_torch.datasets.toy import (SyntheticSeqDataset,
                                                  batch_iterator)
    from chainermn_tpu_torch.examples import train_transformer as ex

    args = ex.parser().parse_args(["--device", "cuda"])
    comm = ex.make_communicator(args)
    model = ex.make_model(args, comm.device)
    opt = ex.make_optimizer(model, comm, args, args.train_size)
    step = opt.make_train_step(ex.make_loss_fn(model))
    full = SyntheticSeqDataset(n=args.train_size, src_len=args.seq_len,
                               tgt_len=args.seq_len, vocab=args.vocab)
    train = SubDataset(full, np.random.RandomState(0).permutation(len(full)))
    losses = []
    for i, (src, tgt) in enumerate(batch_iterator(train, args.batchsize,
                                                  seed=0)):
        if i == WMT_CARD_STEPS:
            break
        losses.append(step((torch.from_numpy(src).long().to(comm.device),
                            torch.from_numpy(tgt).long().to(comm.device))))
    return [float(x) for x in losses]


def _s2s_wide():
    import contextlib
    import io

    from chainermn_tpu_torch.examples import seq2seq as ex

    out = {}
    for tier, extra in (("replicated", []), ("sharded", ["--sharded-params"])):
        with contextlib.redirect_stdout(io.StringIO()):
            res = ex.run(ex.parser().parse_args(S2S_WIDE + extra))
        out[tier] = {"losses": res["losses"], "accuracy": res["accuracy"],
                     "bleu": res["bleu"]}
    return out


def _split_of_split(rank, size, device):
    """Split the world by parity (keys reverse the order), then split each
    half again over the same members with the order reversed back, and
    into one-rank communicators."""
    from chainermn_tpu_torch import create_communicator

    comm = create_communicator("pure_nccl", device=device)
    sub = comm.split(rank % 2, key=-rank)
    subsub = sub.split(0, key=-sub.rank)
    solo = sub.split(sub.rank)
    grads = [torch.from_numpy(g).to(device) for g in rank_grads(rank)]
    subsub.allreduce_grad(grads)
    members = [r for r in range(size) if r % 2 == rank % 2]
    want = [np.mean([rank_grads(m)[i] for m in members], axis=0)
            for i in range(len(grads))]
    return {"sub": [sub.rank, sub.size, sub.allgather_obj(rank)],
            "subsub": [subsub.rank, subsub.size, subsub.allgather_obj(rank)],
            "solo": [solo.rank, solo.size],
            "backend": dist.get_backend(subsub.group),
            "grad_err": max(float(np.abs(g.cpu().numpy() - w).max())
                            for g, w in zip(grads, want))}


def _mp_nccl(rank, size):
    import contextlib
    import io

    from chainermn_tpu_torch.examples import train_transformer as ex

    dev = torch.device("cuda", rank)
    out = {"backend": dist.get_backend(), "wmt": wmt_card_pipeline(),
           "seq2seq": _s2s_wide()}
    if size > 1:
        out["functions"] = _functions(rank, size, dev)
        out["chains"] = _chains(rank, size, dev)
        out["split"] = _split_of_split(rank, size, dev)
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            out["wmt_main"] = ex.main(["--device", "cuda", "--epochs", "1",
                                       "--steps", "5"])
        out["wmt_main_printed"] = printed.getvalue()
    return out


def run(kind: str, rank: int, size: int, init_file: str, out_dir: str,
        args: dict):
    torch.set_num_threads(1)        # one core a rank: no oversubscription
    backend = "gloo"
    if kind == "mp_nccl":
        # One GPU a rank, as a launcher would set it up.
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)
        backend = "nccl"
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=size)
    try:
        if kind == "allreduce":
            res = _allreduce(args["comm"], args.get("bucket_bytes"),
                             args.get("dtype"), rank, size)
        elif kind == "sgd":
            res = _sgd_step(args["comm"], rank, size)
        elif kind == "broadcast_params":
            res = _broadcast_params(rank, size)
        elif kind == "functions":
            res = _functions(rank, size)
        elif kind == "chains":
            res = _chains(rank, size)
        elif kind == "wmt":
            res = _wmt(rank, size, args)
        elif kind == "seq2seq":
            res = _seq2seq(rank, size, args)
        elif kind == "mp_nccl":
            res = _mp_nccl(rank, size)
        else:
            raise ValueError(kind)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn(kind: str, size: int, tmp_path, timeout_s: float = 60, **args):
    """Run ``kind`` on ``size`` spawned gloo ranks, each joined under
    ``timeout_s``; returns every rank's JSON result."""
    import json as _json
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(kind, r, size,
                                           str(tmp_path / "rendezvous"),
                                           str(tmp_path), args))
             for r in range(size)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout_s)
            assert p.exitcode is not None, f"rank timed out after {timeout_s}s"
            assert p.exitcode == 0, f"rank exited {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [_json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(size)]
