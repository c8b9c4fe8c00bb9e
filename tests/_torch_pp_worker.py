"""Worker processes for the multi-rank gloo tests of the port's pipeline
tier: the seven schedules of ``parallel/pipeline.py``, the ViT example
and the parallel-convolution example.

Imports only torch, numpy and the port, so a spawned child never loads
JAX.  Each worker joins a ``file://`` rendezvous, runs one kind of check,
and writes its result as JSON to ``<out_dir>/rank<r>.json``.  The inputs
are numpy draws from fixed seeds, shared with the tests, which feed the
same arrays to the reference.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

D = 8           # the schedules' activation width
BATCH = 8


# -- the schedules ------------------------------------------------------------

def pp_inputs(n: int, v: int = 1):
    """Seeded numpy inputs of the schedule cases at ``n`` stages of ``v``
    chunks: global stage ``s``'s ``w`` (D, D) and ``b`` (D,), the batch,
    the target, and an embedding and a head matrix."""
    rng = np.random.RandomState(100 * n + v)
    L = n * v
    return {
        "w": (rng.randn(L, D, D) * 0.5).astype(np.float32),
        "b": (rng.randn(L, D) * 0.1).astype(np.float32),
        "x": rng.randn(BATCH, D).astype(np.float32),
        "tgt": rng.randn(BATCH, D).astype(np.float32),
        "embed_w": (rng.randn(D, D) * 0.5).astype(np.float32),
        "head_w": (rng.randn(D, D) * 0.5).astype(np.float32),
    }


def per_device(full, n: int, v: int):
    """Global stage ``l n + d`` of ``full`` (L, ...) at ``[d][l]``: the
    interleaved assignment, (n, v, ...)."""
    return np.stack([np.stack([full[l * n + d] for l in range(v)])
                     for d in range(n)])


# Every schedule case: (kind, n_microbatches, n_chunks, with head/input).
PP_CASES = {
    **{f"gpipe_m{m}": ("gpipe", m, 1, False) for m in (1, 2, 4)},
    "gpipe_loss": ("gpipe_loss", 2, 1, False),
    **{f"1f1b_m{m}": ("1f1b", m, 1, False) for m in (2, 4, 8)},
    "1f1b_head": ("1f1b", 4, 1, True),
    **{f"interleaved_v{v}_m{m}": ("interleaved", m, v, False)
       for v, m in ((2, 4), (2, 8), (3, 4))},
    "interleaved_head": ("interleaved", 4, 2, True),
    **{f"circular_v{v}_m{m}": ("circular", m, v, False)
       for v, m in ((1, 4), (2, 4), (2, 8), (3, 4))},
    "circular_head": ("circular", 4, 2, True),
    "circular_fwd": ("circular_fwd", 8, 2, False),
}


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def mse(out, target):
    return ((out - target) ** 2).mean()


def head_loss(hw, out, target):
    return ((out @ hw - target) ** 2).mean()


def _np(t):
    return t.detach().cpu().numpy().tolist()


def pipeline_case(comm, name: str):
    """One schedule case on this rank: every output of the function, this
    rank's own (stage gradients, unreduced head gradients and input
    cotangents)."""
    from chainermn_tpu_torch.parallel import pipeline as P

    kind, M, v, composed = PP_CASES[name]
    n, d, dev = comm.size, comm.rank, comm.device
    inp = pp_inputs(n, v)
    t = {k: torch.from_numpy(a).to(dev) for k, a in inp.items()}
    if kind in ("gpipe", "gpipe_loss", "1f1b"):
        params = {"w": t["w"][d].clone().requires_grad_(),
                  "b": t["b"][d].clone().requires_grad_()}
    else:
        params = {k: torch.from_numpy(per_device(inp[k], n, v)[d]).to(dev)
                  .requires_grad_() for k in ("w", "b")}
    x, tgt = t["x"], t["tgt"]
    if kind in ("gpipe", "circular_fwd"):
        out = (P.spmd_pipeline(stage_fn, params, x, comm, M) if kind == "gpipe"
               else P.spmd_pipeline_circular(stage_fn, params, x, comm, M, v))
        return {"out": _np(out)}
    if kind == "gpipe_loss":
        xg = x.clone().requires_grad_()
        loss = P.pipeline_forward_and_loss(stage_fn, mse, params, xg, tgt,
                                           comm, M)
        gw, gb, gx = torch.autograd.grad(loss, [params["w"], params["b"], xg])
        return {"loss": float(loss.detach()), "w": _np(gw), "b": _np(gb),
                "x": _np(gx)}
    fn = {"1f1b": P.pipeline_1f1b_loss_and_grads,
          "interleaved": P.pipeline_interleaved_1f1b_loss_and_grads,
          "circular": P.pipeline_circular_1f1b_loss_and_grads}[kind]
    extra = () if kind == "1f1b" else (v,)
    if not composed:
        loss, g = fn(stage_fn, mse, params, x, tgt, comm, M, *extra)
        return {"loss": float(loss), "w": _np(g["w"]), "b": _np(g["b"])}
    ew = t["embed_w"].clone().requires_grad_()
    tokens = torch.tanh(x @ ew)
    loss, g, hg, gtok = fn(stage_fn, head_loss, params, tokens, tgt, comm, M,
                           *extra, loss_params=t["head_w"],
                           with_input_grads=True)
    # The example's composition: both sums over the pipeline, then the
    # embedding's backward from the summed input cotangent.
    (eg,) = torch.autograd.grad(tokens, [ew], comm.allreduce(gtok))
    return {"loss": float(loss), "w": _np(g["w"]), "b": _np(g["b"]),
            "head": _np(hg), "gtok": _np(gtok),
            "head_sum": _np(comm.allreduce(hg)), "embed": _np(eg)}


def pipeline_errors(comm):
    """The schedules' argument errors: a batch that does not divide into
    the microbatches, and microbatches that do not divide into rounds."""
    from chainermn_tpu_torch.parallel import pipeline as P

    n, dev = comm.size, comm.device
    params = {"w": torch.zeros(D, D, device=dev),
              "b": torch.zeros(D, device=dev)}
    chunked = {"w": torch.zeros(2, D, D, device=dev),
               "b": torch.zeros(2, D, device=dev)}
    x = torch.ones(6, D, device=dev)
    bad_m = 3 if n == 2 else 6          # not a multiple of n
    calls = {
        "gpipe": lambda: P.spmd_pipeline(stage_fn, params, x, comm, 4),
        "1f1b": lambda: P.pipeline_1f1b_loss_and_grads(
            stage_fn, mse, params, x, x, comm, 4),
        "interleaved": lambda: P.pipeline_interleaved_1f1b_loss_and_grads(
            stage_fn, mse, chunked, x, x, comm, bad_m, 2),
        "circular": lambda: P.pipeline_circular_1f1b_loss_and_grads(
            stage_fn, mse, chunked, x, x, comm, bad_m, 2),
        "circular_fwd": lambda: P.spmd_pipeline_circular(
            stage_fn, chunked, x, comm, bad_m, 2),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _naive_cpu():
    from chainermn_tpu_torch import create_communicator

    return create_communicator("naive", device="cpu")


def _pipeline(rank, size, device="cpu"):
    from chainermn_tpu_torch import create_communicator

    comm = create_communicator("naive", device=device)
    assert (comm.rank, comm.size) == (rank, size)
    out = {name: pipeline_case(comm, name) for name in PP_CASES}
    out["errors"] = pipeline_errors(comm)
    return out


# -- communicator splits by axis and by device --------------------------------

def members(sub):
    """A sub-communicator's world ranks in its rank order (``None`` for
    no communicator)."""
    if sub is None:
        return None
    return sub.allgather_obj(dist.get_rank())


def _splits(rank, size, inter_size):
    """``split`` by each axis and by both, and ``split_devices`` with keys
    and an undefined color, on an ``(inter_size, size // inter_size)``
    grid: each result's members in rank order, its class and a mean over
    it."""
    from chainermn_tpu_torch import create_communicator

    comm = create_communicator("xla_ici", device="cpu", inter_size=inter_size)
    out = {}
    for name, axes in (("inter", ("inter",)), ("intra", ("intra",)),
                       ("both", ("inter", "intra")), ("str", "intra")):
        sub = comm.split(axes)
        g = [torch.full((2,), float(rank))]
        sub.allreduce_grad(g)
        out[name] = {"members": members(sub), "size": sub.device_size,
                     "cls": type(sub).__name__, "mean": float(g[0][0])}
    colors = [r % 2 for r in range(size)]
    colors[-1] = None
    keys = [-r for r in range(size)]
    subs = comm.split_devices(colors, keys)
    out["devices"] = {"colors": list(subs), "members": {
        str(c): members(s) for c, s in subs.items()},
        "cls": sorted({type(s).__name__ for s in subs.values()
                       if s is not None})}
    out["hier_inter"] = type(create_communicator(
        "hierarchical", device="cpu", inter_size=inter_size).split(
            ("inter",))).__name__
    return out


# -- the ViT example ----------------------------------------------------------

# The examples' parity runs: a tiny ViT (16 px, patch 8: a 2 x 2 grid),
# global batch 8 in 4 microbatches, 3 steps.
VIT_FLAGS = ["--epochs", "1", "--batchsize", "8", "--image-size", "16",
             "--patch", "8", "--d-model", "16", "--n-heads", "2", "--d-ff",
             "32", "--layers-per-stage", "1", "--n-classes", "10",
             "--microbatches", "4", "--train-size", "24"]
VIT_SCHEDULES = {
    "gpipe": ["--schedule", "gpipe"],
    "1f1b": ["--schedule", "1f1b"],
    "1f1b_v2": ["--schedule", "1f1b", "--virtual-stages", "2"],
}
# The reference smokes' flags (tests/test_examples.py).
VIT_SMOKE = ["--epochs", "1", "--batchsize", "8", "--image-size", "32",
             "--patch", "8", "--d-model", "32", "--n-heads", "2", "--d-ff",
             "64", "--layers-per-stage", "1", "--n-classes", "10",
             "--microbatches", "2", "--train-size", "16"]
VIT_SMOKE_INTERLEAVED = VIT_SMOKE[:-4] + [
    "--microbatches", "4", "--train-size", "16", "--schedule", "1f1b",
    "--virtual-stages", "2", "--dp", "2"]


def vit_configs(dp):
    """``{name: argv}``: each schedule with and without double buffering,
    at ``dp`` data-parallel ways."""
    extra = [] if dp is None else ["--dp", str(dp)]
    return {f"{s}_{'db' if db else 'nodb'}":
            VIT_FLAGS + argv + extra + ([] if db else
                                        ["--no-double-buffering"])
            for s, argv in VIT_SCHEDULES.items() for db in (True, False)}


def load_vit_state(path, pp_rank):
    """Pipeline rank ``pp_rank``'s ``{"embed", "stages", "head"}`` state
    dicts from an npz of ``r<d>/<group>/<name>`` arrays."""
    state = {"embed": {}, "stages": {}, "head": {}}
    with np.load(path) as f:
        for key in f.files:
            r, group, name = key.split("/", 2)
            if r == f"r{pp_rank}":
                state[group][name] = torch.from_numpy(f[key])
    return state


def vit_example_run(comm, argv, init_path, device="cpu"):
    """The example's step for its epoch's batches from the given initial
    state: the losses and this rank's final state (as lists)."""
    from chainermn_tpu_torch.datasets.toy import batch_iterator
    from chainermn_tpu_torch.examples import train_vit as ex

    args = ex.parser().parse_args(argv + ["--device", device])
    run = ex.ViTPipeline(args, comm)
    run.load(load_vit_state(init_path, run.pp_comm.rank))
    losses, norms = [], None
    for x, y in batch_iterator(ex.training_set(args), args.batchsize, seed=0):
        losses.append(float(run.step(x, y)))
        if norms is None:
            # Step 0's averaged gradients (kept by double buffering, else
            # just applied) by group, summed over the pipeline ranks.
            grads, pos = run.prev if run.double_buffering else None, 0
            norms = {}
            for name, group in run.groups.items():
                sq = (sum(float(g.square().sum())
                          for g in grads[pos:pos + len(group)])
                      if grads is not None else 0.0)
                if name == "stages":
                    sq = float(run.pp_comm.allreduce(torch.tensor([sq]))[0])
                norms[name] = sq ** 0.5
                pos += len(group)
    return {"losses": losses, "pp_rank": run.pp_comm.rank,
            "grad_norms0": norms,
            "state": {g: {k: _np(v) for k, v in sd.items()}
                      for g, sd in run.state().items()}}


def _vit(rank, size, args):
    from chainermn_tpu_torch import create_communicator

    comm = create_communicator("xla_ici", device="cpu",
                               inter_size=args["dp"])
    return {key: vit_example_run(comm, argv, args["init"][key])
            for key, argv in vit_configs(args["dp"]).items()}


def _vit_main(rank, size):
    import contextlib
    import io

    from chainermn_tpu_torch.examples import train_vit as ex

    with contextlib.redirect_stdout(io.StringIO()) as printed:
        loss = ex.main(VIT_SMOKE_INTERLEAVED + ["--device", "cpu"])
    return {"loss": loss, "printed": printed.getvalue()}


# -- the parallel-convolution example ----------------------------------------

# The reference smoke's flags (tests/test_examples.py): 4 steps.
PCONV_SMOKE = ["--communicator", "naive", "--epochs", "1", "--batchsize",
               "8", "--channels", "16", "--train-size", "32"]


def pconv_run(comm, init_path=None, argv=PCONV_SMOKE, device="cpu",
              keep_init=False):
    """The example's net and step on this rank from the given initial
    channel shards (an npz of ``r<d>/<name>`` arrays; ``None``: the
    example's own initialisation): this rank's losses and final state
    (and its initial state with ``keep_init``)."""
    from chainermn_tpu_torch.datasets.toy import batch_iterator
    from chainermn_tpu_torch.examples import train_parallel_conv as ex

    args = ex.parser().parse_args(argv + ["--device", device])
    model = ex.make_model(args, comm)
    if init_path is not None:
        with np.load(init_path) as f:
            pre = f"r{comm.rank}/"
            model.load_state_dict({k[len(pre):]: torch.from_numpy(f[k])
                                   for k in f.files if k.startswith(pre)})
    init = ({k: _np(v) for k, v in model.state_dict().items()}
            if keep_init else None)
    step = ex.make_step(model, comm)
    losses = [float(step(x, y)) for x, y in
              batch_iterator(ex.training_set(args), args.batchsize, seed=0)]
    out = {"losses": losses,
           "state": {k: _np(v) for k, v in model.state_dict().items()}}
    if keep_init:
        out["init"] = init
    return out


def _pconv(rank, size, args):
    import contextlib
    import io

    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.examples import train_parallel_conv as ex

    comm = create_communicator("naive", device="cpu")
    out = pconv_run(comm, args["init"])
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        out["main_loss"] = ex.main(PCONV_SMOKE + ["--device", "cpu"])
    out["printed"] = printed.getvalue()
    return out


# -- across cards (NCCL) ------------------------------------------------------

# The ViT example at full width in fp32, global batch 128 in 4
# microbatches, 3 steps: across four cards in three layouts, and on one
# card with all 12 layers (the reference for them).
VIT_WIDE = ["--image-size", "224", "--patch", "16", "--d-model", "768",
            "--n-heads", "12", "--d-ff", "3072", "--n-classes", "1000",
            "--batchsize", "128", "--microbatches", "4", "--epochs", "1",
            "--train-size", "384"]
VIT_WIDE_CARDS = {
    "pp4": ["--schedule", "1f1b", "--layers-per-stage", "3"],
    "dp2xpp2": ["--schedule", "gpipe", "--dp", "2", "--layers-per-stage",
                "6"],
    "pp4_v3": ["--schedule", "1f1b", "--virtual-stages", "3",
               "--layers-per-stage", "1"],
}
VIT_WIDE_ONE = ["--schedule", "1f1b", "--layers-per-stage", "12"]


def vit_wide_run(extra, batches=None, device="cuda", flags=VIT_WIDE):
    """The example (at full width by default) on this world's devices:
    each step's loss, the median of the timed steps (the first step is
    not timed; each step ends with a device synchronisation), peak
    memory, and the norm and size of every parameter keyed by its global
    layer (``layer<k>.<name>``), embedding and head."""
    import time

    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.datasets.toy import batch_iterator
    from chainermn_tpu_torch.examples import train_vit as ex

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    args = ex.parser().parse_args(flags + extra + ["--device", device])
    world = create_communicator("xla_ici", device=device,
                                inter_size=args.dp)
    if batches is None:
        batches = [(torch.from_numpy(x).to(world.device),
                    torch.from_numpy(y).to(world.device))
                   for x, y in batch_iterator(ex.training_set(args),
                                              args.batchsize, seed=0)]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    run = ex.ViTPipeline(args, world)
    losses, ms = [], []
    for x, y in batches:
        sync()
        t = time.perf_counter()
        losses.append(run.step(x, y))
        sync()
        ms.append((time.perf_counter() - t) * 1e3)
    ms = sorted(ms[1:])
    def norm(t):
        return [float(t.detach().norm()), t.numel()]

    norms = {f"embed.{k}": norm(p) for k, p in run.embed_params.items()}
    norms.update({f"head.{k}": norm(p) for k, p in run.head_params.items()})
    d, pp, ls = run.pp_comm.rank, run.pp, args.layers_per_stage
    for k, p in run.stage_params.items():
        _, i, rest = k.split(".", 2)
        for l in range(run.v):
            layer = (l * pp + d) * ls + int(i)
            norms[f"layer{layer}.{rest}"] = norm(p[l] if run.v > 1 else p)
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    return {"losses": [float(x) for x in losses], "step_ms": ms[len(ms) // 2],
            "peak_gib": peak, "norms": norms}, batches


def _pp_nccl(rank, size, args):
    """Across the cards: every schedule case, the ViT example at full
    width in three layouts, and the parallel-convolution example (its
    own initialisation, the initial shards kept).  ``args`` may name
    another ``device`` and ViT ``flags`` (a rehearsal on gloo)."""
    from chainermn_tpu_torch import create_communicator

    dev = args.get("device", "cuda")
    flags = args.get("flags", VIT_WIDE)
    out = _pipeline(rank, size, device=dev)
    out = {"backend": dist.get_backend(), "pipeline": out}
    batches, out["vit"] = None, {}
    for name, extra in VIT_WIDE_CARDS.items():
        out["vit"][name], batches = vit_wide_run(extra, batches, dev, flags)
    comm = create_communicator("naive", device=dev)
    out["pconv"] = pconv_run(comm, None, device=dev, keep_init=True)
    return out


def _pp_one_card(rank, size, args):
    """One card: the ViT example with all 12 layers, and each rank's
    step-0 loss of the four cards' parallel-convolution run from one
    unsharded net holding their shards (the channels concatenated in rank
    order, rank ``r``'s head)."""
    from chainermn_tpu_torch.datasets.toy import batch_iterator
    from chainermn_tpu_torch.examples import train_parallel_conv as ex

    dev = args.get("device", "cuda")
    out = {"vit": vit_wide_run(VIT_WIDE_ONE, None, dev,
                               args.get("flags", VIT_WIDE))[0]}
    a = ex.parser().parse_args(PCONV_SMOKE + ["--device", dev])
    x, y = next(batch_iterator(ex.training_set(a), a.batchsize, seed=0))
    x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).long().to(dev)
    inits = args["pconv_inits"]
    n = len(inits)
    losses = []
    for r in range(n):
        net = ex.ShardedConvNet(a.channels, 1).to(dev)
        sd = {k: torch.cat([torch.tensor(init[k]) for init in inits])
              for k in inits[0] if k.startswith("conv_")}
        sd.update({k: torch.tensor(inits[r][k]) for k in inits[r]
                   if k.startswith("head.")})
        net.load_state_dict(sd)
        with torch.no_grad():
            losses.append(float(torch.nn.functional.cross_entropy(net(x), y)))
    out["pconv_step0"] = losses
    return out


# -- spawning -----------------------------------------------------------------

def run(kind: str, rank: int, size: int, init_file: str, out_dir: str,
        args: dict):
    torch.set_num_threads(1)        # one core a rank: no oversubscription
    backend = "gloo"
    if kind in ("pp_nccl", "pp_one_card") and \
            args.get("device", "cuda") == "cuda":
        # One GPU a rank, as a launcher would set it up.
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)
        backend = "nccl"
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=size)
    try:
        if kind == "pipeline":
            res = _pipeline(rank, size)
        elif kind == "pipeline_pconv":
            res = {"pipeline": _pipeline(rank, size),
                   "pconv": pconv_run(_naive_cpu(), None)}
        elif kind == "pp_nccl":
            res = _pp_nccl(rank, size, args)
        elif kind == "pp_one_card":
            res = _pp_one_card(rank, size, args)
        elif kind == "vit":
            res = _vit(rank, size, args)
        elif kind == "vit_main":
            res = _vit_main(rank, size)
        elif kind == "splits":
            res = _splits(rank, size, args["inter_size"])
        elif kind == "pconv":
            res = _pconv(rank, size, args)
        else:
            raise ValueError(kind)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn(kind: str, size: int, tmp_path, timeout_s: float = 60, **args):
    """Run ``kind`` on ``size`` spawned gloo ranks, each joined under
    ``timeout_s``; returns every rank's JSON result."""
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
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(size)]
