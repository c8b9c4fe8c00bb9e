"""Worker processes for the multi-rank tests of the port's GSPMD step
(``parallel.sharding.make_gspmd_train_step`` over a ``DeviceMesh``).

Imports only torch, numpy and the port, so a spawned child never loads
JAX.  Each worker joins a ``file://`` rendezvous, runs every case of its
world (one spawn per world size), and writes its results as JSON to
``<out_dir>/rank<r>.json``.  Weights come from ``<out_dir>/init.npz``
(the reference's initial weights through ``convert.py``) when the test
writes one, else from the port's seeded init; tokens are numpy draws
from fixed seeds shared with the tests.
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

LM = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_len=16)
B, S, LR, STEPS = 8, 16, 1e-2, 3


def lm_batch():
    """(tokens, next-token targets), the reference test's batch."""
    tokens = np.random.RandomState(0).randint(0, LM["vocab"], (B, S))
    return tokens, np.roll(tokens, -1, axis=1)


def make_lm(init_path=None, **over):
    from chainermn_tpu_torch.models.transformer import TransformerLM
    from chainermn_tpu_torch.ops import make_flash_attention_fn

    cfg = dict(LM, dtype=torch.float32, device="cpu", seed=0,
               attention_fn=make_flash_attention_fn(causal=True))
    cfg.update(over)
    model = TransformerLM(**cfg)
    if init_path and os.path.exists(init_path):
        with np.load(init_path) as sd:
            model.load_state_dict({k: torch.from_numpy(sd[k])
                                   for k in sd.files})
    return model


def _ce(logits, targets):
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           targets.reshape(-1))


def logits_loss(model, batch):
    """Mean CE of the tied fp32 logits (the reference test's loss), per
    data shard through ``batch_mean``."""
    from chainermn_tpu_torch.parallel.sharding import batch_mean

    tokens, targets = batch
    return batch_mean(_ce, (model(tokens), targets))


def oracle(model, batch, steps=STEPS):
    """The replicated oracle: plain Adam steps on one process."""
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    tokens, targets = (torch.from_numpy(x) for x in batch)
    losses = []
    for _ in range(steps):
        loss = _ce(model(tokens), targets)
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(float(loss))
    return losses, opt


def _params(model):
    from torch.distributed.tensor import DTensor

    return {n: (p.full_tensor() if isinstance(p, DTensor) else p)
            .detach().cpu().numpy().tolist()
            for n, p in model.named_parameters()}


def _placements(p):
    return [str(x) for x in p.placements]


def run_plan(mesh, plan, batch, init_path=None, steps=STEPS, model=None,
             opt_state=None):
    """``steps`` GSPMD steps of ``plan`` on ``mesh``: losses, final
    parameters, and each parameter's and moment's placements."""
    from chainermn_tpu_torch.parallel.sharding import make_gspmd_train_step

    model = model or make_lm(init_path)
    step, shard_fn = make_gspmd_train_step(
        model, logits_loss, lambda ps: torch.optim.Adam(ps, lr=LR), mesh,
        plan)
    model, opt = shard_fn(opt_state)
    tokens, targets = (torch.from_numpy(x) for x in batch)
    losses = [float(step((tokens, targets))) for _ in range(steps)]
    moments = {}
    for group in opt.param_groups:
        for p in group["params"]:
            moments[len(moments)] = {
                "param": _placements(p),
                "exp_avg": _placements(opt.state[p]["exp_avg"])}
    return {"losses": losses, "params": _params(model),
            "placements": {n: _placements(p)
                           for n, p in model.named_parameters()},
            "moments": [moments[i] for i in range(len(moments))]}


def _error(fn):
    try:
        fn()
    except (RuntimeError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _w4(rank, size, args):
    """World 4: dp_tp on a 2 x 2 mesh (plan name and spec mapping),
    plans_for_mesh on real meshes, the step's refusals."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.parallel.sharding import (
        build_device_mesh, make_gspmd_train_step, transformer_param_spec)
    from chainermn_tpu_torch.sharding import plans_for_mesh

    comm = create_communicator("naive", device="cpu")
    mesh = build_device_mesh(comm, (2, 2), device="cpu")
    data = build_device_mesh(comm, (4,), ("data",), device="cpu")
    init, batch = args["init"], lm_batch()
    out = {"dp_tp": run_plan(mesh, "dp_tp", batch, init),
           "spec_tree": run_plan(
               mesh, transformer_param_spec(make_lm(init)), batch, init),
           "plans_2x2": [p.name for p in plans_for_mesh(mesh)],
           "plans_data4": [p.name for p in plans_for_mesh(data)],
           "plans_2x2_lm": [p.name for p in plans_for_mesh(
               mesh, make_lm(n_kv_heads=2))]}
    step, shard_fn = make_gspmd_train_step(
        make_lm(), logits_loss, lambda ps: torch.optim.SGD(ps, lr=0.1), mesh,
        "dp")
    out["before_shard_fn"] = _error(lambda: step(lm_batch()))
    out["axisless_mesh"] = _error(lambda: make_gspmd_train_step(
        make_lm(), logits_loss, torch.optim.SGD, data, "tp"))
    out["no_data_axis"] = _error(lambda: make_gspmd_train_step(
        make_lm(), logits_loss, torch.optim.SGD,
        build_device_mesh(comm, (4,), ("model",), device="cpu"), "tp"))
    mystery = {"state": {99: {"exp_avg": torch.zeros(4, 4)}},
               "param_groups": [{"params": [0], "lr": 0.1}]}
    _, shard_fn = make_gspmd_train_step(
        make_lm(), logits_loss, lambda ps: torch.optim.Adam(ps, lr=LR),
        mesh, "dp_tp")
    out["moment_miss"] = _error(lambda: shard_fn(mystery))
    if rank:
        for case in ("dp_tp", "spec_tree"):
            out[case].pop("params")
    return out


class TwoKernels(torch.nn.Module):
    """Two same-shaped weights that shard differently: moments must follow
    each one's name, never the shape."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(3)
        self.a = torch.nn.Linear(16, 16, bias=False)
        self.b = torch.nn.Linear(16, 16, bias=False)
        with torch.no_grad():
            self.a.weight.copy_(torch.randn(16, 16, generator=g) / 4)
            self.b.weight.copy_(torch.randn(16, 16, generator=g) / 4)

    def forward(self, x):
        return self.b(self.a(x))


def _two_kernels_loss(model, batch):
    from chainermn_tpu_torch.parallel.sharding import batch_mean

    return batch_mean(lambda y: (y ** 2).sum(-1).mean(), (model(batch[0]),))


def _w2(rank, size, args):
    """World 2: tp (1 x 2, MHA and GQA), fsdp and zero (2) against the
    replicated oracle; fsdp resumed from an unsharded optimizer state;
    moments by name on two same-shaped weights."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.parallel.sharding import (
        build_device_mesh, make_gspmd_train_step)
    from chainermn_tpu_torch.sharding import P

    comm = create_communicator("naive", device="cpu")
    mesh12 = build_device_mesh(comm, (1, 2), device="cpu")
    data2 = build_device_mesh(comm, (2,), ("data",), device="cpu")
    batch = lm_batch()
    out, oracles = {}, {}
    for name, mesh, plan, over in (
            ("tp", mesh12, "tp", {}),
            ("tp_gqa", mesh12, "tp", {"n_kv_heads": 2}),
            ("fsdp", data2, "fsdp", {}),
            ("zero", data2, "zero", {})):
        res = run_plan(mesh, plan, batch, model=make_lm(**over))
        key = tuple(sorted(over.items()))
        if key not in oracles:
            ref = make_lm(**over)
            oracles[key] = oracle(ref, batch)[0], _params(ref)
        res["oracle_losses"], res["oracle_params"] = oracles[key]
        out[name] = res
    # fsdp resumed: one unsharded Adam step, its state loaded by shard_fn,
    # two GSPMD steps — against three unsharded steps.
    model = make_lm()
    _, opt = oracle(model, batch, steps=1)
    res = run_plan(data2, "fsdp", batch, model=model,
                   opt_state=opt.state_dict(), steps=STEPS - 1)
    out["fsdp_resumed"] = res
    # moments follow the parameter's name, never its shape
    spec = {"a.weight": P("model", None), "b.weight": P(None, "model")}
    x = np.random.RandomState(5).randn(4, 16).astype(np.float32)
    step, shard_fn = make_gspmd_train_step(
        TwoKernels(), _two_kernels_loss,
        lambda ps: torch.optim.Adam(ps, lr=LR), mesh12, spec)
    model, opt = shard_fn()
    step((torch.from_numpy(x),))
    out["two_kernels"] = {
        n: {"param": _placements(p),
            "exp_avg": _placements(opt.state[p]["exp_avg"]),
            "exp_avg_sq": _placements(opt.state[p]["exp_avg_sq"]),
            "step": type(opt.state[p]["step"]).__name__}
        for n, p in model.named_parameters()}
    if rank:
        for res in out.values():
            res.pop("params", None)
            res.pop("oracle_params", None)
    return out


# -- across the cards -----------------------------------------------------------

#: Phase 4's model, batch and AdamW (``chip_smoke.py``): what each plan runs
#: across four cards and the plain step runs on one.
FULL = dict(vocab=32768, d_model=2048, n_heads=16, d_ff=8192, n_layers=8,
            seq=4096, batch=4, ce_chunk=1024)
#: Each plan's mesh over four cards.
GSPMD_CARDS = {"tp": ((1, 4), ("data", "model")),
               "dp_tp": ((2, 2), ("data", "model")),
               "fsdp": ((4,), ("data",)),
               "zero": ((4,), ("data",))}


def _full_setup(cfg, device):
    from chainermn_tpu_torch.models.transformer import TransformerLM
    from chainermn_tpu_torch.ops import make_flash_attention_fn

    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = TransformerLM(
        vocab=cfg["vocab"], d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        d_ff=cfg["d_ff"], n_layers=cfg["n_layers"], max_len=cfg["seq"],
        dtype=torch.bfloat16, device=device, seed=0,
        attention_fn=make_flash_attention_fn(causal=True))
    rng = np.random.RandomState(0)
    shape = (cfg["batch"], cfg["seq"])
    batch = tuple(torch.from_numpy(rng.randint(0, cfg["vocab"], shape))
                  .to(device) for _ in range(2))

    def adamw(params):
        return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=0.1)

    return model, batch, adamw


def _timed(step, batch, steps, device):
    """Each step's loss and time (host clock around a synchronised step),
    and the peak memory."""
    import time

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    losses, ms = [], []
    for _ in range(steps):
        sync()
        t = time.perf_counter()
        losses.append(float(step(batch)))
        sync()
        ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30 \
        if device == "cuda" else 0.0
    return {"losses": losses, "step_ms": ms, "peak_gib": peak}


def _kind(name):
    low = name.lower()
    return ("nccl" if "nccl" in low else "flash" if "flash_" in low else
            "gemm" if any(w in low for w in ("gemm", "nvjet", "xmma",
                                              "cutlass", "cublas")) else
            "other")


def profile_step(step, batch):
    """One more step under ``torch.profiler``: wall and device-busy ms,
    the device's idle share and its time by kind of kernel."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kinds = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total \
                and not getattr(ev, "is_user_annotation", False):
            k = _kind(ev.key)
            kinds[k] = kinds.get(k, 0.0) + ev.self_device_time_total / 1e3
    busy = sum(kinds.values())
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "by_kind_ms": kinds}


def gspmd_full(comm, plan, mesh_shape, names, cfg=FULL, device="cuda",
               steps=3):
    """``plan`` on a mesh over the world: ``steps`` of phase 4's step, and
    the bytes of this rank's parameters and AdamW moments."""
    from chainermn_tpu_torch.parallel.sharding import (
        build_device_mesh, lm_loss, make_gspmd_train_step)

    mesh = build_device_mesh(comm, mesh_shape, names, device=device)
    model, batch, adamw = _full_setup(cfg, device)
    step, shard_fn = make_gspmd_train_step(
        model, lm_loss(cfg["ce_chunk"]), adamw, mesh, plan)
    model, opt = shard_fn()
    out = _timed(step, batch, steps, device)
    if device == "cuda":
        out["profile"] = profile_step(step, batch)
    out["param_bytes"] = sum(p.to_local().numel() * p.element_size()
                             for p in model.parameters())
    out["moment_bytes"] = sum(
        v.to_local().numel() * v.element_size()
        for st in opt.state.values() for v in st.values()
        if hasattr(v, "to_local"))
    return out


def plain_full(cfg=FULL, device="cuda", steps=3):
    """One card's unsharded step: the model, fused CE and AdamW, no
    DTensor."""
    from chainermn_tpu_torch.ops.fused_ce import fused_cross_entropy

    model, batch, adamw = _full_setup(cfg, device)
    opt = adamw(model.parameters())

    def step(b):
        loss = fused_cross_entropy(model(b[0], return_hidden=True),
                                   model.embed.weight, b[1],
                                   chunk=cfg["ce_chunk"])
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    out = _timed(step, batch, steps, device)
    if device == "cuda":
        out["profile"] = profile_step(step, batch)
    return out


def _gspmd_cards(rank, size, args):
    """Every plan of ``GSPMD_CARDS`` in turn on this world (``args`` may
    name another ``device`` and a smaller ``cfg``: a rehearsal on
    gloo)."""
    import gc

    from chainermn_tpu_torch import create_communicator

    dev, cfg = args.get("device", "cuda"), args.get("cfg", FULL)
    comm = create_communicator("xla_ici", device=dev)
    out = {"backend": dist.get_backend(), "plans": {}}
    for plan, (shape, names) in GSPMD_CARDS.items():
        out["plans"][plan] = gspmd_full(comm, plan, shape, names, cfg, dev)
        gc.collect()
    return out


def _gspmd_one_card(rank, size, args):
    return plain_full(args.get("cfg", FULL), args.get("device", "cuda"))


# -- spawning -----------------------------------------------------------------

KINDS = {"w4": _w4, "w2": _w2, "gspmd_cards": _gspmd_cards,
         "gspmd_one_card": _gspmd_one_card}


def run(kind: str, rank: int, size: int, init_file: str, out_dir: str,
        args: dict):
    torch.set_num_threads(1)        # one core a rank: no oversubscription
    warnings.filterwarnings("ignore")
    backend = "gloo"
    if kind.startswith("gspmd_") and args.get("device", "cuda") == "cuda":
        # One GPU a rank, as a launcher would set it up.
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)
        backend = "nccl"
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=size)
    try:
        res = KINDS[kind](rank, size, args)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn(kind: str, size: int, tmp_path, timeout_s: float = 60, **args):
    """Run ``kind`` on ``size`` spawned ranks, each joined under
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
