"""Fake-world worker for the port's collective-audit tests
(``tests/test_torch_collective_audit.py``) and ``chip_smoke.py`` phase 18b.

Imports only torch, numpy and the port.  ``run`` joins torch's process
group without peers (``backend="fake"`` on a ``FakeStore``: every
collective completes locally, nothing leaves the process), once for each
rank asked for, and audits the reference's census scenario there: the
64-leaf tree of ``synthetic_grad_tree(64, 8 MiB)`` through
``allreduce_grad`` of the five communicators on a world of 8 forced to
2 x 4, bucketed at 256 KiB and unbucketed, on the int8 wire, and under the
backward-overlapped launch; then the serving steps on a world of 2.  The
capture runs no collective, so a fake group is enough; the object plane,
which would need peers, is never called.

Run as a script it prints one JSON line::

    python tests/_torch_audit_worker.py [--device cpu,cuda] [--ranks 0,1]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.distributed as dist

#: the scenario of tests/golden/allreduce_census_64leaf*.json.
MESH = (2, 4)
N_LEAVES, TOTAL_BYTES, BUCKET_BYTES = 64, 8 * 1024 * 1024, 256 * 1024
COMMUNICATORS = ("naive", "flat", "xla_ici", "hierarchical",
                 "two_dimensional")
#: leaves, total bytes, bucket bytes of tests/test_packing.py's census.
SMALL = (24, 512 * 1024, 64 * 1024)
#: chip_smoke.py phase 4's LM widths, and its batch a rank.
LM_GEO = dict(vocab=32768, d_model=2048, n_heads=16, d_ff=8192, n_layers=8,
              max_len=4096)
LM_BATCH = 4


def _record(audit) -> dict:
    out = audit.summary()
    out["census"] = audit.census()
    return out


def _fake_world(rank: int, size: int):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=size)


def allreduce_cases(device: str, mesh=MESH) -> dict:
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.communicators.packing import synthetic_grad_tree
    from chainermn_tpu_torch.observability.collective_audit import (
        audit_allreduce, audit_allreduce_tree)

    tree = synthetic_grad_tree(N_LEAVES, TOTAL_BYTES, device=device)

    def comm(name, **kw):
        return create_communicator(name, device=device, inter_size=mesh[0],
                                   intra_size=mesh[1], **kw)

    out = {}
    for name in COMMUNICATORS:
        rec = {}
        for label, bb in (("bucketed", BUCKET_BYTES), ("unbucketed", 0)):
            rec[label] = _record(audit_allreduce_tree(
                comm(name, bucket_bytes=bb, overlap=False), tree))
        rec["int8"] = _record(audit_allreduce_tree(
            comm(name, bucket_bytes=BUCKET_BYTES, overlap=False,
                 comm_dtype="int8"), tree))
        rec["overlap"] = _record(audit_allreduce_tree(
            comm(name, bucket_bytes=BUCKET_BYTES, overlap=True,
                 overlap_granularity=1), tree, overlap=True))
        rec["one_buffer"] = _record(audit_allreduce(
            comm(name, overlap=False), 1 << 20))
        # tests/test_packing.py's scenario: 24 leaves, 512 KiB, 64 KiB
        # buckets (and unbucketed).
        small = synthetic_grad_tree(SMALL[0], SMALL[1], device=device)
        for label, bb in (("small_bucketed", SMALL[2]),
                          ("small_unbucketed", 0)):
            rec[label] = _record(audit_allreduce_tree(
                comm(name, bucket_bytes=bb, overlap=False), small))
        out[name] = rec
    out["toy"] = toy_cases(comm("flat", overlap=False), device)
    return out


def toy_cases(comm, device: str) -> dict:
    """``audit_fn`` on a toy step with one all-reduce over the world and on
    one without collectives (tests/test_observability.py's cases)."""
    from chainermn_tpu_torch.observability.collective_audit import audit_fn

    x = torch.ones(256, device=device)

    def reduce(t):
        y = t * 2
        dist.all_reduce(y, group=comm.group)
        return y

    return {"psum": _record(audit_fn(reduce, x, comm=comm)),
            "local": _record(audit_fn(lambda t: t * 2, x, comm=comm))}


def serving_cases(n_layers: int = 2) -> dict:
    """On a world of 2: the TP decode step at 1 and ``n_layers`` layers,
    the host sampling tail on its replicated logits, and the SP chunk
    prefill."""
    from chainermn_tpu_torch.analysis import fixtures
    from chainermn_tpu_torch.observability.collective_audit import audit_fn
    from chainermn_tpu_torch.serving import InferenceEngine, SamplingParams

    out = {}
    for layers in (1, n_layers):
        t = fixtures.fixture_tp_decode(n_layers=layers)
        audit = audit_fn(t["fn"], *t["args"], state=t["state"])
        out[f"tp_decode_{layers}"] = _record(audit)
    logits = torch.zeros(2, fixtures._GEOM["vocab"])

    def tail(lg):
        return [InferenceEngine.sample(row, SamplingParams(), 0)
                for row in lg.float().cpu().numpy()]

    out["sampling_tail"] = _record(audit_fn(tail, logits))
    t = fixtures.fixture_sharded_prefill()
    out["sp_prefill"] = _record(audit_fn(t["fn"], *t["args"],
                                         state=t["state"]))
    return out


def lm_audit(device: str, mesh, geo=None, batch: int = LM_BATCH,
             profile: bool = False) -> dict:
    """``audit_fn`` on ``chip_smoke.py`` phase 4's LM step (its widths
    unless ``geo`` is given; bf16, flash attention, fused CE, AdamW) over
    an ``xla_ici`` communicator forced to ``mesh`` with the overlapped
    bucket launch on, each rank on its own seeded batch.  With
    ``profile``, two steps and then one under ``torch.profiler``: the
    share of NCCL kernel time that overlaps another kernel."""
    import inspect

    import numpy as np

    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.models.transformer import TransformerLM
    from chainermn_tpu_torch.observability import audit_fn
    from chainermn_tpu_torch.ops import make_flash_attention_fn
    from chainermn_tpu_torch.ops.fused_ce import fused_cross_entropy

    geo = dict(LM_GEO if geo is None else geo)
    comm = create_communicator("xla_ici", device=device, inter_size=mesh[0],
                               intra_size=mesh[1], overlap=True)
    model = TransformerLM(**geo, dtype=torch.bfloat16,
                          attention_fn=make_flash_attention_fn(causal=True),
                          device=comm.device, seed=0)
    opt = create_multi_node_optimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.1),
        comm)
    opt.init()
    rng = np.random.RandomState(dist.get_rank())
    data = tuple(torch.from_numpy(rng.randint(
        0, geo["vocab"], (batch, geo["max_len"]))).to(comm.device)
        for _ in range(2))

    def loss_fn(b):
        toks, labs = b
        h = model(toks, return_hidden=True)
        return fused_cross_entropy(h, model.embed.weight, labs)

    step = opt.make_train_step(loss_fn, local_batch=True)
    out = _record(audit_fn(inspect.unwrap(step), data, comm=comm,
                           state=opt))
    if profile:
        out["profiler_nccl_overlap"] = _nccl_overlap(step, data)
    return out


def _nccl_overlap(step, data) -> float:
    """Share of NCCL kernel time, in one profiled step after two, that
    runs while another (compute) kernel runs."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step(data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(data)
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end, "nccl" in e.name.lower())
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    compute = [(a, b) for a, b, n in spans if not n]
    total = hidden = 0
    for a, b, is_nccl in spans:
        if not is_nccl:
            continue
        total += b - a
        cover = sorted((max(a, c0), min(b, c1)) for c0, c1 in compute
                       if c0 < b and c1 > a)
        end = a
        for c0, c1 in cover:
            hidden += max(0, c1 - max(c0, end))
            end = max(end, c1)
    return hidden / total if total else 0.0


def run(ranks=(0, 1), device: str = "cpu", serving: bool = True,
        mesh=MESH, lm: bool = False, geo=None) -> dict:
    """Every case at each rank of ``ranks`` (a fake world of ``mesh``,
    8 as 2 x 4 by default; with ``lm`` also the LM step's audit), then,
    with ``serving``, the serving cases at rank 0 of a fake world of 2.
    One process group at a time, each destroyed after use."""
    torch.manual_seed(0)
    out = {"ranks": {}}
    for rank in ranks:
        _fake_world(rank, mesh[0] * mesh[1])
        try:
            out["ranks"][str(rank)] = allreduce_cases(device, mesh)
            if lm:
                out["ranks"][str(rank)]["lm"] = lm_audit(
                    device, mesh, geo=geo, batch=LM_BATCH if geo is None
                    else 2)
        finally:
            dist.destroy_process_group()
    if serving:
        _fake_world(0, 2)
        try:
            out["serving"] = serving_cases()
        finally:
            dist.destroy_process_group()
    return out


def run_ranks(rank: int, size: int, init_file: str, out_dir: str, mesh,
              device: str = "cuda", geo=None):
    """One real rank (NCCL, one card; gloo for ``device="cpu"``): the same
    cases as :func:`run` for this rank, the LM step's (at ``geo``) with its
    profiled overlap on a card; writes ``<out_dir>/rank<r>.json``."""
    if device == "cuda":
        # A bare "cuda" would put every rank on LOCAL_RANK's card (0
        # without a launcher): name this rank's card.
        device = f"cuda:{rank}"
        torch.cuda.set_device(rank)
    dist.init_process_group("gloo" if device == "cpu" else "nccl",
                            init_method=f"file://{init_file}",
                            rank=rank, world_size=size)
    try:
        res = allreduce_cases(device, mesh)
        res["lm"] = lm_audit(device, mesh, geo=geo,
                             batch=LM_BATCH if geo is None else 2,
                             profile=device != "cpu")
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(size: int, tmp_path, mesh, timeout_s: float = 600,
                device: str = "cuda", geo=None):
    """:func:`run_ranks` on ``size`` spawned ranks; every rank's result."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run_ranks, args=(
        r, size, str(tmp_path / "rendezvous"), str(tmp_path), mesh, device,
        geo)) for r in range(size)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout_s)
            assert p.exitcode == 0, f"rank exited {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(size)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cpu",
                   help="a device, or several separated by commas: the "
                        "result is then keyed by device")
    p.add_argument("--ranks", default="0,1")
    p.add_argument("--no-serving", action="store_true")
    p.add_argument("--mesh", default="2x4", help="inter x intra")
    p.add_argument("--lm", action="store_true",
                   help="also audit phase 4's LM step (needs a card)")
    args = p.parse_args(argv)
    ranks = tuple(int(r) for r in args.ranks.split(","))
    devices = args.device.split(",")
    mesh = tuple(int(x) for x in args.mesh.split("x"))
    res = {d: run(ranks, d, serving=not args.no_serving, mesh=mesh,
                  lm=args.lm) for d in devices}
    print(json.dumps(res if len(devices) > 1 else res[devices[0]]),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
