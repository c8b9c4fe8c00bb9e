"""The run of one cell: set-up, the first steps and their readings, the
measured window, the traced stretch, the reference, the verdict.

Everything a cell needs is found by name under the checkout's
``portbench/``: ``workloads/<cell>.json`` (configuration, traffic,
chips, limits), ``configs/<config>.json`` (sizes and the driver's name),
``drivers/<driver>.py`` and ``metrics/<metric>.py``.  A rank runs
:func:`run_rank`; on more than one chip :func:`spawn` starts one process
a card and gathers what each rank wrote.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time

from . import check, inputs, trace
from .reference import optim as ref_optim
from .reference.precision import no_tf32

PROGRAM = "chainermn_tpu_torch"
#: Top-level module names that no run may load (whole names compared).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chainermn_tpu")
FIRST_STEPS = 3          # the steps the reference follows
TIMING_STEPS = 2         # set-up steps that size the window
PROFILE_STEPS = 3        # the traced stretch after the window
#: Faults a test or a calibration may plant in the timed path.
FAULTS = ("state_unchanged", "half_batch", "no_exchange")


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def hygiene(root: str) -> None:
    """Before the program is imported: no ``CHAINERMN_TPU_*`` knob of the
    caller's environment steers the run, and every build or kernel cache
    lies at a fixed path inside the checkout."""
    for k in [k for k in os.environ if k.startswith("CHAINERMN_TPU_")]:
        del os.environ[k]
    cache = os.path.join(root, "build", "portbench")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)


def import_program(root: str):
    """The program, imported from the checkout at ``root`` and nowhere
    else (a copy installed elsewhere would not be the code under test)."""
    if root not in sys.path:
        sys.path.insert(0, root)
    mod = importlib.import_module(PROGRAM)
    here = os.path.realpath(os.path.dirname(mod.__file__))
    if os.path.dirname(here) != os.path.realpath(root):
        raise RuntimeError(f"{PROGRAM} was imported from {here}, not from "
                           f"the checkout {root}")
    return mod


# -- the registry: everything by name --------------------------------------

def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files its names lead to."""

    def __init__(self, root: str):
        self.root = root
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))
        self.dir = os.path.join(root, "portbench")

    def entry(self, workload: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == workload:
                return w
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def cell(self, workload: str):
        """``(cell file, configuration file)`` of a workload."""
        entry = self.entry(workload)
        cell = load_json(os.path.join(self.dir, "workloads",
                                      f"{workload}.json"))
        for key in ("config", "traffic", "chips"):
            if cell[key] != entry[key]:
                raise ValueError(f"{workload}: {key} is {cell[key]!r} in its "
                                 f"file, {entry[key]!r} in BENCHMARK.json")
        cfg = load_json(os.path.join(self.dir, "configs",
                                     f"{cell['config']}.json"))
        return cell, cfg

    def metrics(self, workload: str, trace_on: bool) -> list:
        """The metrics this cell reports: its end-to-end ones untraced,
        its per-layer ones traced."""
        e2e = [m for m in self.spec["end_to_end"]
               if workload in m.get("workloads", [workload])]
        if not trace_on:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if workload in m.get("workloads", [workload])
                or ("workloads" not in m and m["moves"] in names)]

    def metric_reader(self, name: str):
        path = os.path.join(self.dir, "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


# -- one rank ----------------------------------------------------------------

class Ctx:
    def __init__(self, device, rank, world, seed, fault=None):
        self.device, self.rank, self.world = device, rank, world
        self.seed, self.fault = seed, fault


def _norms(torch, pairs) -> dict:
    """``{name: float}`` from ``(name, 0-d tensor)`` pairs, one transfer."""
    pairs = list(pairs)
    if not pairs:
        return {}
    vals = torch.stack([v.float() for _, v in pairs]).cpu().tolist()
    return {n: v for (n, _), v in zip(pairs, vals)}


def _change(torch, tensors: dict, start: dict) -> dict:
    return _norms(torch, ((n, (t.detach().float() - start[n]).norm())
                          for n, t in tensors.items()))


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The program's objects for one cell, built once; :meth:`start`
    loads a seed's weights and a fresh optimizer."""

    def __init__(self, torch, drv, cfg, traffic, ctx):
        self.torch, self.drv, self.cfg, self.traffic = torch, drv, cfg, traffic
        self.ctx = ctx
        with torch.device("meta"):
            self.specs = inputs.weight_specs(drv.reference(cfg, traffic))
        self.model, self.comm, self._new_step = drv.build(torch, cfg,
                                                          traffic, ctx)
        sd = self.model.state_dict()
        names = {n for n, _ in self.specs}
        if set(sd) != names:
            raise ValueError(
                "the program's and the reference's tensors differ: "
                f"{sorted(set(sd) ^ names)[:8]}")
        self.work = drv.work(cfg, traffic, ctx.world)

    def start(self, seed: int, fault=None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; faults: {FAULTS}")
        torch, ctx = self.torch, self.ctx
        w = inputs.make_weights(self.specs, seed, ctx.device)
        with torch.no_grad():
            for n, t in self.model.state_dict().items():
                t.copy_(w[n])
        del w
        comm = self.comm
        for name in ("allreduce_grad", "_allreduce_async"):
            comm.__dict__.pop(name, None)
        if fault == "no_exchange":
            comm.allreduce_grad = lambda grads: None
            comm._allreduce_async = lambda buf: (lambda: buf)
        self.ctx.fault = fault
        self.inner, self.opt, self.step = self._new_step()
        if fault == "state_unchanged":
            self.inner.step = lambda *a, **k: None
        self.opt.init()
        self.pool = inputs.make_pool(self.traffic, self.cfg, seed, ctx.rank,
                                     ctx.device)
        self.done = 0

    def release(self):
        """Free the optimizer, its state and the gradients (the model and
        the communicator stay for the next :meth:`start`)."""
        for p in self.model.parameters():
            p.grad = None
        self.inner = self.opt = self.step = self.pool = None

    def run(self, k: int):
        losses = []
        for _ in range(k):
            losses.append(self.step(self.pool[self.done % len(self.pool)]))
            self.done += 1
        return losses

    def first_steps(self, seed: int) -> check.Readings:
        """The first steps, read as the reference reads its own."""
        torch = self.torch
        losses = self.run(1)
        grad = _norms(torch, self.drv.first_grad_norms(
            torch, self.model, self.inner, self.cfg).items())
        losses += self.run(FIRST_STEPS - 1)
        start = inputs.make_weights(self.specs, seed, self.ctx.device)
        params = dict(self.model.named_parameters())
        state = {n: b for n, b in self.model.named_buffers()
                 if n in start and b.is_floating_point()}
        r = check.Readings(losses=[x.item() for x in losses], grad=grad,
                           change=_change(torch, params, start),
                           state=_change(torch, state, start))
        del start
        return r

    def timing(self, seconds: float) -> int:
        """Steps of the window: ``seconds`` over the time of the set-up's
        timing steps, the same on every rank (rank 0's)."""
        torch, dev = self.torch, self.ctx.device
        _sync(torch, dev)
        t = time.perf_counter()
        self.run(TIMING_STEPS)
        _sync(torch, dev)
        per = (time.perf_counter() - t) / TIMING_STEPS
        n = torch.tensor([max(1, math.ceil(seconds / per))],
                         device=self.comm.device)
        if self.ctx.world > 1:
            torch.distributed.broadcast(n, 0)
        return int(n.item())

    def window(self, n: int) -> dict:
        torch, dev = self.torch, self.ctx.device
        cuda = dev.type == "cuda"
        _sync(torch, dev)
        marks = ([torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
                 if cuda else [])
        stamps = []
        t0, wall0 = time.perf_counter(), time.time()
        if cuda:
            marks[0].record()
        losses = []
        for i in range(n):
            losses += self.run(1)
            if cuda:
                marks[i + 1].record()
            else:
                stamps.append(time.perf_counter())
        _sync(torch, dev)
        seconds = time.perf_counter() - t0
        if cuda:
            step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        else:
            step_ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)]
        bad = int((~torch.isfinite(torch.stack(losses).float())).sum())
        return {"steps": n, "seconds": seconds, "start_wall": wall0,
                "work": n * self.work["per_step"],
                "flops": n * self.work["flops_per_step"],
                "step_ms": step_ms, "failed": bad}


def reference_readings(torch, drv, cfg, traffic, seed, world, device,
                       precision="fp32") -> check.Readings:
    """The plain reference's readings of the first steps on the same
    weights and every rank's same batches (TF32 off while it runs)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    no_tf32(torch)
    torch.backends.cudnn.benchmark = False
    try:
        return _reference_readings(torch, drv, cfg, traffic, seed, world,
                                   device, precision)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = flags


def _reference_readings(torch, drv, cfg, traffic, seed, world, device,
                        precision):
    with torch.device(device):
        ref = drv.reference(cfg, traffic)
    ref.set_precision(precision)
    specs = inputs.weight_specs(ref)
    w = inputs.make_weights(specs, seed, device)
    with torch.no_grad():
        for n, t in ref.state_dict().items():
            t.copy_(w[n])
    del w
    params = dict(ref.named_parameters())
    opt = ref_optim.make(drv.OPTIMIZER, params.values(), cfg)
    pools = [inputs.make_pool(traffic, cfg, seed, r, device)
             for r in range(world)]
    losses, grad = [], None
    for t in range(FIRST_STEPS):
        for p in params.values():
            p.grad = None
        losses.append(drv.ref_step(torch, ref, [p[t] for p in pools]))
        if grad is None:
            grad = _norms(torch, ((n, p.grad.norm())
                                  for n, p in params.items()))
        opt.step([p.grad for p in params.values()])
    start = inputs.make_weights(specs, seed, device)
    state = {n: b for n, b in ref.named_buffers() if b.is_floating_point()}
    out = check.Readings(losses=losses, grad=grad,
                         change=_change(torch, params, start),
                         state=_change(torch, state, start))
    del start, ref, opt, pools, params
    gc.collect()
    return out


def _device(torch, kind: str, rank: int):
    if kind == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        return dev
    return torch.device("cpu")


def run_rank(spec: dict) -> dict:
    """One rank of one run (``spec``: root, workload, seed, seconds,
    trace, rank, world, device, t_start; a ``fault`` only from tests).
    Returns what this rank measured; rank 0 adds the verdict."""
    root = spec["root"]
    hygiene(root)
    import torch

    import_program(root)
    from chainermn_tpu_torch.observability import reporter as rep_mod

    bench = Bench(spec.get("bench_root", root))
    cell, cfg = bench.cell(spec["workload"])
    traffic, drv = cell["traffic_params"], driver(cfg["driver"])
    rank, world, seed = spec["rank"], spec["world"], spec["seed"]
    dev = _device(torch, spec["device"], rank)
    ctx = Ctx(dev, rank, world, seed)
    rep = rep_mod.Reporter() if spec["trace"] else None
    out = {"rank": rank}
    marks = [("imports", time.time())]
    with (rep_mod.scope(rep) if rep else contextlib.nullcontext()):
        prog = Program(torch, drv, cfg, traffic, ctx)
        marks.append(("build", time.time()))
        prog.start(seed, spec.get("fault"))
        marks.append(("weights", time.time()))
        readings = prog.first_steps(seed)
        marks.append(("first steps", time.time()))
        n = prog.timing(spec["seconds"])
        marks.append(("timing steps", time.time()))
        log("set-up: " + ", ".join(
            f"{name} {t - t0:.1f} s" for (name, t), (_, t0) in
            zip(marks, [("start", spec["t_start"])] + marks)))
        before = _span(rep)
        win = prog.window(n)
        out["setup_s"] = win["start_wall"] - spec["t_start"]
        out["window"] = win
        out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0)
        if rep is not None:
            after = _span(rep)
            out["dispatch_s"] = ((after[1] - before[1])
                                 / max(1, after[0] - before[0]))
            out["counters"] = rep.summary()["counters"]
            stretch = trace.profile_stretch(torch, prog.run, PROFILE_STEPS,
                                            dev)
            out["busy_s"] = trace.busy_s(stretch)
            out["stretch_wall_s"] = stretch["wall_s"]
            if rank == 0:
                out["stretch"] = stretch
    out["work"] = prog.work
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if world > 1:
        torch.distributed.barrier()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    if rank == 0:
        t = time.time()
        ref = reference_readings(torch, drv, cfg, traffic, seed, world, dev)
        log(f"reference: {time.time() - t:.1f} s; set-up {out['setup_s']:.1f} "
            f"s, window {win['seconds']:.2f} s of {win['steps']} steps")
        nums = check.numbers(readings, ref)
        out["correct"], out["checks"] = check.verdict(nums, cell["limits"])
        out["readings"] = {"program": readings.to_json(),
                           "reference": ref.to_json()}
    out["forbidden"] = forbidden_modules()
    return out


def _span(rep):
    if rep is None:
        return (0, 0.0)
    s = rep.summary()["scalars"].get("span/train_step")
    return (s["count"], s["sum"]) if s else (0, 0.0)


# -- several ranks -----------------------------------------------------------

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(spec: dict, world: int, timeout: float, entry: str) -> list:
    """``world`` processes of ``entry`` (a script taking a spec file and a
    rank), one a card, joined on a localhost port the OS picked; their
    rendezvous and result files lie in a directory under ``TMPDIR``.
    Returns each rank's result, in rank order; raises if any failed."""
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        path = os.path.join(tmp, "spec.json")
        with open(path, "w") as f:
            json.dump(dict(spec, tmp=tmp), f)
        port = free_port()
        procs = []
        for r in range(world):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port))
            if spec["device"] == "cuda":
                env.update(NCCL_DEBUG="INFO",
                           NCCL_DEBUG_FILE=os.path.join(tmp, "nccl.%p.log"))
            procs.append(subprocess.Popen(
                [sys.executable, entry, path, str(r)], env=env,
                stdout=sys.stderr, cwd=spec["root"]))
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                bad = [i for i, p in enumerate(procs)
                       if p.returncode not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                    break
                if time.monotonic() > deadline:
                    failed = f"ranks still running after {timeout:.0f} s"
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        if failed is None:
            bad = [i for i, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
        log_transport(tmp)
        if failed:
            raise RuntimeError(failed)
        outs = []
        for r in range(world):
            outs.append(load_json(os.path.join(tmp, f"rank{r}.json")))
        return outs


def log_transport(tmp: str) -> None:
    """NCCL's chosen transports, from its debug files (one line each)."""
    seen = {}
    for name in sorted(os.listdir(tmp)):
        if not name.startswith("nccl."):
            continue
        with open(os.path.join(tmp, name), errors="replace") as f:
            for line in f:
                if " via " in line:
                    how = line.split(" via ", 1)[1].strip()
                    seen[how] = seen.get(how, 0) + 1
    if seen:
        log("nccl transport: " + ", ".join(f"{k} x{v}"
                                             for k, v in sorted(seen.items())))


def rank_entry(argv) -> int:
    """A spawned rank: ``<spec file> <rank>``; writes ``rank<r>.json``
    (a run, or with ``mode`` ``readings`` the calibration's readings)."""
    spec = load_json(argv[0])
    spec["rank"] = int(argv[1])
    if spec.get("mode") == "readings":
        from . import calibrate

        out = calibrate.readings_rank(spec)
    else:
        out = run_rank(spec)
    with open(os.path.join(spec["tmp"], f"rank{spec['rank']}.json"),
              "w") as f:
        json.dump(out, f)
    return 0
