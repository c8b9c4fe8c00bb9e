"""Worker-side elastic runtime — the port of
``chainermn_tpu/elastic/worker.py``, the rank half of the supervisor
contract.

A supervised rank receives its identity through the environment
(``CHAINERMN_TPU_ELASTIC_*``); :func:`init_from_env` reads it, forms the
``torch.distributed`` group at the coordinator address with bounded
retries and backoff (a half-started coordinator must surface as an error,
never a hang), installs the crash hook (whose postmortem row the
supervisor reads) and a SIGTERM handler that records preemption instead of
dying mid-collective, and arms the chaos engine when a fault schedule is
present.

Training loops drive three methods:

* :meth:`ElasticContext.beat` once per step — fires due chaos faults,
  then touches the heartbeat file the supervisor watches;
* :meth:`ElasticContext.check_preemption` — an object-plane all-reduce of
  the SIGTERM flag, so ONE preempted rank moves ALL ranks into the
  grace-window checkpoint together (a lone rank cannot checkpoint
  consistently);
* :meth:`ElasticContext.exit_preempted` — flush and exit with
  ``EXIT_PREEMPTED`` so the supervisor counts a preemption, not a crash.

:meth:`ElasticContext.reshard` is the rescale half: resolve a named
``ShardingPlan`` against the *current* world and re-place restored
parameters and moments through it.

Backend and device: NCCL serves ``cuda:{rank % device_count}``, one rank a
card, and gloo serves only a caller who asked for the CPU.  NCCL cannot
place two ranks on one card, so a world with more ranks than the machine
has cards raises, naming both counts.  This module imports torch only
inside its functions: the supervisor imports the package.
"""

from __future__ import annotations

import datetime
import os
import signal
import sys
import time
from typing import Optional

from . import chaos as chaos_mod
from .heartbeat import FileBeat
from .supervisor import EXIT_PREEMPTED

ENV_ACTIVE = "CHAINERMN_TPU_ELASTIC"


def active() -> bool:
    """True when this process runs under the elastic supervisor."""
    return os.environ.get(ENV_ACTIVE) == "1"


class ElasticContext:
    def __init__(self, rank: int, nproc: int, coordinator: str,
                 incarnation: int, heartbeat: Optional[FileBeat],
                 chaos_engine):
        self.rank = rank
        self.nproc = nproc
        self.coordinator = coordinator
        self.incarnation = incarnation
        self.heartbeat = heartbeat
        self.chaos = chaos_engine
        self._preempted = False

    # -- per-step ------------------------------------------------------
    def beat(self, step: int) -> None:
        from .. import global_except_hook

        global_except_hook.set_current_step(step)
        if self.chaos is not None:
            self.chaos.on_step(step)
        if self.heartbeat is not None:
            self.heartbeat.beat(step)

    @property
    def preempted(self) -> bool:
        return self._preempted

    def check_preemption(self, comm) -> bool:
        """Did ANY rank receive SIGTERM?  Collective: every rank calls it
        at the same step so the grace-window checkpoint is coordinated."""
        if comm is None or comm.size <= 1:
            return self._preempted
        return bool(comm.allreduce_obj(int(self._preempted)))

    def exit_preempted(self) -> None:
        """Exit with the preemption code.  ``os._exit`` on purpose: every
        rank leaves right after a blocking checkpoint save, and no atexit
        teardown (the process group's included) may outlive the
        supervisor's grace window."""
        sys.stdout.flush()
        sys.stderr.flush()
        if self.rank == 0 and self.nproc > 1:
            # Rank 0 holds the group's store: leaving first cuts every
            # peer's connection mid-exit.  Give them a head start; the
            # supervisor treats stragglers' deaths as preemption
            # collateral regardless.
            time.sleep(1.0)
        os._exit(EXIT_PREEMPTED)

    # -- checkpoint integration ---------------------------------------
    def attach_checkpointer(self, ckpt) -> None:
        """Arm checkpoint-path chaos faults (corrupt/torn/slow) on this
        rank's checkpointer.  No-op without a schedule."""
        if self.chaos is not None:
            self.chaos.wrap_checkpointer(ckpt)

    # -- rescale -------------------------------------------------------
    def reshard(self, params, opt_state, comm, plan: str = "dp",
                place: bool = True, mesh=None):
        """Re-place restored state for the CURRENT world through a named
        sharding plan.  Returns ``(params, opt_state, validation)``; the
        :class:`~chainermn_tpu_torch.sharding.PlanValidation` is the
        checkable proof that the layout is legal on this world (every
        leaf matched, no axis conflicts).

        ``params``: an ``nn.Module`` (or a name → tensor mapping);
        ``opt_state``: ``None``, a ``torch.optim`` optimizer over those
        parameters, or a multi-node optimizer (its wrapped one).
        ``mesh``: a ``DeviceMesh`` with the plan's axes; by default the
        plan's one axis over the communicator's world (a plan over more
        axes needs one).  A leaf whose spec replicates stays a plain
        tensor on the rank's device; a sharded one becomes a DTensor at
        :func:`~chainermn_tpu_torch.sharding.plan.placements_for`'s
        placements.  ``place=False`` validates only."""
        from ..sharding import get_plan, validate
        from ..sharding.plan import mesh_axis_sizes

        p = get_plan(plan)
        if mesh is not None:
            sizes = mesh_axis_sizes(mesh)
        elif len(p.axes) <= 1:
            sizes = {a: comm.size for a in p.axes}
        else:
            raise ValueError(
                f"plan {plan!r} shards over {p.axes}: pass the DeviceMesh "
                "as mesh=")
        report = validate(p, params, mesh=sizes)
        if not report.ok:
            raise ValueError(
                "elastic reshard: plan does not cover the restored "
                "state on the new world:\n" + report.render()
            )
        if not place:
            return params, opt_state, report
        inner = getattr(opt_state, "actual_optimizer", opt_state)
        placer = _Placer(comm, sizes, mesh)
        if inner is not None:
            placer.moments(inner, p, params)
        moved = placer.params(params, p.resolve(params))
        if inner is not None and moved:
            # The optimizer holds the parameters it was built over: point
            # its groups and state at their replacements.
            for g in inner.param_groups:
                g["params"] = [moved.get(t, t) for t in g["params"]]
            for old, new in moved.items():
                if old in inner.state:
                    inner.state[new] = inner.state.pop(old)
        return params, opt_state, report


class _Placer:
    """Puts each leaf where its spec says: a replicated leaf on the rank's
    device, a sharded one as a DTensor over the mesh (built at first
    need)."""

    def __init__(self, comm, sizes, mesh):
        self.comm = comm
        self.sizes = sizes
        self.mesh = mesh

    def leaf(self, value, spec):
        import torch

        from ..sharding.plan import placements_for, spec_axes

        if not isinstance(value, torch.Tensor) or value.dim() == 0:
            return value
        if not spec_axes(spec):
            return value.to(self.comm.device)
        from torch.distributed.tensor import distribute_tensor

        if self.mesh is None:
            from ..parallel.sharding import build_device_mesh

            axes = tuple(self.sizes)
            self.mesh = build_device_mesh(
                self.comm, tuple(self.sizes[a] for a in axes), axes,
                device=self.comm.device.type)
        return distribute_tensor(
            value.detach().to(self.comm.device), self.mesh,
            placements_for(spec, self.mesh.mesh_dim_names))

    def params(self, params, specs) -> dict:
        """Place every parameter; returns ``{old: new}`` for each module
        parameter that was replaced."""
        import torch

        if not hasattr(params, "named_parameters"):
            for name in list(params):
                params[name] = self.leaf(params[name], specs[name])
            return {}
        moved = {}
        for name, t in list(params.named_parameters()):
            new = self.leaf(t.detach(), specs[name])
            if new.data_ptr() == t.data_ptr() and type(new) is torch.Tensor:
                continue
            mod_name, _, attr = name.rpartition(".")
            mod = params.get_submodule(mod_name) if mod_name else params
            moved[t] = torch.nn.Parameter(new, requires_grad=t.requires_grad)
            setattr(mod, attr, moved[t])
        return moved

    def moments(self, optimizer, plan, params) -> None:
        """Each moment at its parameter's moment spec, replaced in the
        optimizer's live state."""
        from ..sharding.plan import moment_entries

        names = params if hasattr(params, "named_parameters") else None
        specs = plan.resolve_moments(optimizer, names)
        sd = optimizer.state_dict()
        index = [i for g in sd["param_groups"] for i in g["params"]]
        live = dict(zip(index, (t for g in optimizer.param_groups
                                for t in g["params"])))
        for (name, _), i in zip(moment_entries(optimizer, names),
                                sd["state"]):
            state = optimizer.state[live[i]]
            for key in list(state):
                state[key] = self.leaf(state[key], specs[name][key])


def init_from_env(install_hooks: bool = True,
                  device="cuda") -> Optional[ElasticContext]:
    """Join the supervised world, or return None when not supervised (so
    ``--elastic`` examples run as plain runs).

    Must run BEFORE the communicator is created: it forms the process
    group the communicator then finds.  ``device``: ``"cuda"`` (NCCL,
    this rank's card) or ``"cpu"`` (gloo), as the caller asked."""
    if not active():
        return None
    rank = int(os.environ["CHAINERMN_TPU_ELASTIC_RANK"])
    nproc = int(os.environ["CHAINERMN_TPU_ELASTIC_NPROC"])
    coord = os.environ["CHAINERMN_TPU_ELASTIC_COORD"]
    incarnation = int(
        os.environ.get("CHAINERMN_TPU_ELASTIC_INCARNATION", "0")
    )
    init_timeout = float(
        os.environ.get("CHAINERMN_TPU_ELASTIC_INIT_TIMEOUT_S", "120")
    )

    early_term = {"fired": False}
    if install_hooks:
        # A resize can SIGTERM this rank between exec and the real
        # handler below (which goes in once the group has formed).
        # Record instead of dying, so the early window doesn't turn a
        # rescale into a -SIGTERM crash.
        signal.signal(
            signal.SIGTERM,
            lambda signum, frame: early_term.__setitem__("fired", True),
        )

    hb = None
    hb_path = os.environ.get("CHAINERMN_TPU_ELASTIC_HB_FILE")
    if hb_path:
        # Which plane and lease this rank serves rides the beat payload;
        # absent variables keep the bare format.
        hb = FileBeat(
            hb_path,
            plane=os.environ.get("CHAINERMN_TPU_ELASTIC_PLANE", ""),
            lease_id=os.environ.get("CHAINERMN_TPU_ELASTIC_LEASE", ""),
            world=nproc,
        )
    engine = chaos_mod.engine_from_env(rank, incarnation, heartbeat=hb)

    if install_hooks:
        from .. import global_except_hook

        global_except_hook.add_hook()

    _distributed_init(coord, nproc, rank, init_timeout, device)
    ctx = ElasticContext(rank, nproc, coord, incarnation, hb, engine)

    if install_hooks:
        def on_term(signum, frame):
            # Record only: the training loop propagates the flag through
            # check_preemption and checkpoints at a step boundary — never
            # from inside a signal handler.
            ctx._preempted = True

        signal.signal(signal.SIGTERM, on_term)
        if early_term["fired"]:
            ctx._preempted = True
    if hb is not None:
        hb.beat(-1)  # prove liveness before the first training step
    return ctx


def _distributed_init(coord: str, nproc: int, rank: int, timeout_s: float,
                      device="cuda"):
    """``init_process_group`` at ``tcp://{coord}`` with bounded retries and
    backoff — a respawned incarnation can race the previous one's release
    of the port, and that must cost a retry, not a hang.  The
    communicator built next finds the group formed."""
    import torch
    import torch.distributed as dist

    from .._device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if nproc > n:
            raise RuntimeError(
                f"elastic: a world of {nproc} ranks over NCCL needs {nproc} "
                f"cards (one rank a card), and this machine has {n}")
        dev = torch.device("cuda", rank % n)
        torch.cuda.set_device(dev)
        # The communicator places this rank on cuda:LOCAL_RANK.
        os.environ["LOCAL_RANK"] = str(dev.index)
        backend = "nccl"
    else:
        backend = "gloo"
    if dist.is_initialized():
        return
    timeout = datetime.timedelta(seconds=max(10.0, timeout_s))
    delay, attempts = 0.2, 3
    for attempt in range(attempts + 1):
        try:
            dist.init_process_group(
                backend, init_method=f"tcp://{coord}", rank=rank,
                world_size=nproc, timeout=timeout)
            break
        except Exception:  # noqa: BLE001 — retried, then raised
            if dist.is_initialized():
                dist.destroy_process_group()
            if attempt >= attempts:
                raise
            time.sleep(delay)
            delay = min(delay * 2, 5.0)
