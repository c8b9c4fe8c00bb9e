"""Seeded-violation fixtures — port of ``chainermn_tpu/analysis/fixtures.py``.

One deliberately broken step per rule, in the port's idiom, plus the
clean train step none of them may flag, and the deliberately CLEAN
entries (``expect=None``): ``overlap_async_pairs`` (the overlapped
bucketed step, whose ``async_op=True`` all-reduces and their waits R004
must read as one reduction each), ``quant_scaled_allreduce`` (the scaled
int8 wire, blessed structurally by its amax MAX all-reduce), and the
serving engine's device steps — ``serving_decode``, ``serving_verify``
(the chunk step that verifies drafts), ``draft_verify`` (the truncated
draft model's proposal), ``sharded_prefill`` (the ``sp`` chunk step,
whose only collectives are K/V all-gathers, never a reduction) and
``tp_decode`` (the decode step under plan ``tp``, whose DTensor
collectives stay out of R003/R004) — which must stay finding-free.

The host plane has the same corpus shape: one violating + one clean
``source=`` snippet per H-rule (``h001``…``h005_clean``), linted through
:func:`chainermn_tpu_torch.analysis.hostlint.analyze_host`.

Every R builder runs inside an initialized process group and builds at
the world it is given, on the port's communicators (an ``(inter,
intra)`` = ``(2, n/2)`` topology when the world is even, so both legs of
the two-level communicators run): ``python -m
chainermn_tpu_torch.tools.lint --fixtures --world 2`` spawns the ranks.
Most seeded violations need more than one rank to show (at world 1 the
port's ``allreduce_grad`` issues no collective); the lint golden
``tests/golden/torch_lint_fixtures.json`` is taken at world 2 on gloo.
A target carries ``state`` (what the step mutates: the capture restores
it and R002/R005 read it).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.distributed as dist

from ..communicators import create_communicator
from ..optimizers import create_multi_node_optimizer

#: the clean-gate communicator set (the reference's five, by the port's
#: factory names).
CLEAN_COMMUNICATORS = (
    "naive", "flat", "xla_ici", "hierarchical", "two_dimensional",
)


def _device() -> torch.device:
    """This rank's device: its CUDA card under NCCL, else the CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _comm(name="naive", **kw):
    """A communicator over every rank: ``(inter, intra)`` = ``(2, n/2)``
    when the world is even, the reference's fixture mesh (a world of one
    forms here when this process has none)."""
    from ..communicators.mesh_utils import ensure_process_group

    ensure_process_group(_device())
    n = dist.get_world_size()
    inter = 2 if n % 2 == 0 and n >= 2 else 1
    return create_communicator(name, device=_device(), inter_size=inter,
                               intra_size=n // inter, **kw)


class _Leafy(torch.nn.Module):
    """``n`` square weight leaves, the reference's ``_leafy_params``."""

    def __init__(self, n_leaves: int, shape=(32, 32), device="cpu"):
        super().__init__()
        self.w = torch.nn.ParameterList(
            torch.nn.Parameter(torch.ones(shape, device=device))
            for _ in range(n_leaves))

    def loss(self, batch):
        scale = (batch.float() ** 2).mean()
        return scale * sum((w * w).sum() for w in self.w)


def _leafy_step(n_leaves, comm, shape=(32, 32), **step_kw):
    model = _Leafy(n_leaves, shape, device=comm.device)
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), comm)
    opt.init()
    step = opt.make_train_step(model.loss, **step_kw)
    batch = torch.ones(comm.size * 2, 8, device=comm.device)
    return step, opt, batch


def _linear(comm):
    torch.manual_seed(0)
    return torch.nn.Linear(16, 4).to(comm.device)


def _local_slice(batch, comm):
    per = batch.shape[0] // comm.size
    return batch[comm.rank * per:(comm.rank + 1) * per]


def fixture_r001() -> dict:
    """Collective-order divergence: rank 0 alone all-reduces its
    gradients — it dispatches a collective the others never do (and the
    others apply unreduced gradients)."""
    comm = _comm("naive")
    model = _linear(comm)

    def diverging(batch):
        model.zero_grad(set_to_none=True)
        loss = (model(_local_slice(batch, comm)) ** 2).mean()
        loss.backward()
        if comm.rank == 0:
            for p in model.parameters():
                dist.all_reduce(p.grad, group=comm.group)
                p.grad.div_(comm.size)
        with torch.no_grad():
            for p in model.parameters():
                p.sub_(0.1 * p.grad)
        return loss.detach()

    batch = torch.randn(comm.size * 2, 16, device=comm.device)
    return dict(target="r001", expect="R001", fn=diverging, args=(batch,),
                kwargs={}, comm=comm, state=[model])


def fixture_r002() -> dict:
    """Unreduced gradient: a hand-rolled step that applies each rank's
    LOCAL gradients straight to the parameters — no allreduce — so the
    replicas silently diverge."""
    comm = _comm("naive")
    model = _linear(comm)

    def local_sgd_step(batch):
        model.zero_grad(set_to_none=True)
        loss = (model(_local_slice(batch, comm)) ** 2).mean()
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p.sub_(0.1 * p.grad)
        return loss.detach()

    batch = torch.randn(comm.size * 2, 16, device=comm.device)
    return dict(target="r002", expect="R002", fn=local_sgd_step,
                args=(batch,), kwargs={}, comm=comm, state=[model])


def _grad_tree(comm, dtype):
    g = torch.Generator().manual_seed(comm.rank)
    return {"a": torch.randn(256, generator=g).to(comm.device, dtype),
            "b": torch.randn(64, 8, generator=g).to(comm.device, dtype)}


def fixture_r003() -> dict:
    """Narrow-dtype reduction: bf16 gradients through ``allreduce_grad``
    with NO ``allreduce_grad_dtype`` — the sum accumulates in bf16."""
    comm = _comm("naive")

    def reduce_bf16(tree):
        return comm.allreduce_grad(list(tree.values()))

    return dict(target="r003", expect="R003", fn=reduce_bf16,
                args=(_grad_tree(comm, torch.bfloat16),), kwargs={},
                comm=comm)


def fixture_quant_scaled_allreduce() -> dict:
    """The blessed scale→cast→reduce→cast→unscale wire (CLEAN):
    ``allreduce_grad`` under ``comm_dtype="int8"`` runs a MAX all-reduce
    of the amax and then an int8 sum.  The target hands the linter NO
    communicator, so R003 must recognize the pattern structurally."""
    comm = _comm("xla_ici", comm_dtype="int8")

    def reduce_quantized(tree):
        return comm.allreduce_grad(list(tree.values()))

    return dict(target="quant_scaled_allreduce", expect=None,
                fn=reduce_quantized,
                args=(_grad_tree(comm, torch.float32),), kwargs={},
                comm=None)


def fixture_r003_bare_int8() -> dict:
    """Bare int8 reduction (fires R003): gradients cast to int8 and
    all-reduced directly, with no amax scale exchange."""
    comm = _comm("naive")

    def reduce_bare_int8(tree):
        out = {}
        for k, g in tree.items():
            q = torch.clamp(torch.round(g), -127, 127).to(torch.int8)
            dist.all_reduce(q, group=comm.group)
            out[k] = q.float()
        return out

    tree = {"g": torch.ones(128, device=comm.device)}
    return dict(target="r003_bare_int8", expect="R003", fn=reduce_bare_int8,
                args=(tree,), kwargs={}, comm=comm)


def fixture_r004() -> dict:
    """Bucketing regression: a default train step over a 16-leaf tree
    with bucketing disabled (``bucket_bytes=0``) — one all-reduce per
    leaf."""
    comm = _comm("naive", bucket_bytes=0)
    step, opt, batch = _leafy_step(16, comm)
    return dict(target="r004", expect="R004", fn=step, args=(batch,),
                kwargs={}, comm=comm, state=opt)


def fixture_r005() -> dict:
    """In-place audit: a bucketed, clean-wire step that rebinds
    ``p.data`` to a new tensor instead of updating in place — the old
    and the new parameters are both alive."""
    comm = _comm("naive")
    model = _Leafy(16, device=comm.device)

    def rebinding(batch):
        model.zero_grad(set_to_none=True)
        model.loss(_local_slice(batch, comm)).backward()
        comm.allreduce_grad([p.grad for p in model.parameters()])
        for p in model.parameters():
            p.data = p.data - 0.1 * p.grad

    batch = torch.ones(comm.size * 2, 8, device=comm.device)
    return dict(target="r005", expect="R005", fn=rebinding, args=(batch,),
                kwargs={}, comm=comm, state=[model])


def fixture_r006() -> dict:
    """Sharding-plan coverage: a plan with NO catch-all (the conv kernel
    goes unmatched) whose one rule also repeats a mesh axis in two spec
    entries — both R006 error classes from one target."""
    from ..sharding import P, PlanRule, ShardingPlan

    plan = ShardingPlan(
        name="broken_fixture",
        rules=(PlanRule("dense_twice", r"dense\.kernel$",
                        P("inter", "inter")),),
        axes=("inter",),
    )
    params = {
        "dense.kernel": (32, 32), "dense.bias": (32,),
        "conv.kernel": (3, 3, 8, 16),
        "step": (),  # scalar: auto-replicated, never a finding
    }
    return dict(target="r006", expect="R006", plan=plan, params=params,
                comm=None)


def fixture_overlap_async_pairs() -> dict:
    """The overlapped bucketed step (CLEAN): six leaves in three buckets,
    each bucket's all-reduce launched with ``async_op=True`` from the
    gradient hooks and waited on before the update.  R004 must read each
    launch and its wait as ONE reduction (3 buckets + the loss mean < 6
    leaves), never misdiagnose overlap as a bucketing regression."""
    comm = _comm("naive", bucket_bytes=8192, overlap=True)
    step, opt, batch = _leafy_step(6, comm)
    return dict(target="overlap_async_pairs", expect=None, fn=step,
                args=(batch,), kwargs={}, comm=comm, state=opt)


# ----------------------------------------------------------------------
# The serving engine's device steps (all CLEAN)
# ----------------------------------------------------------------------
_GEOM = dict(vocab=32, d_model=16, n_heads=4, d_ff=32, n_layers=1,
             max_len=16)


def _engine(plan=None, mesh=None, **cfg):
    from ..models.transformer import TransformerLM
    from ..serving import EngineConfig, InferenceEngine

    dev = _device()
    lm = TransformerLM(**_GEOM, dtype=torch.float32, device=dev, seed=0)
    lm.requires_grad_(False)
    config = EngineConfig(block_size=4, n_blocks=8, max_len=16,
                          max_batch=2, prefix_cache=False, kv_dtype="none",
                          prefill_chunk=0, **{"draft": "ngram", **cfg})
    eng = InferenceEngine(lm, config, plan=plan, mesh=mesh, device=dev)
    pages = [leaf for c in eng._cache for leaf in c.leaves().values()]
    return eng, [lm, pages]


def _decode_args():
    B, W = 2, 4
    return (np.zeros((B,), np.int64), np.zeros((B, W), np.int32),
            np.zeros((B,), np.int32))


def fixture_serving_decode() -> dict:
    """The engine's single-token decode step (CLEAN): attention over
    paged KV is per sequence, so the decode plane must stay
    collective-free."""
    eng, state = _engine()
    return dict(target="serving_decode", expect=None, fn=eng._decode_run,
                args=_decode_args(), kwargs={}, comm=None, state=state)


def fixture_serving_verify() -> dict:
    """The engine's multi-token chunk step — the program that verifies
    speculative drafts and prefills the suffix after a prefix hit
    (CLEAN): collective-free however many draft tokens ride in a row."""
    eng, state = _engine()
    B, T, W = 2, 4, 4
    args = (np.zeros((B, T), np.int64), np.zeros((B, W), np.int32),
            np.zeros((B,), np.int32))
    return dict(target="serving_verify", expect=None, fn=eng._chunk_run,
                args=args, kwargs={}, comm=None, state=state)


def fixture_draft_verify() -> dict:
    """The truncated self-draft's proposal (CLEAN): a strict subset of
    the target's layers on the request's own device, collective-free."""
    eng, state = _engine(draft="model", draft_layers=1)
    return dict(target="draft_verify", expect=None, fn=eng.propose_draft,
                args=([1, 2, 3, 4], 2), kwargs={}, comm=None, state=state)


def _sp_size() -> int:
    n, sp = dist.get_world_size(), 1
    while sp * 2 <= n and n % (sp * 2) == 0:
        sp *= 2
    return sp if sp > 1 else 0


def fixture_sharded_prefill() -> dict:
    """The ``sp`` chunk step: one row's chunk split over the ranks of an
    ``sp`` group (CLEAN).  Its only collectives are the per-layer K/V
    all-gathers and the logits gather — pure concatenations, never a
    reduction.  At world 1 it is the plain chunk step."""
    sp = _sp_size()
    eng, state = _engine(sp=sp)
    T = 4 * max(sp, 1)
    args = (np.zeros((1, T), np.int64), np.zeros((1, 4), np.int32),
            np.zeros((1,), np.int32), bool(sp))
    return dict(target="sharded_prefill", expect=None, fn=eng._chunk_run,
                args=args, kwargs={}, comm=None, state=state)


def fixture_tp_decode() -> dict:
    """The decode step under plan ``tp`` over a ``("model",)`` mesh of
    every rank (CLEAN): the DTensor placement's functional collectives
    are in the census, not in R003/R004 (the reference's partitioner
    inserts its all-reduces after tracing, out of its rules' sight)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = _device()
    mesh = init_device_mesh(dev.type, (dist.get_world_size(),),
                            mesh_dim_names=("model",))
    eng, state = _engine(plan="tp", mesh=mesh)
    return dict(target="tp_decode", expect=None, fn=eng._decode_run,
                args=_decode_args(), kwargs={}, comm=None, state=state)


# ----------------------------------------------------------------------
# Host-plane fixtures (H001–H005): one violating + one clean snippet per
# rule, linted as ``source=`` targets through hostlint.analyze_host.
# ----------------------------------------------------------------------
_H001_BAD = '''\
import threading


class Counter:
    def __init__(self):
        self.lock = threading.Lock()
        self.value = 0

    def bump(self):
        with self.lock:
            self.value += 1

    def reset(self):
        self.value = 0
'''

_H001_OK = _H001_BAD.replace(
    "    def reset(self):\n        self.value = 0\n",
    "    def reset(self):\n        with self.lock:\n"
    "            self.value = 0\n",
)

_H002_BAD = '''\
import threading
import time


class Sender:
    def __init__(self, sock):
        self._lock = threading.Lock()
        self._sock = sock

    def push(self, payload):
        with self._lock:
            time.sleep(0.05)
            self._sock.sendall(payload)
'''

_H002_OK = '''\
import threading


class Sender:
    def __init__(self, sock):
        self._lock = threading.Lock()
        self._sock = sock
        self._seq = 0

    def push(self, payload):
        with self._lock:
            seq = self._seq
            self._seq += 1
        self._sock.sendall((seq, payload))
'''

_H003_BAD = '''\
class MiniEngine:
    def __init__(self, decode_jit):
        self._cache = None
        self.mirror_sink = None
        self._decode_jit = decode_jit

    def _mirror(self, op, *payload):
        if self.mirror_sink is not None:
            self.mirror_sink(op, payload)

    def decode(self, tokens):
        out = self._decode_jit(tokens, self._cache)
        self._cache = out[1]
        self._mirror("decode", tokens)
        return out[0]
'''

_H003_OK = '''\
class MiniEngine:
    def __init__(self, decode_jit):
        self._cache = None
        self.mirror_sink = None
        self._decode_jit = decode_jit

    def _mirror(self, op, *payload):
        if self.mirror_sink is not None:
            self.mirror_sink(op, payload)

    def decode(self, tokens):
        self._mirror("decode", tokens)
        out = self._decode_jit(tokens, self._cache)
        self._cache = out[1]
        return out[0]
'''

_H004_SRC = '''\
import dataclasses


@dataclasses.dataclass(frozen=True)
class HeartbeatFrame:
    host: str
    port: int
    seq: int = 0
'''

#: lockfile claiming (host, seq, port) — the source above reordered the
#: trailing fields, which breaks positional decode on old receivers.
_H004_BAD_LOCK = {"schemas": {"dataclass:HeartbeatFrame": {
    "fields": [["host", False], ["seq", False], ["port", False]],
}}}

#: lockfile from one release earlier — the source appended ``seq`` WITH
#: a default, the sanctioned wire evolution, so nothing fires.
_H004_OK_LOCK = {"schemas": {"dataclass:HeartbeatFrame": {
    "fields": [["host", False], ["port", False]],
}}}

_H005_BAD = '''\
import random
import time


def pick_victim(blocks):
    if random.random() < 0.5:
        return blocks[0]
    return blocks[int(time.time()) % len(blocks)]
'''

_H005_OK = '''\
import numpy as np


def pick_victim(blocks, seed, step):
    rng = np.random.default_rng((seed, step))
    return blocks[int(rng.integers(len(blocks)))]
'''


def fixture_h001() -> dict:
    """Mixed guarded/bare access: ``value`` is incremented under the
    lock but reset bare — the reset can land mid-increment."""
    return dict(target="h001", expect="H001", source=_H001_BAD)


def fixture_h001_clean() -> dict:
    return dict(target="h001_clean", expect=None, source=_H001_OK)


def fixture_h002() -> dict:
    """A sleep and a socket send inside the lock — every other thread
    convoys behind network latency."""
    return dict(target="h002", expect="H002", source=_H002_BAD)


def fixture_h002_clean() -> dict:
    return dict(target="h002_clean", expect=None, source=_H002_OK)


def fixture_h003() -> dict:
    """Mirror emitted only AFTER the jit step + cache assignment — a
    follower that detaches between the two replays a shorter prefix."""
    return dict(target="h003", expect="H003", source=_H003_BAD)


def fixture_h003_clean() -> dict:
    return dict(target="h003_clean", expect=None, source=_H003_OK)


def fixture_h004() -> dict:
    """Field reorder against the lockfile: positional decode on an
    old receiver reads ``port`` where ``seq`` was promised."""
    return dict(target="h004", expect="H004", source=_H004_SRC,
                wire=True, wire_lock=_H004_BAD_LOCK)


def fixture_h004_clean() -> dict:
    return dict(target="h004_clean", expect=None, source=_H004_SRC,
                wire=True, wire_lock=_H004_OK_LOCK)


def fixture_h005() -> dict:
    """Global RNG + wall-clock in a defrag victim pick — replicas
    replaying the same op stream choose different victims."""
    return dict(target="h005", expect="H005", source=_H005_BAD, det=True)


def fixture_h005_clean() -> dict:
    return dict(target="h005_clean", expect=None, source=_H005_OK,
                det=True)


FIXTURES: Dict[str, Callable[[], dict]] = {
    "r001": fixture_r001,
    "r002": fixture_r002,
    "r003": fixture_r003,
    "r003_bare_int8": fixture_r003_bare_int8,
    "quant_scaled_allreduce": fixture_quant_scaled_allreduce,
    "r004": fixture_r004,
    "r005": fixture_r005,
    "r006": fixture_r006,
    "overlap_async_pairs": fixture_overlap_async_pairs,
    "serving_decode": fixture_serving_decode,
    "serving_verify": fixture_serving_verify,
    "sharded_prefill": fixture_sharded_prefill,
    "tp_decode": fixture_tp_decode,
    "draft_verify": fixture_draft_verify,
    "h001": fixture_h001,
    "h001_clean": fixture_h001_clean,
    "h002": fixture_h002,
    "h002_clean": fixture_h002_clean,
    "h003": fixture_h003,
    "h003_clean": fixture_h003_clean,
    "h004": fixture_h004,
    "h004_clean": fixture_h004_clean,
    "h005": fixture_h005,
    "h005_clean": fixture_h005_clean,
}

#: the fixtures that need no process group (host snippets, the plan).
LOCAL_FIXTURES = frozenset(
    {"r006"} | {n for n in FIXTURES if n.startswith("h0")})


def clean_train_step(communicator: str = "xla_ici",
                     n_leaves: int = 8) -> dict:
    """The program the whole package stands behind: a default bucketed
    ``make_train_step`` (overlap on, fp32 gradients, updates in place).
    Must lint clean on every rule for every communicator."""
    comm = _comm(communicator)
    step, opt, batch = _leafy_step(n_leaves, comm, shape=(16, 16))
    return dict(target=f"clean:{communicator}", expect=None, fn=step,
                args=(batch,), kwargs={}, comm=comm, state=opt)
