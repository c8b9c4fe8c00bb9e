"""Multi-node optimizer — the data-parallel hot path.

Port of ``chainermn_tpu/optimizers.py`` (reference: ChainerMN's
``create_multi_node_optimizer``): wrap a ``torch.optim`` optimizer; at
``init`` broadcast the parameters from rank 0; each step runs local
forward/backward, the gradient mean over the ranks and the inner
optimizer's update.

Batch contract, as in the reference's ``make_train_step``: the step takes
the GLOBAL batch, and rank ``r`` of ``n`` computes on the contiguous
slice ``r`` of its leading axis — the reference's ``P(world)`` batch
sharding, one process per rank.  ``local_batch=True`` takes this rank's
slice directly instead (what a ChainerMN process draws from its
``scatter_dataset`` shard).  ``loss_fn(local_batch)`` returns the local
mean loss; the step returns the mean of the ranks' losses.

ZeRO (the reference's ``zero_stage``; its contract is
``optimizers.py:185-211``):

* stage 1: the optimizer state lives as a 1/n shard.  The parameters are
  packed into one flat fp32 buffer padded to a multiple of the world size
  n, each in the optimizer's order and, with ``flat_layout``, permuted
  into the layout it names (:func:`convert.flax_flat_layout` gives the
  reference's leaf order and flax's layouts, so that every shard holds
  the reference's elements and LARS's per-shard trust ratio sees the
  same values); gradients arrive by reduce-scatter (the mean of this rank's shard),
  the wrapped optimizer — rebuilt from its class and its one group's
  hyperparameters over one flat shard parameter — updates the shard, and
  the updated shards are all-gathered into the parameters;
* stage 2: as stage 1, and under ``n_accum > 1`` each microbatch's
  gradients are reduce-scattered at once, so the accumulator is a shard;
* stage 3: the fp32 master parameters themselves live as the 1/n shard
  between steps.  Each step all-gathers them into one flat buffer, the
  module's parameters become views into it (casts for non-fp32
  parameters), gradients are reduce-scattered per microbatch, the shard
  is updated, and the parameters' storage is freed (a parameter held in
  another layout is a ``permute`` of its flat slice, still a view).
  :meth:`materialize`
  fills the module again (for evaluation or export).

Every stage composes with ``double_buffering`` (under ZeRO the stale
gradient is kept as a shard), ``n_accum`` and ``loss_scale``.  At stage 0
the gradient mean is launched from gradient hooks during backward when
the communicator's overlap resolves on (:mod:`.communicators.overlap`),
bit-exact with the eager path; on one rank with a full-precision wire
neither path moves a byte.

Learning-rate schedules, as optax's: ``lr_schedule(count)`` sets the
learning rate of every group before each update, ``count`` being the
number of updates applied before it (the reduce-only first step of
double buffering is none); the count is part of :meth:`state_dict`.

Model state (BatchNorm statistics): :meth:`make_train_step_with_state`
runs the forward on this rank's slice with its local batch statistics,
as the reference does (its BatchNorm has no ``axis_name``), then averages
the floating buffers over the ranks in one collective.

``CHAINERMN_TPU_LINT=1`` (or ``strict``) lints a built step at its first
call (:mod:`.analysis`; the capture leaves every tensor as it found it).

AdamW note: ``torch.optim.AdamW`` decays the parameter multiplicatively
before the Adam step, ``optax.adamw`` adds ``weight_decay * param`` to the
update before the learning-rate scale.  The two agree to fp32 rounding;
``torch.optim.AdamW`` also defaults to ``weight_decay=0.01`` where
``optax.adamw`` defaults to 1e-4, so pass every argument explicitly.
"""

from __future__ import annotations

import functools
import inspect
import os
import time
from typing import Callable, Mapping

import torch

from .communicators.base import CommunicatorBase
from .communicators.overlap import BackwardOverlap


def _tree_map(fn, batch):
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if isinstance(batch, Mapping):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_tree_map(fn, v) for v in batch)
    return batch


def _batch_leaves(batch):
    out = []
    _tree_map(out.append, batch)
    return out


def _stack_aux(auxs):
    """The microbatches' aux trees stacked leaf by leaf on a new leading
    axis (the reference's ``lax.scan`` output)."""
    first = auxs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(auxs)
    if isinstance(first, Mapping):
        return {k: _stack_aux([a[k] for a in auxs]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_aux(list(col)) for col in zip(*auxs))
    return torch.stack([torch.as_tensor(a) for a in auxs])


def rng_seed(seed: int, step: int, rank: int, micro: int = 0) -> int:
    """The generator seed of microbatch ``micro`` of step ``step`` on
    ``rank`` under ``make_train_step(rng=seed)``: one 63-bit word of
    numpy's ``SeedSequence`` over the four, so every (step, rank,
    microbatch) draws its own stream and a rerun draws the same ones.
    (The reference folds a jax key by step, device and microbatch; the
    streams differ from jax's, the contract is the same.)"""
    import numpy as np

    words = np.random.SeedSequence(
        [int(seed), int(step), int(rank), int(micro)]).generate_state(2)
    return (int(words[0]) << 32 | int(words[1])) & ((1 << 63) - 1)


def _instrument_step(step_fn, device):
    """Telemetry wrapper for a built train step: when a Reporter or
    StepRecorder is installed (``observability.telemetry_active``) each
    call runs under ``traced_step(device)``, i.e. ``span("train_step")``
    (a profiler annotation, the host's time to return and the time on
    ``device``, into both sinks), inside which the step's phases
    (``train_step/forward``, ``/backward``, ``/grad_sync``, ``/update``,
    ``/state_mean``) are device spans too, and bumps the reporter's
    ``train_step_calls`` counter.  With no telemetry installed the cost
    is one boolean check.  Nothing adds a device synchronisation."""
    from .observability import reporter as _rep
    from .observability import spans as _spans

    @functools.wraps(step_fn)
    def instrumented(*args, **kwargs):
        if not _spans.telemetry_active():
            return step_fn(*args, **kwargs)
        with _spans.traced_step(device):
            out = step_fn(*args, **kwargs)
        rep = _rep.get_reporter()
        if rep is not None:
            rep.count("train_step_calls")
        return out

    return instrumented


def _run_first_call_lint(step_fn, opt, state, mode, args, kwargs):
    """One lint pass over the step at its first call: the step runs once
    under the capture (which restores every tensor, count and RNG state it
    touched, so the real first call that follows computes what it would
    have without the hook).  Lint infrastructure failures never take
    training down: everything short of a strict-mode violation is a
    warning."""
    import warnings

    try:
        from .analysis import analyze_fn

        report = analyze_fn(step_fn, *args, comm=opt.communicator,
                            state=state, **kwargs)
    except Exception as e:  # noqa: BLE001 — a capture oddity, not a user bug
        warnings.warn(f"CHAINERMN_TPU_LINT: lint pass failed: {e!r}")
        return None
    from .observability import reporter as _rep
    from .observability import step_log as _sl

    rep = _rep.get_reporter()
    if rep is not None:
        rep.count("lint/findings", len(report.findings))
        rep.count("lint/errors", len(report.errors))
    rec = _sl.current_recorder()
    if rec is not None:
        rec.record("lint", rules_run=list(report.rules_run),
                   findings=[f.summary() for f in report.findings])
    if report.errors:
        if mode == "strict":
            from .analysis import LintError

            raise LintError(report)
        warnings.warn("CHAINERMN_TPU_LINT found problems in the train "
                      "step:\n" + report.render())
    return report


def _lint_hook(step_fn, opt, state):
    """Opt-in lint at the step's first call: ``CHAINERMN_TPU_LINT=1``
    warns and reports through the Reporter/step log (counters
    ``lint/findings``, ``lint/errors``; a ``lint`` row), ``=strict`` raises
    :class:`~.analysis.LintError`.  Unset (or ``0``/``off``/``false``),
    the step function passes through untouched; after the first call the
    cost is one list check.  The hooked step's ``lint`` dict holds the
    first call's report under ``"report"`` and the lint's wall seconds
    (capture and rules) under ``"seconds"``; the step's wrappers share
    that dict."""
    mode = os.environ.get("CHAINERMN_TPU_LINT", "").strip().lower()
    if mode in ("", "0", "off", "false"):
        return step_fn
    done = []

    @functools.wraps(step_fn)
    def linted(*args, **kwargs):
        if not done:
            done.append(True)
            t0 = time.perf_counter()
            linted.lint["report"] = _run_first_call_lint(
                step_fn, opt, state, mode, args, kwargs)
            linted.lint["seconds"] = time.perf_counter() - t0
        return step_fn(*args, **kwargs)

    linted.lint = {}
    return linted


def _check_batch_divisibility(batch, n_dev, n_accum=1):
    quantum = n_dev * n_accum
    for leaf in _batch_leaves(batch):
        if leaf.dim() and leaf.shape[0] % quantum:
            raise ValueError(
                f"global batch axis ({leaf.shape[0]}) must be divisible by "
                f"device count x n_accum ({n_dev} x {n_accum} = {quantum}); "
                f"pad or drop the remainder"
            )


def _slice(x, i, n):
    per = x.shape[0] // n
    return x[i * per:(i + 1) * per]


class MultiNodeOptimizer:
    """Wrap a ``torch.optim.Optimizer`` with distributed gradient
    averaging and the reference's ZeRO stages.

    ``double_buffering``: step ``t`` applies step ``t-1``'s averaged
    gradients (the first step only reduces and leaves the parameters
    unchanged) — the reference's one-step-stale semantics.
    ``lr_schedule``: the learning rate as a function of the update count
    (an optax schedule's contract).  ``flat_layout`` (ZeRO): one entry
    per parameter, in the wrapped optimizer's order, ``None`` or the
    permutation of its dimensions that its segment of the flat buffer
    holds."""

    def __init__(self, actual_optimizer: torch.optim.Optimizer,
                 communicator: CommunicatorBase,
                 double_buffering: bool = False, zero_stage: int = 0,
                 lr_schedule: Callable[[int], float] | None = None,
                 flat_layout=None):
        if zero_stage not in (0, 1, 2, 3):
            raise ValueError("zero_stage must be 0, 1, 2 or 3")
        self.actual_optimizer = actual_optimizer
        self.communicator = communicator
        self.double_buffering = double_buffering
        self.zero_stage = zero_stage
        self.lr_schedule = lr_schedule
        self.step_count = 0
        self.update_count = 0
        self._params = [p for group in actual_optimizer.param_groups
                        for p in group["params"] if p.requires_grad]
        self._stale = None      # double buffering: last step's mean grads
        self._overlap = None    # stage 0: the hooks of the built step
        self._shard = None      # ZeRO: this rank's flat fp32 shard
        self._inner = None      # ZeRO: the optimizer rebuilt over it
        self._target = None     # setup(): the module
        self._step_fn = None
        if zero_stage:
            perms = ([None] * len(self._params) if flat_layout is None
                     else [None if q is None else tuple(q)
                           for q in flat_layout])
            if len(perms) != len(self._params):
                raise ValueError(
                    f"flat_layout has {len(perms)} entries for "
                    f"{len(self._params)} parameters")
            self._perms = perms
            # Each segment's shape in the flat buffer, and the permutation
            # that takes it back to the parameter's own dimensions.
            self._shapes = [p.shape if q is None else
                            torch.Size(p.shape[d] for d in q)
                            for p, q in zip(self._params, perms)]
            self._unperms = [None if q is None else
                             tuple(sorted(range(len(q)), key=q.__getitem__))
                             for q in perms]
            self._sizes = [p.numel() for p in self._params]
            n = communicator.size
            total = sum(self._sizes)
            self._shard_size = (total + (-total) % n) // n

    @property
    def params(self):
        return list(self._params)

    def init(self):
        """Replicate the parameters from rank 0 (the reference's
        first-update ``broadcast_data``); under ZeRO build the shard and
        the optimizer over it, and under stage 3 keep the master as the
        shard from here on."""
        self.communicator.broadcast_data(self._params)
        self.step_count = self.update_count = 0
        self._stale = None
        if self.zero_stage:
            self._shard = torch.nn.Parameter(
                self._my_shard(self._pack_params()).clone())
            self._inner = self._rebuild_inner()
            if self.zero_stage == 3:
                self._release_params()

    def broadcast_params(self, params=None):
        """Replace every rank's values of ``params`` (a module, a sequence
        or a mapping of tensors; default: the wrapped optimizer's
        parameters) with rank 0's, in place, and return them (the
        reference's on-demand replication from process 0).  Collective."""
        return self.communicator.broadcast_data(
            self._params if params is None else params)

    def _schedule_lr(self):
        """Before an update: the scheduled learning rate into every group
        of the wrapped optimizer (ZeRO copies it to the rebuilt one)."""
        if self.lr_schedule is not None:
            lr = float(self.lr_schedule(self.update_count))
            for group in self.actual_optimizer.param_groups:
                group["lr"] = lr
        self.update_count += 1

    # -- ZeRO plumbing ---------------------------------------------------
    def _rebuild_inner(self) -> torch.optim.Optimizer:
        groups = [{k: v for k, v in g.items() if k != "params"}
                  for g in self.actual_optimizer.param_groups]
        if any(g != groups[0] for g in groups[1:]):
            raise ValueError(
                "zero_stage > 0 rebuilds the optimizer over one flat shard "
                "and needs one set of hyperparameters; got param groups "
                "that differ")
        cls = type(self.actual_optimizer)
        accepted = inspect.signature(cls.__init__).parameters
        inner = cls([self._shard], **{k: v for k, v in groups[0].items()
                                      if k in accepted})
        inner.param_groups[0].update(groups[0])
        return inner

    def _pad(self):
        return self._shard_size * self.communicator.size - sum(self._sizes)

    def _pack(self, tensors):
        """Tensors (the parameters' shapes) -> one flat fp32 buffer in the
        flat layout, padded to shard x world."""
        parts = [(t if q is None else t.permute(q)).reshape(-1).float()
                 for t, q in zip(tensors, self._perms)]
        pad = self._pad()
        if pad:
            parts.append(parts[0].new_zeros(pad))
        return torch.cat(parts)

    def _pack_params(self):
        with torch.no_grad():
            return self._pack([p.detach() for p in self._params])

    def _my_shard(self, flat):
        s, r = self._shard_size, self.communicator.rank
        return flat[r * s:(r + 1) * s]

    def _gather_flat(self, copy: bool):
        shard = self._shard.detach()
        if self.communicator.size == 1:
            return shard.clone() if copy else shard
        return self.communicator.allgather(shard, tiled=True)

    def _fill_params(self, flat, views: bool):
        """Unpack ``flat`` into the parameters: as views into it (stage 3),
        or copied into their own storage (stages 1 and 2)."""
        off = 0
        with torch.no_grad():
            for p, shape, size, unperm in zip(self._params, self._shapes,
                                              self._sizes, self._unperms):
                v = flat[off:off + size].view(shape)
                if unperm is not None:
                    v = v.permute(unperm)
                off += size
                if views:
                    p.data = v if p.dtype == torch.float32 else v.to(p.dtype)
                else:
                    p.copy_(v)

    def _release_params(self):
        for p in self._params:
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
            p.grad = None

    def _scatter_grads(self):
        """This rank's shard of the mean of the local gradients (fp32),
        after the optional ``allreduce_grad_dtype`` cast; clears them."""
        comm = self.communicator
        with torch.no_grad():
            flat = self._pack([torch.zeros_like(p) if p.grad is None
                               else p.grad for p in self._params])
            for p in self._params:
                p.grad = None
            if comm.allreduce_grad_dtype is not None:
                flat = flat.to(comm.allreduce_grad_dtype)
            part = flat if comm.size == 1 else comm.reduce_scatter(flat)
            return (part / comm.size).float()

    def _zero_update(self, gshard, loss_scale):
        if self.double_buffering:
            stale, self._stale = self._stale, gshard
            if stale is None:            # first step: reduce only
                return
            gshard = stale
        if loss_scale is not None:
            gshard = gshard / loss_scale
        if self.zero_stage < 3:
            # Stages 1 and 2 keep no master: the shard is re-read from the
            # (replicated) parameters, as the reference does.
            with torch.no_grad():
                self._shard.copy_(self._my_shard(self._pack_params()))
        self._schedule_lr()
        inner = self._inner
        for k, v in self.actual_optimizer.param_groups[0].items():
            if k != "params":
                inner.param_groups[0][k] = v
        self._shard.grad = gshard
        inner.step()
        self._shard.grad = None
        if self.zero_stage < 3:
            self._fill_params(self._gather_flat(copy=False), views=False)

    def shard_params(self) -> torch.Tensor:
        """Stage 3: pack the module's parameters into the master shard
        (when they hold data), free them, and return this rank's flat fp32
        shard — the state that lives between steps."""
        if self.zero_stage != 3:
            raise ValueError("shard_params is only meaningful for zero_stage=3")
        if self._shard is None:
            raise RuntimeError("call init() before shard_params()")
        if all(p.numel() == s for p, s in zip(self._params, self._sizes)):
            with torch.no_grad():
                self._shard.copy_(self._my_shard(self._pack_params()))
            self._release_params()
        return self._shard.detach()

    def materialize(self, module: torch.nn.Module | None = None):
        """Fill the parameters with the current values (under stage 3,
        all-gathered from the shards; collective) and return ``module``'s
        ``state_dict``, or the parameters when no module is given."""
        if self.zero_stage == 3:
            if self._shard is None:
                raise RuntimeError("call init() before materialize()")
            self._fill_params(self._gather_flat(copy=True), views=True)
        module = module if module is not None else self._target
        if isinstance(module, torch.nn.Module):
            return module.state_dict()
        return self.params

    # -- the step --------------------------------------------------------
    def make_train_step(self, loss_fn: Callable, n_accum: int = 1,
                        loss_scale: float | None = None,
                        overlap: bool | None = None,
                        local_batch: bool = False,
                        has_aux: bool = False, rng: int | None = None):
        """Build ``step(batch) -> loss`` (``(loss, aux)`` with ``has_aux``).

        ``n_accum > 1`` splits this rank's slice into that many equal
        microbatches; their gradients are summed and divided by
        ``n_accum`` (the reference's mean of microbatch gradients).
        ``loss_scale`` multiplies the loss before backward; gradients stay
        scaled through the collective and are unscaled once, just before
        the update.  The returned loss is unscaled.  ``overlap`` pins the
        backward-overlapped launch for this step (``None`` = the
        communicator's; it is inert under ZeRO, as in the reference).
        ``local_batch`` says that ``batch`` is this rank's slice.

        ``has_aux``: ``loss_fn`` returns ``(loss, aux)``; the step returns
        ``(loss, aux)`` with this rank's aux detached, stacked on a leading
        ``n_accum`` axis when ``n_accum > 1``.  ``rng`` (an integer seed):
        ``loss_fn(batch, generator)`` gets a ``torch.Generator`` on the
        parameters' device seeded with :func:`rng_seed` of (``rng``, the
        step count, this rank, the microbatch) — per-rank dropout that a
        rerun reproduces."""
        return _instrument_step(_lint_hook(self._build_step(
            loss_fn, n_accum, loss_scale, overlap, local_batch, has_aux, rng),
            self, [self]), self._device())

    def _device(self) -> torch.device:
        """The device the step runs on: the parameters'."""
        if self._params:
            return self._params[0].device
        return self.communicator.device

    def _build_step(self, loss_fn, n_accum, loss_scale, overlap,
                    local_batch, has_aux, rng):
        from .observability.spans import step_span

        if n_accum < 1:
            raise ValueError(f"n_accum must be >= 1, got {n_accum}")
        comm = self.communicator
        stage = self.zero_stage
        gen = None
        if rng is not None:
            gen = torch.Generator(device=self._device())
        if stage and self._shard is None:
            raise RuntimeError("zero_stage > 0: call init() first")
        hooks = None
        if self._overlap is not None:
            self._overlap.remove()
            self._overlap = None
        if (stage == 0 and len(self._params) > 1
                and comm.resolve_bucket_bytes(self._params) > 0):
            wire = comm.wire_dtype(self._params)
            if comm.resolve_overlap(overlap) and (comm.size > 1
                                                 or wire is not None):
                hooks = self._overlap = BackwardOverlap(
                    comm, self._params,
                    comm.resolve_overlap_granularity(self._params),
                    wire)
        per_micro_scatter = stage == 3 or (stage == 2 and n_accum > 1)

        def step(batch):
            _check_batch_divisibility(batch, 1 if local_batch else comm.size,
                                      n_accum)
            params = self._params
            if stage == 3:
                self._fill_params(self._gather_flat(copy=False), views=True)
            for p in params:
                p.grad = None
            mine = batch if local_batch else _tree_map(
                lambda x: _slice(x, comm.rank, comm.size), batch)
            loss_sum = gacc = None
            auxs = []
            for i in range(n_accum):
                mb = _tree_map(lambda x: _slice(x, i, n_accum), mine)
                if hooks is not None and i == n_accum - 1:
                    hooks.arm(n_accum)
                with step_span("train_step/forward"):
                    if gen is None:
                        loss = loss_fn(mb)
                    else:
                        gen.manual_seed(
                            rng_seed(rng, self.step_count, comm.rank, i))
                        loss = loss_fn(mb, gen)
                    if has_aux:
                        loss, aux = loss
                        auxs.append(_tree_map(torch.Tensor.detach, aux))
                    scaled = loss if loss_scale is None else loss * loss_scale
                    loss = loss.detach().float()
                    loss_sum = loss if loss_sum is None else loss_sum + loss
                with step_span("train_step/backward"):
                    scaled.backward()
                if per_micro_scatter:
                    with step_span("train_step/grad_sync"):
                        g = self._scatter_grads()
                        gacc = g if gacc is None else gacc + g
            with step_span("train_step/grad_sync"):
                loss = loss_sum / n_accum
                if has_aux:
                    aux = auxs[0] if n_accum == 1 else _stack_aux(auxs)
                if stage:
                    if per_micro_scatter:
                        gshard = gacc / n_accum if n_accum > 1 else gacc
                    else:
                        if n_accum > 1:
                            for p in params:
                                if p.grad is not None:
                                    p.grad.div_(n_accum)
                        gshard = self._scatter_grads()
                elif hooks is not None:
                    hooks.finish()
                    grads = [p.grad for p in params]
                else:
                    grads = []
                    for p in params:
                        if p.grad is None:
                            p.grad = torch.zeros_like(p)
                        if n_accum > 1:
                            p.grad.div_(n_accum)
                        grads.append(p.grad)
                    comm.allreduce_grad(grads)
                if comm.size > 1:
                    loss = comm.allreduce(loss.reshape(1).to(comm.device),
                                          "mean")[0]
            self.step_count += 1
            with step_span("train_step/update"):
                self._update(params, grads if not stage else None,
                             gshard if stage else None, loss_scale)
            return (loss, aux) if has_aux else loss

        return step

    def _update(self, params, grads, gshard, loss_scale):
        """The step's tail: the ZeRO shard update, or the stage-0 update
        of ``grads`` (the stale ones under double buffering)."""
        if self.zero_stage:
            self._zero_update(gshard, loss_scale)
            if self.zero_stage == 3:
                self._release_params()
            return
        if self.double_buffering:
            stale, self._stale = self._stale, grads
            if stale is None:            # first step: reduce only
                for p in params:
                    p.grad = None
                return
            for p, g in zip(params, stale):
                p.grad = g
        if loss_scale is not None:
            for p in params:
                p.grad.div_(loss_scale)
        self._schedule_lr()
        self.actual_optimizer.step()

    def make_train_step_with_state(self, loss_fn: Callable,
                                   model_state: torch.nn.Module,
                                   overlap: bool | None = None,
                                   local_batch: bool = False):
        """Build ``step(batch) -> loss`` for a model with non-trainable
        state (BatchNorm statistics; the reference's ``batch_stats``).

        ``loss_fn(local_batch)`` runs the forward in train mode, which
        normalises with this rank's batch statistics and updates the
        buffers of the module ``model_state`` in place.  After the step the floating buffers are averaged over
        the ranks, packed into one collective per dtype; integer buffers
        stay as they are.  The returned loss is the mean over the ranks.
        Every ZeRO stage, the backward overlap and ``double_buffering``
        apply as in :meth:`make_train_step`; under double buffering step
        ``t`` applies step ``t-1``'s gradients while the buffers update
        from step ``t``.  Gradient accumulation is not exposed, as in the
        reference."""
        from .observability.spans import step_span

        step = self._build_step(loss_fn, 1, None, overlap, local_batch,
                                False, None)
        floating = [b for b in model_state.buffers()
                    if b.is_floating_point()]

        def step_with_state(batch):
            loss = step(batch)
            with step_span("train_step/state_mean"):
                self._mean_over_ranks(floating)
            return loss

        return _instrument_step(_lint_hook(step_with_state, self,
                                           [self, model_state]),
                                self._device())

    def _mean_over_ranks(self, tensors):
        """Replace each tensor by its mean over the ranks, one collective
        per dtype (none at one rank)."""
        comm = self.communicator
        if comm.size == 1 or not tensors:
            return
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        with torch.no_grad():
            for group in by_dtype.values():
                flat = comm.allreduce(
                    torch.cat([t.reshape(-1) for t in group]), "mean")
                off = 0
                for t in group:
                    t.copy_(flat[off:off + t.numel()].view_as(t))
                    off += t.numel()

    # -- checkpoint state ------------------------------------------------
    def state_dict(self) -> dict:
        """Step and update counts (the schedule's count), the inner
        optimizer's state, the stale gradient (double buffering) and, under
        stage 3, this rank's master shard."""
        inner = self._inner if self.zero_stage else self.actual_optimizer
        sd = {"step": self.step_count, "updates": self.update_count,
              "inner": inner.state_dict(), "stale": self._stale}
        if self.zero_stage == 3:
            sd["shard"] = self._shard.detach()
        return sd

    def load_state_dict(self, sd: dict) -> None:
        inner = self._inner if self.zero_stage else self.actual_optimizer
        inner.load_state_dict(sd["inner"])
        self.step_count = int(sd["step"])
        self.update_count = int(sd["updates"])
        stale = sd.get("stale")
        if stale is None:
            self._stale = None
        elif self.zero_stage:
            self._stale = stale.to(self._shard.device, torch.float32)
        else:
            self._stale = [t.to(p.device, p.dtype)
                           for t, p in zip(stale, self._params)]
        if self.zero_stage == 3:
            with torch.no_grad():
                self._shard.copy_(sd["shard"])

    # -- imperative API (ChainerMN's optimizer.setup(model); update()) ---
    def setup(self, target, loss_fn: Callable, *, n_accum: int = 1,
              loss_scale: float | None = None, has_aux: bool = False,
              rng: int | None = None):
        """``target`` is the module whose parameters the wrapped optimizer
        holds; broadcasts them once and builds the step (``has_aux`` and
        ``rng`` as in :meth:`make_train_step`)."""
        self._target = target
        self.init()
        self._step_fn = self.make_train_step(
            loss_fn, n_accum=n_accum, loss_scale=loss_scale,
            has_aux=has_aux, rng=rng)
        return self

    def update(self, batch):
        """One step on ``batch``; returns the loss, or ``(loss, aux)``
        when :meth:`setup` was given ``has_aux``."""
        if self._step_fn is None:
            raise RuntimeError("call setup(target, loss_fn) before update()")
        return self._step_fn(batch)

    @property
    def target(self):
        """The module (reference: ``optimizer.target``); under stage 3 its
        parameters are all-gathered first."""
        if self.zero_stage == 3 and self._shard is not None:
            self.materialize()
        return self._target

    @property
    def t(self) -> int:
        return self.step_count


def create_multi_node_optimizer(
        actual_optimizer: torch.optim.Optimizer,
        communicator: CommunicatorBase, double_buffering: bool = False,
        zero_stage: int = 0,
        lr_schedule: Callable[[int], float] | None = None,
        flat_layout=None) -> MultiNodeOptimizer:
    """Reference-parity factory (ChainerMN's ``create_multi_node_optimizer``);
    ``lr_schedule`` carries what an optax schedule carries in the
    reference's optimizer, ``flat_layout`` the ZeRO buffer's layout."""
    return MultiNodeOptimizer(actual_optimizer, communicator,
                              double_buffering=double_buffering,
                              zero_stage=zero_stage, lr_schedule=lr_schedule,
                              flat_layout=flat_layout)
