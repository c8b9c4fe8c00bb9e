"""Vocab-parallel (Megatron-style) embedding and cross-entropy — the
vocab-parallel half of ``chainermn_tpu/parallel/sharding.py``.

Each rank of a communicator (the reference's ``axis_name``) holds a
contiguous slice of the vocabulary: rank ``i`` owns ids ``[i V/n,
(i+1) V/n)`` of the embedding table, which is also the tied LM head.
Each function is a ``torch.autograd.Function`` with its collectives
written out in both directions, as the reference's ``custom_vjp``s are:

* :func:`vocab_parallel_embed`: each rank looks up the ids it owns
  (zeros elsewhere) and one sum-allreduce assembles the activations.
  Backward: the ownership-masked scatter of the cotangent into the local
  rows; with ``grad_reduce=True`` (the sequence-parallel contract, where
  each rank consumes a different slice of the output) the cotangent is
  summed over the ranks first.
* :func:`gather_seq_for_replicated_head`: all-gather of a sequence shard
  whose backward SLICES the (replicated) cotangent instead of summing it.
* :func:`vocab_parallel_cross_entropy`: the chunked scan of
  :mod:`chainermn_tpu_torch.ops.fused_ce` with a strategy that merges the
  row max (max-allreduce), sum-exp and picked logit (two sum-allreduces)
  per chunk, and sums ``dh`` over the ranks in the backward.

Every rank of the communicator calls each function, and each takes the
result into its backward.

The GSPMD half (the reference's ``transformer_param_spec`` and
``make_gspmd_train_step``) runs on DTensor: a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions plays
the reference's ``Mesh``, a plan's specs become ``Shard``/``Replicate``
placements, and DTensor's sharding propagation inserts the collectives
XLA inserts from the annotations (``Partial`` → ``Replicate`` is the
all-reduce, ``Partial`` → ``Shard`` the reduce-scatter).  Three things
XLA does that DTensor does not are written out here:

* every submodule's output is pinned to the batch layout (dim 0 over
  the data axis, replicated over the others).  DTensor's per-op choice
  would otherwise reduce-scatter a row-parallel output over ``model``
  and then gather the next layer's weights, turning tensor parallelism
  into weight gathering;
* the hand kernels are opaque to DTensor: :func:`local_heads` runs an
  attention function on each rank's local heads (and batch rows)
  through ``local_map``, and :func:`batch_mean` runs a per-row mean
  loss (the fused CE) on each data shard with whole weights;
* the optimizer runs at the moment placement: each gradient is
  redistributed there (an all-reduce, or a reduce-scatter into the
  ``zero`` plan's shards) and the updated shards are gathered back to
  the parameter placement where the two differ.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import torch

from ..ops.fused_ce import _validate_and_flatten, ce_scan_bwd, ce_scan_fwd


class _VocabParallelEmbed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tokens, embedding_shard, comm, grad_reduce):
        v_loc = embedding_shard.shape[0]
        local = tokens.long() - comm.rank * v_loc
        in_range = (local >= 0) & (local < v_loc)
        idx = local.clamp(0, v_loc - 1)
        emb = embedding_shard[idx]
        emb = torch.where(in_range[..., None], emb, torch.zeros_like(emb))
        ctx.save_for_backward(idx, in_range)
        ctx.comm, ctx.grad_reduce = comm, grad_reduce
        ctx.shape = embedding_shard.shape
        return comm.allreduce(emb, "sum")

    @staticmethod
    def backward(ctx, g):
        idx, in_range = ctx.saved_tensors
        if ctx.grad_reduce:
            # Each rank's cotangent covers its own slice of the output:
            # reassemble the full cotangent BEFORE the ownership mask.
            g = ctx.comm.allreduce(g, "sum")
        g = torch.where(in_range[..., None], g, torch.zeros_like(g))
        d_emb = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        d_emb.index_add_(0, idx.reshape(-1), g.reshape(-1, ctx.shape[-1]))
        return None, d_emb, None, None


def vocab_parallel_embed(tokens, embedding_shard, comm, grad_reduce=False):
    """Look ``tokens`` up in a VOCAB-SHARDED table: ``embedding_shard``
    (V/n, D) is this rank's contiguous rows.  Returns the replicated
    (..., D) embeddings.

    ``grad_reduce``: False is the pure tensor-parallel contract (the
    cotangent of the output is the same on every rank, so the local
    scatter is the complete gradient of this shard); True is the
    sequence-parallel one (each rank consumes its own slice of the
    output, so the cotangents are summed over the ranks before the
    scatter)."""
    return _VocabParallelEmbed.apply(tokens, embedding_shard, comm,
                                     bool(grad_reduce))


class _GatherForHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.comm, ctx.axis, ctx.s_local = comm, axis, x.shape[axis]
        return comm.allgather(x, axis=axis, tiled=True)

    @staticmethod
    def backward(ctx, g):
        s, r = ctx.s_local, ctx.comm.rank
        return g.narrow(ctx.axis, r * s, s).contiguous(), None, None


def gather_seq_for_replicated_head(x, comm, axis: int = 1):
    """All-gather a sequence-sharded activation for a head whose gradient
    is REPLICATED over the ranks (the vocab-parallel cross-entropy):
    every rank seeds the same cotangent on the gathered tensor, so the
    backward slices it back to this rank's shard (a plain all-gather's
    reduce-scatter would count it ``n`` times)."""
    return _GatherForHead.apply(x, comm, axis)


class _VocabShardStrategy:
    """:class:`~chainermn_tpu_torch.ops.fused_ce.LocalVocabStrategy`'s
    cross-shard sibling: the row max, sum-exp and picked logit merged over
    the ranks, labels resolved by contiguous-shard ownership, and ``dh``
    summed over the ranks."""

    def __init__(self, comm, v_loc: int):
        self.comm, self.v_loc = comm, v_loc
        self.offset = comm.rank * v_loc

    def merge_max(self, m):
        return self.comm.allreduce(m, "max")

    def merge_sum(self, s):
        return self.comm.allreduce(s, "sum")

    def merge_pick(self, p):
        return self.comm.allreduce(p, "sum")

    def reduce_dh(self, dh):
        return self.comm.allreduce(dh, "sum")

    def label_local(self, labels):
        local = labels - self.offset
        owner = (local >= 0) & (local < self.v_loc)
        return local.clamp(0, self.v_loc - 1), owner


class _VocabParallelCESum(torch.autograd.Function):
    """Replicated (loss_sum, n_valid) over vocab-sharded logits."""

    @staticmethod
    def forward(ctx, hidden, embedding_shard, labels, comm, chunk):
        strat = _VocabShardStrategy(comm, embedding_shard.shape[0])
        loss_sum, n_valid, lse = ce_scan_fwd(hidden, embedding_shard, labels,
                                             chunk, strat)
        ctx.save_for_backward(hidden, embedding_shard, labels, lse)
        ctx.comm, ctx.chunk = comm, chunk
        ctx.mark_non_differentiable(n_valid)
        return loss_sum, n_valid

    @staticmethod
    def backward(ctx, g_loss, _g_nvalid):
        hidden, embedding_shard, labels, lse = ctx.saved_tensors
        strat = _VocabShardStrategy(ctx.comm, embedding_shard.shape[0])
        dh, d_emb = ce_scan_bwd(hidden, embedding_shard, labels, lse, g_loss,
                                torch.zeros_like(lse), ctx.chunk, strat)
        return dh, d_emb, None, None, None


def vocab_parallel_cross_entropy(hidden, embedding_shard, labels, comm, *,
                                 chunk: int = 512):
    """Mean softmax cross-entropy of ``hidden`` against a VOCAB-SHARDED
    tied embedding (this rank's (V/n, D) rows) — the tensor-parallel LM
    head.  The semantics of
    :func:`~chainermn_tpu_torch.ops.fused_ce.fused_cross_entropy`
    (negative labels ignored; bf16 products, fp32 reductions; never more
    than one (chunk, V/n) logit tile), with the softmax statistics merged
    across the ranks: one max-allreduce and two sum-allreduces a chunk,
    one sum-allreduce of ``dh`` a chunk in the backward.  ``hidden`` and
    ``labels`` are the same on every rank; returns the replicated mean,
    and gradients ``d hidden`` replicated and ``d embedding_shard``
    local."""
    h2, l2, chunk = _validate_and_flatten(hidden, embedding_shard, labels,
                                          chunk)
    loss_sum, n_valid = _VocabParallelCESum.apply(h2, embedding_shard, l2,
                                                  comm, int(chunk))
    return loss_sum / n_valid.clamp_min(1.0)



# ---------------------------------------------------------------------------
# GSPMD: plan-driven placement over a DeviceMesh
# ---------------------------------------------------------------------------


def build_device_mesh(comm, mesh_shape, mesh_dim_names=("data", "model"),
                      device="cuda"):
    """A ``DeviceMesh`` over the world of ``comm`` (a communicator of
    :func:`~chainermn_tpu_torch.create_communicator`), ranks laid out
    row-major over ``mesh_shape`` with ``mesh_dim_names``.  ``device``
    (default ``"cuda"``) must be ``"cpu"`` explicitly to build a CPU mesh
    (gloo); a CUDA mesh without a card raises."""
    from torch.distributed.device_mesh import init_device_mesh

    from .._device import resolve_device

    dev = resolve_device(device)
    n = 1
    for d in mesh_shape:
        n *= int(d)
    world = torch.distributed.get_world_size()
    if comm.size != world or n != world:
        raise ValueError(
            f"mesh {tuple(mesh_shape)} ({n} ranks) must cover the "
            f"communicator's world of {comm.size} (process group "
            f"{world})"
        )
    return init_device_mesh(dev.type, tuple(int(d) for d in mesh_shape),
                            mesh_dim_names=tuple(mesh_dim_names))


def transformer_param_spec(module, model_axis: str = "model"):
    """``{parameter name: PartitionSpec}`` for the transformer/ViT families
    of :mod:`chainermn_tpu_torch.models`: attention heads and MLP hidden
    sharded over ``model_axis``, everything else replicated — the shim
    over registry plan ``"tp"``, leaf for leaf.

    A module whose names match none of the rules would replicate
    everything, so a spec that shards NOTHING raises."""
    from ..sharding import get_plan
    from ..sharding.plan import P

    def rename(spec):
        return P(*((model_axis if e == "model" else e) for e in spec))

    spec = {n: rename(s) for n, s in get_plan("tp").resolve(module).items()}
    if not any(any(e is not None for e in s) for s in spec.values()):
        raise ValueError(
            "transformer_param_spec matched NO shardable parameters — "
            "tensor parallelism would silently do nothing.  The rules "
            "key on this package's layer names (query/key/value/out, "
            "wi/wo); for a model with different naming, write the "
            "name → PartitionSpec mapping by hand and pass it to "
            "make_gspmd_train_step directly."
        )
    return spec


def _batch_placements(mesh, data_axis):
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if n == data_axis else Replicate()
            for n in mesh.mesh_dim_names]


def _constrain(x, mesh, placements):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) and x.ndim >= 1 \
            and tuple(x.placements) != tuple(placements):
        return x.redistribute(mesh, placements)
    if isinstance(x, tuple):
        return tuple(_constrain(y, mesh, placements) for y in x)
    return x


def local_heads(fn, mesh):
    """Wrap an ``attention_fn(q, k, v, mask)`` (``(B, S, H, D)`` inputs)
    so that, given DTensors, it runs ``fn`` on each rank's local batch
    rows and heads through ``local_map``: a placement that shards the
    batch (dim 0) or the heads (dim 2) is kept, any other becomes
    ``Replicate()``.  Plain tensors pass straight to ``fn``.  This is how
    the hand kernels, opaque to DTensor, run under the GSPMD step."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    def wrapped(q, k, v, mask=None):
        if not isinstance(q, DTensor):
            return fn(q, k, v, mask)
        pl = [p if isinstance(p, Shard) and p.dim % q.ndim in (0, 2)
              else Replicate() for p in q.placements]
        run = local_map(lambda a, b, c: fn(a, b, c, mask),
                        out_placements=pl, in_placements=(pl, pl, pl),
                        in_grad_placements=(pl, pl, pl), device_mesh=mesh,
                        redistribute_inputs=True)
        return run(q, k, v)

    return wrapped


def batch_mean(fn, batch, weights=(), *, data_axis="data"):
    """The global mean of a per-row mean loss under the GSPMD step:
    ``fn(*batch, *weights)`` runs through ``local_map`` on each data
    shard's rows of the ``batch`` DTensors (dim 0 over ``data_axis``,
    replicated over the other mesh dimensions) with whole ``weights``
    (redistributed to ``Replicate()``; their gradients are partial sums
    over the data shards), and the shards' means are averaged with one
    all-reduce.  The shards weigh equally: with ignored rows (negative
    labels) the result is the mean of the shards' means.  This is how
    the fused cross-entropy, opaque to DTensor, runs under the step."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = batch[0].device_mesh
    names = mesh.mesh_dim_names
    n_data = mesh.size(names.index(data_axis))
    rows = _batch_placements(mesh, data_axis)
    whole = [Replicate()] * len(names)
    grads = [Partial() if n == data_axis else Replicate() for n in names]
    run = local_map(
        lambda *a: fn(*a) / n_data,
        out_placements=[Partial() if n == data_axis else Replicate()
                        for n in names],
        in_placements=(rows,) * len(batch) + (whole,) * len(weights),
        in_grad_placements=(rows,) * len(batch) + (grads,) * len(weights),
        device_mesh=mesh, redistribute_inputs=True,
    )
    return run(*batch, *weights).redistribute(mesh, whole)


def lm_loss(chunk=None, data_axis="data"):
    """``loss_fn(model, (tokens, labels))`` for a ``TransformerLM`` under
    :func:`make_gspmd_train_step`: the final-norm hidden states through
    the fused cross-entropy against the tied table (gathered whole under
    ``fsdp``), per data shard (:func:`batch_mean`)."""
    from ..ops.fused_ce import fused_cross_entropy

    def ce(h, labels, table):
        return fused_cross_entropy(h, table, labels, chunk=chunk)

    def loss_fn(model, batch):
        tokens, labels = batch
        h = model(tokens, return_hidden=True)
        return batch_mean(ce, (h, labels), (model.embed.weight,),
                          data_axis=data_axis)

    return loss_fn


def _as_plan(param_spec):
    from ..sharding import ShardingPlan, get_plan
    from ..sharding.plan import PartitionSpec, PlanRule, spec_axes

    if isinstance(param_spec, str):
        return get_plan(param_spec)
    if isinstance(param_spec, ShardingPlan):
        return param_spec
    if isinstance(param_spec, Mapping):
        rules = tuple(PlanRule(name, f"^{re.escape(name)}$",
                               PartitionSpec(*spec))
                      for name, spec in param_spec.items())
        axes = tuple(dict.fromkeys(a for r in rules for a in spec_axes(r.spec)))
        return ShardingPlan("<spec tree>", rules, axes=axes)
    raise TypeError(
        "param_spec must be a ShardingPlan, a registry plan name or a "
        f"{{parameter name: PartitionSpec}} mapping, not "
        f"{type(param_spec).__name__}"
    )


def _owners(model, name_of):
    """``{id(param): [(module, attribute)]}``: every place a parameter is
    registered (tied weights have several)."""
    owners = {}
    for _, mod in model.named_modules(remove_duplicate=False):
        for attr, p in mod._parameters.items():
            if p is not None and id(p) in name_of:
                owners.setdefault(id(p), []).append((mod, attr))
    return owners


def make_gspmd_train_step(model, loss_fn, optimizer, mesh, param_spec,
                          data_axis: str = "data"):
    """Build a dp×tp (or fsdp, zero, ...) train step via sharding
    placement on a ``DeviceMesh`` — the port of the reference's
    ``make_gspmd_train_step``.

    ``model``: an ``nn.Module`` holding plain parameters, the same on
    every rank.  ``loss_fn(model, batch) -> loss`` runs on the module
    with DTensor parameters and a DTensor batch (``lm_loss`` builds one
    for ``TransformerLM``; plain tensors the module makes, such as its
    position table, count as replicated).  ``optimizer``: a factory from a
    list of parameters to a ``torch.optim`` optimizer.  ``param_spec``: a
    :class:`~chainermn_tpu_torch.sharding.ShardingPlan`, a registry plan
    name (``"tp"``, ``"dp_tp"``, ``"fsdp"``, ``"zero"``, ...) or a
    ``{parameter name: PartitionSpec}`` mapping.  A plan's axes must be
    dimensions of ``mesh``, and so must ``data_axis``.

    Returns ``(step, shard_fn)``.  ``shard_fn(opt_state=None)`` replaces
    each parameter with a DTensor at its plan placement, wraps every
    attention module's ``attention_fn`` in :func:`local_heads`, pins each
    submodule's output to the batch layout, and builds the optimizer over
    the parameters at their MOMENT placement (the plan's
    ``moment_rules``; a separate shard only where it differs), loading
    ``opt_state`` (a ``state_dict()`` of an optimizer over the unsharded
    module) with each moment placed by its parameter's name; it returns
    ``(model, optimizer)``.  ``step(batch)`` takes the global batch (a
    tensor or a tuple of tensors, dim 0 the batch, the same on every
    rank), places it dim 0 over ``data_axis``, runs forward and backward,
    redistributes every gradient to its moment placement (all-reduce or
    reduce-scatter), steps the optimizer, gathers updated shards back to
    the parameter placement, and returns the loss (a plain 0-d tensor)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from ..models.transformer import MultiHeadAttention
    from ..sharding.plan import moment_entries, placements_for

    plan = _as_plan(param_spec)
    names = tuple(mesh.mesh_dim_names or ())
    missing = set(plan.axes) - set(names)
    if missing:
        raise ValueError(
            f"sharding plan {plan.name!r} shards over axes "
            f"{sorted(missing)} the mesh lacks (mesh axes: {names})"
        )
    if data_axis not in names:
        raise ValueError(f"data_axis {data_axis!r} is not a dimension of "
                         f"the mesh {names}")
    n_data = mesh.size(names.index(data_axis))
    batch_pl = _batch_placements(mesh, data_axis)
    moment_rules = plan.moment_rules if plan.moment_rules is not None \
        else plan.rules
    state = {}

    def shard_fn(opt_state=None):
        if state:
            raise RuntimeError("shard_fn already placed this model")
        named = list(model.named_parameters())
        name_of = {id(p): n for n, p in named}
        owners = _owners(model, name_of)
        entries, opt_params = [], []
        for name, p in named:
            shape = tuple(p.shape)
            fwd_pl = placements_for(plan.spec_for(name, shape), names)
            mom_pl = placements_for(
                plan.spec_for(name, shape, moment_rules), names)
            dt = torch.nn.Parameter(
                distribute_tensor(p.detach(), mesh, fwd_pl),
                requires_grad=p.requires_grad)
            for mod, attr in owners[id(p)]:
                mod._parameters[attr] = dt
            if mom_pl == fwd_pl:
                master = dt
            else:
                master = torch.nn.Parameter(
                    dt.detach().redistribute(mesh, mom_pl),
                    requires_grad=p.requires_grad)
            entries.append((name, dt, master, fwd_pl, mom_pl))
            opt_params.append(master)
        opt = optimizer(opt_params)
        if opt_state is not None:
            by_name = {n: i for i, (n, *_) in enumerate(entries)}
            placed = {"param_groups": opt_state["param_groups"], "state": {}}
            for name, st in moment_entries(opt_state, [n for n, _ in named]):
                mom_pl = entries[by_name[name]][4]
                placed["state"][by_name[name]] = {
                    k: (distribute_tensor(v, mesh, mom_pl)
                        if torch.is_tensor(v) and v.ndim else v)
                    for k, v in st.items()}
            opt.load_state_dict(placed)
        for m in model.modules():
            if isinstance(m, MultiHeadAttention) and m.attention_fn is not None:
                m.attention_fn = local_heads(m.attention_fn, mesh)
            m.register_forward_hook(
                lambda mod, inp, out: _constrain(out, mesh, batch_pl))
        state.update(opt=opt, entries=entries)
        return model, opt

    def place(x):
        if not torch.is_tensor(x):
            return x
        if x.shape[0] % n_data:
            raise ValueError(f"global batch {x.shape[0]} does not divide "
                             f"over {n_data} data shards")
        rows = x.shape[0] // n_data
        c = mesh.get_local_rank(data_axis)
        local = x[c * rows:(c + 1) * rows].to(mesh.device_type)
        return DTensor.from_local(local, mesh, batch_pl, run_check=False)

    def step(batch):
        if "opt" not in state:
            raise RuntimeError(
                "gspmd step called before shard_fn: call shard_fn() once to "
                "resolve the plan, place the parameters and build the "
                "optimizer"
            )
        opt, entries = state["opt"], state["entries"]
        batch = tuple(map(place, batch)) if isinstance(batch, (tuple, list)) \
            else place(batch)
        with implicit_replication():
            loss = loss_fn(model, batch)
            loss.backward()
        for _, p, master, _, mom_pl in entries:
            if p.grad is None:
                continue
            g = p.grad.redistribute(mesh, mom_pl)
            p.grad = None
            master.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            for _, p, master, fwd_pl, _ in entries:
                if master is not p:
                    p.copy_(master.redistribute(mesh, fwd_pl))
        return loss.detach().full_tensor()

    return step, shard_fn
