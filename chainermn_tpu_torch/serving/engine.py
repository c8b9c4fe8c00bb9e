"""Inference engine: bucketed prefill, paged decode and multi-token chunk
steps — port of ``chainermn_tpu/serving/engine.py`` on one device.

The engine is the *execution* half of serving (the scheduler is the
*policy* half): it owns the device KV pages, the three step programs and
sampling.  Design constraints, in order:

1. **Bit-stable batching.**  Everything is per sequence: the paged
   attention reduces only within one sequence's gathered context, padding
   rows write nothing, and sampling is host-side per request (greedy
   ``np.argmax`` on fp32 logits; temperature/top-k from a per-request
   counter-based RNG).  On the GPU one caveat remains that XLA on the CPU
   does not show: the GEMM library may pick another kernel (another
   reduction order) for another batch size, so bf16 logits of one
   sequence can differ in their last bits between a batch of 1 and of 8.
2. **Bounded shapes.**  Every host-side shape is padded to a static
   bucket — prompt length, decode batch, block-table width, chunk length
   — as the reference pads them for jit; the "compile" counts of
   :meth:`InferenceEngine.stats` are the distinct bucket shapes run, the
   same numbers the reference reports.
3. **Plain torch ops.**  The data plane is
   :mod:`~chainermn_tpu_torch.ops.decode_attention` (gather/scatter +
   einsum softmax) and the model's dense prefill; no hand kernel.

The pages update in place (the reference donates its cache buffers).
Block tables and lengths stay on the host; only the selected write
indices and the gather tables cross to the device, without a stream
synchronise, so the host can run ahead of the card within a step.

Across ranks (one engine a rank, every rank running the same host
scheduler on the same requests in lockstep; sampling is host-side and
counter-based, so every rank samples the same token):

* ``plan=``/``mesh=`` — tensor-parallel placement: the module's
  parameters become DTensors at the plan's placements over a
  ``DeviceMesh`` and each layer's ``k_pages``/``v_pages`` shard their
  KV-head axis through the plan's ``kv_pages`` rule.  The attention runs
  on each rank's local heads (``local_map``), the out projection and
  ``wo`` are row-parallel, and every submodule's output is pinned
  replicated (one all-reduce each).  The module is placed in place.
* ``EngineConfig.sp`` — sequence-parallel chunk prefill: a one-row chunk
  whose bucket ``sp`` divides is split over a group of ``sp`` ranks (the
  world in consecutive groups, the first ``sp`` ranks first), each
  holding C = T / sp tokens; K/V are gathered to the whole slice (a pure
  concatenation: the pages are the unsharded chunk's, bitwise wherever a
  GEMM of C rows rounds as one of T rows does, as on the CPU).
* ``pp_stages`` — a decode iteration runs as contiguous microbatches
  (:func:`~chainermn_tpu_torch.parallel.pipeline.decode_microbatches`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from .._device import check_model_device
from ..communicators import quant
from .kv_cache import PagedKVCache
from .spec import DraftModel
from .spec import propose_draft as _ngram_draft

#: draft proposal sources the engine can dispatch to.
DRAFT_SOURCES = ("ngram", "model")
ENV_DRAFT = "CHAINERMN_TPU_DRAFT"
ENV_PREFILL_CHUNK = "CHAINERMN_TPU_PREFILL_CHUNK"
#: largest default chunk bucket (tokens); longer rows grow the ladder
#: lazily (``EngineConfig.max_len_growth``).
DEFAULT_CHUNK_CAP = 4096

# (lockstep ranks, sp) -> (the world they were made in, this rank's
# sequence-parallel communicator): every engine of one kind shares its
# process groups, so building engines piles up no communicators.
_SP_GROUPS: dict = {}


def _resolve_draft(cfg: "EngineConfig") -> str:
    """``draft`` source: explicit config -> ``CHAINERMN_TPU_DRAFT`` ->
    ``"ngram"`` (the reference's tune-cache step waits for the port's
    ``tuning`` (ROADMAP A.7))."""
    if cfg.draft is not None:
        if cfg.draft not in DRAFT_SOURCES:
            raise ValueError(
                f"draft must be one of {DRAFT_SOURCES}, got {cfg.draft!r}")
        return cfg.draft
    env = os.environ.get(ENV_DRAFT)
    if env is not None:
        return env if env in DRAFT_SOURCES else "ngram"
    return "ngram"


def _resolve_prefill_chunk(cfg: "EngineConfig") -> int:
    """``prefill_chunk`` (0 = off): explicit config ->
    ``CHAINERMN_TPU_PREFILL_CHUNK`` -> off."""
    if cfg.prefill_chunk is not None:
        return max(0, int(cfg.prefill_chunk))
    env = os.environ.get(ENV_PREFILL_CHUNK)
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            return 0
    return 0


def _resolve_kv_dtype(cfg: "EngineConfig"):
    """``kv_dtype``: an explicit config value (any spelling, ``"none"``
    included) wins; an unset one reads ``CHAINERMN_TPU_KV_DTYPE``
    (an unknown value there means off)."""
    if cfg.kv_dtype is not None:
        return quant.canonical_kv_dtype(cfg.kv_dtype)
    env = os.environ.get(quant.ENV_KV_DTYPE)
    if env is not None:
        try:
            return quant.canonical_kv_dtype(env)
        except ValueError:
            return None
    return None


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling policy.  ``temperature == 0`` is greedy
    (argmax, RNG never consulted); otherwise softmax sampling at the
    given temperature, optionally truncated to the ``top_k`` most likely
    tokens.  ``seed`` plus the token position form a counter-based RNG,
    so a request's stream is reproducible and independent of batching."""

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static geometry of the serving engine (the reference's fields).

    ``n_blocks * block_size`` is the total KV pool in tokens; ``max_len``
    bounds any single sequence (prompt + generated); ``max_batch`` is the
    widest decode iteration.  Buckets are pow2 ladders derived from these
    unless given explicitly.  ``kv_dtype``, ``draft`` and
    ``prefill_chunk`` left ``None`` resolve through the environment (see
    the ``_resolve_*`` functions).  ``sp`` > 1 (a power of two) splits
    one-row chunk steps over that many ranks."""

    block_size: int = 16
    n_blocks: int = 256
    max_len: int = 2048
    max_batch: int = 8
    prefix_cache: bool = True
    kv_dtype: Optional[str] = None
    prefill_buckets: Optional[Tuple[int, ...]] = None
    batch_buckets: Optional[Tuple[int, ...]] = None
    table_width_buckets: Optional[Tuple[int, ...]] = None
    chunk_buckets: Optional[Tuple[int, ...]] = None
    draft: Optional[str] = None
    draft_layers: Optional[int] = None
    prefill_chunk: Optional[int] = None
    sp: int = 0
    max_len_growth: bool = True

    def resolved(self) -> "EngineConfig":
        def pow2_ladder(lo, hi):
            out, v = [], lo
            while v < hi:
                out.append(v)
                v *= 2
            out.append(hi)
            return tuple(sorted(set(out)))

        max_pages = -(-self.max_len // self.block_size)
        return dataclasses.replace(
            self,
            prefill_buckets=self.prefill_buckets
            or pow2_ladder(min(16, self.max_len), self.max_len),
            batch_buckets=self.batch_buckets
            or pow2_ladder(1, self.max_batch),
            table_width_buckets=self.table_width_buckets
            or pow2_ladder(1, max_pages),
            chunk_buckets=self.chunk_buckets
            or pow2_ladder(1, min(self.max_len, DEFAULT_CHUNK_CAP)),
        )


def _bucket(value: int, buckets: Tuple[int, ...], what: str) -> int:
    for b in buckets:
        if value <= b:
            return b
    raise ValueError(f"{what} {value} exceeds the largest bucket "
                     f"{buckets[-1]}")


class InferenceEngine:
    """Cached-KV inference over a trained
    :class:`~chainermn_tpu_torch.models.transformer.TransformerLM`.

    ``lm`` carries its parameters (the reference takes ``lm`` and a
    parameter tree); its cache modes serve prefill, decode and chunk over
    those parameters.  ``device`` (default ``"cuda"``; raises with no CUDA
    device unless ``device="cpu"``) must be where ``lm`` lives.  The
    engine owns:

    * ``kv`` — the :class:`PagedKVCache` page accounting;
    * the device pages, one
      :class:`~chainermn_tpu_torch.models.transformer.PagedLayerCache` a
      layer (the reference's flax ``cache`` collection);
    * the step programs' bucket bookkeeping.

    ``plan`` (a :class:`~chainermn_tpu_torch.sharding.ShardingPlan` or a
    registry name) with ``mesh`` (a ``DeviceMesh`` with the plan's
    dimension names) places ``lm`` for tensor parallelism;
    ``config.sp`` splits the ranks of ``mesh`` or of the default process
    group into groups of ``sp`` (see the module docstring).  Engines under the
    same plan and mesh may share one placed module.
    """

    def __init__(self, lm, config: Optional[EngineConfig] = None, *,
                 plan=None, mesh=None, device="cuda"):
        dev = check_model_device(lm.device, device)
        cfg = (config or EngineConfig(max_len=lm.max_len)).resolved()
        if cfg.max_len > lm.max_len:
            raise ValueError(
                f"config.max_len {cfg.max_len} exceeds the model's "
                f"max_len {lm.max_len}"
            )
        self.sp = int(cfg.sp) if cfg.sp and int(cfg.sp) > 1 else 0
        self._sp_comm = None
        if self.sp:
            self._sp_comm = self._sp_group(plan, mesh)
        self.device = dev
        self.config = cfg
        self.lm = lm
        self.kv = PagedKVCache(cfg.n_blocks, cfg.block_size,
                               prefix_cache=cfg.prefix_cache)
        # The engine's resolved dtype decides the pages, never the
        # model's own ``kv_dtype`` field (as the reference's twins).
        self.kv_dtype = _resolve_kv_dtype(cfg)
        self._cache = lm.init_paged_cache(cfg.n_blocks, cfg.block_size,
                                          kv_dtype=self.kv_dtype)

        self._prefill_buckets = list(cfg.prefill_buckets)
        self._table_buckets = list(cfg.table_width_buckets)
        self._chunk_buckets = list(cfg.chunk_buckets)
        self._table_cap = max(1, -(-cfg.max_len // cfg.block_size))
        self._bucket_growths = 0
        self._max_prefilled = 0

        #: shard-group mirror hook: when set, every device-mutating step
        #: first emits ``(op, host payload)`` here; a follower replays it
        #: with :meth:`apply_step`.
        self.mirror_sink = None
        #: decode microbatching for tp x pp serving: when > 1, each decode
        #: iteration runs as this many contiguous microbatch steps (the
        #: same per-row results: attention is per sequence).
        self.pp_stages = 1
        self._prefill_shapes: set = set()
        self._decode_shapes: set = set()
        self._chunk_shapes: set = set()
        self._sp_shapes: set = set()
        self._tokens_decoded = 0
        self._tokens_prefilled = 0
        self._tokens_chunked = 0
        self._tokens_prefix_cached = 0
        self._cow_splits = 0
        self._kv_quant_err = 0.0
        self.plan = None
        self.mesh = None
        if self.sp:
            from ..sharding import get_plan

            # Plan "sp" replicates everything: each rank's plain tensors
            # already are that placement.
            self.plan = get_plan("sp")
        elif plan is not None:
            self._apply_plan(plan, mesh)

        # Built after the placement, so the draft runs on the placed
        # parameters.
        self.draft_source = _resolve_draft(cfg)
        self.prefill_chunk = _resolve_prefill_chunk(cfg)
        self.draft_model: Optional[DraftModel] = None
        if self.draft_source == "model":
            k = cfg.draft_layers or max(1, lm.n_layers // 2)
            self.draft_model = DraftModel(lm, k, cfg.prefill_buckets)

    def _sp_group(self, plan, mesh):
        """This rank's sequence-parallel communicator: the ranks of
        ``mesh`` or of the default process group split into consecutive
        groups of ``sp`` (the first ``sp`` ranks are the first group).
        Every lockstep rank runs the sharded chunk in its group, so every
        rank computes the same logits and pages: a rank running the
        plain chunk instead could round them differently (another GEMM
        shape) and sample another token at a near tie.  The groups are
        made once for each world, ranks and ``sp`` (:data:`_SP_GROUPS`);
        the first engine of a kind is collective over the world."""
        import torch.distributed as dist

        from ..communicators.base import group_communicator

        if self.sp & (self.sp - 1):
            raise ValueError(
                f"sp must be a power of two (it has to divide the pow2 "
                f"chunk buckets), got {self.sp}")
        if plan is not None:
            raise ValueError(
                "sp prefill and an explicit tensor-parallel plan are "
                "mutually exclusive: sp brings its own group and the 'sp' "
                "registry plan")
        if mesh is not None:
            ranks = [int(r) for r in mesh.mesh.reshape(-1).tolist()]
        elif dist.is_available() and dist.is_initialized():
            ranks = list(range(dist.get_world_size()))
        else:
            ranks = [0]
        if len(ranks) < self.sp:
            raise ValueError(
                f"sp={self.sp} needs {self.sp} ranks, have {len(ranks)}")
        if len(ranks) % self.sp:
            raise ValueError(
                f"sp={self.sp} must divide the {len(ranks)} lockstep ranks")
        world, key = dist.group.WORLD, (tuple(ranks), self.sp)
        hit = _SP_GROUPS.get(key)
        if hit is not None and hit[0] is world:
            return hit[1]
        me, mine = dist.get_rank(), None
        for g in range(0, len(ranks), self.sp):
            members = ranks[g:g + self.sp]
            group = dist.new_group(members)
            if me in members:
                mine = group_communicator(group)
        _SP_GROUPS[key] = (world, mine)
        return mine

    def _apply_plan(self, plan, mesh) -> None:
        """Tensor-parallel placement from a sharding plan: the module's
        parameters (:func:`~chainermn_tpu_torch.parallel.sharding.place_parameters`)
        and each layer's pages at the plan's placements over ``mesh``,
        every submodule's output pinned replicated."""
        from torch.distributed.tensor import distribute_tensor

        from ..parallel.sharding import pin_outputs, place_parameters
        from ..sharding import ShardingPlan, get_plan
        from ..sharding.plan import placements_for

        if isinstance(plan, str):
            plan = get_plan(plan)
        if not isinstance(plan, ShardingPlan):
            raise TypeError(
                f"plan must be a ShardingPlan or registry name, got "
                f"{type(plan).__name__}")
        if mesh is None:
            raise ValueError(
                f"plan {plan.name!r} needs mesh=: the plan only names "
                "axes; the mesh supplies the devices behind them")
        names = tuple(mesh.mesh_dim_names or ())
        missing = set(plan.axes) - set(names)
        if missing:
            raise ValueError(
                f"plan {plan.name!r} shards over axes {sorted(missing)} "
                f"the mesh lacks (mesh axes: {names})")
        self.plan, self.mesh = plan, mesh
        placed = getattr(self.lm, "_serving_placement", None)
        if placed is None:
            place_parameters(self.lm, plan, mesh)
            pin_outputs(self.lm, mesh, placements_for((), names))
            self.lm._serving_placement = (plan.name, mesh)
        elif placed != (plan.name, mesh):
            raise ValueError(
                f"the module is already placed under plan {placed[0]!r} on "
                f"another mesh; place a fresh module")
        for i, c in enumerate(self._cache):
            for leaf_name, leaf in c.leaves().items():
                pl = placements_for(
                    plan.spec_for(f"layers.{i}.{leaf_name}",
                                  tuple(leaf.shape)), names)
                setattr(c, leaf_name, distribute_tensor(leaf, mesh, pl))
        if getattr(self, "draft_model", None) is not None:
            self.draft_model.rebind(self.lm)

    def _leaves(self):
        """Every page tensor of every layer, as this rank holds it (the
        local shard of a placed leaf: the page axis is never sharded)."""
        for c in self._cache:
            for leaf in c.leaves().values():
                yield leaf if self.plan is None or self.sp else \
                    leaf.to_local()

    # -- the step programs ---------------------------------------------
    def _run(self, mode: str, tokens, tables, lens, offsets=None, sp=None):
        """One forward of ``mode`` over the pages; returns the device
        logits.  ``tokens``/``tables``/``lens``/``offsets`` are host
        arrays; the tables and lengths stay on the host (routing), the
        tokens and positions go to the device.  Positions clamp into the
        position table as the reference's gather does (bucket padding of a
        chunk near ``max_len`` reaches past it; those rows are never
        read)."""
        dev = self.device
        tok = torch.from_numpy(np.asarray(tokens, np.int64)).to(
            dev, non_blocking=True)
        pos = None
        if offsets is not None:
            off = np.minimum(np.asarray(offsets, np.int64),
                             self.lm.max_len - 1)
            pos = torch.from_numpy(off).to(dev, non_blocking=True)
        kw = dict(position_offset=pos,
                  block_tables=torch.from_numpy(np.asarray(tables, np.int32)),
                  seq_lens=torch.from_numpy(np.asarray(lens, np.int32)),
                  cache=self._cache, paged=mode)
        if sp is not None:
            kw["sp_axis"] = sp
        with torch.no_grad():
            if self.mesh is None:
                logits = self.lm(tok, **kw)
            else:
                from torch.distributed.tensor.experimental import (
                    implicit_replication)

                with implicit_replication():
                    logits = self.lm(tok, **kw).to_local()
        if self.kv_dtype is not None:
            self._note_kv_err(float(torch.stack(
                [c.kv_quant_err for c in self._cache]).max()))
        return logits

    def _prefill_run(self, padded, table, lens):
        return self._run("prefill", padded, table, lens)

    def _decode_run(self, tok, tables, lens):
        return self._run("decode", tok[:, None], tables, lens,
                         offsets=np.maximum(lens, 0)[:, None])

    def _chunk_run(self, tok, tables, start, use_sp=False):
        T = tok.shape[1]
        comm = self._sp_comm if use_sp else None
        if comm is None:
            offs = np.maximum(start, 0)[:, None] + np.arange(T)[None]
            return self._run("chunk", tok, tables, start, offsets=offs)
        # This rank's C consecutive tokens at their global positions; the
        # layers gather the whole slice's K/V, and the logits are gathered
        # back to the whole slice.
        C, r = T // comm.size, comm.rank
        offs = np.maximum(start, 0)[:, None] + r * C + np.arange(C)[None]
        logits = self._run("chunk", tok[:, r * C:(r + 1) * C], tables, start,
                           offsets=offs, sp=comm)
        return comm.allgather(logits, axis=1, tiled=True)

    def _cow(self, old: int, new: int) -> None:
        """Device half of a copy-on-write split: page ``old`` duplicated
        into page ``new`` on every cache leaf."""
        with torch.no_grad():
            for leaf in self._leaves():
                leaf[new] = leaf[old]

    def _permute(self, perm) -> None:
        """Device half of a defragment: ``leaf[i] = leaf[perm[i]]``."""
        p = torch.from_numpy(np.asarray(perm, np.int64)).to(self.device)
        with torch.no_grad():
            for leaf in self._leaves():
                leaf.copy_(leaf[p])

    # -- shard-group mirroring -----------------------------------------
    def _mirror(self, op: str, *payload) -> None:
        if self.mirror_sink is not None:
            self.mirror_sink(op, payload)

    def apply_step(self, op: str, payload) -> None:
        """Replay one mirrored device step (the follower half of a shard
        group): the same step over this engine's own pages, keeping only
        the cache update — sampling and host accounting are the
        leader's."""
        if op == "prefill":
            self._prefill_run(*payload)
        elif op == "decode":
            self._decode_run(*payload)
        elif op == "chunk":
            tok, tables, start, use_sp = payload
            self._chunk_run(tok, tables, start, use_sp)
        elif op == "cow":
            self._cow(*payload)
        elif op == "defrag":
            self._permute(payload[0])
        else:
            raise ValueError(f"unknown mirrored op {op!r}")

    # -- geometry ------------------------------------------------------
    @property
    def max_batch(self) -> int:
        return self.config.max_batch

    @property
    def max_bucket(self) -> int:
        """Longest context (tokens) this engine has run a prefill or chunk
        step over."""
        return self._max_prefilled

    def _bucket_grow(self, value: int, ladder: List[int], cap: int,
                     what: str) -> int:
        """Bucket ``value`` on a mutable ladder, extending it (next pow2,
        capped at ``cap``) instead of raising when ``max_len_growth`` is
        on; each extension counts in ``stats()['bucket_growths']``."""
        for b in ladder:
            if value <= b:
                return b
        if not self.config.max_len_growth or value > cap:
            raise ValueError(f"{what} {value} exceeds the largest bucket "
                             f"{ladder[-1]}")
        while ladder[-1] < value:
            ladder.append(min(ladder[-1] * 2, cap))
            self._bucket_growths += 1
        return ladder[-1]

    def table_width(self, n_tokens: int) -> int:
        """Bucketed block-table width for a context of ``n_tokens``."""
        return self._bucket_grow(
            max(1, self.kv.blocks_for(n_tokens)),
            self._table_buckets, self._table_cap, "table width",
        )

    # -- steps ---------------------------------------------------------
    def prefill(self, token_ids, seq_id) -> np.ndarray:
        """Run one prompt through the prefill step, writing its K/V into
        the pages of the already-allocated ``seq_id``.  Returns the fp32
        (vocab,) logits of the last prompt token."""
        toks = np.asarray(token_ids, np.int32).reshape(-1)
        L = len(toks)
        if L == 0:
            raise ValueError("empty prompt")
        if L >= self.config.max_len:
            raise ValueError(
                f"prompt of {L} tokens leaves no room to generate within "
                f"max_len {self.config.max_len}"
            )
        S = self._bucket_grow(L, self._prefill_buckets,
                              self.config.max_len, "prompt length")
        W = self.table_width(L)
        padded = np.zeros((1, S), np.int32)
        padded[0, :L] = toks
        table = self.kv.padded_table(seq_id, W)[None]
        self._prefill_shapes.add((S, W))
        lens = np.asarray([L], np.int32)
        self._mirror("prefill", padded, table, lens)
        logits = self._prefill_run(padded, table, lens)
        self._tokens_prefilled += L
        self._max_prefilled = max(self._max_prefilled, L)
        return logits[0, L - 1].float().cpu().numpy()

    def decode(self, tokens, seq_ids, seq_lens) -> np.ndarray:
        """One decode iteration: for each running sequence, write the given
        (just-sampled) token at position ``seq_lens[i]`` and return the
        fp32 (B, vocab) logits predicting the next one.  The batch pads to
        its bucket with inert rows (invalid tables, ``seq_len = -1``).
        With ``pp_stages > 1`` the iteration runs as that many contiguous
        microbatch steps (the same per-row results)."""
        B = len(tokens)
        if self.pp_stages > 1 and B > 1:
            from ..parallel.pipeline import decode_microbatches

            return np.concatenate([
                self._decode_step(tokens[a:b], seq_ids[a:b], seq_lens[a:b])
                for a, b in decode_microbatches(B, self.pp_stages)
            ], axis=0)
        return self._decode_step(tokens, seq_ids, seq_lens)

    def _decode_step(self, tokens, seq_ids, seq_lens) -> np.ndarray:
        B = len(tokens)
        if B == 0:
            raise ValueError("empty decode batch")
        if B > self.config.max_batch:
            raise ValueError(
                f"decode batch {B} exceeds max_batch "
                f"{self.config.max_batch}"
            )
        Bp = _bucket(B, self.config.batch_buckets, "decode batch")
        W = max(self.table_width(int(n) + 1) for n in seq_lens)
        tok = np.zeros((Bp,), np.int32)
        tok[:B] = np.asarray(tokens, np.int32)
        lens = np.full((Bp,), -1, np.int32)
        lens[:B] = np.asarray(seq_lens, np.int32)
        tables = np.full((Bp, W), self.kv.invalid, np.int32)
        for i, sid in enumerate(seq_ids):
            tables[i] = self.kv.padded_table(sid, W)
        self._decode_shapes.add((Bp, W))
        self._mirror("decode", tok, tables, lens)
        logits = self._decode_run(tok, tables, lens)
        self._tokens_decoded += B
        return logits[:B, 0].float().cpu().numpy()

    def chunk(self, token_rows, seq_ids, start_lens) -> np.ndarray:
        """One multi-token step: for each row, write ``len(token_rows[i])``
        consecutive tokens from context position ``start_lens[i]`` and
        return fp32 (B, T, vocab) logits — ``logits[i, t]`` predicts
        position ``start_lens[i] + t + 1``, what ``len(row)`` sequential
        :meth:`decode` calls would have produced.  Serves speculative
        verify and prefix-cache suffix prefill."""
        B = len(token_rows)
        if B == 0:
            raise ValueError("empty chunk batch")
        if B > self.config.max_batch:
            raise ValueError(
                f"chunk batch {B} exceeds max_batch {self.config.max_batch}"
            )
        Tmax = max(len(r) for r in token_rows)
        if Tmax == 0:
            raise ValueError("empty chunk row")
        T = self._bucket_grow(Tmax, self._chunk_buckets,
                              self.config.max_len, "chunk length")
        Bp = _bucket(B, self.config.batch_buckets, "decode batch")
        W = max(self.table_width(self.kv.seq_len(sid)) for sid in seq_ids)
        # One-row slices whose bucket sp divides run sequence-parallel
        # (the same pages: the gather is a pure concatenation); the rest
        # run the plain chunk step.
        use_sp = bool(self.sp and B == 1 and T % self.sp == 0)
        tok = np.zeros((Bp, T), np.int32)
        start = np.full((Bp,), -1, np.int32)
        tables = np.full((Bp, W), self.kv.invalid, np.int32)
        for i, (row, sid, s) in enumerate(
            zip(token_rows, seq_ids, start_lens)
        ):
            tok[i, : len(row)] = np.asarray(row, np.int32)
            start[i] = int(s)
            tables[i] = self.kv.padded_table(sid, W)
        (self._sp_shapes if use_sp else self._chunk_shapes).add((Bp, T, W))
        self._mirror("chunk", tok, tables, start, use_sp)
        logits = self._chunk_run(tok, tables, start, use_sp)
        self._tokens_chunked += sum(len(r) for r in token_rows)
        covered = max(
            (int(s) + len(r)
             for r, s in zip(token_rows, start_lens) if int(s) >= 0),
            default=0,
        )
        self._max_prefilled = max(self._max_prefilled, covered)
        return logits[:B].float().cpu().numpy()

    def prefill_cached(self, token_ids, seq_id, n_cached: int) -> np.ndarray:
        """Prefill a prompt whose first ``n_cached`` tokens are covered by
        shared prefix pages: only the suffix runs, through the chunk step.
        Returns the fp32 (vocab,) logits of the last prompt token.
        ``n_cached`` must leave at least one suffix token."""
        toks = np.asarray(token_ids, np.int32).reshape(-1)
        L = len(toks)
        if n_cached <= 0:
            return self.prefill(toks, seq_id)
        if n_cached >= L:
            raise ValueError(
                f"n_cached {n_cached} leaves no suffix for a prompt of "
                f"{L} tokens (use the CoW rewind path)"
            )
        if L >= self.config.max_len:
            raise ValueError(
                f"prompt of {L} tokens leaves no room to generate within "
                f"max_len {self.config.max_len}"
            )
        suffix = [int(t) for t in toks[n_cached:]]
        logits = self.chunk([suffix], [seq_id], [n_cached])
        self._tokens_prefilled += len(suffix)
        self._tokens_prefix_cached += n_cached
        return logits[0, len(suffix) - 1]

    def make_writable(self, seq_id, position: int) -> bool:
        """Copy-on-write guard before a K/V write at ``position``: the
        accounting split of :meth:`PagedKVCache.make_writable`, then the
        device page copy.  Returns whether a split happened.  May raise
        :class:`~chainermn_tpu_torch.serving.kv_cache.OutOfBlocks`."""
        split = self.kv.make_writable(seq_id, position)
        if split is None:
            return False
        old, new = split
        self._mirror("cow", int(old), int(new))
        self._cow(int(old), int(new))
        self._cow_splits += 1
        return True

    def _note_kv_err(self, err: float) -> None:
        """Fold one step's KV round-trip quantization error into the
        running max and publish the ``serve/kv_quant_err`` gauge when
        telemetry is active."""
        self._kv_quant_err = max(self._kv_quant_err, float(err))
        from ..observability import reporter as _reporter
        from ..observability import spans as _spans

        if _spans.telemetry_active():
            rep = _reporter.get_reporter()
            if rep is not None:
                rep.gauge("serve/kv_quant_err", self._kv_quant_err)

    # -- speculative drafts --------------------------------------------
    def propose_draft(self, context, n_draft: int) -> List[int]:
        """Up to ``n_draft`` draft tokens continuing ``context`` from the
        resolved draft source (n-gram lookup or the truncated model)."""
        if n_draft <= 0:
            return []
        if self.draft_model is not None:
            return self.draft_model.propose(context, n_draft)
        return _ngram_draft(context, n_draft)

    # -- sampling ------------------------------------------------------
    @staticmethod
    def sample(logits: np.ndarray, params: SamplingParams,
               position: int) -> int:
        """Sample one token from fp32 (vocab,) logits.  Greedy at
        ``temperature == 0`` (np.argmax — first max on ties).  Otherwise
        counter-based: the RNG is seeded from ``(seed, position)`` alone,
        so the draw does not depend on batch composition, scheduling
        order, or preemption history."""
        if params.temperature == 0.0:
            return int(np.argmax(logits))
        z = logits.astype(np.float64) / params.temperature
        if params.top_k:
            k = min(params.top_k, z.shape[-1])
            cutoff = np.partition(z, -k)[-k]
            z = np.where(z >= cutoff, z, -np.inf)
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        rng = np.random.default_rng((int(params.seed), int(position)))
        return int(rng.choice(p.shape[-1], p=p))

    # -- maintenance ---------------------------------------------------
    def defragment(self) -> int:
        """Compact the page pool (see :meth:`PagedKVCache.defragment`) and
        permute the device pages to match.  Returns the number of pages
        moved (0 = already compact, no device copy)."""
        perm = self.kv.defragment()
        if perm is None:
            return 0
        self._mirror("defrag", np.asarray(perm))
        self._permute(perm)
        return int(self.kv._last_defrag_moves)

    def reset(self) -> None:
        """Drop every sequence and the prefix index (device pages are left
        as they are — unreachable without a table entry)."""
        for sid in self.kv.seq_ids():
            self.kv.free(sid)
        self.kv.drop_prefix_cache()

    # -- introspection -------------------------------------------------
    def stats(self) -> dict:
        """Occupancy and shape bookkeeping, the reference's keys (its
        ``*_jit_cache_size`` cross-checks are XLA's and absent here)."""
        out = {
            "cache": self.kv.stats().as_dict(),
            "prefill_compiles": len(self._prefill_shapes),
            "decode_compiles": len(self._decode_shapes),
            "chunk_compiles": len(self._chunk_shapes),
            "prefill_shapes": sorted(self._prefill_shapes),
            "decode_shapes": sorted(self._decode_shapes),
            "chunk_shapes": sorted(self._chunk_shapes),
            "tokens_prefilled": self._tokens_prefilled,
            "tokens_decoded": self._tokens_decoded,
            "tokens_chunked": self._tokens_chunked,
            "tokens_prefix_cached": self._tokens_prefix_cached,
            "cow_splits": self._cow_splits,
        }
        if self.kv_dtype is not None:
            out["kv_dtype"] = self.kv_dtype
            out["kv_quant_err"] = self._kv_quant_err
        if self.draft_model is not None:
            out["draft_source"] = self.draft_source
            out["draft_layers"] = self.draft_model.n_layers
            out["draft_compiles"] = self.draft_model.compiles
        if self.sp:
            out["sp"] = self.sp
            out["sp_chunk_compiles"] = len(self._sp_shapes)
            out["sp_chunk_shapes"] = sorted(self._sp_shapes)
        if self.prefill_chunk:
            out["prefill_chunk"] = self.prefill_chunk
        if self._bucket_growths:
            out["bucket_growths"] = self._bucket_growths
        out["max_bucket"] = self._max_prefilled
        return out

    # -- convenience ---------------------------------------------------
    def generate(self, prompt, max_new_tokens: int,
                 sampling: Optional[SamplingParams] = None,
                 stop_token: Optional[int] = None) -> List[int]:
        """Single-request generation through the same prefill/decode steps
        the scheduler drives — the sequential oracle of the batching
        contract."""
        sp = sampling or SamplingParams()
        toks = list(np.asarray(prompt, np.int32).reshape(-1))
        L = len(toks)
        total = min(L + max_new_tokens, self.config.max_len)
        sid = object()
        self.kv.allocate(sid, L)
        try:
            logits = self.prefill(toks, sid)
            out: List[int] = []
            cur = L
            while cur < total:
                nxt = self.sample(logits, sp, cur)
                out.append(nxt)
                if stop_token is not None and nxt == stop_token:
                    break
                if cur + 1 >= total:
                    break
                self.kv.extend(sid, cur + 1)
                logits = self.decode([nxt], [sid], [cur])[0]
                cur += 1
            return out
        finally:
            self.kv.free(sid)
