"""Long-context causal language-model training — the port of
``examples/long_context/train_lm.py``.

The long-context stack, one flag each:

* ``--sp none``: each rank holds whole sequences (pure data parallelism
  through ``create_multi_node_optimizer(...).make_train_step``); the
  attention is the hand-written flash kernels (``--no-flash``: dense
  attention), with ``--window`` (sliding window), ``--kv-heads`` (GQA)
  and ``--packed`` (segment masks) riding the kernels.
* ``--sp ring``, ``zigzag`` or ``ulysses``: the sequence is sharded over
  the communicator's ``intra`` axis (``--dp`` ways of data parallelism on
  ``inter``), with :mod:`~chainermn_tpu_torch.parallel.ring_attention`
  (K/V blocks rotating; zigzag the load-balanced causal layout, its
  inner blocks on the flash kernels on a card) or
  :mod:`~chainermn_tpu_torch.parallel.ulysses` (head <-> sequence
  all-to-all around the flash kernels).  ``position_offset`` gives each
  shard its global positions (the zigzag permutation included).
* ``--vocab-tp``: the embedding table and LM head are vocab-sharded over
  the same ``intra`` ranks (:mod:`~chainermn_tpu_torch.parallel.sharding`):
  each rank embeds the full rows with ``vocab_parallel_embed`` (its
  cotangent summed over the ranks), runs its sequence shard, gathers the
  final hidden states with ``gather_seq_for_replicated_head`` and takes
  the vocab-parallel cross-entropy.

The loss is the reference's in each mode.  ``--sp none``: the dense
logits' cross-entropy (optax's, in the logits' dtype) summed over this
rank's rows over ``denom / world`` (``denom`` the predicted positions of
the global batch), averaged over the ranks by the optimizer.  SP: each
rank's sum over ``denom``, loss and gradients SUMMED over every rank.
Vocab-TP: the replicated mean of the sharded CE; the transformer's
gradients summed over every rank and divided by ``dp``, the table
shard's summed over ``inter`` only and divided by ``dp``.  The optimizer
is ``optax.adamw(lr, weight_decay=0.01)`` in optax's order
(:class:`~chainermn_tpu_torch.optim.OptaxAdamW`).

Data: successor sequences (next token = current + 1 mod vocab, random
start) drawn from ``RandomState(0)``, the same global batch on every
rank; ``--packed`` puts two documents in a row, positions restarting at
the boundary.  ``--checkpoint-dir`` saves every ``--checkpoint-every``
steps; a relaunch resumes and replays the consumed draws, so the resumed
run sees the same data.

Run on the card (one process; ``torchrun --nproc-per-node N`` for
more)::

    python -m chainermn_tpu_torch.examples.train_lm

and on the CPU at a tiny size::

    python -m chainermn_tpu_torch.examples.train_lm --device cpu \\
        --seq-len 64 --batchsize 4 --d-model 32 --n-heads 4 --d-ff 64 \\
        --layers 1 --vocab 64 --epochs 1 --steps-per-epoch 4 \\
        --dtype float32

``main(argv)`` returns the last step's loss.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch.convert import vocab_shard
from chainermn_tpu_torch.examples.train_mnist import params_digest
from chainermn_tpu_torch.examples.train_transformer import (
    softmax_cross_entropy)
from chainermn_tpu_torch.models.transformer import TransformerLM
from chainermn_tpu_torch.ops import make_flash_attention_fn
from chainermn_tpu_torch.optim import OptaxAdamW
from chainermn_tpu_torch.parallel import ring_attention as ra
from chainermn_tpu_torch.parallel import sharding
from chainermn_tpu_torch.parallel.ulysses import make_ulysses_attention_fn
from chainermn_tpu_torch.utils.profiling import sync

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def successor_batch(rng, batch, seq_len, vocab):
    start = rng.randint(0, vocab, size=(batch, 1))
    seq = (start + np.arange(seq_len)[None, :]) % vocab
    return seq.astype(np.int32)


def data_stream(args, perm):
    """The global batches ``(tokens, targets)``, one a step, drawn from
    ``RandomState(0)`` as the reference draws them and put in the shard
    layout's order ``perm``.  ``--packed``: two documents a row, the
    targets rolled within each (its last position has weight 0)."""
    S, B, vocab = args.seq_len, args.batchsize, args.vocab
    rng = np.random.RandomState(0)
    while True:
        if args.packed:
            halves = [successor_batch(rng, B, S // 2, vocab)
                      for _ in range(2)]
            tok = np.concatenate(halves, axis=1)
            tgt = np.concatenate([np.roll(h, -1, axis=1) for h in halves],
                                 axis=1)
        else:
            tok = successor_batch(rng, B, S, vocab)
            tgt = np.roll(tok, -1, axis=1)
        yield tok[:, perm], tgt[:, perm]


def parser():
    p = argparse.ArgumentParser(
        description="chainermn_tpu_torch long-context LM example")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs over gloo)")
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--batchsize", type=int, default=8, help="global batch")
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--kv-heads", type=int, default=None,
                   help="GQA/MQA: K/V head count (divides --n-heads)")
    p.add_argument("--d-ff", type=int, default=1024)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--steps-per-epoch", type=int, default=20)
    p.add_argument("--sp", choices=["none", "ring", "zigzag", "ulysses"],
                   default="none",
                   help="sequence parallelism over the 'intra' axis "
                        "(zigzag = load-balanced causal ring)")
    p.add_argument("--no-flash", action="store_true",
                   help="dense attention instead of the flash kernels "
                        "(sp=none only)")
    p.add_argument("--window", type=int, default=None,
                   help="sliding-window attention size (sp none, ring, "
                        "ulysses; zigzag refuses it)")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel ways (inter axis); rest is sequence")
    p.add_argument("--vocab-tp", action="store_true",
                   help="vocab-parallel embedding + cross-entropy over the "
                        "sequence axis (needs --sp != none and vocab "
                        "divisible by the sp ways)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save every --checkpoint-every steps and resume "
                        "from the newest generation on relaunch")
    p.add_argument("--checkpoint-every", type=int, default=10)
    p.add_argument("--checkpoint-name", default="long_context")
    p.add_argument("--packed", action="store_true",
                   help="two documents per row, attention kept inside each "
                        "by segment ids through every attention backend")
    return p


def _check(args, sp_ways: int):
    """The reference's refusals, in its order."""
    S, vocab = args.seq_len, args.vocab
    if args.packed and args.sp == "none" and args.no_flash:
        raise SystemExit(
            "--packed with --sp none needs the flash kernel's segment "
            "masks: drop --no-flash")
    if args.window is not None and (
            args.sp == "zigzag" or (args.sp == "none" and args.no_flash)):
        raise SystemExit(
            "--window: supported with --sp none (flash kernel band), ring "
            "(global-position band), or ulysses (full sequence after the "
            "head all-to-all); zigzag's chunk schedule is derived from "
            "FULL causality and would need its own banded block selection")
    if args.sp != "none" and sp_ways == 1:
        raise SystemExit(
            "sequence parallelism needs intra_size > 1; pass --dp to leave "
            "devices on the intra axis (e.g. --dp 1)")
    if args.vocab_tp:
        if args.sp == "none":
            raise SystemExit("--vocab-tp shards over the sequence axis; "
                             "pick an --sp mode")
        if vocab % sp_ways:
            raise SystemExit(f"--vocab-tp needs vocab ({vocab}) divisible "
                             f"by sp ways ({sp_ways})")
        if args.checkpoint_dir:
            raise SystemExit("--vocab-tp + --checkpoint-dir is not wired "
                             "up in this example yet")
    ways = sp_ways if args.sp != "none" else 1
    if S % ways:
        raise SystemExit(f"--seq-len {S} must divide by sp ways {ways}")
    if args.sp == "zigzag" and S % (2 * sp_ways):
        raise SystemExit(
            f"--sp zigzag needs --seq-len divisible by 2*sp ways "
            f"({2 * sp_ways}); got {S}")
    if args.sp == "ulysses" and args.n_heads % sp_ways:
        raise SystemExit("--sp ulysses needs n_heads % sp ways == 0")
    if args.kv_heads is not None:
        if args.n_heads % args.kv_heads:
            raise SystemExit("--kv-heads must divide --n-heads")
        if args.sp == "ulysses" and args.kv_heads % sp_ways:
            raise SystemExit("--sp ulysses needs kv_heads % sp ways == 0")


def _sum_over(comm, tensors):
    """Sum each tensor over the ranks of ``comm``, in one collective."""
    if comm.size == 1:
        return list(tensors)
    flat = comm.allreduce(torch.cat([t.reshape(-1) for t in tensors]), "sum")
    out, pos = [], 0
    for t in tensors:
        out.append(flat[pos:pos + t.numel()].view_as(t))
        pos += t.numel()
    return out


class LongContextLM:
    """The example's model, communicators and step on one rank."""

    def __init__(self, args, comm=None):
        if comm is None:
            comm = cmn.create_communicator("xla_ici", device=args.device,
                                           inter_size=args.dp)
        self.args, self.comm = args, comm
        self.dp, self.sp_ways = comm.inter_size, comm.intra_size
        S, B = args.seq_len, args.batchsize
        _check(args, self.sp_ways)
        sp = args.sp
        if B % (comm.size if sp == "none" else self.dp):
            raise SystemExit(f"--batchsize {B} must divide by the "
                             f"data-parallel ways")
        self.sp_comm = self.dp_comm = None
        if sp != "none":
            self.sp_comm = comm.split(("intra",))
            self.dp_comm = comm.split(("inter",))
        seg_row = (np.arange(S) >= S // 2).astype(np.int32) \
            if args.packed else None
        self.seq_perm = (ra.zigzag_indices(S, self.sp_ways) if sp == "zigzag"
                         else np.arange(S))
        if sp == "none":
            attention_fn = None if args.no_flash else make_flash_attention_fn(
                q_segment_ids=seg_row, window=args.window)
        elif sp == "ring":
            attention_fn = ra.make_ring_attention_fn(
                self.sp_comm, segment_ids=seg_row, window=args.window)
        elif sp == "zigzag":
            attention_fn = ra.make_zigzag_ring_attention_fn(
                self.sp_comm, segment_ids=None if seg_row is None
                else seg_row[self.seq_perm])
        else:
            attention_fn = make_ulysses_attention_fn(
                self.sp_comm, segment_ids=seg_row, window=args.window)
        dev = comm.device
        self.model = TransformerLM(
            vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
            d_ff=args.d_ff, n_layers=args.layers, max_len=S,
            dtype=DTYPES[args.dtype], attention_fn=attention_fn,
            n_kv_heads=args.kv_heads, device=dev, seed=0)
        # Predicted positions: each packed document loses its last token.
        self.denom = B * (S - 2) if args.packed else B * (S - 1)
        # Positions restart at the packing boundary (global order
        # otherwise), carried through the shard layout's permutation.
        base = (np.concatenate([np.arange(S // 2)] * 2) if args.packed
                else np.arange(S))
        self.positions = torch.from_numpy(
            base[self.seq_perm].astype(np.int64)).to(dev)
        wt = np.ones((B, S), np.float32)
        wt[:, -1] = 0.0                  # the last position has no successor
        if args.packed:
            wt[:, S // 2 - 1] = 0.0      # nor the first document's last
        self.wt = wt[:, self.seq_perm]
        if args.vocab_tp:
            self.embed_shard = torch.nn.Parameter(vocab_shard(
                self.model.embed.weight.detach(), self.sp_comm.rank,
                self.sp_ways).clone())
            self.model.embed.weight.requires_grad_(False)
            self.params = [p for n, p in self.model.named_parameters()
                           if n != "embed.weight"] + [self.embed_shard]
        else:
            self.params = list(self.model.parameters())
        self.opt = OptaxAdamW(self.params, args.lr, weight_decay=0.01)
        self.mn_opt = None
        if sp == "none":
            self.mn_opt = cmn.create_multi_node_optimizer(self.opt, comm)
            self.mn_opt.init()
            self._dp_step = self.mn_opt.make_train_step(self._loss_none)

    # -- state --------------------------------------------------------------
    def load(self, state: dict):
        """Copy a full model ``state_dict`` (the unsharded table included)
        into this rank's parameters (its vocab rows under ``--vocab-tp``)."""
        with torch.no_grad():
            self.model.load_state_dict(state)
            if self.args.vocab_tp:
                self.embed_shard.copy_(vocab_shard(
                    self.model.embed.weight, self.sp_comm.rank,
                    self.sp_ways))

    def state(self) -> dict:
        """This rank's parameters: the model's ``state_dict`` and, under
        ``--vocab-tp``, its table shard as ``embed_shard``."""
        out = {k: v.detach() for k, v in self.model.state_dict().items()}
        if self.args.vocab_tp:
            out.pop("embed.weight")
            out["embed_shard"] = self.embed_shard.detach()
        return out

    def snapshot(self) -> dict:
        return {"model": self.model.state_dict(),
                "opt": (self.mn_opt or self.opt).state_dict()}

    def restore(self, snap: dict):
        self.model.load_state_dict(snap["model"])
        (self.mn_opt or self.opt).load_state_dict(snap["opt"])

    # -- steps --------------------------------------------------------------
    def _loss_none(self, batch):
        tok, tgt, wt = batch
        pos = self.positions if self.args.packed else None
        logits = self.model(tok, position_offset=pos)
        ce = softmax_cross_entropy(logits, tgt)
        # This rank's share of the predicted positions; the optimizer
        # averages over the ranks.
        return (ce.float() * wt).sum() / (self.denom / self.comm.size)

    def _rows(self, x):
        """This rank's data row of a (B, ...) array, on the device."""
        n = self.args.batchsize // self.dp
        r = self.comm.inter_rank
        return torch.as_tensor(x[r * n:(r + 1) * n]).to(self.comm.device)

    def step(self, tok, tgt):
        """One training step on the global batch (numpy, already in the
        shard layout's order); returns the loss (a 0-d tensor)."""
        if self.args.sp == "none":
            dev = self.comm.device
            batch = tuple(torch.as_tensor(a).to(dev)
                          for a in (tok, tgt, self.wt))
            return self._dp_step((batch[0].long(), batch[1].long(), batch[2]))
        if self.args.vocab_tp:
            return self._step_vocab_tp(tok, tgt)
        return self._step_sp(tok, tgt)

    def _local(self, x):
        S_loc = self.args.seq_len // self.sp_ways
        j = self.comm.intra_rank
        return x[:, j * S_loc:(j + 1) * S_loc]

    def _step_sp(self, tok, tgt):
        tok_l, tgt_l, wt_l = (self._local(self._rows(a))
                              for a in (tok, tgt, self.wt))
        with torch.enable_grad():
            logits = self.model(tok_l.long(),
                                position_offset=self._local(
                                    self.positions[None])[0])
            ce = softmax_cross_entropy(logits, tgt_l.long())
            # A sum over this shard; the global mean by summing over every
            # rank (shards hold different counts of weighted positions).
            loss = (ce.float() * wt_l).sum() / self.denom
            grads = torch.autograd.grad(loss, self.params)
        grads = _sum_over(self.comm, list(grads))
        self.opt.update(grads)
        return self.comm.allreduce(loss.detach().reshape(1), "sum")[0]

    def _step_vocab_tp(self, tok, tgt):
        sp_comm = self.sp_comm
        tok_f, tgt_f, wt_f = (self._rows(a) for a in (tok, tgt, self.wt))
        with torch.enable_grad():
            # Each rank consumes its own sequence slice: the table's
            # cotangent is summed over the ranks inside the embed backward.
            x_f = sharding.vocab_parallel_embed(tok_f, self.embed_shard,
                                                sp_comm, True)
            h_l = self.model(self._local(tok_f).long(),
                             position_offset=self._local(
                                 self.positions[None])[0],
                             return_hidden=True,
                             inputs_embeds=self._local(x_f))
            # The CE's gradient is the same on every rank: the gather's
            # backward slices it instead of summing n copies.
            h_f = sharding.gather_seq_for_replicated_head(h_l, sp_comm, 1)
            labels = torch.where(wt_f > 0, tgt_f.long(),
                                 torch.full_like(tgt_f.long(), -1))
            loss = sharding.vocab_parallel_cross_entropy(
                h_f, self.embed_shard, labels, sp_comm)
            grads = torch.autograd.grad(loss, self.params)
        # Transformer: sequence partials summed over intra, rows over
        # inter, /dp for the data-parallel mean.  The table shard is
        # complete over intra; only the data-parallel mean remains.
        rest = [g / self.dp for g in _sum_over(self.comm, list(grads[:-1]))]
        (emb,) = _sum_over(self.dp_comm, [grads[-1]])
        self.opt.update(rest + [emb / self.dp])
        return self.dp_comm.allreduce(loss.detach().reshape(1), "mean")[0]


def main(argv=None) -> float:
    args = parser().parse_args(argv)
    ex = LongContextLM(args)
    comm = ex.comm
    B, S = args.batchsize, args.seq_len
    if comm.rank == 0:
        n_params = sum(p.numel() for p in ex.model.parameters())
        print(f"mesh: data={ex.dp} x seq={ex.sp_ways}; sp={args.sp} "
              f"flash={args.sp == 'none' and not args.no_flash} "
              f"params={n_params / 1e6:.1f}M seq_len={S}", flush=True)
    stream = data_stream(args, ex.seq_perm)
    ckpt = None
    resume_step = gstep = 0
    if args.checkpoint_dir:
        from chainermn_tpu_torch.extensions import (
            create_multi_node_checkpointer)
        from chainermn_tpu_torch.global_except_hook import add_hook

        add_hook()
        ckpt = create_multi_node_checkpointer(
            args.checkpoint_name, comm, path=args.checkpoint_dir)
        loaded, it = ckpt.maybe_load(ex.snapshot())
        if it is not None:
            ex.restore(loaded)
            resume_step = gstep = it
            if comm.rank == 0:
                print(f"resumed from step {it}", flush=True)
    last = torch.tensor(float("nan"))
    for epoch in range(args.epochs):
        t0, n_tok = time.perf_counter(), 0
        for i in range(args.steps_per_epoch):
            # The stream's position is what a resume replays.
            tok, tgt = next(stream)
            if epoch * args.steps_per_epoch + i < resume_step:
                continue
            last = ex.step(tok, tgt)
            n_tok += B * S
            gstep += 1
            if ckpt is not None and gstep % args.checkpoint_every == 0:
                ckpt.save(ex.snapshot(), gstep, block=False)
        if n_tok:
            sync(last)
        dt = time.perf_counter() - t0
        if comm.rank == 0 and n_tok:
            print(f"epoch {epoch}: loss {float(last):.4f} "
                  f"({n_tok / dt:,.0f} tok/s)", flush=True)
    if ckpt is not None:
        ckpt.wait()
        digest = params_digest(ex.model.parameters())
        if comm.rank == 0:
            print(f"final step {gstep} params_digest {digest:08x}",
                  flush=True)
    return float(last)


if __name__ == "__main__":
    main()
