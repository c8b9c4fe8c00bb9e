"""Model-parallel seq2seq — the port of ``examples/seq2seq/seq2seq.py``
(BASELINE config #3), ChainerMN's model-parallel showcase.

The encoder (:class:`~chainermn_tpu_torch.models.seq2seq.Encoder`) runs
on rank 0 and the decoder on the last rank, wired by
:class:`~chainermn_tpu_torch.links.MultiNodeChainList`: the encoder's
final GRU states cross ranks by ``send``/``recv`` and their gradient
comes back in backward.  Every rank takes the same batch (rank 0 draws
it and broadcasts it, ChainerMN's multi-node iterator).  Two parameter
tiers:

* replicated (default): every rank holds both models, computes the
  gradients of the one it owns, and the gradients are summed over the
  ranks so that every rank applies the same Adam update;
* ``--sharded-params``: each rank keeps one flat fp32 row of its own
  component's parameters and its Adam state, and updates only that.

Trained on ``SyntheticSeqDataset`` (target = reversed source), then
evaluated on a fresh set: teacher-forced token accuracy, and BLEU of a
greedy decode that reruns the decoder over the prefix at each step.
With one rank both components sit on rank 0 and every transfer is a
local pass-through.

Run on the card (one process; ``torchrun --nproc-per-node N`` for more)::

    python -m chainermn_tpu_torch.examples.seq2seq

and on the CPU at a tiny size::

    python -m chainermn_tpu_torch.examples.seq2seq --device cpu \\
        --communicator naive --epochs 1 --batchsize 8 --unit 32 \\
        --vocab 64 --seq-len 8 --train-size 32

``main(argv)`` returns the token accuracy; :func:`run` returns it with
the BLEU and every step's loss.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.func import functional_call

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch.datasets.scatter_dataset import SubDataset
from chainermn_tpu_torch.datasets.toy import SyntheticSeqDataset, batch_iterator
from chainermn_tpu_torch.examples.train_transformer import masked_cross_entropy
from chainermn_tpu_torch.iterators import create_multi_node_iterator
from chainermn_tpu_torch.links import MultiNodeChainList
from chainermn_tpu_torch.models.seq2seq import BOS, Decoder, Encoder, shift_right
from chainermn_tpu_torch.utils.metrics import corpus_bleu, strip_special


def build_chain(comm, encoder, decoder):
    """Encoder on rank 0, decoder on the last rank; the chain's input is
    the ``(src, tgt)`` batch and its output the decoder's logits."""
    enc_rank, dec_rank = 0, comm.size - 1
    chain = MultiNodeChainList(comm)
    chain.add_link(lambda p, batch: functional_call(encoder, p, (batch[0],)),
                   rank=enc_rank, rank_out=dec_rank)
    chain.add_link(
        lambda p, inp: functional_call(
            decoder, p, (inp[0], shift_right(inp[1][1]))),
        rank=dec_rank, rank_in=enc_rank, needs_input=True)
    return chain


def ce_loss(logits, batch):
    return masked_cross_entropy(logits, batch[1])


def make_replicated_step(chain, params_list, comm, lr):
    """Adam over every component's parameters; the gradients (each rank
    has those of its own components) are summed over the ranks, so every
    rank applies the same update."""
    params = [p for tree in params_list for p in tree.values()]
    opt = torch.optim.Adam(params, lr=lr)

    def step(batch):
        opt.zero_grad(set_to_none=True)
        loss = ce_loss(chain.apply(params_list, batch), batch)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        if comm.size > 1:
            total = comm.allreduce(torch.cat([g.reshape(-1) for g in grads]),
                                   "sum")
            for p, g in zip(params, total.split([g.numel() for g in grads])):
                p.grad = g.view_as(p)
        opt.step()
        return loss.detach()

    return step


def greedy_decode(encoder, decoder, params_list, src, steps):
    """Greedy decoding: each step reruns the decoder over the prefix."""
    enc_p, dec_p = params_list
    h = functional_call(encoder, enc_p, (src,))
    toks = torch.full((src.shape[0], 1), BOS, dtype=torch.long,
                      device=src.device)
    for _ in range(steps):
        logits = functional_call(decoder, dec_p, (h, toks))
        toks = torch.cat([toks, logits[:, -1].argmax(-1)[:, None]], dim=1)
    return toks[:, 1:]


def parser():
    p = argparse.ArgumentParser(description="chainermn_tpu_torch seq2seq "
                                            "example")
    p.add_argument("--communicator", default="xla_ici")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs over gloo)")
    p.add_argument("--batchsize", type=int, default=64)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--unit", type=int, default=128)
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--seq-len", type=int, default=12)
    p.add_argument("--train-size", type=int, default=2048)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--sharded-params", action="store_true",
                   help="stage-sharded parameter storage: each rank holds "
                        "only its own component (encoder or decoder)")
    return p


def run(args) -> dict:
    comm = cmn.create_communicator(args.communicator, device=args.device)
    if comm.rank == 0:
        print(f"communicator: {comm!r}; encoder on rank 0, decoder on rank "
              f"{comm.size - 1}")
    full = SyntheticSeqDataset(n=args.train_size, src_len=args.seq_len,
                               tgt_len=args.seq_len, vocab=args.vocab)
    # The reference's scatter of the whole set to its one process.
    train = SubDataset(full, np.random.RandomState(0).permutation(len(full)))
    dev = comm.device
    encoder = Encoder(args.vocab, args.unit, device=dev, seed=0)
    decoder = Decoder(args.vocab, args.unit, device=dev, seed=1)
    params_list = (dict(encoder.named_parameters()),
                   dict(decoder.named_parameters()))
    chain = build_chain(comm, encoder, decoder)
    if args.sharded_params:
        def adam(ps):
            return torch.optim.Adam(ps, lr=args.lr)

        row = chain.shard_params(params_list)
        opt_state = chain.init_sharded_opt_state(adam, row)
        sharded_step = chain.make_sharded_train_step(adam, ce_loss)
    else:
        step = make_replicated_step(chain, params_list, comm, args.lr)

    losses = []
    for epoch in range(args.epochs):
        t0, epoch_losses = time.perf_counter(), []
        batches = batch_iterator(train, args.batchsize, seed=epoch)
        if comm.size > 1:
            batches = create_multi_node_iterator(batches, comm)
        for src, tgt in batches:
            batch = (torch.from_numpy(src).long().to(dev),
                     torch.from_numpy(tgt).long().to(dev))
            if args.sharded_params:
                row, opt_state, loss = sharded_step(row, opt_state, batch)
            else:
                loss = step(batch)
            epoch_losses.append(loss)
        epoch_losses = torch.stack(epoch_losses).tolist()  # waits once
        losses += epoch_losses
        if comm.rank == 0:
            print(f"epoch {epoch}: loss {epoch_losses[-1]:.4f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    if args.sharded_params:
        params_list = chain.materialize_params(row)

    test = SyntheticSeqDataset(n=256, src_len=args.seq_len,
                               vocab=args.vocab, seed=9)
    src = torch.from_numpy(test.src).long().to(dev)
    tgt = torch.from_numpy(test.tgt).long().to(dev)
    with torch.no_grad():
        logits = chain.apply(params_list, (src, tgt))
        acc = float((logits.argmax(-1) == tgt).float().mean())
        hyp = greedy_decode(encoder, decoder, params_list, src,
                            args.seq_len).cpu().numpy()
    bleu = corpus_bleu([strip_special(r) for r in test.tgt],
                       [strip_special(h) for h in hyp])
    if comm.rank == 0:
        print(f"token accuracy (teacher-forced): {acc:.4f}  "
              f"BLEU (greedy): {bleu * 100:.2f}", flush=True)
    return {"accuracy": acc, "bleu": bleu, "losses": losses}


def main(argv=None) -> float:
    return run(parser().parse_args(argv))["accuracy"]


if __name__ == "__main__":
    main()
