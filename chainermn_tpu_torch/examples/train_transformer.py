"""Transformer encoder-decoder (WMT shape) with the two-dimensional
allreduce — the port of ``examples/wmt/train_transformer.py``
(BASELINE config #4).

Data-parallel training of :class:`~chainermn_tpu_torch.models.transformer
.Transformer` on ``SyntheticSeqDataset`` (target = reversed source), each
rank drawing its share of the global batch from its scattered shard,
through the ``two_dimensional`` communicator (intra-node reduce-scatter,
inter-node allreduce, intra-node all-gather) with the gradients on a
bf16 wire (``--comm-dtype``, the reference's fp16-comm analogue), AdamW
(weight decay 0.01) under a linear warm-up over 50 updates and a cosine
decay, as the reference's.  The loss is the cross-entropy over non-pad
targets, computed as optax computes it on the model's bf16 logits.

Run on the card (one process; ``torchrun --nproc-per-node N`` for more)::

    python -m chainermn_tpu_torch.examples.train_transformer

and on the CPU at a tiny size::

    python -m chainermn_tpu_torch.examples.train_transformer --device cpu \\
        --epochs 1 --batchsize 8 --d-model 32 --n-heads 2 --d-ff 64 \\
        --layers 1 --vocab 64 --seq-len 8

``main(argv)`` returns the last step's loss.
"""

from __future__ import annotations

import argparse
import time

import torch

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch.datasets.toy import SyntheticSeqDataset, batch_iterator
from chainermn_tpu_torch.models.seq2seq import shift_right
from chainermn_tpu_torch.models.transformer import Transformer
from chainermn_tpu_torch.optim import warmup_cosine_decay_schedule

WARMUP_STEPS = 50


def softmax_cross_entropy(logits, labels):
    """``optax.softmax_cross_entropy_with_integer_labels`` in the logits'
    dtype: shifted by the (constant) row max, the log of the sum of
    exponentials accumulated in fp32 and rounded to the logits' dtype, as
    ``jnp.sum`` does."""
    shifted = logits - logits.amax(-1, keepdim=True).detach()
    label_logits = shifted.gather(-1, labels[..., None].long())[..., 0]
    log_norm = torch.log(torch.exp(shifted).sum(-1, dtype=torch.float32)
                         .to(logits.dtype))
    return log_norm - label_logits


def masked_cross_entropy(logits, tgt):
    """Mean cross-entropy over the non-pad (``!= 0``) targets."""
    mask = (tgt != 0).float()
    ce = softmax_cross_entropy(logits, tgt)
    return (ce * mask).sum() / mask.sum()


def make_model(args, device) -> Transformer:
    return Transformer(vocab=args.vocab, d_model=args.d_model,
                       n_heads=args.n_heads, d_ff=args.d_ff,
                       n_enc_layers=args.layers, n_dec_layers=args.layers,
                       max_len=args.seq_len, device=device, seed=0)


def make_optimizer(model, comm, args, n_train: int):
    """AdamW (weight decay 0.01) under the reference's schedule: warm-up
    over 50 updates, cosine decay to 0 at ``max(200, epochs * n_train //
    batchsize)`` updates, ``n_train`` being the whole training set (what
    the reference's one process holds)."""
    sched = warmup_cosine_decay_schedule(
        0.0, args.lr, WARMUP_STEPS,
        max(200, args.epochs * n_train // args.batchsize))
    opt = cmn.create_multi_node_optimizer(
        torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=0.01),
        comm, lr_schedule=sched)
    opt.init()
    return opt


def make_loss_fn(model):
    def loss_fn(batch):
        src, tgt = batch
        return masked_cross_entropy(model(src, shift_right(tgt)), tgt)

    return loss_fn


def make_communicator(args):
    wire = None if args.comm_dtype == "none" else getattr(torch,
                                                          args.comm_dtype)
    return cmn.create_communicator(args.communicator, device=args.device,
                                   allreduce_grad_dtype=wire)


def parser():
    p = argparse.ArgumentParser(
        description="chainermn_tpu_torch WMT Transformer example")
    p.add_argument("--communicator", default="two_dimensional")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs over gloo)")
    p.add_argument("--batchsize", type=int, default=128, help="global batch")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--d-ff", type=int, default=1024)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--train-size", type=int, default=4096)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--comm-dtype", default="bfloat16",
                   help="allreduce_grad dtype (the fp16-comm analogue; "
                        "none for full precision)")
    p.add_argument("--steps", type=int, default=None)
    return p


def main(argv=None) -> float:
    args = parser().parse_args(argv)
    comm = make_communicator(args)
    if comm.rank == 0:
        print(f"communicator: {comm!r} comm-dtype={args.comm_dtype}")
    if args.batchsize % comm.size:
        raise SystemExit(f"--batchsize {args.batchsize} must divide by the "
                         f"rank count {comm.size}")
    local_bs = args.batchsize // comm.size

    full = SyntheticSeqDataset(n=args.train_size, src_len=args.seq_len,
                               tgt_len=args.seq_len, vocab=args.vocab)
    train = cmn.scatter_dataset(full, comm, shuffle=True, seed=0)
    dev = comm.device
    model = make_model(args, dev)
    opt = make_optimizer(model, comm, args, len(full))
    step = opt.make_train_step(make_loss_fn(model), local_batch=True)

    n_steps, last = 0, torch.tensor(float("nan"))
    for epoch in range(args.epochs):
        t0, n_tok = time.perf_counter(), 0
        for src, tgt in batch_iterator(train, local_bs, seed=epoch):
            batch = (torch.from_numpy(src).to(dev, non_blocking=True),
                     torch.from_numpy(tgt).long().to(dev, non_blocking=True))
            last = step(batch)
            n_tok += (src.size + tgt.size) * comm.size
            n_steps += 1
            if args.steps and n_steps >= args.steps:
                break
        loss = float(last)                  # waits for the device
        dt = time.perf_counter() - t0
        if comm.rank == 0:
            print(f"epoch {epoch}: loss {loss:.4f} ({n_tok / dt:,.0f} tok/s "
                  f"over {comm.size} devices)", flush=True)
    return float(last)


if __name__ == "__main__":
    main()
