"""Data-parallel MNIST MLP — the port of ``examples/mnist/train_mnist.py``.

ChainerMN's canonical example: ``create_communicator`` →
``scatter_dataset`` → ``create_multi_node_optimizer`` → train, with a
multi-node evaluator and an optional multi-node checkpointer that resumes
a relaunched run from the newest consistent generation, mid-epoch.  Each
rank draws its share of the global batch from its scattered shard.  The
data is ``SyntheticImageDataset`` (MNIST's shapes, made from a seed).

Run on the card (one process; ``torchrun --nproc-per-node N`` for more)::

    python -m chainermn_tpu_torch.examples.train_mnist --communicator pure_nccl

and on the CPU::

    python -m chainermn_tpu_torch.examples.train_mnist --device cpu \\
        --communicator naive --epochs 2 --unit 128 --train-size 2048 \\
        --val-size 512

At the end it prints ``final gstep G params_digest XXXXXXXX``: the number
of steps taken and a crc32 of the parameters' bytes, equal between a run
and the same run stopped and resumed from its checkpoint.
"""

from __future__ import annotations

import argparse
import time
import zlib

import torch
import torch.nn.functional as F

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch.datasets.toy import (SyntheticImageDataset,
                                              batch_iterator)
from chainermn_tpu_torch.extensions import Evaluator
from chainermn_tpu_torch.models import MLP


def params_digest(params) -> int:
    """crc32 over the parameters' bytes, in order."""
    crc = 0
    for p in params:
        raw = p.detach().to("cpu").contiguous().reshape(-1)
        crc = zlib.crc32(raw.view(torch.uint8).numpy(), crc)
    return crc


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="chainermn_tpu_torch MNIST example")
    p.add_argument("--communicator", default="xla_ici")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs over gloo)")
    p.add_argument("--bucket-bytes", type=int, default=None,
                   help="gradient-allreduce bucket cap in bytes "
                        "(0 disables bucketing; default 4 MiB)")
    p.add_argument("--comm-dtype", default=None,
                   help="gradient wire: int8 or fp8 (default: "
                        "CHAINERMN_TPU_COMM_DTYPE, else full precision)")
    p.add_argument("--batchsize", type=int, default=256,
                   help="global batch size")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--unit", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--double-buffering", action="store_true")
    p.add_argument("--zero-stage", type=int, default=0, choices=(0, 1, 2, 3),
                   help="ZeRO sharding stage (composes with "
                        "--double-buffering)")
    p.add_argument("--train-size", type=int, default=8192)
    p.add_argument("--val-size", type=int, default=1024)
    p.add_argument("--checkpoint-dir", default=None,
                   help="save generations here and resume from the newest "
                        "consistent one on relaunch")
    p.add_argument("--checkpoint-every", type=int, default=10,
                   help="save a generation every N global steps")
    p.add_argument("--checkpoint-name", default="mnist",
                   help="checkpoint set name under --checkpoint-dir")
    p.add_argument("--elastic", action="store_true",
                   help="not ported yet (ROADMAP A.7, the host planes)")
    p.add_argument("--step-log", default=None, metavar="PATH",
                   help="not ported yet (ROADMAP A.7, the host planes)")
    args = p.parse_args(argv)
    for flag, on in (("--elastic", args.elastic),
                     ("--step-log", args.step_log)):
        if on:
            raise SystemExit(f"{flag} belongs to the host planes, which "
                             "the port does not have yet (ROADMAP A.7)")

    comm = cmn.create_communicator(
        args.communicator, device=args.device,
        bucket_bytes=args.bucket_bytes, comm_dtype=args.comm_dtype)
    if comm.rank == 0:                  # reference pattern: rank 0 logs
        print(f"communicator: {comm!r}")
        print(f"global batch {args.batchsize} over {comm.size} ranks")
    if args.batchsize % comm.size:
        raise SystemExit(f"--batchsize {args.batchsize} must divide by the "
                         f"rank count {comm.size}")
    local_bs = args.batchsize // comm.size

    train = SyntheticImageDataset(n=args.train_size, seed=0)
    val = SyntheticImageDataset(n=args.val_size, seed=1)
    train = cmn.scatter_dataset(train, comm, shuffle=True, seed=42)
    val = cmn.scatter_dataset(val, comm)

    dev = comm.device
    model = MLP(n_units=args.unit, n_out=10, device=dev, seed=0)
    opt = cmn.create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=args.lr), comm,
        double_buffering=args.double_buffering, zero_stage=args.zero_stage)
    opt.init()

    def loss_fn(batch):
        x, y = batch
        return F.cross_entropy(model(x), y)

    def metric_fn(model, batch):
        x, y = batch
        logits = model(x)
        return {"val/loss": F.cross_entropy(logits, y),
                "val/accuracy": (logits.argmax(-1) == y).float().mean()}

    step = opt.make_train_step(loss_fn, local_batch=True)
    # ZeRO reduce-scatters one flat buffer at full precision: the narrow
    # wire carries only the bucketed stage-0 allreduce, as in the reference.
    wire = comm.wire_dtype() if args.zero_stage == 0 else None
    if comm.rank == 0 and wire is not None:
        print(f"gradient wire: {str(wire).split('.')[1]}")
    evaluator = Evaluator(metric_fn, comm)

    def on_device(batch):
        x, y = batch
        return (torch.from_numpy(x).to(dev, non_blocking=True),
                torch.from_numpy(y).long().to(dev, non_blocking=True))

    def snapshot(epoch, n_steps):
        return {"model": None if args.zero_stage == 3 else model.state_dict(),
                "opt": opt.state_dict(), "epoch": epoch, "step": n_steps}

    ckpt = None
    start_epoch = start_step = gstep = 0
    resumed = None
    if args.checkpoint_dir:
        from chainermn_tpu_torch.extensions import (
            create_multi_node_checkpointer)
        from chainermn_tpu_torch.global_except_hook import add_hook

        add_hook()
        ckpt = create_multi_node_checkpointer(
            args.checkpoint_name, comm, path=args.checkpoint_dir)
        loaded, it = ckpt.maybe_load(snapshot(0, 0))
        if it is not None:
            if loaded["model"] is not None:
                model.load_state_dict(loaded["model"])
            opt.load_state_dict(loaded["opt"])
            start_epoch, start_step = int(loaded["epoch"]), int(loaded["step"])
            gstep = resumed = it
            if comm.rank == 0:
                print(f"resumed from iteration {it} "
                      f"(epoch {start_epoch}, step {start_step})")

    metrics, epoch_losses, mean_losses, img_per_s = {}, [], [], []
    for epoch in range(start_epoch, args.epochs):
        t0 = time.perf_counter()
        n_seen = n_steps = n_trained = 0
        last_loss = torch.tensor(float("nan"))
        loss_sum = 0.0                  # on the device: no sync a step
        # Resuming into this epoch: replay the iterator (same epoch seed,
        # same permutation) and drop the batches already trained on.
        skip = start_step if epoch == start_epoch else 0
        for batch in batch_iterator(train, local_bs, seed=epoch):
            if skip > 0:
                skip -= 1
                n_steps += 1
                continue
            last_loss = step(on_device(batch))
            loss_sum = loss_sum + last_loss
            n_trained += 1
            n_seen += batch[0].shape[0] * comm.size
            n_steps += 1
            gstep += 1
            if ckpt is not None and gstep % args.checkpoint_every == 0:
                ckpt.save(snapshot(epoch, n_steps), gstep, block=False)
        loss = float(last_loss)               # waits for the device
        dt = time.perf_counter() - t0
        mean_losses.append(float(loss_sum) / max(1, n_trained))
        if args.zero_stage == 3:
            opt.materialize()
        metrics = evaluator.evaluate(
            model, (on_device(b) for b in
                    batch_iterator(val, local_bs, shuffle=False)))
        ips = n_seen / dt
        epoch_losses.append(loss)
        img_per_s.append(ips)
        if comm.rank == 0:
            print(f"epoch {epoch}: train/loss {loss:.4f}  "
                  + "  ".join(f"{k} {v:.4f}" for k, v in metrics.items())
                  + f"  ({ips:,.0f} img/s)", flush=True)
    if ckpt is not None:
        ckpt.wait()
    if args.zero_stage == 3:
        opt.materialize()
    digest = params_digest(model.parameters())
    if comm.rank == 0:
        print(f"final gstep {gstep} params_digest {digest:08x}", flush=True)
    return {"metrics": metrics, "epoch_losses": epoch_losses,
            "epoch_mean_losses": mean_losses,
            "img_per_s": img_per_s, "gstep": gstep,
            "params_digest": f"{digest:08x}", "resumed_from": resumed,
            "wire": None if wire is None else str(wire).split(".")[1]}


if __name__ == "__main__":
    main()
