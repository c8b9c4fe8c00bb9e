"""Data-parallel ImageNet — the port of ``examples/imagenet/train_imagenet.py``.

ChainerMN's throughput configuration: a ResNet-50 (or ResNet-18, AlexNet,
NiN, GoogLeNet) trained data-parallel with the linear-scaling rule
(``lr * global_batch / 256``) warmed up from 0 over ``--warmup-steps``
updates, SGD with momentum 0.9 or LARS (weight decay 1e-4).  Each rank
draws its share of the global batch from its scattered shard; the
models with BatchNorm train through ``make_train_step_with_state``
(local batch statistics, running buffers averaged over the ranks after
each step), the dropout models draw their masks from a generator seeded
per step and per rank.  A background thread assembles the batches and
stages them on the device through pinned memory (``--prefetch``), and
the loss is read back once per epoch.  The data is
``SyntheticImageDataset`` (ImageNet's shapes, made from a seed) unless
``--data-npz`` names ``images``/``labels`` arrays.

Run on the card (one process; ``torchrun --nproc-per-node N`` for more)::

    python -m chainermn_tpu_torch.examples.train_imagenet \\
        --communicator pure_nccl --arch resnet50 --batchsize 256

and on the CPU at a tiny size::

    python -m chainermn_tpu_torch.examples.train_imagenet --device cpu \\
        --communicator naive --arch resnet18 --batchsize 16 \\
        --image-size 32 --num-classes 10 --train-size 64 --val-size 32 \\
        --steps 2

With ``--checkpoint-dir`` a generation (parameters, BatchNorm buffers,
optimizer state with the schedule's update count, epoch and step) is
saved every ``--checkpoint-every`` steps and a relaunch resumes from the
newest consistent one at the exact step; ``main`` returns the crc32 of
each saved generation and of the state the relaunch loaded.  The last
line is ``final gstep G params_digest XXXXXXXX`` (a crc32 of the
parameters' bytes).
"""

from __future__ import annotations

import argparse
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch.datasets.toy import (SyntheticImageDataset,
                                              batch_iterator)
from chainermn_tpu_torch.examples.train_mnist import params_digest
from chainermn_tpu_torch.extensions import Evaluator
from chainermn_tpu_torch.models.convnets import AlexNet, GoogLeNet, NiN
from chainermn_tpu_torch.models.resnet import ResNet18, ResNet50
from chainermn_tpu_torch.optim import LARS, linear_schedule

ARCHS = {"resnet50": ResNet50, "resnet18": ResNet18, "alex": AlexNet,
         "nin": NiN, "googlenet": GoogLeNet}


def state_digest(tree, crc: int = 0) -> int:
    """crc32 over a checkpoint tree: its keys, scalars and tensor bytes,
    in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            crc = state_digest(v, zlib.crc32(repr(k).encode(), crc))
        return crc
    if isinstance(tree, (list, tuple)):
        for v in tree:
            crc = state_digest(v, crc)
        return crc
    if isinstance(tree, torch.Tensor):
        raw = tree.detach().to("cpu").contiguous().reshape(-1)
        return zlib.crc32(raw.view(torch.uint8).numpy(), crc)
    return zlib.crc32(repr(tree).encode(), crc)


#: The dropout models' ``rng`` seed (the reference's ``PRNGKey(7)``); the
#: multi-node optimizer seeds a generator from it per step and rank.
DROPOUT_SEED = 7


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description="chainermn_tpu_torch ImageNet example")
    p.add_argument("--communicator", default="xla_ici")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs over gloo)")
    p.add_argument("--bucket-bytes", type=int, default=None,
                   help="gradient-allreduce bucket cap in bytes "
                        "(0 disables bucketing; default: 4 MiB / "
                        "CHAINERMN_TPU_BUCKET_BYTES)")
    p.add_argument("--arch", "--model", dest="arch", default="resnet50",
                   choices=list(ARCHS))
    p.add_argument("--batchsize", type=int, default=256, help="global batch")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--optimizer", choices=["sgd", "lars"], default="sgd")
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--train-size", type=int, default=4096)
    p.add_argument("--val-size", type=int, default=512)
    p.add_argument("--steps", type=int, default=None, help="cap steps/epoch")
    p.add_argument("--data-npz", default=None)
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches staged on the device ahead of the step "
                        "(0 disables)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save generations here and resume from the newest "
                        "consistent one on relaunch")
    p.add_argument("--checkpoint-every", type=int, default=50,
                   help="save a generation every N global steps")
    p.add_argument("--checkpoint-name", default="imagenet",
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

    comm = cmn.create_communicator(args.communicator, device=args.device,
                                   bucket_bytes=args.bucket_bytes)
    if comm.rank == 0:
        print(f"communicator: {comm!r}")
    if args.batchsize % comm.size:
        raise SystemExit(f"--batchsize {args.batchsize} must divide by the "
                         f"rank count {comm.size}")
    local_bs = args.batchsize // comm.size

    shape = (args.image_size, args.image_size, 3)
    if args.data_npz:
        raw = np.load(args.data_npz)
        train = list(zip(raw["images"], raw["labels"]))
        val = train[:args.val_size]
    else:
        train = SyntheticImageDataset(n=args.train_size, shape=shape,
                                      n_classes=args.num_classes, seed=0)
        val = SyntheticImageDataset(n=args.val_size, shape=shape,
                                    n_classes=args.num_classes, seed=1)
    train = cmn.scatter_dataset(train, comm, shuffle=True, seed=42)
    val = cmn.scatter_dataset(val, comm)

    dev = comm.device
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
    kw = {"image_size": args.image_size} if args.arch == "alex" else {}
    model = ARCHS[args.arch](num_classes=args.num_classes, device=dev,
                             seed=0, **kw)
    has_bn = args.arch.startswith("resnet")

    # Linear-scaling rule with warm-up from 0 (the large-minibatch recipe).
    scaled_lr = args.lr * args.batchsize / 256.0
    params = list(model.parameters())
    if args.optimizer == "lars":
        inner = LARS(params, momentum=0.9, weight_decay=1e-4)
    else:
        inner = torch.optim.SGD(params, lr=0.0, momentum=0.9)
    opt = cmn.create_multi_node_optimizer(
        inner, comm,
        lr_schedule=linear_schedule(0.0, scaled_lr, args.warmup_steps))
    opt.init()

    def loss_fn(batch, rng=None):
        x, y = batch
        logits = (model(x, train=True) if has_bn
                  else model(x, train=True, rng=rng))
        return F.cross_entropy(logits, y.long())

    if has_bn:
        step = opt.make_train_step_with_state(loss_fn, model,
                                              local_batch=True)
    else:
        step = opt.make_train_step(loss_fn, local_batch=True,
                                   rng=DROPOUT_SEED)

    def metric_fn(model, batch):
        x, y = batch
        logits = model(x, train=False)
        y = y.long()
        return {"val/loss": F.cross_entropy(logits, y),
                "val/accuracy": (logits.argmax(-1) == y).float().mean()}

    evaluator = Evaluator(metric_fn, comm)

    def on_device(batch):
        return tuple(torch.from_numpy(a).to(dev, non_blocking=True)
                     for a in batch)

    def host_batches(epoch):
        # Runs in the prefetch thread when enabled, beside the step.
        for x, y in batch_iterator(train, local_bs, seed=epoch):
            yield x.astype(np.float32), y

    def snapshot(epoch, n_steps):
        return {"model": model.state_dict(), "opt": opt.state_dict(),
                "epoch": epoch, "step": n_steps}

    ckpt = None
    start_epoch = start_step = gstep = 0
    resumed = loaded_digest = None
    saved_digests = {}
    if args.checkpoint_dir:
        from chainermn_tpu_torch.extensions import (
            create_multi_node_checkpointer)
        from chainermn_tpu_torch.global_except_hook import add_hook

        add_hook()
        ckpt = create_multi_node_checkpointer(
            args.checkpoint_name, comm, path=args.checkpoint_dir)
        loaded, it = ckpt.maybe_load(snapshot(0, 0))
        if it is not None:
            model.load_state_dict(loaded["model"])
            opt.load_state_dict(loaded["opt"])
            start_epoch, start_step = int(loaded["epoch"]), int(loaded["step"])
            gstep = resumed = it
            # What the run now holds, to compare with what was saved.
            loaded_digest = state_digest(snapshot(start_epoch, start_step))
            if comm.rank == 0:
                print(f"resumed from iteration {it} "
                      f"(epoch {start_epoch}, step {start_step})")

    metrics, epoch_losses, step_losses, img_per_s = {}, [], [], []
    for epoch in range(start_epoch, args.epochs):
        t0, n_seen, n_steps, losses = time.perf_counter(), 0, 0, []
        # Resuming into this epoch: replay the iterator (same epoch seed,
        # same permutation) and drop the batches already trained on.
        skip = start_step if epoch == start_epoch else 0
        batches = host_batches(epoch)
        batches = (cmn.create_prefetch_iterator(batches, size=args.prefetch,
                                                device=dev)
                   if args.prefetch > 0 else map(on_device, batches))
        try:
            for batch in batches:
                if skip > 0:
                    skip -= 1
                    n_steps += 1
                    if args.steps and n_steps >= args.steps:
                        break          # the cap counts replayed steps too
                    continue
                losses.append(step(batch))
                n_seen += batch[0].shape[0] * comm.size
                n_steps += 1
                gstep += 1
                if ckpt is not None and gstep % args.checkpoint_every == 0:
                    snap = snapshot(epoch, n_steps)
                    saved_digests[gstep] = state_digest(snap)
                    ckpt.save(snap, gstep, block=False)
                if args.steps and n_steps >= args.steps:
                    break
        finally:
            if hasattr(batches, "close"):
                batches.close()
        # One readback an epoch: it waits for the device.
        losses = torch.stack(losses).tolist() if losses else []
        dt = time.perf_counter() - t0
        metrics = evaluator.evaluate(
            model, map(on_device, batch_iterator(val, local_bs,
                                                 shuffle=False)))
        ips = n_seen / dt
        step_losses.append(losses)
        epoch_losses.append(losses[-1] if losses else float("nan"))
        img_per_s.append(ips)
        if comm.rank == 0:
            print(f"epoch {epoch}: loss {epoch_losses[-1]:.4f}  "
                  + "  ".join(f"{k} {v:.4f}" for k, v in metrics.items())
                  + f"  {ips:,.1f} img/s ({ips / comm.size:,.1f}/card)",
                  flush=True)
    if ckpt is not None:
        ckpt.wait()
    digest = params_digest(model.parameters())
    if comm.rank == 0:
        print(f"final gstep {gstep} params_digest {digest:08x}", flush=True)
    return {"metrics": metrics, "epoch_losses": epoch_losses,
            "step_losses": step_losses, "img_per_s": img_per_s,
            "gstep": gstep, "params_digest": f"{digest:08x}",
            "resumed_from": resumed, "saved_digests": saved_digests,
            "loaded_digest": loaded_digest, "model": model}


if __name__ == "__main__":
    main()
