"""Channel-parallel convolution — the port of
``examples/parallel_convolution/train_parallel_conv.py`` (ChainerMN's
proto-tensor-parallel example).

Each rank owns ``C/n`` output channels of every convolution; after each
convolution the ranks reassemble the full channel dimension with the
differentiable ``functions.allgather(comm, x, axis=0, tiled=False)``
(backward: a reduce-scatter, the sum of every rank's cotangents) and
concatenate the shards on the channel axis (dim 1 here, in NCHW; the
last axis in the reference's NHWC).  Every rank sees the same, replicated
global batch and has its own classifier head and its own initialisation
(a generator seeded with its rank, as the reference folds the rank into
its key), and each rank's Adam updates only its own shards, with the
exact gradient of the sum of the ranks' losses.  The loss printed and
returned is rank 0's.

Run on the card (one process; ``torchrun --nproc-per-node N`` for
more)::

    python -m chainermn_tpu_torch.examples.train_parallel_conv

and on the CPU at a tiny size::

    python -m chainermn_tpu_torch.examples.train_parallel_conv \\
        --device cpu --communicator naive --epochs 1 --batchsize 8 \\
        --channels 16 --train-size 32

``main(argv)`` returns rank 0's last loss.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch import functions
from chainermn_tpu_torch.datasets.scatter_dataset import SubDataset
from chainermn_tpu_torch.datasets.toy import (SyntheticImageDataset,
                                              batch_iterator)
from chainermn_tpu_torch.models.layers import Conv, Dense

STRIDES = (1, 2, 2)
IMAGE = (16, 16, 3)


class ShardedConvNet(nn.Module):
    """Three 3x3 convolutions (strides 1, 2, 2) of ``channels`` output
    channels each on this rank, their activations allgathered over
    ``n_ranks`` ranks between layers, a spatial mean and a dense head.
    Flax's names (``conv_i``, ``head``) and ``SAME`` padding; fp32."""

    def __init__(self, channels: int, n_ranks: int = 1, n_classes: int = 10,
                 generator: torch.Generator = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        full = channels * n_ranks
        for i, stride in enumerate(STRIDES):
            self.add_module(f"conv_{i}", Conv(
                IMAGE[2] if i == 0 else full, channels, 3, strides=stride,
                dtype=torch.float32, generator=gen))
        self.head = Dense(full, n_classes, generator=gen)

    def forward(self, x, comm=None):
        """``x`` (B, H, W, 3) -> (B, n_classes); ``comm`` reassembles the
        channels (``None``: one rank)."""
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        for i in range(len(STRIDES)):
            x = F.relu(getattr(self, f"conv_{i}")(x))
            if comm is not None:
                # (n, B, C/n, H, W) -> (B, C, H, W), the ranks in order.
                x = torch.cat(functions.allgather(comm, x, axis=0,
                                                  tiled=False).unbind(0), 1)
        return self.head(x.mean(dim=(2, 3)))


def make_model(args, comm) -> ShardedConvNet:
    if args.channels % comm.size:
        raise SystemExit(f"--channels must be divisible by {comm.size} "
                         "devices")
    return ShardedConvNet(
        args.channels // comm.size, comm.size,
        generator=torch.Generator().manual_seed(comm.rank)).to(comm.device)


def make_step(model, comm):
    """``step(x, y) -> loss``: this rank's loss on the replicated batch,
    backward (collective through the allgathers) and Adam on this rank's
    shards."""
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def step(x, y):
        x = torch.as_tensor(x).to(comm.device)
        y = torch.as_tensor(y).long().to(comm.device)
        loss = F.cross_entropy(model(x, comm), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def training_set(args):
    """The reference's data: seeded 16x16x3 images in the order of its
    one-process ``scatter_dataset(shuffle=True, seed=1)``, the same global
    batch on every rank."""
    full = SyntheticImageDataset(n=args.train_size, shape=IMAGE, seed=0)
    return SubDataset(full, np.random.RandomState(1).permutation(len(full)))


def parser():
    p = argparse.ArgumentParser(
        description="chainermn_tpu_torch channel-parallel convolution")
    p.add_argument("--communicator", default="xla_ici")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs over gloo)")
    p.add_argument("--batchsize", type=int, default=128)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--channels", type=int, default=64,
                   help="global channels")
    p.add_argument("--train-size", type=int, default=1024)
    return p


def main(argv=None) -> float:
    args = parser().parse_args(argv)
    comm = cmn.create_communicator(args.communicator, device=args.device)
    model = make_model(args, comm)
    step = make_step(model, comm)
    train = training_set(args)
    last = torch.tensor(float("nan"))
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        for x, y in batch_iterator(train, args.batchsize, seed=epoch):
            last = step(x, y)
        loss = comm.bcast_obj(float(last))      # rank 0's
        if comm.rank == 0:
            print(f"epoch {epoch}: loss {loss:.4f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return comm.bcast_obj(float(last))


if __name__ == "__main__":
    main()
