"""ViT-B/16-style training with mixed data + pipeline parallelism and
double-buffered gradients — the port of ``examples/vit/train_vit.py``
(BASELINE config #5).

Layout: ``create_communicator("xla_ici", inter_size=dp)``; its ``inter``
axis is DATA parallel and its ``intra`` axis the PIPELINE, one process a
rank.  Patchify runs replicated on every pipeline rank, the transformer
blocks run through :mod:`chainermn_tpu_torch.parallel.pipeline` with each
pipeline rank holding only ITS stages' parameters, and the classifier
head runs on the pipeline output (mean over tokens).  Gradients are
combined per role, as in the reference:

* stage parameters: mean over the data axis only (``comm.split(
  ("inter",))``), since each pipeline rank owns different weights;
* patchify and head: summed over the pipeline axis (``comm.split(
  ("intra",))``; one rank produces nonzero gradients) then averaged over
  the data axis.

Schedules: ``--schedule gpipe`` differentiates :func:`spmd_pipeline`
through autograd, with the pipeline output summed over the pipeline
ranks (``functions.allreduce``, whose backward sums the cotangents) so
that every rank computes the head loss — as the reference does with
``psum``, whose transpose there is a ``psum`` too: the GPipe gradients
are the pipeline size times the 1F1B ones, which AdamW cancels up to its
epsilon.  ``--schedule 1f1b`` runs the head inside the explicit-gradient
schedule (``--virtual-stages v`` > 1: interleaved, global stage ``l pp +
d`` on rank ``d``) and the patchify's backward from the summed input
cotangents.

The optimizer is the reference's ``optax.adamw(lr, weight_decay=0.01)``,
step for step: with double buffering (the default) every step calls the
update on the previous step's averaged gradients and scales the update
by 0 at step 0, so Adam's count and moments advance once on zeros there
and step 1 bias-corrects with count 2 (the multi-node optimizer's
``double_buffering`` skips step 0's update instead).

Data: the reference's one process iterates global batches of the whole
dataset (``scatter_dataset`` over one process, shuffled with seed 1);
here every rank draws the same global batch and takes its data row's
contiguous slice, so the pipeline ranks of a row see the same images.

Initialisation, from explicit ``torch.Generator``s: patchify from seed
0, the head from 1, and global encoder layer ``k`` from ``10 + k``, so
that a split of the same depth into other stages (``--layers-per-stage``
and ``--virtual-stages``) starts from the same weights.

Run on the card (one process; ``torchrun --nproc-per-node N`` for
more)::

    python -m chainermn_tpu_torch.examples.train_vit

and on the CPU at a tiny size::

    python -m chainermn_tpu_torch.examples.train_vit --device cpu \\
        --epochs 1 --batchsize 8 --image-size 32 --patch 8 --d-model 32 \\
        --n-heads 2 --d-ff 64 --layers-per-stage 1 --n-classes 10 \\
        --microbatches 2 --train-size 16

``main(argv)`` returns the last step's loss.
"""

from __future__ import annotations

import argparse
import copy
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch import functions
from chainermn_tpu_torch.datasets.scatter_dataset import SubDataset
from chainermn_tpu_torch.datasets.toy import (SyntheticImageDataset,
                                              batch_iterator)
from chainermn_tpu_torch.models.layers import Conv, Dense
from chainermn_tpu_torch.models.transformer import EncoderLayer
from chainermn_tpu_torch.optim import OptaxAdamW
from chainermn_tpu_torch.parallel import pipeline as pp
from chainermn_tpu_torch.utils.profiling import sync

LAYER_SEED = 10         # global encoder layer k draws from seed 10 + k


class Patchify(nn.Module):
    """``proj``: a ``patch`` x ``patch`` stride-``patch`` fp32 conv over
    the NHWC image, its grid read row-major over (H, W); plus ``pos``."""

    def __init__(self, d_model: int, patch: int, image_size: int,
                 generator: torch.Generator):
        super().__init__()
        self.d_model = d_model
        self.proj = Conv(3, d_model, patch, strides=patch,
                         dtype=torch.float32, generator=generator)
        n = (-(-image_size // patch)) ** 2
        self.pos = nn.Parameter(torch.empty(1, n, d_model))
        with torch.no_grad():
            self.pos.normal_(0.0, 0.02, generator=generator)

    def forward(self, x):
        B = x.shape[0]
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = self.proj(x).permute(0, 2, 3, 1).reshape(B, -1, self.d_model)
        return x + self.pos


class Blocks(nn.Module):
    """One pipeline stage: ``layers`` fp32 encoder blocks, global layers
    ``first``, ``first + 1``, ... (each from its own seed)."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, layers: int,
                 first: int = 0):
        super().__init__()
        self.blocks = nn.ModuleList(
            EncoderLayer(d_model, n_heads, d_ff, torch.float32,
                         generator=torch.Generator().manual_seed(
                             LAYER_SEED + first + i))
            for i in range(layers))

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x


class ViTPipeline:
    """The example's model, communicators and step on one rank."""

    def __init__(self, args, comm=None):
        self.args = args
        v = args.virtual_stages
        if v < 1:
            raise SystemExit("--virtual-stages must be >= 1")
        if v > 1 and args.schedule != "1f1b":
            raise SystemExit("--virtual-stages > 1 requires --schedule 1f1b")
        if comm is None:
            comm = cmn.create_communicator("xla_ici", device=args.device,
                                           inter_size=args.dp)
        self.comm, self.v = comm, v
        self.dp, self.pp = comm.inter_size, comm.intra_size
        self.dp_comm = comm.split(("inter",))   # data-parallel group
        self.pp_comm = comm.split(("intra",))   # this row's pipeline
        # One data-parallel subgroup per pipeline stage (the reference's
        # split_devices check of the topology).
        self.stage_dp = comm.split_devices(
            [r % self.pp for r in range(comm.device_size)])
        assert all(sub is None or sub.device_size == self.dp
                   for sub in self.stage_dp.values())
        if args.batchsize % self.dp:
            raise SystemExit(f"--batchsize {args.batchsize} must divide by "
                             f"the data-parallel ways {self.dp}")
        dev = comm.device
        d, ls = self.pp_comm.rank, args.layers_per_stage
        self.patchify = Patchify(args.d_model, args.patch, args.image_size,
                                 torch.Generator().manual_seed(0)).to(dev)
        self.head = Dense(args.d_model, args.n_classes,
                          generator=torch.Generator().manual_seed(1)).to(dev)
        chunks = [Blocks(args.d_model, args.n_heads, args.d_ff, ls,
                         first=(l * self.pp + d) * ls).to(dev)
                  for l in range(v)]
        if v == 1:
            self.template = chunks[0]
            self.stage_params = dict(chunks[0].named_parameters())
        else:
            self.template = copy.deepcopy(chunks[0]).to("meta")
            self.stage_params = {
                k: torch.stack([dict(c.named_parameters())[k] for c in chunks])
                .detach().requires_grad_() for k, _ in
                chunks[0].named_parameters()}
        self.embed_params = dict(self.patchify.named_parameters())
        self.head_params = dict(self.head.named_parameters())
        self.groups = {"embed": self.embed_params, "stages": self.stage_params,
                       "head": self.head_params}
        self.params = [p for g in self.groups.values() for p in g.values()]
        self.opt = OptaxAdamW(self.params, args.lr, weight_decay=0.01)
        self.double_buffering = not args.no_double_buffering
        self.prev = [torch.zeros_like(p) for p in self.params]
        self.step_idx = 0

    def load(self, state: dict):
        """Copy ``{"embed", "stages", "head"}`` state dicts (those of
        :func:`~chainermn_tpu_torch.convert.vit_example_flax_to_state_dict`)
        into this rank's parameters."""
        with torch.no_grad():
            for name, group in self.groups.items():
                assert set(group) == set(state[name]), name
                for k, p in group.items():
                    p.copy_(state[name][k])

    def state(self) -> dict:
        return {name: {k: p.detach() for k, p in group.items()}
                for name, group in self.groups.items()}

    def stage_fn(self, params, x):
        return functional_call(self.template, params, (x,))

    def head_loss(self, hp, out, tgt):
        logits = functional_call(self.head, hp, (out.mean(dim=1),))
        return F.cross_entropy(logits, tgt)

    def _grads_gpipe(self, x, y):
        names = list(self.groups)
        with torch.enable_grad():
            tokens = self.patchify(x)
            out = pp.spmd_pipeline(self.stage_fn, self.stage_params, tokens,
                                   self.pp_comm, self.args.microbatches)
            # Every pipeline rank computes the head loss on the summed
            # output; the sum's backward sums the ranks' cotangents.
            out = functions.allreduce(self.pp_comm, out)
            loss = self.head_loss(self.head_params, out, y)
            flat = torch.autograd.grad(loss, self.params)
        grads, pos = {}, 0
        for name in names:
            n = len(self.groups[name])
            grads[name] = list(flat[pos:pos + n])
            pos += n
        for name in ("embed", "head"):
            grads[name] = [self.pp_comm.allreduce(g) for g in grads[name]]
        loss = self.comm.allreduce(loss.detach().reshape(1), "mean")[0]
        return loss, grads

    def _grads_1f1b(self, x, y):
        args = self.args
        with torch.enable_grad():
            tokens = self.patchify(x)
        common = dict(loss_params=self.head_params, with_input_grads=True)
        if self.v > 1:
            loss, sg, hg, gtok = pp.pipeline_interleaved_1f1b_loss_and_grads(
                self.stage_fn, self.head_loss, self.stage_params, tokens, y,
                self.pp_comm, args.microbatches, self.v, **common)
        else:
            loss, sg, hg, gtok = pp.pipeline_1f1b_loss_and_grads(
                self.stage_fn, self.head_loss, self.stage_params, tokens, y,
                self.pp_comm, args.microbatches, **common)
        gtok = self.pp_comm.allreduce(gtok)          # stage 0's
        head = [self.pp_comm.allreduce(hg[k]) for k in self.head_params]
        embed = torch.autograd.grad(tokens, list(self.embed_params.values()),
                                    gtok)
        loss = self.dp_comm.allreduce(loss.reshape(1), "mean")[0]
        return loss, {"embed": list(embed),
                      "stages": [sg[k] for k in self.stage_params],
                      "head": head}

    def step(self, x, y):
        """One training step on this rank's data row of the global batch
        ``(x, y)`` (numpy or tensors); returns the loss (a 0-d tensor)."""
        row, per = self.comm.inter_rank, self.args.batchsize // self.dp
        dev = self.comm.device
        x = torch.as_tensor(x[row * per:(row + 1) * per]).to(dev)
        y = torch.as_tensor(y[row * per:(row + 1) * per]).long().to(dev)
        if self.args.schedule == "1f1b":
            loss, grads = self._grads_1f1b(x, y)
        else:
            loss, grads = self._grads_gpipe(x, y)
        flat = [g for name in self.groups for g in grads[name]]
        self.dp_comm.allreduce_grad(flat)
        if self.double_buffering:
            apply, self.prev = self.prev, flat
            # Step 0 has no previous gradients: the update of the zeros
            # runs (Adam's count and moments advance) and is scaled by 0.
            self.opt.update(apply, 0.0 if self.step_idx == 0 else 1.0)
        else:
            self.opt.update(flat)
        self.step_idx += 1
        return loss


def parser():
    p = argparse.ArgumentParser(
        description="chainermn_tpu_torch ViT data + pipeline example")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs over gloo)")
    p.add_argument("--batchsize", type=int, default=64, help="global batch")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--patch", type=int, default=8)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--d-ff", type=int, default=256)
    p.add_argument("--layers-per-stage", type=int, default=1)
    p.add_argument("--n-classes", type=int, default=10)
    p.add_argument("--microbatches", type=int, default=2)
    p.add_argument("--train-size", type=int, default=1024)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--no-double-buffering", action="store_true")
    p.add_argument("--schedule", choices=["gpipe", "1f1b"], default="gpipe",
                   help="pipeline schedule: GPipe (autograd backward) or "
                        "the memory-bounded 1F1B (explicit backward)")
    p.add_argument("--virtual-stages", type=int, default=1,
                   help="model chunks PER pipeline rank (interleaved 1F1B; "
                        "requires --schedule 1f1b and microbatches "
                        "divisible by the pipeline size)")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel ways (inter axis); rest is pipeline")
    return p


def training_set(args):
    """The reference's data: the seeded synthetic images, in the order of
    its one-process ``scatter_dataset(shuffle=True, seed=1)``."""
    full = SyntheticImageDataset(
        n=args.train_size, shape=(args.image_size, args.image_size, 3),
        n_classes=args.n_classes, seed=0)
    return SubDataset(full, np.random.RandomState(1).permutation(len(full)))


def main(argv=None) -> float:
    args = parser().parse_args(argv)
    ex = ViTPipeline(args)
    comm = ex.comm
    if comm.rank == 0:
        print(f"mesh: data={ex.dp} x pipeline={ex.pp} "
              f"(+{len(ex.stage_dp)} per-stage DP subgroups); "
              f"double_buffering={ex.double_buffering}", flush=True)
    train = training_set(args)
    last = torch.tensor(float("nan"))
    for epoch in range(args.epochs):
        t0, n_seen = time.perf_counter(), 0
        for x, y in batch_iterator(train, args.batchsize, seed=epoch):
            last = ex.step(x, y)
            n_seen += x.shape[0]
        sync(last)
        if comm.rank == 0:
            print(f"epoch {epoch}: loss {float(last):.4f} "
                  f"({n_seen / (time.perf_counter() - t0):,.0f} img/s)",
                  flush=True)
    return float(last)


if __name__ == "__main__":
    main()
