"""Driver ``convnet_train``: a ResNet trained through the port's
data-parallel entry point with model state.

The program: ``create_communicator`` (the configuration's communicator),
``models.resnet.ResNet`` with bottleneck blocks (cuDNN convolutions and
BatchNorm in ``channels_last``, bf16 over fp32 parameters), uint8 NHWC
images decoded on the device (x / 127.5 - 1 in bf16), momentum SGD
wrapped by ``create_multi_node_optimizer`` and stepped by
``make_train_step_with_state``, which averages the BatchNorm statistics
over the ranks.  Each rank trains on its own batch (``local_batch``).
The reference: :class:`..reference.resnet.RefResNet`.
"""

from __future__ import annotations

from .. import yardstick
from ..reference.resnet import RefResNet

OPTIMIZER = "sgd"


def reference(cfg: dict, traffic: dict):
    ref = RefResNet(cfg["stage_sizes"], cfg["num_filters"],
                    cfg["num_classes"], cfg["bn_eps"])
    ref.bn_momentum = cfg["bn_momentum"]
    return ref


def ref_step(torch, ref, batches):
    """One reference step's forward and backward over every rank's batch:
    the gradients of the mean of the ranks' losses, and each BatchNorm's
    running statistics updated with the mean over the ranks of its batch
    statistics (momentum as configured).  Returns the mean loss."""
    import torch.nn.functional as F

    bns = ref.batch_norms()
    sums = {n: [0.0, 0.0] for n in bns}
    total = 0.0
    for x, y in batches:
        loss = F.cross_entropy(ref(x), y) / len(batches)
        loss.backward()
        total += loss.item()
        for n, bn in bns.items():
            mean, var = bn.last_stats
            sums[n][0] = sums[n][0] + mean / len(batches)
            sums[n][1] = sums[n][1] + var / len(batches)
    m = ref.bn_momentum
    with torch.no_grad():
        for n, bn in bns.items():
            bn.running_mean.mul_(m).add_(sums[n][0], alpha=1 - m)
            bn.running_var.mul_(m).add_(sums[n][1], alpha=1 - m)
            bn.last_stats = None
    return total


def work(cfg: dict, traffic: dict, world: int) -> dict:
    import torch

    per_image = yardstick.resnet_train_flops_per_image(
        torch, cfg["stage_sizes"], cfg["num_filters"], cfg["num_classes"],
        traffic["image"])
    n = traffic["batch"] * world
    return {"unit": "images", "per_step": n,
            "flops_per_step": per_image * n, "flops_per_image": per_image,
            "flash_shape": None}


def build(torch, cfg: dict, traffic: dict, ctx):
    """The program's model and communicator, and ``new_step()``: a fresh
    momentum SGD under the wrapper and its train step, ``(inner, wrapper,
    step)``; ``ctx.fault`` ``half_batch`` plants that fault."""
    import torch.nn.functional as F

    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.models.resnet import BottleneckBlock, ResNet

    torch.backends.cudnn.benchmark = bool(cfg["cudnn_benchmark"])
    comm = create_communicator(cfg["communicator"], device=ctx.device)
    model = ResNet(stage_sizes=cfg["stage_sizes"],
                   block_cls=BottleneckBlock,
                   num_classes=cfg["num_classes"],
                   num_filters=cfg["num_filters"], dtype=torch.bfloat16,
                   device=ctx.device, seed=ctx.seed % 2**63)

    def new_step():
        inner = torch.optim.SGD(model.parameters(), lr=cfg["lr"],
                                momentum=cfg["momentum"])
        opt = create_multi_node_optimizer(inner, comm)
        half = ctx.fault == "half_batch"

        def loss_fn(batch):
            x, y = batch
            if half:
                x, y = x[:len(x) // 2], y[:len(y) // 2]
            x = x.to(torch.bfloat16) / 127.5 - 1.0
            return F.cross_entropy(model(x, train=True), y)

        return inner, opt, opt.make_train_step_with_state(loss_fn, model,
                                                          local_batch=True)

    return model, comm, new_step


def first_grad_norms(torch, model, inner, cfg) -> dict:
    """The norm of each parameter's first-step gradient from SGD's state
    after one step: the momentum buffer starts as the gradient."""
    return {n: _state_norm(torch, inner, p, "momentum_buffer")
            for n, p in model.named_parameters()}


def _state_norm(torch, inner, p, key):
    """The norm of ``p``'s optimizer state ``key``; NaN where the
    optimizer holds none (it never stepped)."""
    t = inner.state.get(p, {}).get(key)
    return t.norm() if t is not None else torch.tensor(float("nan"))
