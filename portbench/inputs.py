"""What a run feeds both sides, made from ``--seed`` alone: the weights
(one set for the program and the reference alike) and the traffic (the
batches each rank trains on).  Everything is drawn on the device by a
``torch.Generator`` there, in a few large calls."""

from __future__ import annotations

import numpy as np
import torch

WEIGHTS, TRAFFIC = 0, 1     # the streams a seed feeds


def stream_seed(seed: int, *tags: int) -> int:
    """One 63-bit generator seed for ``seed`` and ``tags`` (any whole
    numbers, ``seed`` as large as the caller likes)."""
    words = np.random.SeedSequence([int(seed) % 2**128]
                                   + [int(t) for t in tags]).generate_state(2)
    return (int(words[0]) << 32 | int(words[1])) & ((1 << 63) - 1)


def _generator(device, seed: int, *tags: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *tags))
    return g


def weight_specs(module: torch.nn.Module):
    """``(name, shape)`` of every parameter and buffer of ``module`` in
    state-dict order (build it on the meta device: nothing is allocated)."""
    return [(n, tuple(t.shape)) for n, t in module.state_dict().items()]


def make_weights(specs, seed: int, device) -> dict:
    """Seeded fp32 weights for ``specs``: a matrix or kernel (2 dims or
    more) is N(0, 1 / fan_in), fan_in being its elements over its first
    dimension; of the vectors, scales (``weight``) and variances
    (``running_var``) are 1, shifts (``bias``) and means
    (``running_mean``) 0.  One draw for all the matrices."""
    mats = [(n, s) for n, s in specs if len(s) >= 2]
    total = sum(int(np.prod(s)) for _, s in mats)
    flat = torch.randn(total, generator=_generator(device, seed, WEIGHTS),
                       device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape in mats:
        n = int(np.prod(shape))
        out[name] = flat[off:off + n].view(shape).mul_(
            (n // shape[0]) ** -0.5)
        off += n
    for name, shape in specs:
        if len(shape) >= 2:
            continue
        ones = name.endswith("running_var") or name.endswith("weight")
        out[name] = (torch.ones if ones else torch.zeros)(
            shape, device=device, dtype=torch.float32)
    return out


def make_pool(traffic: dict, cfg: dict, seed: int, rank: int, device):
    """This rank's pool of batches, as the traffic's file describes it.

    ``kind`` ``tokens``: ``pool`` batches of ``batch`` rows of ``seq + 1``
    token ids drawn uniformly from the configuration's ``vocab``; a batch
    is ``(ids[:, :-1], ids[:, 1:])``.  ``kind`` ``images``: ``pool``
    batches of ``batch`` NHWC uint8 images of ``image`` px, uniform bytes,
    and labels uniform over the configuration's ``num_classes``.  Every
    rank draws its own stream of (seed, rank)."""
    g = _generator(device, seed, TRAFFIC, rank)
    kind, n, b = traffic["kind"], traffic["pool"], traffic["batch"]
    if kind == "tokens":
        ids = torch.randint(0, cfg["vocab"], (n, b, traffic["seq"] + 1),
                            generator=g, device=device)
        return [(x[:, :-1].contiguous(), x[:, 1:].contiguous()) for x in ids]
    if kind == "images":
        s = traffic["image"]
        x = torch.randint(0, 256, (n, b, s, s, 3), generator=g,
                          device=device, dtype=torch.uint8)
        y = torch.randint(0, cfg["num_classes"], (n, b), generator=g,
                          device=device)
        return list(zip(x.unbind(0), y.unbind(0)))
    raise ValueError(f"unknown traffic kind {kind!r}")
