"""Supervised training rank for the port's elastic soaks
(``tests/test_torch_elastic_soak.py``).

Launched by ``python -m chainermn_tpu_torch.tools.elastic`` (or by a test
acting as the launcher, with the same ``CHAINERMN_TPU_ELASTIC_*``
environment): one thread a rank, so several gloo ranks share a small
machine, then the port's MNIST example with the given arguments::

    python _torch_elastic_train_worker.py --device cpu --elastic ...

The example prints the lines the supervisor and the tests scrape:
``resumed from iteration N``, ``elastic_reshard plan=dp ok=True ...``,
``preempted: checkpoint saved at iteration N`` and ``final gstep G
params_digest XXXXXXXX``.  It imports nothing of the JAX package.
"""

import sys


def main():
    import torch

    torch.set_num_threads(1)
    from chainermn_tpu_torch.examples import train_mnist

    train_mnist.main(sys.argv[1:])
    print("ELASTIC_TRAIN_OK", flush=True)


if __name__ == "__main__":
    main()
