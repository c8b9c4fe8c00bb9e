"""Self-contained datasets for the examples and smoke tests.

A copy of ``chainermn_tpu/datasets/toy.py``: deterministic synthetic
datasets with MNIST's shapes and cardinalities, made from a seed (no
download).  :func:`batch_iterator` yields the same bytes in the same order
as the reference's; it stacks each batch with ``np.stack`` where the
reference gathers through its native helper.
"""

from __future__ import annotations

import numpy as np


class SyntheticImageDataset:
    """Deterministic labeled images: class-dependent means plus noise, so
    a model can fit them (loss falls, accuracy climbs)."""

    def __init__(self, n: int = 2048, shape=(28, 28), n_classes: int = 10,
                 seed: int = 0, flat: bool = False):
        rng = np.random.RandomState(seed)
        self.n_classes = n_classes
        self.labels = rng.randint(0, n_classes, size=n).astype(np.int32)
        # Class prototypes come from a FIXED seed so train/val splits (built
        # with different `seed`s) share the same underlying classes.
        base = np.random.RandomState(1234).randn(
            n_classes, *shape).astype(np.float32)
        noise = rng.randn(n, *shape).astype(np.float32) * 0.5
        self.images = base[self.labels] + noise
        if flat:
            self.images = self.images.reshape(n, -1)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.images[i], self.labels[i]


class SyntheticSeqDataset:
    """Synthetic 'translation' pairs: target = reversed source."""

    def __init__(self, n=1024, src_len=12, tgt_len=12, vocab=64, seed=0):
        rng = np.random.RandomState(seed)
        self.vocab = vocab
        # Reserve 0=pad, 1=bos, 2=eos.
        self.src = rng.randint(3, vocab, size=(n, src_len)).astype(np.int32)
        self.tgt = np.flip(self.src, axis=1).copy()

    def __len__(self):
        return len(self.src)

    def __getitem__(self, i):
        return self.src[i], self.tgt[i]


class ExplodingDataset:
    """Raises at one index, so tests can check that a loader worker's
    failure reaches the training loop.  Module-level so spawned workers
    can unpickle it."""

    def __init__(self, inner, explode_at: int):
        self.inner = inner
        self.explode_at = explode_at

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        if i == self.explode_at:
            raise ValueError(f"synthetic item failure at {i}")
        return self.inner[i]


def batch_iterator(dataset, batch_size, *, shuffle=True, seed=0,
                   drop_last=True):
    """One epoch over an indexable dataset, yielding tuples of stacked
    numpy arrays; the order is ``RandomState(seed).permutation`` (or
    ``arange`` without ``shuffle``)."""
    n = len(dataset)
    order = (np.random.RandomState(seed).permutation(n) if shuffle
             else np.arange(n))
    stop = n - (n % batch_size) if drop_last else n
    for start in range(0, stop, batch_size):
        items = [dataset[int(i)] for i in order[start:start + batch_size]]
        yield tuple(np.stack([np.asarray(it[j]) for it in items])
                    for j in range(len(items[0])))
