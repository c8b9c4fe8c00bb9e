"""Dataset scattering across ranks.

A copy of the numpy logic of ``chainermn_tpu/datasets/scatter_dataset.py``
(reference: ChainerMN's ``scatter_dataset``): the shard indices are
identical to the reference's for the same ``(n, rank, size, shuffle,
seed)``.  Seeded global permutation, contiguous chunks whose sizes differ
by at most one (earlier ranks take the longer ones), and optional
wrap-around padding to equal length.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class SubDataset:
    """A view of ``dataset`` at ``indices`` — the Chainer ``SubDataset``
    analogue, duck-typed to anything with ``__getitem__``/``__len__``."""

    def __init__(self, dataset, indices: np.ndarray):
        self._dataset = dataset
        self._indices = np.asarray(indices)

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._dataset[int(j)] for j in self._indices[i]]
        return self._dataset[int(self._indices[i])]

    @property
    def indices(self) -> np.ndarray:
        return self._indices


def scatter_index(n_total: int, comm, root: int = 0, shuffle: bool = False,
                  seed: Optional[int] = None) -> np.ndarray:
    """This rank's index shard of ``range(n_total)``."""
    if shuffle:
        if seed is None:
            # Ranks must agree on the permutation: the root draws it and
            # broadcasts (the reference's pickled scatter path).
            order = None
            if comm.rank == root:
                order = np.random.permutation(n_total)
            order = comm.bcast_obj(order, root=root)
        else:
            order = np.random.RandomState(seed).permutation(n_total)
    else:
        order = np.arange(n_total)

    size = comm.size
    base, rem = divmod(n_total, size)
    sizes = [base + (1 if r < rem else 0) for r in range(size)]
    offsets = np.cumsum([0] + sizes)
    r = comm.rank
    return order[offsets[r] : offsets[r + 1]]


def scatter_dataset(dataset, comm, root: int = 0, shuffle: bool = False,
                    seed: Optional[int] = None,
                    force_equal_length: bool = True) -> SubDataset:
    """Shard ``dataset`` across ranks (reference signature preserved).

    ``force_equal_length`` pads shorter shards by wrapping around their
    own indices so every rank sees the same epoch length."""
    idx = scatter_index(len(dataset), comm, root=root, shuffle=shuffle,
                        seed=seed)
    if force_equal_length and comm.size > 1:
        max_len = -(-len(dataset) // comm.size)
        if len(idx) < max_len and len(idx) > 0:
            pad = idx[: max_len - len(idx)]
            idx = np.concatenate([idx, pad])
    return SubDataset(dataset, idx)


def create_empty_dataset(dataset):
    """Strip a dataset to its length only (ChainerMN's
    ``create_empty_dataset``)."""
    return SubDataset(_Empty(len(dataset)), np.arange(len(dataset)))


class _Empty:
    def __init__(self, n):
        self._n = n

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        return ()


def get_n_iterations_for_one_epoch(dataset, local_batch_size: int) -> int:
    """Iterations per epoch at a per-rank batch size: ⌈len / local batch⌉
    (the helper the reference keeps for its examples)."""
    return -(-len(dataset) // local_batch_size)
