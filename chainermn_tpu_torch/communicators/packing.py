"""Gradient packing — the flat-buffer fusion that made ``pure_nccl`` fast.

Port of ``chainermn_tpu/communicators/packing.py``.  Two utilities:

* :func:`pack_tree` — one flat buffer for a list of tensors, plus the
  unpack closure (the ``flat``/``xla_ici`` single-collective path).
* :class:`GradPacker` — per-dtype buckets capped at ``bucket_bytes`` of
  payload, each padded by the reference's rule (next power of two when
  that stays within the cap, else the next multiple of 128 elements);
  ``allreduce_grad`` runs one collective per bucket.

Leaf order: the port packs tensors in the order the caller gives them —
for a model, ``Module.parameters()`` registration order — where the
reference packs in jax's sorted-key flatten order.  Buckets group by
dtype (groups in first-appearance order, leaves within a group in the
given order) and fill greedily, so the same tensors in the same order
always give the same plan.  Pack and unpack are pure layout moves
(ravel/concat/slice): ``unpack(pack(x))`` is bit-exact.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

#: Default bucket cap (``chainermn_tpu/communicators/packing.py:43``).
DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024

#: Environment override of the bucket cap when the constructor leaves it
#: ``None`` (``0`` disables bucketing).
ENV_BUCKET_BYTES = "CHAINERMN_TPU_BUCKET_BYTES"

#: Buckets that cannot take a power-of-two size pad to this multiple.
LANE_ELEMS = 128


def pack_tree(tensors: Sequence[torch.Tensor], pad_to: int | None = None):
    """Flatten tensors of one dtype into (one 1-D buffer, unpack closure).

    ``pad_to`` appends zeros up to that element count; ``unpack`` slices
    the leaves back from the prefix, so padding never round-trips."""
    shapes = [t.shape for t in tensors]
    sizes = [t.numel() for t in tensors]
    if tensors:
        flat = torch.cat([t.reshape(-1) for t in tensors])
    else:
        flat = torch.zeros((0,))
    if pad_to is not None:
        if pad_to < flat.numel():
            raise ValueError(
                f"pad_to={pad_to} smaller than packed size {flat.numel()}"
            )
        if pad_to > flat.numel():
            flat = torch.cat([flat, flat.new_zeros(pad_to - flat.numel())])

    def unpack(buf):
        out, off = [], 0
        for shape, size in zip(shapes, sizes):
            out.append(buf[off : off + size].reshape(shape))
            off += size
        return out

    return flat, unpack


def _padded_elems(elems: int, cap_elems: int) -> int:
    """Bucket padding rule: next power of two when that stays within the
    cap, else the next multiple of :data:`LANE_ELEMS`."""
    if elems == 0:
        return 0
    p = 1 << (elems - 1).bit_length()
    if p <= cap_elems:
        return p
    return elems + (-elems) % LANE_ELEMS


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One contiguous single-dtype slab of the packed gradient."""

    dtype: torch.dtype
    leaf_indices: Tuple[int, ...]    # into the given tensor order
    elems: int                       # payload elements (sum of leaf sizes)
    padded_elems: int                # buffer length actually reduced

    @property
    def payload_bytes(self) -> int:
        return self.elems * self.dtype.itemsize

    @property
    def padded_bytes(self) -> int:
        return self.padded_elems * self.dtype.itemsize

    @property
    def quantizable(self) -> bool:
        """Whether a ``comm_dtype`` wire applies to this bucket: floating
        buckets are quantized, integer ones ride at full precision."""
        return self.dtype.is_floating_point

    def wire_bytes(self, wire_itemsize: int | None = None) -> int:
        """Bytes one rank puts on the wire for this bucket: the padded
        buffer at the wire dtype's width when quantized, plus the fp32
        amax (one word a bucket; the port sends it in its own MAX
        all-reduce ahead of the bucket's sum), else the padded bytes."""
        if wire_itemsize is None or not self.quantizable:
            return self.padded_bytes
        return self.padded_elems * wire_itemsize + 4


def _dtype_name(dtype: torch.dtype) -> str:
    """``"float32"``, ``"bfloat16"``, ...: the reference's numpy names."""
    return str(dtype).replace("torch.", "")


def _wire_itemsize(comm_dtype) -> int | None:
    if comm_dtype is None:
        return None
    from . import quant

    wire_dt = quant.wire_dtype(comm_dtype)
    return None if wire_dt is None else wire_dt.itemsize


class GradPacker:
    """Bucketed pack/unpack plan for one list of gradient shapes/dtypes.

    A bucket always takes at least one leaf, so a single leaf larger than
    the cap becomes its own oversize bucket rather than an error."""

    def __init__(self, shapes: Sequence[tuple], dtypes: Sequence[torch.dtype],
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES):
        if bucket_bytes <= 0:
            raise ValueError(
                f"bucket_bytes must be positive, got {bucket_bytes} "
                "(use the unbucketed path to disable bucketing)"
            )
        self.shapes = [tuple(s) for s in shapes]
        self.dtypes = list(dtypes)
        self.sizes = [
            int(torch.Size(s).numel()) for s in self.shapes
        ]
        self.bucket_bytes = int(bucket_bytes)

        groups: dict[torch.dtype, list[int]] = {}
        for i, dt in enumerate(self.dtypes):
            groups.setdefault(dt, []).append(i)

        buckets: List[Bucket] = []
        for dt, idxs in groups.items():
            cap_elems = max(1, self.bucket_bytes // dt.itemsize)
            cur: list[int] = []
            cur_elems = 0
            for i in idxs:
                if cur and cur_elems + self.sizes[i] > cap_elems:
                    buckets.append(Bucket(
                        dt, tuple(cur), cur_elems,
                        _padded_elems(cur_elems, cap_elems),
                    ))
                    cur, cur_elems = [], 0
                cur.append(i)
                cur_elems += self.sizes[i]
            if cur:
                buckets.append(Bucket(
                    dt, tuple(cur), cur_elems,
                    _padded_elems(cur_elems, cap_elems),
                ))
        self.buckets: Tuple[Bucket, ...] = tuple(buckets)

    @classmethod
    def for_tensors(cls, tensors: Sequence[torch.Tensor],
                    bucket_bytes: int = DEFAULT_BUCKET_BYTES):
        return cls([t.shape for t in tensors], [t.dtype for t in tensors],
                   bucket_bytes)

    @classmethod
    def for_tree(cls, tree, bucket_bytes: int = DEFAULT_BUCKET_BYTES):
        """The plan of a mapping (values in order, as
        :func:`synthetic_grad_tree` makes) or a sequence of tensors."""
        leaves = list(tree.values()) if isinstance(tree, dict) else list(tree)
        return cls.for_tensors(leaves, bucket_bytes)

    @property
    def n_leaves(self) -> int:
        return len(self.shapes)

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def payload_bytes(self) -> int:
        return sum(b.payload_bytes for b in self.buckets)

    @property
    def padded_bytes(self) -> int:
        return sum(b.padded_bytes for b in self.buckets)

    def wire_bytes(self, comm_dtype=None) -> int:
        """Bytes one ``allreduce_grad`` puts on the wire per rank: the
        padded bytes at full precision, or each quantizable bucket at the
        width of :func:`.quant.wire_dtype` of ``comm_dtype`` (a canonical
        name) plus its amax word."""
        itemsize = _wire_itemsize(comm_dtype)
        return sum(b.wire_bytes(itemsize) for b in self.buckets)

    def describe(self, comm_dtype=None) -> dict:
        """The plan as JSON (the reference's layout and dtype names; what
        the ``grad_pack/*`` report publishes).  With a ``comm_dtype`` it
        adds the wire's bytes, in total and per bucket."""
        itemsize = _wire_itemsize(comm_dtype)
        out = {
            "bucket_bytes": self.bucket_bytes,
            "n_leaves": self.n_leaves,
            "n_buckets": self.n_buckets,
            "payload_bytes": self.payload_bytes,
            "padded_bytes": self.padded_bytes,
            "buckets": [
                {"dtype": _dtype_name(b.dtype),
                 "n_leaves": len(b.leaf_indices),
                 "elems": b.elems,
                 "padded_elems": b.padded_elems,
                 "padded_bytes": b.padded_bytes}
                for b in self.buckets
            ],
        }
        if itemsize is not None:
            out["comm_dtype"] = comm_dtype
            out["wire_bytes"] = self.wire_bytes(comm_dtype)
            for spec, b in zip(out["buckets"], self.buckets):
                spec["quantized"] = b.quantizable
                spec["wire_bytes"] = b.wire_bytes(itemsize)
        return out

    def pack(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Tensors → one 1-D buffer per bucket (padded with zeros)."""
        if len(tensors) != len(self.shapes):
            raise ValueError(
                f"got {len(tensors)} tensors, plan has {len(self.shapes)}"
            )
        for i, t in enumerate(tensors):
            if tuple(t.shape) != self.shapes[i] or t.dtype != self.dtypes[i]:
                raise ValueError(
                    f"tensor {i} is {tuple(t.shape)}/{t.dtype}, plan expects "
                    f"{self.shapes[i]}/{self.dtypes[i]}"
                )
        return [self.pack_bucket(tensors, i) for i in range(self.n_buckets)]

    def pack_bucket(self, tensors: Sequence[torch.Tensor], i: int):
        """Bucket ``i`` of ``tensors`` as one 1-D buffer (zero padded);
        only its member tensors are read."""
        b = self.buckets[i]
        parts = [tensors[j].reshape(-1) for j in b.leaf_indices]
        pad = b.padded_elems - b.elems
        if pad:
            parts.append(parts[0].new_zeros(pad))
        return torch.cat(parts)

    def unpack_bucket(self, buf: torch.Tensor, i: int):
        """``(leaf index, view)`` for each member of bucket ``i``."""
        out, off = [], 0
        for j in self.buckets[i].leaf_indices:
            out.append((j, buf[off : off + self.sizes[j]].reshape(
                self.shapes[j])))
            off += self.sizes[j]
        return out

    def unpack(self, bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Bucket buffers → tensors (views into the buffers; padding is
        discarded)."""
        if len(bufs) != self.n_buckets:
            raise ValueError(
                f"got {len(bufs)} buffers for {self.n_buckets} buckets"
            )
        out: list = [None] * len(self.shapes)
        for i, (b, buf) in enumerate(zip(self.buckets, bufs)):
            if buf.numel() != b.padded_elems:
                raise ValueError(
                    f"buffer has {buf.numel()} elems, bucket expects "
                    f"{b.padded_elems}"
                )
            for j, view in self.unpack_bucket(buf, i):
                out[j] = view
        return out


def synthetic_grad_tree(n_leaves: int, total_bytes: int,
                        dtypes: Sequence = ("float32", "bfloat16"),
                        device="cpu") -> dict:
    """Deterministic mixed-shape, mixed-dtype gradient tree (``{"leaf_000":
    tensor, ...}``, the reference's leaves, shapes, dtypes and values):
    leaf 0 is a scalar, every 5th leaf is 2-D when its size is even,
    dtypes go round-robin and sizes follow a cycling weight, so buckets
    straddle leaf boundaries.  Values are multiples of 1/32 below 8, exact
    in bfloat16.  The communicator tuners time over it."""
    import numpy as np

    dts = [d if isinstance(d, torch.dtype) else getattr(torch, str(d))
           for d in dtypes]
    weights = [(i % 7) + 1 for i in range(n_leaves)]
    wsum = sum(weights) or 1
    tree = {}
    for i in range(n_leaves):
        dt = dts[i % len(dts)]
        itemsize = torch.empty((), dtype=dt).element_size()
        if i == 0:
            shape: tuple = ()
        else:
            elems = max(1, int(total_bytes * weights[i] / wsum) // itemsize)
            if i % 5 == 0 and elems % 2 == 0:
                shape = (elems // 2, 2)
            else:
                shape = (elems,)
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        vals = (np.arange(size, dtype=np.float32) % 97) / 32.0 + (i % 13) / 8.0
        tree[f"leaf_{i:03d}"] = torch.from_numpy(
            vals.reshape(shape)).to(device=device, dtype=dt)
    return tree
