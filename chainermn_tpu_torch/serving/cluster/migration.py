"""KV-page migration: move one live sequence between replicas.

A running sequence's device state is exactly (a) the ordered KV pages
its block table points at, in every layer's cache leaf, and (b) the
number of positions they cover.  :func:`extract_sequence` gathers those
pages (table order, so the physical page ids of the source pool never
matter) into a host :class:`KVSnapshot`; :func:`restore_sequence`
allocates a fresh table in the target pool and scatters them in.  The
two pools may differ in ``n_blocks`` — only the per-sequence slice
moves — but must agree on ``block_size`` and model geometry (the page
shape check enforces both).

Port of ``chainermn_tpu/serving/cluster/migration.py``.  The engine's
cache is one :class:`~chainermn_tpu_torch.models.transformer.PagedLayerCache`
a layer; the leaves are walked layer by layer in
``PagedLayerCache.LEAVES`` order.  numpy has no bfloat16, so a bf16 leaf
travels as its ``uint16`` bits with the dtype name ``"bfloat16"`` and is
rebuilt with ``torch.Tensor.view`` on the receiver, bit for bit.

On the wire (:func:`send_snapshot` / :func:`recv_snapshot`) each leaf's
pages travel as ONE ndarray frame over an object plane (a communicator's
``send_obj``/``recv_obj``, or any plane with the reference
``ObjectPlane``'s ``send``/``recv``) as a flat byte view with dtype and
shape in the metadata frame.

Restores are verified: ``assert_consistent`` runs on the target pool
before the caller sees the table, and the snapshot carries ``seq_len``
so an adopted request's context arithmetic is checked at admission
(:meth:`ContinuousBatchingScheduler.adopt_request`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch


def _leaves(engine):
    """The engine's page tensors, layer by layer in
    ``PagedLayerCache.LEAVES`` order (as this rank holds them)."""
    return list(engine._leaves())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy; bf16 as its uint16 bits (numpy has no bfloat16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_torch(a: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype_name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


@dataclasses.dataclass
class KVSnapshot:
    """Host-side copy of one sequence's live KV state.

    ``pages[i]`` is cache leaf ``i``'s pages in BLOCK-TABLE ORDER with
    shape ``(n_pages, *page_shape)`` (a bf16 leaf as its uint16 bits;
    ``dtypes[i]`` names the leaf's dtype) — position ``t`` lives in
    ``pages[i][t // block_size]`` at slot ``t % block_size``, exactly as
    on the source device.  ``context`` optionally carries the token ids
    the pages encode (prompt + generated at extraction time), letting a
    receiver fall back to re-prefill if restore is impossible.
    ``prompt_len`` marks how many of those tokens are the immutable
    prompt: pages fully inside that span are safe to publish into the
    target pool's prefix index on restore (ownership travels with the
    pages — the target can serve cache hits for the same prompt without
    ever re-prefilling it)."""

    seq_len: int
    block_size: int
    pages: List[np.ndarray]
    context: Optional[List[int]] = None
    prompt_len: Optional[int] = None
    dtypes: Optional[List[str]] = None

    @property
    def n_pages(self) -> int:
        return self.pages[0].shape[0] if self.pages else 0

    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.pages)


def extract_sequence(engine, seq_id,
                     context: Optional[List[int]] = None,
                     prompt_len: Optional[int] = None) -> KVSnapshot:
    """Snapshot ``seq_id``'s pages out of ``engine``'s cache.  The
    sequence stays live on the source — callers free it (migration) or
    keep it (replication) afterwards as policy dictates."""
    kv = engine.kv
    table = kv.block_table(seq_id)
    leaves = _leaves(engine)
    idx = torch.as_tensor(np.asarray(table, np.int64)).to(engine.device)
    with torch.no_grad():
        pages = [_to_numpy(leaf.index_select(0, idx)) for leaf in leaves]
    return KVSnapshot(
        seq_len=kv.seq_len(seq_id),
        block_size=kv.block_size,
        pages=pages,
        context=None if context is None else list(map(int, context)),
        prompt_len=None if prompt_len is None else int(prompt_len),
        dtypes=[_dtype_name(leaf) for leaf in leaves],
    )


def restore_sequence(engine, snap: KVSnapshot, seq_id) -> List[int]:
    """Allocate ``seq_id`` in ``engine``'s pool and scatter the
    snapshot's pages into its (fresh) block table.  Returns the new
    table.  Raises ``OutOfBlocks`` (allocation rolled back — nothing
    was written) when the target pool can't hold the sequence, and
    ``ValueError`` on any geometry mismatch."""
    kv = engine.kv
    if kv.block_size != snap.block_size:
        raise ValueError(
            f"block_size mismatch: snapshot pages hold "
            f"{snap.block_size} tokens, target pool {kv.block_size}"
        )
    leaves = _leaves(engine)
    if len(leaves) != len(snap.pages):
        raise ValueError(
            f"cache structure mismatch: snapshot has {len(snap.pages)} "
            f"leaves, target engine {len(leaves)}"
        )
    names = snap.dtypes or [None] * len(leaves)
    for leaf, p, name in zip(leaves, snap.pages, names):
        if tuple(leaf.shape[1:]) != tuple(p.shape[1:]):
            raise ValueError(
                f"page shape mismatch: snapshot {tuple(p.shape[1:])} vs "
                f"target {tuple(leaf.shape[1:])} (different model "
                "geometry or block_size?)"
            )
        if name is not None and name != _dtype_name(leaf):
            raise ValueError(
                f"page dtype mismatch: snapshot {name} vs target "
                f"{_dtype_name(leaf)} (different kv_dtype or model dtype?)")
    table = kv.allocate(seq_id, snap.seq_len)
    if len(table) != snap.n_pages:
        kv.free(seq_id)
        raise ValueError(
            f"snapshot of {snap.seq_len} tokens carries {snap.n_pages} "
            f"pages; target allocated {len(table)}"
        )
    idx = torch.as_tensor(np.asarray(table, np.int64)).to(engine.device)
    with torch.no_grad():
        for leaf, p, name in zip(leaves, snap.pages, names):
            leaf[idx] = _to_torch(p, name or _dtype_name(leaf), leaf.device)
    if snap.prompt_len and snap.context:
        # Migrated pages carry their sharing potential: publish the
        # fully-written prompt pages into the target's prefix index.
        # ``prompt_len`` is the producer's claim of how many leading
        # context tokens have their K/V written (post-prefill that is
        # the whole prompt); full pages inside it become shareable.
        written = min(int(snap.prompt_len), snap.seq_len)
        kv.register_prefix(seq_id, snap.context[:written])
    kv.assert_consistent()
    return table


# -- wire format -------------------------------------------------------
# One metadata frame (small pickle) then one ndarray frame per cache
# leaf, flattened to raw bytes with (numpy dtype, shape) carried in the
# metadata; the leaf's torch dtype name travels in the snapshot.

def _plane(plane):
    """(send, recv) of a communicator's object plane or of a plane with
    the reference ``ObjectPlane``'s ``send``/``recv``."""
    if hasattr(plane, "send_obj"):
        return plane.send_obj, plane.recv_obj
    return plane.send, plane.recv


def send_snapshot(plane, dest: int, snap: KVSnapshot, tag: int = 7) -> None:
    """Ship a snapshot to rank ``dest`` over an object plane."""
    send, _ = _plane(plane)
    meta = {
        "seq_len": snap.seq_len,
        "block_size": snap.block_size,
        "context": snap.context,
        "prompt_len": snap.prompt_len,
        "leaves": [(str(p.dtype), list(p.shape)) for p in snap.pages],
        "dtypes": snap.dtypes,
    }
    send(meta, dest, tag=tag)
    for p in snap.pages:
        flat = np.ascontiguousarray(p).reshape(-1).view(np.uint8)
        send(flat, dest, tag=tag)


def recv_snapshot(plane, source: int, tag: int = 7,
                  timeout_ms: Optional[int] = None) -> KVSnapshot:
    """Receive a :func:`send_snapshot` transmission.  ``timeout_ms``
    bounds EACH frame's wait; a dead sender surfaces as ``TimeoutError``
    (or the plane's own error) rather than a hang."""
    _, recv = _plane(plane)
    meta = recv(source, tag=tag, timeout_ms=timeout_ms)
    pages = []
    for dt_name, shape in meta["leaves"]:
        flat = recv(source, tag=tag, timeout_ms=timeout_ms)
        pages.append(
            np.asarray(flat).view(np.dtype(dt_name)).reshape(shape)
        )
    return KVSnapshot(
        seq_len=int(meta["seq_len"]),
        block_size=int(meta["block_size"]),
        pages=pages,
        context=meta["context"],
        prompt_len=meta.get("prompt_len"),
        dtypes=meta.get("dtypes"),
    )
