"""Multi-node checkpointer — coordinated snapshot and auto-resume.

Port of ``chainermn_tpu/extensions/checkpoint.py`` (reference: ChainerMN's
``create_multi_node_checkpointer``): each rank snapshots its state, the
checkpointer tracks the newest *consistent* generation (committed by every
rank), rotates old ones, and ``maybe_load`` restores the newest consistent
set before training resumes.

Layout, as the reference's: ``snapshot_iter_N.rankR`` (written to a
``.tmp`` name, then renamed), ``done_iter_N.rankR`` markers holding the
world size that wrote the generation, ``rotated_iter_N`` tombstones for
generations rotated out, ``*.quarantined`` for rejected ones.  A state is
a tree of dicts, lists and tuples whose leaves are tensors, numpy arrays
or picklable scalars (a ``state_dict``, an optimizer's ``state_dict``, a
ZeRO rank's shard).

The snapshot format is the port's own::

    MAGIC | u64 header_len | u32 header_crc32 | header (pickle)
          | payload (raw tensor and array bytes) | u32 payload_crc32

The header holds the tree with each tensor or array replaced by a
reference into the payload (kind, dtype, shape, byte count).  Reading
checks both checksums (``zlib.crc32``) before any byte is trusted; a
corrupt or truncated snapshot raises :class:`CheckpointCorruptionError`,
and ``maybe_load`` quarantines that generation on every rank and falls
back to the one before.  The JAX package's snapshots are not read: weights
cross between the packages through ``convert.py``.
"""

from __future__ import annotations

import os
import pickle
import re
import struct
import threading
import warnings
import zlib
from typing import Any, Optional, Tuple

import numpy as np
import torch


class CheckpointCorruptionError(RuntimeError):
    """A snapshot file failed verification (checksum mismatch, truncation
    or unparseable contents)."""


_MAGIC = b"CMNTORCH1"


class _Ref:
    """Header placeholder for a tensor or array held in the payload."""

    def __init__(self, idx: int):
        self.idx = idx


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _to_host(tree):
    """Tensors to CPU copies and arrays to copies, now: the tree may be
    written on a background thread while the caller mutates its state."""

    def conv(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        if isinstance(x, np.ndarray):
            return np.array(x, copy=True)
        return x

    return _map(conv, tree)


def _split_payload(host_tree):
    """(tree with _Ref placeholders, buffer specs, uint8 numpy buffers)."""
    specs, bufs = [], []

    def conv(x):
        if isinstance(x, torch.Tensor):
            raw = x.contiguous().reshape(-1).view(torch.uint8).numpy()
            specs.append(("torch", str(x.dtype).split(".")[1],
                          tuple(x.shape), raw.nbytes))
        elif isinstance(x, np.ndarray) and x.dtype != object:
            raw = np.ascontiguousarray(x).reshape(-1).view(np.uint8)
            specs.append(("numpy", x.dtype.str, x.shape, raw.nbytes))
        else:
            return x
        bufs.append(raw)
        return _Ref(len(bufs) - 1)

    return _map(conv, host_tree), specs, bufs


def _join_payload(struct_tree, arrays):
    return _map(lambda x: arrays[x.idx] if isinstance(x, _Ref) else x,
                struct_tree)


def _write_snapshot(path: str, host_tree) -> None:
    struct_tree, specs, bufs = _split_payload(host_tree)
    header = pickle.dumps(
        {"struct": struct_tree, "buffers": specs,
         "payload_len": int(sum(b.nbytes for b in bufs))},
        protocol=pickle.HIGHEST_PROTOCOL)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<QI", len(header), zlib.crc32(header)))
        f.write(header)
        crc = 0
        for b in bufs:
            crc = zlib.crc32(b, crc)
            f.write(b.tobytes())
        f.write(struct.pack("<I", crc))


def _read_snapshot(path: str):
    """Parse one snapshot; any failure is a CheckpointCorruptionError (the
    cross-rank vote in ``maybe_load`` catches only that type)."""
    try:
        with open(path, "rb") as f:
            return _read_snapshot_body(path, f)
    except CheckpointCorruptionError:
        raise
    except Exception as e:  # noqa: BLE001 — typed for the vote
        raise CheckpointCorruptionError(f"{path}: unreadable: {e}") from e


def _read_snapshot_body(path: str, f):
    if f.read(len(_MAGIC)) != _MAGIC:
        raise CheckpointCorruptionError(f"{path}: not a snapshot")
    hlen, hcrc = struct.unpack("<QI", f.read(12))
    header_bytes = f.read(hlen)
    if len(header_bytes) != hlen or zlib.crc32(header_bytes) != hcrc:
        raise CheckpointCorruptionError(
            f"{path}: header crc32 mismatch — snapshot is corrupt")
    header = pickle.loads(header_bytes)
    plen = header["payload_len"]
    payload = np.empty(plen, np.uint8)
    if f.readinto(memoryview(payload)) != plen:
        raise CheckpointCorruptionError(f"{path}: payload truncated")
    tail = f.read(4)
    if len(tail) != 4:
        raise CheckpointCorruptionError(f"{path}: checksum truncated")
    (crc,) = struct.unpack("<I", tail)
    if zlib.crc32(payload) != crc:
        raise CheckpointCorruptionError(
            f"{path}: payload crc32 mismatch — snapshot is corrupt")
    arrays, off = [], 0
    for kind, dt, shape, nbytes in header["buffers"]:
        raw = payload[off:off + nbytes].copy()
        off += nbytes
        if kind == "torch" and not nbytes:       # no bytes to view
            arrays.append(torch.empty(shape, dtype=getattr(torch, dt)))
        elif kind == "torch":
            arrays.append(torch.from_numpy(raw).view(getattr(torch, dt))
                          .reshape(shape))
        else:
            arrays.append(raw.view(np.dtype(dt)).reshape(shape))
    return _join_payload(header["struct"], arrays)


def _restore(tpl, saved):
    """``saved`` with each tensor moved to the dtype and device of the
    template's leaf at the same path, where there is one."""
    if isinstance(saved, dict):
        return {k: _restore(tpl.get(k) if isinstance(tpl, dict) else None, v)
                for k, v in saved.items()}
    if isinstance(saved, (list, tuple)):
        tpls = (tpl if isinstance(tpl, (list, tuple))
                and len(tpl) == len(saved) else [None] * len(saved))
        return type(saved)(_restore(t, v) for t, v in zip(tpls, saved))
    if isinstance(saved, torch.Tensor) and isinstance(tpl, torch.Tensor):
        return saved.to(device=tpl.device, dtype=tpl.dtype)
    return saved


class MultiNodeCheckpointer:
    def __init__(
        self,
        name: str,
        comm,
        path: str = ".",
        keep: int = 2,
        keep_last_n: Optional[int] = None,
    ):
        self.name = name
        self.comm = comm
        self.dir = os.path.join(path, name)
        # ``keep_last_n`` is the retention knob long soaks tune: it
        # bounds BOTH live consistent generations (same rotation as
        # ``keep``, which it overrides when given) and retained
        # quarantined generations.
        self.keep = keep if keep_last_n is None else int(keep_last_n)
        os.makedirs(self.dir, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._pending_error: Optional[BaseException] = None
        # Catch up on rotations a previous run decided but didn't finish
        # (e.g. a rank that never ran another cleanup): drop our own files
        # of tombstoned generations so stale tombstones get released
        # instead of lingering to shadow future saves.
        self._cleanup(ranks=(comm.rank,))

    # -- file layout -----------------------------------------------------
    def _snap(self, iteration: int, rank: int) -> str:
        return os.path.join(self.dir, f"snapshot_iter_{iteration}.rank{rank}")

    def _marker(self, iteration: int, rank: int) -> str:
        return os.path.join(self.dir, f"done_iter_{iteration}.rank{rank}")

    def _tomb(self, iteration: int) -> str:
        return os.path.join(self.dir, f"rotated_iter_{iteration}")

    # -- API (reference: checkpointer.save / maybe_load) ------------------
    def save(self, state: Any, iteration: int, block: bool = True) -> None:
        """Snapshot ``state`` as generation ``iteration``.

        ``block=False``: the device-to-host copy happens now (the caller
        may mutate the live state at once), but serialization and file
        I/O run on a background thread — call :meth:`wait` (or let the
        next ``save``/``maybe_load`` do it) to join.
        """
        self.wait()
        rank = self.comm.rank
        # A fresh save of this iteration supersedes any earlier rotation
        # of the same number (dir reuse across runs): clear the tombstone
        # so cleanup cannot delete the checkpoint we are about to write.
        try:
            os.remove(self._tomb(iteration))
        except OSError:
            pass
        host_state = _to_host(state)

        def write():
            tmp = self._snap(iteration, rank) + ".tmp"
            _write_snapshot(tmp, host_state)
            os.replace(tmp, self._snap(iteration, rank))
            with open(self._marker(iteration, rank), "w") as f:
                # The marker records the world size that wrote this
                # generation: consistency is "every SAVE-TIME rank
                # committed", so a rescaled relaunch (different
                # comm.size) can still recognize and resume it.
                f.write(f"ok {self.comm.size}")

        if block:
            write()
            self.comm.barrier()
            # Cleanup only after every rank has committed this generation:
            # deleting a rotated generation before a straggler finished
            # choosing its newest-consistent set could turn its maybe_load
            # into a FileNotFoundError.
            self._cleanup()
        else:
            def run():
                try:
                    write()
                    # No barrier on the background thread; deleting other
                    # ranks' files here could race a straggler's
                    # maybe_load, so each rank rotates only its own.
                    self._cleanup(ranks=(rank,))
                except BaseException as e:  # noqa: BLE001 — surfaced in wait()
                    self._pending_error = e

            self._pending = threading.Thread(target=run, daemon=True)
            self._pending.start()

    def wait(self) -> None:
        """Join an in-flight async save; re-raise its error, if any."""
        t, self._pending = self._pending, None
        if t is not None:
            t.join()
        err, self._pending_error = self._pending_error, None
        if err is not None:
            raise err

    def _generations(self, names=None):
        if names is None:
            names = os.listdir(self.dir)
        pat = re.compile(r"done_iter_(\d+)\.rank(\d+)$")
        gens: dict[int, int] = {}
        for fn in names:
            m = pat.match(fn)
            if m:
                gens[int(m.group(1))] = gens.get(int(m.group(1)), 0) + 1
        for it in self._tombstoned(names):
            gens.pop(it, None)
        return gens

    def _tombstoned(self, names=None):
        if names is None:
            names = os.listdir(self.dir)
        pat = re.compile(r"rotated_iter_(\d+)$")
        return sorted(
            int(m.group(1)) for m in map(pat.match, names) if m
        )

    def _marker_world(self, it: int, names=None) -> Optional[int]:
        """World size recorded in generation ``it``'s markers, or None
        for legacy markers (pre-world-stamp: plain "ok")."""
        if names is None:
            names = os.listdir(self.dir)
        pat = re.compile(rf"done_iter_{it}\.rank\d+$")
        for fn in sorted(n for n in names if pat.match(n)):
            try:
                with open(os.path.join(self.dir, fn)) as f:
                    parts = f.read().split()
                if len(parts) >= 2:
                    return int(parts[1])
            except (OSError, ValueError):
                continue
        return None

    def _consistent_generations(self, names=None):
        """Generations every save-time rank committed.  The marker's
        recorded world size (not the CURRENT comm.size) is the quorum,
        so an elastic N→M relaunch resumes generations the old world
        wrote; legacy markers fall back to the current-size rule."""
        if names is None:
            names = os.listdir(self.dir)
        out = []
        for it, cnt in self._generations(names).items():
            world = self._marker_world(it, names)
            if cnt >= (world if world is not None else self.comm.size):
                out.append(it)
        return sorted(out)

    def _quarantined_generations(self, names=None):
        if names is None:
            names = os.listdir(self.dir)
        pat = re.compile(
            r"(?:snapshot|done)_iter_(\d+)\.rank\d+\.quarantined$"
        )
        return sorted({
            int(m.group(1)) for m in map(pat.match, names) if m
        })

    def _quarantine(self, it: int) -> None:
        """Rename generation ``it``'s files to ``*.quarantined`` so it
        drops out of ``_generations`` permanently — rejected snapshots
        are kept for forensics but never re-verified on later loads.
        Every rank runs this after the failed vote; file ownership is
        split by ``saved_rank % comm.size`` so concurrent renames never
        collide and orphan ranks of a shrunken world are covered."""
        pat = re.compile(
            rf"(?:snapshot|done)_iter_{it}\.rank(\d+)(?:\.tmp)?$"
        )
        for fn in os.listdir(self.dir):
            m = pat.match(fn)
            if not m or int(m.group(1)) % self.comm.size != self.comm.rank:
                continue
            src = os.path.join(self.dir, fn)
            try:
                os.replace(src, src + ".quarantined")
            except OSError:
                pass

    def _cleanup(self, ranks=None):
        """Rotate old generations.

        Rotation is decided ONCE, while the generation is still fully
        consistent, by writing a tombstone (``rotated_iter_N``); every
        rank's later cleanup sees the tombstone and removes its share, so
        nothing leaks even when each rank deletes only its own files.
        ``ranks``: which ranks' files to delete — all (blocking mode,
        after the barrier) or just our own (async mode, where deleting a
        straggler's files could race its ``maybe_load``; each rank reads
        only its own snapshot, so own-file deletion can never break a
        concurrent load on another rank).  File ownership is
        ``saved_rank % comm.size``, NOT identity: after a rescale the
        dead ranks' leftovers must still have an owner, or a shrunken
        world would leak them forever.

        Quarantined generations rotate on the same ``keep`` budget but
        without tombstones (nothing ever loads them, so deleting them
        can't race anything).
        """
        # One directory snapshot serves every check below (shared/network
        # storage: listings are not free), updated locally as we write
        # tombstones and delete files.
        names = set(os.listdir(self.dir))
        done = self._consistent_generations(names)
        for it in done[: -self.keep] if len(done) > self.keep else []:
            with open(self._tomb(it), "w") as f:
                f.write("rotated")
            names.add(os.path.basename(self._tomb(it)))

        def mine(saved_rank: int) -> bool:
            return ranks is None or \
                saved_rank % self.comm.size in ranks

        pat = re.compile(
            r"(?:snapshot|done)_iter_(\d+)\.rank(\d+)"
            r"(?:\.tmp)?(\.quarantined)?$"
        )
        tombstoned = set(self._tombstoned(names))
        quarantined = self._quarantined_generations(names)
        stale_q = set(
            quarantined[: -self.keep] if len(quarantined) > self.keep
            else []
        )
        for fn in sorted(names):
            m = pat.match(fn)
            if not m:
                continue
            it, saved_rank = int(m.group(1)), int(m.group(2))
            if m.group(3):
                if it not in stale_q:
                    continue
            elif it not in tombstoned:
                continue
            if not mine(saved_rank):
                continue
            try:
                os.remove(os.path.join(self.dir, fn))
                names.discard(fn)
            except OSError:
                pass
        # Drop a tombstone once every live (non-quarantined) file of its
        # generation — including any crash-orphaned .tmp — is gone (any
        # rank may observe this; double-removal is swallowed).
        for it in tombstoned:
            gone = not any(
                (m := pat.match(fn)) is not None
                and int(m.group(1)) == it and not m.group(3)
                for fn in names
            )
            if gone:
                try:
                    os.remove(self._tomb(it))
                except OSError:
                    pass

    def maybe_load(self, state: Any = None) -> Tuple[Any, Optional[int]]:
        """Restore the newest consistent generation, or return ``state``
        untouched when none exists (reference ``maybe_load`` contract).

        With a ``state`` template, each tensor whose path exists in the
        template comes back at that leaf's dtype and device; the others
        (optimizer state that a fresh optimizer has not created yet, for
        one) come back on the CPU, where ``load_state_dict`` places them.

        Integrity: every snapshot verifies its crc32 before any byte is
        trusted.  A corrupt newest generation falls back (with a warning)
        to the next older consistent one — *agreed across ranks*, so a
        generation corrupt on any single rank is skipped by all — and
        *quarantined* (files renamed ``*.quarantined``), so no later
        load re-verifies it.  If every consistent generation is corrupt
        this raises rather than silently restarting from scratch."""
        self.wait()
        done = self._consistent_generations()
        # The per-generation integrity votes below are collectives, so all
        # ranks must iterate the SAME generation list: one rank listing a
        # marker before another (async saves, NFS attribute caching) would
        # otherwise desynchronize the votes.  Agree on the intersection.
        if self.comm.size > 1:
            lists = self.comm.allgather_obj(set(done))
            done = sorted(set.intersection(*map(set, lists)))
        if not done:
            return state, None
        last_err: Optional[BaseException] = None
        for it in reversed(done):
            # A generation written by a different world size maps ranks
            # onto save-time snapshots by modulo (valid for replicated
            # state; per-rank ZeRO shards need the same world).
            world = self._marker_world(it) or self.comm.size
            src = self.comm.rank % max(1, world)
            try:
                loaded = _read_snapshot(self._snap(it, src))
                ok = 1
            except CheckpointCorruptionError as e:
                loaded, ok, last_err = None, 0, e
            # All ranks must restore the same generation: one rank's
            # corruption vetoes the generation everywhere.
            ok_everywhere = (
                bool(ok) if self.comm.size == 1
                else self.comm.allreduce_obj(ok) == self.comm.size
            )
            if not ok_everywhere:
                warnings.warn(
                    f"checkpoint generation {it} is corrupt on at least one "
                    f"rank ({last_err}); quarantining it and falling back "
                    f"to an older generation"
                )
                # Rename, don't re-verify: the rejected generation drops
                # out of _generations for good, so every later load skips
                # straight past it.
                self._quarantine(it)
                continue
            if state is not None:
                loaded = _restore(state, loaded)
            return loaded, it
        raise CheckpointCorruptionError(
            f"all consistent checkpoint generations {done} failed "
            f"integrity verification; refusing to silently restart "
            f"from scratch"
        ) from last_err


def create_multi_node_checkpointer(
    name: str, comm, path: str = ".", keep: int = 2,
    keep_last_n: Optional[int] = None,
) -> MultiNodeCheckpointer:
    """Reference-parity factory (ChainerMN's
    ``create_multi_node_checkpointer``).  ``keep_last_n`` overrides
    ``keep`` and also bounds retained quarantined generations."""
    return MultiNodeCheckpointer(
        name, comm, path=path, keep=keep, keep_last_n=keep_last_n
    )
