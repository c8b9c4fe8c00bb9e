"""Host-plane transport over a ``torch.distributed`` key-value store —
port of ``chainermn_tpu/communicators/kvtransport.py``, the analogue of
the reference's pickled-MPI transport.

The reference runs this transport over jax's coordination-service KV
store.  The port runs it over one ``torch.distributed.Store`` a process
holds (a ``TCPStore``: the master in the fleet's process 0, a client in
every other process), which the entry point installs with
:func:`install`.  No process group is needed: the serving fleet calls no
``init_process_group``.  The reference's client calls map onto the
store:

============================  ==========================================
reference (jax client)        port (``torch.distributed.Store``)
============================  ==========================================
``key_value_set[_bytes]``     ``set``
``blocking_key_value_get``    ``wait([key], timeout)`` then ``get``, in
                              ``POLL_SLICE_MS`` slices
``key_value_increment``       ``add``
``key_value_delete``          ``delete_key``
gRPC ``DEADLINE_EXCEEDED``    ``DistStoreError`` whose text says timeout
============================  ==========================================

On it the module builds the reference's primitives, their wire formats
unchanged:

* ``put_payload``/``get_payload`` — a chunked header-written-last
  protocol.  Values are split into ``CHUNK_BYTES`` pieces, the chunk
  writes are pipelined over a small thread pool, and the header key is
  written *last*, so a reader blocking on the header never observes a
  partial write.
* **Typed ndarray fast path** — a C-contiguous ``np.ndarray`` payload
  travels as raw buffer bytes with dtype/shape in the header (no pickle
  on either side; the receiver's chunks land in the preallocated
  result).  Everything else goes through pickle.
* single-reader keys are deleted by their reader; multi-reader keys are
  garbage-collected by the *last* reader, elected with the store's
  atomic ``add`` counter.

Keys are namespaced under ``chainermn_tpu/`` (the reference's wire
names) and carry a monotone per-(edge, tag) sequence number maintained
independently on each side, so no two in-flight transfers share a key.

**Direct-socket bulk data plane** (:class:`SocketPlane`): the store is a
control plane, so point-to-point payloads ride a DIRECT TCP connection
between the two processes.  Each process lazily opens one listener,
publishes its ``host:port:token`` under a store key, and sends framed
payloads (JSON header + raw buffer bytes; typed ndarrays ``recv_into``
the preallocated result).  p2p send/recv, ``gather`` and the per-rank
legs of ``scatter`` ride sockets; the store's chunk path remains as the
socket-less fallback and carries bcast/allgather.  A peer whose
connection hits EOF is :class:`PeerGone`; a replacement process at the
same rank republishes its endpoint and resumes the stream.

Nothing on the wire is a ``torch.Tensor``: callers hand numpy arrays and
plain Python objects (a pickled CUDA tensor would drag its device along).
"""

from __future__ import annotations

import datetime
import pickle
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np

import os as _os

# 2 MiB chunks (the reference's size: it keeps each store value small and
# round-trips low).  Env-tunable for stores with other ceilings/latency.
CHUNK_BYTES = int(
    _os.environ.get("CHAINERMN_TPU_KV_CHUNK_BYTES", str(2 << 20))
)

# In-flight chunk calls per transfer.  The store is latency-bound per
# call; a handful of overlapped calls saturates it without flooding the
# master.
PIPELINE_DEPTH = int(_os.environ.get("CHAINERMN_TPU_KV_DEPTH", "8"))

# Socket-plane handshake token length (see SocketPlane's trust boundary).
TOKEN_BYTES = 16

# Blocking gets wait indefinitely by default — MPI semantics: a slow peer
# is waited for; a *dead* peer surfaces through the socket plane.
# The wait is implemented as poll slices so a caller-supplied finite
# timeout (recv_obj's escape hatch) is honored promptly.
POLL_SLICE_MS = 60_000

_PREFIX = "chainermn_tpu"

# Upper bound on a single socket-plane frame payload.  A corrupt header
# must not drive a multi-GB allocation on the receiver, so the reader
# enforces it — and the SENDER enforces the same bound so an oversized
# payload fails loudly on the sending rank instead of poisoning the
# receiver's plane.  Env-tunable (set IDENTICALLY on every process) for
# giant object sends.  Headers are small JSON; their length prefix gets
# its own tight cap.
MAX_FRAME_BYTES = int(
    _os.environ.get("CHAINERMN_TPU_MAX_FRAME_BYTES", str(16 << 30))
)
MAX_HEADER_BYTES = 1 << 20

# Sentinel pushed into every route queue when a reader thread dies on a
# malformed frame, so blocked recvs raise instead of hanging to timeout.
_POISON = object()


class PeerGone(RuntimeError):
    """A host-plane peer died: its connection hit EOF/reset, or a send to
    it failed at the socket layer.  Distinct from :class:`TimeoutError`
    (the peer may merely be slow and the recv is retryable): a
    ``PeerGone`` means the peer's *incarnation* is over — retrying
    against it is pointless until a replacement re-handshakes (a new
    process republishing the same rank's endpoint and reconnecting).
    Router health checks and KV migration catch this to fail over
    instead of hanging."""

    def __init__(self, msg: str, peer: "int | None" = None):
        super().__init__(msg)
        self.peer = peer


class _PeerGoneMarker:
    """Queue sentinel for a dead peer.  Honored only while the plane
    still believes the peer is gone — a replacement incarnation's first
    frame revives the peer, after which stale markers are skipped, so
    messages queued behind one are not lost."""

    __slots__ = ("src", "reason")

    def __init__(self, src: int, reason: str):
        self.src = src
        self.reason = reason


def retry_backoff(fn, *, retries: int = 3, base_s: float = 0.05,
                  exceptions=(PeerGone, TimeoutError)):
    """Call ``fn()`` with exponential backoff on transient host-plane
    failures (the satellite contract: fail fast with ``PeerGone``/
    ``TimeoutError``, then retry with backoff rather than hang).  The
    last failure propagates after ``retries`` re-attempts."""
    attempt = 0
    while True:
        try:
            return fn()
        except exceptions:
            if attempt >= retries:
                raise
            time.sleep(base_s * (2 ** attempt))
            attempt += 1

_pool: ThreadPoolExecutor | None = None


def _get_pool() -> ThreadPoolExecutor:
    global _pool
    if _pool is None:
        _pool = ThreadPoolExecutor(
            max_workers=PIPELINE_DEPTH,
            thread_name_prefix="chainermn_tpu_torch_kv",
        )
    return _pool


_store = None


def install(store) -> None:
    """Make ``store`` (a ``torch.distributed.Store``: a ``TCPStore``, or
    anything with its ``set``/``get``/``wait``/``add``/``delete_key``) the
    process's transport store.  The entry point calls it once, before any
    plane is built (see ``tools.serve``'s ``_init_distributed``)."""
    global _store
    _store = store


def uninstall() -> None:
    """Drop the process's store and close its socket plane's listener
    (the plane's endpoint lives in that store)."""
    global _store, _socket_plane
    if _socket_plane is not None:
        _socket_plane._srv.close()
    _store = None
    _socket_plane = None


def client():
    """The process's transport store, or None when none is installed
    (single-process runs)."""
    return _store


def available() -> bool:
    return client() is not None


def _client():
    c = client()
    if c is None:
        raise RuntimeError(
            "no host-plane store is installed: call kvtransport.install() "
            "with a torch.distributed TCPStore first (the serving CLI does "
            "this from --coordinator/--num-processes/--process-id)"
        )
    return c


def _is_deadline(e: Exception) -> bool:
    """Did a bounded store wait time out (vs a real transport error)?
    ``Store.wait`` raises ``DistStoreError`` with "timeout" in its text;
    match the type and the text."""
    import torch.distributed as dist

    err = getattr(dist, "DistStoreError", RuntimeError)
    return isinstance(e, err) and "TIMEOUT" in str(e).upper()


def _get_raw(c, key: str, timeout_ms: int) -> bytes:
    """The store's blocking get: wait up to ``timeout_ms`` for ``key``,
    then read it."""
    c.wait([key], datetime.timedelta(milliseconds=max(1, int(timeout_ms))))
    return c.get(key)


def _get_str(c, key: str, timeout_ms: int) -> str:
    v = _get_raw(c, key, timeout_ms)
    return v.decode() if isinstance(v, (bytes, bytearray)) else str(v)


def _delete(c, key: str) -> None:
    c.delete_key(key)


def _put_chunks(c, key: str, view: memoryview) -> int:
    """Write ``view`` as pipelined CHUNK_BYTES-sized chunk values; returns
    the count.  The header is NOT written here — callers write it last."""
    n = max(1, -(-len(view) // CHUNK_BYTES))
    if n == 1:
        c.set(f"{key}/c0", bytes(view))
        return n
    futs = [
        _get_pool().submit(
            c.set,
            f"{key}/c{i}",
            bytes(view[i * CHUNK_BYTES : (i + 1) * CHUNK_BYTES]),
        )
        for i in range(n)
    ]
    for f in futs:
        f.result()
    return n


def _hdr_prefix(n: int) -> str:
    # The chunk size travels in the header: CHUNK_BYTES is env-tunable,
    # and a sender/receiver mismatch must not scramble chunk offsets.
    return f"{n},{CHUNK_BYTES}"


def _parse_hdr(hdr: str) -> tuple[int, int, str]:
    count, _, meta = hdr.partition("|")
    n, _, chunk = count.partition(",")
    return int(n), int(chunk) if chunk else CHUNK_BYTES, meta


def put_bytes(key: str, data) -> None:
    """Publish ``data`` (bytes-like) under ``key`` — chunked, chunk RPCs
    pipelined, header written last."""
    c = _client()
    n = _put_chunks(c, key, memoryview(data).cast("B"))
    c.set(f"{key}/hdr", f"{_hdr_prefix(n)}|raw")


def _byte_view(a: np.ndarray) -> memoryview:
    """Flat byte view of a C-contiguous array (0-d safe)."""
    return memoryview(a.reshape(-1).view(np.uint8))


def _is_typed_array(obj) -> bool:
    """Payloads eligible for the raw-buffer path: plain ndarrays whose
    dtype holds no Python references anywhere (``hasobject`` also catches
    structured dtypes with object fields, which ``dtype != object``
    would not).  Exactly ``np.ndarray`` — subclasses (``np.matrix``,
    ``np.ma.MaskedArray``) carry state a raw buffer would drop, so they
    take the pickle path, which round-trips them faithfully."""
    return type(obj) is np.ndarray and not obj.dtype.hasobject


def put_payload(key: str, obj) -> None:
    """Publish a Python object under ``key``.

    C-contiguous-able ndarrays travel TYPED: raw buffer chunks plus
    dtype/shape in the header, no pickle byte-string materialized
    (the reference's first-class ndarray ``send`` path,
    REF:chainermn/communicators/mpi_communicator_base.py).  Everything
    else is pickled."""
    c = _client()
    if _is_typed_array(obj):
        # asarray(order="C"), not ascontiguousarray: the latter silently
        # promotes 0-d arrays to shape (1,).
        a = np.asarray(obj, order="C")
        n = _put_chunks(c, key, _byte_view(a))
        shape = "x".join(map(str, a.shape))
        # ';' separators: dtype.str itself contains '|' (e.g. '|S1').
        c.set(f"{key}/hdr", f"{_hdr_prefix(n)}|nd;{a.dtype.str};{shape}")
        return
    n = _put_chunks(c, key, memoryview(pickle.dumps(obj)))
    c.set(f"{key}/hdr", f"{_hdr_prefix(n)}|pkl")


def _blocking_get(fn, key: str, deadline: float | None):
    """Call a blocking store getter ``fn(key, slice_ms)``, waiting until
    ``deadline`` (monotonic seconds; None = forever), polling in
    ``POLL_SLICE_MS`` slices.
    Non-deadline errors propagate immediately; deadline expiry raises
    ``TimeoutError`` so callers see the same exception type on both
    transports (the socket plane's ``recv`` already raises it)."""
    while True:
        if deadline is None:
            slice_ms = POLL_SLICE_MS
        else:
            remaining = int((deadline - time.monotonic()) * 1000)
            if remaining <= 0:
                remaining = 1
            slice_ms = min(POLL_SLICE_MS, remaining)
        try:
            return fn(key, slice_ms)
        except Exception as e:
            if not _is_deadline(e):
                raise
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"store get of {key!r} expired its caller deadline "
                    f"({type(e).__name__} from the store)"
                ) from e


def _get_chunks_into(c, key: str, n: int, chunk: int, out, deadline) -> None:
    """Fetch ``n`` chunks of ``key`` (written with chunk size ``chunk``)
    into the writable buffer ``out`` — chunk reads pipelined, each landing
    at its offset, no join copy."""
    view = memoryview(out).cast("B")

    def fetch(i: int) -> None:
        data = _blocking_get(
            lambda k, ms: _get_raw(c, k, ms), f"{key}/c{i}", deadline
        )
        view[i * chunk : i * chunk + len(data)] = data

    if n == 1:
        fetch(0)
        return
    futs = [_get_pool().submit(fetch, i) for i in range(n)]
    for f in futs:
        f.result()


def _assemble_raw(c, key: str, n: int, chunk: int, deadline) -> bytes:
    """Fetch an n-chunk variable-length payload: the tail chunk sizes the
    buffer, the rest land at their offsets."""
    tail = _blocking_get(
        lambda k, ms: _get_raw(c, k, ms), f"{key}/c{n - 1}", deadline
    )
    out = bytearray((n - 1) * chunk + len(tail))
    out[(n - 1) * chunk :] = tail
    if n > 1:
        _get_chunks_into(c, key, n - 1, chunk, out, deadline)
    return bytes(out)


def _deadline_of(timeout_ms: int | None) -> float | None:
    return None if timeout_ms is None else time.monotonic() + timeout_ms / 1e3


def get_bytes(
    key: str, *, timeout_ms: int | None = None
) -> tuple[bytes, int]:
    """Block until ``key`` is published; return (payload, n_chunks).
    ``timeout_ms`` bounds the WHOLE receive (one deadline shared by the
    header and every chunk), not each store round-trip."""
    c = _client()
    deadline = _deadline_of(timeout_ms)
    hdr = _blocking_get(lambda k, ms: _get_str(c, k, ms), f"{key}/hdr",
                        deadline)
    n, chunk, _meta = _parse_hdr(hdr)
    return _assemble_raw(c, key, n, chunk, deadline), n


def get_payload(key: str, *, timeout_ms: int | None = None):
    """Block until ``key`` is published; return (object, n_chunks).

    Typed ndarray payloads are fetched straight into the preallocated
    result array (chunk reads pipelined, each landing at its offset — no
    join, no pickle, no extra copy); pickled payloads are assembled and
    unpickled.  ``timeout_ms`` bounds the WHOLE receive."""
    c = _client()
    deadline = _deadline_of(timeout_ms)
    hdr = _blocking_get(lambda k, ms: _get_str(c, k, ms), f"{key}/hdr",
                        deadline)
    n, chunk, meta = _parse_hdr(hdr)
    if meta.startswith("nd;"):
        _, dts, shp = meta.split(";", 2)
        a = np.empty(tuple(int(s) for s in shp.split("x") if s), np.dtype(dts))
        _get_chunks_into(c, key, n, chunk, _byte_view(a), deadline)
        return a, n
    return pickle.loads(_assemble_raw(c, key, n, chunk, deadline)), n


def delete(key: str, n_chunks: int) -> None:
    c = _client()
    for i in range(n_chunks):
        _delete(c, f"{key}/c{i}")
    _delete(c, f"{key}/hdr")


def ack_and_collect(key: str, n_chunks: int, n_readers: int) -> None:
    """Reader-side GC for multi-reader keys: the last of ``n_readers`` to
    ack (atomic increment) deletes the data; earlier readers return
    immediately.  Safe because readers only ack *after* consuming."""
    c = _client()
    if int(c.add(f"{key}/ack", 1)) >= n_readers:
        delete(key, n_chunks)
        _delete(c, f"{key}/ack")


class SocketPlane:
    """Per-process direct-TCP data plane for host p2p payloads.

    One listener socket per process (shared by every ObjectPlane),
    rendezvoused through the store: rank r publishes
    ``chainermn_tpu/sockep/r`` = ``host:port`` once.  A background thread
    per accepted connection reads frames —

        ``u32 header_len | header JSON | payload bytes``

    with the header carrying (namespace, src, tag, seq, kind, dtype,
    shape, nbytes) — and routes decoded objects into per-(namespace, src,
    tag) queues, where :meth:`recv` awaits them.  TCP preserves per-edge
    order and senders stamp sequence numbers, so MPI's (communicator,
    source, tag, order) matching rule holds; a timed-out recv leaves the
    queue intact and is retryable.  Typed ndarrays are received straight
    into the preallocated result array (``recv_into`` — no join, no
    pickle, no extra copy).

    Trust boundary: frames can carry pickles, so accepting one from an
    arbitrary connection would be code execution.  The listener binds to
    the store-facing interface only, and every connection must open with
    this process's secret token — a random value published ONLY through
    the store, so a peer that presents it has store access, the same
    trust the store fallback path requires.  Wrong or
    missing token → the connection is dropped before any frame is read."""

    def __init__(self, rank: int):
        import secrets
        import socket as _socket
        import threading

        self.rank = rank
        self._socket = _socket
        self._queues: dict[tuple, Any] = {}
        self._queues_lock = threading.Lock()
        self._broken: str | None = None  # first reader decode failure
        # src rank -> reason, for peers whose connection died (EOF/reset).
        # Cleared when a replacement incarnation's frames arrive.
        self._gone: dict[int, str] = {}
        self._send_socks: dict[int, Any] = {}
        self._send_lock = threading.Lock()
        self._token = secrets.token_bytes(TOKEN_BYTES)
        host = self._my_host()
        srv = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
        srv.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        srv.bind((host, 0))
        srv.listen(64)
        self._srv = srv
        port = srv.getsockname()[1]
        # Delete-then-set: a replacement process taking over a dead rank's
        # identity must be able to republish the endpoint (some stores
        # reject silent overwrites; delete of a missing key may raise —
        # both are fine).
        try:
            _delete(_client(), f"{_PREFIX}/sockep/{rank}")
        except Exception:
            pass
        _client().set(
            f"{_PREFIX}/sockep/{rank}",
            f"{host}:{port}:{self._token.hex()}",
        )
        t = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="chainermn_tpu_torch_sock_accept",
        )
        t.start()

    def _my_host(self) -> str:
        """An address peers can reach: the interface that routes toward
        the store's host (loopback on single-machine runs)."""
        host = getattr(client(), "host", None)
        if not host:
            return "127.0.0.1"
        try:
            s = self._socket.socket(
                self._socket.AF_INET, self._socket.SOCK_DGRAM
            )
            try:
                s.connect((host, 1))
                return s.getsockname()[0]
            finally:
                s.close()
        except Exception:
            return "127.0.0.1"

    # -- receive side ---------------------------------------------------
    def _queue(self, route: tuple):
        import queue as _q

        with self._queues_lock:
            q = self._queues.get(route)
            if q is None:
                q = self._queues[route] = _q.Queue()
            return q

    def _accept_loop(self):
        import threading

        while True:
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                return  # listener closed at process exit
            threading.Thread(
                target=self._reader_loop, args=(conn,), daemon=True,
                name="chainermn_tpu_torch_sock_reader",
            ).start()

    def _read_exact(self, conn, view: memoryview) -> bool:
        got = 0
        while got < len(view):
            n = conn.recv_into(view[got:], len(view) - got)
            if n == 0:
                return False
            got += n
        return True

    def _mark_gone(self, srcs, reason: str) -> None:
        """Record that every src rank seen on a now-dead connection is
        gone, and wake any recv blocked on one of its routes with a
        :class:`_PeerGoneMarker`.  Messages already queued ahead of the
        marker still deliver in order; the marker is only honored while
        ``_gone`` still lists the src (a replacement incarnation's first
        frame revives it, turning queued markers into no-ops)."""
        if not srcs:
            return
        with self._queues_lock:
            for src in srcs:
                self._gone[src] = reason
            routes = [
                (route, q) for route, q in self._queues.items()
                if route[1] in srcs
            ]
        for (_ns, src, _tag), q in routes:
            q.put(_PeerGoneMarker(src, reason))

    def peer_gone(self, src: int) -> "str | None":
        """The recorded death reason for ``src``, or None while it is
        believed alive."""
        with self._queues_lock:
            return self._gone.get(src)

    def _reader_loop(self, conn):
        import hmac
        import json as _json
        import struct

        # src ranks whose frames arrived on THIS connection: the set the
        # connection's death condemns.
        seen_srcs: set = set()
        try:
            conn.setsockopt(
                self._socket.IPPROTO_TCP, self._socket.TCP_NODELAY, 1
            )
            # Handshake: the peer must present our secret token (known
            # only via the store) before any frame is processed.
            presented = bytearray(TOKEN_BYTES)
            if not self._read_exact(conn, memoryview(presented)):
                conn.close()
                return
            if not hmac.compare_digest(bytes(presented), self._token):
                conn.close()
                return
            lenbuf = bytearray(4)
            while True:
                if not self._read_exact(conn, memoryview(lenbuf)):
                    self._mark_gone(seen_srcs, "connection EOF")
                    return
                (hlen,) = struct.unpack("<I", lenbuf)
                if hlen > MAX_HEADER_BYTES:
                    raise ValueError(
                        f"frame header length {hlen} exceeds "
                        f"{MAX_HEADER_BYTES} (stream desync/corruption?)"
                    )
                hbuf = bytearray(hlen)
                if not self._read_exact(conn, memoryview(hbuf)):
                    self._mark_gone(seen_srcs, "connection EOF mid-frame")
                    return
                hdr = _json.loads(hbuf.decode())
                nbytes = int(hdr["nbytes"])
                if nbytes < 0 or nbytes > MAX_FRAME_BYTES:
                    raise ValueError(
                        f"frame nbytes {nbytes} outside [0, "
                        f"{MAX_FRAME_BYTES}]"
                    )
                if hdr["kind"] == "nd":
                    dt = np.dtype(hdr["dtype"])
                    shape = tuple(int(s) for s in hdr["shape"])
                    want = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
                    if want != nbytes:
                        raise ValueError(
                            f"frame header inconsistent: dtype {dt} shape "
                            f"{shape} implies {want} bytes, header says "
                            f"{nbytes}"
                        )
                    a = np.empty(shape, dt)
                    if not self._read_exact(conn, _byte_view(a)):
                        self._mark_gone(
                            seen_srcs, "connection EOF mid-frame"
                        )
                        return
                    obj = a
                else:
                    buf = bytearray(nbytes)
                    if not self._read_exact(conn, memoryview(buf)):
                        self._mark_gone(
                            seen_srcs, "connection EOF mid-frame"
                        )
                        return
                    obj = pickle.loads(bytes(buf))
                src = hdr["src"]
                if src not in seen_srcs:
                    seen_srcs.add(src)
                    with self._queues_lock:
                        # A fresh connection carrying this src's frames
                        # is the re-handshake: the replacement is live.
                        self._gone.pop(src, None)
                route = (hdr["ns"], src, hdr["tag"])
                self._queue(route).put((hdr["seq"], obj))
        except OSError as e:
            self._mark_gone(seen_srcs, f"connection error: {e}")
            return
        except Exception as e:
            # A malformed frame must not kill the reader silently: record
            # the failure so every pending/future recv raises a transport
            # error instead of hanging to its timeout.
            self._broken = f"{type(e).__name__}: {e}"
            with self._queues_lock:
                queues = list(self._queues.values())
            for q in queues:
                q.put(_POISON)
            try:
                conn.close()
            except Exception:
                pass
            return

    def recv(
        self, ns: str, source: int, tag: int, seq: int,
        timeout_ms: int | None = None,
    ):
        import queue as _q

        q = self._queue((ns, source, tag))
        deadline = _deadline_of(timeout_ms)
        while True:
            if self._broken is not None:
                raise RuntimeError(
                    f"host-plane socket reader on rank {self.rank} died "
                    f"decoding a frame: {self._broken}"
                )
            # Fast-fail on a dead peer with nothing pending: blocking for
            # the full timeout would be waiting on a corpse.  (Benign
            # race with q.put in _mark_gone: the marker also wakes us.)
            reason = self.peer_gone(source)
            if reason is not None and q.empty():
                raise PeerGone(
                    f"host-plane peer {source} is gone ({reason}); recv "
                    f"on {ns!r} tag {tag} cannot complete until a "
                    "replacement re-handshakes",
                    peer=source,
                )
            if deadline is None:
                timeout = None
            else:
                timeout = max(1e-3, deadline - time.monotonic())
            try:
                item = q.get(timeout=timeout)
            except _q.Empty:
                reason = self.peer_gone(source)
                if reason is not None:
                    raise PeerGone(
                        f"host-plane peer {source} is gone ({reason})",
                        peer=source,
                    ) from None
                raise TimeoutError(
                    f"recv_obj from {source} tag {tag}: nothing arrived "
                    f"in {timeout_ms} ms"
                ) from None
            if item is _POISON:
                # keep other waiters on this route failing fast
                q.put(_POISON)
                raise RuntimeError(
                    f"host-plane socket reader on rank {self.rank} died "
                    f"decoding a frame: {self._broken}"
                )
            if isinstance(item, _PeerGoneMarker):
                reason = self.peer_gone(item.src)
                if reason is None:
                    # Stale marker: the peer re-handshook after the marker
                    # was queued.  Drop it and keep draining.
                    continue
                q.put(item)  # keep other waiters on this route failing fast
                raise PeerGone(
                    f"host-plane peer {item.src} died mid-stream "
                    f"({item.reason})",
                    peer=item.src,
                )
            got_seq, obj = item
            if got_seq != seq:
                raise RuntimeError(
                    f"host-plane stream desync on edge "
                    f"{source}->{self.rank} tag {tag}: expected seq "
                    f"{seq}, got {got_seq} (SPMD send/recv order "
                    "diverged across processes)"
                )
            return obj

    # -- send side ------------------------------------------------------
    def _connect(self, dest: int):
        sock = self._send_socks.get(dest)
        if sock is not None:
            return sock
        c = _client()
        ep = _blocking_get(
            lambda k, ms: _get_str(c, k, ms), f"{_PREFIX}/sockep/{dest}",
            None,
        )
        host, port, token = ep.rsplit(":", 2)
        try:
            sock = self._socket.create_connection((host, int(port)))
            sock.setsockopt(
                self._socket.IPPROTO_TCP, self._socket.TCP_NODELAY, 1
            )
            sock.sendall(bytes.fromhex(token))  # handshake (see class doc)
        except OSError as e:
            # The published endpoint no longer answers: the peer died
            # between publishing and our connect.  A replacement that
            # republishes the endpoint makes a later attempt succeed.
            raise PeerGone(
                f"cannot reach host-plane peer {dest} at {host}:{port} "
                f"({e})",
                peer=dest,
            ) from e
        self._send_socks[dest] = sock
        return sock

    def send(self, ns: str, dest: int, tag: int, seq: int, obj) -> None:
        import json as _json
        import struct

        if _is_typed_array(obj):
            # asarray(order="C"), not ascontiguousarray: the latter
            # silently promotes 0-d arrays to shape (1,).
            a = np.asarray(obj, order="C")
            payload = _byte_view(a)
            hdr = {
                "kind": "nd", "dtype": a.dtype.str, "shape": list(a.shape),
                "nbytes": a.nbytes,
            }
        else:
            payload = memoryview(pickle.dumps(obj))
            hdr = {"kind": "pkl", "nbytes": len(payload)}
        if hdr["nbytes"] > MAX_FRAME_BYTES:
            raise ValueError(
                f"socket-plane payload of {hdr['nbytes']} bytes exceeds "
                f"MAX_FRAME_BYTES ({MAX_FRAME_BYTES}); raise "
                "CHAINERMN_TPU_MAX_FRAME_BYTES identically on every "
                "process to send objects this large"
            )
        hdr.update(ns=ns, src=self.rank, tag=tag, seq=seq)
        hbytes = _json.dumps(hdr).encode()
        with self._send_lock:
            sock = self._connect(dest)
            try:
                sock.sendall(struct.pack("<I", len(hbytes)))
                sock.sendall(hbytes)
                sock.sendall(payload)
            except OSError as e:
                # Broken pipe / reset: the peer died under us.  Drop the
                # cached socket so a retry after the replacement
                # re-handshakes resolves a fresh endpoint.
                self._send_socks.pop(dest, None)
                try:
                    sock.close()
                except Exception:
                    pass
                raise PeerGone(
                    f"send to host-plane peer {dest} failed mid-frame "
                    f"({e}); the frame was NOT delivered",
                    peer=dest,
                ) from e


_socket_plane: "SocketPlane | None" = None


def socket_plane(rank: int) -> "SocketPlane":
    """The process's shared socket data plane (lazily constructed)."""
    global _socket_plane
    if _socket_plane is None:
        _socket_plane = SocketPlane(rank)
    return _socket_plane


class ObjectPlane:
    """Sequenced pickled-object transport for one communicator.

    Each instance keeps per-(operation, edge) sequence counters; because the
    object plane is SPMD-ordered (every process issues the same collective
    calls in the same order, and matched ``send_obj``/``recv_obj`` pairs are
    ordered per edge+tag), both sides of any transfer derive the same key
    without negotiation — the role MPI's (communicator, tag, order)
    matching plays in the reference.

    Counters commit only after the transfer succeeds, so a p2p call that
    raises (e.g. a finite ``timeout_ms`` expiring) can be retried without
    desynchronizing the stream.  A *collective* that fails midway leaves
    the plane's state undefined across processes — as a failed MPI
    collective does — and the job should abort (the except hook's role).
    """

    def __init__(
        self, namespace: str, rank: int, size: int, site: str = "<unknown>",
        members: "list[int] | None" = None,
    ):
        """``rank`` is this process's GLOBAL process index (its wire
        identity: socket endpoints and store keys are global-rank-keyed).
        ``members`` — the ordered GLOBAL ranks participating in this plane
        — makes the plane a subgroup (``split(color, key)``); public
        root/dest/source arguments are then SUBGROUP ranks, translated
        through ``members``.  Default: the full world, identity order.
        Disjoint subgroups may share a namespace safely: every key and
        frame route embeds global ranks, so their key spaces are
        disjoint by construction."""
        self.namespace = namespace
        self.rank = rank
        self.size = size
        self.members = list(members) if members is not None else list(
            range(size)
        )
        if len(self.members) != size:
            raise ValueError(
                f"members {self.members} inconsistent with size {size}"
            )
        if rank not in self.members:
            raise ValueError(
                f"global rank {rank} is not a member of {self.members}"
            )
        self.sub_rank = self.members.index(rank)
        self.site = site
        self._seq: dict[Any, int] = {}
        self._validated = size == 1
        # Publish this plane's construction-site fingerprint NOW (one
        # non-blocking put): first use on any rank validates against rank
        # 0's, turning a breached SPMD-construction-order contract into a
        # fast diagnostic instead of a silent stream mixup or hang.
        # Publication at construction (not first use) matters because rank
        # 0 may never use a plane's host ops at all.
        if not self._validated and available():
            try:
                client().set(
                    f"{_PREFIX}/planecheck/{namespace}/{rank}", site
                )
            except Exception:
                pass  # duplicate keys on re-init: validation degrades soft

    def _ensure_validated(self) -> None:
        """First-use check of the SPMD construction-order contract: this
        plane's construction site must match rank 0's for the same
        namespace ordinal."""
        if self._validated:
            return
        self._validated = True
        timeout_ms = int(
            _os.environ.get("CHAINERMN_TPU_PLANE_CHECK_TIMEOUT_MS", "60000")
        )
        key = f"{_PREFIX}/planecheck/{self.namespace}/{self.members[0]}"
        c = _client()
        try:
            root_site = _blocking_get(
                lambda k, ms: _get_str(c, k, ms), key,
                time.monotonic() + timeout_ms / 1e3,
            )
        except Exception:
            raise RuntimeError(
                f"host-plane {self.namespace} (constructed at {self.site} "
                f"on rank {self.rank}): rank 0 never constructed a plane "
                f"with this ordinal within {timeout_ms} ms — communicator "
                "construction order diverged across processes "
                "(rank-conditional create_communicator?)"
            ) from None
        # The TRUE contract is ordinal matching — rank 0 constructed a
        # plane with this namespace ordinal at all (checked fatally
        # above).  Site equality is only a heuristic fingerprint:
        # heterogeneous checkout paths or a legal rank-conditional
        # wrapper calling create_communicator satisfy the ordinal
        # contract with different filename:lineno, so a mismatch warns
        # rather than aborts.  Basenames are compared to
        # tolerate differing install prefixes across hosts.
        def _basename_site(s: str) -> str:
            path, _, line = s.rpartition(":")
            return f"{_os.path.basename(path)}:{line}" if path else s

        if (
            _basename_site(root_site) != _basename_site(self.site)
            and "<unknown>" not in (root_site, self.site)
        ):
            import warnings

            warnings.warn(
                f"host-plane {self.namespace} construction-site mismatch: "
                f"rank {self.rank} built it at {self.site}, rank 0 at "
                f"{root_site}.  If communicator construction ORDER also "
                "diverged across processes, payloads will be delivered "
                "to the wrong streams.",
                RuntimeWarning,
                stacklevel=3,
            )

    def _peek(self, slot) -> int:
        return self._seq.get(slot, 0)

    def _commit(self, slot) -> None:
        self._seq[slot] = self._seq.get(slot, 0) + 1

    def _key(self, *parts) -> str:
        return "/".join([_PREFIX, self.namespace, *map(str, parts)])

    # -- point-to-point ------------------------------------------------
    # p2p rides the direct-socket data plane by default (the store is a
    # control plane; see SocketPlane).  Set CHAINERMN_TPU_SOCKET_P2P=0 —
    # identically on EVERY process — to force the store's chunk path
    # (e.g. if direct TCP between hosts is firewalled); the two sides of
    # an edge must use the same plane.
    _use_sockets = _os.environ.get("CHAINERMN_TPU_SOCKET_P2P", "1") != "0"

    def send(self, obj, dest: int, tag: int = 0) -> None:
        self._ensure_validated()
        gdest = self.members[dest]
        slot = ("p2p", self.rank, gdest, tag)
        if self._use_sockets:
            socket_plane(self.rank).send(
                self.namespace, gdest, tag, self._peek(slot), obj
            )
        else:
            put_payload(
                self._key("p2p", self.rank, gdest, tag, self._peek(slot)),
                obj,
            )
        self._commit(slot)

    def recv(
        self, source: int, tag: int = 0, *, timeout_ms: int | None = None
    ):
        self._ensure_validated()
        gsrc = self.members[source]
        slot = ("p2p", gsrc, self.rank, tag)
        if self._use_sockets:
            obj = socket_plane(self.rank).recv(
                self.namespace, gsrc, tag, self._peek(slot),
                timeout_ms=timeout_ms,
            )
        else:
            key = self._key(
                "p2p", gsrc, self.rank, tag, self._peek(slot)
            )
            obj, n = get_payload(key, timeout_ms=timeout_ms)
            delete(key, n)  # sole reader
        self._commit(slot)
        return obj

    # -- collectives ---------------------------------------------------
    def bcast(self, obj, root: int):
        self._ensure_validated()
        groot = self.members[root]
        slot = ("bcast", groot)
        key = self._key("bcast", groot, self._peek(slot))
        if self.rank == groot:
            put_payload(key, obj)
            self._commit(slot)
            return obj
        obj, n = get_payload(key)
        ack_and_collect(key, n, self.size - 1)
        self._commit(slot)
        return obj

    def allgather(self, obj, *, timeout_ms: int | None = None) -> list:
        """``timeout_ms`` bounds the wait on EACH member's payload so a
        dead peer surfaces as ``TimeoutError`` instead of a hang (the
        elastic supervisor's bounded-teardown contract rides this: a
        timed-out collective leaves the slot uncommitted, so the caller
        must treat it as fatal and die loudly, not retry)."""
        self._ensure_validated()
        slot = ("gather",)
        base = self._key("gather", self._peek(slot))
        put_payload(f"{base}/{self.rank}", obj)
        out = []
        for g in self.members:
            if g == self.rank:
                out.append(obj)
                continue
            got, n = get_payload(f"{base}/{g}", timeout_ms=timeout_ms)
            out.append(got)
            ack_and_collect(f"{base}/{g}", n, self.size - 1)
        self._commit(slot)
        return out

    def gather(self, obj, root: int, *,
               timeout_ms: int | None = None) -> "list | None":
        """Point-to-root gather (the reference ``MPI_Gather`` wire
        profile): every non-root sends its payload ONLY to root — O(n *
        payload) total wire, and non-root processes fetch NOTHING — where
        :meth:`allgather` costs O(n^2) total.  Returns the subgroup-
        ordered list at root, None elsewhere.  p2p-shaped, so payloads
        ride the socket data plane in a dedicated route namespace.
        ``timeout_ms`` bounds root's wait per member (``recv_obj``'s
        contract) so a dead sender surfaces as ``TimeoutError``, not a
        hang."""
        self._ensure_validated()
        groot = self.members[root]
        slot = ("pgather", groot)
        seq = self._peek(slot)
        ns = f"{self.namespace}#gather{groot}"
        if self.rank == groot:
            out = []
            for g in self.members:
                if g == groot:
                    out.append(obj)
                elif self._use_sockets:
                    out.append(socket_plane(self.rank).recv(
                        ns, g, 0, seq, timeout_ms=timeout_ms))
                else:
                    key = self._key("pgather", groot, g, seq)
                    got, n = get_payload(key, timeout_ms=timeout_ms)
                    delete(key, n)  # sole reader
                    out.append(got)
            self._commit(slot)
            return out
        if self._use_sockets:
            socket_plane(self.rank).send(ns, groot, 0, seq, obj)
        else:
            put_payload(self._key("pgather", groot, self.rank, seq), obj)
        self._commit(slot)
        return None

    def scatter(self, objs, root: int):
        """Point-to-point scatter: root sends each rank exactly its element
        (the reference's ``scatter_obj``), not a broadcast of the whole list
        — O(total) root-side wire, O(own) per receiver.  The per-rank
        payloads are p2p-shaped, so they ride the socket data plane (this
        is the multi-MB ``scatter_dataset`` path the chunking exists for),
        in a dedicated ``#scatter`` route namespace so user p2p traffic on
        any tag can never interleave with internal collective matching
        (the role of MPI's per-context internal tags); store keys are the
        socket-less fallback."""
        self._ensure_validated()
        groot = self.members[root]
        slot = ("scatter", groot)
        seq = self._peek(slot)
        ns = f"{self.namespace}#scatter{groot}"
        if self.rank == groot:
            if objs is None or len(objs) != self.size:
                raise ValueError(
                    f"scatter_obj needs a length-{self.size} list at root"
                )
            for i, g in enumerate(self.members):
                if g == groot:
                    continue
                if self._use_sockets:
                    socket_plane(self.rank).send(ns, g, 0, seq, objs[i])
                else:
                    put_payload(
                        self._key("scatter", groot, g, seq), objs[i]
                    )
            self._commit(slot)
            return objs[self.sub_rank]
        if self._use_sockets:
            obj = socket_plane(self.rank).recv(ns, groot, 0, seq)
        else:
            key = self._key("scatter", groot, self.rank, seq)
            obj, n = get_payload(key)
            delete(key, n)  # sole reader
        self._commit(slot)
        return obj
