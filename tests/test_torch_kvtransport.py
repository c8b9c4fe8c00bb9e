"""The port's host-plane transport (``communicators.kvtransport``) against
the reference's, on the CPU, in one process.

The 15 cases of ``tests/test_kvtransport.py`` run over two stores: a
dict-backed fake with a ``torch.distributed.Store``'s methods (``set``,
``get``, ``wait``, ``add``, ``delete_key``; a bounded ``wait`` raises
``DistStoreError``) and a real ``TCPStore`` master in this process.  The
store only rendezvouses the socket plane; the data rides real loopback
TCP sockets.  The typed payload header and chunks of each dtype equal the
reference's on the same arrays, and a KV snapshot of bf16, fp32 and int8
pages crosses a ``SocketPlane`` pair bitwise (the reference's
``test_snapshot_socket_roundtrip``).
"""

import datetime
import os
import socket as _socket
import struct
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from chainermn_tpu.communicators import kvtransport as jkv
from chainermn_tpu_torch import convert
from chainermn_tpu_torch.communicators import kvtransport as kv

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_kvtransport import FakeKvClient  # noqa: E402


class FakeStore:
    """A dict-backed stand-in with the methods of a
    ``torch.distributed.Store``."""

    def __init__(self):
        self.d = {}
        self.cv = threading.Condition()

    def set(self, k, v):
        with self.cv:
            self.d[k] = v.encode() if isinstance(v, str) else bytes(v)
            self.cv.notify_all()

    def get(self, k):
        with self.cv:
            return self.d[k]

    def wait(self, keys, timeout):
        deadline = time.monotonic() + timeout.total_seconds()
        with self.cv:
            while not all(k in self.d for k in keys):
                left = deadline - time.monotonic()
                if left <= 0 or not self.cv.wait(timeout=left):
                    raise dist.DistStoreError(
                        f"wait timeout after {timeout}, keys: {keys}")

    def add(self, k, n):
        with self.cv:
            v = int(self.d.get(k, b"0")) + n
            self.d[k] = str(v).encode()
            return v

    def delete_key(self, k):
        with self.cv:
            return self.d.pop(k, None) is not None


@pytest.fixture(params=["fake", "tcp"])
def store(request):
    if request.param == "fake":
        s = FakeStore()
    else:
        s = dist.TCPStore("127.0.0.1", 0, None, True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=30))
    kv.install(s)
    yield s
    kv.uninstall()


@pytest.fixture
def sock_pair(store):
    pair = kv.SocketPlane(0), kv.SocketPlane(1)
    yield pair
    for p in pair:
        p._srv.close()


def _endpoint(rank):
    raw = kv.client().get(f"{kv._PREFIX}/sockep/{rank}")
    return raw.decode().rsplit(":", 2)


def test_socket_plane_typed_roundtrip(sock_pair):
    """Multi-frame float64, 0-d scalar, non-contiguous view, empty array
    and a pickled dict arrive in order with exact dtype/shape/values."""
    p0, p1 = sock_pair
    typed = np.random.RandomState(11).randn(100_001)
    msgs = [
        typed,
        np.array(2.5, np.float32),
        typed[:99].reshape(33, 3)[:, 1],
        np.empty((0, 4), np.int16),
        {"obj": 1, "nested": [1, 2]},
    ]
    for seq, m in enumerate(msgs):
        p0.send("c", 1, 9, seq, m)
    for seq, m in enumerate(msgs):
        got = p1.recv("c", 0, 9, seq, timeout_ms=20000)
        if isinstance(m, np.ndarray):
            assert isinstance(got, np.ndarray)
            assert got.shape == m.shape and got.dtype == m.dtype
            np.testing.assert_array_equal(got, m)
        else:
            assert got == m


def test_socket_plane_routes_by_namespace_and_tag(sock_pair):
    p0, p1 = sock_pair
    p0.send("commA", 1, 0, 0, "a0")
    p0.send("commB", 1, 0, 0, "b0")
    p0.send("commA", 1, 5, 0, "a-tag5")
    p0.send("commA", 1, 0, 1, "a1")
    assert p1.recv("commA", 0, 5, 0, timeout_ms=20000) == "a-tag5"
    assert p1.recv("commB", 0, 0, 0, timeout_ms=20000) == "b0"
    assert p1.recv("commA", 0, 0, 0, timeout_ms=20000) == "a0"
    assert p1.recv("commA", 0, 0, 1, timeout_ms=20000) == "a1"


def test_socket_plane_timeout_is_retryable(sock_pair):
    p0, p1 = sock_pair
    with pytest.raises(TimeoutError):
        p1.recv("c", 0, 3, 0, timeout_ms=100)
    p0.send("c", 1, 3, 0, np.arange(5))
    np.testing.assert_array_equal(
        p1.recv("c", 0, 3, 0, timeout_ms=20000), np.arange(5))


def test_socket_plane_detects_seq_desync(sock_pair):
    p0, p1 = sock_pair
    p0.send("c", 1, 4, 0, "first")
    with pytest.raises(RuntimeError, match="desync"):
        p1.recv("c", 0, 4, 7, timeout_ms=20000)


def test_payload_header_roundtrip_dtypes(store):
    """put_payload/get_payload over the store: typed arrays of assorted
    dtypes, a two-chunk array and the pickle fallback."""
    cases = [
        np.arange(10, dtype=np.int64),
        np.zeros((3, 0, 2), np.float16),
        np.array(b"x"),
        np.random.RandomState(0).randn(kv.CHUNK_BYTES // 8 + 7),
        ["not", "an", "array"],
    ]
    for i, c in enumerate(cases):
        kv.put_payload(f"k{i}", c)
        got, n = kv.get_payload(f"k{i}", timeout_ms=5000)
        if isinstance(c, np.ndarray):
            assert got.shape == c.shape and got.dtype == c.dtype
            np.testing.assert_array_equal(got, c)
        else:
            assert got == c
        kv.delete(f"k{i}", n)
    assert n == 1 and kv.client().delete_key("k3/hdr") is False


def test_socket_plane_rejects_unauthenticated_connection(sock_pair):
    import pickle

    p0, p1 = sock_pair
    host, port, _token = _endpoint(1)
    evil = _socket.create_connection((host, int(port)))
    payload = pickle.dumps("evil")
    hdr = (b'{"kind": "pkl", "nbytes": %d, "ns": "c", "src": 0, "tag": 0, '
           b'"seq": 0}' % len(payload))
    try:
        evil.sendall(b"\x00" * kv.TOKEN_BYTES)
        evil.sendall(struct.pack("<I", len(hdr)) + hdr + payload)
    except OSError:
        pass
    with pytest.raises(TimeoutError):
        p1.recv("c", 0, 0, 0, timeout_ms=300)
    p0.send("c", 1, 0, 0, "legit")
    assert p1.recv("c", 0, 0, 0, timeout_ms=20000) == "legit"
    evil.close()


def test_malformed_frame_poisons_recv_not_hangs(sock_pair):
    p0, p1 = sock_pair
    p0.send("c", 1, 1, 0, "parked")
    assert p1.recv("c", 0, 1, 0, timeout_ms=20000) == "parked"
    conn = _socket.create_connection(p1._srv.getsockname())
    conn.sendall(p1._token)
    hdr = (b'{"kind": "nd", "dtype": "<f4", "shape": [4], '
           b'"nbytes": 999999999999, "ns": "c", "src": 0, "tag": 2, '
           b'"seq": 0}')
    conn.sendall(struct.pack("<I", len(hdr)) + hdr)
    deadline = time.monotonic() + 10
    while p1._broken is None and time.monotonic() < deadline:
        time.sleep(0.02)
    assert p1._broken is not None and "nbytes" in p1._broken
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="died decoding"):
        p1.recv("c", 0, 1, 1, timeout_ms=60_000)
    assert time.monotonic() - t0 < 5
    with pytest.raises(RuntimeError, match="died decoding"):
        p1.recv("c", 0, 99, 0, timeout_ms=60_000)
    conn.close()


def test_oversized_send_raises_on_sender(sock_pair, monkeypatch):
    p0, _p1 = sock_pair
    monkeypatch.setattr(kv, "MAX_FRAME_BYTES", 1024)
    with pytest.raises(ValueError, match="CHAINERMN_TPU_MAX_FRAME_BYTES"):
        p0.send("c", 1, 0, 0, np.zeros(4096, np.float64))


def test_object_plane_gather_root_timeout(store, monkeypatch):
    """Point-to-root gather over the store path (sockets off) honours
    ``timeout_ms`` at root: a member that never sends raises
    TimeoutError (the store's DistStoreError translated), not a hang."""
    monkeypatch.setattr(kv.ObjectPlane, "_use_sockets", False)
    root = kv.ObjectPlane("gt", rank=0, size=2, site="t:1")
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        root.gather("root-obj", 0, timeout_ms=300)
    assert time.monotonic() - t0 < 10.0


def test_peer_death_raises_peer_gone_fast(sock_pair):
    p0, p1 = sock_pair
    p0.send("c", 1, 0, 0, "hello")
    assert p1.recv("c", 0, 0, 0, timeout_ms=20_000) == "hello"
    p0._send_socks[1].close()
    t0 = time.monotonic()
    with pytest.raises(kv.PeerGone) as e:
        p1.recv("c", 0, 0, 1, timeout_ms=60_000)
    assert time.monotonic() - t0 < 10
    assert e.value.peer == 0
    assert p1.peer_gone(0) is not None


def test_peer_death_delivers_queued_messages_first(sock_pair):
    p0, p1 = sock_pair
    p0.send("c", 1, 3, 0, "one")
    p0.send("c", 1, 3, 1, "two")
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if p1._queue(("c", 0, 3)).qsize() >= 2:
            break
        time.sleep(0.01)
    p0._send_socks[1].close()
    assert p1.recv("c", 0, 3, 0, timeout_ms=20_000) == "one"
    assert p1.recv("c", 0, 3, 1, timeout_ms=20_000) == "two"
    with pytest.raises(kv.PeerGone):
        p1.recv("c", 0, 3, 2, timeout_ms=60_000)


def test_partial_frame_death_is_peer_gone(sock_pair):
    p0, p1 = sock_pair
    p0.send("c", 1, 4, 0, "intact")
    assert p1.recv("c", 0, 4, 0, timeout_ms=20_000) == "intact"
    sock = p0._send_socks[1]
    hdr = (b'{"kind": "pkl", "nbytes": 64, "ns": "c", "src": 0, '
           b'"tag": 4, "seq": 1}')
    sock.sendall(struct.pack("<I", len(hdr)) + hdr + b"\x00" * 10)
    sock.close()
    with pytest.raises(kv.PeerGone):
        p1.recv("c", 0, 4, 1, timeout_ms=60_000)
    assert p1._broken is None


def test_replacement_peer_rehandshakes_after_death(sock_pair):
    """A replacement at the same rank republishes its endpoint
    (delete-then-set on the store) and resumes the stream."""
    p0, p1 = sock_pair
    p0.send("c", 1, 5, 0, "before")
    assert p1.recv("c", 0, 5, 0, timeout_ms=20_000) == "before"
    p0._send_socks[1].close()
    with pytest.raises(kv.PeerGone):
        p1.recv("c", 0, 5, 1, timeout_ms=60_000)
    p0b = kv.SocketPlane(0)
    try:
        p0b.send("c", 1, 5, 1, "after")
        got = kv.retry_backoff(
            lambda: p1.recv("c", 0, 5, 1, timeout_ms=20_000),
            retries=6, base_s=0.05)
        assert got == "after"
        assert p1.peer_gone(0) is None
        p1.send("c", 0, 6, 0, "to-replacement")
        assert p0b.recv("c", 1, 6, 0, timeout_ms=20_000) == \
            "to-replacement"
    finally:
        p0b._srv.close()


def test_send_to_dead_peer_raises_peer_gone(sock_pair):
    """Connecting to a dead endpoint (port 1: privileged, never
    listening) is PeerGone, not a raw OSError."""
    p0, _p1 = sock_pair
    host, _port, token = _endpoint(1)
    kv.client().set(f"{kv._PREFIX}/sockep/1", f"{host}:1:{token}")
    p0._send_socks.pop(1, None)
    with pytest.raises(kv.PeerGone):
        p0.send("c", 1, 0, 0, "anyone home?")


def test_retry_backoff_retries_then_succeeds():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise kv.PeerGone("not yet", peer=7)
        return "ok"

    assert kv.retry_backoff(flaky, retries=4, base_s=0.001) == "ok"
    assert len(calls) == 3
    with pytest.raises(kv.PeerGone):
        kv.retry_backoff(
            lambda: (_ for _ in ()).throw(kv.PeerGone("always")),
            retries=2, base_s=0.001)


# ---------------------------------------------------------------------------
# Wire format against the reference; the KV snapshot over sockets
# ---------------------------------------------------------------------------


class _RefFullFake(FakeKvClient):
    def key_value_set_bytes(self, k, v):
        self.key_value_set(k, bytes(v))

    def blocking_key_value_get_bytes(self, k, timeout_ms):
        return self.blocking_key_value_get(k, timeout_ms)


@pytest.mark.parametrize("case", [
    np.arange(10, dtype=np.int64), np.zeros((3, 0, 2), np.float16),
    np.array(b"x"), np.array(["ab", "c"]), np.array(2.5, np.float32),
    np.ones((4, 3), np.bool_), np.arange(6, dtype=np.uint16).reshape(2, 3),
    np.arange(5, dtype=np.int8), np.linspace(0, 1, 7).astype(np.complex64),
    np.random.RandomState(1).randn(kv.CHUNK_BYTES // 8 + 7),
    {"pickled": [1, 2]},
], ids=["int64", "f16-empty", "bytes", "unicode", "f32-0d", "bool",
        "uint16", "int8", "complex64", "two-chunks", "pickle"])
def test_payload_header_and_chunks_equal_reference(case, monkeypatch):
    """The same array published by both packages: the header string and
    every chunk's bytes are the reference's (pickles compare by value)."""
    ref = _RefFullFake()
    monkeypatch.setattr(jkv, "client", lambda: ref)
    jkv.put_payload("k", case)
    mine = FakeStore()
    kv.install(mine)
    try:
        kv.put_payload("k", case)
    finally:
        kv.uninstall()
    assert mine.d["k/hdr"].decode() == ref.d["k/hdr"]
    n = int(ref.d["k/hdr"].split(",")[0])
    for i in range(n):
        if isinstance(case, np.ndarray):
            assert mine.d[f"k/c{i}"] == ref.d[f"k/c{i}"]
    if not isinstance(case, np.ndarray):
        import pickle

        assert pickle.loads(mine.d["k/c0"]) == pickle.loads(ref.d["k/c0"])


class _MiniPlane:
    """ObjectPlane-shaped shim over a raw SocketPlane."""

    def __init__(self, sp, rank):
        self.sp, self.rank, self.members = sp, rank, [0, 1]
        self._seq = {}

    def send(self, obj, dest, tag=0):
        k = ("s", dest, tag)
        self.sp.send("mig", dest, tag, self._seq.get(k, 0), obj)
        self._seq[k] = self._seq.get(k, 0) + 1

    def recv(self, src, tag=0, timeout_ms=None):
        k = ("r", src, tag)
        out = self.sp.recv("mig", src, tag, self._seq.get(k, 0),
                           timeout_ms=timeout_ms)
        self._seq[k] = self._seq.get(k, 0) + 1
        return out


@pytest.mark.parametrize("dtype,kvd", [(torch.float32, None),
                                       (torch.bfloat16, None),
                                       (torch.float32, "int8")],
                         ids=["fp32", "bf16", "int8"])
def test_snapshot_socket_roundtrip(sock_pair, dtype, kvd):
    """A running sequence's pages (bf16 as uint16 bits, fp32, int8 with
    its scales) extracted from an engine on the reference's converted
    weights cross a loopback SocketPlane pair as typed frames and restore
    into a second engine bitwise, its context intact."""
    import jax.numpy as jnp

    from chainermn_tpu.models.transformer import TransformerLM as JaxLM
    from chainermn_tpu_torch.models.transformer import TransformerLM
    from chainermn_tpu_torch.serving import EngineConfig, InferenceEngine
    from chainermn_tpu_torch.serving.cluster import (
        extract_sequence, recv_snapshot, restore_sequence, send_snapshot)

    cfg = dict(vocab=32, d_model=16, n_heads=2, d_ff=32, n_layers=2,
               max_len=64)
    params = JaxLM(**cfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    lm = TransformerLM(**cfg, dtype=dtype, device="cpu")
    lm.load_state_dict(convert.flax_to_state_dict(jax.device_get(params)))
    ecfg = dict(block_size=4, n_blocks=64, max_len=64, max_batch=2,
                kv_dtype=kvd)
    src = InferenceEngine(lm, EngineConfig(**ecfg), device="cpu")
    dst = InferenceEngine(lm, EngineConfig(**ecfg), device="cpu")
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5]
    src.kv.allocate("s", len(prompt))
    tok = int(np.argmax(src.prefill(prompt, "s")))
    snap = extract_sequence(src, "s", context=prompt, prompt_len=len(prompt))
    p0, p1 = sock_pair
    got = []
    t = threading.Thread(target=lambda: got.append(
        recv_snapshot(_MiniPlane(p1, 1), 0, timeout_ms=20_000)))
    t.start()
    send_snapshot(_MiniPlane(p0, 0), 1, snap)
    t.join(timeout=30)
    (back,) = got
    assert back.context == prompt and back.dtypes == snap.dtypes
    assert back.seq_len == snap.seq_len
    for a, b in zip(snap.pages, back.pages):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    restore_sequence(dst, back, "t")
    again = extract_sequence(dst, "t")
    for a, b in zip(snap.pages, again.pages):
        assert a.tobytes() == b.tobytes()
    L = len(prompt)
    src.kv.extend("s", L + 1)
    dst.kv.extend("t", L + 1)
    np.testing.assert_array_equal(src.decode([tok], ["s"], [L]),
                                  dst.decode([tok], ["t"], [L]))
    dst.kv.assert_consistent()
