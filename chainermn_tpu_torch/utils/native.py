"""ctypes binding for the port's host-buffer library
(``chainermn_tpu_torch/csrc/hostbuf.cpp``) — the port of
``chainermn_tpu/utils/native.py``.

The library is built with ``g++`` at first use into ``build/native/`` of
the checkout (keyed by a hash of the source, written under a temporary
name and renamed, so concurrent ranks never load a half-written file).
Every entry point has a numpy or pure-Python fallback that gives the same
bytes, so a machine without a toolchain still runs; :func:`native_impl`
says which one is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "hostbuf.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_loaded_from: Optional[str] = None   # "csrc" | None


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"libhostbuf-{digest}.so")


def _build(out: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp, _SRC, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except Exception:  # noqa: BLE001 — no toolchain: the fallbacks serve
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def native_impl() -> Optional[str]:
    """Which library is active: ``"csrc"`` (the g++ build of
    ``csrc/hostbuf.cpp``) or ``None`` (the Python fallbacks)."""
    get_lib()
    return _loaded_from


def get_lib() -> Optional[ctypes.CDLL]:
    """Load the library, building it first when this source has no
    build; ``None`` when that fails (callers use the fallbacks)."""
    global _lib, _load_failed, _loaded_from
    with _lib_lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            path = _lib_path()
            if not os.path.exists(path) and not _build(path):
                _load_failed = True
                return None
            _lib = _bind_symbols(ctypes.CDLL(path))
            _loaded_from = "csrc"
        except (OSError, AttributeError):
            _load_failed = True
        return _lib


def _bind_symbols(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.hostbuf_crc32c.restype = ctypes.c_uint32
    lib.hostbuf_crc32c.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32,
    ]
    lib.hostbuf_crc32c_impl.restype = ctypes.c_int
    for name in ("hostbuf_gatherv", "hostbuf_scatterv"):
        fn = getattr(lib, name)
        fn.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64, ctypes.c_int,
        ]
    lib.hostbuf_queue_new.restype = ctypes.c_void_p
    lib.hostbuf_queue_new.argtypes = [ctypes.c_uint64]
    lib.hostbuf_queue_push.restype = ctypes.c_int
    lib.hostbuf_queue_push.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
    ]
    lib.hostbuf_queue_pop.restype = ctypes.c_uint64
    lib.hostbuf_queue_pop.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.hostbuf_queue_size.restype = ctypes.c_uint64
    lib.hostbuf_queue_size.argtypes = [ctypes.c_void_p]
    lib.hostbuf_queue_close.argtypes = [ctypes.c_void_p]
    lib.hostbuf_queue_free.argtypes = [ctypes.c_void_p]
    return lib


_CRC32C_TABLES: Optional[list] = None


def _crc32c_tables() -> list:
    """Slicing-by-8 table set for the pure-Python CRC32C fallback."""
    global _CRC32C_TABLES
    if _CRC32C_TABLES is None:
        poly = 0x82F63B78
        t0 = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            t0.append(crc)
        tables = [t0]
        for k in range(1, 8):
            prev = tables[k - 1]
            tables.append([(prev[i] >> 8) ^ t0[prev[i] & 0xFF] for i in range(256)])
        _CRC32C_TABLES = tables
    return _CRC32C_TABLES


def _crc32c_py(data, seed: int) -> int:
    """Pure-Python CRC32C (Castagnoli), bit-identical to the native one —
    the checksum is load-bearing (parameter digests, cross-rank collective
    fingerprints), so the fallback must match the native
    polynomial exactly, not substitute zlib's.  Slicing-by-8 keeps the
    no-toolchain path within shouting distance of usable."""
    t = _crc32c_tables()
    t0, t1, t2, t3, t4, t5, t6, t7 = t
    mv = memoryview(data).cast("B")
    crc = ~seed & 0xFFFFFFFF
    n = len(mv)
    i = 0
    for i in range(0, n - 7, 8):
        crc ^= mv[i] | (mv[i + 1] << 8) | (mv[i + 2] << 16) | (mv[i + 3] << 24)
        crc = (
            t7[crc & 0xFF] ^ t6[(crc >> 8) & 0xFF]
            ^ t5[(crc >> 16) & 0xFF] ^ t4[(crc >> 24) & 0xFF]
            ^ t3[mv[i + 4]] ^ t2[mv[i + 5]] ^ t1[mv[i + 6]] ^ t0[mv[i + 7]]
        )
    for j in range(n - (n % 8), n):
        crc = (crc >> 8) ^ t0[(crc ^ mv[j]) & 0xFF]
    return ~crc & 0xFFFFFFFF


_accel_crc = None


def _accel_crc32c():
    """An accelerated installed crc32c, if any — the middle tier of the
    fallback chain (native lib → installed module → pure Python), because
    the pure-Python tail runs at ~MB/s.  Both candidate modules implement
    Castagnoli with the same ~x ~seed convention as ours, but only for
    seed=0-style chaining of our API; they are used only for seed == 0."""
    global _accel_crc
    if _accel_crc is None:
        _accel_crc = False
        for mod in ("google_crc32c", "crc32c"):
            try:
                m = __import__(mod)
                fn = m.value if hasattr(m, "value") else m.crc32c
                if fn(b"123456789") == 0xE3069283:  # known vector check
                    _accel_crc = fn
                    break
            except Exception:
                continue
    return _accel_crc or None


def crc32c_impl() -> str:
    """Which implementation :func:`crc32c` dispatches to — 'hw' (native
    SSE4.2 instruction), 'sw' (native slicing-by-8), 'module' (installed
    accelerated package), or 'python' (pure-Python slicing-by-8)."""
    lib = get_lib()
    if lib is not None:
        return "hw" if lib.hostbuf_crc32c_impl() else "sw"
    if _accel_crc32c() is not None:
        return "module"
    return "python"


def crc32c(data, seed: int = 0) -> int:
    """CRC32C checksum over ``bytes`` or a C-contiguous ``np.ndarray``
    (arrays are checksummed in place via their buffer pointer — no copy).
    Native implementation (hardware SSE4.2 when the CPU supports it,
    slicing-by-8 otherwise) with an installed-module middle tier and a
    bit-identical pure-Python tail for toolchain-less hosts."""
    lib = get_lib()
    if isinstance(data, np.ndarray):
        if not data.flags["C_CONTIGUOUS"]:
            data = np.ascontiguousarray(data)
        if lib is None:
            return _crc32c_fallback(_byte_view(data), seed)
        return int(
            lib.hostbuf_crc32c(
                data.ctypes.data_as(ctypes.c_char_p), data.nbytes, seed
            )
        )
    if lib is None:
        return _crc32c_fallback(data, seed)
    return int(lib.hostbuf_crc32c(data, len(data), seed))


def _leaves(tree) -> list:
    """Array leaves in the reference's ``jax.tree.leaves`` order: mapping
    keys sorted, sequences in order, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _leaf_bytes(leaf) -> np.ndarray:
    """A leaf's raw bytes as a flat uint8 array (tensors of any dtype,
    bf16 included, through their storage; anything else through numpy)."""
    if hasattr(leaf, "detach") and hasattr(leaf, "view"):
        t = leaf.detach().to("cpu").contiguous().reshape(-1)
        import torch

        return t.view(torch.uint8).numpy()
    return _byte_view(np.ascontiguousarray(np.asarray(leaf)))


def tree_digest(tree) -> int:
    """crc32c of every array leaf of ``tree`` (tensors, numpy arrays,
    scalars in dicts, lists and tuples), folded in the reference's leaf
    order.  Bit-identical parameters give equal digests, and a tree of
    numpy arrays gives the reference's ``tree_digest``."""
    digest = 0
    for leaf in _leaves(tree):
        digest = crc32c(_leaf_bytes(leaf), seed=digest)
    return digest


def _crc32c_fallback(data, seed: int) -> int:
    if seed == 0:
        accel = _accel_crc32c()
        if accel is not None:
            return int(accel(bytes(data)))
    return _crc32c_py(data, seed)


def _byte_view(a: np.ndarray) -> np.ndarray:
    """Flat uint8 view of a C-contiguous array's buffer.  reshape(-1)
    BEFORE the dtype view: ``view(np.uint8)`` is illegal on 0-d arrays."""
    return a.reshape(-1).view(np.uint8)


def _default_threads(n_threads: int) -> int:
    if n_threads <= 0:
        return min(8, os.cpu_count() or 1)
    return n_threads


def _as_u64_array(vals) -> "ctypes.Array":
    return (ctypes.c_uint64 * len(vals))(*vals)


def _ptr_array(arrays: Sequence[np.ndarray]) -> "ctypes.Array":
    return (ctypes.c_void_p * len(arrays))(
        *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays]
    )


def pack_buffers(
    arrays: Sequence[np.ndarray],
    out: Optional[np.ndarray] = None,
    n_threads: int = 0,
) -> np.ndarray:
    """Concatenate the raw bytes of C-contiguous arrays (any shapes/dtypes)
    into one uint8 buffer with a native multithreaded memcpy — pack_params
    for the host side."""
    # np.asarray(..., order="C") rather than ascontiguousarray: the latter
    # silently promotes 0-d arrays to shape (1,).
    arrays = [np.asarray(a, order="C") for a in arrays]
    sizes = [a.nbytes for a in arrays]
    total = sum(sizes)
    if out is None:
        out = np.empty(total, np.uint8)
    elif out.nbytes < total:
        raise ValueError(f"pack_buffers out ({out.nbytes}) < total ({total})")
    lib = get_lib()
    offsets = np.cumsum([0] + sizes[:-1]).tolist()
    if lib is None:
        view = _byte_view(out)
        for a, off, sz in zip(arrays, offsets, sizes):
            view[off : off + sz] = _byte_view(a)
        return out
    lib.hostbuf_gatherv(
        out.ctypes.data_as(ctypes.c_void_p), _ptr_array(arrays),
        _as_u64_array(sizes), _as_u64_array(offsets),
        len(arrays), _default_threads(n_threads),
    )
    return out


def unpack_buffers(
    buf: np.ndarray, arrays: Sequence[np.ndarray], n_threads: int = 0
) -> None:
    """Scatter a contiguous uint8 buffer back into preallocated
    C-contiguous arrays (unpack_params), the inverse of
    :func:`pack_buffers`."""
    sizes = [a.nbytes for a in arrays]
    total = sum(sizes)
    if buf.nbytes < total:
        raise ValueError(f"unpack_buffers buf ({buf.nbytes}) < total ({total})")
    for a in arrays:
        if not a.flags["C_CONTIGUOUS"]:
            raise ValueError("unpack_buffers targets must be C-contiguous")
    offsets = np.cumsum([0] + sizes[:-1]).tolist()
    lib = get_lib()
    if lib is None:
        view = _byte_view(buf)
        for a, off, sz in zip(arrays, offsets, sizes):
            _byte_view(a)[:] = view[off : off + sz]
        return
    lib.hostbuf_scatterv(
        buf.ctypes.data_as(ctypes.c_void_p), _ptr_array(arrays),
        _as_u64_array(sizes), _as_u64_array(offsets),
        len(arrays), _default_threads(n_threads),
    )


def parallel_gather(items: Sequence[np.ndarray], n_threads: int = 0) -> np.ndarray:
    """Stack equal-shaped C-contiguous arrays into one batch array with a
    native multithreaded memcpy (``np.stack`` copies under the GIL) — the
    reference's batch-assembly path.  The port's ``datasets.toy`` still
    stacks with numpy."""
    first = np.asarray(items[0], order="C")
    if any(
        np.shape(a) != first.shape or np.asarray(a).dtype != first.dtype
        for a in items[1:]
    ):
        raise ValueError("parallel_gather needs equal-shaped same-dtype items")
    out = np.empty((len(items),) + first.shape, first.dtype)
    pack_buffers(items, out=out.reshape(-1).view(np.uint8),
                 n_threads=n_threads)
    return out


class NativeQueue:
    """Bounded byte-buffer queue backed by the C++ ring queue
    (``queue.Queue`` fallback) — a host-side staging structure for
    byte-level pipelines (raw record readers, serialized payload chunks).
    ``iterators.create_prefetch_iterator`` stages tensor batches through
    its own queue; this class is for payloads that live as bytes."""

    def __init__(self, capacity: int = 4):
        self._lib = get_lib()
        if self._lib is not None:
            self._h = self._lib.hostbuf_queue_new(capacity)
        else:
            import queue

            self._q = queue.Queue(maxsize=capacity)
            self._closed = threading.Event()

    def push(self, data: bytes) -> bool:
        if self._lib is not None:
            return self._lib.hostbuf_queue_push(self._h, data, len(data)) == 0
        # Fallback mirrors the C++ contract: push blocks while full, fails
        # once closed.
        while not self._closed.is_set():
            try:
                self._q.put(data, timeout=0.05)
                return True
            except Exception:
                continue
        return False

    def pop(self, max_len: int) -> bytes:
        if self._lib is not None:
            buf = ctypes.create_string_buffer(max_len)
            n = self._lib.hostbuf_queue_pop(self._h, buf, max_len)
            return buf.raw[:n]
        while True:
            try:
                item = self._q.get(timeout=0.05)
            except Exception:
                if self._closed.is_set():
                    return b""
                continue
            return item[:max_len]

    def size(self) -> int:
        if self._lib is not None:
            return int(self._lib.hostbuf_queue_size(self._h))
        return self._q.qsize()

    def close(self):
        if self._lib is not None:
            self._lib.hostbuf_queue_close(self._h)
        else:
            self._closed.set()

    def __del__(self):
        try:
            if self._lib is not None:
                self._lib.hostbuf_queue_free(self._h)
        except Exception:
            pass
