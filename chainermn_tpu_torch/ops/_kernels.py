"""The hand-written flash-attention kernels: build, bind, launch, count.

Three CUDA kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``, with
the Hopper building blocks of ``csrc/sm90.cuh``) replace the three
Pallas kernels of ``chainermn_tpu/ops/flash_attention.py``:

==============  =====================================================
``flash_fwd``   ``_attn_kernel`` — o and the fp32 row log-sum-exp
``flash_dq``    ``_dq_kernel`` — dQ from the saved LSE
``flash_dkv``   ``_dkv_kernel`` — dK, dV, the GQA group reduced in-block
==============  =====================================================

Each source compiles at first use with ``nvcc`` (sm_90a) into a shared
library with a plain C interface under ``build/kernels/`` of the
checkout, named by the sources' hash, and is bound with ``ctypes``.
Both sources build in parallel.  Which kernel a call runs (``wgmma`` or
``simt``) follows one rule in ``csrc/flash_common.cuh``; :func:`route`
reports it.

Each kernel is also a ``torch.library`` custom op
(``chainermn_torch::flash_fwd``, ``::flash_dq``, ``::flash_dkv``) that
declares its real inputs and outputs, with a fake implementation for
meta and fake tensors, so the dispatcher (a ``TorchDispatchMode``, the
profiler, ``opcheck``) sees one op taking q, k, v and giving o and lse
where the raw-pointer launch alone would show only the allocations.
The op's body is the wrapper's device switch: the plain PyTorch twin
only when the tensors lie on the CPU; for CUDA tensors it launches the
kernel or raises.  Each launch adds one to :data:`LAUNCHES`.

Layouts at this boundary are the reference's: ``(BH, S, D)`` q/k/v/o
(k/v may carry ``BH / G`` rows for GQA: q row ``b`` reads kv row
``b // G``), ``(BH, S, 1)`` fp32 lse and delta, ``(BH, S, 1)`` int32
segment ids.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Optional, Tuple

import torch
from torch import Tensor

_NEG_INF = -1e30

#: Launches of each kernel since the last :func:`reset_launch_counts`.
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}

#: Per source: build seconds and the compiler's ``-Xptxas -v`` report.
BUILD_INFO: dict = {}

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
_SOURCES = ("flash_fwd", "flash_bwd")
_libs: dict = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for f in sorted(_CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return _BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build() -> dict:
    """Compile every kernel source that has no library yet, all ``nvcc``
    processes at once; load each library.  Returns :data:`BUILD_INFO`."""
    with _lock:
        todo = [n for n in _SOURCES if n not in _libs]
        if not todo:
            return BUILD_INFO
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for name in todo:
            out = _library_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [
                _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v", "-I", str(_CSRC),
                "-o", str(tmp), str(_CSRC / f"{name}.cu"), "-ldl",
            ]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ), tmp, out)
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            os.replace(tmp, out)
            BUILD_INFO[name] = {
                "seconds": time.perf_counter() - t0, "log": log,
            }
        for name in todo:
            lib = ctypes.CDLL(str(_library_path(name)))
            _bind(name, lib)
            _libs[name] = lib
            BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "cached"})
        return BUILD_INFO


def _bind(name: str, lib) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # bf16, BH, BHk, Sq, Sk, D, scale, causal, window, stream
    tail = [I, I, I, I, I, I, F, I, I, P]
    kernels = ({"fwd": 7} if name == "flash_fwd" else {"dq": 9, "dkv": 10})
    for kind, n_ptr in kernels.items():
        fn = getattr(lib, f"chainermn_flash_{kind}")
        fn.argtypes = [P] * n_ptr + tail
        fn.restype = I
        smem = getattr(lib, f"chainermn_flash_{kind}_smem")
        smem.argtypes = [I, I]
        smem.restype = ctypes.c_longlong
    if name == "flash_fwd":
        lib.chainermn_flash_route.argtypes = [I, I, I]
        lib.chainermn_flash_route.restype = I


def _lib(name: str):
    if name not in _libs:
        build()
    return _libs[name]


# ---------------------------------------------------------------------------
# Argument checks shared by the three wrappers
# ---------------------------------------------------------------------------


def _check(q, k, v, extra, seg, window):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (BH, S, D)")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if q.shape[2] != k.shape[2]:
        raise ValueError(f"q head dim {q.shape[2]} != kv head dim {k.shape[2]}")
    if q.shape[0] % k.shape[0]:
        raise ValueError(
            f"query head rows {q.shape[0]} not a multiple of kv head rows "
            f"{k.shape[0]}"
        )
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernels take float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v must share one dtype")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    tensors = [q, k, v, *extra]
    if seg[0] is not None:
        qs, ks = seg
        if qs.dtype != torch.int32 or ks.dtype != torch.int32:
            raise TypeError("segment ids must be int32")
        if tuple(qs.shape) != (q.shape[0], q.shape[1], 1) or tuple(
                ks.shape) != (k.shape[0], k.shape[1], 1):
            raise ValueError("segment ids must be (BH, S, 1) per operand")
        tensors += [qs, ks]
    dev = q.device
    for t in tensors:
        if t.device != dev:
            raise ValueError("all operands must be on one device")
    return tensors


def _cuda_ready(q, tensors):
    """Raise unless the kernels take this call: D <= 256, grid rows within
    CUDA's limit, row positions within int32 (the TMA coordinates), every
    operand a contiguous tensor with a 16-byte aligned base (the kernels
    take raw pointers)."""
    if q.shape[2] > 256:
        raise ValueError(f"flash kernels take D <= 256, got {q.shape[2]}")
    if q.shape[0] > 65535:
        raise ValueError(f"flash kernels take at most 65535 rows, got {q.shape[0]}")
    if q.shape[0] * max(q.shape[1], tensors[1].shape[1]) >= 2 ** 31:
        raise ValueError("flash kernels take fewer than 2**31 rows x positions")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("flash kernels take contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("flash kernels take 16-byte aligned tensors")


def _tail(q, k, scale, causal, window):
    return [
        int(q.dtype == torch.bfloat16), q.shape[0], k.shape[0], q.shape[1],
        k.shape[1], q.shape[2], float(scale), int(bool(causal)),
        -1 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream,
    ]


def smem_bytes(name: str, dtype: torch.dtype, D: int) -> int:
    """Dynamic shared memory one block of kernel ``name`` (``flash_fwd``,
    ``flash_dq``, ``flash_dkv``) requests at this dtype and head size;
    builds the kernels on first use."""
    lib = _lib("flash_fwd" if name == "flash_fwd" else "flash_bwd")
    fn = getattr(lib, f"chainermn_{name}_smem")
    return int(fn(int(dtype == torch.bfloat16), int(D)))


_KERNEL_IDS = {"flash_fwd": 0, "flash_dq": 1, "flash_dkv": 2}
_ROUTES = ("simt", "wgmma")


def route(name: str, dtype: torch.dtype, D: int) -> str:
    """The kernel a CUDA call of ``name`` (``flash_fwd``, ``flash_dq``,
    ``flash_dkv``) runs at this dtype and head size: ``"wgmma"`` (the
    Hopper TMA-fed, warp-specialised kernels) or ``"simt"``.  The rule
    lives in ``csrc/flash_common.cuh``; builds the kernels on first use."""
    lib = _lib("flash_fwd")
    return _ROUTES[lib.chainermn_flash_route(
        _KERNEL_IDS[name], int(dtype == torch.bfloat16), int(D))]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# Plain twins (the CPU path, and the card-side reference)
# ---------------------------------------------------------------------------


def _mask(Sq, Sk, causal, window, q_seg, kv_seg, device):
    """(rows, Sq, Sk) bool mask, rows = 1 or the segment rows."""
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Sk, device=device)[None, :]
    m = torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    if causal:
        m = m & (qp >= kp)
    if window is not None:
        m = m & (qp - kp < window)
    m = m[None]
    if q_seg is not None:
        m = m & (q_seg[:, :, 0][:, :, None] == kv_seg[:, :, 0][:, None, :])
    return m


def _row_chunks(BH, Sq, Sk):
    """Row chunks that bound the twins' (rows, Sq, Sk) fp32 temporaries
    to ~256 MiB each."""
    step = max(1, (1 << 26) // max(1, Sq * Sk))
    return [(b, min(BH, b + step)) for b in range(0, BH, step)]


def flash_fwd_plain(q, k, v, scale, causal, window=None, q_seg=None,
                    kv_seg=None):
    """Plain twin of :func:`flash_fwd`: dense masked softmax in fp32 with
    P cast to v's dtype before PV, as the kernel does."""
    BH, Sq, D = q.shape
    G = BH // k.shape[0]
    o = torch.empty_like(q)
    lse = torch.empty(BH, Sq, 1, dtype=torch.float32, device=q.device)
    for b0, b1 in _row_chunks(BH, Sq, k.shape[1]):
        kv = torch.arange(b0, b1, device=q.device) // G
        qf = q[b0:b1].float()
        kf, vf = k[kv].float(), v[kv]
        s = torch.matmul(qf, kf.transpose(1, 2)) * scale
        qs = None if q_seg is None else q_seg[b0:b1]
        ks = None if kv_seg is None else kv_seg[kv]
        mask = _mask(Sq, k.shape[1], causal, window, qs, ks, q.device)
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
        m = s.amax(-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
        denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
        acc = torch.matmul(p.to(vf.dtype).float(), vf.float())
        o[b0:b1] = (acc / denom).to(q.dtype)
        lse[b0:b1] = m + torch.log(denom)
    return o, lse


def _bwd_plain(q, k, v, do, lse, delta, scale, causal, window, q_seg,
               kv_seg, want):
    BH, Sq, D = q.shape
    BHk = k.shape[0]
    G = BH // BHk
    dq = dk = dv = None
    if "dq" in want:
        dq = torch.empty_like(q)
    if "dkv" in want:
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for b0, b1 in _row_chunks(BH, Sq, k.shape[1]):
        kv = torch.arange(b0, b1, device=q.device) // G
        qf, dof = q[b0:b1].float(), do[b0:b1].float()
        kf, vf = k[kv].float(), v[kv].float()
        s = torch.matmul(qf, kf.transpose(1, 2)) * scale
        qs = None if q_seg is None else q_seg[b0:b1]
        ks = None if kv_seg is None else kv_seg[kv]
        mask = _mask(Sq, k.shape[1], causal, window, qs, ks, q.device)
        p = torch.where(mask, torch.exp(s - lse[b0:b1]), torch.zeros_like(s))
        dp = torch.matmul(dof, vf.transpose(1, 2))
        ds = (p * (dp - delta[b0:b1]) * scale).to(q.dtype).float()
        if dq is not None:
            dq[b0:b1] = torch.matmul(ds, kf).to(q.dtype)
        if dk is not None:
            pt = p.to(q.dtype).float().transpose(1, 2)
            dv.index_add_(0, kv, torch.matmul(pt, dof))
            dk.index_add_(0, kv, torch.matmul(ds.transpose(1, 2), qf))
    return dq, dk, dv


def flash_dq_plain(q, k, v, do, lse, delta, scale, causal, window=None,
                   q_seg=None, kv_seg=None):
    """Plain twin of :func:`flash_dq`."""
    return _bwd_plain(q, k, v, do, lse, delta, scale, causal, window, q_seg,
                      kv_seg, ("dq",))[0]


def flash_dkv_plain(q, k, v, do, lse, delta, scale, causal, window=None,
                    q_seg=None, kv_seg=None):
    """Plain twin of :func:`flash_dkv`."""
    _, dk, dv = _bwd_plain(q, k, v, do, lse, delta, scale, causal, window,
                           q_seg, kv_seg, ("dkv",))
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Custom ops: the device switch and the launches
# ---------------------------------------------------------------------------


def _segs(q_seg, kv_seg):
    return [t for t in (q_seg, kv_seg) if t is not None]


@torch.library.custom_op("chainermn_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: Tensor, k: Tensor, v: Tensor, scale: float,
                  causal: bool, window: Optional[int],
                  q_seg: Optional[Tensor],
                  kv_seg: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale, causal, window, q_seg, kv_seg)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu, not {q.device}")
    _cuda_ready(q, [q, k, v, *_segs(q_seg, kv_seg)])
    lib = _lib("flash_fwd")
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[0], q.shape[1], 1, dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        err = lib.chainermn_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
            *_tail(q, k, scale, causal, window),
        )
    _raise_on(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


@_flash_fwd_op.register_fake
def _(q, k, v, scale, causal, window, q_seg, kv_seg):
    return (torch.empty_like(q),
            q.new_empty((q.shape[0], q.shape[1], 1), dtype=torch.float32))


@torch.library.custom_op("chainermn_torch::flash_dq", mutates_args=())
def _flash_dq_op(q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor,
                 delta: Tensor, scale: float, causal: bool,
                 window: Optional[int], q_seg: Optional[Tensor],
                 kv_seg: Optional[Tensor]) -> Tensor:
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, scale, causal, window,
                              q_seg, kv_seg)
    if q.device.type != "cuda":
        raise ValueError(f"flash_dq runs on cuda or cpu, not {q.device}")
    _cuda_ready(q, [q, k, v, do, lse, delta, *_segs(q_seg, kv_seg)])
    lib = _lib("flash_bwd")
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.chainermn_flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
            dq.data_ptr(), *_tail(q, k, scale, causal, window),
        )
    _raise_on(err, "flash_dq")
    LAUNCHES["flash_dq"] += 1
    return dq


@_flash_dq_op.register_fake
def _(q, k, v, do, lse, delta, scale, causal, window, q_seg, kv_seg):
    return torch.empty_like(q)


@torch.library.custom_op("chainermn_torch::flash_dkv", mutates_args=())
def _flash_dkv_op(q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor,
                  delta: Tensor, scale: float, causal: bool,
                  window: Optional[int], q_seg: Optional[Tensor],
                  kv_seg: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, scale, causal,
                               window, q_seg, kv_seg)
    if q.device.type != "cuda":
        raise ValueError(f"flash_dkv runs on cuda or cpu, not {q.device}")
    _cuda_ready(q, [q, k, v, do, lse, delta, *_segs(q_seg, kv_seg)])
    lib = _lib("flash_bwd")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.chainermn_flash_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
            dk.data_ptr(), dv.data_ptr(), *_tail(q, k, scale, causal, window),
        )
    _raise_on(err, "flash_dkv")
    LAUNCHES["flash_dkv"] += 1
    return dk, dv


@_flash_dkv_op.register_fake
def _(q, k, v, do, lse, delta, scale, causal, window, q_seg, kv_seg):
    return torch.empty_like(k), torch.empty_like(v)


# ---------------------------------------------------------------------------
# Wrappers: argument checks, then the custom op
# ---------------------------------------------------------------------------


def flash_fwd(q, k, v, scale, causal, window=None, q_seg=None, kv_seg=None):
    """Flash forward over ``(BH, S, D)``: returns ``(o, lse)``."""
    _check(q, k, v, (), (q_seg, kv_seg), window)
    return torch.ops.chainermn_torch.flash_fwd(
        q, k, v, float(scale), bool(causal),
        None if window is None else int(window), q_seg, kv_seg)


def _check_rows(q, do, lse, delta):
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("do must match q in shape and dtype")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (
                q.shape[0], q.shape[1], 1):
            raise ValueError(f"{name} must be float32 (BH, S, 1)")


def flash_dq(q, k, v, do, lse, delta, scale, causal, window=None,
             q_seg=None, kv_seg=None):
    """dQ of flash attention from the saved row LSE and
    ``delta = rowsum(dO * O) - dlse``."""
    _check_rows(q, do, lse, delta)
    _check(q, k, v, (do, lse, delta), (q_seg, kv_seg), window)
    return torch.ops.chainermn_torch.flash_dq(
        q, k, v, do, lse, delta, float(scale), bool(causal),
        None if window is None else int(window), q_seg, kv_seg)


def flash_dkv(q, k, v, do, lse, delta, scale, causal, window=None,
              q_seg=None, kv_seg=None):
    """dK, dV of flash attention; a GQA group's query heads reduce inside
    the kernel."""
    _check_rows(q, do, lse, delta)
    _check(q, k, v, (do, lse, delta), (q_seg, kv_seg), window)
    return torch.ops.chainermn_torch.flash_dkv(
        q, k, v, do, lse, delta, float(scale), bool(causal),
        None if window is None else int(window), q_seg, kv_seg)
