"""Low-precision gradient wire and int8 KV pages — port of
``chainermn_tpu/communicators/quant.py``.

With ``comm_dtype=`` on a communicator, each packed gradient bucket is
scaled by its global amax and cast to a narrow wire dtype before the sum
collective, then cast back and unscaled::

    amax = allreduce_max(max(|bucket|))   # one tiny fp32 collective
    s    = amax / per_rank_qmax           # world headroom: the SUM fits
    q    = clip(round(bucket / s))        # narrow wire dtype
    out  = allreduce_sum(q) * s / world   # sum collective + dequant mean

``per_rank_qmax`` is ``floor(127 / world)`` for int8, an integer budget,
so ``round(x / s) <= per_rank_qmax`` exactly and the int8 sum of the
world cannot wrap (a fractional budget such as 127 / 8 = 15.875 rounds up
to 16).  For fp8 (e4m3) it is ``448 / world`` with a 2**-3 divisor for
the format's rounding.  The division by the world happens in fp32 at
dequant time, never in the wire dtype.

``fp8`` is the wire only where the backend sums ``torch.float8_e4m3fn``;
elsewhere it falls back to the int8 wire, as the reference does on the
CPU.  Gloo does not sum fp8 (its all-reduce rejects the dtype), so on the
CPU the fallback is always taken; over NCCL the communicator probes once
(:meth:`CommunicatorBase.wire_dtype`).

Error bounds per element of the quantized mean against the fp32 mean,
with ``A`` the global bucket amax and ``n`` the world size: int8
``A / (2 * floor(127 / n))``; fp8 ``A * (n + 1) / 16`` (loose by
construction; it covers the int8 fallback too).

The serving half (:func:`quantize_kv`, :func:`dequantize_kv`) stores KV
pages as int8 with one fp32 scale per written token per KV head
(``kv_dtype="int8"`` on the engine).
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import numpy as np
import torch

#: Environment override for an unset constructor ``comm_dtype``.
#: Values: ``int8`` | ``fp8`` | ``none`` (explicit off).
ENV_COMM_DTYPE = "CHAINERMN_TPU_COMM_DTYPE"

#: Environment override for an unset engine ``kv_dtype``.
ENV_KV_DTYPE = "CHAINERMN_TPU_KV_DTYPE"

#: Canonical wire names accepted by ``comm_dtype=`` (plus ``"none"`` for
#: an explicit off and ``None`` for "resolve the environment").
COMM_DTYPE_CHOICES = ("int8", "fp8")

#: Canonical KV cache storage dtypes accepted by ``kv_dtype=``.
KV_DTYPE_CHOICES = ("int8",)

_INT8_QMAX = 127.0

_NAME_ALIASES = {
    "": None,
    "none": "none",
    "off": "none",
    "0": "none",
    "float32": "none",
    "bfloat16": "none",
    "bf16": "none",
    "int8": "int8",
    "s8": "int8",
    "fp8": "fp8",
    "e4m3": "fp8",
    "float8_e4m3fn": "fp8",
    "e2m1": "fp8",
}


def canonical_comm_dtype(name: Any) -> Optional[str]:
    """Normalize a spelling of ``comm_dtype``: ``None`` for unset, the
    string ``"none"`` for an explicit off, or a member of
    :data:`COMM_DTYPE_CHOICES`.  Unknown names raise."""
    if name is None:
        return None
    key = str(name).strip().lower()
    if key in _NAME_ALIASES:
        return _NAME_ALIASES[key]
    raise ValueError(
        f"unknown comm_dtype {name!r}; choose from "
        f"{COMM_DTYPE_CHOICES} (or 'none' to disable)"
    )


def canonical_kv_dtype(name: Any) -> Optional[str]:
    """Normalize a ``kv_dtype`` spelling: ``None``/"none"/model-dtype
    names mean "store pages at the model dtype" (off); ``"int8"`` turns
    quantized pages on.  Unknown names raise."""
    if name is None:
        return None
    key = str(name).strip().lower()
    if key in ("", "none", "off", "bf16", "bfloat16", "float32", "fp32"):
        return None
    if key in ("int8", "s8"):
        return "int8"
    raise ValueError(
        f"unknown kv_dtype {name!r}; choose from {KV_DTYPE_CHOICES} "
        "(or 'none' to store pages at the model dtype)"
    )


@functools.lru_cache(maxsize=None)
def fp8_supported() -> bool:
    """Whether this torch casts to and from ``torch.float8_e4m3fn`` (probed
    once): the quantize and dequantize legs of the fp8 wire.  Whether a
    process group also SUMS fp8 is the communicator's own probe
    (:meth:`~.base.CommunicatorBase.wire_dtype`)."""
    if not hasattr(torch, "float8_e4m3fn"):
        return False
    try:
        x = torch.ones(2).to(torch.float8_e4m3fn)
        return bool((x.float() == 1).all())
    except (RuntimeError, TypeError):
        return False


def wire_dtype(comm_dtype: Optional[str]):
    """Canonical comm dtype name -> the dtype that goes on the wire:
    ``torch.int8``, ``torch.float8_e4m3fn`` for ``"fp8"`` where
    :func:`fp8_supported` (int8 otherwise), ``None`` for off."""
    if comm_dtype is None or comm_dtype == "none":
        return None
    if comm_dtype == "int8":
        return torch.int8
    if comm_dtype == "fp8":
        return torch.float8_e4m3fn if fp8_supported() else torch.int8
    raise ValueError(f"unknown canonical comm_dtype {comm_dtype!r}")


def qmax(wire_dt: torch.dtype) -> float:
    """Largest representable magnitude of a wire dtype."""
    if wire_dt == torch.int8:
        return _INT8_QMAX
    return float(torch.finfo(wire_dt).max)  # e4m3fn: 448


def quantizable(dtype: torch.dtype) -> bool:
    """Only floating buckets are quantized; integer ones pass through."""
    return dtype.is_floating_point


def _chunked(buf: torch.Tensor, chunk_elems: Optional[int]):
    n = buf.shape[0]
    if chunk_elems and chunk_elems < n and n % chunk_elems == 0:
        return buf.reshape(n // chunk_elems, chunk_elems)
    return buf.reshape(1, n)


def local_amax(buf: torch.Tensor, chunk_elems: Optional[int] = None):
    """Per-chunk max-abs of this rank's bucket, fp32, shape (n_chunks,)."""
    return _chunked(buf, chunk_elems).float().abs().amax(dim=1)


def per_rank_qmax(wire_dt: torch.dtype, world: int) -> float:
    """Each rank's magnitude budget on the wire such that the world's sum
    stays representable (see the module docstring)."""
    if wire_dt == torch.int8:
        return max(1.0, float(np.floor(_INT8_QMAX / world)))
    return qmax(wire_dt) / world / (1.0 + 2.0 ** -3)


def scale_for(amax_global: torch.Tensor, wire_dt: torch.dtype, world: int):
    """``s = amax / per_rank_qmax`` per chunk; all-zero chunks get 1."""
    s = amax_global / per_rank_qmax(wire_dt, world)
    return torch.where(amax_global > 0, s, torch.ones_like(s))


def quantize(buf: torch.Tensor, scale: torch.Tensor, wire_dt: torch.dtype,
             chunk_elems: Optional[int] = None) -> torch.Tensor:
    """Scale and cast one bucket buffer to the wire dtype."""
    x = _chunked(buf, chunk_elems).float() / scale[:, None]
    if wire_dt == torch.int8:
        x = torch.clamp(torch.round(x), -_INT8_QMAX, _INT8_QMAX)
    return x.to(wire_dt).reshape(buf.shape)


def quantize_for_allreduce(buf: torch.Tensor, wire_dt: torch.dtype, group,
                           world: int, chunk_elems: Optional[int] = None):
    """The quantized wire's leg before the sum: the local amax, its MAX
    all-reduce over ``group`` (every rank agrees on the scale), the
    scale and the cast.  Returns ``(q, scale)``; the caller sums ``q``
    and finishes with :func:`dequantize_mean`."""
    import torch.distributed as dist

    amax = local_amax(buf, chunk_elems)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = scale_for(amax, wire_dt, world)
    return quantize(buf, scale, wire_dt, chunk_elems), scale


def dequantize_mean(qsum: torch.Tensor, scale: torch.Tensor, world: int,
                    out_dtype: torch.dtype,
                    chunk_elems: Optional[int] = None) -> torch.Tensor:
    """Summed wire buffer -> the mean, ``qsum * s / world`` in fp32."""
    x = _chunked(qsum, chunk_elems).float()
    x = x * (scale[:, None] / float(world))
    return x.reshape(qsum.shape).to(out_dtype)


def error_bound(comm_dtype: str, amax, world: int):
    """Worst-case error of the quantized mean against the fp32 mean."""
    amax = np.asarray(amax, np.float64)
    if comm_dtype == "int8":
        return amax / (2.0 * max(1.0, np.floor(_INT8_QMAX / world)))
    if comm_dtype == "fp8":
        return amax * (world + 1) / 16.0
    raise ValueError(f"no error bound for comm_dtype {comm_dtype!r}")


def measure_comm_quant_error(comm, tensors, publish: bool = True) -> float:
    """Max-abs error of ``comm``'s quantized ``allreduce_grad`` against its
    full-precision one on copies of ``tensors`` (this rank's gradients;
    collective, so every rank calls it).  Sets the ``comm/quant_abs_err``
    gauge when telemetry is active and ``publish`` is set."""
    if comm.resolve_comm_dtype(tensors) is None:
        raise ValueError(
            "measure_comm_quant_error needs a communicator with a "
            "resolved comm_dtype (ctor or CHAINERMN_TPU_COMM_DTYPE)"
        )
    quantized = [t.detach().clone() for t in tensors]
    exact = [t.detach().clone() for t in tensors]
    comm.allreduce_grad(quantized)
    saved = comm.comm_dtype
    try:
        comm.comm_dtype = "none"
        comm.allreduce_grad(exact)
    finally:
        comm.comm_dtype = saved
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(quantized, exact))
    if publish:
        from ..observability import reporter as _reporter
        from ..observability import spans as _spans

        if _spans.telemetry_active():
            rep = _reporter.get_reporter()
            if rep is not None:
                rep.gauge("comm/quant_abs_err", err)
    return err


# ----------------------------------------------------------------------
# Serving KV half: per-token-per-head scales over d_head
# ----------------------------------------------------------------------
def quantize_kv(x: torch.Tensor):
    """Quantize freshly projected K or V for int8 page storage.

    ``x``: (B, T, Hkv, D).  Returns ``(q, scales)``: ``q`` int8 of the same
    shape, ``scales`` fp32 (B, T, Hkv) — ``amax / 127`` per token per KV
    head, 1 where the amax is 0.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does, so the payload equals the reference's bitwise."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / _INT8_QMAX, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -_INT8_QMAX,
                    _INT8_QMAX).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scales: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Int8 pages (or a gathered context) back to ``dtype``: ``q`` (...,
    Hkv, D) int8 times ``scales`` (..., Hkv) fp32 over the head dim.  A slot
    never written holds zero payload and zero scale, so it dequantizes to
    the zeros an unquantized cache gives."""
    return (q.float() * scales[..., None]).to(dtype)
