"""The paged data plane and the int8 KV quantiser against the JAX package.

Same seeded numpy pages, tables and queries through
``chainermn_tpu.ops.decode_attention`` and the port's
``chainermn_tpu_torch.ops.decode_attention``.  Tolerances: fp32 outputs
within 1e-6 absolute; bf16 outputs within one bf16 ulp of the reference's
magnitude (both sides compute the same fp32 logits from bf16 operands and
round once more to bf16 after the second einsum, whose accumulation order
may differ).  Page writes, ``quantize_kv`` and the chunked gather are
held bitwise; pages outside the written (page, slot) set stay bitwise
unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.communicators import quant as jquant
from chainermn_tpu.ops import decode_attention as jda
from chainermn_tpu_torch.communicators import quant as tquant
from chainermn_tpu_torch.ops import decode_attention as tda

N, PS, D, H, B, W = 12, 4, 8, 4, 3, 4


def _tables(rng):
    t = np.stack([rng.permutation(N)[:W] for _ in range(B)]).astype(np.int32)
    t[0, 3] = N              # an unallocated slot in a live row
    t[1, :] = N              # a padding row
    return t


def _pages(rng, hkv, dtype):
    k = rng.standard_normal((N, PS, hkv, D)).astype(np.float32)
    v = rng.standard_normal((N, PS, hkv, D)).astype(np.float32)
    return k, v


def _to_t(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _np(t):
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


def _close(port, ref, dtype):
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(port, ref, rtol=0, atol=1e-6)
    else:
        assert np.all(np.abs(port - ref) <= _bf16_ulp(ref)), (
            np.max(np.abs(port - ref) / _bf16_ulp(ref)))


JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv", [1, 2, 4])
@pytest.mark.parametrize("T", [1, 3])
def test_chunk_attention_matches_reference(dtype, hkv, T):
    rng = np.random.default_rng(hkv * 10 + T)
    k, v = _pages(rng, hkv, dtype)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    tables = _tables(rng)
    # a live row, a padding row, a row whose chunk runs past the table
    start = np.array([5, -1, W * PS - 2], np.int32)
    jd = JDT[dtype]
    ref = jda.paged_attention_chunk(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.asarray(tables), jnp.asarray(start))
    out = tda.paged_attention_chunk(
        _to_t(q, dtype), _to_t(k, dtype), _to_t(v, dtype),
        torch.from_numpy(tables), torch.from_numpy(start))
    assert out.dtype == dtype and out.shape == (B, T, H, D)
    assert torch.isfinite(out).all()       # the padding row included
    live = [0, 2]
    _close(_np(out)[live], np.asarray(ref, np.float32)[live], dtype)
    if T == 1:
        dec = tda.paged_attention_decode(
            _to_t(q, dtype), _to_t(k, dtype), _to_t(v, dtype),
            torch.from_numpy(tables), torch.from_numpy(start + 1))
        assert torch.equal(dec, out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_pages_match_reference(dtype):
    rng = np.random.default_rng(3)
    hkv, T = 2, 2
    kf, vf = _pages(rng, hkv, dtype)
    qk, ks = jquant.quantize_kv(jnp.asarray(kf))
    qv, vs = jquant.quantize_kv(jnp.asarray(vf))
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    tables = _tables(rng)
    start = np.array([3, -1, 9], np.int32)
    jd = JDT[dtype]
    ref = jda.paged_attention_chunk(
        jnp.asarray(q, jd), qk, qv, jnp.asarray(tables), jnp.asarray(start),
        k_scales=ks, v_scales=vs)
    out = tda.paged_attention_chunk(
        _to_t(q, dtype), torch.from_numpy(np.array(qk)),
        torch.from_numpy(np.array(qv)), torch.from_numpy(tables),
        torch.from_numpy(start), k_scales=torch.from_numpy(np.array(ks)),
        v_scales=torch.from_numpy(np.array(vs)))
    _close(_np(out)[[0, 2]], np.asarray(ref, np.float32)[[0, 2]], dtype)
    with pytest.raises(ValueError, match="together"):
        tda.paged_attention_chunk(
            _to_t(q, dtype), torch.from_numpy(np.array(qk)),
            torch.from_numpy(np.array(qv)), torch.from_numpy(tables),
            torch.from_numpy(start), k_scales=torch.ones(N, PS, hkv))


@pytest.mark.parametrize("int8", [False, True])
def test_block_ctx_chunked_gather_is_bitwise_one_shot(int8):
    rng = np.random.default_rng(4)
    kf, vf = _pages(rng, 2, torch.float32)
    k, v = torch.from_numpy(kf), torch.from_numpy(vf)
    scales = {}
    if int8:
        k, ksc = tquant.quantize_kv(k)
        v, vsc = tquant.quantize_kv(v)
        scales = dict(k_scales=ksc, v_scales=vsc)
    q = torch.from_numpy(rng.standard_normal((B, 2, H, D)).astype(np.float32))
    tables = torch.from_numpy(_tables(rng))
    start = torch.tensor([6, -1, 13], dtype=torch.int32)
    one = tda.paged_attention_chunk(q, k, v, tables, start, **scales)
    for bc in (1, 3, W, 2 * W):
        out = tda.paged_attention_chunk(q, k, v, tables, start,
                                        block_ctx=bc, **scales)
        assert torch.equal(out, one)


def test_invalid_page_gathers_zeros_and_gqa_rejects():
    k = torch.ones(N, PS, 1, D)
    q = torch.ones(1, 1, H, D)
    # one live position in an invalid slot: its key and value read as 0,
    # so the only live key has logit 0 and the output is exactly 0
    out = tda.paged_attention_chunk(q, k, k, torch.full((1, 1), N),
                                    torch.tensor([0]))
    assert torch.equal(out, torch.zeros_like(out))
    with pytest.raises(ValueError, match="divide"):
        tda.paged_attention_chunk(torch.ones(1, 1, 3, D), torch.ones(N, PS, 2, D),
                                  torch.ones(N, PS, 2, D), torch.zeros(1, 1),
                                  torch.tensor([0]))
    with pytest.raises(ValueError, match="one query"):
        tda.paged_attention_decode(torch.ones(1, 2, H, D), k, k,
                                   torch.zeros(1, 1), torch.tensor([1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("writer", ["prompt", "chunk", "token"])
def test_page_writes_match_reference_bitwise(dtype, writer):
    rng = np.random.default_rng({"prompt": 5, "chunk": 6, "token": 7}[writer])
    hkv = 2
    pages = rng.standard_normal((N, PS, hkv, D)).astype(np.float32)
    tables = _tables(rng)
    if writer == "prompt":
        S = 9
        lens = np.array([7, 4, 3], np.int32)   # row 1's table is all invalid
        jfn, tfn = jda.write_prompt_pages, tda.write_prompt_pages
    elif writer == "chunk":
        S = 3
        lens = np.array([4, -1, W * PS - 1], np.int32)  # past the table
        jfn, tfn = jda.write_chunk_pages, tda.write_chunk_pages
    else:
        S = 1
        lens = np.array([10, -1, 13], np.int32)
        jfn, tfn = jda.write_token_pages, tda.write_token_pages
    new = rng.standard_normal((B, S, hkv, D)).astype(np.float32)
    jd = JDT[dtype]
    ref = np.asarray(jfn(jnp.asarray(pages, jd), jnp.asarray(new, jd),
                         jnp.asarray(tables), jnp.asarray(lens)), np.float32)
    tp = _to_t(pages, dtype)
    before = tp.clone()
    out = tfn(tp, _to_t(new, dtype), torch.from_numpy(tables),
              torch.from_numpy(lens))
    assert out is tp                                   # in place
    np.testing.assert_array_equal(_np(tp), ref)
    # pages outside the written (page, slot) set are untouched
    page, slot = tda._positions_to_pages(
        torch.from_numpy(tables),
        torch.from_numpy(_positions(writer, lens, S)), PS, N)
    written = torch.zeros(N, PS, dtype=torch.bool)
    ok = page < N
    written[page[ok].long(), slot[ok].long()] = True
    assert torch.equal(tp[~written], before[~written])
    assert written.any()


def _positions(writer, lens, S):
    ar = np.arange(S)[None]
    if writer == "prompt":
        return np.where(ar < lens[:, None], ar, -1).astype(np.int32)
    pos = lens[:, None] + ar
    return np.where(lens[:, None] >= 0, pos, -1).astype(np.int32)


def test_scale_pages_write_through_the_same_routing():
    rng = np.random.default_rng(8)
    sc = np.zeros((N, PS, 2), np.float32)
    new = rng.random((B, 2, 2)).astype(np.float32)
    tables = _tables(rng)
    lens = np.array([2, -1, 5], np.int32)
    ref = jda.write_chunk_pages(jnp.asarray(sc), jnp.asarray(new),
                                jnp.asarray(tables), jnp.asarray(lens))
    out = tda.write_chunk_pages(torch.from_numpy(sc.copy()),
                                torch.from_numpy(new),
                                torch.from_numpy(tables),
                                torch.from_numpy(lens))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kv_bitwise_and_names(dtype):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    x[0, 1, 2] = 0.0                                   # amax 0 -> scale 1
    x[1, 0, 0, :4] = [0.5, -1.5, 2.5, 127.0]           # round half to even
    jd = JDT[dtype]
    jq, js = jquant.quantize_kv(jnp.asarray(x, jd))
    tq, ts = tquant.quantize_kv(_to_t(x, dtype))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 1, 2] == 1.0
    deq = tquant.dequantize_kv(tq, ts, dtype)
    ref = jquant.dequantize_kv(jq, js, jd)
    np.testing.assert_array_equal(_np(deq), np.asarray(ref, np.float32))
    assert tquant.KV_DTYPE_CHOICES == jquant.KV_DTYPE_CHOICES
    assert tquant.ENV_KV_DTYPE == jquant.ENV_KV_DTYPE
    for name in (None, "", "none", "bf16", "float32", "int8", "S8"):
        assert tquant.canonical_kv_dtype(name) == jquant.canonical_kv_dtype(name)
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        tquant.canonical_kv_dtype("fp4")
    assert tda.invalid_block(7) == jda.invalid_block(7) == 7
