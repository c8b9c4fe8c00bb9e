"""chainermn_tpu_torch flash attention against the JAX package.

The same numpy inputs go through the reference's Pallas kernels (interpret
mode on the CPU, blocks dividing S, as tests/test_flash_attention.py runs
them) and through the port on CPU tensors, where each kernel wrapper takes
its plain PyTorch twin.  Forward outputs, the row LSE and all three
gradients are compared over the reference's case grid: causal and not,
GQA (Hk in {1, 2}), sliding windows, packed segments with padding rows,
and head sizes 16, 64 and 192.

Tolerances: both sides compute in fp32 and differ only in summation order
(the reference sums blockwise with an online softmax, the twin densely),
so outputs and the LSE agree to 2e-5 and gradients, sums over up to 128
keys of such terms, to 5e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu_torch.ops import _kernels

# The modules, not the same-named functions the ops packages re-export.
jfa = importlib.import_module("chainermn_tpu.ops.flash_attention")
tfa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")

ATOL_FWD = 2e-5
ATOL_GRAD = 5e-5


def _inputs(B, S, H, Hk, D, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, Hk, D).astype(np.float32)
    v = rng.randn(B, S, Hk, D).astype(np.float32)
    do = rng.randn(B, S, H, D).astype(np.float32)
    return q, k, v, do


def _segments(B, S):
    """Two packed documents and a padding tail; padding q ids (-1) match
    no kv id (-2), so those rows are fully masked."""
    seg = np.zeros((B, S), np.int32)
    seg[:, S // 3: 2 * S // 3] = 1
    seg[:, 5 * S // 6:] = -1
    kv = seg.copy()
    kv[kv == -1] = -2
    return seg, kv


# (causal, H, Hk, window, segmented, D, S, block)
GRID = [
    (True, 4, 4, None, False, 64, 128, 64),
    (False, 4, 4, None, False, 64, 128, 64),
    (True, 4, 2, None, False, 64, 128, 64),
    (True, 4, 1, None, False, 64, 128, 32),
    (False, 4, 2, None, False, 16, 128, 64),
    (False, 4, 1, None, False, 16, 128, 32),
    (True, 2, 2, 1, False, 64, 128, 32),
    (True, 2, 2, 17, False, 64, 128, 32),
    (True, 4, 2, 64, False, 16, 128, 32),
    (True, 2, 2, None, True, 16, 128, 32),
    (False, 2, 2, None, True, 16, 128, 32),
    (True, 4, 2, 17, True, 64, 128, 32),
    (True, 2, 2, None, False, 192, 64, 32),
    (False, 2, 1, None, True, 192, 64, 32),
]


def _ids(case):
    return "c{}-H{}-Hk{}-w{}-seg{}-D{}".format(*case[:6])


@pytest.mark.parametrize("case", GRID, ids=[_ids(c) for c in GRID])
def test_flash_forward_and_grads_match_reference(case):
    causal, H, Hk, window, segmented, D, S, block = case
    B = 2
    q, k, v, do = _inputs(B, S, H, Hk, D, seed=S + D + H + Hk)
    seg = kv_seg = None
    if segmented:
        seg, kv_seg = _segments(B, S)

    def jfn(q, k, v):
        return jfa.flash_attention(
            q, k, v, causal=causal, block_q=block, block_k=block,
            interpret=True, window=window,
            q_segment_ids=None if seg is None else jnp.asarray(seg),
            kv_segment_ids=None if kv_seg is None else jnp.asarray(kv_seg),
        )

    jo, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    to = tfa.flash_attention(
        tq, tk, tv, causal=causal, block_q=block, block_k=block,
        window=window,
        q_segment_ids=None if seg is None else torch.from_numpy(seg),
        kv_segment_ids=None if kv_seg is None else torch.from_numpy(kv_seg),
    )
    to.backward(torch.from_numpy(do))

    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               atol=ATOL_FWD, rtol=ATOL_FWD)
    for name, t, j in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   atol=ATOL_GRAD, rtol=ATOL_GRAD,
                                   err_msg=f"d{name}")
    if segmented:
        pad = seg == -1
        assert np.all(to.detach().numpy()[pad] == 0.0)
        assert np.all(tq.grad.numpy()[pad] == 0.0)


# (causal, H, Hk, segmented, D)
LSE_GRID = [
    (True, 4, 4, False, 64),
    (False, 4, 2, False, 16),
    (True, 4, 1, True, 64),
    (False, 2, 2, True, 16),
]


@pytest.mark.parametrize("case", LSE_GRID,
                         ids=["c{}-H{}-Hk{}-seg{}-D{}".format(*c)
                              for c in LSE_GRID])
def test_flash_with_lse_and_dlse_match_reference(case):
    """(BH, S, D) entry points: o, the row LSE, and all three gradients
    with a cotangent on the LSE folded into delta."""
    causal, H, Hk, segmented, D = case
    B, S, block = 2, 128, 32
    q, k, v, do = _inputs(B, S, H, Hk, D, seed=7 + D)
    dlse = np.random.RandomState(11).randn(B * H, S, 1).astype(np.float32)
    qb, kb, vb, dob = (x.transpose(0, 2, 1, 3).reshape(-1, S, D)
                       for x in (q, k, v, do))
    scale = 1.0 / np.sqrt(D)
    if segmented:
        seg, kv_seg = _segments(B, S)
        qs = np.repeat(seg, H, axis=0)[..., None]
        ks = np.repeat(kv_seg, Hk, axis=0)[..., None]

        def jfn(q, k, v):
            return jfa.flash_attention_with_lse_seg(
                q, k, v, jnp.asarray(qs), jnp.asarray(ks), scale, causal,
                block, block, True)
    else:
        def jfn(q, k, v):
            return jfa.flash_attention_with_lse(q, k, v, scale, causal,
                                                block, block, True)

    (jo, jl), vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (qb, kb, vb)))
    jgrads = vjp((jnp.asarray(dob), jnp.asarray(dlse)))

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (qb, kb, vb))
    if segmented:
        to, tl = tfa.flash_attention_with_lse_seg(
            tq, tk, tv, torch.from_numpy(qs), torch.from_numpy(ks), scale,
            causal, block, block)
    else:
        to, tl = tfa.flash_attention_with_lse(tq, tk, tv, scale, causal,
                                              block, block)
    torch.autograd.backward((to, tl),
                            (torch.from_numpy(dob), torch.from_numpy(dlse)))

    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               atol=ATOL_FWD, rtol=ATOL_FWD)
    live = np.asarray(jl) > -1e29
    np.testing.assert_allclose(tl.detach().numpy()[live],
                               np.asarray(jl)[live], atol=ATOL_FWD,
                               rtol=ATOL_FWD)
    assert np.all(tl.detach().numpy()[~live] < -1e29)
    for name, t, j in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   atol=ATOL_GRAD, rtol=ATOL_GRAD,
                                   err_msg=f"d{name}")


# bf16 limits of chip_smoke.py (kernel against twin on the card), here
# twin against the reference's kernels: per element |a - b| <= atol +
# rtol |b|, and per 64-row tile of a head ||a - b|| / ||b|| <= tile.
BF16_ATOL, BF16_RTOL, BF16_TILE = 2 ** -6, 2e-2, 1e-2

# (causal, H, Hk, window, segmented, D, block)
BF16_GRID = [
    (True, 4, 4, None, False, 64, 64),
    (False, 4, 4, None, False, 64, 64),
    (True, 4, 2, None, False, 64, 32),       # GQA
    (True, 4, 2, 17, False, 64, 32),         # window
    (True, 4, 2, None, True, 64, 32),        # segments, padding rows
    (False, 4, 1, None, True, 128, 64),
]


@pytest.mark.parametrize("case", BF16_GRID,
                         ids=["c{}-H{}-Hk{}-w{}-seg{}-D{}".format(*c[:6])
                              for c in BF16_GRID])
def test_bwd_twins_match_reference_kernels_in_bf16(case):
    """The kernel boundary at the dtype the Hopper kernels run: bf16 q, k,
    v, dO through the reference's dQ and dK/dV kernels (interpret mode,
    from its own forward's o and LSE) and through the port's twins
    ``flash_dq_plain`` / ``flash_dkv_plain`` (the card-side reference of
    the CUDA kernels) on the same bf16 values, lse and delta."""
    causal, H, Hk, window, segmented, D, block = case
    B, S = 2, 128
    scale = 1.0 / np.sqrt(D)
    q, k, v, do = (x.transpose(0, 2, 1, 3).reshape(-1, S, D)
                   for x in _inputs(B, S, H, Hk, D, seed=31 + D + H + Hk))
    qs = ks = None
    if segmented:
        seg, kv_seg = _segments(B, S)
        qs = np.repeat(seg, H, axis=0)[..., None]
        ks = np.repeat(kv_seg, Hk, axis=0)[..., None]
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    jqs = None if qs is None else jnp.asarray(qs)
    jks = None if ks is None else jnp.asarray(ks)
    geo = dict(scale=scale, causal=causal, block_q=block, block_k=block,
               interpret=True, q_seg=jqs, kv_seg=jks, window=window)
    jo, jl = jfa._flash_bh_fwd(jq, jk, jv, **geo)
    jdq, jdk, jdv = jfa._flash_bh_bwd(jq, jk, jv, jo, jl, jdo, **geo)

    def bf16(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)

    tq, tk, tv, tdo, to = (bf16(x) for x in (jq, jk, jv, jdo, jo))
    lse = torch.from_numpy(np.array(jl))
    delta = (tdo.float() * to.float()).sum(-1, keepdim=True)
    tqs = None if qs is None else torch.from_numpy(qs)
    tks = None if ks is None else torch.from_numpy(ks)
    args = (lse, delta, scale, causal, window, tqs, tks)
    got = (_kernels.flash_dq_plain(tq, tk, tv, tdo, *args),
           *_kernels.flash_dkv_plain(tq, tk, tv, tdo, *args))
    for name, a, b in zip(("dq", "dk", "dv"), got, (jdq, jdk, jdv)):
        assert a.dtype == torch.bfloat16, name
        a = a.float().numpy()
        b = np.asarray(b, np.float32)
        d = np.abs(a - b)
        worst = (d / (BF16_ATOL + BF16_RTOL * np.abs(b))).max()
        assert worst <= 1.0, f"d{name}: worst element {worst:.3g} of limit"
        for r0 in range(0, S, 64):
            num = np.linalg.norm(d[:, r0:r0 + 64], axis=(1, 2))
            den = np.linalg.norm(b[:, r0:r0 + 64], axis=(1, 2))
            tile = (num / np.maximum(den, 1e-30)).max()
            assert tile <= BF16_TILE, f"d{name} rows {r0}+: tile {tile:.3g}"
    if segmented:
        pad = qs[:, :, 0] == -1
        assert np.all(got[0].float().numpy()[pad] == 0.0)
        assert np.all(np.asarray(jdq, np.float32)[pad] == 0.0)


def test_dense_fallback_outside_gate_matches_reference():
    """A block that does not divide S leaves the kernel gate: both
    packages take their dense counterpart."""
    q, k, v, _ = _inputs(1, 96, 2, 2, 32, seed=3)
    jo = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                             causal=True, block_q=64, block_k=64,
                             interpret=True, window=30)
    to = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=True, block_q=64, block_k=64, window=30)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL_FWD,
                               rtol=ATOL_FWD)


def test_block_policy_matches_reference():
    for S in (64, 100, 192, 256, 384, 2048, 2688, 4096, 8192):
        assert tfa.auto_block_size(S) == jfa.auto_block_size(S), S
    for S in (8, 64, 192, 256, 384, 512, 2048, 8192):
        assert tfa.flash_block_plan(S, 64) == jfa.flash_block_plan(
            S, 64, jnp.float32, False), S
    assert tfa.flash_block_plan(1024, 320) == (False, 0)


def test_layout_helpers_match_reference():
    x = np.random.RandomState(0).randn(2, 8, 3, 4).astype(np.float32)
    bh = tfa.to_bh(torch.from_numpy(x))
    np.testing.assert_array_equal(bh.numpy(), np.asarray(jfa.to_bh(x)))
    np.testing.assert_array_equal(tfa.from_bh(bh, 2, 3).numpy(), x)
    ids = np.array([[0, 0, 1, -1], [2, 2, 2, 2]], np.int32)
    np.testing.assert_array_equal(
        tfa.seg_to_bh(torch.from_numpy(ids), 3).numpy(),
        np.asarray(jfa.seg_to_bh(jnp.asarray(ids), 3)))
    np.testing.assert_array_equal(
        tfa.segment_mask(torch.from_numpy(ids), torch.from_numpy(ids)).numpy(),
        np.asarray(jfa.segment_mask(jnp.asarray(ids), jnp.asarray(ids))))


def test_validation_matches_reference():
    q, k, v, _ = _inputs(1, 64, 4, 2, 16, seed=0)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    with pytest.raises(ValueError, match="divide"):
        tfa.flash_attention(tq, tk[:, :, :1], tv, causal=True)
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(tq, tk, tv, causal=False, window=4)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(tq, tk, tv, causal=True, window=0)
    with pytest.raises(ValueError, match="together"):
        tfa.flash_attention(tq, tk, tv, q_segment_ids=torch.zeros(1, 64))
    with pytest.raises(ValueError, match="divide"):
        tfa.flash_attention_with_lse(tfa.to_bh(tq), tfa.to_bh(tk),
                                     tfa.to_bh(tv), 0.25, True, 48, 64)


def test_adapter_segment_ids_broadcast_and_batch_check():
    q, k, v, _ = _inputs(2, 64, 2, 2, 16, seed=1)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    ids = np.zeros(64, np.int32)
    ids[32:] = 1
    fn = tfa.make_flash_attention_fn(causal=True,
                                     q_segment_ids=torch.from_numpy(ids))
    want = tfa.flash_attention(
        tq, tk, tv, causal=True,
        q_segment_ids=torch.from_numpy(np.stack([ids, ids])),
        kv_segment_ids=torch.from_numpy(np.stack([ids, ids])))
    np.testing.assert_array_equal(fn(tq, tk, tv, None).numpy(), want.numpy())
    bad = tfa.make_flash_attention_fn(
        q_segment_ids=torch.zeros(3, 64, dtype=torch.int32))
    with pytest.raises(ValueError, match="batch"):
        bad(tq, tk, tv)


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers take the plain twins and count nothing:
    the counters move only where a CUDA kernel launches."""
    _kernels.reset_launch_counts()
    q, k, v, do = _inputs(1, 64, 2, 2, 16, seed=2)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tfa.flash_attention(tq, tk, tv).backward(torch.from_numpy(do))
    assert _kernels.LAUNCHES == {"flash_fwd": 0, "flash_dq": 0,
                                 "flash_dkv": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(2, 64, 16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _kernels.flash_fwd(q.double(), q.double(), q.double(), 0.25, True)
    with pytest.raises(ValueError, match="multiple"):
        _kernels.flash_fwd(torch.zeros(3, 64, 16), q, q, 0.25, True)
    with pytest.raises(TypeError, match="int32"):
        _kernels.flash_fwd(q, q, q, 0.25, True, None,
                           torch.zeros(2, 64, 1), torch.zeros(2, 64, 1))
