"""The hand-written CUDA kernels on the card, against their plain twins.

Imports only torch and the port, so it also runs where JAX is absent:
on the card, ``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``
(the suite's conftest imports JAX).  Without a CUDA device every test
skips.  Tolerances, as in ``chip_smoke.py``: every element within
``atol + rtol * |twin|`` and every 64-row tile of a head within a
normalized error ``||a - b|| / ||b||``.  bf16: atol 2^-6 (kernel and
twin round P to bf16 from fp32 values that differ in their last bits, so
a P near 1 can land one ulp, 2^-8, apart, times an operand up to about
4), rtol 2e-2 (the outputs' own bf16 rounding), tile 1e-2 (isolated
flips pass; an error spread over a tile does not).  fp32: atol 2e-5,
rtol 1e-4, tile 1e-5 (summation order).  The fp32 row LSE within 1e-4.

bf16 at D in {64, 128} runs the Hopper forward, dQ and dK/dV kernels
(TMA ring, wgmma); the cases below reach their special tiles: S not a
multiple of the 128-row tile, GQA, a window band, segment ids with
padding rows (fully masked rows), causal and not.
"""

import pytest
import torch

from chainermn_tpu_torch.ops import _kernels
from chainermn_tpu_torch.ops.flash_attention import (
    dense_attention,
    flash_attention,
)

TOL = {"bfloat16": (2 ** -6, 2e-2, 1e-2), "float32": (2e-5, 1e-4, 1e-5)}


def _worst_tile_l2(a, b, tile=64):
    return max(
        ((x - y).norm(dim=(1, 2)) / y.norm(dim=(1, 2)).clamp_min(1e-30))
        .max().item()
        for x, y in zip(a.split(tile, dim=1), b.split(tile, dim=1)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


def _rand(shape, dtype, device, gen):
    return torch.randn(*shape, generator=gen).to(device, dtype)


def _check_against_twins(q, k, v, do, args, dtype):
    """Every kernel once against its twin on one case, with the limits
    above; returns the kernels' (o, lse, dq, dk, dv)."""
    before = dict(_kernels.LAUNCHES)
    o, lse = _kernels.flash_fwd(q, k, v, *args)
    o_p, lse_p = _kernels.flash_fwd_plain(q, k, v, *args)
    delta = (do.float() * o_p.float()).sum(-1, keepdim=True)
    got = (o, lse, _kernels.flash_dq(q, k, v, do, lse_p, delta, *args),
           *_kernels.flash_dkv(q, k, v, do, lse_p, delta, *args))
    want = (o_p, lse_p, _kernels.flash_dq_plain(q, k, v, do, lse_p, delta,
                                                *args),
            *_kernels.flash_dkv_plain(q, k, v, do, lse_p, delta, *args))
    atol, rtol, tile = TOL[dtype]
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=0)
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        if name != "lse":
            a, b = a.float(), b.float()
            torch.testing.assert_close(a, b, atol=atol, rtol=rtol,
                                       msg=lambda m: f"{name}: {m}")
            assert _worst_tile_l2(a, b) <= tile, name
    for name in before:
        assert _kernels.LAUNCHES[name] == before[name] + 1
    return got


def _segments(S, BH, BHk, device):
    """Three segments; the last sixth of the rows is padding whose ids
    match no key, so those query rows are fully masked."""
    ids = torch.zeros(S, dtype=torch.int32)
    ids[S // 3: 2 * S // 3] = 1
    ids[5 * S // 6:] = -1
    kids = ids.clone()
    kids[kids == -1] = -2
    return (ids[None, :, None].repeat(BH, 1, 1).to(device),
            kids[None, :, None].repeat(BHk, 1, 1).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [64, 128, 96])
def test_kernels_match_plain_twins(cuda, dtype, D):
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(D)
    q, do = (_rand((8, 256, D), dt, cuda, g) for _ in range(2))
    k, v = (_rand((4, 256, D), dt, cuda, g) for _ in range(2))
    ids = torch.zeros(4, 256, 1, dtype=torch.int32)
    ids[:, 128:] = 1
    qs, ks = ids.repeat(2, 1, 1).to(cuda), ids.to(cuda)
    _check_against_twins(q, k, v, do, (D ** -0.5, True, 17, qs, ks), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [200, 320])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window,seg", [(None, False), (17, False),
                                        (None, True)])
def test_hopper_kernels_special_tiles(cuda, D, S, causal, window, seg):
    """GQA G = 4 at a ragged S against the twins, through the wgmma
    routes; with segments, the padding rows come out o = 0, lse ~ -1e30
    and dq = 0."""
    bf16 = torch.bfloat16
    assert [_kernels.route(n, bf16, D) for n in
            ("flash_fwd", "flash_dq", "flash_dkv")] == ["wgmma", "wgmma",
                                                        "wgmma"]
    g = torch.Generator().manual_seed(S + D)
    q, do = (_rand((16, S, D), bf16, cuda, g) for _ in range(2))
    k, v = (_rand((4, S, D), bf16, cuda, g) for _ in range(2))
    qs, ks = _segments(S, 16, 4, cuda) if seg else (None, None)
    o, lse, dq, _, _ = _check_against_twins(
        q, k, v, do, (D ** -0.5, causal, window, qs, ks), "bfloat16")
    if seg:
        dead = qs[0, :, 0] == -1
        assert dead.any()
        assert o[:, dead].abs().max().item() == 0.0
        assert lse[:, dead].max().item() < -1e29
        assert dq[:, dead].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_hopper_kernels_are_bitwise_deterministic(cuda, D):
    """Two launches on the same inputs give identical bytes: each block
    writes only its own rows (the dK/dV kernel reduces the GQA group inside
    the block), with no atomics."""
    bf16 = torch.bfloat16
    g = torch.Generator().manual_seed(D)
    q, do = (_rand((16, 320, D), bf16, cuda, g) for _ in range(2))
    k, v = (_rand((4, 320, D), bf16, cuda, g) for _ in range(2))
    qs, ks = _segments(320, 16, 4, cuda)
    args = (D ** -0.5, True, None, qs, ks)
    o1, lse1 = _kernels.flash_fwd(q, k, v, *args)
    o2, lse2 = _kernels.flash_fwd(q, k, v, *args)
    delta = (do.float() * o1.float()).sum(-1, keepdim=True)
    dq1 = _kernels.flash_dq(q, k, v, do, lse1, delta, *args)
    dq2 = _kernels.flash_dq(q, k, v, do, lse1, delta, *args)
    dk1, dv1 = _kernels.flash_dkv(q, k, v, do, lse1, delta, *args)
    dk2, dv2 = _kernels.flash_dkv(q, k, v, do, lse1, delta, *args)
    torch.cuda.synchronize()
    for a, b in ((o1, o2), (lse1, lse2), (dq1, dq2), (dk1, dk2), (dv1, dv2)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.cuda
def test_flash_attention_autograd_matches_dense_on_the_card(cuda):
    """The public (B, S, H, D) entry point through the kernels against
    the dense counterpart, fp32, GQA, forward and all three gradients."""
    g = torch.Generator().manual_seed(0)
    q = _rand((2, 128, 4, 64), torch.float32, cuda, g).requires_grad_()
    k = _rand((2, 128, 2, 64), torch.float32, cuda, g).requires_grad_()
    v = _rand((2, 128, 2, 64), torch.float32, cuda, g).requires_grad_()
    do = _rand((2, 128, 4, 64), torch.float32, cuda, g)
    out = flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    ref = dense_attention(q, k, v, 0.125, True)
    ref_grads = torch.autograd.grad(ref, (q, k, v), do)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(2, 64, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2),
                           q, q, 0.25, True)
    wide = torch.zeros(2, 64, 264, device=cuda)
    with pytest.raises(ValueError, match="D <= 256"):
        _kernels.flash_fwd(wide, wide, wide, 0.25, True)
    with pytest.raises(ValueError, match="one device"):
        _kernels.flash_fwd(q, q.cpu(), q, 0.25, True)
