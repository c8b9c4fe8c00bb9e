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
    args = (D ** -0.5, True, 17, qs, ks)
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
