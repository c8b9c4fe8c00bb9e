"""The flash kernels as custom ops (``torch.ops.chainermn_torch.flash_*``)
on the CPU route.

Each op gives its plain twin's outputs bitwise (the op's CPU body is the
twin), ``torch.library.opcheck`` passes on its schema, fake
implementation and dispatch, ``_FlashBH``'s gradients equal those of the
twins composed by hand (the autograd function only routes through the
ops), and a dispatch mode sees each op with its real inputs and outputs.
The same on the card: ``tests/test_torch_kernels_cuda.py``.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from chainermn_tpu_torch.ops import _kernels
from chainermn_tpu_torch.ops.flash_attention import (_FlashBH,
                                                     flash_attention, to_bh)

CASES = {
    # BH, BHk, S, D, dtype, causal, window, segments
    "plain": (4, 4, 32, 16, torch.float32, True, None, False),
    "gqa_window": (4, 2, 48, 8, torch.float32, True, 8, False),
    "segments_bf16": (2, 2, 32, 16, torch.bfloat16, False, None, True),
}


def _case(name, seed=0):
    BH, BHk, S, D, dtype, causal, window, seg = CASES[name]
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(BH, S, D, generator=g).to(dtype)
    k = torch.randn(BHk, S, D, generator=g).to(dtype)
    v = torch.randn(BHk, S, D, generator=g).to(dtype)
    do = torch.randn(BH, S, D, generator=g).to(dtype)
    qs = ks = None
    if seg:
        ids = torch.repeat_interleave(torch.arange(4, dtype=torch.int32),
                                      S // 4)
        ids[-3:] = 9          # padding rows: no key matches
        qs = ids.repeat(BH, 1)[..., None].contiguous()
        ks = torch.repeat_interleave(torch.arange(4, dtype=torch.int32),
                                     S // 4).repeat(BHk, 1)[..., None] \
            .contiguous()
    return q, k, v, do, 1.0 / D ** 0.5, causal, window, qs, ks


@pytest.mark.parametrize("name", sorted(CASES))
def test_ops_give_the_plain_twins_bitwise(name):
    q, k, v, do, scale, causal, window, qs, ks = _case(name)
    ops = torch.ops.chainermn_torch
    o, lse = ops.flash_fwd(q, k, v, scale, causal, window, qs, ks)
    o_p, lse_p = _kernels.flash_fwd_plain(q, k, v, scale, causal, window,
                                          qs, ks)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dq = ops.flash_dq(q, k, v, do, lse, delta, scale, causal, window, qs, ks)
    dk, dv = ops.flash_dkv(q, k, v, do, lse, delta, scale, causal, window,
                           qs, ks)
    assert torch.equal(dq, _kernels.flash_dq_plain(
        q, k, v, do, lse, delta, scale, causal, window, qs, ks))
    dk_p, dv_p = _kernels.flash_dkv_plain(q, k, v, do, lse, delta, scale,
                                          causal, window, qs, ks)
    assert torch.equal(dk, dk_p) and torch.equal(dv, dv_p)
    assert dk.shape == k.shape and dv.dtype == v.dtype


@pytest.mark.parametrize("name", sorted(CASES))
def test_opcheck_passes(name):
    q, k, v, do, scale, causal, window, qs, ks = _case(name)
    ops = torch.ops.chainermn_torch
    o, lse = ops.flash_fwd(q, k, v, scale, causal, window, qs, ks)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    for op, args in (
            (ops.flash_fwd, (q, k, v, scale, causal, window, qs, ks)),
            (ops.flash_dq, (q, k, v, do, lse, delta, scale, causal, window,
                            qs, ks)),
            (ops.flash_dkv, (q, k, v, do, lse, delta, scale, causal, window,
                             qs, ks))):
        res = torch.library.opcheck(op, args)
        assert set(res.values()) == {"SUCCESS"}, (op, res)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_bh_gradients_unchanged(name):
    """``_FlashBH`` through the ops against the twins composed by hand:
    the outputs and all three gradients bitwise."""
    q, k, v, do, scale, causal, window, qs, ks = _case(name)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = _FlashBH.apply(*leaves, qs, ks, scale, causal, window)
    o.backward(do)
    o_p, lse_p = _kernels.flash_fwd_plain(q, k, v, scale, causal, window,
                                          qs, ks)
    delta = (do.float() * o_p.float()).sum(-1, keepdim=True)
    want = (_kernels.flash_dq_plain(q, k, v, do, lse_p, delta, scale,
                                    causal, window, qs, ks),
            *_kernels.flash_dkv_plain(q, k, v, do, lse_p, delta, scale,
                                      causal, window, qs, ks))
    assert torch.equal(o.detach(), o_p) and torch.equal(lse.detach(), lse_p)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


class _Seen(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((str(func), [tuple(a.shape) for a in args
                                     if isinstance(a, torch.Tensor)],
                         out))
        return out


def test_a_dispatch_mode_sees_each_op_with_its_inputs_and_outputs():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 32, 4, 8, generator=g).requires_grad_(True)
               for _ in range(3))
    with _Seen() as seen:
        out = flash_attention(q, k, v, causal=True)
        out.sum().backward()
    names = [n for n, _, _ in seen.ops]
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        assert names.count(f"chainermn_torch.{name}.default") == 1, names
    fwd = next(x for x in seen.ops
               if x[0] == "chainermn_torch.flash_fwd.default")
    assert fwd[1] == [tuple(to_bh(q).shape)] * 3
    o, lse = fwd[2]
    assert o.shape == (8, 32, 8) and lse.shape == (8, 32, 1)
