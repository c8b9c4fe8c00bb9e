"""The one-pass RMSNorm and RMSNorm + RoPE ops (``ops.rms_norm``): their
plain twins against the two-step arithmetic they replace, kept here as the
plain formula; the twins' gradients; ``opcheck``; the ops an AFMoE step
calls.

Imports only torch and the port, so the card runs it without the suite's
conftest (which imports JAX): ``python -m pytest --noconftest
tests/test_torch_rms_norm.py -q -k cuda`` holds each Triton kernel to its
twin at the Trinity cell's widths, counts the launches of an AFMoE
micro-batch, and runs the kernels with CUDA's synchronising calls made
errors."""

import collections

import pytest
import torch

from chainermn_tpu_torch.models.afmoe import AFMoELM, SLIDING, rope_tables
from chainermn_tpu_torch.ops import rms_norm as rn

EPS = 1e-5


# -- the arithmetic the ops replace: a norm, then a rotation ------------------


def _old_norm(x, w, out_dtype):
    xf = x.float()
    rstd = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + EPS)
    return (xf * rstd * w.float()).to(out_dtype), rstd


def _old_norm_bwd(dy, x, w, rstd):
    xhat = x.float() * rstd
    dyf = dy.float()
    dyw = dyf * w.float()
    dx = rstd * (dyw - xhat * (dyw * xhat).mean(-1, keepdim=True))
    dw = (dyf * xhat).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw


def _old_rope(x, cos, sin):
    xf = x.float()
    a, b = xf.chunk(2, dim=-1)
    return (xf * cos[:, None] + torch.cat([-b, a], dim=-1)
            * sin[:, None]).to(x.dtype)


def _old_rope_bwd(dy, cos, sin):
    dyf = dy.float()
    a, b = (dyf * sin[:, None]).chunk(2, dim=-1)
    return (dyf * cos[:, None] + torch.cat([b, -a], dim=-1)).to(dy.dtype)


def _old(x, w, out_dtype, dy, rope):
    """(y, dx, dw) of the two-step form: the norm rounded to ``out_dtype``,
    then RoPE in fp32 rounded again; the backward the same way back."""
    y, rstd = _old_norm(x, w, out_dtype)
    g = dy
    if rope is not None:
        y = _old_rope(y, *rope)
        g = _old_rope_bwd(dy, *rope)
    return (y, *_old_norm_bwd(g, x, w, rstd))


def _case(width, in_dtype, rope, seed=0, S=16):
    """x as (B, S, H, width) head rows with RoPE, else (B, S, width)."""
    g = torch.Generator().manual_seed(seed)
    shape = (2, S, 3, width) if rope else (2, S, width)
    x = (torch.randn(shape, generator=g) * 3).to(in_dtype)
    w = 1 + 0.1 * torch.randn(width, generator=g)
    dy = torch.randn(shape, generator=g)
    tables = rope_tables(S, width, 10000.0, "cpu") if rope else None
    return x, w, dy, tables


def _new(x, w, out_dtype, dy, rope):
    x = x.clone().requires_grad_()
    w = w.clone().requires_grad_()
    y = rn.rms_norm(x, w, EPS, out_dtype, rope)
    y.backward(dy.to(out_dtype))
    return y.detach(), x.grad, w.grad


CASES = [(width, in_dt, out_dt, rope)
         for width, rope in ((2048, False), (128, False), (128, True))
         for in_dt in (torch.float32, torch.bfloat16)
         for out_dt in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("width,in_dtype,out_dtype,rope", CASES)
def test_twins_against_the_two_step_arithmetic(width, in_dtype, out_dtype,
                                               rope):
    """Bitwise wherever the two-step form rounds nothing in between (no
    RoPE, or an fp32 result); with RoPE into bf16 the one rounding lands
    closer to the fp64 result than the two did, and within one bf16 unit
    of the old result."""
    x, w, dy, tables = _case(width, in_dtype, rope)
    got = _new(x, w, out_dtype, dy, tables)
    want = _old(x, w, out_dtype, dy.to(out_dtype), tables)
    if not rope or out_dtype == torch.float32:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        return
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -7,
                                   atol=2 ** -7 * b.float().abs().max())
    exact = _new(x.double(), w.double(), torch.float64,
                 dy.to(out_dtype).double(),
                 tuple(t.double() for t in tables))
    for a, b, e in zip(got, want, exact):
        assert (a.double() - e).norm() <= (b.double() - e).norm()


@pytest.mark.parametrize("rope", [False, True])
def test_twin_gradients_in_fp64(rope):
    x, w, _, tables = _case(8, torch.float64, rope, S=4)
    x, w = x.requires_grad_(), w.double().requires_grad_()
    if tables is not None:
        tables = tuple(t.double() for t in tables)
    assert torch.autograd.gradcheck(
        lambda a, b: rn.rms_norm(a, b, EPS, torch.float64, tables), (x, w))


def _op_args(case):
    """The op and its arguments for a case named as its launches count."""
    x, w, dy, tables = _case(128, torch.bfloat16, "rope" in case, S=8)
    y, rstd = rn.rms_fwd_plain(x, w, EPS, torch.bfloat16,
                               *(tables or ()))
    dy = dy.to(torch.bfloat16)
    return {"rms_fwd": ("rms_fwd", (x, w, EPS, torch.bfloat16)),
            "rms_rope_fwd": ("rms_fwd", (x, w, EPS, torch.float32,
                                         *(tables or ()))),
            "rms_bwd": ("rms_bwd", (dy, x, w, rstd)),
            "rms_rope_bwd": ("rms_bwd", (dy, x, w, rstd,
                                         *(tables or ())))}[case]


@pytest.mark.parametrize("op", ["rms_fwd", "rms_rope_fwd", "rms_bwd",
                                "rms_rope_bwd"])
def test_opcheck_passes(op):
    name, args = _op_args(op)
    torch.library.opcheck(getattr(torch.ops.chainermn_torch, name), args)


SMALL = dict(vocab=64, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2,
             d_head=16, d_ff=96, d_expert=32, n_experts=8, top_k=2,
             n_dense_layers=1, layer_types=[SLIDING] * 3 + ["full_attention"],
             window=8)


def _norm_calls(model, toks):
    from torch.utils._python_dispatch import TorchDispatchMode

    calls = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__.split(".")[0]
            if name.startswith("rms_") and (len(args) > 4
                                            and args[4] is not None):
                name = name.replace("rms_", "rms_rope_")
            calls.append(name)
            return func(*args, **(kwargs or {}))

    with Count():
        model(toks).float().sum().backward()
    return collections.Counter(c for c in calls if c.startswith("rms_"))


def _want_calls(L, sliding):
    """Each way: four block norms a layer and the final one, two head norms
    a layer, the head norms of the sliding layers with RoPE."""
    plain = 4 * L + 1 + 2 * (L - sliding)
    return {"rms_fwd": plain, "rms_bwd": plain,
            "rms_rope_fwd": 2 * sliding, "rms_rope_bwd": 2 * sliding}


def test_an_afmoe_step_runs_every_norm_through_the_ops():
    model = AFMoELM(**SMALL, dtype=torch.float32, device="cpu")
    toks = torch.randint(0, SMALL["vocab"], (2, 12))
    assert _norm_calls(model, toks) == _want_calls(4, 3)
    for name, p in model.named_parameters():
        if "norm" in name:
            assert p.grad is not None and torch.isfinite(p.grad).all(), name


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(got, want):
    """(max gap / max, norm gap / norm), in fp32."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item(), \
        ((got - want).norm() / want.norm()).item()


def _kernel_case(dev, shape, in_dtype, rope, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, device=dev, generator=g) * 3).to(in_dtype)
    w = 1 + 0.1 * torch.randn(shape[-1], device=dev, generator=g)
    dy = torch.randn(shape, device=dev, generator=g)
    tables = (rope_tables(shape[1], shape[-1], 10000.0, dev)
              if rope else ())
    return x, w, dy, tables


#: The Trinity cell's rows, one micro-batch (4 x 4096 tokens): the block
#: norms 2048 wide both ways between the fp32 residual and bf16, the q and
#: k head norms (32 and 4 heads of 128) in bf16 with RoPE and without.
CELL_CASES = [((4, 4096, 2048), torch.float32, torch.bfloat16, False),
              ((4, 4096, 2048), torch.bfloat16, torch.float32, False),
              ((4, 4096, 32, 128), torch.bfloat16, torch.bfloat16, True),
              ((4, 4096, 32, 128), torch.bfloat16, torch.bfloat16, False),
              ((4, 4096, 4, 128), torch.bfloat16, torch.bfloat16, True),
              ((4, 4096, 4, 128), torch.bfloat16, torch.bfloat16, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,in_dtype,out_dtype,rope", CELL_CASES)
def test_cuda_kernels_match_their_twins_at_the_cell_widths(
        cuda, shape, in_dtype, out_dtype, rope):
    """Kernel and twin differ in the order of the row sums alone, so a
    result in bf16 may land one unit (2^-8 of the largest entry's binade,
    under 2^-7 of the largest entry) apart where the fp32 values straddle
    a rounding point, and by 1e-3 of the norm at most; an fp32 result or
    statistic within 1e-5 of the largest entry; ``dw`` sums 16384 rows in
    another order, within 1e-5 of its norm."""
    x, w, dy, tables = _kernel_case(cuda, shape, in_dtype, rope)
    dy = dy.to(out_dtype)
    fwd = "rms_rope_fwd" if rope else "rms_fwd"
    bwd = "rms_rope_bwd" if rope else "rms_bwd"
    ops = torch.ops.chainermn_torch
    rn.reset_launch_counts()
    y, rstd = ops.rms_fwd(x, w, EPS, out_dtype, *tables)
    dx, dw = ops.rms_bwd(dy, x, w, rstd, *tables)
    torch.cuda.synchronize()
    assert rn.LAUNCHES == {**dict.fromkeys(rn.LAUNCHES, 0), fwd: 1, bwd: 1,
                           "rms_dw": 1}
    wy, wrstd = rn.rms_fwd_plain(x, w, EPS, out_dtype, *tables)
    wdx, wdw = rn.rms_bwd_plain(dy, x, w, wrstd, *tables)
    assert y.dtype == out_dtype and dx.dtype == in_dtype
    assert dw.dtype == torch.float32 and rstd.shape == wrstd.shape

    def limit(t):
        return (2 ** -7, 1e-3) if t.dtype == torch.bfloat16 else (1e-5, 1e-5)

    for name, a, b in (("y", y, wy), ("rstd", rstd, wrstd), ("dx", dx, wdx),
                       ("dw", dw, wdw)):
        top, norm = _rel(a, b)
        lim = limit(a)
        assert top <= lim[0] and norm <= lim[1], (name, top, norm)


@pytest.mark.cuda
def test_cuda_backward_is_bitwise_deterministic(cuda):
    for shape, in_dtype, out_dtype, rope in CELL_CASES[1:3]:
        x, w, dy, tables = _kernel_case(cuda, shape, in_dtype, rope, seed=1)
        dy = dy.to(out_dtype)
        y, rstd = rn.rms_fwd_plain(x, w, EPS, out_dtype, *tables)
        op = torch.ops.chainermn_torch.rms_bwd
        a, b = op(dy, x, w, rstd, *tables), op(dy, x, w, rstd, *tables)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_cuda_afmoe_micro_batch_launches(cuda):
    """One micro-batch of a small AFMoE in bf16 on the card, forward and
    backward: every norm through the kernels, RoPE on the sliding layers'
    head norms alone, one ``dw`` pass a backward launch."""
    from chainermn_tpu_torch.ops import moe_dispatch

    cfg = dict(SMALL, d_model=256, n_heads=4, n_kv_heads=2, d_head=64,
               d_ff=512, d_expert=128, window=64)
    model = AFMoELM(**cfg, dtype=torch.bfloat16, device=cuda)
    moe_dispatch.warm_up(cuda, cfg["d_model"], cfg["top_k"])
    toks = torch.randint(0, cfg["vocab"], (2, 256), device=cuda)
    rn.reset_launch_counts()
    model(toks).float().sum().backward()
    torch.cuda.synchronize()
    want = _want_calls(4, 3)
    assert rn.LAUNCHES == {**want, "rms_dw": want["rms_bwd"]
                           + want["rms_rope_bwd"]}


@pytest.mark.cuda
def test_cuda_kernels_never_synchronise(cuda):
    """The cell's widest rows and its q heads, forward and backward through
    autograd, with CUDA's synchronising calls made errors."""
    cases = [_kernel_case(cuda, (4, 4096, 2048), torch.float32, False),
             _kernel_case(cuda, (4, 4096, 32, 128), torch.bfloat16, True)]

    def run():
        for x, w, dy, tables in cases:
            xg = x.detach().requires_grad_()
            wg = w.detach().requires_grad_()
            rn.rms_norm(xg, wg, EPS, torch.bfloat16, tables or None).backward(
                dy.to(torch.bfloat16))

    run()                                  # compiles the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x, w, dy, (cos, sin) = _kernel_case(cuda, (2, 8, 2, 128), torch.bfloat16,
                                        True)
    ops = torch.ops.chainermn_torch
    with pytest.raises(ValueError, match="contiguous"):
        ops.rms_fwd(x.transpose(1, 2), w, EPS, torch.bfloat16)
    with pytest.raises(ValueError, match="weight"):
        ops.rms_fwd(x, w[:64].contiguous(), EPS, torch.bfloat16)
    with pytest.raises(ValueError, match="tables"):
        ops.rms_fwd(x, w, EPS, torch.bfloat16, cos[:4].contiguous(), sin)
    with pytest.raises(ValueError, match="RoPE"):
        ops.rms_fwd(x[..., :127].contiguous(), w[:127].contiguous(), EPS,
                    torch.bfloat16, cos, sin)
    with pytest.raises(ValueError, match="both"):
        ops.rms_fwd(x, w, EPS, torch.bfloat16, cos)
    with pytest.raises(TypeError):
        ops.rms_fwd(x.double(), w, EPS, torch.bfloat16)
