"""The AFMoE decoder (``models.afmoe``) and its dropless expert layer
(``parallel.moe.DroplessMoE``, ``ops.moe_dispatch``) against the plain
reference the benchmark uses (``portbench/reference/trinity.py``), on
seeded weights at a small size on the CPU, in fp32.

On the card, ``python -m pytest --noconftest tests/test_torch_afmoe.py -q
-k cuda`` holds the three Triton kernels to their plain twins, the grouped
products to theirs, and one expert layer at the cell's widths to no host
synchronisation."""

import collections
import os
import sys

import pytest
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chainermn_tpu_torch.models.afmoe import AFMoELM, SLIDING  # noqa: E402
from chainermn_tpu_torch.observability import reporter as rep_mod  # noqa: E402
from chainermn_tpu_torch.ops import moe_dispatch as md  # noqa: E402
from chainermn_tpu_torch.parallel.moe import DroplessMoE  # noqa: E402
from portbench import inputs  # noqa: E402
from portbench.reference.trinity import RefTrinity  # noqa: E402

TYPES = [SLIDING] * 3 + ["full_attention"]
SMALL = dict(vocab=64, d_model=64, n_layers=8, n_heads=4, n_kv_heads=2,
             d_head=16, d_ff=96, d_expert=32, n_experts=16, top_k=4,
             n_dense_layers=2, layer_types=TYPES * 2, window=8)
ROUTE_SCALE, RATE = 2.826, 1e-3


def _program(first=0, held=16, **kw):
    return AFMoELM(**SMALL, route_scale=ROUTE_SCALE, bias_rate=RATE,
                   first_expert=first, held_experts=held,
                   dtype=torch.float32, device="cpu", **kw)


def _reference(first=0, held=16):
    s = SMALL
    return RefTrinity(s["vocab"], s["d_model"], s["n_layers"], s["n_heads"],
                      s["n_kv_heads"], s["d_head"], s["d_ff"],
                      s["d_expert"], s["n_experts"], held, first,
                      s["top_k"], s["n_dense_layers"], s["layer_types"],
                      s["window"], 10000.0, 1e-5, ROUTE_SCALE, RATE, 1,
                      s["d_model"] ** 0.5, attn_block=8, loss_block=16)


def _load(seed, *mods):
    specs = inputs.weight_specs(mods[-1])
    w = inputs.make_weights(specs, seed, "cpu")
    for m in mods:
        with torch.no_grad():
            for n, t in m.state_dict().items():
                t.copy_(w[n])
    return w


def _tokens(seed, B=2, S=32):
    g = torch.Generator().manual_seed(seed)
    t = torch.randint(0, SMALL["vocab"], (B, S + 1), generator=g)
    return t[:, :-1], t[:, 1:]


def _loss(model, toks, labs):
    logits = model(toks)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labs.reshape(-1))


@pytest.mark.parametrize("seed", [3, 11])
def test_loss_and_gradients_match_the_reference(seed):
    prog, ref = _program(), _reference()
    assert set(prog.state_dict()) == {n for n, _ in
                                      inputs.weight_specs(ref)}
    _load(seed, prog, ref)
    toks, labs = _tokens(seed)
    lp = _loss(prog, toks, labs)
    lp.backward()
    lr = ref(toks, labs)
    lr.backward()
    assert abs(lp.item() - lr.item()) <= 1e-6 * abs(lr.item())
    rp = dict(ref.named_parameters())
    for n, p in prog.named_parameters():
        err = (p.grad - rp[n].grad).norm() / rp[n].grad.norm()
        assert err < 2e-5, (n, err.item())
    for a, b in zip(prog.moe_layers(), [blk.mlp for blk in ref.layers[2:]]):
        assert torch.equal(a.counts.double(), b.counts.to(torch.float64))


def _layers(first=0, count=16, seed=5, bias=None):
    torch.manual_seed(seed)
    m = DroplessMoE(64, 32, 16, 4, first=first, count=count,
                    route_scale=ROUTE_SCALE, bias_rate=RATE,
                    dtype=torch.float32)
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0.0, p.shape[-1] ** -0.5)
        if bias is not None:
            m.expert_bias.copy_(bias)
    return m


def test_routing_bias_and_gates_exactly():
    bias = torch.zeros(16)
    bias[5] = 10.0                       # expert 5 always chosen
    m = _layers(bias=bias)
    ref = _reference()
    rm = ref.layers[2].mlp
    with torch.no_grad():
        rm.router.weight.copy_(m.router.weight)
        rm.expert_bias.copy_(m.expert_bias)
    x = torch.randn(40, 64)
    idx, g = m.route(x)
    ridx, rg = ref.route(rm, x)
    assert torch.equal(idx, ridx)
    torch.testing.assert_close(g, rg, rtol=1e-6, atol=0)
    s = torch.sigmoid(x @ m.router.weight.t())
    assert (idx == 5).any(-1).all()
    chosen = s.gather(1, idx)
    # The bias selects and never weighs: gates are the scaled scores.
    torch.testing.assert_close(
        g, ROUTE_SCALE * chosen / chosen.sum(-1, keepdim=True))
    torch.testing.assert_close(g.sum(-1), torch.full((40,), ROUTE_SCALE))
    want = torch.topk(s + bias, 4, dim=-1).indices
    assert torch.equal(idx, want)


def _oracle(m, x, first, count):
    """Every held expert on every token, the unchosen weighted 0."""
    idx, g = m.route(x)
    F_, D = m.d_expert, m.d_model
    out = torch.zeros_like(x)
    for e in range(count):
        w = torch.where(idx == first + e, g, torch.zeros_like(g)).sum(-1)
        wg = m.experts_gate[e * F_:(e + 1) * F_]
        wu = m.experts_up[e * F_:(e + 1) * F_]
        wd = m.experts_down[e * D:(e + 1) * D]
        out = out + w[:, None] * ((F.silu(x @ wg.t()) * (x @ wu.t())) @ wd.t())
    return out


@pytest.mark.parametrize("skew", [0.0, 50.0])
def test_dropless_every_assignment_is_computed(skew):
    bias = torch.zeros(16)
    bias[:4] = skew              # skewed: every token on experts 0-3
    m = _layers(bias=bias)
    x = torch.randn(48, 64)
    idx, _ = m.route(x)
    plan = md.dispatch_plan(idx, 0, 16)
    assert int(plan.sizes.sum()) == idx.numel()
    assert int((plan.pos >= 0).sum()) == idx.numel()
    assert torch.equal(torch.sort(plan.src[plan.src >= 0]).values,
                       torch.arange(48).repeat_interleave(4).int())
    got = m(x) - m.shared(x)
    torch.testing.assert_close(got, _oracle(m, x, 0, 16), rtol=1e-5,
                               atol=1e-5)


def test_the_shares_add_up_to_the_uncut_layer():
    """Experts 0-7 and 8-15 on two layers, the shared expert counted once,
    give what the layer holding all 16 gives."""
    whole = _layers()
    halves = [_layers(first=0, count=8), _layers(first=8, count=8)]
    sd = whole.state_dict()
    for h in halves:
        with torch.no_grad():
            for n, t in h.state_dict().items():
                if n.startswith("experts_"):
                    rows = t.shape[0]
                    start = h.first * rows // h.count
                    t.copy_(sd[n][start:start + rows])
                else:
                    t.copy_(sd[n])
    x = torch.randn(64, 64)
    parts = halves[0](x) + halves[1](x) - whole.shared(x)
    torch.testing.assert_close(parts, whole(x), rtol=1e-5, atol=1e-5)
    ref = _reference()
    _load(2, ref)
    rm = ref.layers[2].mlp
    with torch.no_grad():
        for n, t in rm.state_dict().items():
            t.copy_(sd[n])
    torch.testing.assert_close(ref._experts(rm, x[None])[0], whole(x),
                               rtol=1e-5, atol=1e-5)


def test_bias_update_sign_rule_over_microbatches():
    prog, ref = _program(), _reference()
    _load(7, prog, ref)
    opt = torch.optim.SGD(prog.parameters(), lr=0.0)
    prog.register_bias_update(opt)
    micro = [_tokens(s) for s in (1, 2)]
    for toks, labs in micro:           # the step's two micro-batches
        _loss(prog, toks, labs).backward()
        ref(toks, labs).backward()
    counts = [m.counts.clone() for m in prog.moe_layers()]
    assert all(int(c.sum()) == 2 * 2 * 32 * 4 for c in counts)
    before = [m.expert_bias.clone() for m in prog.moe_layers()]
    opt.step()
    ref.update_bias()
    for m, c, b0, blk in zip(prog.moe_layers(), counts, before,
                             ref.layers[2:]):
        torch.testing.assert_close(m.expert_bias - b0,
                                   RATE * torch.sign(c.mean() - c))
        assert torch.equal(m.expert_bias, blk.mlp.expert_bias)
        assert not m.counts.any()


def test_rope_on_sliding_layers_only():
    prog, ref = _program(), _reference()
    _load(9, prog, ref)
    kinds = [b.attention.window is not None for b in prog.layers]
    assert kinds == [t == SLIDING for t in SMALL["layer_types"]]
    u = torch.randn(2, 32, 64)
    from chainermn_tpu_torch.models.afmoe import rope_tables

    rope = rope_tables(32, 16, 10000.0, "cpu")
    for i, blk in enumerate(prog.layers[:4]):
        got = blk.attention(u, rope)
        sliding = SMALL["layer_types"][i] == SLIDING
        same = ref._attention(ref.layers[i].attention, u, sliding)
        other = ref._attention(ref.layers[i].attention, u, not sliding)
        torch.testing.assert_close(got, same, rtol=1e-5, atol=1e-5)
        assert (got - other).abs().max() > 1e-3


class _Comm:
    size = 2


def test_refuses_more_than_one_rank():
    with pytest.raises(NotImplementedError, match="all-to-all"):
        DroplessMoE(64, 32, 16, 4, count=8, comm=_Comm())
    with pytest.raises(NotImplementedError):
        _program(comm=_Comm())
    _Comm.size = 1
    DroplessMoE(64, 32, 16, 4, count=8, comm=_Comm())


def test_counters_equal_the_routing_counts():
    m = _layers(first=4, count=8)
    x = torch.randn(2, 24, 64)
    rep = rep_mod.Reporter()
    with rep_mod.scope(rep):
        m(x)
        m(x[:, :10])
    c = rep.summary()["counters"]
    held = total = load = 0
    for xs in (x, x[:, :10]):
        idx, _ = m.route(xs.reshape(-1, 64))
        hit = (idx >= 4) & (idx < 12)
        held += int(hit.sum())
        total += idx.numel()
        load += int(torch.bincount(idx[hit] - 4, minlength=8).max())
    assert c["moe/calls"] == 2
    assert c["moe/assignments_total"] == total
    assert c["moe/assignments_held"] == held
    assert c["moe/max_expert_load"] == load


def _op_calls(m, x):
    from torch.utils._python_dispatch import TorchDispatchMode

    calls = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            calls.append(str(func))
            return func(*args, **(kwargs or {}))

    with Count():
        m(x).sum().backward()
    return collections.Counter(c for c in calls if "detach" not in c)


def test_one_call_launches_the_same_ops_with_8_and_16_experts():
    """No loop over experts: one layer call, forward and backward, runs
    the same operators however many experts it holds."""
    x = torch.randn(32, 64)
    a = _op_calls(_layers(count=8), x.clone().requires_grad_())
    b = _op_calls(_layers(count=16), x.clone().requires_grad_())
    assert a == b
    for op, n in (("moe_permute", 1), ("moe_combine", 2),
                  ("moe_combine_bwd", 1)):
        assert sum(v for c, v in a.items() if op + "." in c) == n, op


def _kernel_args(dev, dtype, T=24, k=4, count=6, D=48):
    g = torch.Generator(device="cpu").manual_seed(0)
    idx = torch.randint(0, 10, (T, k), generator=g)
    idx = torch.stack([torch.randperm(10, generator=g)[:k] for _ in range(T)])
    plan = md.dispatch_plan(idx.to(dev), 2, count)
    x = torch.randn(T, D, generator=g).to(dev, dtype)
    ys = torch.randn(plan.rows, D, generator=g).to(dev, dtype)
    gates = torch.rand(T, k, generator=g).to(dev)
    w = torch.rand(plan.rows, generator=g).to(dev)
    return plan, x, ys, gates, w


@pytest.mark.parametrize("op", ["moe_permute", "moe_combine",
                                "moe_combine_bwd"])
def test_opcheck_passes(op):
    plan, x, ys, gates, w = _kernel_args("cpu", torch.float32)
    args = {"moe_permute": (x, plan.src),
            "moe_combine": (ys, plan.pos, gates),
            "moe_combine_bwd": (x, ys, plan.src, w)}[op]
    torch.library.opcheck(getattr(torch.ops.chainermn_torch, op), args)


def test_grouped_product_twin_against_a_loop():
    plan, x, _, _, _ = _kernel_args("cpu", torch.float32)
    xs = md.permute(x, plan)
    w = torch.randn(6, 48, 20)
    got = md.grouped_mm(xs, w, plan.offs)
    ends = plan.offs.tolist()
    for e, (a, b) in enumerate(zip([0] + ends, ends)):
        torch.testing.assert_close(got[a:b], xs[a:b] @ w[e])
    assert not got[ends[-1]:].any()


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.float16, torch.float16),
                                    (torch.bfloat16, torch.float32)])
def test_grouped_product_off_the_cpu_refuses_what_is_not_bf16(dtypes):
    """Off the CPU the twin (every expert for every row) is never taken:
    an operand that the library's grouped product does not take is an
    error."""
    x = torch.empty(32, 48, dtype=dtypes[0], device="meta")
    w = torch.empty(6, 48, 20, dtype=dtypes[1], device="meta")
    offs = torch.empty(6, dtype=torch.int32, device="meta")
    with pytest.raises(TypeError, match="bf16"):
        md.grouped_mm(x, w, offs)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_their_twins(cuda):
    plan, x, ys, gates, w = _kernel_args(cuda, torch.bfloat16, T=300, k=8,
                                         count=6, D=2048)
    cpu = [t.cpu() if torch.is_tensor(t) else t for t in plan]
    cplan = md.Plan(*cpu)
    md.reset_launch_counts()
    got = md._permute_op(x, plan.src)
    assert torch.equal(got.cpu(), md.permute_plain(x.cpu(), cplan.src))
    for g in (gates, None):
        got = md._combine_op(ys, plan.pos, g)
        want = md.combine_plain(ys.cpu(), cplan.pos,
                                None if g is None else g.cpu())
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=1e-2, atol=1e-2)
    dys, dw = md._combine_bwd_op(x, ys, plan.src, w)
    wd, wdw = md.combine_bwd_plain(x.cpu(), ys.cpu(), cplan.src, w.cpu())
    assert torch.equal(dys.cpu(), wd)
    torch.testing.assert_close(dw.cpu(), wdw, rtol=1e-4, atol=1e-3)
    assert md.LAUNCHES == {"moe_permute": 1, "moe_combine": 2,
                           "moe_combine_bwd": 1}


@pytest.mark.cuda
def test_cuda_grouped_products_match_the_twin(cuda):
    """Groups of every size the card may see: empty, one row, unaligned."""
    torch.manual_seed(0)
    sizes = torch.tensor([0, 1, 17, 300, 15, 64])
    idx = torch.repeat_interleave(torch.arange(6), sizes)[:, None]
    plan = md.dispatch_plan(idx.to(cuda), 0, 6)
    x = torch.randn(len(idx), 256, device=cuda).bfloat16()
    w = (torch.randn(6 * 128, 256, device=cuda) / 16).bfloat16()
    xs = md.permute(x, plan).requires_grad_()
    wv = w.view(6, 128, 256).transpose(1, 2).detach().requires_grad_()
    got = md.grouped_mm(xs, wv, plan.offs)
    n = int(plan.offs[-1])
    want = md.grouped_mm_plain(xs.float(), wv.float(), plan.offs)
    torch.testing.assert_close(got[:n].float(), want[:n], rtol=2e-2,
                               atol=2e-2)
    dy = torch.randn_like(got)
    dy[n:] = 0
    gx, gw = torch.autograd.grad(got, (xs, wv), dy)
    wx, ww = torch.autograd.grad(want, (xs, wv), dy.float())
    torch.testing.assert_close(gx[:n].float(), wx[:n].float(), rtol=3e-2,
                               atol=3e-2)
    torch.testing.assert_close(gw.float(), ww.float(), rtol=3e-2, atol=3e-1)


@pytest.mark.cuda
def test_cuda_expert_layer_at_the_cell_widths_never_synchronises(cuda):
    """One expert layer of the benchmark's Trinity cell (2048 wide, 64 of
    128 experts of 1024, top 8, the shared expert) over 16384 tokens,
    forward and backward, with CUDA's synchronising calls made errors."""
    torch.manual_seed(0)
    m = DroplessMoE(2048, 1024, 128, 8, first=0, count=64, route_scale=2.826,
                    dtype=torch.bfloat16).to(cuda)
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0.0, p.shape[-1] ** -0.5)
    x = torch.randn(4, 4096, 2048, device=cuda, requires_grad=True)
    md.warm_up(cuda, 2048, 8)
    m(x).float().sum().backward()          # the first call's set-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            y = m(x)
            y.float().sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.isfinite(x.grad).all()
    assert torch.isfinite(m.experts_down.grad).all()
