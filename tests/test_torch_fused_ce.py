"""chainermn_tpu_torch fused cross-entropy against the JAX package.

The cases of tests/test_fused_ce.py, with the same numpy inputs through
``chainermn_tpu.ops.fused_ce`` and its port.  Both cast hidden states and
embedding to bf16 for every chunk product and accumulate in fp32, so the
loss and the LSE agree to 1e-5 (summation order only).  Gradients go
through a bf16 cast of ``dlogits`` on both sides; a rounding tie can fall
differently, so they are held to 1e-4 absolute, a few bf16 ulps of the
O(1e-2) gradient entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops import fused_ce as jce
from chainermn_tpu_torch.ops import fused_ce as tce


def _mk(n=96, d=32, v=50, seed=0, neg_frac=0.0):
    rng = np.random.RandomState(seed)
    h = rng.randn(n, d).astype(np.float32)
    e = (rng.randn(v, d) * 0.1).astype(np.float32)
    lab = rng.randint(0, v, size=n).astype(np.int32)
    if neg_frac:
        lab[rng.rand(n) < neg_frac] = -1
    return h, e, lab


def _both(fn_j, fn_t, h, e, lab, **kw):
    jl = fn_j(jnp.asarray(h), jnp.asarray(e), jnp.asarray(lab), **kw)
    tl = fn_t(torch.from_numpy(h), torch.from_numpy(e),
              torch.from_numpy(lab).long(), **kw)
    return jl, tl


@pytest.mark.parametrize("chunk", [7, 32, 96, 1000])
def test_value_matches_reference(chunk):
    h, e, lab = _mk()
    jl, tl = _both(jce.fused_cross_entropy, tce.fused_cross_entropy, h, e,
                   lab, chunk=chunk)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    naive = tce.naive_cross_entropy(torch.from_numpy(h), torch.from_numpy(e),
                                    torch.from_numpy(lab))
    np.testing.assert_allclose(float(tl), float(naive), rtol=1e-5)


def _grads(fn_j, fn_t, h, e, lab):
    gj = jax.grad(fn_j, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(e))
    th = torch.tensor(h, requires_grad=True)
    te = torch.tensor(e, requires_grad=True)
    fn_t(th, te).backward()
    return [np.asarray(g) for g in gj], [th.grad.numpy(), te.grad.numpy()]


def test_grads_match_reference():
    h, e, lab = _mk()
    gj, gt = _grads(
        lambda h, e: jce.fused_cross_entropy(h, e, jnp.asarray(lab), chunk=32),
        lambda h, e: tce.fused_cross_entropy(h, e, torch.from_numpy(lab),
                                             chunk=32),
        h, e, lab)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3)


def test_ignored_labels_zero_loss_and_grad():
    h, e, lab = _mk(neg_frac=0.3, seed=1)
    mask = lab >= 0
    jl, tl = _both(jce.fused_cross_entropy, tce.fused_cross_entropy, h, e,
                   lab, chunk=16)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    th = torch.tensor(h, requires_grad=True)
    tce.fused_cross_entropy(th, torch.from_numpy(e), torch.from_numpy(lab),
                            chunk=16).backward()
    gh = th.grad.numpy()
    assert np.all(gh[~mask] == 0.0)
    assert np.abs(gh[mask]).max() > 0
    gj = jax.grad(lambda h: jce.fused_cross_entropy(
        h, jnp.asarray(e), jnp.asarray(lab), chunk=16))(jnp.asarray(h))
    np.testing.assert_allclose(gh, np.asarray(gj), atol=1e-4, rtol=1e-3)


def test_all_labels_ignored_is_zero_not_nan():
    h, e, _ = _mk(n=8)
    lab = torch.full((8,), -1, dtype=torch.int32)
    th = torch.tensor(h, requires_grad=True)
    te = torch.tensor(e, requires_grad=True)
    out = tce.fused_cross_entropy(th, te, lab)
    assert float(out.detach()) == 0.0
    out.backward()
    assert torch.all(th.grad == 0) and torch.all(te.grad == 0)


def test_batched_shape_and_bf16_hidden():
    h, e, lab = _mk(n=96)
    h16 = torch.from_numpy(h).to(torch.bfloat16)
    got = tce.fused_cross_entropy(h16.reshape(4, 24, -1), torch.from_numpy(e),
                                  torch.from_numpy(lab).reshape(4, 24),
                                  chunk=24)
    want = jce.fused_cross_entropy(
        jnp.asarray(h).astype(jnp.bfloat16).reshape(4, 24, -1),
        jnp.asarray(e), jnp.asarray(lab).reshape(4, 24), chunk=24)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_with_lse_matches_reference_lse():
    h, e, lab = _mk(n=64, v=40)
    (jl, jlse), (tl, tlse) = _both(jce.fused_cross_entropy_with_lse,
                                   tce.fused_cross_entropy_with_lse, h, e,
                                   lab, chunk=16)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tlse.detach().numpy(), np.asarray(jlse),
                               atol=1e-5, rtol=1e-5)


def test_lse_output_is_differentiable():
    """The z-loss pattern: the lse cotangent flows through the backward."""
    h, e, lab = _mk(n=32, v=20)

    def zloss_j(h, e):
        loss, lse = jce.fused_cross_entropy_with_lse(h, e, jnp.asarray(lab),
                                                     chunk=8)
        return loss + 1e-3 * jnp.mean(lse ** 2)

    def zloss_t(h, e):
        loss, lse = tce.fused_cross_entropy_with_lse(
            h, e, torch.from_numpy(lab), chunk=8)
        return loss + 1e-3 * torch.mean(lse ** 2)

    gj, gt = _grads(zloss_j, zloss_t, h, e, lab)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3)


def test_no_full_logit_tensor_saved_for_backward():
    """The memory claim: autograd saves no (N, V) tensor — only the
    inputs and one fp32 LSE per token."""
    n, d, v, chunk = 1024, 16, 512, 64
    h = torch.zeros(n, d, requires_grad=True)
    e = torch.zeros(v, d, requires_grad=True)
    lab = torch.zeros(n, dtype=torch.int32)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        loss = tce.fused_cross_entropy(h, e, lab, chunk=chunk)
    loss.backward()
    assert all(not (len(s) >= 2 and s[-1] == v and s[0] > chunk)
               for s in saved), saved
    assert (n,) in saved


def test_shape_mismatch_raises():
    h, e, lab = (torch.from_numpy(x) for x in _mk())
    with pytest.raises(ValueError, match="labels"):
        tce.fused_cross_entropy(h, e, lab[:-1])
    with pytest.raises(ValueError, match="dim"):
        tce.fused_cross_entropy(h, e[:, :-1], lab)
    with pytest.raises(ValueError, match="chunk"):
        tce.fused_cross_entropy(h, e, lab, chunk=0)
