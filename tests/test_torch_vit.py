"""The port's ``ViT`` against the JAX package's ``ViT``.

The reference's flax parameters, converted by ``convert.py``, go into the
port's model; logits and every parameter's gradient (of a fixed weighted
sum of the logits) are compared in fp32 and in bf16, on a non-square image
(32 x 48 pixels, patch 8: a 4 x 6 patch grid, so that tokens read in the
wrong order of (H, W) would meet the wrong ``pos_embed`` rows).  Then
ViT-B/16 at full width on the ``meta`` device against the shapes of the
reference's ``init`` at 224 px, and the conversion's round trip.

Tolerances: fp32 logits rtol 1e-5 (atol 1e-6), gradients within 1e-5
relative L2 per tensor (observed 1e-6: another summation order).  bf16:
logits within 2e-2 of the largest |logit|, gradients within 2e-2
relative L2 per tensor (observed 0.021 of 1.79 and 0.014): XLA and ATen
round the bf16 intermediates of each block at different points, a few
bf16 ulps (2^-8 each) over two blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models.vit import ViT as JaxViT
from chainermn_tpu_torch.convert import (vit_flax_to_state_dict,
                                         vit_state_dict_to_flax)
from chainermn_tpu_torch.models import ViT
from chainermn_tpu_torch.models.vit import ViT_B16

SMALL = dict(num_classes=10, patch=8, d_model=32, n_heads=2, d_ff=64,
             n_layers=2)


def _pair(dtype, image=(32, 48), batch=3):
    jm = JaxViT(dtype=getattr(jnp, dtype), **SMALL)
    x = np.random.RandomState(0).randn(batch, *image, 3).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0), x))
    m = ViT(dtype=getattr(torch, dtype), image_size=image, device="cpu",
            **SMALL)
    m.load_state_dict(vit_flax_to_state_dict(params))
    return jm, params, m, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_matches_reference(dtype):
    jm, params, m, x = _pair(dtype)
    want = np.asarray(jm.apply(params, x))
    got = m(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 10)
    got_np = got.detach().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got_np, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got_np, want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())
    wts = np.random.RandomState(1).randn(*want.shape).astype(np.float32)
    gj = jax.grad(lambda p: (jm.apply(p, x) * wts).sum())(params)
    gsd = vit_flax_to_state_dict(jax.tree_util.tree_map(np.asarray, gj))
    (got * torch.from_numpy(wts)).sum().backward()
    bound = 1e-5 if dtype == "float32" else 2e-2
    names = [k for k, _ in m.named_parameters()]
    assert sorted(names) == sorted(gsd)
    for k, p in m.named_parameters():
        rel = float((p.grad - gsd[k]).norm() / gsd[k].norm())
        assert rel <= bound, (k, rel)


def test_vit_token_order_is_row_major():
    """The tokens are the patches in flax's row-major (H, W) order: the
    port's first block sees exactly the reference's tokens, position
    embeddings included, on the 4 x 6 grid."""
    jm, params, m, x = _pair("float32")
    _, state = jm.apply(params, x, capture_intermediates=True,
                        mutable=["intermediates"])
    seen = {}
    m.blocks[0].register_forward_hook(
        lambda mod, args, out: seen.setdefault("x", args[0]))
    m(torch.from_numpy(x))
    # The reference's first block's input: its patchify output, the cls
    # token and pos_embed, rebuilt here as the flax model builds them.
    patches = np.asarray(state["intermediates"]["patchify"]["__call__"][0])
    assert patches.shape == (3, 4, 6, 32)
    p = params["params"]
    want = np.concatenate([np.broadcast_to(p["cls"], (3, 1, 32)),
                           patches.reshape(3, -1, 32)], axis=1)
    want = want + p["pos_embed"]
    np.testing.assert_allclose(seen["x"].detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)


def test_vit_b16_full_width_shapes_on_meta():
    """ViT-B/16 (patch 16, d_model 768, 12 heads, d_ff 3072, 12 layers,
    1000 classes, 224 px): every parameter's shape, and the count, equal
    those of the reference's ``init``."""
    shapes = jax.eval_shape(
        lambda: JaxViT().init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 224, 224, 3))))
    ref = vit_flax_to_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    with torch.device("meta"):
        ours = ViT_B16(device="meta")
    got = {k: tuple(p.shape) for k, p in ours.named_parameters()}
    assert got == {k: tuple(v.shape) for k, v in ref.items()}
    n = sum(p.numel() for p in ours.parameters())
    assert n == sum(v.numel() for v in ref.values()) == 86_484_712
    assert ours.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in ours.parameters())


def test_vit_conversion_round_trip_and_seeded_init():
    _, params, m, _ = _pair("bfloat16")
    back = vit_state_dict_to_flax(m.state_dict(), n_heads=2)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    flat_p = dict(jax.tree_util.tree_leaves_with_path(params["params"]))
    assert len(flat_b) == len(flat_p)
    for path, leaf in flat_b:
        np.testing.assert_array_equal(leaf, flat_p[path])
    a = ViT(device="cpu", seed=3, image_size=32, **SMALL)
    b = ViT(device="cpu", seed=3, image_size=32, **SMALL)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    assert float(a.cls.abs().max()) == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ViT(**SMALL)
