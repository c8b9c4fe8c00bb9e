"""The port's LM slice end to end against the JAX package.

A tiny decoder LM (vocab 64, d_model 32, 4 heads, d_ff 64, 2 layers,
S=64, fp32) with flash attention in both packages starts from the same
converted weights and trains three AdamW steps on the same global batch:
the reference through its multi-node optimizer on the conftest's 8-device
CPU mesh, the port through its multi-node optimizer over a one-rank gloo
group.  Both sides compute in fp32 and differ in summation order (8
device shards against one, blockwise against dense attention) and in
AdamW's order of decay and update, so per-step losses agree to 1e-5
relative.  The loss head casts ``dlogits`` to bf16 on both sides, where
a rounding tie can fall differently; Adam's normalisation can turn that
into a parameter difference of a fraction of the step size, so the final
parameters are held to 1e-4 absolute (the learning rate is 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chainermn_tpu.communicators import build_mesh
from chainermn_tpu.communicators import create_communicator as jax_comm
from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.ops.flash_attention import (
    make_flash_attention_fn as jax_flash_fn,
)
from chainermn_tpu.ops.fused_ce import fused_cross_entropy as jax_ce
from chainermn_tpu.optimizers import create_multi_node_optimizer as jax_mno
from chainermn_tpu_torch import (
    convert,
    create_communicator,
    create_multi_node_optimizer,
)
from chainermn_tpu_torch.models.transformer import (
    EncoderLayer,
    MultiHeadAttention,
    TransformerLM,
    causal_mask,
    sinusoidal_positions,
)
from chainermn_tpu_torch.ops import make_flash_attention_fn
from chainermn_tpu_torch.ops.fused_ce import fused_cross_entropy

CFG = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_len=64)
LR, WD = 1e-3, 0.1


def _batch(seed=0, rows=8):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, CFG["vocab"], (rows, CFG["max_len"])).astype(np.int32)
    labs = rng.randint(0, CFG["vocab"], (rows, CFG["max_len"])).astype(np.int32)
    return toks, labs


def _jax_model(attn=True, n_kv_heads=None):
    return JaxLM(**CFG, dtype=jnp.float32, n_kv_heads=n_kv_heads,
                 attention_fn=jax_flash_fn(causal=True) if attn else None)


def _port_model(attn=True, n_kv_heads=None, remat=False):
    return TransformerLM(
        **CFG, dtype=torch.float32, n_kv_heads=n_kv_heads, remat=remat,
        attention_fn=make_flash_attention_fn(causal=True) if attn else None,
        device="cpu")


def test_three_adamw_steps_match_reference(devices8):
    toks, labs = _batch()
    jm = _jax_model()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(toks[:1]))["params"]
    params = jax.tree.map(np.asarray, params)

    # Reference: 8-device data parallelism over the global batch.
    mesh = build_mesh(inter_size=1, intra_size=8, devices=devices8)
    jopt = jax_mno(optax.adamw(LR, b1=0.9, b2=0.999, eps=1e-8,
                               weight_decay=WD), jax_comm("xla_ici", mesh=mesh))

    def jloss(p, batch):
        h = jm.apply({"params": p}, batch[0], return_hidden=True)
        return jax_ce(h, p["embed"]["embedding"], batch[1])

    jstep = jopt.make_train_step(jloss, donate=False)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    jlosses = []
    for _ in range(3):
        jp, jstate, loss = jstep(jp, jstate, (jnp.asarray(toks),
                                              jnp.asarray(labs)))
        jlosses.append(float(loss))

    # Port: the same step through its own optimizer and communicator.
    model = _port_model()
    model.load_state_dict(convert.flax_to_state_dict(params))
    comm = create_communicator("xla_ici", device="cpu")
    opt = create_multi_node_optimizer(
        torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=WD), comm)
    opt.init()

    def loss_fn(batch):
        h = model(batch[0], return_hidden=True)
        return fused_cross_entropy(h, model.embed.weight, batch[1])

    step = opt.make_train_step(loss_fn)
    batch = (torch.from_numpy(toks).long(), torch.from_numpy(labs).long())
    losses = [float(step(batch)) for _ in range(3)]

    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    got = convert.state_dict_to_flax(model.state_dict(), CFG["n_heads"])
    want = jax.tree.map(np.asarray, jp)
    for path, a in jax.tree_util.tree_leaves_with_path(want):
        b = got
        for key in path:
            b = b[key.key]
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("n_kv_heads", [None, 2])
def test_dense_attention_path_matches_reference(n_kv_heads):
    """No attention_fn: the dense masked softmax of the reference, GQA
    included, forward and logits."""
    toks, _ = _batch(rows=2)
    jm = _jax_model(attn=False, n_kv_heads=n_kv_heads)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(toks))["params"]
    want = jm.apply({"params": params}, jnp.asarray(toks))
    model = _port_model(attn=False, n_kv_heads=n_kv_heads)
    model.load_state_dict(convert.flax_to_state_dict(
        jax.tree.map(np.asarray, params)))
    got = model(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_remat_gives_the_same_loss_and_grads():
    toks, labs = _batch(rows=2)
    a, b = _port_model(), _port_model(remat=True)
    b.load_state_dict(a.state_dict())
    for m in (a, b):
        h = m(torch.from_numpy(toks).long(), return_hidden=True)
        fused_cross_entropy(h, m.embed.weight,
                            torch.from_numpy(labs).long()).backward()
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa.grad, pb.grad, atol=0, rtol=0)


def test_positions_and_mask_match_reference():
    from chainermn_tpu.models import transformer as jt

    np.testing.assert_array_equal(sinusoidal_positions(16, 8),
                                  jt.sinusoidal_positions(16, 8))
    np.testing.assert_array_equal(causal_mask(5).numpy(),
                                  np.asarray(jt.causal_mask(5)))


def test_bf16_layers_cast_inputs_and_params():
    """dtype=bf16 keeps fp32 parameters and computes in bf16."""
    layer = EncoderLayer(32, 4, 64, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in layer.parameters())
    out = layer(torch.randn(2, 8, 32, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16


def test_later_slices_and_missing_device_raise():
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.6"):
        MultiHeadAttention(16, 2, decode=True)
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.6"):
        TransformerLM(vocab=8, d_model=16, n_heads=2, d_ff=16, n_layers=1,
                      paged="decode", device="cpu")
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.6"):
        TransformerLM(vocab=8, d_model=16, n_heads=2, d_ff=16, n_layers=1,
                      sp_axis="seq", device="cpu")
    with pytest.raises(ValueError, match="divide"):
        MultiHeadAttention(16, 4, n_kv_heads=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TransformerLM(vocab=8, d_model=16, n_heads=2, d_ff=16,
                          n_layers=1)
