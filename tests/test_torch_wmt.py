"""The port's WMT slice against the JAX package: the encoder-decoder
``Transformer`` converted from flax (fp32 and bf16, padded source and
target tokens), ``warmup_cosine_decay_schedule`` against optax over its
whole range, the loss against optax's on bf16 logits, the example's
pipeline (model, loss, schedule, AdamW through the two-dimensional
communicator on a bf16 wire) step by step at 1, 2 and 4 ranks (gloo
workers from ``_torch_dist_worker.py``) against meshes of as many
devices, and ``main()`` end to end at the reference smoke's flags.

Tolerances: fp32 logits rtol 1e-5 / atol 2e-5 (another summation order);
bf16 logits within 0.05 absolute, a few bf16 ulps at their size, since
XLA and ATen round the bf16 intermediates of each block at different
points; the schedule within 1e-6 of its peak (optax evaluates it in fp32,
whose warm-up interpolation cancels to a few fp32 ulps of the peak, the
port in fp64); the loss rtol 1e-5
in fp32 and 1e-2 in bf16.  The fp32 pipeline holds losses to rtol 1e-5
and parameters to 3e-4 absolute after 4 AdamW updates whose learning
rates sum to 6e-3: the gradients cross a bf16 wire, where a last-bit
fp32 difference (another summation order) can round one element to the
neighbouring bf16 value, 2^-8 relative, and Adam's normalisation carries
that into a fraction of the step (observed: one element of 1024 off by
1.1e-4 at 4 ranks); the bf16 pipeline, the example's own, holds losses
to 0.02 absolute.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_dist_worker as worker
from chainermn_tpu.communicators import build_mesh
from chainermn_tpu.communicators import create_communicator as jax_comm
from chainermn_tpu.models.transformer import Transformer as JaxTransformer
from chainermn_tpu.optimizers import create_multi_node_optimizer as jax_mno
from chainermn_tpu_torch.convert import (encdec_flax_to_state_dict,
                                         encdec_state_dict_to_flax)
from chainermn_tpu_torch.models.transformer import Transformer
from chainermn_tpu_torch.optim import warmup_cosine_decay_schedule

train_transformer = importlib.import_module(
    "chainermn_tpu_torch.examples.train_transformer")

SMALL = dict(vocab=64, d_model=32, n_heads=2, d_ff=64, n_enc_layers=1,
             n_dec_layers=1, max_len=8)


def flax_model(dtype, **kw):
    cfg = {**SMALL, **kw}
    return JaxTransformer(dtype=dtype, **cfg), cfg


def flax_params(model, seq=8):
    z = jnp.zeros((2, seq), jnp.int32)
    return jax.tree_util.tree_map(np.asarray,
                                  model.init(jax.random.PRNGKey(0), z, z))


def port_model(params, cfg, dtype):
    m = Transformer(dtype=dtype, device="cpu", **cfg)
    m.load_state_dict(encdec_flax_to_state_dict(params))
    return m


def tokens(seed, shape, vocab=64, pad_tail=True):
    """Tokens in [3, vocab) with padding (0) at the ends of some rows."""
    rng = np.random.RandomState(seed)
    t = rng.randint(3, vocab, size=shape).astype(np.int32)
    if pad_tail:
        t[0, -3:] = 0
        t[-1, -1:] = 0
    return t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_matches_reference(dtype):
    """``tests/test_models.py``'s shapes (two layers here), padded source
    and target: the logits, their dtype (bf16 with a bf16 model, as the
    reference computes), and a bit-exact conversion round trip."""
    model, cfg = flax_model(getattr(jnp, dtype), n_enc_layers=2,
                            n_dec_layers=2, vocab=50, max_len=16)
    params = flax_params(model)
    src, tgt = tokens(0, (3, 8), 50), tokens(1, (3, 8), 50)
    want = model.apply(params, src, tgt)
    port = port_model(params, cfg, getattr(torch, dtype))
    with torch.no_grad():
        got = port(torch.from_numpy(src).long(), torch.from_numpy(tgt).long())
    assert str(want.dtype) == dtype and got.dtype == getattr(torch, dtype)
    assert got.shape == (3, 8, 50)
    tol = (dict(rtol=1e-5, atol=2e-5) if dtype == "float32"
           else dict(rtol=0, atol=0.05))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    back = encdec_state_dict_to_flax(port.state_dict(), n_heads=2)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    flat_p = dict(jax.tree_util.tree_leaves_with_path(params["params"]))
    assert len(flat_b) == len(flat_p)
    for path, leaf in flat_b:
        np.testing.assert_array_equal(leaf, flat_p[path])


def test_transformer_shapes_and_seeded_init():
    a = Transformer(device="cpu", seed=3, **SMALL)
    b = Transformer(device="cpu", seed=3, **SMALL)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    assert all(p.dtype == torch.float32 for p in a.parameters())
    src = torch.ones(2, 8, dtype=torch.long)
    assert a(src, src).shape == (2, 8, 64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Transformer(**SMALL)


@pytest.mark.parametrize("init,peak,warmup,decay,end,exponent", [
    (0.0, 1e-3, 50, 200, 0.0, 1.0), (0.1, 0.5, 3, 10, 0.05, 2.0),
    (0.0, 0.0, 2, 5, 0.0, 1.0)])
def test_warmup_cosine_schedule_matches_optax(init, peak, warmup, decay,
                                              end, exponent):
    ours = warmup_cosine_decay_schedule(init, peak, warmup, decay, end,
                                        exponent)
    want = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay,
                                              end, exponent)
    for count in range(decay + 5):
        np.testing.assert_allclose(ours(count), float(want(count)),
                                   rtol=1e-6, atol=1e-6 * max(init, peak))
    np.testing.assert_allclose(ours(0), init, rtol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_matches_optax(dtype):
    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 8, 64) * 3).astype(np.float32)
    tgt = tokens(2, (3, 8))
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    mask = (tgt != 0).astype(np.float32)
    ce = optax.softmax_cross_entropy_with_integer_labels(jl, tgt)
    want = float((ce * mask).sum() / mask.sum())
    got = train_transformer.masked_cross_entropy(
        torch.from_numpy(logits).to(getattr(torch, dtype)),
        torch.from_numpy(tgt).long())
    np.testing.assert_allclose(float(got), want,
                               rtol=1e-5 if dtype == "float32" else 1e-2)


def reference_pipeline(n, dtype, params):
    """The reference example's step (its loss, schedule and optimizer) on
    an ``n``-device mesh: losses and the final state dict."""
    comm = jax_comm("two_dimensional", allreduce_grad_dtype="bfloat16",
                    mesh=build_mesh(inter_size=1, intra_size=n,
                                    devices=jax.devices()[:n]))
    model, _ = flax_model(getattr(jnp, dtype))

    def loss_fn(params, batch):
        src, tgt = batch
        tgt_in = jnp.concatenate(
            [jnp.ones((tgt.shape[0], 1), tgt.dtype), tgt[:, :-1]], axis=1)
        logits = model.apply(params, src, tgt_in)
        mask = (tgt != 0).astype(jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, tgt)
        return (ce * mask).sum() / mask.sum()

    sched = optax.warmup_cosine_decay_schedule(0.0, 0.05, 50, 200)
    opt = jax_mno(optax.adamw(sched, weight_decay=0.01), comm)
    state = opt.init(params)
    step = opt.make_train_step(loss_fn, donate=False)
    losses = []
    for batch in worker.wmt_batches():
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    sd = encdec_flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                          params))
    return losses, {k: v.numpy().ravel() for k, v in sd.items()}


DTYPES = ("float32", "bfloat16")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Each dtype's reference parameters, and the npz of their conversion
    that the workers load."""
    tmp = tmp_path_factory.mktemp("wmt_weights")
    out = {}
    for dtype in DTYPES:
        params = flax_params(flax_model(getattr(jnp, dtype))[0])
        path = tmp / f"{dtype}.npz"
        np.savez(path, **{k: v.numpy() for k, v in
                          encdec_flax_to_state_dict(params).items()})
        out[dtype] = (params, str(path))
    return out


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda n: f"{n}ranks")
def pipeline_runs(request, weights, tmp_path_factory):
    size = request.param
    paths = {d: w[1] for d, w in weights.items()}
    if size == 1:
        return size, [{d: worker.wmt_pipeline(
            {k: torch.from_numpy(v) for k, v in np.load(p).items()}, d)
            for d, p in paths.items()}]
    return size, worker.spawn("wmt", size,
                              tmp_path_factory.mktemp(f"wmt{size}"),
                              weights=paths)


@pytest.mark.parametrize("dtype", DTYPES)
def test_example_pipeline_matches_reference(pipeline_runs, weights, dtype):
    """The example's pipeline against the reference's, step by step on the
    same global batches: every rank holds the same parameters, the
    schedule's count advanced once a step (the first update at lr 0)."""
    size, res = pipeline_runs
    params = weights[dtype][0]
    want_losses, want = reference_pipeline(size, dtype, params)
    res = [r[dtype] for r in res]
    for out in res:
        assert out["updates"] == worker.WMT_STEPS
        assert out["params"] == res[0]["params"]
        if dtype == "float32":
            np.testing.assert_allclose(out["losses"], want_losses, rtol=1e-5)
            for k, v in want.items():
                np.testing.assert_allclose(out["params"][k], v, rtol=0,
                                           atol=3e-4, err_msg=k)
        else:
            np.testing.assert_allclose(out["losses"], want_losses, rtol=0,
                                       atol=0.02)
    # Only the first update ran at lr 0: the parameters moved.
    assert res[0]["params"] != {k: v.numpy().ravel().tolist() for k, v in
                                encdec_flax_to_state_dict(params).items()}


def test_example_main_end_to_end(capsys):
    """The reference smoke's flags (``tests/test_examples.py``) on the CPU,
    one thread: one epoch of 512 steps, a finite loss below ln(vocab)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loss = train_transformer.main([
            "--device", "cpu", "--communicator", "two_dimensional",
            "--epochs", "1", "--batchsize", "8", "--d-model", "32",
            "--n-heads", "2", "--d-ff", "64", "--layers", "1", "--vocab",
            "64", "--seq-len", "8"])
    finally:
        torch.set_num_threads(threads)
    printed = capsys.readouterr().out
    assert "TwoDimensionalCommunicator" in printed
    assert f"epoch 0: loss {loss:.4f}" in printed
    assert "tok/s over 1 devices" in printed
    assert np.isfinite(loss) and loss < np.log(64)
