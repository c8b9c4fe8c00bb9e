"""The port's ResNet and its flax building blocks against the JAX package.

The same seeded numpy inputs go through ``flax.linen`` (``Conv``,
``max_pool``, ``BatchNorm``) and the reference's ``ResNet18`` and
Bottleneck ``ResNet``, and through the port with weights converted from
``model.init``; the converted full-width ResNet-50 is checked against
``jax.eval_shape`` (no FLOPs), and the conversion round trip bit for bit.

Tolerances: fp32 forwards rtol 1e-4, atol 1e-5 (the same arithmetic in
another summation order: XLA's and ATen's convolutions and reductions);
running statistics rtol 1e-5 (one fp32 mean and variance each, blended
with 0.9 of the old value); bf16 logits relative L2 <= 3e-2 (both sides
round every conv, BatchNorm and residual output to bf16, 2^-9 relative
each, from fp32 values that differ in their last bits, so single
elements can land one bf16 ulp apart after any layer; over the ~20
layers of these nets such flips stay near 1e-2 of the logits' norm,
while a wrong padding grid or variance moves them by order 1).
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models.resnet import ResNet as FlaxResNet
from chainermn_tpu.models.resnet import BasicBlock as FlaxBasic
from chainermn_tpu.models.resnet import BottleneckBlock as FlaxBottleneck
from chainermn_tpu.models.resnet import ResNet50 as FlaxResNet50
from chainermn_tpu_torch.convert import (convnet_flax_to_state_dict,
                                         convnet_state_dict_to_flax)
from chainermn_tpu_torch.models import layers
from chainermn_tpu_torch.models.resnet import (BasicBlock, BottleneckBlock,
                                               ResNet, ResNet50)

FP32 = dict(rtol=1e-4, atol=1e-5)
# A whole net in train mode: its last stage is 1x1 at these sizes, so each
# BatchNorm there normalises over the batch's 16 values per channel, which
# amplifies fp32 rounding; against a float64 run of the same weights the
# port's logits sit 0.6-2.4e-5 away and the reference's 1.2-3.2e-5, so
# the two are held to each other at atol 1e-4 (eval mode keeps FP32).
FP32_TRAIN_NET = dict(rtol=1e-4, atol=1e-4)
STATS = dict(rtol=1e-5, atol=1e-7)
# Running statistics of a whole net: each layer's mean and variance come
# from activations that already differ in their last fp32 bits, so a mean
# near zero needs an absolute margin beside the relative one.
NET_STATS = dict(rtol=1e-5, atol=1e-6)
BF16_REL_L2 = 3e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _nchw(x_nhwc):
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _images(n, size, seed=0, channels=3):
    return np.random.RandomState(seed).randn(
        n, size, size, channels).astype(np.float32)


# -- layers ---------------------------------------------------------------

@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("kernel,stride,padding", [
    (3, 2, "SAME"), (7, 2, "SAME"), (1, 2, "SAME"), (11, 4, "SAME"),
    (5, 1, "SAME"), (3, 1, "SAME"), (3, 2, "VALID"), (5, 1, "VALID")])
def test_conv_padding_matches_flax(size, kernel, stride, padding):
    x = _images(2, size, channels=4)
    conv = nn.Conv(6, (kernel, kernel), strides=(stride, stride),
                   padding=padding)
    params = conv.init(jax.random.PRNGKey(size), x)
    want = np.asarray(conv.apply(params, x))
    ours = layers.Conv(4, 6, kernel, stride, padding, dtype=torch.float32,
                       generator=torch.Generator().manual_seed(0))
    ours.load_state_dict(convnet_flax_to_state_dict(
        {"params": params["params"]}))
    got = _nhwc(ours(_nchw(x).contiguous(memory_format=torch.channels_last)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **FP32)


def test_same_padding_is_xla_split_not_torch_symmetric():
    """The splits the ResNet stem and strided convs take at 224 px."""
    assert layers.same_pads(224, 7, 2) == (2, 3)
    assert layers.same_pads(112, 3, 2) == (0, 1)
    assert layers.same_pads(56, 3, 2) == (0, 1)
    assert layers.same_pads(224, 11, 4) == (3, 4)
    assert layers.same_pads(7, 3, 2) == (1, 1)
    assert layers.same_pads(56, 1, 2) == (0, 0)


@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("window,stride,padding", [
    (3, 2, "SAME"), (3, 1, "SAME"), (3, 2, "VALID"), (2, 2, "SAME")])
def test_max_pool_matches_flax(size, window, stride, padding):
    x = _images(2, size, seed=size, channels=5)
    want = np.asarray(nn.max_pool(x, (window, window), strides=(stride,
                                                                stride),
                                  padding=padding))
    got = _nhwc(layers.max_pool(_nchw(x), window, stride, padding))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)      # a max is exact


@pytest.mark.parametrize("size", [5, 8])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batchnorm_matches_flax_train_and_eval(size, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(size)
    # Offset and spread per channel, so the mean and the variance matter.
    x = (rng.randn(4, size, size, 6) * rng.uniform(0.5, 3, 6)
         + rng.randn(6)).astype(np.float32)
    bn = nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=jdt)
    params = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
              "bias": rng.randn(6).astype(np.float32)}
    stats = {"mean": rng.randn(6).astype(np.float32),
             "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    variables = {"params": params, "batch_stats": stats}
    xj = jnp.asarray(x, jdt)
    want, upd = bn.apply(variables, xj, use_running_average=False,
                         mutable=["batch_stats"])

    ours = layers.BatchNorm(6, dtype=tdt)
    ours.load_state_dict(convnet_flax_to_state_dict(variables))
    xt = _nchw(np.array(xj.astype(jnp.float32))).to(tdt)
    got = ours(xt, train=True)
    assert got.dtype == tdt
    got_eval = ours(xt, train=False)   # with the updated running stats
    tol = FP32 if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want, np.float32),
                               **tol)
    np.testing.assert_allclose(ours.running_mean.numpy(),
                               upd["batch_stats"]["mean"], **STATS)
    np.testing.assert_allclose(ours.running_var.numpy(),
                               upd["batch_stats"]["var"], **STATS)
    # torch.nn.BatchNorm2d would have stored the unbiased variance: at
    # this batch the factor n / (n - 1) is far outside the tolerance.
    xs = np.asarray(xj.astype(jnp.float32), np.float64)
    n = xs.size // 6
    unbiased = 0.9 * stats["var"] + 0.1 * xs.var(axis=(0, 1, 2)) * n / (n - 1)
    assert not np.allclose(ours.running_var.numpy(), unbiased, **STATS)
    want_eval = bn.apply({"params": params,
                          "batch_stats": upd["batch_stats"]}, xj,
                         use_running_average=True)
    np.testing.assert_allclose(_nhwc(got_eval),
                               np.asarray(want_eval, np.float32), **tol)


# -- ResNet ----------------------------------------------------------------

MODELS = {
    "resnet18": (functools.partial(FlaxResNet, stage_sizes=[2, 2, 2, 2],
                                   block_cls=FlaxBasic, num_filters=8),
                 functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                                   block_cls=BasicBlock, num_filters=8)),
    "bottleneck": (functools.partial(FlaxResNet, stage_sizes=[1, 1, 1, 1],
                                     block_cls=FlaxBottleneck, num_filters=4),
                   functools.partial(ResNet, stage_sizes=[1, 1, 1, 1],
                                     block_cls=BottleneckBlock,
                                     num_filters=4)),
}


def perturbed_init(flax_model, size, seed=0):
    """``model.init`` with every BatchNorm scale, bias and running
    statistic moved off its initial value (the zero-initialised last scale
    of each block would otherwise hide the residual branches)."""
    variables = flax_model.init(jax.random.PRNGKey(seed),
                                jnp.zeros((1, size, size, 3)), train=False)
    rng = np.random.RandomState(seed + 1)

    def perturb(path, leaf):
        name = path[-1].key
        a = np.asarray(leaf)
        if name == "scale":
            return (1 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.randn(*a.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, dict(variables))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch,size", [("resnet18", 32), ("bottleneck", 16),
                                       ("bottleneck", 24)])
def test_resnet_matches_flax(arch, size, dtype, train):
    jdt, tdt = DTYPES[dtype]
    flax_cls, port_cls = MODELS[arch]
    fm = flax_cls(num_classes=10, dtype=jdt)
    variables = perturbed_init(fm, size)
    # 16 images: a train-mode BatchNorm over a handful of values per
    # channel (ResNet-18's 1x1 last stage at 32 px) amplifies the bf16
    # rounding of its inputs; at 8 images both implementations sit ~5%
    # from the float64 result and ~3% from each other, at 16 ~4% and
    # below 2%.  fp32 and eval mode are unaffected.
    x = _images(16, size, seed=3)
    if train:
        want, upd = fm.apply(variables, x, train=True,
                             mutable=["batch_stats"])
    else:
        want = fm.apply(variables, x, train=False)
    ours = port_cls(num_classes=10, dtype=tdt, device="cpu")
    ours.load_state_dict(convnet_flax_to_state_dict(variables))
    got = ours(torch.from_numpy(x), train=train)
    assert got.dtype == torch.float32 and got.shape == (16, 10)
    got = got.detach().numpy()
    want = np.asarray(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want,
                                   **(FP32_TRAIN_NET if train else FP32))
    else:
        assert _rel_l2(got, want) <= BF16_REL_L2
    if train:
        sd = convnet_state_dict_to_flax(ours.state_dict())["batch_stats"]
        flat_want = jax.tree_util.tree_leaves_with_path(upd["batch_stats"])
        assert len(flat_want) == len(jax.tree_util.tree_leaves(sd))
        for path, leaf in flat_want:
            mine = sd
            for k in path:
                mine = mine[k.key]
            if dtype == "float32":
                np.testing.assert_allclose(mine, np.asarray(leaf),
                                           **NET_STATS)
            else:
                assert _rel_l2(mine, leaf) <= BF16_REL_L2


def test_full_width_resnet50_shapes_and_count():
    """Every converted shape of the reference's ResNet-50 (1000 classes,
    224 px) loads into the port's, and the counts agree; no FLOPs."""
    shapes = jax.eval_shape(
        lambda: FlaxResNet50(num_classes=1000).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   dict(shapes))
    sd = convnet_flax_to_state_dict(zeros)
    with torch.device("meta"):
        ours = ResNet50(num_classes=1000, device="meta")
    mine = ours.state_dict()
    assert set(sd) == set(mine)
    assert all(tuple(sd[k].shape) == tuple(mine[k].shape) for k in sd)
    n_flax = sum(int(np.prod(s.shape))
                 for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert n_flax == sum(p.numel() for p in ours.parameters()) == 25557032


def test_convert_round_trip_is_bit_exact():
    fm = MODELS["bottleneck"][0](num_classes=10)
    variables = perturbed_init(fm, 16, seed=4)
    back = convnet_state_dict_to_flax(convnet_flax_to_state_dict(variables))
    want = jax.tree_util.tree_leaves_with_path(variables)
    assert len(want) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in want:
        mine = back
        for k in path:
            mine = mine[k.key]
        assert mine.dtype == np.asarray(leaf).dtype
        assert mine.tobytes() == np.asarray(leaf).tobytes()


def test_seeded_init_and_device():
    a = ResNet(stage_sizes=[1], block_cls=BasicBlock, num_filters=4,
               num_classes=3, device="cpu", seed=5)
    b = ResNet(stage_sizes=[1], block_cls=BasicBlock, num_filters=4,
               num_classes=3, device="cpu", seed=5)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    assert a.conv_init.weight.is_contiguous(memory_format=torch.channels_last)
    # flax's init: zero scale on each block's last BatchNorm, unit elsewhere.
    assert torch.all(a.BasicBlock_0.BatchNorm_1.weight == 0)
    assert torch.all(a.BasicBlock_0.BatchNorm_0.weight == 1)
    # lecun_normal: std sqrt(1 / fan_in) within a sampling margin.
    w = ResNet50(num_classes=10, device="cpu").BottleneckBlock_3.Conv_1.weight
    assert abs(w.std().item() * (w[0].numel()) ** 0.5 - 1.0) < 0.02
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ResNet50(num_classes=10)
