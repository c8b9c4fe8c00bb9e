"""The port's AlexNet, NiN and GoogLeNet against the JAX package's, in eval
mode (dropout's masks come from different generators, so train mode is
held by shape and by the dropout contract only), at the sizes the
reference's own model tests use, with seeded numpy weights of the shapes
``model.init`` gives (``jax.eval_shape``: the init's truncated-normal
draws alone take ~20 s to compile here) converted to the port; the
full-width AlexNet's converted shapes and parameter
count against ``jax.eval_shape``; the conversion round trip bit for bit.

Tolerances as in ``test_torch_resnet.py``: fp32 logits rtol 1e-4, atol
1e-5; bf16 logits relative L2 <= 3e-2 (per-layer bf16 rounding of values
that differ in their last fp32 bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models.convnets import AlexNet as FlaxAlexNet
from chainermn_tpu.models.convnets import GoogLeNet as FlaxGoogLeNet
from chainermn_tpu.models.convnets import NiN as FlaxNiN
from chainermn_tpu_torch.convert import (convnet_flax_to_state_dict,
                                         convnet_state_dict_to_flax)
from chainermn_tpu_torch.models import layers
from chainermn_tpu_torch.models.convnets import AlexNet, GoogLeNet, NiN

FP32 = dict(rtol=1e-4, atol=1e-5)
BF16_REL_L2 = 3e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ARCHS = {"alex": (FlaxAlexNet, AlexNet, 96), "nin": (FlaxNiN, NiN, 64),
         "googlenet": (FlaxGoogLeNet, GoogLeNet, 64)}


def _port(cls, size, **kw):
    if cls is AlexNet:
        kw["image_size"] = size
    return cls(device="cpu", **kw)


def _init_shapes(flax_cls, size, num_classes):
    return jax.eval_shape(lambda: flax_cls(num_classes=num_classes).init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))


@pytest.fixture(scope="module")
def inits():
    """Variables of each reference convnet at its test size: kernels
    ~ N(0, 1/fan_in) and biases ~ N(0, 0.1^2) from a seeded numpy draw."""
    rng = np.random.RandomState(0)

    def draw(s):
        if len(s.shape) == 1:
            return (0.1 * rng.randn(*s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return {name: jax.tree_util.tree_map(
                draw, dict(_init_shapes(flax_cls, size, 10)))
            for name, (flax_cls, _, size) in ARCHS.items()}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_convnet_matches_flax_in_eval_mode(inits, arch, dtype):
    jdt, tdt = DTYPES[dtype]
    flax_cls, port_cls, size = ARCHS[arch]
    variables = inits[arch]
    x = np.random.RandomState(1).randn(2, size, size, 3).astype(np.float32)
    model = flax_cls(num_classes=10, dtype=jdt)
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, x))
    ours = _port(port_cls, size, num_classes=10, dtype=tdt)
    ours.load_state_dict(convnet_flax_to_state_dict(variables))
    got = ours(torch.from_numpy(x), train=False)
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    got = got.detach().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **FP32)
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= BF16_REL_L2


@pytest.mark.parametrize("arch", list(ARCHS))
def test_convnet_round_trip_and_train_mode(inits, arch):
    """The conversion round trip is bit-exact; train mode needs a
    generator, and one seed gives one set of masks."""
    variables = inits[arch]
    back = convnet_state_dict_to_flax(convnet_flax_to_state_dict(variables))
    assert back["batch_stats"] == {}
    want = jax.tree_util.tree_leaves_with_path(variables["params"])
    assert len(want) == len(jax.tree_util.tree_leaves(back["params"]))
    for path, leaf in want:
        mine = back["params"]
        for k in path:
            mine = mine[k.key]
        assert mine.dtype == leaf.dtype and mine.tobytes() == leaf.tobytes()
    _, port_cls, size = ARCHS[arch]
    ours = _port(port_cls, size, num_classes=10, dtype=torch.float32)
    x = torch.from_numpy(np.random.RandomState(2).randn(
        2, size, size, 3).astype(np.float32))
    with pytest.raises(ValueError, match="Generator"):
        ours(x, train=True)
    runs = [ours(x, train=True, rng=torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], ours(x, train=False))


def test_dropout_keeps_and_scales():
    x = torch.ones(4096)
    y = layers.dropout(x, 0.4, True, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.6))
    assert abs(kept.float().mean().item() - 0.6) < 0.03
    assert layers.dropout(x, 0.4, False) is x


def test_full_width_alexnet_shapes_and_count():
    """The reference's AlexNet at 224 px and 1000 classes: every converted
    shape loads into the port's (``Dense_0`` takes the 6x6x256 NHWC
    flatten) and the parameter counts agree; no FLOPs."""
    shapes = _init_shapes(FlaxAlexNet, 224, 1000)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   dict(shapes))
    sd = convnet_flax_to_state_dict(zeros)
    with torch.device("meta"):
        ours = AlexNet(num_classes=1000, device="meta")
    mine = ours.state_dict()
    assert set(sd) == set(mine)
    assert all(tuple(sd[k].shape) == tuple(mine[k].shape) for k in sd)
    assert tuple(mine["Dense_0.weight"].shape) == (4096, 6 * 6 * 256)
    n_flax = sum(int(np.prod(s.shape))
                 for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert n_flax == sum(p.numel() for p in ours.parameters())
