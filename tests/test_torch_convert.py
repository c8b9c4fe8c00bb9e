"""Parameter conversion between the reference's flax tree and the port.

The round trip flax -> torch -> flax is bit-exact (every move is a
reshape or a transpose), and converted weights give the reference's
forward pass in fp32 to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu_torch import convert
from chainermn_tpu_torch.models.transformer import TransformerLM


def _flax_params(n_kv_heads=None, seed=0):
    model = JaxLM(vocab=48, d_model=32, n_heads=4, d_ff=64, n_layers=2,
                  max_len=16, dtype=jnp.float32, n_kv_heads=n_kv_heads)
    tokens = jnp.zeros((1, 16), jnp.int32)
    params = model.init(jax.random.PRNGKey(seed), tokens)["params"]
    return model, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("n_kv_heads", [None, 2])
def test_round_trip_is_bit_exact(n_kv_heads):
    _, params = _flax_params(n_kv_heads)
    sd = convert.flax_to_state_dict(params)
    back = convert.state_dict_to_flax(sd, n_heads=4)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_kv_heads", [None, 2])
def test_converted_weights_load_and_match_forward(n_kv_heads):
    model, params = _flax_params(n_kv_heads, seed=1)
    port = TransformerLM(vocab=48, d_model=32, n_heads=4, d_ff=64,
                         n_layers=2, max_len=16, dtype=torch.float32,
                         n_kv_heads=n_kv_heads, device="cpu")
    port.load_state_dict(convert.flax_to_state_dict({"params": params}))
    tokens = np.random.RandomState(0).randint(0, 48, (2, 16)).astype(np.int32)
    want = model.apply({"params": params}, jnp.asarray(tokens))
    got = port(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    # And the port's own state_dict converts back to the same tree.
    back = convert.state_dict_to_flax(port.state_dict(), n_heads=4)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
