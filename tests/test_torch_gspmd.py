"""The port's GSPMD train step against the JAX package's.

``parallel.sharding.make_gspmd_train_step`` places a ``TransformerLM``
(2 layers, d_model 32, 4 heads, d_ff 64, vocab 64, fp32) on a
``DeviceMesh`` of gloo ranks per a sharding plan and takes 3 Adam(1e-2)
steps on a (8, 16) token batch (the reference test's loss: mean CE of
the tied fp32 logits against the next token).  One world per world size
(workers from ``_torch_gspmd_worker.py``), each running all its cases:

* world 4, ``dp_tp`` on a 2 x 2 ``("data", "model")`` mesh against the
  reference's ``make_gspmd_train_step`` on a (2, 2) mesh of CPU devices
  from the same weights (``convert.flax_to_state_dict``): losses within
  1e-4 relative, parameters within 2e-4 relative and 2e-5 absolute (the
  reference's own bounds, ``tests/test_sharding.py``), by plan name and
  by ``transformer_param_spec``'s name → spec mapping; every moment at
  its parameter's placement; ``plans_for_mesh`` on real meshes; the
  reference's errors (a step before ``shard_fn``, a mesh without the
  plan's axes, a moment naming no parameter) and a missing data axis;
* world 2, ``tp`` (1 x 2; and GQA with 2 kv heads), ``fsdp`` and
  ``zero`` (2) against the replicated oracle (plain
  Adam in one process) within the same bounds, with the placements each
  plan must give (``zero``: parameters replicated, moments sharded);
  ``fsdp`` resumed from an unsharded optimizer's state after one step;
  and two same-shaped weights sharded differently, whose moments follow
  each one's name.

The port runs the flash adapter (its plain twin on the CPU) on each
rank's local heads; the reference runs dense attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

import _torch_gspmd_worker as worker
from chainermn_tpu.models.transformer import TransformerLM
from chainermn_tpu.parallel.sharding import make_gspmd_train_step
from chainermn_tpu_torch.convert import flax_to_state_dict
from chainermn_tpu_torch.parallel.sharding import build_device_mesh

LOSS_RTOL = 1e-4
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)


def reference_dp_tp():
    """The reference's plan-driven step at (2, 2): initial and final
    parameters (the port's layout) and the losses."""
    lm = TransformerLM(dtype=jnp.float32, **worker.LM)
    tokens, targets = worker.lm_batch()
    params = lm.init(jax.random.PRNGKey(1), jnp.asarray(tokens))
    init = {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree.map(np.asarray, params)).items()}

    def loss_fn(p, batch):
        return optax.softmax_cross_entropy_with_integer_labels(
            lm.apply(p, batch), jnp.roll(batch, -1, axis=1)).mean()

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    optimizer = optax.adam(worker.LR)
    step, shard_fn = make_gspmd_train_step(loss_fn, optimizer, mesh, "dp_tp",
                                           data_axis="data")
    p, o = shard_fn(params, optimizer.init(params))
    losses = []
    for _ in range(worker.STEPS):
        p, o, loss = step(p, o, jnp.asarray(tokens))
        losses.append(float(loss))
    final = {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree.map(np.asarray, p)).items()}
    return init, final, losses


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    init, final, losses = reference_dp_tp()
    tmp = tmp_path_factory.mktemp("gspmd4")
    np.savez(tmp / "init.npz", **init)
    ranks = worker.spawn("w4", 4, tmp, init=str(tmp / "init.npz"))
    return {"final": final, "losses": losses, "ranks": ranks}


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    return worker.spawn("w2", 2, tmp_path_factory.mktemp("gspmd2"))


def check_params(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), want[k], err_msg=k,
                                   **PARAM_TOL)


@pytest.mark.parametrize("case", ["dp_tp", "spec_tree"])
def test_dp_tp_matches_reference_step(w4, case):
    for r in w4["ranks"]:
        np.testing.assert_allclose(r[case]["losses"], w4["losses"],
                                   rtol=LOSS_RTOL)
    check_params(w4["ranks"][0][case]["params"], w4["final"])
    pl = w4["ranks"][0][case]["placements"]
    assert pl["layers.0.attention.query.weight"] == ["R", "S(0)"]
    assert pl["layers.1.attention.out.weight"] == ["R", "S(1)"]
    assert pl["layers.0.feed_forward.wi.weight"] == ["R", "S(0)"]
    assert pl["layers.0.feed_forward.wo.weight"] == ["R", "S(1)"]
    assert pl["embed.weight"] == ["R", "R"]


def test_moments_follow_their_parameter_placement(w4, w2):
    for m in w4["ranks"][0]["dp_tp"]["moments"]:
        assert m["exp_avg"] == m["param"]
    assert any("S(0)" in m["param"] for m in
               w4["ranks"][0]["dp_tp"]["moments"])
    for name in ("tp", "fsdp", "zero"):
        for m in w2[0][name]["moments"]:
            assert m["exp_avg"] == m["param"], name


def test_plans_for_a_device_mesh(w4):
    r = w4["ranks"][0]
    assert r["plans_2x2"] == ["dp", "dp_tp", "fsdp", "tp", "zero"]
    assert r["plans_data4"] == ["dp", "fsdp", "zero"]
    # validated against the model at the mesh's sizes: 2 kv heads divide
    assert r["plans_2x2_lm"] == ["dp", "dp_tp", "fsdp", "tp", "zero"]


@pytest.mark.parametrize("name,match", [
    ("before_shard_fn", "RuntimeError: gspmd step called before shard_fn"),
    ("axisless_mesh", "ValueError: sharding plan 'tp' shards over axes "
                      r"\['model'\] the mesh lacks"),
    ("no_data_axis", "ValueError: data_axis 'data' is not a dimension"),
    ("moment_miss", "ValueError: optimizer state entry 99 .* names no "
                    "parameter"),
])
def test_reference_errors(w4, name, match):
    import re

    for r in w4["ranks"]:
        assert r[name] is not None and re.match(match, r[name]), r[name]


@pytest.mark.parametrize("case", ["tp", "tp_gqa", "fsdp", "zero"])
def test_plans_match_the_replicated_oracle(w2, case):
    for r in w2:
        np.testing.assert_allclose(r[case]["losses"],
                                   r[case]["oracle_losses"], rtol=LOSS_RTOL)
    want = {k: np.asarray(v) for k, v in w2[0][case]["oracle_params"].items()}
    check_params(w2[0][case]["params"], want)


@pytest.mark.parametrize("case,query,moment", [
    ("tp", ["R", "S(0)"], ["R", "S(0)"]),
    ("fsdp", ["S(0)"], ["S(0)"]),
    ("zero", ["R"], ["S(0)"]),
])
def test_plan_placements(w2, case, query, moment):
    r = w2[0][case]
    assert r["placements"]["layers.0.attention.query.weight"] == query
    i = list(r["placements"]).index("layers.0.attention.query.weight")
    assert r["moments"][i]["exp_avg"] == moment
    # biases and norm scales replicate under every plan
    assert set(map(tuple, (v for k, v in r["placements"].items()
                           if "norm" in k))) == {("R",) * len(query)}


def test_fsdp_resumed_from_unsharded_state(w2):
    r = w2[0]["fsdp_resumed"]
    np.testing.assert_allclose(r["losses"], w2[0]["fsdp"]["oracle_losses"][1:],
                               rtol=LOSS_RTOL)
    want = {k: np.asarray(v) for k, v in w2[0]["fsdp"]["oracle_params"].items()}
    check_params(r["params"], want)


def test_moments_follow_name_not_shape(w2):
    two = w2[0]["two_kernels"]
    assert two["a.weight"]["param"] == ["R", "S(0)"]
    assert two["b.weight"]["param"] == ["R", "S(1)"]
    for p in two.values():
        assert p["exp_avg"] == p["exp_avg_sq"] == p["param"]
        assert p["step"] == "Tensor"        # scalar state stays a plain tensor


def test_cuda_mesh_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_device_mesh(None, (1, 1))
