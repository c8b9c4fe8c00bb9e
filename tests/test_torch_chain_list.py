"""The port's ``MultiNodeChainList`` against the JAX package's, at 2 and
4 gloo ranks (workers from ``_torch_dist_worker.py``) against meshes of as
many devices; the cases of ``tests/test_chain_list.py``.

Each component runs on its owner only; the chain's output is returned on
every rank and a loss computed from it on every rank counts once, so the
owner of each component holds the gradient the reference's replicated
forward gives it, and every other rank holds none.

Tolerances: forward rtol 1e-5 / atol 1e-6 and gradients rtol 1e-4 /
atol 1e-5, as the reference's own tests (fp32 products and tanh in
another summation order); the sharded tier against the replicated one
within 1e-6 (the same arithmetic on views of a flat row), and 4 Adam
steps of it against the reference's sharded tier rtol 1e-4 / atol 1e-5
(the reference's tolerance for the same comparison).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

import _torch_dist_worker as worker
from chainermn_tpu.communicators import build_mesh
from chainermn_tpu.communicators import create_communicator as jax_comm
from chainermn_tpu.links import MultiNodeChainList as JaxChain

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", params=(2, 4), ids=lambda n: f"{n}ranks")
def runs(request, tmp_path_factory):
    size = request.param
    return size, worker.spawn("chains", size,
                              tmp_path_factory.mktemp(f"chain{size}"))


def jdense(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def jmerge(p, xs):
    return xs[0] + xs[1]


def _comm(n):
    return jax_comm("naive", mesh=build_mesh(
        inter_size=1, intra_size=n, devices=jax.devices()[:n]))


def _jax_chain(comm, comps):
    chain = JaxChain(comm)
    for fn, owner, rin, rout in comps:
        jfn = jmerge if fn is worker._merge else jdense
        chain.add_link(jfn, rank=owner, rank_in=rin, rank_out=rout)
    return chain


@pytest.mark.parametrize("name", ["two_stage", "three_stage", "branching"])
def test_chain_forward_and_gradients_match_reference(runs, name):
    n, res = runs
    comps, shapes = worker.chain_specs(n)[name]
    if name != "two_stage" and n < 3:
        # Rank 2 is outside the world: every rank raises, naming it.
        for out in res:
            assert "names rank 2 outside the 2-rank world" in \
                out[name]["error"]
        return
    params = tuple(() if s is None else worker.chain_params(i, *s)
                   for i, s in enumerate(shapes))
    x = worker.chain_input(9, 5, 4)
    chain = _jax_chain(_comm(n), comps)
    want = np.asarray(chain.make_forward(batch_spec=P())(params, x))
    grads = jax.grad(lambda ps: jnp.sum(chain.make_forward(
        batch_spec=P(), jit=False)(ps, x) ** 2))(params)
    for r, out in enumerate(res):
        got = out[name]
        np.testing.assert_allclose(got["y"], want, **FWD,
                                   err_msg=f"{name} rank {r}")
        for i, (comp, g_ref) in enumerate(zip(comps, grads)):
            for k, g in got["grads"][i].items():
                if comp[1] == r:
                    np.testing.assert_allclose(
                        g, np.asarray(g_ref[k]), **GRAD,
                        err_msg=f"{name} rank {r} component {i} {k}")
                else:
                    assert g is None, (name, r, i, k)


def test_sharded_forward_matches_replicated(runs):
    """Each rank's row holds its own component only; the sharded forward
    equals the replicated one, and materialize round-trips the params."""
    n, res = runs
    sizes = {0: 4 * 16 + 16, n - 1: 16 * 2 + 2}
    x = worker.chain_input(2, 5, 4)
    p0, p1 = (worker.chain_params(10 + i, *s)
              for i, s in enumerate([(4, 16), (16, 2)]))
    want = np.asarray(jdense(p1, jdense(p0, x)))
    for r, out in enumerate(res):
        got = out["sharded"]
        assert got["row_numel"] == sizes.get(r, 0)
        assert got["equal"] and got["roundtrip"]
        np.testing.assert_allclose(got["y"], want, **FWD)


def test_sharded_training_matches_replicated_and_reference(runs):
    """4 Adam steps on one batch: the sharded tier equals the replicated
    tier (gradients summed over the ranks) and the reference's
    ``make_sharded_train_step``."""
    n, res = runs
    comm = _comm(n)
    params = [worker.chain_params(10 + i, *s)
              for i, s in enumerate([(4, 16), (16, 2)])]
    x, y = worker.chain_input(2, 6, 4), worker.chain_input(3, 6, 2)
    chain = JaxChain(comm)
    chain.add_link(lambda p, b: jdense(p, b["x"]), rank=0, rank_out=n - 1)
    chain.add_link(jdense, rank=n - 1, rank_in=0)
    opt = optax.adam(1e-2)
    flat = chain.shard_params(params)
    state = chain.init_sharded_opt_state(opt, flat)
    step = chain.make_sharded_train_step(
        opt, lambda o, b: jnp.mean((o - b["y"]) ** 2), donate=False)
    losses = []
    for _ in range(4):
        flat, state, loss = step(flat, state, {"x": x, "y": y})
        losses.append(float(loss))
    want = chain.materialize_params(flat)
    for r, out in enumerate(res):
        got = out["train"]
        np.testing.assert_allclose(got["sharded_losses"], losses, **GRAD)
        np.testing.assert_allclose(got["sharded_losses"],
                                   got["replicated_losses"], rtol=1e-6)
        assert got["sharded_losses"][-1] < got["sharded_losses"][0]
        for i in range(2):
            for k in ("w", "b"):
                np.testing.assert_allclose(got["sharded"][i][k],
                                           np.asarray(want[i][k]), **GRAD)
                np.testing.assert_allclose(got["sharded"][i][k],
                                           got["replicated"][i][k],
                                           rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case,match", [
    ("miswired", "no send"), ("no_output", "rank_out=None"),
    ("never_received", "never received"), ("length", "components")])
def test_chains_that_cannot_run_raise_without_hanging(runs, case, match):
    """Every rank raises ``ValueError`` before any transfer (the spawn's
    join limit holds the no-hang half)."""
    import re

    _, res = runs
    for out in res:
        assert re.search(match, out["errors"][case]), out["errors"][case]
