"""The port's multi-node optimizer against the JAX package.

Mirrors tests/test_optimizer.py's contracts — the distributed step equals
the single-device step on the full batch, double buffering applies the
previous step's mean, and equal microbatches accumulate to the full-batch
gradient — with the reference's multi-node optimizer on the 8-device CPU
mesh as the oracle, fed the same numpy problem.  The port runs over a
one-rank gloo group here (tests/test_torch_communicator.py runs it at two
ranks).  Everything is fp32 on a 4-parameter linear model, so trajectories
agree to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chainermn_tpu.communicators import build_mesh
from chainermn_tpu.communicators import create_communicator as jax_comm
from chainermn_tpu.optimizers import create_multi_node_optimizer as jax_mno
from chainermn_tpu_torch import (
    MultiNodeOptimizer,
    create_communicator,
    create_multi_node_optimizer,
)

TOL = dict(rtol=1e-6, atol=1e-6)


def make_problem(seed=0, n=64, d=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    y = rng.randn(n, 1).astype(np.float32)
    w = rng.randn(d, 1).astype(np.float32)
    return x, y, w


def jax_loss(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] + params["b"] - y) ** 2)


def jax_run(devices8, opt, steps, **step_kw):
    x, y, w = make_problem()
    mesh = build_mesh(inter_size=1, intra_size=8, devices=devices8)
    mno = jax_mno(opt, jax_comm("xla_ici", mesh=mesh),
                  double_buffering=step_kw.pop("double_buffering", False))
    params = {"w": jnp.asarray(w), "b": jnp.zeros((1,), jnp.float32)}
    state = mno.init(params)
    step = mno.make_train_step(jax_loss, donate=False, **step_kw)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state,
                                   (jnp.asarray(x), jnp.asarray(y)))
        losses.append(float(loss))
    return np.asarray(params["w"]), np.asarray(params["b"]), losses


def port_run(make_opt, comm_name, steps, double_buffering=False, **step_kw):
    x, y, w = make_problem()
    wp = torch.nn.Parameter(torch.from_numpy(w))
    bp = torch.nn.Parameter(torch.zeros(1))
    comm = create_communicator(comm_name, device="cpu")
    mno = create_multi_node_optimizer(make_opt([wp, bp]), comm,
                                      double_buffering=double_buffering)
    mno.init()
    step = mno.make_train_step(
        lambda b: ((b[0] @ wp + bp - b[1]) ** 2).mean(), **step_kw)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    losses = [float(step(batch)) for _ in range(steps)]
    return wp.detach().numpy(), bp.detach().numpy(), losses, mno


@pytest.mark.parametrize("name", ["naive", "xla_ici", "pure_nccl",
                                  "hierarchical"])
def test_matches_single_device_sgd(devices8, name):
    jw, jb, jl = jax_run(devices8, optax.sgd(0.1), 3)
    w, b, losses, _ = port_run(lambda p: torch.optim.SGD(p, lr=0.1), name, 3)
    np.testing.assert_allclose(w, jw, **TOL)
    np.testing.assert_allclose(b, jb, **TOL)
    np.testing.assert_allclose(losses, jl, rtol=1e-6)
    # And the single-device oracle: plain full-batch SGD in torch.
    x, y, w0 = make_problem()
    wr = torch.nn.Parameter(torch.from_numpy(w0))
    br = torch.nn.Parameter(torch.zeros(1))
    sgd = torch.optim.SGD([wr, br], lr=0.1)
    for _ in range(3):
        sgd.zero_grad()
        ((torch.from_numpy(x) @ wr + br - torch.from_numpy(y)) ** 2).mean() \
            .backward()
        sgd.step()
    np.testing.assert_allclose(w, wr.detach().numpy(), **TOL)


def test_double_buffering_is_one_step_stale(devices8):
    jw, jb, jl = jax_run(devices8, optax.sgd(0.1), 3, double_buffering=True)
    w, b, losses, mno = port_run(lambda p: torch.optim.SGD(p, lr=0.1),
                                 "xla_ici", 3, double_buffering=True)
    np.testing.assert_allclose(w, jw, **TOL)
    np.testing.assert_allclose(b, jb, **TOL)
    np.testing.assert_allclose(losses, jl, rtol=1e-6)
    assert mno.step_count == 3
    # Step 0 reduces only and leaves the parameters unchanged.
    w1, _, _, _ = port_run(lambda p: torch.optim.SGD(p, lr=0.1), "xla_ici",
                            1, double_buffering=True)
    np.testing.assert_array_equal(w1, make_problem()[2])


@pytest.mark.parametrize("n_accum", [2, 4])
def test_grad_accumulation_matches_full_batch(devices8, n_accum):
    def mom(p):
        return torch.optim.SGD(p, lr=0.1, momentum=0.9)

    jw, jb, jl = jax_run(devices8, optax.sgd(0.1, momentum=0.9), 3,
                         n_accum=n_accum)
    w, b, losses, _ = port_run(mom, "xla_ici", 3, n_accum=n_accum)
    np.testing.assert_allclose(w, jw, **TOL)
    np.testing.assert_allclose(b, jb, **TOL)
    np.testing.assert_allclose(losses, jl, rtol=1e-6)
    wf, bf, lf, _ = port_run(mom, "xla_ici", 3)
    np.testing.assert_allclose(w, wf, **TOL)
    np.testing.assert_allclose(losses, lf, rtol=1e-6)


def test_loss_scale_and_adamw_match_reference(devices8):
    """Scaled loss, unscaled once before the update; AdamW with every
    argument pinned (torch's defaults differ from optax's)."""
    jw, jb, jl = jax_run(devices8, optax.adamw(1e-2, b1=0.9, b2=0.999,
                                               eps=1e-8, weight_decay=0.1),
                         3, loss_scale=1024.0)
    w, b, losses, _ = port_run(
        lambda p: torch.optim.AdamW(p, lr=1e-2, betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=0.1),
        "xla_ici", 3, loss_scale=1024.0)
    np.testing.assert_allclose(w, jw, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b, jb, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(losses, jl, rtol=1e-6)


def test_contract_errors():
    comm = create_communicator("xla_ici", device="cpu")
    p = torch.nn.Parameter(torch.zeros(4, 1))
    zero = create_multi_node_optimizer(torch.optim.SGD([p], lr=0.1), comm,
                                       zero_stage=1)
    with pytest.raises(RuntimeError, match="init"):
        zero.make_train_step(lambda b: b.sum())
    q = torch.nn.Parameter(torch.zeros(2))
    two_groups = torch.optim.SGD([{"params": [p]},
                                  {"params": [q], "lr": 0.5}], lr=0.1)
    with pytest.raises(ValueError, match="hyperparameters"):
        create_multi_node_optimizer(two_groups, comm, zero_stage=2).init()
    with pytest.raises(ValueError, match="zero_stage"):
        MultiNodeOptimizer(torch.optim.SGD([p], lr=0.1), comm, zero_stage=4)
    mno = create_multi_node_optimizer(torch.optim.SGD([p], lr=0.1), comm)
    with pytest.raises(ValueError, match="n_accum"):
        mno.make_train_step(lambda b: b.sum(), n_accum=0)
    step = mno.make_train_step(lambda b: (b[0] @ p).mean(), n_accum=3)
    with pytest.raises(ValueError, match="divisible"):
        step((torch.zeros(64, 4),))


def test_broadcast_params_replicates_rank0(tmp_path):
    """At 2 gloo ranks with parameters that differ by rank:
    ``broadcast_params`` of a mapping, then of the wrapped optimizer's
    parameters (the default), leaves every rank with rank 0's values."""
    import _torch_dist_worker as worker

    res = worker.spawn("broadcast_params", 2, tmp_path)
    assert res[0]["before"] != res[1]["before"]
    for out in res:
        assert out["w"] == [1.0] * 6
        assert out["b"] == [0.0, 1.0, 2.0, 3.0]
        assert out["extra"] == [10.0, 10.0]


def _jax_aux_run(devices, n_accum, steps=2):
    """The reference's ``has_aux`` step on ``len(devices)`` devices over
    the worker's problem; device 0's aux (its ``P()`` output)."""
    import _torch_dist_worker as worker

    x, y, w = worker.aux_problem()
    mesh = build_mesh(inter_size=1, intra_size=len(devices), devices=devices)
    mno = jax_mno(optax.sgd(0.1), jax_comm("xla_ici", mesh=mesh))
    params = {"w": jnp.asarray(w), "b": jnp.zeros((1,), jnp.float32)}
    state = mno.init(params)

    def loss_fn(p, b):
        loss = jnp.mean((b[0] @ p["w"] + p["b"] - b[1]) ** 2)
        return loss, {"l2": jnp.sum(p["w"] ** 2), "x0": b[0][0, 0]}

    step = mno.make_train_step(loss_fn, donate=False, has_aux=True,
                               n_accum=n_accum)
    runs = []
    for _ in range(steps):
        params, state, loss, aux = step(params, state,
                                        (jnp.asarray(x), jnp.asarray(y)))
        runs.append({"loss": float(loss),
                     "aux": {k: np.asarray(v) for k, v in aux.items()},
                     "w": np.asarray(params["w"]).ravel()})
    return runs


@pytest.mark.parametrize("size", [1, 2])
def test_has_aux_matches_reference(devices8, tmp_path, size):
    """``has_aux`` at ``n_accum`` 1 and 2 on ``size`` gloo ranks: rank 0's
    aux (a parameter norm and a value of its microbatch, stacked over the
    microbatches at ``n_accum`` 2), the loss and the weights equal the
    reference's on as many devices."""
    import _torch_dist_worker as worker

    res = worker.spawn("aux", size, tmp_path)
    for n_accum in (1, 2):
        want = _jax_aux_run(devices8[:size], n_accum)
        for r, out in enumerate(res):
            for got, ref in zip(out[str(n_accum)], want):
                np.testing.assert_allclose(got["loss"], ref["loss"], **TOL)
                np.testing.assert_allclose(got["w"], ref["w"], **TOL)
                np.testing.assert_allclose(got["aux"]["l2"],
                                           ref["aux"]["l2"], **TOL)
                assert np.shape(got["aux"]["x0"]) == ref["aux"]["x0"].shape
                if r == 0:
                    np.testing.assert_array_equal(got["aux"]["x0"],
                                                  ref["aux"]["x0"])


def test_rng_generator_contract():
    """``rng``: ``loss_fn(batch, generator)`` gets a generator seeded per
    (seed, step, rank, microbatch); steps and microbatches draw different
    streams, a rerun draws the same ones, and ``setup`` takes ``rng`` and
    ``has_aux`` (``update`` then returns ``(loss, aux)``)."""
    from chainermn_tpu_torch.optimizers import rng_seed

    def run(seed):
        wp = torch.nn.Parameter(torch.ones(4, 1))
        comm = create_communicator("naive", device="cpu")
        mno = create_multi_node_optimizer(torch.optim.SGD([wp], lr=0.0),
                                          comm)
        draws = []

        def loss_fn(b, gen):
            assert isinstance(gen, torch.Generator)
            draws.append(torch.rand(3, generator=gen).tolist())
            return (b[0] @ wp).mean(), {"u": torch.tensor(draws[-1])}

        mno.setup(wp, loss_fn, n_accum=2, has_aux=True, rng=seed)
        batch = (torch.ones(4, 4),)
        auxs = [mno.update(batch)[1]["u"] for _ in range(2)]
        return draws, auxs

    draws, auxs = run(7)
    assert len(draws) == 4 and len({tuple(d) for d in draws}) == 4
    assert run(7)[0] == draws and run(8)[0] != draws
    assert [a.shape for a in auxs] == [(2, 3), (2, 3)]
    assert auxs[1].tolist() == draws[2:]
    g = torch.Generator().manual_seed(rng_seed(7, 1, 0, 1))
    assert torch.rand(3, generator=g).tolist() == draws[3]
    assert len({rng_seed(7, s, r, m) for s in range(3) for r in range(3)
                for m in range(3)}) == 27
