"""The port's expert parallelism against the JAX package's.

The routing cases of ``tests/test_moe.py`` on the same inputs through
both packages (top-1 capacity, top-2 renormalisation and choice-major
capacity priority, the top-1 combine weight, a degenerate second choice,
the dropped fraction, the load-balancing loss), and random logits routed
by both (dispatch exactly, combine within 1e-6).  Then ``moe_layer`` at 1
rank (in this process), 2 and 4 gloo ranks (workers from
``_torch_sp_worker.py``) against the reference's inside ``shard_map`` on
as many CPU devices and against the one-device oracle, for top-1
(capacity factor 4), top-2 (2) and two experts a rank (``epd`` 2): each
rank's output, its aux dict (load-balance loss and dropped fraction), the
router's gradient of ``sum(y ** 2)`` summed over the ranks and each
rank's experts' gradients.  fp32 throughout: outputs and aux within 2e-5
(the reference's own oracle bound is 2e-4 relative), gradients within
1e-4.  The deprecated ``return_aux="scalar"`` form warns and returns the
dict's loss; a router of the wrong width is refused with the reference's
message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_sp_worker as worker
from chainermn_tpu.communicators import build_mesh
from chainermn_tpu.communicators.base import shard_map_compat as shard_map
from chainermn_tpu.parallel import moe as jm
from chainermn_tpu_torch.parallel import moe as tm

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _both(fn_name, logits, *args, **kw):
    j = getattr(jm, fn_name)(jnp.asarray(logits), *args, **kw)
    t = getattr(tm, fn_name)(torch.tensor(np.asarray(logits, np.float32)),
                             *args, **kw)
    return j, t


ROUTES = {
    "top1_capacity": (np.array([[5.0, 0.0], [4.0, 0.0], [3.0, 0.0],
                                [0.0, 2.0]]), 2, 2, 1),
    "top2_priority": (np.array([[5.0, 4.0, 0.0], [5.0, 4.0, 0.0]]), 3, 1, 2),
    "top1_prob": (np.array([[1.0, 0.0, 0.0, 0.0]]), 4, 1, 1),
    "degenerate": (np.array([[200.0, 0.0, 0.0]]), 3, 2, 2),
    "random_top1": (np.random.RandomState(0).randn(24, 4), 4, 5, 1),
    "random_top2": (np.random.RandomState(1).randn(24, 4), 4, 8, 2),
    "random_top3": (np.random.RandomState(2).randn(16, 6), 6, 3, 3),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_topk_route_matches_reference(name):
    logits, E, cap, k = ROUTES[name]
    (jd, jc), (td, tc) = _both("topk_route", logits, E, cap, k=k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)


def test_routing_cases_of_the_reference():
    (_, _), (d, c) = _both("topk_route", *ROUTES["top1_capacity"][:1], 2, 2)
    # Tokens 0 and 1 fill expert 0's two slots; token 2 is dropped.
    assert d[0, 0, 0] == 1 and d[0, 1, 1] == 1 and d[:, :, 2].sum() == 0
    assert d[1, 0, 3] == 1 and 0 < float(c[0, 0, 0]) <= 1
    assert 1.0 - float(d.sum()) / 4 == 0.25          # the dropped fraction
    # Top-2 with ample capacity: both choices kept, gates renormalised.
    logits = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    d, c = tm.topk_route(torch.from_numpy(logits), 4, 8, k=2)
    np.testing.assert_allclose(c.sum(dim=(0, 1)).numpy(), np.ones(8),
                               rtol=1e-5)
    assert float(d.sum()) == 16.0
    # Choice-major priority: token 0's first choice takes expert 0's slot,
    # token 1's is dropped, token 0's second choice takes expert 1's.
    d, _ = tm.topk_route(torch.tensor([[5.0, 4.0, 0.0], [5.0, 4.0, 0.0]]),
                         3, 1, k=2)
    assert d[0, 0, 0] == 1 and d[0, 0, 1] == 0 and d[1, 0, 0] == 1
    # Top-1 combine is the router probability, not renormalised.
    _, c = tm.top1_route(torch.tensor([[1.0, 0.0, 0.0, 0.0]]), 4, 1)
    np.testing.assert_allclose(float(c.sum()),
                               float(torch.softmax(torch.tensor(
                                   [1.0, 0.0, 0.0, 0.0]), 0)[0]), rtol=1e-6)
    # A second choice from zero remaining mass burns no slot.
    d, _ = tm.topk_route(torch.tensor([[200.0, 0.0, 0.0]]), 3, 2, k=2)
    assert float(d.sum()) == 1.0


@pytest.mark.parametrize("seed,uniform", [(0, False), (1, False),
                                          (2, True)])
def test_load_balancing_loss_matches_reference(seed, uniform):
    logits = np.random.RandomState(seed).randn(32, 4).astype(np.float32)
    if uniform:
        logits = np.tile(np.eye(4, dtype=np.float32) * 5, (8, 1))
    j, t = _both("load_balancing_loss", logits, 4)
    np.testing.assert_allclose(float(t), float(j), rtol=1e-6)
    if uniform:
        np.testing.assert_allclose(float(t), 1.0, rtol=1e-2)


def _jexpert(params, x):
    return jnp.tanh(x @ params["w"]) @ params["w2"]


def reference_moe(n: int, name: str) -> dict:
    """``moe_layer`` on ``n`` devices: every rank's output and aux, the
    gradients of ``sum(y ** 2)`` and the reference's oracle per rank."""
    k, cf, epd = worker.MOE_CASES[name]
    inp = {a: jnp.asarray(b) for a, b in worker.moe_inputs(name, n).items()}
    mesh = build_mesh(inter_size=1, intra_size=n, devices=jax.devices()[:n])

    def body(x, gate_w, w, w2):
        experts = {"w": w, "w2": w2}
        if epd == 1:
            experts = jax.tree.map(lambda p: p[0], experts)
        y, aux = jm.moe_layer(x, gate_w, _jexpert, experts, "intra",
                              capacity_factor=cf, k=k, return_aux=True,
                              experts_per_device=epd)
        return y, jax.tree.map(lambda a: a[None], aux)

    f = shard_map(body, mesh=mesh,
                  in_specs=(P("intra"), P(), P("intra"), P("intra")),
                  out_specs=(P("intra"), P("intra")), check_vma=False)

    def loss(gate_w, w, w2):
        y, aux = f(inp["x"], gate_w, w, w2)
        return jnp.sum(y ** 2), (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(inp["gate_w"], inp["w"],
                                                inp["w2"])
    T = worker.MOE_T
    oracle = [jm.dense_moe_oracle(inp["x"][r * T:(r + 1) * T], inp["gate_w"],
                                  _jexpert, {"w": inp["w"], "w2": inp["w2"]},
                                  capacity_factor=cf, k=k) for r in range(n)]
    return {"y": np.asarray(y), "aux": jax.tree.map(np.asarray, aux),
            "grads": [np.asarray(g) for g in grads],
            "oracle": [np.asarray(o) for o in oracle]}


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda n: f"{n}rank")
def runs(request, tmp_path_factory):
    n = request.param
    if n == 1:
        from chainermn_tpu_torch import create_communicator

        comm = create_communicator("naive", device="cpu")
        ranks = [{name: worker.moe_case(comm, name)
                  for name in worker.MOE_CASES}]
    else:
        ranks = worker.spawn("moe", n, tmp_path_factory.mktemp(f"moe{n}"))
    return n, ranks


@pytest.mark.parametrize("name", sorted(worker.MOE_CASES))
def test_moe_layer_matches_reference(runs, name):
    n, ranks = runs
    ref = reference_moe(n, name)
    epd = worker.MOE_CASES[name][2]
    T = worker.MOE_T
    for r, res in enumerate(ranks):
        got = res[name]
        y_ref = ref["y"][r * T:(r + 1) * T]
        np.testing.assert_allclose(np.asarray(got["y"]), y_ref, **TOL)
        # The oracle routes this rank's tokens over every expert.
        np.testing.assert_allclose(np.asarray(got["oracle"]), y_ref, **TOL)
        np.testing.assert_allclose(ref["oracle"][r], y_ref, rtol=2e-4,
                                   atol=2e-5)
        for a in ("load_balance_loss", "dropped_fraction"):
            np.testing.assert_allclose(got["aux"][a], ref["aux"][a][r],
                                       **TOL)
        g_gate, g_w, g_w2 = ref["grads"]
        np.testing.assert_allclose(np.asarray(got["gate_w"]), g_gate,
                                   **GRAD_TOL)
        mine = slice(r * epd, (r + 1) * epd)
        np.testing.assert_allclose(np.asarray(got["w"]), g_w[mine],
                                   **GRAD_TOL)
        np.testing.assert_allclose(np.asarray(got["w2"]), g_w2[mine],
                                   **GRAD_TOL)
        # One expert in all routes every token with probability 1: then
        # the router has no gradient.
        moved = ("w", "w2") + (("gate_w",) if n * epd > 1 else ())
        assert all(np.abs(np.asarray(got[p])).sum() > 0 for p in moved)


def test_scalar_shim_and_gate_width(runs):
    """``return_aux="scalar"`` warns (``DeprecationWarning``) and returns
    the dict's load-balance loss with the same output; a router routing to
    more experts than the layout holds is refused."""
    n, ranks = runs
    for res in ranks:
        top1 = res["top1"]
        assert top1["shim"]["warned"] == ["DeprecationWarning"]
        assert top1["shim"]["y_equal"]
        assert top1["shim"]["lbl"] == top1["aux"]["load_balance_loss"]
        assert "experts/device" in top1["gate_error"]
    with pytest.warns(DeprecationWarning, match="scalar"):
        from chainermn_tpu_torch import create_communicator

        comm = create_communicator("naive", device="cpu")
        x = torch.zeros(4, worker.MOE_D)
        p = {"w": torch.zeros(worker.MOE_D, 16),
             "w2": torch.zeros(16, worker.MOE_D)}
        tm.moe_layer(x, torch.zeros(worker.MOE_D, 1), worker.moe_expert_fn,
                     p, comm, return_aux="scalar")
