"""The port's model-parallel functions (``send``/``recv``, ``send_recv``,
``ring_exchange``, ``pseudo_connect``, the differentiable collectives)
against the JAX package, at 2 and 4 gloo ranks (workers from
``_torch_dist_worker.py``) against meshes of as many devices; the cases
of ``tests/test_functions.py``.

The reference differentiates one SPMD program; its objective is the sum
over the ranks of each rank's loss.  Each port rank computes its own loss
and runs its own backward, so each rank's input gradient is held to the
reference's gradient for that rank's block of the same total objective.

Tolerances: transfers are copies, so values that travel are compared
exactly; collectives sum in another order, so their values and
gradients are held to rtol 1e-5 (atol 1e-6 for sums near zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import _torch_dist_worker as worker
from chainermn_tpu import functions as JF
from chainermn_tpu.communicators import build_mesh
from chainermn_tpu.communicators import create_communicator as jax_comm
from chainermn_tpu_torch import functions as F
from chainermn_tpu_torch.functions import DelegateVariable, pseudo_connect

COLL = dict(rtol=1e-5, atol=1e-6)
SIZES = (2, 4)


@pytest.fixture(scope="module", params=SIZES, ids=lambda n: f"{n}ranks")
def runs(request, tmp_path_factory):
    size = request.param
    return size, worker.spawn("functions", size,
                              tmp_path_factory.mktemp(f"fn{size}"))


def _comm(n):
    return jax_comm("naive", mesh=build_mesh(
        inter_size=1, intra_size=n, devices=jax.devices()[:n]))


def reference(n, body, xs, ws):
    """The reference's per-rank outputs of ``body(comm, x, rank)`` and the
    gradient of the total objective ``sum_r sum(body(x_r) * w_r)``."""
    comm = _comm(n)
    spec = comm._world_spec

    def loss(x, w):
        y = body(comm, x[0], comm.axis_index())
        return jax.lax.psum(jnp.sum(y * w[0]), comm.axes), y[None]

    grads, ys = jax.jit(jax.grad(lambda x: comm.shard_map(
        loss, in_specs=(spec, spec), out_specs=(P(), spec))(x, ws),
        has_aux=True))(xs)
    return np.asarray(ys), np.asarray(grads)


def test_send_recv_forward_and_gradient(runs):
    """``send_recv``: the destination gets the source's value, the others
    zeros; the destination's loss reaches the source's input."""
    n, res = runs
    xs = (10.0 + np.arange(n, dtype=np.float32))[:, None]
    ws = np.zeros((n, 1), np.float32)
    ws[n - 1] = 1.0

    def body(comm, x, rank):
        got = JF.send_recv(x, comm, src=0, dst=n - 1)
        return got * got * 3.0

    ys, grads = reference(n, body, xs, ws)
    for r, out in enumerate(res):
        got = out["send_recv"]
        assert got["value"] == (10.0 if r == n - 1 else 0.0)
        np.testing.assert_allclose(got["grad"], grads[r, 0], rtol=1e-6)


def test_gradient_flows_back_to_sender(runs):
    """d/dx of a loss computed on the receiving rank lands on the sending
    rank: loss = (3 x0)^2, so d/dx0 = 18 x0 = 18 (as the reference's)."""
    n, res = runs
    xs = (np.arange(n, dtype=np.float32) + 1.0)[:, None]
    ws = np.zeros((n, 1), np.float32)
    ws[n - 1] = 1.0

    def body(comm, x, rank):
        d = JF.send(x * 3.0, comm, rank=n - 1, src=0)
        return JF.recv(comm, 0, delegate_variable=d) ** 2

    _, grads = reference(n, body, xs, ws)
    assert res[n - 1]["received"] == 3.0
    np.testing.assert_allclose(res[0]["sender_grad"], grads[0, 0], rtol=1e-6)
    assert res[0]["sender_grad"] == 18.0


def test_pseudo_connect_grafts_gradient(runs):
    """A send whose value has no local consumer still gets its gradient
    through ``pseudo_connect``: loss (2 x0)^2 on rank 1, d/dx0 = 40."""
    _, res = runs
    assert res[0]["grafted_grad"] == 40.0


def test_delegates_merge_and_tuple_payloads(runs):
    """Two sends' delegates merged into one reach both senders; a tuple
    payload arrives with its integer leaf, which carries no gradient."""
    _, res = runs
    assert res[0]["merged_is_delegate"]
    assert res[0]["merged_grads"] == [[10.0, 10.0], [42.0]]
    assert res[1]["tuple_payload"] == [[2.0, 4.0], [7, 8], "torch.int64",
                                       False, [9.0]]


def test_send_to_self_is_a_pass_through(runs):
    _, res = runs
    assert all(out["self_grad"] == 64.0 for out in res)   # d(4s)^2/ds


def test_ring_exchange(runs):
    n, res = runs
    shift = 2 if n > 2 else 1
    xs = np.arange(n, dtype=np.float32)[:, None]
    ws = (np.arange(n, dtype=np.float32) + 1.0)[:, None]
    ys, grads = reference(
        n, lambda comm, x, r: JF.point_to_point.ring_exchange(x, comm, shift),
        xs, ws)
    np.testing.assert_array_equal(ys[:, 0], np.roll(np.arange(n), shift))
    for r, out in enumerate(res):
        assert out["ring"]["value"] == ys[r, 0]
        assert out["ring"]["grad"] == grads[r, 0]


@pytest.mark.parametrize("name", list(worker.coll_cases(2)))
def test_collective_forward_and_gradient(runs, name):
    """Each collective's values, and the gradient its backward (the
    transpose collective) gives each rank's input, against the
    reference's for the same total objective."""
    n, res = runs
    kw, _ = worker.coll_cases(n)[name]
    xs, ws = worker.coll_inputs(n, name)
    fn = getattr(JF, name.split("_")[0])
    ys, grads = reference(n, lambda comm, x, r: fn(comm, x, **kw), xs, ws)
    for r, out in enumerate(res):
        got = out["coll"][name]
        np.testing.assert_allclose(got["y"], ys[r], **COLL,
                                   err_msg=f"{name} rank {r} value")
        np.testing.assert_allclose(got["grad"], grads[r], **COLL,
                                   err_msg=f"{name} rank {r} gradient")


def test_delegate_api_on_one_process():
    """The pieces that need no peer: merging (``+``), grafting into a
    tensor that carries no gradient of its own, and the checks."""
    import torch

    from chainermn_tpu_torch import create_communicator

    tok = torch.zeros(0, requires_grad=True)
    d1 = DelegateVariable(tok, None, 1)
    out = pseudo_connect(d1, torch.full((2,), 7.0))
    assert out.tolist() == [7.0, 7.0] and out.requires_grad
    out.sum().backward()
    assert tok.grad is not None and tok.grad.numel() == 0
    merged = d1 + d1
    assert isinstance(merged, DelegateVariable)
    assert pseudo_connect(d1) is d1
    comm = create_communicator("naive", device="cpu")
    with pytest.raises(ValueError, match="delegate_variable"):
        F.recv(comm, 0)
    with pytest.raises(ValueError, match="src"):
        F.send(torch.ones(1), comm, 0, src=1)
    with pytest.raises(ValueError, match="outside"):
        F.send(torch.ones(1), comm, 3)
