"""The port's vocab-parallel embedding and cross-entropy against the JAX
package's.

Every case of ``_torch_sp_worker.vocab_case`` runs on the port at 1 rank
(in this process), 2 and 4 gloo ranks, and on the reference inside
``shard_map`` over as many CPU devices (axis ``model``), on the same
seeded numpy inputs (vocabulary 64, rank ``i`` owning rows ``[64 i / n,
64 (i+1) / n)``):

* ``vocab_parallel_embed`` with ``grad_reduce=False`` (the same
  cotangent on every rank): the replicated lookup and each rank's table
  gradient, also against ``F.embedding``;
* ``grad_reduce=True`` with each rank's loss on its own sequence slice:
  every rank's rows collect every position's cotangent (against the
  dense ``take`` gradient too);
* ``gather_seq_for_replicated_head``: the gathered tensor, and a 1x
  gradient (a plain all-gather's reduce-scatter would give n x);
* ``vocab_parallel_cross_entropy`` (chunk 16) with and without ignored
  (-1) labels: the loss, ``d hidden`` and each rank's ``d table`` shard,
  against the reference's and against the port's unsharded
  ``fused_cross_entropy``;
* SP + vocab-TP end to end (sharded embed, a stand-in layer on this
  rank's sequence slice, the head gather, the sharded CE): the loss, the
  table shard's and the layer's gradients.

Tolerances: the lookup and the embedding gradients are sums of the same
fp32 numbers, 1e-6.  The cross-entropy casts its products' operands and
``dlogits`` to bf16 as the reference does, and the cross-shard sums of
the row statistics change the last bits of the lse, which can move a
bf16 rounding of ``dlogits``: the loss within 1e-5 relative, gradients
within 1e-4 absolute (a few bf16 ulps of the O(1e-2) entries), as in
``test_torch_fused_ce.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import _torch_sp_worker as worker
from chainermn_tpu.communicators.base import shard_map_compat as shard_map
from chainermn_tpu.parallel import sharding as js
from chainermn_tpu_torch.ops.fused_ce import fused_cross_entropy

EXACT = dict(rtol=1e-6, atol=1e-6)
LOSS_RTOL = 1e-5
CE_GRAD_ATOL = 1e-4


def reference(n: int) -> dict:
    inp = {k: jnp.asarray(v) for k, v in worker.vocab_inputs().items()}
    mesh = Mesh(np.array(jax.devices()[:n]), ("model",))

    def smap(body, in_specs, out_specs):
        return jax.jit(shard_map(body, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))

    toks, emb, w = inp["toks"], inp["emb"], inp["w"]
    S_loc = toks.shape[1] // n
    out = {}
    out["embed_out"] = smap(lambda t, e: js.vocab_parallel_embed(
        t, e, "model"), (P(), P("model")), P())(toks, emb)
    out["embed_grad"] = smap(lambda t, e, w: jax.grad(
        lambda e: jnp.sum(js.vocab_parallel_embed(t, e, "model") * w))(e),
        (P(), P("model"), P()), P("model"))(toks, emb, w)

    def grad_reduce(t, e, w):
        my = jax.lax.axis_index("model")

        def loss(e):
            x_f = js.vocab_parallel_embed(t, e, "model", True)
            x_l = jax.lax.dynamic_slice_in_dim(x_f, my * S_loc, S_loc, 1)
            w_l = jax.lax.dynamic_slice_in_dim(w, my * S_loc, S_loc, 1)
            return jnp.sum(x_l * w_l)

        return jax.grad(loss)(e)

    out["embed_grad_reduce"] = smap(grad_reduce, (P(), P("model"), P()),
                                    P("model"))(toks, emb, w)

    def gather(x, xw):
        my = jax.lax.axis_index("model")
        x_l = jax.lax.dynamic_slice_in_dim(x, my * S_loc, S_loc, 1)

        def loss(x_l):
            return jnp.sum(js.gather_seq_for_replicated_head(
                x_l, "model", 1) * xw)

        return (js.gather_seq_for_replicated_head(x_l, "model", 1),
                jax.lax.all_gather(jax.grad(loss)(x_l), "model", axis=1,
                                   tiled=True))

    out["gather_out"], out["gather_grad"] = smap(
        gather, (P(), P()), (P(), P()))(inp["x"], inp["xw"])
    for name, neg in (("ce", False), ("ce_ignored", True)):
        lab = jnp.where(inp["mask"], -1, inp["labels"]) if neg \
            else inp["labels"]
        loss, (gh, ge) = smap(
            lambda h, e, l: jax.value_and_grad(
                lambda h, e: js.vocab_parallel_cross_entropy(
                    h, e, l, "model", chunk=16), argnums=(0, 1))(h, e),
            (P(), P("model"), P()), (P(), (P(), P("model"))))(
                inp["h"], inp["ce_emb"], lab)
        out[name] = (loss, gh, ge)

    def e2e(t, labels, e, wl):
        my = jax.lax.axis_index("model")

        def loss(e, wl):
            x_f = js.vocab_parallel_embed(t, e, "model", True)
            x_l = jax.lax.dynamic_slice_in_dim(x_f, my * S_loc, S_loc, 1)
            h_f = js.gather_seq_for_replicated_head(jnp.tanh(x_l @ wl),
                                                    "model", 1)
            return js.vocab_parallel_cross_entropy(h_f, e, labels, "model",
                                                   chunk=8)

        lv, (ge, gw) = jax.value_and_grad(loss, argnums=(0, 1))(e, wl)
        return lv, ge, jax.lax.psum(gw, "model")

    out["e2e"] = smap(e2e, (P(), P(), P("model"), P()),
                      (P(), P("model"), P()))(
        toks, inp["e2e_labels"], inp["e2e_emb"], inp["e2e_w"])
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda n: f"{n}rank")
def runs(request, tmp_path_factory):
    n = request.param
    if n == 1:
        from chainermn_tpu_torch import create_communicator

        ranks = [worker.vocab_case(create_communicator("naive",
                                                       device="cpu"))]
    else:
        ranks = worker.spawn("vocab", n, tmp_path_factory.mktemp(f"v{n}"))
    return n, ranks, reference(n)


def _rows(a, r, n):
    v = a.shape[0] // n
    return a[r * v:(r + 1) * v]


def test_embed_matches_reference(runs):
    n, ranks, ref = runs
    inp = worker.vocab_inputs()
    dense = F.embedding(torch.from_numpy(inp["toks"]).long(),
                        torch.from_numpy(inp["emb"])).numpy()
    np.testing.assert_allclose(ref["embed_out"], dense, **EXACT)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(np.asarray(res["embed"]["out"]),
                                   ref["embed_out"], **EXACT)
        np.testing.assert_allclose(np.asarray(res["embed"]["grad"]),
                                   _rows(ref["embed_grad"], r, n), **EXACT)


def test_embed_grad_reduce_collects_every_position(runs):
    """``grad_reduce=True``: each rank reads its own sequence slice, and
    its rows still get every position's cotangent — the gradient of the
    dense lookup."""
    n, ranks, ref = runs
    inp = worker.vocab_inputs()
    e = torch.from_numpy(inp["emb"]).requires_grad_()
    (dense,) = torch.autograd.grad(
        (F.embedding(torch.from_numpy(inp["toks"]).long(), e)
         * torch.from_numpy(inp["w"])).sum(), [e])
    np.testing.assert_allclose(ref["embed_grad_reduce"], dense.numpy(),
                               **EXACT)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(
            np.asarray(res["embed_grad_reduce"]["grad"]),
            _rows(ref["embed_grad_reduce"], r, n), **EXACT)


def test_gather_head_gradient_is_1x(runs):
    n, ranks, ref = runs
    inp = worker.vocab_inputs()
    np.testing.assert_allclose(ref["gather_grad"], inp["xw"], **EXACT)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(np.asarray(res["gather"]["out"]),
                                   ref["gather_out"], **EXACT)
        np.testing.assert_allclose(np.asarray(res["gather"]["grad"]),
                                   worker._shard(inp["xw"], r, n), **EXACT)


@pytest.mark.parametrize("name", ["ce", "ce_ignored"])
def test_cross_entropy_matches_reference_and_fused(runs, name):
    n, ranks, ref = runs
    inp = worker.vocab_inputs()
    loss_ref, gh_ref, ge_ref = ref[name]
    h = torch.from_numpy(inp["h"]).requires_grad_()
    e = torch.from_numpy(inp["ce_emb"]).requires_grad_()
    lab = torch.from_numpy(inp["labels"]).long()
    if name == "ce_ignored":
        lab[torch.from_numpy(inp["mask"])] = -1
        assert (lab < 0).any()
    fused = fused_cross_entropy(h, e, lab, chunk=16)
    gh_f, ge_f = torch.autograd.grad(fused, [h, e])
    for r, res in enumerate(ranks):
        got = res[name]
        for want in (float(loss_ref), float(fused.detach())):
            np.testing.assert_allclose(got["loss"], want, rtol=LOSS_RTOL)
        for want in (gh_ref, gh_f.numpy()):
            np.testing.assert_allclose(np.asarray(got["h"]), want, rtol=0,
                                       atol=CE_GRAD_ATOL)
        for want in (_rows(ge_ref, r, n), _rows(ge_f.numpy(), r, n)):
            np.testing.assert_allclose(np.asarray(got["emb"]), want, rtol=0,
                                       atol=CE_GRAD_ATOL)


def test_sp_vocab_tp_end_to_end(runs):
    n, ranks, ref = runs
    loss, ge, gw = ref["e2e"]
    for r, res in enumerate(ranks):
        got = res["e2e"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(np.asarray(got["emb"]), _rows(ge, r, n),
                                   rtol=0, atol=CE_GRAD_ATOL)
        np.testing.assert_allclose(np.asarray(got["w"]), gw, rtol=0,
                                   atol=CE_GRAD_ATOL)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_vocab_shard_is_the_sharded_rows(n):
    """``convert.vocab_shard`` takes rank ``r``'s rows as ``shard_map``'s
    ``P("model")`` gives them to device ``r``."""
    from chainermn_tpu_torch.convert import vocab_shard

    emb = worker.vocab_inputs()["emb"]
    mesh = Mesh(np.array(jax.devices()[:n]), ("model",))
    local = jax.jit(shard_map(lambda e: e[None], mesh=mesh,
                              in_specs=P("model"), out_specs=P("model"),
                              check_vma=False))(jnp.asarray(emb))
    for r in range(n):
        np.testing.assert_array_equal(vocab_shard(emb, r, n),
                                      np.asarray(local[r]))
        np.testing.assert_array_equal(
            vocab_shard(torch.from_numpy(emb), r, n).numpy(),
            np.asarray(local[r]))
    with pytest.raises(ValueError, match="split"):
        vocab_shard(emb, 0, 3)
