"""The reference side of the sequence-parallel parity tests
(``test_torch_sequence_parallel.py``, ``test_torch_zigzag.py``): each
case of ``_torch_sp_worker.SP_CASES`` inside ``shard_map`` over as many
CPU devices as the port has ranks, the port's ranks (one in this
process, 2 and 4 spawned) and the comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import _torch_sp_worker as worker
from chainermn_tpu.communicators import build_mesh
from chainermn_tpu.communicators.base import shard_map_compat as shard_map
from chainermn_tpu.parallel import ring_attention as jra
from chainermn_tpu.parallel import ulysses as jul

# fp32: the blocks merge in other orders, and the gradients are sums over
# blocks.
OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def reference_case(n: int, name: str) -> dict:
    """Case ``name`` on ``n`` devices: the full output and the gradients
    of ``sum(out * w)``, in the shard layout's sequence order."""
    c = worker.SP_CASES[name]
    inp = worker.sp_inputs(name, n)
    mesh = build_mesh(inter_size=1, intra_size=n, devices=jax.devices()[:n])
    seq = P(None, "intra")
    segmented = c["seg"] is not None

    def attn(q, k, v, seg):
        seg = seg if segmented else None
        if c["kind"] == "ring":
            return jra.ring_attention(q, k, v, "intra", causal=c["causal"],
                                      q_segment_ids=seg, window=c["window"])
        if c["kind"] == "zigzag":
            return jra.zigzag_ring_attention(q, k, v, "intra",
                                             use_flash=c["flash"],
                                             segment_ids=seg)
        return jul.ulysses_attention(q, k, v, "intra", causal=c["causal"],
                                     q_segment_ids=seg, window=c["window"])

    f = shard_map(attn, mesh=mesh,
                  in_specs=(seq, seq, seq,
                            P() if c["seg"] == "full" else seq),
                  out_specs=seq, check_vma=False)
    q, k, v, w, seg = (jnp.asarray(inp[x]) for x in ("q", "k", "v", "w",
                                                      "seg"))

    def loss(q, k, v):
        out = f(q, k, v, seg)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return {"out": np.asarray(out),
            **{x: np.asarray(g) for x, g in zip("qkv", grads)}}


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda n: f"{n}rank")
def world(request, tmp_path_factory):
    n = request.param
    if n == 1:
        from chainermn_tpu_torch import create_communicator

        comm = create_communicator("naive", device="cpu")
        ranks = [worker.sp_all(comm)]
    else:
        ranks = worker.spawn("sp", n, tmp_path_factory.mktemp(f"sp{n}"))
    return n, ranks


def check_case(world, name):
    """Each rank's output shard and q, k, v gradient shards of case
    ``name`` against the reference's."""
    n, ranks = world
    ref = reference_case(n, name)
    for r, res in enumerate(ranks):
        got = res[name]
        np.testing.assert_allclose(np.asarray(got["out"]),
                                   worker._shard(ref["out"], r, n),
                                   err_msg=f"{name} rank {r} out", **OUT_TOL)
        for x in "qkv":
            np.testing.assert_allclose(np.asarray(got[x]),
                                       worker._shard(ref[x], r, n),
                                       err_msg=f"{name} rank {r} d{x}",
                                       **GRAD_TOL)
