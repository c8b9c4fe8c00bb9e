"""The port's sequence-parallel attention against the JAX package's.

Each ring and Ulysses case of ``_torch_sp_worker.SP_CASES`` (the zigzag
ones are ``test_torch_zigzag.py``'s) runs on the port at 1 rank
(in this process), 2 and 4 gloo ranks (workers from
``_torch_sp_worker.py``, one process a shard), and on the reference
inside ``shard_map`` over as many CPU devices, on the same seeded numpy
inputs: ``ring_attention`` causal and not, with packed segment ids
crossing shard boundaries (causal, and non-causal with GQA ``Hk`` 2),
GQA ``Hk`` 1, a sliding window (alone and with GQA and segments);
``ulysses_attention`` causal and not, with local segment ids, full ids
with GQA, and a window.  Each rank's output shard
and its gradients of ``sum(out * w)`` for its q, k, v shards are held to
the reference's: fp32, output within 2e-5 and gradients within 1e-4
(rtol and atol; the blocks are merged in other orders and the gradients
summed over blocks).

Also: Ulysses' head-count refusals at 1, 2 and 4 ranks (the reference's
messages), the zigzag permutation and its inverse (equal to the
reference's), the reference's block helpers (``_block_attn``,
``_online_merge``, ``_flash_block_stats``) on the same inputs, and
``TransformerLM``'s ``position_offset`` forms and ``inputs_embeds``
against the reference's.  The sequence-parallel LM end to end is
``test_torch_long_context.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_sp_worker as worker
from _sp_reference import GRAD_TOL, OUT_TOL, check_case, world  # noqa: F401
from chainermn_tpu.communicators import build_mesh
from chainermn_tpu.communicators.base import shard_map_compat as shard_map
from chainermn_tpu.parallel import ring_attention as jra
from chainermn_tpu.parallel import ulysses as jul
from chainermn_tpu_torch.parallel import ring_attention as tra

#: The ``SP_CASES`` kinds this file's worlds run.
SP_KINDS = ("ring", "ulysses")


@pytest.mark.parametrize("name", sorted(
    name for name, c in worker.SP_CASES.items() if c["kind"] != "zigzag"))
def test_matches_reference(world, name):
    check_case(world, name)


def test_ulysses_refusals(world):
    """The head count must divide by the ranks, and under GQA the kv head
    count too: the port raises the reference's messages (at one rank
    every count divides, and neither raises)."""
    n, ranks = world
    mesh = build_mesh(inter_size=1, intra_size=n, devices=jax.devices()[:n])
    for name, (H, Hk) in worker.ulysses_refusal_cases(n).items():
        q = jnp.zeros((worker.B, 4 * n, H, worker.D))
        kv = jnp.zeros((worker.B, 4 * n, Hk, worker.D))
        f = shard_map(lambda q, k, v: jul.ulysses_attention(q, k, v, "intra"),
                      mesh=mesh, in_specs=(P(None, "intra"),) * 3,
                      out_specs=P(None, "intra"), check_vma=False)
        try:
            jax.jit(f)(q, kv, kv)
            want = None
        except ValueError as e:
            want = str(e)
        assert (want is None) == (n == 1), name
        for res in ranks:
            assert res["errors"][name] == want, name


def test_gather_sequence_kv_matches_reference(world):
    """The gathered K/V equal the reference's ``gather_sequence_kv`` (the
    plain concatenation in ring order), and the backward reduce-scatters:
    every rank's loss reads the whole gathered pair, so each shard's
    gradient is n times its slice of the weights (the transpose of
    ``lax.all_gather``)."""
    n, ranks = world
    inp = worker.sp_inputs("ring_seg_gqa2_noncausal", n)
    mesh = build_mesh(inter_size=1, intra_size=n, devices=jax.devices()[:n])
    seq = P(None, "intra")
    kf, vf = jax.jit(shard_map(
        lambda k, v: jra.gather_sequence_kv(k, v, "intra"), mesh=mesh,
        in_specs=(seq, seq), out_specs=(P(), P()), check_vma=False))(
            jnp.asarray(inp["k"]), jnp.asarray(inp["v"]))
    np.testing.assert_array_equal(np.asarray(kf), inp["k"])
    np.testing.assert_array_equal(np.asarray(vf), inp["v"])
    for r, res in enumerate(ranks):
        got = res["gather_kv"]
        np.testing.assert_array_equal(np.asarray(got["k"]), np.asarray(kf))
        np.testing.assert_array_equal(np.asarray(got["v"]), np.asarray(vf))
        for g, w in (("gk", inp["q"]), ("gv", inp["w"])):
            np.testing.assert_allclose(
                np.asarray(got[g]), n * worker._shard(w[:, :, :2], r, n),
                rtol=1e-6)


@pytest.mark.parametrize("S,n", [(16, 1), (16, 2), (16, 4), (48, 3),
                                 (64, 8)])
def test_zigzag_indices_match_reference(S, n):
    idx = tra.zigzag_indices(S, n)
    np.testing.assert_array_equal(idx, np.asarray(jra.zigzag_indices(S, n)))
    inv = tra.inverse_zigzag_indices(S, n)
    np.testing.assert_array_equal(inv,
                                  np.asarray(jra.inverse_zigzag_indices(S, n)))
    np.testing.assert_array_equal(idx[inv], np.arange(S))
    x = np.random.RandomState(0).randn(2, S)
    np.testing.assert_array_equal(x[:, idx][:, inv], x)
    # Shard r holds chunks r and 2n-1-r.
    c = S // (2 * n)
    for r in range(n):
        shard = idx[r * 2 * c:(r + 1) * 2 * c]
        assert list(shard) == list(range(r * c, (r + 1) * c)) + list(
            range((2 * n - 1 - r) * c, (2 * n - r) * c))
    with pytest.raises(ValueError, match="divide"):
        tra.zigzag_indices(S + 1, n)


def _qkv(seed, S=16, H=4, Hk=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, S, h, 8).astype(np.float32) for h in (H, Hk, Hk)]


@pytest.mark.parametrize("Hk,masked", [(4, False), (4, True), (2, True),
                                       (1, False)])
def test_block_attn_and_merge_match_reference(Hk, masked):
    """``_block_attn`` (dense fp32 block stats, GQA grouped) and
    ``_online_merge`` (with a closed gate and a fully masked block) in the
    reference's layout."""
    q, k, v = _qkv(1, Hk=Hk)
    mask = None
    if masked:
        m = np.tril(np.ones((16, 16), bool))[None, None]
        m = np.broadcast_to(m, (2, 1, 16, 16)).copy()
        m[1, :, 3] = False              # a fully masked row
        mask = m
    tq = [torch.from_numpy(a) for a in (q, k, v)]
    jq = [jnp.asarray(a) for a in (q, k, v)]
    tb = tra._block_attn(*tq, None if mask is None else torch.from_numpy(mask),
                         0.3)
    jb = jra._block_attn(*jq, None if mask is None else jnp.asarray(mask), 0.3)
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OUT_TOL)
    q2, k2, v2 = _qkv(2, Hk=Hk)
    tb2 = tra._block_attn(torch.from_numpy(q2), torch.from_numpy(k2),
                          torch.from_numpy(v2), None, 0.3)
    jb2 = jra._block_attn(jnp.asarray(q2), jnp.asarray(k2), jnp.asarray(v2),
                          None, 0.3)
    for gate in (None, True, False):
        t = tra._online_merge(tb, tb2, gate)
        j = jra._online_merge(jb, jb2, None if gate is None
                              else jnp.asarray(gate))
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **OUT_TOL)


@pytest.mark.parametrize("causal,segmented", [(True, False), (False, False),
                                              (False, True)])
def test_flash_block_stats_match_reference(causal, segmented):
    """The kernels' ``(o, lse)`` as ``(lse, 1, o)`` stats, and their
    gradients through a merge, against the reference's Pallas kernels in
    interpret mode."""
    q, k, v = _qkv(3, Hk=2)
    seg = np.zeros((2, 16), np.int32)
    seg[:, 9:] = 1
    w = np.random.RandomState(4).randn(2, 16, 4, 8).astype(np.float32)
    kw = dict(qseg=seg, kseg=seg) if segmented else {}

    def jloss(q, k, v):
        m, l, o = jra._flash_block_stats(
            q, k, v, causal, 0.3, 16, True,
            **{a: jnp.asarray(b) for a, b in kw.items()})
        return jnp.sum(o * w) + jnp.sum(m * w[..., 0].transpose(0, 2, 1)), \
            (m, l, o)

    (jl, jstats), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                          has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    m, l, o = tra._flash_block_stats(
        *tq, causal, 0.3, 16, **{a: torch.from_numpy(b) for a, b in kw.items()})
    tw = torch.from_numpy(w)
    loss = (o * tw).sum() + (m * tw[..., 0].permute(0, 2, 1)).sum()
    tg = torch.autograd.grad(loss, tq)
    for a, b in zip((m, l, o), jstats):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   **OUT_TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_zigzag_use_flash_refuses_bad_plan():
    from chainermn_tpu_torch import create_communicator

    comm = create_communicator("naive", device="cpu")
    q = torch.zeros(1, 2 * 600, 2, 8)     # C = 600: no block divides it
    with pytest.raises(ValueError, match="block plan"):
        tra.zigzag_ring_attention(q, q, q, comm, use_flash=True)
    with pytest.raises(ValueError, match="even"):
        tra.zigzag_ring_attention(q[:, :5], q[:, :5], q[:, :5], comm)


# -- TransformerLM's position_offset and inputs_embeds ---------------------------

LM = dict(vocab=32, d_model=16, n_heads=2, d_ff=32, n_layers=2, max_len=24)


@pytest.fixture(scope="module")
def lms():
    from chainermn_tpu.models.transformer import TransformerLM as JaxLM
    from chainermn_tpu_torch.convert import flax_to_state_dict
    from chainermn_tpu_torch.models.transformer import TransformerLM

    toks = np.random.RandomState(5).randint(0, 32, size=(2, 12)).astype(
        np.int32)
    jm = JaxLM(**LM, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(toks))
    tm = TransformerLM(**LM, dtype=torch.float32, device="cpu")
    tm.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm, toks


@pytest.mark.parametrize("form", ["none", "scalar", "scalar_clamped",
                                  "explicit", "per_sequence"])
def test_position_offset_forms_match_reference(lms, form):
    """``None``; a scalar offset (and one past the table's end, which the
    reference's dynamic slice clamps); explicit ``(S,)`` positions (the
    zigzag layout); ``(B, S)`` positions per sequence."""
    jm, params, tm, toks = lms
    rng = np.random.RandomState(6)
    off = {"none": None, "scalar": 7, "scalar_clamped": 20,
           "explicit": rng.permutation(24)[:12].astype(np.int32),
           "per_sequence": rng.randint(0, 24, size=(2, 12)).astype(
               np.int32)}[form]
    want = jm.apply(params, jnp.asarray(toks), position_offset=None
                    if off is None else jnp.asarray(off))
    got = tm(torch.from_numpy(toks).long(), position_offset=None
             if off is None else (off if np.ndim(off) == 0
                                  else torch.from_numpy(off)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_inputs_embeds_matches_reference(lms):
    jm, params, tm, toks = lms
    emb = np.random.RandomState(7).randn(2, 12, 16).astype(np.float32)
    want = jm.apply(params, jnp.asarray(toks), position_offset=3,
                    return_hidden=True, inputs_embeds=jnp.asarray(emb))
    x = torch.from_numpy(emb).requires_grad_()
    got = tm(torch.from_numpy(toks).long(), position_offset=3,
             return_hidden=True, inputs_embeds=x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    # The gradient reaches the external embeddings.
    (g,) = torch.autograd.grad(got.sum(), [x])
    assert float(g.abs().sum()) > 0
    with pytest.raises(ValueError, match="return_hidden"):
        jm.apply(params, jnp.asarray(toks), inputs_embeds=jnp.asarray(emb))
    with pytest.raises(ValueError, match="return_hidden"):
        tm(torch.from_numpy(toks).long(), inputs_embeds=x)
