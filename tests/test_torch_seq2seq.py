"""The port's seq2seq slice against the JAX package: the GRU encoder and
decoder converted from flax (flax's ``GRUCell`` parameter set, no
hidden-side ``r``/``z`` biases), three Adam steps against optax's, the
BLEU metrics, and the example (encoder on rank 0, decoder on the last
rank through ``MultiNodeChainList``) step by step at 1, 2 and 4 ranks
(gloo workers from ``_torch_dist_worker.py``) against the reference's on
meshes of as many devices, in both parameter tiers, and its ``run`` end
to end at the reference smoke's flags, both tiers with equal losses.

Tolerances: fp32 logits rtol 1e-5 / atol 1e-5 (another summation order
through the recurrence); Adam steps rtol 1e-5 on losses and 1e-5
absolute on parameters (updates of at most lr = 3e-3 whose normalised
size a last-bit gradient difference barely moves); the example's steps
the same.  The reference example's replicated step differentiates each
device's copy of the loss inside ``shard_map`` and sums over the
devices, so its gradients are exactly the world size n times the
chain's (checked: 2.0 and 4.0 at 2 and 4 devices); the port's loss
counts once.  Adam on n g with epsilon n eps takes the same steps as
Adam on g with eps, so the reference runs here with ``eps = n * 1e-8``
and the port with its 1e-8 (with the same epsilon the two differ where a
gradient is near epsilon: embedding rows of tokens a batch barely
holds).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist_worker as worker
from chainermn_tpu.communicators import build_mesh
from chainermn_tpu.communicators import create_communicator as jax_comm
from chainermn_tpu.links import MultiNodeChainList as JaxChain
from chainermn_tpu.models.seq2seq import Decoder as JaxDecoder
from chainermn_tpu.models.seq2seq import Encoder as JaxEncoder
from chainermn_tpu.models.seq2seq import Seq2seq as JaxSeq2seq
from chainermn_tpu.models.seq2seq import shift_right as jax_shift_right
from chainermn_tpu.utils import metrics as jax_metrics
from chainermn_tpu_torch.convert import (seq2seq_flax_to_state_dict,
                                         seq2seq_state_dict_to_flax)
from chainermn_tpu_torch.examples.train_transformer import \
    masked_cross_entropy
from chainermn_tpu_torch.models.seq2seq import (BOS, EOS, PAD, GRU, Seq2seq,
                                                shift_right)
from chainermn_tpu_torch.utils import metrics

STEP = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _src_tgt(seed=0, shape=(3, 6), vocab=30):
    rng = np.random.RandomState(seed)
    src = rng.randint(3, vocab, size=shape).astype(np.int32)
    tgt = rng.randint(3, vocab, size=shape).astype(np.int32)
    tgt[0, -2:] = PAD
    return src, tgt


@pytest.mark.parametrize("n_layers", [1, 2])
def test_seq2seq_matches_reference(n_layers):
    """``tests/test_models.py``'s shapes: the logits and a bit-exact
    conversion round trip."""
    model = JaxSeq2seq(vocab=30, d_model=16, n_layers=n_layers)
    src, tgt = _src_tgt()
    params = _np(model.init(jax.random.PRNGKey(0), src, tgt))
    want = np.asarray(model.apply(params, src, jax_shift_right(tgt)))
    port = Seq2seq(30, 16, n_layers, device="cpu")
    port.load_state_dict(seq2seq_flax_to_state_dict(params))
    with torch.no_grad():
        got = port(torch.from_numpy(src).long(),
                   shift_right(torch.from_numpy(tgt).long())).numpy()
    assert got.shape == (3, 6, 30) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **STEP)
    back = seq2seq_state_dict_to_flax(port.state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params["params"])
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params["params"])):
        np.testing.assert_array_equal(a, b)


def test_gru_keeps_flax_parameter_set():
    gru = GRU(8, 16, torch.Generator().manual_seed(0))
    assert {n: tuple(p.shape) for n, p in gru.named_parameters()} == {
        "weight_ih": (48, 8), "bias_ih": (48,), "weight_hh": (48, 16),
        "bias_hn": (16,)}
    assert gru(torch.zeros(2, 5, 8)).shape == (2, 5, 16)
    assert (BOS, EOS, PAD) == (1, 2, 0)


def test_three_adam_steps_match_optax():
    """Adam moves every flax parameter (and nothing else) as optax does."""
    model = JaxSeq2seq(vocab=30, d_model=16, n_layers=2)
    src, tgt = _src_tgt(1)
    params = _np(model.init(jax.random.PRNGKey(0), src, tgt))["params"]

    def jloss(p):
        logits = model.apply({"params": p}, src, jax_shift_right(tgt))
        mask = (tgt != 0).astype(jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, tgt)
        return (ce * mask).sum() / mask.sum()

    tx = optax.adam(3e-3)
    state = tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(jloss))
    want_losses = []
    for _ in range(3):
        loss, g = grad_fn(params)
        up, state = tx.update(g, state, params)
        params = optax.apply_updates(params, up)
        want_losses.append(float(loss))
    port = Seq2seq(30, 16, 2, device="cpu")
    port.load_state_dict(seq2seq_flax_to_state_dict(
        _np(model.init(jax.random.PRNGKey(0), src, tgt))))
    opt = torch.optim.Adam(port.parameters(), lr=3e-3)
    s, t = torch.from_numpy(src).long(), torch.from_numpy(tgt).long()
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = masked_cross_entropy(port(s, shift_right(t)), t)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    want = seq2seq_flax_to_state_dict(_np(params))
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_bleu_and_strip_special_equal_reference():
    rng = np.random.RandomState(0)
    refs = [list(rng.randint(3, 9, size=rng.randint(1, 9))) for _ in range(20)]
    hyps = [list(rng.randint(3, 9, size=rng.randint(1, 9))) for _ in range(20)]
    for smooth in (True, False):
        assert metrics.corpus_bleu(refs, hyps, smooth=smooth) == \
            jax_metrics.corpus_bleu(refs, hyps, smooth=smooth)
    assert metrics.corpus_bleu(refs, refs, smooth=False) == 1.0
    seq = [5, 0, 6, 2, 9]
    assert metrics.strip_special(seq) == jax_metrics.strip_special(seq) == [5, 6]
    with pytest.raises(ValueError):
        metrics.corpus_bleu([[1]], [])


# -- the example against the reference --------------------------------------

def reference_flax_params():
    """The reference example's initialisation (keys 0 and 1)."""
    enc, dec = JaxEncoder(64, 32), JaxDecoder(64, 32)
    z = jnp.zeros((2, 8), jnp.int32)
    enc_p = enc.init(jax.random.PRNGKey(0), z)
    dec_p = dec.init(jax.random.PRNGKey(1), enc.apply(enc_p, z), z)
    return enc, dec, enc_p, dec_p


@functools.lru_cache(maxsize=None)
def reference_pipeline(n):
    """The reference example's replicated step on an ``n``-device mesh
    (encoder on device 0, decoder on the last): losses and the final
    parameters as the port's state dicts."""
    enc, dec, enc_p, dec_p = reference_flax_params()
    comm = jax_comm("naive", mesh=build_mesh(inter_size=1, intra_size=n,
                                             devices=jax.devices()[:n]))
    chain = JaxChain(comm)
    chain.add_link(lambda p, batch: enc.apply(p, batch[0]), rank=0,
                   rank_in=None, rank_out=n - 1)
    chain.add_link(
        lambda p, inp: dec.apply(p, inp[0], jax_shift_right(inp[1][1])),
        rank=n - 1, rank_in=0, rank_out=None, needs_input=True)

    def loss_fn(params_list, batch):
        logits = chain.apply(params_list, batch)
        tgt = batch[1]
        mask = (tgt != 0).astype(jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, tgt)
        return (ce * mask).sum() / mask.sum()

    opt = optax.adam(3e-3, eps=1e-8 * n)   # its gradients are n times
    params = (enc_p, dec_p)
    state = opt.init(params)

    @jax.jit
    def step(params, state, batch):
        def mapped(params, batch):
            loss, grads = jax.value_and_grad(loss_fn)(params, batch)
            return loss, jax.tree.map(lambda g: jax.lax.psum(g, comm.axes),
                                      grads)

        loss, grads = comm.shard_map(mapped, in_specs=(P(), P()),
                                     out_specs=(P(), P()))(params, batch)
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    losses = []
    for batch in worker.s2s_batches():
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    return losses, [{k: v.numpy().ravel() for k, v in
                     seq2seq_flax_to_state_dict(_np(p)).items()}
                    for p in params]


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    _, _, enc_p, dec_p = reference_flax_params()
    tmp = tmp_path_factory.mktemp("s2s_weights")
    paths = []
    for name, p in (("enc", enc_p), ("dec", dec_p)):
        path = tmp / f"{name}.npz"
        np.savez(path, **{k: v.numpy() for k, v in
                          seq2seq_flax_to_state_dict(_np(p)).items()})
        paths.append(str(path))
    return paths


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda n: f"{n}ranks")
def example_runs(request, weight_files, tmp_path_factory):
    size = request.param
    if size == 1:
        sds = [{k: torch.from_numpy(v) for k, v in np.load(p).items()}
               for p in weight_files]
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            out = worker.s2s_pipeline(*sds)
            out["main"] = {"replicated": worker._s2s_main(),
                           "sharded": worker._s2s_main(["--sharded-params"])}
        finally:
            torch.set_num_threads(threads)
        return size, [out]
    return size, worker.spawn("seq2seq", size,
                              tmp_path_factory.mktemp(f"s2s{size}"),
                              weights=weight_files)


@pytest.mark.parametrize("tier", ["replicated", "sharded"])
def test_example_steps_match_reference(example_runs, tier):
    size, res = example_runs
    want_losses, want = reference_pipeline(size)
    for r, out in enumerate(res):
        got = out[tier]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5,
                                   err_msg=f"{tier} rank {r}")
        for part, (g, w) in enumerate(zip(got["params"], want)):
            for k, v in w.items():
                np.testing.assert_allclose(g[k], v, rtol=0, atol=1e-5,
                                           err_msg=f"{tier} {part} {k}")


def test_example_run_end_to_end_both_tiers(example_runs):
    """``run`` at the reference smoke's flags: 4 steps, equal losses in
    both tiers on every rank, accuracy and BLEU printed by rank 0."""
    size, res = example_runs
    for r, out in enumerate(res):
        rep, shd = out["main"]["replicated"], out["main"]["sharded"]
        assert len(rep["losses"]) == 4 and np.all(np.isfinite(rep["losses"]))
        np.testing.assert_allclose(shd["losses"], rep["losses"], rtol=1e-6)
        np.testing.assert_allclose(shd["accuracy"], rep["accuracy"],
                                   atol=1e-6)
        assert 0.0 <= rep["bleu"] <= 1.0
        assert rep == {**rep, "losses": res[0]["main"]["replicated"]
                       ["losses"]}
        if r == 0:
            assert f"encoder on rank 0, decoder on rank {size - 1}" in \
                rep["printed"]
            assert "token accuracy (teacher-forced)" in rep["printed"]
            assert "BLEU (greedy)" in shd["printed"]


def test_example_main_returns_the_accuracy(capsys):
    """``main(argv)`` at the reference smoke's flags returns ``run``'s
    teacher-forced accuracy (the reference's return value)."""
    from chainermn_tpu_torch.examples import seq2seq as ex

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        acc = ex.main(worker.S2S_FLAGS)
        want = ex.run(ex.parser().parse_args(worker.S2S_FLAGS))
    finally:
        torch.set_num_threads(threads)
    assert isinstance(acc, float) and acc == want["accuracy"]
    assert capsys.readouterr().out.count("BLEU (greedy)") == 2
