"""The data-parallel surface over NCCL across GPUs, one process a GPU.

What the gloo tests hold on the CPU, here on the card's own backend: the
gradient hooks launching NCCL collectives from the autograd thread, the
int8 and fp8 wires summed by NCCL, ZeRO's reduce-scatter and all-gather,
the object plane on its gloo side group inside an NCCL job, ``split``,
the MNIST example at its defaults (checkpoint resume included), and
``make_train_step_with_state`` on a small ResNet (BatchNorm buffers
averaged over the ranks).

The model-parallel API over NCCL (one spawn of ``_torch_dist_worker``'s
``mp_nccl`` across the cards, one on a single card, and the same
function and chain cases on gloo for comparison): ``send``/``recv``
between the first and the last rank with its gradient, the collectives'
values and gradients, the two-stage, three-stage and branching chains
against the composition, the seq2seq example with its encoder on rank 0
and its decoder on the last rank at full width in both tiers, the WMT
example across the cards against one card, and a split of a split
communicator.

The pipeline tier over NCCL (one spawn of ``_torch_pp_worker``'s
``pp_nccl`` across four cards, one ``pp_one_card`` on one card, and the
schedule and parallel-convolution cases on four gloo ranks to compare):
the seven schedules of ``parallel/pipeline.py`` at pp=4 against gloo's
results; the ViT example at full width (fp32, global batch 128, 3
steps) at pp=4 (``1f1b``, 3 layers a stage), dp=2 x pp=2 (``gpipe``, 6)
and pp=4 interleaved (``1f1b --virtual-stages 3``, 1 layer a chunk)
against all 12 layers on one card, with each layout's step time; and the
parallel-convolution example across the cards against gloo, its step-0
losses against one unsharded net on one card.

The sequence-parallel tier over NCCL (one spawn of ``_torch_sp_worker``'s
``lc_nccl`` across four cards, one ``lc_one_card`` on one card): the
long-context example at phase 4's widths with S 32768 (8192 tokens a
card), bf16, 3 steps, ``--dp 1`` with ``--sp ring``, ``zigzag``,
``ulysses`` and ``zigzag --vocab-tp`` against ``--sp none`` on one card
(the same seeded weights and batches), each layout's step time per rank;
and ``moe_layer`` at four ranks with two experts a rank against the
one-device oracle.

Imports only torch, numpy and the port: on a host with two or more GPUs,
``python -m pytest --noconftest tests/test_torch_nccl_cuda.py -q``
(up to 4 ranks).  With fewer GPUs every test skips.
"""

import json
import multiprocessing as mp

import numpy as np
import pytest
import torch

import _torch_dist_worker as mp_worker
import _torch_dp_worker as worker
import _torch_pp_worker as pp_worker
import _torch_sp_worker as sp_worker

JOIN_TIMEOUT_S = 600
ZERO_TOL = dict(rtol=1e-5, atol=1e-6)    # allreduce and reduce-scatter may
                                         # sum in different orders


def _world() -> int:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two or more CUDA devices (NCCL across GPUs)")
    return min(n, 4)


@pytest.fixture(scope="module")
def nccl(tmp_path_factory):
    size = _world()
    tmp = tmp_path_factory.mktemp("nccl")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker.run,
                         args=("nccl", r, size, str(tmp / "rendezvous"),
                               str(tmp), {"path": str(tmp / "ck")}))
             for r in range(size)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
            assert p.exitcode == 0, f"rank exited {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(size)]


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("name", worker.NCCL_QUANT_NAMES)
def test_quantized_mean_over_nccl(nccl, name, wire):
    for out in nccl:
        assert out["backend"] == "nccl"
        got = out["quant"][f"{name}/{wire}"]
        assert 0.0 < got["err"] <= got["bound"] * (1 + 1e-6), got
        assert got["wire"] == ("int8" if wire == "int8" else
                               "float8_e4m3fn"), got
        assert got["dtypes"] == ["torch.float32"] * 5 + ["torch.float64"]


@pytest.mark.cuda
def test_full_precision_mean_over_nccl(nccl):
    for out in nccl:
        for key, err in out["full"].items():
            assert err < 1e-6, key


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(worker.OVERLAP_CASES))
def test_overlap_byte_equal_over_nccl(nccl, case):
    for out in nccl:
        got = out["overlap"][case]
        assert got["equal"] and got["losses_equal"], got
        assert got["hooked"] == [True, False]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", worker.NCCL_ZERO_VARIANTS)
@pytest.mark.parametrize("opt_name", worker.ZERO_OPTS)
@pytest.mark.parametrize("stage", worker.ZERO_STAGES)
def test_zero_matches_stage0_over_nccl(nccl, stage, opt_name, variant):
    size = len(nccl)
    for out in nccl:
        got = out["zero"][f"{stage}/{opt_name}/{variant}"]
        ref = out["zero"][f"0/{opt_name}/{variant}"]
        np.testing.assert_allclose(got["w"], ref["w"], **ZERO_TOL)
        np.testing.assert_allclose(got["b"], ref["b"], **ZERO_TOL)
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        assert got["shard"] == -(-5 // size)
        assert got["w"] == nccl[0]["zero"][
            f"{stage}/{opt_name}/{variant}"]["w"]


@pytest.mark.cuda
def test_object_plane_and_split_in_an_nccl_job(nccl):
    size = len(nccl)
    for r, out in enumerate(nccl):
        o = out["objects"]
        assert o["bcast_obj"] == size - 1
        assert o["gather_root"] == ([10 * i for i in range(size)]
                                    if r == 1 else None)
        assert o["allreduce_obj"] == size * (size + 1) // 2
        assert o["scatter_obj"] == 100 + r
        members = sorted([m for m in range(size) if m % 2 == r % 2],
                         reverse=True)
        assert o["sub"] == [members.index(r), len(members), members]
        assert o["sub_grad_err"] < 1e-6


@pytest.mark.cuda
def test_mnist_example_over_nccl(nccl):
    """At its defaults: every rank ends with the same parameters; overlap
    off is bitwise equal to on (the hooks launch the same collectives);
    ZeRO-3 follows stage 0; both wires converge; the resumed run ends
    with the uninterrupted run's digest."""
    runs0 = nccl[0]["mnist"]
    for out in nccl:
        runs = out["mnist"]
        for name, run in runs.items():
            assert run["digest"] == runs0[name]["digest"], name
            if name != "stopped":
                assert run["accuracy"] >= 0.99, name
        zero0 = runs["zero0"]
        assert runs["overlap_off"]["digest"] == zero0["digest"]
        assert runs["overlap_off"]["losses"] == zero0["losses"]
        np.testing.assert_allclose(runs["zero3"]["losses"], zero0["losses"],
                                   rtol=1e-4, atol=1e-7)
        assert runs["int8"]["wire"] == "int8"
        assert runs["fp8"]["wire"] == "float8_e4m3fn"
        assert runs["stopped"]["gstep"] == 96     # 32 steps an epoch
        assert runs["resumed"]["resumed_from"] == 90
        assert runs["resumed"]["digest"] == zero0["digest"]
        assert runs["resumed"]["gstep"] == zero0["gstep"]


@pytest.mark.cuda
def test_with_state_step_over_nccl(nccl):
    """After the steps every rank holds the same parameters and BatchNorm
    buffers; after one step the buffers are the mean of the ranks' local
    updates; ZeRO-3 and double buffering keep stage 0's contract, ZeRO-3
    within 1e-5 of stage 0."""
    for out in nccl:
        runs = out["state"]
        for name, run in runs.items():
            assert run["state"] == nccl[0]["state"][name]["state"], name
            assert np.all(np.isfinite(run["losses"])), name
        assert out["state_local_mean_err"] < 1e-6
        stage0 = runs["stage0"]
        np.testing.assert_allclose(runs["zero3"]["losses"], stage0["losses"],
                                   rtol=1e-5)
        # Within 1e-5 of stage 0, every value: NCCL's allreduce (stage 0)
        # and reduce-scatter (ZeRO) sum the ranks' gradients in different
        # orders and cuDNN's weight gradients may accumulate in another
        # order, and four SGD steps through BatchNorm carry those last-bit
        # differences into the parameters (on four H100s the stem's kernel
        # was 2.6e-6 off, past rtol 1e-5 with atol 1e-6).
        worst = {k: float(np.abs(np.asarray(runs["zero3"]["state"][k])
                                 - np.asarray(v)).max())
                 for k, v in stage0["state"].items()}
        key = max(worst, key=worst.get)
        assert worst[key] <= 1e-5, (key, worst[key])
        assert runs["double_buffering"]["updates"] == \
            runs["stage0"]["updates"] - 1


# -- the model-parallel API over NCCL ----------------------------------------

# The seq2seq example across the cards against one card: the same
# operations on the same values (the transfers are copies and the
# replicated tier's sum adds zeros), so within 1e-5 relative; its two
# tiers within 1e-5 relative (the same arithmetic on views of a flat row).
S2S_RTOL = 1e-5
# The WMT example (bf16 model, bf16 gradient wire) across the cards against
# one card: each rank's quarter of the batch, the mean taken on the bf16
# wire in another order, over 8 steps: within 0.02 of each loss.
WMT_ATOL = 0.02


@pytest.fixture(scope="module")
def cards(tmp_path_factory):
    size = _world()
    return mp_worker.spawn("mp_nccl", size, tmp_path_factory.mktemp("cards"),
                           timeout_s=JOIN_TIMEOUT_S)


@pytest.fixture(scope="module")
def one_card(tmp_path_factory):
    _world()
    return mp_worker.spawn("mp_nccl", 1, tmp_path_factory.mktemp("one_card"),
                           timeout_s=JOIN_TIMEOUT_S)[0]


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """The same function and chain cases on gloo (CPU), which the CPU
    tests hold to the JAX reference."""
    size = _world()
    return {kind: mp_worker.spawn(kind, size, tmp_path_factory.mktemp(kind),
                                  timeout_s=JOIN_TIMEOUT_S)
            for kind in ("functions", "chains")}


@pytest.mark.cuda
def test_send_recv_and_gradient_over_nccl(cards, gloo):
    """Between rank 0 and the last rank: the payload, the gradient back to
    the sender, ``pseudo_connect``, merged delegates, a tuple payload, a
    send to self and ``ring_exchange``, as on gloo."""
    last = len(cards) - 1
    assert cards[0]["backend"] == "nccl"
    f0 = cards[0]["functions"]
    assert f0["sender_grad"] == 18.0 and f0["grafted_grad"] == 40.0
    assert f0["merged_is_delegate"]
    assert f0["merged_grads"] == [[10.0, 10.0], [42.0]]
    assert cards[last]["functions"]["received"] == 3.0
    assert cards[1]["functions"]["tuple_payload"] == [
        [2.0, 4.0], [7, 8], "torch.int64", False, [9.0]]
    for out, ref in zip(cards, gloo["functions"]):
        f = out["functions"]
        assert f["self_grad"] == 64.0
        assert f["send_recv"] == ref["send_recv"]
        assert f["ring"] == ref["ring"]


@pytest.mark.cuda
def test_collectives_over_nccl(cards, gloo):
    for r, (out, ref) in enumerate(zip(cards, gloo["functions"])):
        for name, got in out["functions"]["coll"].items():
            want = ref["coll"][name]
            np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} {r}")
            np.testing.assert_allclose(got["grad"], want["grad"], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} {r}")


def _composition(name, size):
    """The chain composed on one process (CPU, float64): output and each
    component's gradients of sum(y ** 2)."""
    comps, shapes = mp_worker.chain_specs(size)[name]
    params = [None if s is None else {
        k: torch.from_numpy(v).double().requires_grad_(True)
        for k, v in mp_worker.chain_params(i, *s).items()}
        for i, s in enumerate(shapes)]
    x = torch.from_numpy(mp_worker.chain_input(9, 5, 4)).double()
    outs = {}
    for i, (fn, owner, rank_in, _) in enumerate(comps):
        inp = (x if rank_in is None else
               outs[rank_in] if isinstance(rank_in, int) else
               tuple(outs[r] for r in rank_in))
        outs[owner] = fn(params[i], inp)
    y = outs[comps[-1][1]]
    (y ** 2).sum().backward()
    return y.detach().numpy(), [{} if p is None else
                                {k: v.grad.numpy() for k, v in p.items()}
                                for p in params]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["two_stage", "three_stage", "branching"])
def test_chains_over_nccl_match_composition(cards, gloo, name):
    """Forward and gradients against the composition (rtol 1e-4, atol 1e-5,
    the reference's tolerance): each component's gradient on its owner
    only; the sharded tier and errors as on gloo."""
    size = len(cards)
    if name != "two_stage" and size < 3:
        pytest.skip("needs three or more CUDA devices")
    y, grads = _composition(name, size)
    comps = mp_worker.chain_specs(size)[name][0]
    for r, out in enumerate(cards):
        got = out["chains"][name]
        np.testing.assert_allclose(got["y"], y, rtol=1e-4, atol=1e-5)
        for i, comp in enumerate(comps):
            for k, g in got["grads"][i].items():
                if comp[1] == r:
                    np.testing.assert_allclose(g, grads[i][k], rtol=1e-4,
                                               atol=1e-5)
                else:
                    assert g is None
    for out, ref in zip(cards, gloo["chains"]):
        c = out["chains"]
        assert c["sharded"]["equal"] and c["sharded"]["roundtrip"]
        assert c["sharded"]["row_numel"] == ref["sharded"]["row_numel"]
        np.testing.assert_allclose(c["train"]["sharded_losses"],
                                   c["train"]["replicated_losses"], rtol=1e-6)
        np.testing.assert_allclose(c["train"]["sharded_losses"],
                                   ref["train"]["sharded_losses"], rtol=1e-5)
        assert set(c["errors"]) == set(ref["errors"])


@pytest.mark.cuda
def test_seq2seq_example_over_nccl(cards, one_card):
    """Encoder on rank 0, decoder on the last rank, at full width (unit
    1024, 2 layers, vocab 32768, 50 tokens, batch 64), both tiers: the
    same losses on every rank, in both tiers and on one card."""
    one = one_card["seq2seq"]["replicated"]["losses"]
    assert len(one) == 10 and np.all(np.isfinite(one))
    for out in cards:
        s = out["seq2seq"]
        for tier in ("replicated", "sharded"):
            assert s[tier]["losses"] == cards[0]["seq2seq"][tier]["losses"]
            np.testing.assert_allclose(s[tier]["losses"], one,
                                       rtol=S2S_RTOL, err_msg=tier)
            assert 0.0 <= s[tier]["bleu"] <= 1.0
        np.testing.assert_allclose(s["sharded"]["losses"],
                                   s["replicated"]["losses"], rtol=S2S_RTOL)
    np.testing.assert_allclose(one_card["seq2seq"]["sharded"]["losses"], one,
                               rtol=S2S_RTOL)


@pytest.mark.cuda
def test_wmt_example_over_nccl(cards, one_card):
    """The example's pipeline across the cards against one card on the same
    global batches, and its ``main`` across the cards."""
    one = one_card["wmt"]
    assert len(one) == mp_worker.WMT_CARD_STEPS and np.all(np.isfinite(one))
    for out in cards:
        assert out["wmt"] == cards[0]["wmt"]
        np.testing.assert_allclose(out["wmt"], one, rtol=0, atol=WMT_ATOL)
        assert np.isfinite(out["wmt_main"])
    assert f"tok/s over {len(cards)} devices" in cards[0]["wmt_main_printed"]


@pytest.mark.cuda
def test_split_of_a_split_over_nccl(cards):
    """The world split by parity (keys reversed), each half split again
    over the same members with the order reversed back, and into single
    ranks: NCCL groups among the members only."""
    size = len(cards)
    for r, out in enumerate(cards):
        sp = out["split"]
        half = sorted([m for m in range(size) if m % 2 == r % 2],
                      reverse=True)
        assert sp["sub"] == [half.index(r), len(half), half]
        assert sp["subsub"] == [half[::-1].index(r), len(half), half[::-1]]
        assert sp["solo"] == [0, 1]
        assert sp["backend"] == "nccl"
        assert sp["grad_err"] < 1e-6


# -- the pipeline tier over NCCL ---------------------------------------------

# The schedules over NCCL against gloo's on the CPU: the same operations,
# on the card's kernels (fp32, TF32 off by default): rtol 1e-5, atol 1e-6
# for elements that cancel to near zero.
PP_TOL = dict(rtol=1e-5, atol=1e-6)
# The ViT example across the cards against one card: the same fp32
# arithmetic split into stages (the GPipe layout's gradients are the
# pipeline size times the others', which AdamW cancels up to its
# epsilon), microbatch and data-row sums in other orders and cuBLAS's
# kernels chosen per shape; AdamW (lr 1e-3, no warm-up) at this width
# moves the loss by several units a step, so 1e-3 of each loss.  Each
# parameter tensor's norm within 1e-3 of one card's, plus 5% of the norm
# of one AdamW step over the tensor (lr sqrt(numel)): AdamW's first
# steps move every element by about lr whatever its gradient's size, so
# an element whose gradient is at rounding level may step the other way
# when the data rows split the batch (observed: head.bias, started at
# zero, 1.8e-3 of its norm apart at dp=2 x pp=2).
VIT_WIDE_RTOL = 1e-3
VIT_LR = 1e-3
# The parallel-convolution example on the cards against gloo: cuDNN's and
# the CPU's convolutions differ in their last bits, and Adam normalises
# each element's step (lr 1e-3): losses 1e-4 relative, parameters 1e-4
# relative or 5e-5 absolute.
PCONV_RTOL, PCONV_ATOL = 1e-4, 5e-5


def _four():
    if _world() < 4:
        pytest.skip("needs four CUDA devices")
    return 4


@pytest.fixture(scope="module")
def pp_cards(tmp_path_factory):
    return pp_worker.spawn("pp_nccl", _four(),
                           tmp_path_factory.mktemp("pp_cards"),
                           timeout_s=JOIN_TIMEOUT_S)


@pytest.fixture(scope="module")
def pp_one_card(pp_cards, tmp_path_factory):
    inits = [out["pconv"]["init"] for out in pp_cards]
    return pp_worker.spawn("pp_one_card", 1,
                           tmp_path_factory.mktemp("pp_one_card"),
                           timeout_s=JOIN_TIMEOUT_S, pconv_inits=inits)[0]


@pytest.fixture(scope="module")
def pp_gloo(tmp_path_factory):
    return pp_worker.spawn("pipeline_pconv", _four(),
                           tmp_path_factory.mktemp("pp_gloo"),
                           timeout_s=JOIN_TIMEOUT_S)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(pp_worker.PP_CASES))
def test_schedules_over_nccl_match_gloo(pp_cards, pp_gloo, name):
    for r, (out, ref) in enumerate(zip(pp_cards, pp_gloo)):
        assert out["backend"] == "nccl"
        got, want = out["pipeline"][name], ref["pipeline"][name]
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(np.asarray(got[key]),
                                       np.asarray(want[key]),
                                       err_msg=f"{name} {key} rank {r}",
                                       **PP_TOL)
        assert out["pipeline"]["errors"] == ref["pipeline"]["errors"]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(pp_worker.VIT_WIDE_CARDS))
def test_vit_example_across_cards_matches_one_card(pp_cards, pp_one_card,
                                                   layout):
    one = pp_one_card["vit"]
    assert len(one["losses"]) == 3 and np.all(np.isfinite(one["losses"]))
    norms = {}
    for out in pp_cards:
        run = out["vit"][layout]
        assert run["losses"] == pp_cards[0]["vit"][layout]["losses"]
        np.testing.assert_allclose(run["losses"], one["losses"],
                                   rtol=VIT_WIDE_RTOL, err_msg=layout)
        norms.update(run["norms"])
    assert set(norms) == set(one["norms"])
    worst = 0.0
    for k, (v, numel) in one["norms"].items():
        got, got_numel = norms[k]
        assert got_numel == numel, k
        bound = VIT_WIDE_RTOL * v + 0.05 * VIT_LR * numel ** 0.5
        worst = max(worst, abs(got - v) / bound)
        assert abs(got - v) <= bound, (layout, k, got, v, bound)
    print(f"vit example {layout}: worst norm difference {worst:.3f} of its "
          f"bound; step "
          f"{[round(o['vit'][layout]['step_ms'], 1) for o in pp_cards]} ms, "
          f"peak {[round(o['vit'][layout]['peak_gib'], 2) for o in pp_cards]}"
          f" GiB; one card {one['step_ms']:.1f} ms, {one['peak_gib']:.2f} "
          f"GiB; losses {run['losses']} vs {one['losses']}")


@pytest.mark.cuda
def test_parallel_conv_across_cards(pp_cards, pp_gloo, pp_one_card):
    for r, (out, ref) in enumerate(zip(pp_cards, pp_gloo)):
        got, want = out["pconv"], ref["pconv"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=PCONV_RTOL, err_msg=f"rank {r}")
        for k, w in want["state"].items():
            np.testing.assert_allclose(np.asarray(got["state"][k]),
                                       np.asarray(w), rtol=PCONV_RTOL,
                                       atol=PCONV_ATOL, err_msg=f"{r} {k}")
        # Step 0: rank r's loss is that of one net holding every rank's
        # channels and rank r's head.
        np.testing.assert_allclose(got["losses"][0],
                                   pp_one_card["pconv_step0"][r], rtol=1e-5)


# The long-context example across four cards against one card: the same
# weights and batches, but each layout's attention merges its blocks in
# another order (the ring's dense fp32 blocks against the kernels' bf16
# probabilities), and the loss is the mean of bf16 logits' cross-entropy,
# whose log-normaliser rounds to bf16 (an ulp of 0.0625 at ln 32768):
# losses within 1e-2 relative.
LC_RTOL = 1e-2
MOE_TOL = dict(rtol=2e-5, atol=2e-5)     # fp32, as the gloo tests


@pytest.fixture(scope="module")
def lc_cards(tmp_path_factory):
    return sp_worker.spawn("lc_nccl", _four(),
                           tmp_path_factory.mktemp("lc_cards"),
                           timeout_s=JOIN_TIMEOUT_S)


@pytest.fixture(scope="module")
def lc_one_card(lc_cards, tmp_path_factory):
    return sp_worker.spawn("lc_one_card", 1,
                           tmp_path_factory.mktemp("lc_one_card"),
                           timeout_s=JOIN_TIMEOUT_S)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(sp_worker.LC_CARDS))
def test_long_context_across_cards_matches_one_card(lc_cards, lc_one_card,
                                                    layout):
    one = lc_one_card
    assert len(one["losses"]) == 3 and np.all(np.isfinite(one["losses"]))
    for out in lc_cards:
        assert out["backend"] == "nccl"
        run = out["lc"][layout]
        assert run["losses"] == lc_cards[0]["lc"][layout]["losses"]
        np.testing.assert_allclose(run["losses"], one["losses"],
                                   rtol=LC_RTOL, err_msg=layout)
    steps = [[round(x, 1) for x in o["lc"][layout]["step_ms"]]
             for o in lc_cards]
    print(f"long-context {layout} on four cards: losses "
          f"{lc_cards[0]['lc'][layout]['losses']} vs one card "
          f"{one['losses']}; step ms per rank {steps}; peak "
          f"{[round(o['lc'][layout]['peak_gib'], 2) for o in lc_cards]} GiB;"
          f" one card {[round(x, 1) for x in one['step_ms']]} ms, "
          f"{one['peak_gib']:.2f} GiB")


@pytest.mark.cuda
def test_moe_across_cards_matches_oracle(lc_cards):
    for r, out in enumerate(lc_cards):
        got = out["moe"]
        np.testing.assert_allclose(np.asarray(got["y"]),
                                   np.asarray(got["oracle"]),
                                   err_msg=f"rank {r}", **MOE_TOL)
        assert 0.0 <= got["aux"]["dropped_fraction"] <= 1.0
