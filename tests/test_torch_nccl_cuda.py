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

The multi-process serving tier across four cards: a router in this
process (the transport's ``TCPStore`` master) and four replica processes
of ``tests/_torch_serve_mp_worker.py``'s ``card`` mode, one a card through
``CUDA_VISIBLE_DEVICES``, at ``chip_smoke.py`` phase 14's widths on 32
requests; replica rank 1 is SIGKILLed after 40 streamed tokens.  Every
stream is held to one card's engine by phase 12 (e)'s contract; tokens/s,
TTFT and the failover gap are printed with the card line.

The GSPMD step over NCCL (one spawn of ``_torch_gspmd_worker``'s
``gspmd_cards`` across four cards, one ``gspmd_one_card`` on one card):
phase 4's model (vocab 32768, d_model 2048, 16 heads, d_ff 8192, 8
layers, S 4096, global batch 4, bf16, AdamW) under plans ``tp`` (model =
4), ``dp_tp`` (2 x 2), ``fsdp`` and ``zero`` (data = 4), 3 steps each,
against one card's unsharded step: losses within 1e-2 relative, each
plan's step per rank, peak memory and bytes of parameters and moments a
card.

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
import _torch_gspmd_worker as gspmd_worker
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


# The GSPMD step's plans across four cards against one card's unsharded
# step: the same weights and batches, but the bf16 products are summed in
# other orders (row- and column-parallel GEMMs, reduce-scattered
# gradients) and the CE's log-normaliser rounds to bf16: losses within
# 1e-2 relative, the standard of the long-context cases.
GSPMD_RTOL = 1e-2


@pytest.fixture(scope="module")
def gspmd_cards(tmp_path_factory):
    return gspmd_worker.spawn("gspmd_cards", _four(),
                              tmp_path_factory.mktemp("gspmd_cards"),
                              timeout_s=JOIN_TIMEOUT_S)


@pytest.fixture(scope="module")
def gspmd_one_card(gspmd_cards, tmp_path_factory):
    return gspmd_worker.spawn("gspmd_one_card", 1,
                              tmp_path_factory.mktemp("gspmd_one_card"),
                              timeout_s=JOIN_TIMEOUT_S)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("plan", sorted(gspmd_worker.GSPMD_CARDS))
def test_gspmd_plans_across_cards_match_one_card(gspmd_cards, gspmd_one_card,
                                                 plan):
    one = gspmd_one_card
    assert len(one["losses"]) == 3 and np.all(np.isfinite(one["losses"]))
    for out in gspmd_cards:
        assert out["backend"] == "nccl"
        run = out["plans"][plan]
        assert run["losses"] == gspmd_cards[0]["plans"][plan]["losses"]
        np.testing.assert_allclose(run["losses"], one["losses"],
                                   rtol=GSPMD_RTOL, err_msg=plan)
    runs = [o["plans"][plan] for o in gspmd_cards]
    print(f"gspmd {plan} on four cards: losses {runs[0]['losses']} vs one "
          f"card {one['losses']}; step ms per rank "
          f"{[[round(x, 1) for x in r['step_ms']] for r in runs]}; peak "
          f"{[round(r['peak_gib'], 2) for r in runs]} GiB; parameters "
          f"{[round(r['param_bytes'] / 2**30, 3) for r in runs]} GiB, "
          f"moments {[round(r['moment_bytes'] / 2**30, 3) for r in runs]} "
          f"GiB a card; one card {[round(x, 1) for x in one['step_ms']]} ms,"
          f" {one['peak_gib']:.2f} GiB")
    for who, prof in [(f"rank {r}", run["profile"])
                      for r, run in enumerate(runs)] + [
            ("one card", one["profile"])]:
        kinds = ", ".join(f"{k} {v:.1f}" for k, v in sorted(
            prof["by_kind_ms"].items(), key=lambda kv: -kv[1]))
        print(f"gspmd {plan} profiled step, {who}: wall "
              f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} "
              f"ms, idle share {prof['idle_share']:.3f}; by kind (ms): "
              f"{kinds}")
    if plan == "tp":
        # the sharded weights and their moments take a quarter a card
        full = gspmd_cards[0]["plans"]["zero"]["param_bytes"]
        assert runs[0]["param_bytes"] < 0.4 * full


# Serving across the cards (one spawn of ``_torch_serve_worker``'s
# ``serve_one_card`` on one card, then ``serve_cards`` across four):
# phase 4's LM widths in bf16 at chip_smoke.py's serving geometry.  The
# TP engine (plan ``tp``, model = 4) on 16 requests of 64 tokens, 32 new,
# B 8; SP prefill at sp 2 and 4 on 4 prompts of 1024 tokens in slices of
# 256.  The row-parallel sums and the sharded K/V projections round in
# other orders than one card's GEMMs, so streams are held by phase 12
# (e)'s contract: teacher-forced logits (fed the one-card streams) within
# 2^-5 of each row's largest |logit|, and a stream may leave the one-card
# stream only where that stream's top-2 margin is below its
# teacher-forced difference.
SERVE_TOL = 2.0 ** -5


@pytest.fixture(scope="module")
def serve_one_card(tmp_path_factory):
    import _torch_serve_worker as serve_worker

    _four()
    tmp = tmp_path_factory.mktemp("serve_one_card")
    res = serve_worker.spawn("serve_one_card", 1, tmp,
                             timeout_s=JOIN_TIMEOUT_S)[0]
    return res, tmp


@pytest.fixture(scope="module")
def serve_cards(serve_one_card, tmp_path_factory):
    import _torch_serve_worker as serve_worker

    one, _ = serve_one_card
    tmp = tmp_path_factory.mktemp("serve_cards")
    res = serve_worker.spawn(
        "serve_cards", _four(), tmp, timeout_s=JOIN_TIMEOUT_S,
        one_card={"tp": one["tp"]["streams"],
                  "long": one["long"]["streams"]})
    return res, tmp


def _serving_contract(streams, refs, tf, tf_ref):
    """Phase 12 (e)'s contract; returns (identical, max difference)."""
    same, worst = 0, 0.0
    for i, (s, a) in enumerate(zip(streams, refs)):
        diff = float(np.max(np.abs(tf[i] - tf_ref[i]).max(-1)
                            / np.abs(tf_ref[i]).max(-1)))
        worst = max(worst, diff)
        if s == a:
            same += 1
            continue
        j = next(k for k, (x, y) in enumerate(zip(s, a)) if x != y)
        top = np.sort(tf_ref[i][j])[-2:]
        margin = (top[1] - top[0]) / np.abs(tf_ref[i][j]).max()
        assert margin < diff, (i, j, margin, diff)
    assert worst <= SERVE_TOL, worst
    return same, worst


def _npz(path):
    with np.load(path) as f:
        return [f[f"arr_{i}"] for i in range(len(f.files))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tp", "sp2", "sp4"])
def test_serving_across_cards_matches_one_card(serve_cards, serve_one_card,
                                               case):
    cards, tmp = serve_cards
    one, tmp1 = serve_one_card
    ref = one["tp"] if case == "tp" else one["long"]
    tf_ref = _npz(tmp1 / f"tf_{'tp' if case == 'tp' else 'long'}_one_card.npz")
    for r, out in enumerate(cards):
        assert out["backend"] == "nccl"
        run = out[case]
        assert run["streams"] == cards[0][case]["streams"]   # lockstep
        same, worst = _serving_contract(
            run["streams"], ref["streams"],
            _npz(tmp / f"tf_{case}_rank{r}.npz"), tf_ref)
        print(f"serve {case} rank {r}: {run['tokens_per_s']:.1f} tokens/s "
              f"(one card {ref['tokens_per_s']:.1f}), TTFT p50 "
              f"{run['ttft_p50_ms']:.1f} ms max {run['ttft_max_ms']:.1f} "
              f"(one card {ref['ttft_p50_ms']:.1f} / "
              f"{ref['ttft_max_ms']:.1f}); {same}/{len(ref['streams'])} "
              f"streams identical, teacher-forced difference {worst:.3g}")
        if case == "tp":
            prof = run["profile"]
            assert run["local_kv_heads"] == 16 // len(cards)
            print(f"serve tp rank {r}: decode step B=8 wall "
                  f"{prof['wall_ms']:.1f} ms, device busy "
                  f"{prof['busy_ms']:.2f} ms, NCCL {prof['nccl_ms']:.2f} ms "
                  f"(one card: wall {one['tp']['profile']['wall_ms']:.1f}, "
                  f"busy {one['tp']['profile']['busy_ms']:.2f})")
        else:
            assert run["sp_chunk_compiles"] >= 1


# The multi-process serving tier across four cards: chip_smoke.py phase
# 14's cell (phase 4's widths, bf16, seed 0, max_len 512, 512 pages of 16 a
# replica, B 8, one batch queued a replica) on 32 greedy requests, one
# replica process a card.  The replicas share no process group: only the
# transport's store and sockets.
FLEET_CARD_FLAGS = ["--vocab", "32768", "--d-model", "2048", "--heads", "16",
                    "--d-ff", "8192", "--layers", "8", "--max-len", "512",
                    "--block-size", "16", "--n-blocks", "512",
                    "--max-batch", "8", "--max-queue", "8",
                    "--requests", "32", "--prompt-len", "64",
                    "--new-tokens", "32", "--seed", "0", "--warm-start",
                    "--timeout-s", "300", "--miss-after-s", "30"]
FLEET_KILL_TOKENS = 40


@pytest.mark.cuda
def test_serving_fleet_across_cards_survives_kill9():
    """A router and four replica processes, one a card; replica rank 1
    (the first the router fills) SIGKILLs itself after 40 streamed tokens
    and the router fails its streams over.  Every request finishes; every stream equals one card's
    sequential engine or is explained by phase 12 (e)'s contract (its
    top-2 margin at the divergence within the stream's teacher-forced
    difference between decode at B 1 and B 8); every replica holds the
    same weights (crc32)."""
    import os
    import subprocess
    import sys

    import _torch_serve_worker as serve_worker
    from chainermn_tpu_torch.communicators import kvtransport
    from chainermn_tpu_torch.serving import InferenceEngine
    from chainermn_tpu_torch.serving.cluster import service
    from chainermn_tpu_torch.tools import serve

    n = _four()
    size = n + 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    args = serve.build_parser().parse_args(FLEET_CARD_FLAGS + [
        "--role", "router", "--coordinator", "127.0.0.1:0",
        "--num-processes", str(size), "--process-id", "0"])
    store = serve._init_distributed(args)
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    try:
        for pid in range(1, size):
            env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(pid - 1),
                       PYTHONPATH=os.pathsep.join(
                           p for p in (os.path.dirname(here),
                                       os.environ.get("PYTHONPATH")) if p))
            kill = FLEET_KILL_TOKENS if pid == 1 else 0
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(here,
                                              "_torch_serve_mp_worker.py"),
                 "card", str(pid), str(size), str(store.port), str(kill),
                 "--"] + FLEET_CARD_FLAGS,
                stdout=subprocess.PIPE, text=True, env=env))
        prompts = serve._synthetic_prompts(args)
        stats = {}
        results = service.run_router(
            size, [{"prompt": p, "max_new_tokens": args.new_tokens,
                    "timeout_s": args.timeout_s} for p in prompts],
            miss_after_s=args.miss_after_s, timeout_s=args.timeout_s,
            wait_ready=True, stats=stats)
        outs = [p.communicate(timeout=JOIN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        kvtransport.uninstall()
        del store
    codes = [p.returncode for p in procs]
    assert codes == [-9] + [0] * (n - 1), codes
    reports = [json.loads(o.splitlines()[-1]) for o in outs[1:]]
    assert len({r["weights_crc32"] for r in reports}) == 1

    lm = serve._build_model(args)
    assert serve.weights_crc32(lm) == reports[0]["weights_crc32"]
    eng = InferenceEngine(lm, serve._engine_config(args), device=args.device)
    oracle = [eng.generate(p, args.new_tokens) for p in prompts]
    streams = [results[g]["tokens"] for g in range(len(prompts))]
    assert all(r["status"] == "finished" for r in results.values())
    failovers = sum(r["failovers"] for r in results.values())
    assert failovers > 0
    tf1 = [serve_worker._teacher_forced(eng, p, s)
           for p, s in zip(prompts, oracle)]
    tf8 = serve_worker._teacher_forced_b8(eng, prompts, oracle)
    same, worst = _serving_contract(streams, oracle, tf8, tf1)

    lat = serve._latency(results)
    gaps = [max((b - a for a, b in zip(r["token_times"],
                                       r["token_times"][1:])), default=0.0)
            for r in results.values() if r["failovers"]]
    tokens = sum(len(s) for s in streams)
    print(f"serve fleet across {n} cards ({card}): "
          f"{tokens / stats['serve_wall_s']:.1f} tokens/s over "
          f"{stats['serve_wall_s']:.2f} s of serving (ready after "
          f"{stats['ready_s']:.1f} s), TTFT p50 "
          f"{lat['ttft_p50_s'] * 1e3:.1f} ms p99 "
          f"{lat['ttft_p99_s'] * 1e3:.1f} ms, per-token p50 "
          f"{lat['per_token_p50_s'] * 1e3:.2f} ms p99 "
          f"{lat['per_token_p99_s'] * 1e3:.2f} ms; {failovers} failovers, "
          f"largest gap of a failed-over stream {max(gaps):.3f} s; "
          f"{same}/{len(streams)} streams identical to one card's, "
          f"teacher-forced difference {worst:.3g}; streamed "
          f"{[r['streamed'] for r in reports]}")


# MNIST under the elastic supervisor across four cards: every step's
# global batch is the whole training set (240 images, which 4 and 3
# divide), so a rescaled world computes the same sums in another order
# and holds the CPU soak's limit (tests/test_torch_elastic_soak.py).
ELASTIC_CARDS_MNIST = ["--communicator", "pure_nccl", "--batchsize", "240",
                       "--train-size", "240", "--val-size", "240",
                       "--epochs", "12", "--checkpoint-every", "1"]


def _elastic_mnist(tmp, *extra):
    import os
    import subprocess
    import sys

    from chainermn_tpu_torch.observability.step_log import read_records

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rank_log = tmp / "ranks.jsonl"
    cmd = [sys.executable, "-m", "chainermn_tpu_torch.tools.elastic",
           "--nproc", "4", "--workdir", str(tmp / "work"), "--grace", "10",
           *extra, "--", sys.executable, "-m",
           "chainermn_tpu_torch.examples.train_mnist", *ELASTIC_CARDS_MNIST,
           "--elastic", "--checkpoint-dir", str(tmp / "ck"),
           "--step-log", str(rank_log)]
    p = subprocess.run(cmd, cwd=repo, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True,
                       timeout=JOIN_TIMEOUT_S,
                       env=dict(os.environ, PYTHONPATH=repo))
    line = [ln for ln in p.stdout.splitlines()
            if ln.startswith("ELASTIC_REPORT ")]
    assert p.returncode == 0 and line, p.stdout[-4000:]
    losses = {r["step"]: r["loss"] for r in read_records(str(rank_log))
              if r.get("event") == "step" and r.get("rank") == 0}
    return json.loads(line[-1].split(" ", 1)[1]), p.stdout, losses


@pytest.mark.cuda
def test_elastic_mnist_rescales_4_to_3_across_cards(tmp_path):
    """``tools.elastic --nproc 4 --rescale-on-failure`` around the MNIST
    example over NCCL, rank 1 SIGKILLed at step 5: the world restarts at
    3, re-placed through plan ``dp``, and every loss stays within 2e-3 of
    the unfaulted four-card run's."""
    _four()
    oracle, _, want = _elastic_mnist(tmp_path / "oracle")
    assert oracle["status"] == "ok" and oracle["incarnations"] == 1
    report, out, losses = _elastic_mnist(
        tmp_path / "rescale", "--rescale-on-failure",
        "--chaos", "kill:rank=1:step=5")
    assert report["status"] == "ok" and report["world"] == 3, report
    assert report["restarts"] == 1, report
    assert "elastic_reshard plan=dp ok=True" in out and "world=3" in out
    assert sorted(losses) == sorted(want) == list(range(12))
    worst = max(abs(losses[g] - want[g]) / max(1.0, abs(want[g]))
                for g in want)
    print(f"elastic MNIST 4 -> 3 cards: resumed from "
          f"{report['resume_generation']}, worst loss difference {worst:.3g} "
          f"(limit 2e-3), {report}")
    assert worst <= 2e-3, (losses, want)


@pytest.mark.cuda
def test_tuning_allreduce_bucket_across_cards(tmp_path):
    """``tune_allreduce_bucket`` over NCCL at four ranks, one a card, each
    rank with its own cache file: the ranks agree on the pick (the largest
    time of the ranks decides) and only rank 0 wrote its cache."""
    import os

    _four()
    res = mp_worker.spawn("tuning_nccl", 4, tmp_path,
                          timeout_s=JOIN_TIMEOUT_S, comm="pure_nccl",
                          dir=str(tmp_path), total_mb=64.0, n_leaves=64,
                          n1=3, repeats=3)
    print(f"tuning across cards: chosen {res[0]['chosen']}, seconds by "
          f"candidate {res[0]['seconds']}, key {res[0]['key']}")
    assert len({json.dumps(r["chosen"]) for r in res}) == 1
    assert [r["written"] for r in res] == [True, False, False, False]
    assert [os.path.exists(tmp_path / f"cache{r}.json")
            for r in range(4)] == [True, False, False, False]
    assert {r["device_size"] for r in res} == {4}
    assert torch.cuda.get_device_name(0) in res[0]["key"]


def _lint_cli(*args, timeout=JOIN_TIMEOUT_S):
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    return subprocess.run(
        [sys.executable, "-m", "chainermn_tpu_torch.tools.lint", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=repo)


@pytest.mark.cuda
def test_lint_clean_gate_and_fixtures_across_cards():
    """``tools.lint`` at four NCCL ranks, one a card: the clean gate on the
    five communicators (both legs of the two-level ones: a 2 x 2
    topology) exits 0; the R fixtures flag the port golden's rules, R001's
    cross-rank comparison included (rank 0 alone all-reduces during the
    capture, which must not hang: no collective leaves a rank while its
    step is captured)."""
    import os
    import time

    _four()
    t0 = time.perf_counter()
    clean = _lint_cli("--device", "cuda", "--world", "4", "--format", "json")
    t_clean = time.perf_counter() - t0
    assert clean.returncode == 0, clean.stderr[-3000:]
    payload = json.loads(clean.stdout)
    assert payload["ok"] and len(payload["targets"]) == 5
    for t in payload["targets"]:
        assert t["rules_run"] == ["R001", "R002", "R003", "R004", "R005"]
    from chainermn_tpu_torch.analysis.fixtures import FIXTURES, \
        LOCAL_FIXTURES

    names = sorted(n for n in FIXTURES if n not in LOCAL_FIXTURES)
    t0 = time.perf_counter()
    fx = _lint_cli("--fixtures", *names, "--device", "cuda", "--world", "4",
                   "--format", "json")
    t_fx = time.perf_counter() - t0
    assert fx.returncode == 1, fx.stderr[-3000:]
    got = {t["target"]: sorted({f["rule"] for f in t["findings"]})
           for t in json.loads(fx.stdout)["targets"]}
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden", "torch_lint_fixtures.json")
    with open(golden) as f:
        want = json.load(f)["flagged_rules"]
    print(f"lint across four cards: clean gate {t_clean:.1f}s, fixtures "
          f"{t_fx:.1f}s, {got}")
    assert got == {n: want[n] for n in names}


@pytest.mark.cuda
def test_collective_audit_across_cards(tmp_path):
    """The collective audit at four NCCL ranks as 2 x 2, one a card: the
    audits of ``allreduce_grad`` over the reference's 64-leaf tree (five
    communicators, bucketed, unbucketed, int8, overlapped) and of phase
    4's LM step with the overlapped bucket launch equal, rank by rank,
    torch's fake process group's audits of the same layout on one card;
    the LM step's ``overlap_fraction`` is printed beside the share of NCCL
    kernel time a ``torch.profiler`` trace shows under compute kernels."""
    import os
    import subprocess
    import sys

    import _torch_audit_worker as audit_worker

    _four()
    cards = audit_worker.spawn_ranks(4, tmp_path, (2, 2),
                                    timeout_s=JOIN_TIMEOUT_S)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run(
        [sys.executable, os.path.join(repo, "tests", "_torch_audit_worker.py"),
         "--device", "cuda", "--ranks", "0,1,2,3", "--mesh", "2x2",
         "--no-serving", "--lm"], capture_output=True, text=True,
        timeout=JOIN_TIMEOUT_S, env=dict(os.environ, PYTHONPATH=repo),
        cwd=repo)
    assert p.returncode == 0, p.stderr[-3000:]
    fake = json.loads(p.stdout.strip().splitlines()[-1])["ranks"]
    for r, got in enumerate(cards):
        lm = got["lm"]
        print(f"audit across cards, rank {r}: LM {lm['counts']} "
              f"{lm['bytes_per_axis']}, async pairs {lm['async_pairs']}, "
              f"overlap_fraction {lm['overlap_fraction']:.3f}, profiled "
              f"NCCL time under compute {lm['profiler_nccl_overlap']:.3f}")
        nccl_share = lm.pop("profiler_nccl_overlap")
        assert 0.0 <= nccl_share <= 1.0
        assert got == fake[str(r)], r
