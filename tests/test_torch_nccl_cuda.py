"""The data-parallel surface over NCCL across GPUs, one process a GPU.

What the gloo tests hold on the CPU, here on the card's own backend: the
gradient hooks launching NCCL collectives from the autograd thread, the
int8 and fp8 wires summed by NCCL, ZeRO's reduce-scatter and all-gather,
the object plane on its gloo side group inside an NCCL job, ``split``,
the MNIST example at its defaults (checkpoint resume included), and
``make_train_step_with_state`` on a small ResNet (BatchNorm buffers
averaged over the ranks).

Imports only torch, numpy and the port: on a host with two or more GPUs,
``python -m pytest --noconftest tests/test_torch_nccl_cuda.py -q``
(up to 4 ranks).  With fewer GPUs every test skips.
"""

import json
import multiprocessing as mp

import numpy as np
import pytest
import torch

import _torch_dp_worker as worker

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
