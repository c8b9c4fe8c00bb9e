"""The ``afmoe_train`` driver and its readers: a tiny Trinity cell on the
CPU against the plain reference, its planted faults and the control
coming out not correct, the configuration against the program, the new
readers on records with and without what they read, and the work counts
by hand."""

import json
import math
import os

import pytest
import torch

from portbench import calibrate, check, harness, sparse_yardstick
from portbench.tests import tiny
from portbench.tests.tiny import REPO

TRINITY = os.path.join(REPO, "portbench", "configs", "trinity-mini.json")
# The real configuration at widths a CPU run holds (8 layers, 8 of 16
# experts, top 4, window 8).  Limits read on the CPU from seeds 1-12 of the
# program (largest) against the fp8 control on seeds 1-4 (smallest): loss
# 5.5e-3 / 1.0e-2, median leaf's gradient 9.6e-3 / 1.6e-2, worst leaf's
# change 2.0e-2 / 2.6e-2; half the batch reads a gradient of 0.28-0.33,
# the update skipped a change of 1.
TINY = dict(name="tiny-trinity", hidden_size=64, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, intermediate_size=96,
            moe_intermediate_size=32, num_experts=8,
            num_experts_published=16, num_experts_per_tok=4,
            sliding_window=8, vocab=96, vocab_size=96)
LIMITS = {"loss_gap": 8e-3, "grad_gap_median": 0.013, "change_gap": 0.022}
CELL = "tiny-trinity.s32"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(str(tmp_path_factory.mktemp("bench")))
    with open(TRINITY) as f:
        cfg = dict(json.load(f), **TINY)
    d = os.path.join(root, "portbench")
    with open(os.path.join(d, "configs", "tiny-trinity.json"), "w") as f:
        json.dump(cfg, f)
    cell = {"name": CELL, "config": "tiny-trinity", "traffic": "s32",
            "chips": 1, "why": "a CPU test", "limits": LIMITS,
            "traffic_params": {"kind": "tokens", "batch": 4, "seq": 32,
                               "pool": 4, "n_accum": 2}}
    with open(os.path.join(d, "workloads", CELL + ".json"), "w") as f:
        json.dump(cell, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({k: cell[k] for k in ("name", "config",
                                                    "traffic", "chips",
                                                    "why")})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "trinity-mini.train-s4096" in m.get("workloads", []):
            m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def test_program_matches_the_reference_and_reports(root):
    import sys

    sys.path.insert(0, os.path.join(REPO, "portbench"))
    import run

    out = harness.run_rank(tiny.spec(root, CELL, trace=1))
    assert out["correct"], out["checks"]
    res = run.result(harness.Bench(root), CELL, [out], True, "cpu", 1)
    assert {"dispatch_ms.lm", "step_mfu.lm", "moe_ms"} <= set(res["metrics"])
    # No device trace on the CPU: the kernels' shares are left out.
    for name in ("flash_roofline.masked", "moe_gemm_roofline",
                 "moe_permute_roofline"):
        assert name not in res["metrics"]
    c = out["counters"]
    assert c["moe/calls"] > 0 and c["device_spans/moe/backward"] > 0
    # moe_ms reads the window alone: the set-up steps' spans were counted
    # when it opened.
    from portbench.drivers import afmoe_train

    calls = out["work"]["moe"]["calls_per_step"]
    assert c["setup/device_spans/moe"] == calls * afmoe_train.SETUP_STEPS
    assert c["device_spans/moe"] > c["setup/device_spans/moe"]
    assert c["moe/assignments_held"] <= c["moe/assignments_total"]
    assert out["readings"]["program"]["state"], "the biases are compared"


@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged"])
def test_planted_faults_are_not_correct(root, fault):
    out = harness.run_rank(tiny.spec(root, CELL, fault=fault))
    assert not out["correct"], out["checks"]


def test_the_control_is_not_correct(root):
    sp = tiny.spec(root, CELL, mode="readings", seeds=[3, 4],
                   control_seeds=[3, 4], fault_seeds=[], faults=[])
    for r in calibrate.readings_rank(sp)["rows"]:
        correct, _ = check.verdict(r["numbers"], LIMITS)
        assert correct == (r["kind"] == "program"), r


def test_the_configuration_is_what_the_program_builds():
    from chainermn_tpu_torch.models.afmoe import AFMoELM, RMSNorm
    from portbench.drivers import afmoe_train

    with open(TRINITY) as f:
        cfg = json.load(f)
    assert cfg["vocab"] == cfg["vocab_size"] == cfg["vocab_size_published"] // 8
    assert cfg["num_experts"] * 2 == cfg["num_experts_published"]
    assert cfg["mup_enabled"]        # the program scales by sqrt(d_model)
    assert cfg["layer_types"][:cfg["num_hidden_layers"]] == (
        ["sliding_attention"] * 3 + ["full_attention"]) * 2
    with torch.device("meta"):
        ref = afmoe_train.reference(cfg, {})
        prog = AFMoELM(
            vocab=cfg["vocab_size"], d_model=cfg["hidden_size"],
            n_layers=cfg["num_hidden_layers"],
            n_heads=cfg["num_attention_heads"],
            n_kv_heads=cfg["num_key_value_heads"], d_head=cfg["head_dim"],
            d_ff=cfg["intermediate_size"],
            d_expert=cfg["moe_intermediate_size"],
            n_experts=cfg["num_experts_published"],
            top_k=cfg["num_experts_per_tok"],
            n_dense_layers=cfg["num_dense_layers"],
            layer_types=cfg["layer_types"], window=cfg["sliding_window"],
            norm_eps=cfg["rms_norm_eps"], held_experts=cfg["num_experts"],
            device="meta")
    shapes = {n: tuple(t.shape) for n, t in prog.state_dict().items()}
    assert shapes == {n: tuple(t.shape) for n, t in ref.state_dict().items()}
    D, F = cfg["hidden_size"], cfg["moe_intermediate_size"]
    assert shapes["layers.2.mlp.experts_gate"] == (64 * F, D)
    assert shapes["layers.2.mlp.experts_down"] == (64 * D, F)
    assert shapes["layers.2.mlp.router.weight"] == (128, D)
    assert shapes["layers.0.mlp.gate.weight"] == (cfg["intermediate_size"], D)
    assert {m.eps for m in prog.modules() if isinstance(m, RMSNorm)} == {
        cfg["rms_norm_eps"]} == {ref.eps}
    assert [b.attention.window for b in prog.layers] == [
        2048, 2048, 2048, None] * 2
    n = sum(math.prod(s) for s in shapes.values())
    assert 2.84e9 < n < 2.86e9


def test_work_counts_by_hand():
    assert sparse_yardstick.window_pairs(4096, 2048) == (
        2048 * 2049 // 2 + 2048 * 2048)
    assert sparse_yardstick.window_pairs(8, None) == 36
    assert sparse_yardstick.window_pairs(8, 8) == 36
    with open(TRINITY) as f:
        cfg = json.load(f)
    active = sparse_yardstick.afmoe_active_params(cfg)
    attn = 2048 * 4096 * 3 + 2 * 2048 * 512
    moe = 2048 * 128 + 3 * 2048 * 1024 * (1 + 4)
    assert active == 8 * attn + 2 * 3 * 2048 * 6144 + 6 * moe + 25024 * 2048
    f = sparse_yardstick.afmoe_train_flops(cfg, 16, 4096)
    pairs = 6 * (2048 * 2049 // 2 + 2048 * 2048) + 2 * (4096 * 4097 // 2)
    assert f == 6 * active * 65536 + 12 * 128 * 32 * 16 * pairs
    assert f == pytest.approx(2.53e14, rel=5e-3)
    from portbench.drivers import afmoe_train

    w = afmoe_train.work(cfg, {"batch": 16, "seq": 4096, "n_accum": 4}, 1)
    assert sorted(n for *_, n in w["flash_masked"]) == [8, 24]
    assert w["moe"]["calls_per_step"] == 24
    assert w["moe"]["tokens_per_call"] == 16384


def test_the_driver_refuses_an_embedding_scale_it_does_not_build():
    from portbench.drivers import afmoe_train

    with open(TRINITY) as f:
        cfg = json.load(f)
    assert afmoe_train._embed_scale(cfg) == math.sqrt(cfg["hidden_size"])
    with pytest.raises(ValueError, match="mup_enabled"):
        afmoe_train.reference(dict(cfg, mup_enabled=False), {})


def test_readers_without_what_they_read():
    """On a record of a program without the expert layer's counters, or
    without a device trace, every new reader finds nothing and says so."""
    bench = harness.Bench(REPO)
    rec = {"work": {"unit": "tokens"}, "counters": {}, "stretch": None}
    for name in ("flash_roofline.masked", "moe_gemm_roofline",
                 "moe_permute_roofline", "moe_ms"):
        assert bench.metric_reader(name).read(rec) is None


def test_readers_by_hand():
    bench = harness.Bench(REPO)
    moe = {"calls_per_step": 24, "tokens_per_call": 16384, "d_model": 2048,
           "d_expert": 1024}
    kernels = [("void flash_fwd_wgmma<128>", 0.0, 1e3),
               ("cutlass::GroupProblemShape gemm", 1e3, 3e3),
               ("moe_permute_kernel", 3e3, 3.5e3),
               ("moe_combine_bwd_kernel", 3.5e3, 4e3),
               ("nvjet_tst", 4e3, 9e3)]
    counters = {"moe/calls": 10, "moe/assignments_held": 655360,
                "device_ms/moe": 20.0, "device_spans/moe": 10,
                "device_ms/moe/backward": 40.0,
                "device_spans/moe/backward": 10,
                # the set-up steps' spans, slower: left out
                "setup/device_ms/moe": 9.0, "setup/device_spans/moe": 2,
                "setup/device_ms/moe/backward": 12.0,
                "setup/device_spans/moe/backward": 2}
    rec = {"work": {"moe": moe, "flash_masked": [[128, 16, 4096, 128,
                                                   4096 * 128, 1]]},
           "counters": counters,
           "stretch": {"kernels": kernels, "host": [], "wall_s": 1.0,
                       "steps": 1}}
    ms = bench.metric_reader("moe_ms").read(rec)
    assert ms == pytest.approx((11.0 / 8 + 28.0 / 8) * 24)
    gemm = bench.metric_reader("moe_gemm_roofline").read(rec)
    want = 18 * 2048 * 1024 * 65536 * 24 / 2e-3 / 989e12 * 100
    assert gemm == pytest.approx(want)
    move = bench.metric_reader("moe_permute_roofline").read(rec)
    want = 2048 * 2 * (6 * 65536 + 3 * 16384) * 24 / 1e-3 / 3.35e12 * 100
    assert move == pytest.approx(want)
    flash = bench.metric_reader("flash_roofline.masked").read(rec)
    f, b = sparse_yardstick.flash_masked_work(128, 16, 4096, 128,
                                              4096 * 128)["flash_fwd"]
    assert flash == pytest.approx(100 * max(f / 989e12, b / 3.35e12) / 1e-3)
