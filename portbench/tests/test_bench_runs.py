"""Whole runs of tiny cells on the CPU: the program against the plain
references, the planted faults and the control coming out not correct,
the result line, and new files picked up by name.  A card test runs
each real cell once."""

import hashlib
import json
import os
import subprocess
import sys

import pytest

from portbench import calibrate, check, harness
from portbench.tests import tiny
from portbench.tests.tiny import REPO

sys.path.insert(0, os.path.join(REPO, "portbench"))
import run  # noqa: E402


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("workload", ["tiny-lm.s32", "tiny-lm.b1",
                                      "tiny-resnet.b8"])
def test_program_matches_the_reference(root, workload):
    out = harness.run_rank(tiny.spec(root, workload))
    assert out["correct"], out["checks"]
    assert out["window"]["steps"] >= 1 and out["window"]["failed"] == 0


@pytest.mark.parametrize("workload,fault", [
    ("tiny-lm.s32", "state_unchanged"), ("tiny-lm.s32", "half_batch"),
    ("tiny-lm.b1", "half_batch"),
    ("tiny-resnet.b8", "state_unchanged"), ("tiny-resnet.b8", "half_batch"),
])
def test_planted_faults_are_not_correct(root, workload, fault):
    out = harness.run_rank(tiny.spec(root, workload, fault=fault))
    assert not out["correct"], out["checks"]


def test_exchange_left_out_is_not_correct(root):
    sp = tiny.spec(root, "tiny-resnet.dp2", world=2)
    entry = os.path.join(REPO, "portbench", "rank.py")
    good = harness.spawn(sp, 2, 300, entry)[0]
    assert good["correct"], good["checks"]
    bad = harness.spawn(dict(sp, fault="no_exchange"), 2, 300, entry)[0]
    assert not bad["correct"], bad["checks"]


@pytest.mark.parametrize("workload", ["tiny-lm.s32", "tiny-resnet.b8"])
def test_the_control_is_not_correct(root, workload):
    """The reference in fp8 in the program's place fails the limits that
    the program meets."""
    sp = tiny.spec(root, workload, mode="readings", seeds=[7, 8, 9],
                   control_seeds=[7, 8, 9], fault_seeds=[], faults=[])
    rows = calibrate.readings_rank(sp)["rows"]
    limits = tiny.LIMITS[tiny.TINY_CELLS[workload][0]]
    for r in rows:
        correct, _ = check.verdict(r["numbers"], limits)
        assert correct == (r["kind"] == "program"), r


def test_result_line(root):
    sp = tiny.spec(root, "tiny-lm.s32", trace=1)
    outs = [harness.run_rank(sp)]
    bench = harness.Bench(root)
    out = run.result(bench, "tiny-lm.s32", outs, True, "cpu-test", 1)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes", "busy_s", "window_s"}
    # A CPU run has no device trace: the readers of device metrics find
    # nothing to read and leave their metric out.
    assert "dispatch_ms.lm" in out["metrics"]
    assert "step_mfu.lm" in out["metrics"]
    assert "flash_roofline.lm" not in out["metrics"]
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out, allow_nan=False)
    out = run.result(bench, "tiny-lm.s32", outs, False, "cpu-test", 1)
    assert set(out["metrics"]) == {"tokens_per_s", "setup_s"}


def _digest(d):
    h = {}
    for base, _, files in os.walk(d):
        for f in files:
            p = os.path.join(base, f)
            h[p] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return h


def test_new_files_are_picked_up_by_name(root, tmp_path):
    """A configuration, a cell and a per-layer metric added as new files
    (and entries in BENCHMARK.json) run with no file of portbench/
    edited."""
    new = tiny.make_root(str(tmp_path))
    pb = os.path.join(new, "portbench")
    before = _digest(pb)
    cfg = dict(tiny.TINY_LM, name="stub-lm", n_layers=1)
    with open(os.path.join(pb, "configs", "stub-lm.json"), "w") as f:
        json.dump(cfg, f)
    cell = {"name": "stub-lm.s16", "config": "stub-lm", "traffic": "s16",
            "chips": 1, "why": "a stub", "limits": tiny.LIMITS["tiny-lm"],
            "traffic_params": {"kind": "tokens", "batch": 2, "seq": 16,
                               "pool": 4}}
    with open(os.path.join(pb, "workloads", "stub-lm.s16.json"), "w") as f:
        json.dump(cell, f)
    with open(os.path.join(pb, "metrics", "stub_steps.py"), "w") as f:
        f.write('LAYER, MOVES = "train step entry", "tokens_per_s"\n'
                'UNIT, BETTER, SOURCE = "steps", "higher", "host_clock"\n\n'
                'def read(rec):\n    return rec["window"]["steps"]\n')
    with open(os.path.join(new, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({k: cell[k] for k in ("name", "config",
                                                    "traffic", "chips",
                                                    "why")})
    for m in bench["end_to_end"]:
        if m["name"] == "tokens_per_s":
            m["workloads"].append("stub-lm.s16")
    bench["per_layer"].append({"name": "stub_steps", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "train step entry",
                               "moves": "tokens_per_s"})
    with open(os.path.join(new, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    outs = [harness.run_rank(tiny.spec(new, "stub-lm.s16", trace=1))]
    out = run.result(harness.Bench(new), "stub-lm.s16", outs, True, "cpu", 1)
    assert out["correct"]
    assert out["metrics"]["stub_steps"]["value"] == out["attempted"]
    after = _digest(pb)
    assert {p: h for p, h in after.items() if p in before} == before


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, a
    run exits non-zero and prints no result."""
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "resnet50.train-b256", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["gpt3-xl.train-s2048",
                                      "resnet50.train-b256",
                                      "resnet50.dp4-b256",
                                      "gpt3-xl.train-s16384"])
def test_cell_on_the_card(workload):
    import torch

    chips = harness.Bench(REPO).entry(workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s)")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        workload, "--seed", "20260", "--seconds", "3",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
