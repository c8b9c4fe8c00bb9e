"""BENCHMARK.json and the files its names lead to: names, units, layers,
bounds, and that every cell, configuration, driver and metric resolves."""

import importlib
import json
import os
import re

import pytest

from portbench import harness
from portbench.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
DRIVER_API = ("OPTIMIZER", "reference", "ref_step", "work", "build",
              "first_grad_norms")


@pytest.fixture(scope="module")
def bench():
    return harness.Bench(REPO)


def test_top_level_keys(bench):
    s = bench.spec
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["command"] == ["python3", "portbench/run.py"]
    assert s["paths"] == ["portbench"]
    assert 1 <= s["run_seconds"] <= 51 and isinstance(s["run_seconds"], int)
    assert len(json.dumps(s)) < 64 * 1024
    # 2 + 14 runs a cell of run_seconds + 60, 2 x 90 s a cell, 1200 spare,
    # all 24 cells, within 43200 s.
    assert (2 + 14 * 24) * (s["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units(bench):
    s = bench.spec
    names = [c["name"] for c in s["configs"]] + [
        w["name"] for w in s["workloads"]] + [
        m["name"] for m in s["end_to_end"] + s["per_layer"]]
    for n in names + [w["traffic"] for w in s["workloads"]]:
        assert NAME.match(n), n
    for c in s["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k), k
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    metric_names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in s[group]]
        assert len(set(ns)) == len(ns)


def test_entries_have_exactly_their_keys(bench):
    s = bench.spec
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and "\n" not in c["source"]
        assert 1 <= len(c["why"]) <= 200
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert 1 <= len(m["layer"]) <= 200
    assert {m["name"] for m in s["end_to_end"]} >= {"setup_s"}
    four = [w for w in s["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(s["workloads"]) // 4)


def test_cells_configs_and_drivers_resolve(bench):
    pairs = set()
    for w in bench.spec["workloads"]:
        cell, cfg = bench.cell(w["name"])
        pairs.add((w["config"], w["traffic"]))
        assert cell["name"] == w["name"] and cell["why"] == w["why"]
        known = {"loss_gap"} | {f"{k}_gap{m}" for k in ("grad", "change",
                                                        "state")
                                for m in ("", "_median")}
        assert "loss_gap" in cell["limits"] and set(cell["limits"]) <= known
        assert all(v > 0 for v in cell["limits"].values())
        drv = harness.driver(cfg["driver"])
        for attr in DRIVER_API:
            assert hasattr(drv, attr), (cfg["driver"], attr)
    assert len(pairs) == len(bench.spec["workloads"])
    for c in bench.spec["configs"]:
        path = os.path.join(REPO, c["file"])
        assert c["file"].startswith("portbench/configs/")
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in bench.spec["workloads"])


def test_every_cell_reports_what_it_must(bench):
    s = bench.spec
    for w in s["workloads"]:
        e2e = {m["name"] for m in bench.metrics(w["name"], False)}
        per = bench.metrics(w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert per, w["name"]
        for m in per:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_metric_files_declare_what_the_json_says(bench):
    s = bench.spec
    for m in s["end_to_end"] + s["per_layer"]:
        mod = bench.metric_reader(m["name"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (
            m["unit"], m["better"], m["source"]), m["name"]
        if "layer" in m:
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
        assert callable(mod.read)


def test_layer_names_are_consistent(bench):
    layers = {}
    for m in bench.spec["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) == {"train step entry", "model step on the device",
                           "device", "kernels", "communicator"}


def test_program_configs_match_the_program():
    """The configuration states what the program does where the program
    has no knob: the LM's LayerNorm epsilon, BatchNorm's momentum and
    epsilon."""
    from chainermn_tpu_torch.models.layers import BatchNorm
    from chainermn_tpu_torch.models.transformer import LayerNorm

    with open(os.path.join(REPO, "portbench/configs/gpt3-xl.json")) as f:
        lm = json.load(f)
    with open(os.path.join(REPO, "portbench/configs/resnet50.json")) as f:
        rn = json.load(f)
    assert lm["layer_norm_eps"] == LayerNorm.EPS
    assert lm["d_head"] * lm["n_heads"] == lm["d_model"]
    bn = BatchNorm(4)
    assert (rn["bn_momentum"], rn["bn_eps"]) == (bn.momentum, bn.epsilon)
    importlib.import_module("portbench.drivers.lm_train")
