"""A tiny benchmark beside the real one, for the CPU tests: the real
``BENCHMARK.json`` and files under a temporary root, plus cells of the
same drivers at sizes a CPU run holds."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY_LM = {"name": "tiny-lm", "driver": "lm_train", "n_layers": 2,
           "d_model": 32, "n_heads": 2, "d_ff": 64, "n_ctx": 32,
           "vocab": 96, "lr": 1e-3, "adam_betas": [0.9, 0.95],
           "adam_eps": 1e-8, "weight_decay": 0.1, "layer_norm_eps": 1e-6,
           "communicator": "pure_nccl", "reduced": []}
TINY_RESNET = {"name": "tiny-resnet", "driver": "convnet_train",
               "stage_sizes": [1, 1], "num_filters": 4, "num_classes": 10,
               "image_size": 32, "lr": 0.1, "momentum": 0.9,
               "bn_momentum": 0.9, "bn_eps": 1e-5, "communicator": "pure_nccl",
               "cudnn_benchmark": False, "reduced": []}
# Limits at these tiny sizes, read on the CPU from seeds 1-8 of the
# program against the reference (the largest) and of the fp8 control (the
# smallest): tiny-lm loss 2.1e-4 / 2.3e-3, worst leaf's gradient 6.3e-3 /
# 4.8e-2, change 4.1e-3 / 1.2e-2; tiny-resnet loss 6.6e-3, median leaf's
# gradient 2.4e-2 / 5.7e-2, median BatchNorm buffer 2.3e-3 / 6.0e-3.
LIMITS = {
    "tiny-lm": {"loss_gap": 1e-3, "grad_gap": 0.02, "change_gap": 0.007},
    "tiny-resnet": {"loss_gap": 0.02, "grad_gap_median": 0.04,
                    "change_gap_median": 0.1, "state_gap_median": 0.004},
}
TINY_CELLS = {
    "tiny-lm.s32": ("tiny-lm", 1, {"kind": "tokens", "batch": 4, "seq": 32,
                                   "pool": 4}),
    "tiny-lm.b1": ("tiny-lm", 1, {"kind": "tokens", "batch": 1, "seq": 64,
                                  "pool": 4}),
    "tiny-resnet.b8": ("tiny-resnet", 1, {"kind": "images", "batch": 8,
                                          "image": 32, "pool": 8}),
    "tiny-resnet.dp2": ("tiny-resnet", 2, {"kind": "images", "batch": 8,
                                           "image": 32, "pool": 8}),
}


def make_root(tmp: str) -> str:
    """A benchmark root at ``tmp``: the real one, and the tiny cells on the
    real metrics (each tiny cell reports every metric of its family)."""
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(tmp, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    d = os.path.join(tmp, "portbench")
    for cfg in (TINY_LM, TINY_RESNET):
        with open(os.path.join(d, "configs", cfg["name"] + ".json"), "w") as f:
            json.dump(cfg, f)
    for name, (cfg, chips, params) in TINY_CELLS.items():
        traffic = name.split(".", 1)[1]
        cell = {"name": name, "config": cfg, "traffic": traffic,
                "chips": chips, "why": "a CPU test", "traffic_params": params,
                "limits": LIMITS[cfg]}
        with open(os.path.join(d, "workloads", name + ".json"), "w") as f:
            json.dump(cell, f)
        bench["workloads"].append({k: cell[k] for k in
                                   ("name", "config", "traffic", "chips",
                                    "why")})
        fam = "lm" if cfg == "tiny-lm" else "resnet"
        for m in bench["end_to_end"] + bench["per_layer"]:
            ws = m.get("workloads")
            if ws is not None and any(w.startswith(
                    "gpt3" if fam == "lm" else "resnet50") for w in ws):
                ws.append(name)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp


def spec(root: str, workload: str, **kw) -> dict:
    import time

    out = {"root": REPO, "bench_root": root, "workload": workload,
           "seed": 2**31 + 12345, "seconds": 0.3, "trace": 0, "rank": 0,
           "world": 1, "device": "cpu", "t_start": time.time()}
    out.update(kw)
    return out
