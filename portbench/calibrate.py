"""Readings that limits are set from, for one cell: the program against
the plain reference on many seeds, the control (the reference in fp8) and
the planted faults on a few, in one process a card.

    python3 portbench/calibrate.py --workload <cell> --seeds 101-112 \\
        --control-seeds 101-103 --fault-seeds 101-103 --out <file.jsonl>

Each line of ``--out`` is one reading: the seed, its kind (``program``,
``control``, a fault's name, or ``bf16_reference``: the reference in the
program's own precision, a witness) and every number of
:func:`check.numbers`.  The benchmark's
own runs never run this; it reads no limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))

from portbench import check, harness  # noqa: E402


def seed_list(text: str) -> list:
    """``"1-3,7"`` -> ``[1, 2, 3, 7]``."""
    out = []
    for part in filter(None, text.split(",")):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def readings_rank(spec: dict) -> dict:
    """One rank's share: every seed's program readings (and its faults'),
    and on rank 0 the reference's and the control's, compared."""
    root = spec["root"]
    harness.hygiene(root)
    import torch

    harness.import_program(root)
    bench = harness.Bench(spec.get("bench_root", root))
    cell, cfg = bench.cell(spec["workload"])
    traffic, drv = cell["traffic_params"], harness.driver(cfg["driver"])
    rank, world = spec["rank"], spec["world"]
    dev = harness._device(torch, spec["device"], rank)
    ctx = harness.Ctx(dev, rank, world, spec["seeds"][0])
    prog = harness.Program(torch, drv, cfg, traffic, ctx)
    rows = []
    for seed in spec["seeds"]:
        t0 = time.time()
        faults = spec["faults"] if seed in spec["fault_seeds"] else []
        mine = {}
        for fault in [None] + faults:
            prog.start(seed, fault)
            mine[fault or "program"] = prog.first_steps(seed)
            prog.release()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if rank == 0:
            ref = harness.reference_readings(torch, drv, cfg, traffic, seed,
                                             world, dev)
            if seed in spec["control_seeds"]:
                mine["control"] = harness.reference_readings(
                    torch, drv, cfg, traffic, seed, world, dev, "fp8")
            if seed in spec.get("witness_seeds", ()):
                mine["bf16_reference"] = harness.reference_readings(
                    torch, drv, cfg, traffic, seed, world, dev, "bf16")
            for kind, r in mine.items():
                rows.append({"seed": seed, "kind": kind,
                             "numbers": check.numbers(r, ref),
                             "losses": r.losses, "ref_losses": ref.losses})
                harness.log(f"seed {seed} {kind}: {rows[-1]['numbers']}")
            if spec.get("keep_readings"):
                rows[-1]["readings"] = {k: v.to_json()
                                        for k, v in mine.items()}
                rows[-1]["readings"]["reference"] = ref.to_json()
            harness.log(f"seed {seed}: {time.time() - t0:.1f} s")
        if world > 1:
            torch.distributed.barrier()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return {"rank": rank, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--witness-seeds", default="",
                    help="seeds on which the reference also runs in bf16")
    ap.add_argument("--faults", default="half_batch,no_exchange")
    ap.add_argument("--keep-readings", action="store_true")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bench = harness.Bench(root)
    cell, _ = bench.cell(args.workload)
    world = cell["chips"]
    faults = [f for f in args.faults.split(",") if f]
    if world == 1:
        faults = [f for f in faults if f != "no_exchange"]
    spec = {"root": root, "workload": args.workload, "mode": "readings",
            "seeds": seed_list(args.seeds),
            "control_seeds": seed_list(args.control_seeds),
            "fault_seeds": seed_list(args.fault_seeds), "faults": faults,
            "witness_seeds": seed_list(args.witness_seeds),
            "keep_readings": args.keep_readings, "rank": 0, "world": world,
            "device": "cuda"}
    if world == 1:
        outs = [readings_rank(spec)]
    else:
        outs = harness.spawn(spec, world, 3000,
                             os.path.join(root, "portbench", "rank.py"))
    with open(args.out, "w") as f:
        for row in outs[0]["rows"]:
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
