"""Multi-replica serving CLI — port of ``chainermn_tpu/tools/serve.py``.

Launches the serving cluster tier from the shell in either of two
shapes:

``--role local`` (default)
    Everything in this process: N in-process replicas behind a
    :class:`~chainermn_tpu_torch.serving.cluster.ReplicaRouter`, threaded
    per-replica stepping, synthetic request traffic, one JSON report on
    stdout.  ``--verify`` additionally replays every prompt through a
    sequential single-engine oracle and asserts the routed streams are
    identical.  With ``--tp``/``--pp`` above 1 or ``--groups`` above 1
    the local role instead launches a whole multi-process fleet: this
    process becomes the router and starts the replica processes.

``--role router`` / ``--role replica``
    One process per role over the host object plane (the
    :mod:`~chainermn_tpu_torch.serving.cluster.service` wire protocol).
    Every process reaches the same ``torch.distributed.TCPStore``
    (``--coordinator host:port --num-processes N --process-id i``):
    process 0, the router, holds the store's master; every other process
    a client.  The fleet needs no process group.  The router drives the
    synthetic traffic and prints the same JSON report shape.

The flags are the reference's, plus ``--device`` (default ``cuda``; every
role refuses to start without a card unless given ``--device cpu``) and
``--warm-start`` (each replica serves one short request before its first
load beat, and the router holds the traffic until every replica has
reported one, so the report's latencies exclude start-up).

Usage::

    # in-process smoke on the CPU: 2 replicas, oracle parity check
    python -m chainermn_tpu_torch.tools.serve --device cpu --replicas 2 --verify

    # heavy-tailed traffic + SLO-guarded autoscaling + timed chaos
    python -m chainermn_tpu_torch.tools.serve --device cpu --replicas 2 \\
        --autoscale --traffic "rate=120,requests=32,abusive_frac=0.2" \\
        --chaos "kill:replica=1:at=0.5" --verify

    # one router and two replica processes on the card, parity checked
    # under greedy and sampled decoding
    python -m chainermn_tpu_torch.tools.serve --groups 2 --verify

    # a shard group: a leader and one lockstep follower mirror
    python -m chainermn_tpu_torch.tools.serve --tp 2 --verify

    # multi-process by hand (three shells):
    python -m chainermn_tpu_torch.tools.serve --role router \\
        --coordinator 127.0.0.1:9123 --num-processes 3 --process-id 0
    python -m chainermn_tpu_torch.tools.serve --role replica \\
        --coordinator 127.0.0.1:9123 --num-processes 3 --process-id 1
    python -m chainermn_tpu_torch.tools.serve --role replica \\
        --coordinator 127.0.0.1:9123 --num-processes 3 --process-id 2

The model is the port's :class:`TransformerLM` (bf16 compute) with
randomly initialised parameters (geometry from the ``--vocab``/
``--d-model``/... flags): every process initialises it on the CPU from
``--seed`` with the port's initialiser, then moves it to its device, so
every process holds the same weights (replicas report a crc32 of them),
which is what makes cross-replica migration and the oracle parity check
meaningful.  The port's initialiser draws other values than the
reference's flax init.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import zlib
from typing import List, Optional


def _build_model(args):
    from ..models.transformer import TransformerLM

    lm = TransformerLM(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.heads,
        d_ff=args.d_ff, n_layers=args.layers, max_len=args.max_len,
        device=args.device, seed=args.seed,
    )
    lm.requires_grad_(False)
    return lm


def weights_crc32(lm) -> int:
    """crc32 over every parameter's bytes, in ``state_dict`` order — equal
    on two processes exactly when their weights are."""
    import torch

    crc = 0
    for _name, t in lm.state_dict().items():
        host = t.detach().to("cpu").contiguous()
        if host.dtype == torch.bfloat16:
            host = host.view(torch.int16)
        crc = zlib.crc32(host.numpy().tobytes(), crc)
    return crc


def module_info(built: list) -> dict:
    """The weights' crc32 and parameter count of the module a factory
    built (computed after serving, off the start-up path); empty when it
    built none."""
    if not built:
        return {}
    return {"weights_crc32": weights_crc32(built[0]),
            "params": sum(p.numel() for p in built[0].parameters())}


def cuda_memory(device) -> dict:
    """This process's peak CUDA allocator memory (MiB) on ``device``;
    empty off the card."""
    import torch

    if not str(device).startswith("cuda"):
        return {}
    return {"cuda_max_allocated_mib":
            torch.cuda.max_memory_allocated() / 2**20,
            "cuda_max_reserved_mib":
            torch.cuda.max_memory_reserved() / 2**20}


def _engine_config(args):
    from ..serving import EngineConfig

    return EngineConfig(
        block_size=args.block_size, n_blocks=args.n_blocks,
        max_len=args.max_len, max_batch=args.max_batch,
        draft=args.draft,
        draft_layers=args.draft_layers,
        prefill_chunk=args.prefill_chunk,
        sp=args.sp,
        max_len_growth=args.max_len_growth,
    )


def _engine_factory(args, built: Optional[list] = None):
    """``factory()`` building an :class:`InferenceEngine` over one module
    this process builds on the first call (engines share it; each owns
    its pages) — so a replica's first heartbeat goes out before the
    module is built.  ``built`` (a list) receives the module.  With
    ``--warm-start`` each engine serves one short request before it is
    returned."""
    from ..serving import InferenceEngine

    built = [] if built is None else built

    def factory():
        if not built:
            built.append(_build_model(args))
        eng = InferenceEngine(built[0], _engine_config(args),
                              device=args.device)
        if args.warm_start:
            eng.generate([1] * min(8, args.max_len // 2), 2)
        return eng

    return factory


def _synthetic_prompts(args) -> List[List[int]]:
    import numpy as np

    rng = np.random.default_rng(args.seed)
    lens = rng.integers(
        max(1, args.prompt_len // 2), args.prompt_len + 1,
        size=args.requests,
    )
    return [
        [int(t) for t in rng.integers(1, args.vocab, size=int(n))]
        for n in lens
    ]


def _parse_roles(spec: Optional[str], n: int) -> List[str]:
    from ..serving.cluster.replica import ROLES

    if not spec:
        return ["both"] * n
    roles = [r.strip() for r in spec.split(",")]
    if len(roles) != n:
        raise SystemExit(
            f"--roles names {len(roles)} roles for {n} replicas"
        )
    for r in roles:
        if r not in ROLES:
            raise SystemExit(f"unknown role {r!r} (choose from {ROLES})")
    return roles


def _report(args, results: dict, wall: float, extra: dict) -> dict:
    tokens = sum(len(r["tokens"]) for r in results.values())
    statuses: dict = {}
    for r in results.values():
        statuses[r["status"]] = statuses.get(r["status"], 0) + 1
    report = {
        "mode": args.role,
        "replicas": args.replicas,
        "requests": len(results),
        "statuses": statuses,
        "tokens": tokens,
        "tokens_per_sec": round(tokens / wall, 1) if wall > 0 else None,
        "failovers": sum(r["failovers"] for r in results.values()),
        "device": args.device,
        "config": {
            "vocab": args.vocab, "d_model": args.d_model,
            "n_layers": args.layers, "max_len": args.max_len,
            "block_size": args.block_size, "n_blocks": args.n_blocks,
            "max_batch": args.max_batch, "max_queue": args.max_queue,
            "watermark_blocks": args.watermark,
            "prefill_threshold": args.prefill_threshold,
            "draft": args.draft, "draft_layers": args.draft_layers,
            "prefill_chunk": args.prefill_chunk,
            "sp": args.sp, "max_len_growth": args.max_len_growth,
        },
    }
    report.update(extra)
    return report


def _oracle_streams(args, prompts, samplings=None) -> List[List[int]]:
    """Sequential single-engine reference streams (one fresh engine so
    cache state can't leak between the oracle and the cluster).
    ``samplings`` — optional per-prompt sampling dicts ({} = greedy),
    so sampled-decode legs verify against the same counter-based RNG."""
    from ..serving import SamplingParams

    eng = _engine_factory(args)()
    samplings = samplings or [{}] * len(prompts)
    return [
        eng.generate(p, args.new_tokens,
                     sampling=SamplingParams(**s) if s else None)
        for p, s in zip(prompts, samplings)
    ]


def _request_samplings(args, n: int) -> List[dict]:
    """Per-request sampling policies: greedy everywhere, except
    ``--sampled`` makes every odd request temperature/top-k sampled —
    so one sweep exercises BOTH decode paths and ``--verify`` proves
    each against the oracle's identical counter-based RNG."""
    if not args.sampled:
        return [{}] * n
    return [
        {} if i % 2 == 0
        else {"temperature": 0.8, "top_k": 8, "seed": 1000 + i}
        for i in range(n)
    ]


def _parse_slo(text: Optional[str]):
    """``"queue=2.0,decode=1.0"`` → SLOConfig, None when unset."""
    if not text:
        return None
    from ..observability.tracing import SLOConfig

    targets = {}
    for item in text.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise SystemExit(
                f"--slo expects stage=seconds, got {item!r}"
            )
        k, v = item.split("=", 1)
        targets[k.strip()] = float(v)
    return SLOConfig(targets=targets)


def _install_tracer(args, reporter=None, slo=None):
    """Install a process-wide tracer when --trace-out/--flight-dir asks
    for one (or an SLO config needs burn-rate gauges).  Returns
    (tracer, uninstall_cb); (None, noop) untraced."""
    import os

    from ..observability import tracing

    if not (args.trace_out or args.flight_dir or slo is not None):
        return None, lambda: None
    flight = None
    if args.flight_dir:
        os.makedirs(args.flight_dir, exist_ok=True)
        flight = tracing.FlightRecorder(
            os.path.join(args.flight_dir, "flight_local.jsonl")
        )
    tr = tracing.Tracer(flight=flight, reporter=reporter, slo=slo)
    tracing.install(tr)

    def done():
        tracing.uninstall(tr)
        tr.close()

    return tr, done


def _stage_table(recs) -> dict:
    from ..observability import tracing

    return {
        name: {"count": st["count"], "p50_s": st["p50_s"],
               "p99_s": st["p99_s"]}
        for name, st in sorted(tracing.stage_percentiles(recs).items())
    }


def _export_trace(args, tr, extra: dict) -> None:
    """Write the Chrome trace to --trace-out and fold per-stage
    percentiles into the report."""
    from ..observability import tracing

    recs = tr.records()
    if args.trace_out:
        with open(args.trace_out, "w") as f:
            json.dump(tracing.to_chrome_trace(recs), f)
    extra["trace_stages"] = _stage_table(recs)
    extra["traces"] = len({
        r.get("trace") for r in recs if r.get("trace")
    })


def run_local_traffic(args) -> int:
    """``--traffic`` mode: replay a seeded heavy-tailed workload over
    the fleet, optionally with the SLO-guarded autoscaler closing the
    loop (``--autoscale``) and timed chaos faults (``--chaos``)."""
    from ..elastic.chaos import ChaosSchedule, TimedChaos
    from ..observability.reporter import Reporter
    from ..serving import workload
    from ..serving.cluster import (
        Autoscaler,
        AutoscalerConfig,
        HeartbeatMonitor,
        Replica,
        ReplicaRouter,
        ThreadedClusterDriver,
    )

    factory = _engine_factory(args)
    roles = _parse_roles(args.roles, args.replicas)
    reporter = Reporter()
    tr, tr_done = _install_tracer(
        args, reporter=reporter, slo=_parse_slo(args.slo)
    )
    spec = workload.TrafficSpec.parse(args.traffic)
    if spec.vocab >= args.vocab:
        raise SystemExit(
            f"--traffic vocab={spec.vocab} must stay below the model's "
            f"--vocab {args.vocab}"
        )

    def replica_factory(rid):
        return Replica(
            rid, factory(), role="both", reporter=reporter,
            watermark_blocks=args.watermark, max_queue=args.max_queue,
            spec_tokens=args.spec_tokens,
        )

    replicas = [
        Replica(
            i, factory(), role=roles[i], reporter=reporter,
            watermark_blocks=args.watermark, max_queue=args.max_queue,
            spec_tokens=args.spec_tokens,
        )
        for i in range(args.replicas)
    ]
    router = ReplicaRouter(
        replicas,
        prefill_threshold=args.prefill_threshold,
        reporter=reporter,
        health=HeartbeatMonitor(
            [r.replica_id for r in replicas], miss_after_s=30.0
        ),
    )
    autoscaler = None
    if args.autoscale:
        autoscaler = Autoscaler(
            router, replica_factory,
            AutoscalerConfig(
                min_replicas=args.replicas,
                max_replicas=args.max_replicas or args.replicas + 2,
            ),
            reporter=reporter,
        )
    exporter = _start_exporter(args, router.fleet_view)
    chaos = None
    if args.chaos:
        chaos = TimedChaos(ChaosSchedule.parse(args.chaos))

    arrivals = workload.generate(spec)

    def fire(fault) -> None:
        rid = fault.replica
        if rid is None:
            alive = [r.replica_id for r in router.replicas.values()
                     if r.alive]
            rid = alive[0] if alive else None
        if rid is None or rid not in router.replicas:
            return
        if fault.kind == "kill":
            router.fail_replica(rid, reason="chaos kill")
        elif fault.kind == "term":
            router.drain(rid)

    t0 = time.perf_counter()
    with ThreadedClusterDriver(router) as drv:
        def pump():
            drv.ensure_threads()
            router.step(drive_replicas=False)
            if autoscaler is not None:
                autoscaler.step()
            if chaos is not None:
                for f in chaos.due():
                    fire(f)

        report = workload.replay(
            arrivals,
            lambda a: router.submit(
                list(a.prompt), a.max_new_tokens,
                timeout_s=args.timeout_s, priority=a.priority,
                tenant=a.tenant,
            ),
            pump=pump, drain_timeout_s=args.timeout_s,
        )
        drv.run_until_idle(timeout_s=args.timeout_s)
    wall = time.perf_counter() - t0

    traffic = workload.summarize(report)
    traffic["spec"] = spec.format()
    if autoscaler is not None:
        traffic["autoscaler_events"] = [
            {k: (round(v, 3) if isinstance(v, float) else v)
             for k, v in ev.items() if k != "t"}
            for ev in autoscaler.events
        ]
        traffic["replicas_final"] = len(router.replicas)
    gauges = reporter.summary().get("gauges", {})
    traffic["burn_rates"] = {
        k.split("/", 2)[2]: round(float(v["value"]), 4)
        for k, v in gauges.items()
        if k.startswith("slo/burn_rate/")
    }
    counters = reporter.summary().get("counters", {})
    traffic["shed_counters"] = {
        k: v for k, v in sorted(counters.items())
        if k.startswith(("serve/shed/", "serve/admit/",
                         "serve/rejected/"))
    }

    finished = [o for o in report.outcomes if o.finished]
    results = {
        o.arrival.index: {
            "tokens": list(o.handle.tokens), "status": o.handle.status,
            "failovers": o.handle.failovers,
        }
        for o in report.outcomes if o.handle is not None
    }
    extra = {"roles": roles, "traffic": traffic}
    if args.verify:
        eng = _engine_factory(args)()
        mismatches = [
            o.arrival.index for o in finished
            if list(o.handle.tokens) != eng.generate(
                list(o.arrival.prompt), o.arrival.max_new_tokens
            )
        ]
        extra["parity"] = "ok" if not mismatches else "FAIL"
        extra["parity_mismatches"] = mismatches
    if tr is not None:
        _export_trace(args, tr, extra)
    tr_done()
    if exporter is not None:
        extra["metrics_url"] = exporter.url
        exporter.stop()
    print(json.dumps(_report(args, results, wall, extra)))
    if args.verify and extra["parity"] != "ok":
        return 1
    return 0


def run_local(args) -> int:
    from ..observability.reporter import Reporter
    from ..serving.cluster import (
        HeartbeatMonitor,
        Replica,
        ReplicaRouter,
        ThreadedClusterDriver,
    )

    tr, tr_done = _install_tracer(args)
    factory = _engine_factory(args)
    roles = _parse_roles(args.roles, args.replicas)
    # A metrics endpoint needs a registry to serve: one shared Reporter
    # across replicas + router (in-process, so the shared registry IS
    # the fleet view).
    reporter = Reporter() if args.metrics_port is not None else None
    replicas = [
        Replica(
            i, factory(), role=roles[i], reporter=reporter,
            watermark_blocks=args.watermark, max_queue=args.max_queue,
            spec_tokens=args.spec_tokens,
        )
        for i in range(args.replicas)
    ]
    router = ReplicaRouter(
        replicas,
        prefill_threshold=args.prefill_threshold,
        reporter=reporter,
        health=HeartbeatMonitor(
            [r.replica_id for r in replicas], miss_after_s=30.0
        ),
    )
    exporter = _start_exporter(args, router.fleet_view)
    prompts = _synthetic_prompts(args)

    t0 = time.perf_counter()
    with ThreadedClusterDriver(router) as drv:
        handles = [
            router.submit(p, args.new_tokens, timeout_s=args.timeout_s)
            for p in prompts
        ]
        drv.run_until_idle(timeout_s=args.timeout_s)
    wall = time.perf_counter() - t0

    results = {
        h.request_id: {
            "tokens": list(h.tokens), "status": h.status,
            "failovers": h.failovers,
        }
        for h in handles
    }
    extra = {
        "roles": roles,
        "replicas_used": sorted(
            {repr(h.replica_id) for h in handles
             if h.replica_id is not None}
        ),
    }
    if args.verify:
        oracle = _oracle_streams(args, prompts)
        mismatches = [
            i for i, (h, o) in enumerate(zip(handles, oracle))
            if h.tokens != o
        ]
        extra["parity"] = "ok" if not mismatches else "FAIL"
        extra["parity_mismatches"] = mismatches
    if tr is not None:
        _export_trace(args, tr, extra)
    tr_done()
    if exporter is not None:
        extra["metrics_url"] = exporter.url
        exporter.stop()
    print(json.dumps(_report(args, results, wall, extra)))
    if args.verify and extra["parity"] != "ok":
        return 1
    if any(r["status"] != "finished" for r in results.values()):
        return 1
    return 0


def _start_exporter(args, source):
    """Start a /metrics scrape endpoint over ``source`` when
    --metrics-port asks for one.  Returns the running exporter or
    None."""
    if args.metrics_port is None:
        return None
    from ..observability import MetricsExporter

    exporter = MetricsExporter(source, port=args.metrics_port)
    exporter.start()
    return exporter


def _init_distributed(args):
    """Install this process's transport store (the reference joins a
    ``jax.distributed`` coordinator here): a ``TCPStore`` master on
    process 0, the router, which never waits for a replica that is slow
    to start, and a client on every other process.  Returns the store;
    the master's ``port`` is the bound one (``--coordinator host:0``
    binds an ephemeral port)."""
    import datetime

    import torch.distributed as dist

    from ..communicators import kvtransport

    if not args.coordinator:
        raise SystemExit(
            "--role router/replica needs --coordinator host:port"
        )
    host, _, port = args.coordinator.rpartition(":")
    master = args.process_id == 0
    store = dist.TCPStore(
        host, int(port), args.num_processes, master,
        timeout=datetime.timedelta(seconds=max(60.0, args.timeout_s)),
        wait_for_workers=False,
    )
    kvtransport.install(store)
    return store


def _flight_path(args) -> Optional[str]:
    import os

    if not args.flight_dir:
        return None
    os.makedirs(args.flight_dir, exist_ok=True)
    name = ("flight_router.jsonl" if args.role == "router"
            else f"flight_{args.process_id}.jsonl")
    return os.path.join(args.flight_dir, name)


def _latency(results: dict) -> dict:
    """TTFT (traffic start to the first token) and per-token gaps over
    every request's router-side token arrival times, in seconds."""
    from ..observability.tracing import percentile

    ttft, gaps = [], []
    for r in results.values():
        ts = r.get("token_times") or []
        if ts:
            ttft.append(ts[0])
            gaps.extend(b - a for a, b in zip(ts, ts[1:]))
    return {
        "ttft_p50_s": percentile(ttft, 50), "ttft_p99_s": percentile(ttft, 99),
        "per_token_p50_s": percentile(gaps, 50),
        "per_token_p99_s": percentile(gaps, 99),
    }


def run_multiprocess(args) -> int:
    from ..communicators import kvtransport
    from ..serving.cluster import service
    from ..serving.cluster.shard_group import plan_groups

    if not kvtransport.available():
        _init_distributed(args)
    size = args.num_processes
    # Shard-group topology (identity when --tp/--pp are 1): replica
    # ranks partition into consecutive leader+followers runs; the
    # router only ever talks to leaders.
    groups = plan_groups(size, args.tp, args.pp)
    if args.role == "replica":
        group = None
        if args.tp * args.pp > 1:
            group = next(
                g for g in groups if args.process_id in g.ranks
            )
        role = (args.replica_role or "both")
        built: list = []
        out = service.run_replica(
            args.process_id, size, _engine_factory(args, built),
            role=role, max_queue=args.max_queue,
            watermark_blocks=args.watermark,
            flight_path=_flight_path(args),
            metrics_port=args.metrics_port,
            group=group,
        )
        print(json.dumps({"mode": "replica", "rank": args.process_id,
                          **module_info(built), **out,
                          **cuda_memory(args.device)}), flush=True)
        return 0

    if args.process_id != 0:
        raise SystemExit("--role router must be --process-id 0")
    args.replicas = len(groups)
    prompts = _synthetic_prompts(args)
    samplings = _request_samplings(args, len(prompts))
    requests = [
        {"prompt": p, "max_new_tokens": args.new_tokens,
         "timeout_s": args.timeout_s, "sampling": s}
        for p, s in zip(prompts, samplings)
    ]
    stats: dict = {}
    t0 = time.perf_counter()
    results = service.run_router(
        size, requests,
        prefill_threshold=args.prefill_threshold,
        # Start-up stalls a replica for seconds (the module's build and
        # move to the card); real deaths are detected much faster via
        # socket EOF -> PeerGone.
        miss_after_s=args.miss_after_s,
        timeout_s=args.timeout_s,
        flight_path=_flight_path(args),
        metrics_port=args.metrics_port,
        metrics_port_file=args.metrics_port_file,
        group_size=args.tp,
        pp_stages=args.pp,
        wait_ready=args.warm_start,
        stats=stats,
    )
    wall = time.perf_counter() - t0
    extra = {"latency": _latency(results), "wall_s": wall,
             "serve_wall_s": stats["serve_wall_s"],
             "ready_s": stats["ready_s"]}
    if args.warm_start:
        # Tokens over the time from the traffic's release (every replica
        # warm) to its last token.
        tokens = sum(len(r["tokens"]) for r in results.values())
        extra["serve_tokens_per_sec"] = (
            round(tokens / stats["serve_wall_s"], 1)
            if stats["serve_wall_s"] > 0 else None)
    if args.trace_out and args.flight_dir:
        # Stitch every process's flight log (shared filesystem) into
        # one Chrome trace — works after crashes too, that's the point.
        import os

        from ..observability import tracing

        recs = tracing.read_flight_dir(
            os.path.join(args.flight_dir, "flight_*.jsonl")
        )
        with open(args.trace_out, "w") as f:
            json.dump(tracing.to_chrome_trace(recs), f)
        extra["trace_stages"] = _stage_table(recs)
    if args.verify:
        oracle = _oracle_streams(args, prompts, samplings)
        mismatches = [
            g for g, o in enumerate(oracle)
            if results[g]["tokens"] != o
        ]
        extra["parity"] = "ok" if not mismatches else "FAIL"
        extra["parity_mismatches"] = mismatches
        extra["parity_sampled"] = sum(1 for s in samplings if s)
        # What a reader needs to explain a divergence: both streams.
        extra["parity_streams"] = {
            g: {"fleet": results[g]["tokens"], "oracle": oracle[g],
                "prompt": prompts[g], "sampling": samplings[g]}
            for g in mismatches
        }
    if args.tp * args.pp > 1:
        extra["tp"] = args.tp
        extra["pp"] = args.pp
        extra["groups"] = len(groups)
    extra.update(cuda_memory(args.device))
    print(json.dumps(_report(args, results, wall, extra)), flush=True)
    if extra.get("parity") == "FAIL":
        return 1
    if any(r["status"] != "finished" for r in results.values()):
        return 1
    return 0


#: seconds each replica process gets to exit after the router stops,
#: before it is killed.
CHILD_EXIT_S = 60.0


def run_shard_groups(args) -> int:
    """``--tp K [--pp S] [--groups G]`` local launcher: spawn the whole
    fleet from one shell — this process becomes the router (process 0,
    the store's master on an ephemeral port), plus ``G x K x S`` replica
    shard processes as its children (``subprocess``, never ``fork``: a
    process that touched CUDA cannot fork).  ``--verify`` turns on the
    sampled request legs too, so parity covers greedy AND
    temperature/top-k decoding.  The report gains each child's exit code
    and its own JSON line (its weights' crc32 among them)."""
    import os
    import subprocess
    import threading

    if args.verify:
        args.sampled = True
    size = 1 + args.groups * args.tp * args.pp
    args.role = "router"
    args.num_processes = size
    args.process_id = 0
    args.coordinator = "127.0.0.1:0"
    store = _init_distributed(args)
    coord = f"127.0.0.1:{store.port}"
    args.coordinator = coord
    forward = [
        "--tp", str(args.tp), "--pp", str(args.pp),
        "--vocab", str(args.vocab), "--d-model", str(args.d_model),
        "--heads", str(args.heads), "--d-ff", str(args.d_ff),
        "--layers", str(args.layers), "--max-len", str(args.max_len),
        "--block-size", str(args.block_size),
        "--n-blocks", str(args.n_blocks),
        "--max-batch", str(args.max_batch),
        "--max-queue", str(args.max_queue),
        "--seed", str(args.seed),
        "--spec-tokens", str(args.spec_tokens),
        "--timeout-s", str(args.timeout_s),
        "--device", args.device,
    ]
    if args.prefill_chunk is not None:
        forward += ["--prefill-chunk", str(args.prefill_chunk)]
    if args.watermark is not None:
        forward += ["--watermark", str(args.watermark)]
    if not args.max_len_growth:
        forward += ["--no-max-len-growth"]
    if args.warm_start:
        forward += ["--warm-start"]
    if args.flight_dir:
        forward += ["--flight-dir", args.flight_dir]
    procs, outs, readers = [], {}, []

    def drain(pid, stream):
        lines = stream.read().splitlines()
        outs[pid] = lines[-1] if lines else ""

    rc = 1
    try:
        for pid in range(1, size):
            p = subprocess.Popen(
                [sys.executable, "-m", "chainermn_tpu_torch.tools.serve",
                 "--role", "replica", "--coordinator", coord,
                 "--num-processes", str(size), "--process-id", str(pid),
                 ] + forward,
                stdout=subprocess.PIPE, text=True,  # one JSON report: ours
                env=dict(os.environ),
            )
            procs.append(p)
            t = threading.Thread(target=drain, args=(pid, p.stdout),
                                 daemon=True)
            t.start()
            readers.append(t)
        rc = run_multiprocess(args)
    finally:
        deadline = time.perf_counter() + CHILD_EXIT_S
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for t in readers:
            t.join(timeout=5.0)
    children = []
    for pid, p in enumerate(procs, start=1):
        try:
            rep = json.loads(outs.get(pid) or "null")
        except ValueError:
            rep = None
        children.append({"rank": pid, "returncode": p.returncode,
                         "report": rep})
    print(json.dumps({"mode": "launcher", "processes": children}),
          flush=True)
    crcs = {c["report"].get("weights_crc32") for c in children
            if c["report"]}
    if rc == 0 and len(crcs) > 1:
        return 1
    return rc


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m chainermn_tpu_torch.tools.serve",
        description="Run the multi-replica serving tier on synthetic "
                    "traffic (in-process or one process per role).",
    )
    ap.add_argument("--role", choices=["local", "router", "replica"],
                    default="local")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (default cuda; "
                         "without a card every role refuses to start "
                         "unless given 'cpu')")
    ap.add_argument("--replicas", type=int, default=2,
                    help="replica count for --role local")
    ap.add_argument("--roles", default=None,
                    help="comma-separated per-replica roles for --role "
                         "local (prefill|decode|both; default all both)")
    ap.add_argument("--replica-role", default=None,
                    choices=["prefill", "decode", "both"],
                    help="this process's role for --role replica")
    ap.add_argument("--prefill-threshold", type=int, default=None,
                    help="prompts at least this long go to a "
                         "prefill-role replica first (disaggregation)")
    ap.add_argument("--watermark", type=int, default=None,
                    help="free-page admission watermark per replica")
    ap.add_argument("--draft", choices=["ngram", "model"], default=None,
                    help="speculative draft source (with --spec-tokens):"
                         " n-gram prompt lookup or the layer-truncated "
                         "self-draft model (default: engine resolution "
                         "— env, then ngram)")
    ap.add_argument("--draft-layers", type=int, default=None,
                    help="self-draft depth (--draft model; default: "
                         "half the target's layers)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill slice size in tokens (0 = "
                         "monolithic prefill; prompts longer than the "
                         "slice prefill incrementally between decode "
                         "steps — either way, --verify proves streams)")
    ap.add_argument("--sp", type=int, default=0,
                    help="sequence-shard chunked prefill over this many "
                         "ranks (power of two; 0 disables)")
    ap.add_argument("--max-len-growth",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="let each replica's context-bucket ladder grow "
                         "lazily past its seed buckets; "
                         "--no-max-len-growth pins the seed ladder")
    ap.add_argument("--spec-tokens", type=int, default=0,
                    help="speculative draft length per decode step "
                         "(0 disables; streams are identical either "
                         "way, --verify proves it)")
    ap.add_argument("--tp", type=int, default=1,
                    help="shard-group width: each replica becomes a "
                         "leader + tp-1 follower shard processes in "
                         "lockstep (--role local spawns the whole "
                         "cluster; router/replica roles must all agree "
                         "on --tp/--pp)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages per shard group: decode "
                         "batches split into per-stage microbatches "
                         "(group spans tp*pp processes)")
    ap.add_argument("--groups", type=int, default=1,
                    help="shard-group count for the local launcher "
                         "(total processes = 1 + groups*tp*pp)")
    ap.add_argument("--sampled", action="store_true",
                    help="make every odd request temperature/top-k "
                         "sampled instead of greedy (multi-process "
                         "roles; the launcher's --verify implies it) so "
                         "parity covers both decode paths")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="bounded frontend queue size per replica")
    ap.add_argument("--verify", action="store_true",
                    help="replay through a sequential oracle and fail "
                         "unless streams are identical")
    ap.add_argument("--warm-start", action="store_true",
                    help="multi-process: each replica serves one short "
                         "request before its first load beat, and the "
                         "router holds the traffic until every replica "
                         "has reported one (latencies exclude start-up)")
    ap.add_argument("--timeout-s", type=float, default=120.0)
    ap.add_argument("--miss-after-s", type=float, default=30.0,
                    help="multi-process router: declare a replica dead "
                         "after this long without a heartbeat (generous "
                         "default covers the module's build; real deaths "
                         "surface faster via socket EOF)")
    # autoscaling + generated traffic (local role only)
    ap.add_argument("--traffic", default=None, metavar="SPEC",
                    help="replay a seeded heavy-tailed workload instead "
                         "of the fixed prompt sweep; SPEC is "
                         "'key=value,...' (or 'default'), see "
                         "serving.workload.TrafficSpec")
    ap.add_argument("--autoscale", action="store_true",
                    help="run the SLO-guarded autoscaler during "
                         "--traffic replay: spawn on pressure, "
                         "drain+migrate+retire on idleness")
    ap.add_argument("--max-replicas", type=int, default=None,
                    help="autoscaler ceiling (default: --replicas + 2)")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="timed fault schedule for --traffic, e.g. "
                         "'kill:replica=1:at=0.5' (seconds since "
                         "replay start; see elastic.chaos)")
    ap.add_argument("--slo", default=None, metavar="TARGETS",
                    help="per-stage latency targets 'stage=seconds,...' "
                         "(e.g. 'queue=5,decode=2'); installs a tracer "
                         "so slo/burn_rate/<stage> gauges populate")
    # observability
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace JSON of every "
                         "request's span tree to this path")
    ap.add_argument("--flight-dir", default=None,
                    help="directory for crash-surviving flight-recorder "
                         "logs (one JSONL per process; enables tracing)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve a Prometheus /metrics scrape endpoint "
                         "on this port (0 = ephemeral).  Local roles "
                         "export the fleet view; --role router the "
                         "heartbeat-merged fleet view; --role replica "
                         "its own registry")
    ap.add_argument("--metrics-port-file", default=None,
                    help="write the bound metrics port to this file "
                         "(--role router; implies an ephemeral port "
                         "when --metrics-port is unset)")
    # traffic
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12,
                    help="max synthetic prompt length (min is half)")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    # model geometry
    ap.add_argument("--vocab", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=32)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--d-ff", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=128)
    # engine
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--n-blocks", type=int, default=128)
    ap.add_argument("--max-batch", type=int, default=4)
    # multi-process wiring
    ap.add_argument("--coordinator", default=None,
                    help="the transport store's host:port (process 0 "
                         "binds it)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    return ap


def main(argv=None) -> int:
    from .._device import resolve_device

    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: refuse
    if args.tp < 1 or args.pp < 1 or args.groups < 1:
        raise SystemExit("--tp/--pp/--groups must be >= 1")
    if args.role == "local":
        if args.tp * args.pp > 1 or args.groups > 1:
            return run_shard_groups(args)
        if args.traffic:
            return run_local_traffic(args)
        return run_local(args)
    return run_multiprocess(args)


if __name__ == "__main__":
    sys.exit(main())
