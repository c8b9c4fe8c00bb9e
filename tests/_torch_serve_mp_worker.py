"""One process of a multi-process serving fleet of the port, for
``tests/test_torch_serving_service.py`` (imports no JAX).

Run as::

    python _torch_serve_mp_worker.py <pid> <nproc> <port> <kill_after> \\
        <mode> <weights.pt> <outdir>

Process 0 runs :func:`service.run_router` and holds the fleet's
``TCPStore`` master (``tools.serve._init_distributed``); every other
process runs :func:`service.run_replica` over a store client.  Every
process builds the tiny fp32 ``TransformerLM`` of the test (vocab 32,
d_model 16, 2 heads, 2 layers) on the CPU and loads ``weights.pt`` (the
reference's init, converted by the test), so the streams can be held to
the reference engine's.

Modes:

* ``plain`` — router + replicas; with ``kill_after > 0`` the highest rank
  SIGKILLs itself after streaming that many tokens;
* ``flight`` — the same, every process recording to
  ``<outdir>/flight_<pid>.jsonl`` for the postmortem;
* ``tpgroup`` — two shard groups of 2 (leaders 1 and 3, followers 2 and
  4); with ``kill_after > 0`` follower rank 2 SIGKILLs itself after
  replaying that many mirrored steps;
* ``traffic`` — the reference's seeded heavy-tailed workload under an
  SLO-wired tracer (targets: request 120 s, placement 60 s); the highest
  rank dies at ``kill_after`` tokens; the router reports its burn rates;
* ``gossip`` — router + 3 replicas with the model draft (2 tokens),
  chunked prefill (8) and queues of 2; rank 1 (the cold-start favourite,
  owner of the template request) dies at ``kill_after`` tokens, and wave
  2's template-prefixed prompts must route, through the gossiped digests
  alone, to the survivor that re-prefilled the template;
* ``longctx`` — a 40-token document prefilled in chunks of 4 and a
  follower gated on 6 gossiped pages of it, which must route to the
  replica still prefilling it;
* ``metrics`` — requests carry tenants, the router serves its fleet view
  at ``/metrics`` (port in ``<outdir>/router_metrics_port``), holds the
  traffic until both replicas have beaten (so each one's series are in
  the view first), and a thread of the router scrapes it every 0.02 s
  into ``<outdir>/scrapes.json``.

``python _torch_serve_mp_worker.py card <pid> <nproc> <port>
<kill_after> -- <tools.serve flags>`` is one replica process of the
four-card fleet of ``tests/test_torch_nccl_cuda.py``: the CLI's own store
client and engine factory at the given flags (on the card its
``CUDA_VISIBLE_DEVICES`` names), SIGKILLed after ``kill_after`` streamed
tokens when that is above 0; it prints one JSON line.

Every process logs each frame it sends or receives on the serving plane
(tag, the frame's op or kind, its keys or arity) to
``<outdir>/frames_<pid>.jsonl``.  The router prints ``SERVE_RESULTS
<json>``; a replica that stops prints ``SERVE_REPLICA_OK <pid>
<reason>``.  A killed process's output is its -9 exit status.
"""

import json
import os
import sys
import threading
import time
import types


def prompts_and_news(mode="plain"):
    """The reference soak's traffic of ``mode`` (``_mp_serve_worker.py``):
    (prompts, max new tokens, extra request fields by index)."""
    import numpy as np

    if mode == "traffic":
        from chainermn_tpu_torch.serving import TrafficSpec, workload

        arrivals = workload.generate(TrafficSpec(
            seed=5, requests=10, rate=200.0, burst=6.0, p_burst=0.3,
            prefix_len=8, templates=4,
            prompt_buckets=((4, 12, 0.7), (14, 20, 0.3)),
            output_buckets=((4, 8, 0.8), (10, 12, 0.2)), vocab=32))
        return ([list(a.prompt) for a in arrivals],
                [a.max_new_tokens for a in arrivals], {})
    if mode == "gossip":
        # Wave 1: a 3-page template prompt and five decoys; wave 2: two
        # template-prefixed prompts held until wave 1 is done.
        rng = np.random.default_rng(29)
        template = [int(t) for t in rng.integers(0, 32, size=12)]
        prompts = [template] + [
            [int(t) for t in rng.integers(0, 32, size=int(n))]
            for n in rng.integers(4, 11, size=5)]
        prompts += [template + [int(t) for t in rng.integers(0, 32, size=6)]
                    for _ in range(2)]
        return prompts, [8] * 6 + [6, 6], {
            6: {"after_gids": list(range(6))},
            7: {"after_gids": list(range(6))}}
    if mode == "longctx":
        # One 10-page document and one follower sharing it, released by
        # the gossiped partial prefix while the document still prefills.
        rng = np.random.default_rng(31)
        doc = [int(t) for t in rng.integers(0, 32, size=40)]
        return ([list(doc),
                 doc + [int(t) for t in rng.integers(0, 32, size=4)]],
                [6, 5], {1: {"after_index_pages": 6}})
    rng = np.random.default_rng(13)
    prompts = [
        [int(t) for t in rng.integers(0, 32, size=int(n))]
        for n in rng.integers(4, 11, size=6)
    ]
    # Half the traffic shares a 2-page prefix: the kill lands while
    # refcounted, index-registered pages are live in both pools.
    shared = [int(t) for t in rng.integers(0, 32, size=8)]
    prompts = [shared + p if i % 2 == 0 else p
               for i, p in enumerate(prompts)]
    return prompts, [8] * len(prompts), {}


def _log_frames(path):
    """Wrap the ObjectPlane's send/recv so every serving-plane frame's
    shape lands in ``path``."""
    from chainermn_tpu_torch.communicators import kvtransport

    lock = threading.Lock()

    def shape(obj, tag):
        if isinstance(obj, dict):
            return [{"tag": tag, "op": obj.get("op"),
                     "keys": sorted(obj)}]
        if tag == 2 and isinstance(obj, list):  # EVT: a list of events
            return [{"tag": tag, "kind": ev[0], "arity": len(ev)}
                    for ev in obj]
        if isinstance(obj, tuple) and obj and isinstance(obj[0], str):
            return [{"tag": tag, "kind": obj[0], "arity": len(obj)}]
        return []

    def write(rows):
        if rows:
            with lock, open(path, "a") as f:
                for r in rows:
                    f.write(json.dumps(r) + "\n")

    send, recv = kvtransport.ObjectPlane.send, kvtransport.ObjectPlane.recv

    def logged_send(self, obj, dest, tag=0):
        send(self, obj, dest, tag=tag)
        write(shape(obj, tag))

    def logged_recv(self, source, tag=0, *, timeout_ms=None):
        obj = recv(self, source, tag=tag, timeout_ms=timeout_ms)
        write(shape(obj, tag))
        return obj

    kvtransport.ObjectPlane.send = logged_send
    kvtransport.ObjectPlane.recv = logged_recv


def card_replica(argv):
    from chainermn_tpu_torch.serving.cluster import service
    from chainermn_tpu_torch.tools import serve

    pid, nproc, port, kill_after = (int(a) for a in argv[:4])
    args = serve.build_parser().parse_args(
        argv[argv.index("--") + 1:] + [
            "--role", "replica", "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", str(nproc), "--process-id", str(pid)])
    serve._init_distributed(args)
    built = []
    out = service.run_replica(
        pid, nproc, serve._engine_factory(args, built),
        max_queue=args.max_queue,
        kill_after_tokens=kill_after if kill_after > 0 else None)
    print(json.dumps({"rank": pid, **serve.module_info(built), **out}),
          flush=True)
    return 0


def main():
    if sys.argv[1] == "card":
        return card_replica(sys.argv[2:])
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    kill_after, mode = int(sys.argv[4]), sys.argv[5]
    weights, outdir = sys.argv[6], sys.argv[7]

    import torch

    torch.set_num_threads(1)
    from chainermn_tpu_torch.models.transformer import TransformerLM
    from chainermn_tpu_torch.serving import EngineConfig, InferenceEngine
    from chainermn_tpu_torch.serving.cluster import service
    from chainermn_tpu_torch.tools import serve

    serve._init_distributed(types.SimpleNamespace(
        coordinator=f"127.0.0.1:{port}", process_id=pid,
        num_processes=nproc, timeout_s=120.0))
    _log_frames(os.path.join(outdir, f"frames_{pid}.jsonl"))
    flight_path = (os.path.join(outdir, f"flight_{pid}.jsonl")
                   if mode == "flight" else None)

    extra_cfg = {"gossip": {"draft": "model", "prefill_chunk": 8},
                 "longctx": {"prefill_chunk": 4}}.get(mode, {})
    lm = []

    def engine_factory():
        if not lm:
            m = TransformerLM(vocab=32, d_model=16, n_heads=2, d_ff=32,
                              n_layers=2, max_len=64, dtype=torch.float32,
                              device="cpu")
            m.load_state_dict(torch.load(weights))
            m.requires_grad_(False)
            lm.append(m)
        return InferenceEngine(lm[0], EngineConfig(
            block_size=4, n_blocks=64, max_len=64, max_batch=2,
            **extra_cfg), device="cpu")

    prompts, news, extras = prompts_and_news(mode)
    if pid == 0:
        requests = [dict({"prompt": p, "max_new_tokens": n},
                         **extras.get(g, {}))
                    for g, (p, n) in enumerate(zip(prompts, news))]
        metrics_port_file = scraper = None
        reporter = slo = None
        if mode == "traffic":
            from chainermn_tpu_torch.observability import Reporter
            from chainermn_tpu_torch.observability.tracing import SLOConfig

            reporter = Reporter()
            slo = SLOConfig(targets={"request": 120.0, "placement": 60.0})
        scrapes, stop = [], threading.Event()
        if mode == "metrics":
            import urllib.request

            for gid, r in enumerate(requests):
                r["tenant"] = f"t{gid % 2}"
            metrics_port_file = os.path.join(outdir, "router_metrics_port")

            def scrape_loop():
                while not os.path.exists(metrics_port_file):
                    if stop.wait(0.05):
                        return
                with open(metrics_port_file) as f:
                    url = f"http://127.0.0.1:{int(f.read())}/metrics"
                while not stop.is_set():
                    try:
                        with urllib.request.urlopen(url, timeout=5) as rs:
                            scrapes.append(rs.read().decode())
                    except OSError:
                        pass
                    time.sleep(0.02)

            scraper = threading.Thread(target=scrape_loop, daemon=True)
            scraper.start()
        stats = {}
        results = service.run_router(
            nproc, requests, miss_after_s=30.0, timeout_s=120.0,
            flight_path=(os.path.join(outdir, "flight_router.jsonl")
                         if mode == "flight" else None),
            metrics_port_file=metrics_port_file,
            group_size=2 if mode == "tpgroup" else 1,
            wait_ready=mode == "metrics", stats=stats,
            reporter=reporter, slo=slo,
        )
        if scraper is not None:
            stop.set()
            scraper.join(timeout=10)
            with open(os.path.join(outdir, "scrapes.json"), "w") as f:
                json.dump(scrapes, f)
        out = {str(g): {k: v for k, v in r.items() if k != "token_times"}
               for g, r in results.items()}
        burns = {} if reporter is None else {
            k.split("/", 2)[2]: g["value"]
            for k, g in reporter.summary()["gauges"].items()
            if k.startswith("slo/burn_rate/")}
        print("SERVE_RESULTS " + json.dumps(
            {"results": out, "prompts": prompts, "news": news,
             "stats": stats, "burns": burns}), flush=True)
        return 0

    if mode == "tpgroup":
        from chainermn_tpu_torch.serving.cluster.shard_group import (
            plan_groups)

        group = next(g for g in plan_groups(nproc, 2, 1) if pid in g.ranks)
        out = service.run_replica(
            pid, nproc, engine_factory, max_queue=3, group=group,
            kill_after_ops=(kill_after if kill_after > 0 and pid == 2
                            else None))
    else:
        doomed = kill_after > 0 and pid == (1 if mode == "gossip"
                                            else nproc - 1)
        out = service.run_replica(
            pid, nproc, engine_factory,
            max_queue=2 if mode == "gossip" else 3,
            kill_after_tokens=kill_after if doomed else None,
            flight_path=flight_path,
            spec_tokens=2 if mode == "gossip" else 0)
    print(f"SERVE_REPLICA_OK {pid} {out['reason']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
