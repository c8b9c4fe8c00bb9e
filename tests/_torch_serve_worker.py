"""Worker processes for the multi-rank serving tests of the port: the
tensor-parallel engine (``plan=``/``mesh=``), the sequence-parallel chunk
prefill (``EngineConfig.sp``) and the KV snapshot over the object plane.

Imports only torch, numpy and the port, so a spawned child never loads
JAX.  Each worker joins a ``file://`` rendezvous, runs one case, and
writes its result as JSON to ``<out_dir>/rank<r>.json``.  Weights come
from ``<out_dir>/init.npz`` (the reference's weights through
``convert.py``); prompts and sampling parameters come in ``args``.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch
import torch.distributed as dist

ENGINE = dict(block_size=4, n_blocks=32, max_len=32, max_batch=4)


def make_lm(init_path, cfg, dtype=torch.float32):
    from chainermn_tpu_torch.models.transformer import TransformerLM

    model = TransformerLM(**cfg, dtype=dtype, device="cpu")
    with np.load(init_path) as sd:
        model.load_state_dict({k: torch.from_numpy(sd[k]) for k in sd.files})
    return model


def _sampling(spec):
    from chainermn_tpu_torch.serving import SamplingParams

    return SamplingParams() if spec is None else SamplingParams(**spec)


def _teacher_forced(engine, prompt, stream):
    """fp32 logits of the prompt's last token and of each decode step fed
    ``stream`` (the same tokens on every engine)."""
    sid = ("tf", len(prompt))
    L = len(prompt)
    engine.kv.allocate(sid, L)
    try:
        rows = [engine.prefill(prompt, sid)]
        for i, tok in enumerate(stream[:-1]):
            engine.kv.extend(sid, L + i + 1)
            rows.append(engine.decode([tok], [sid], [L + i])[0])
        return np.stack(rows)
    finally:
        engine.kv.free(sid)


def _tp(rank, size, args, out_dir):
    """The TP engine on a 1-D ``model`` mesh of ``size`` ranks against a
    one-device engine on the same weights: streams (greedy and sampled),
    teacher-forced logits, the local page shapes, the model draft under
    the plan, and a decode batch split into pipeline microbatches."""
    from torch.distributed.device_mesh import init_device_mesh

    from chainermn_tpu_torch.serving import (ContinuousBatchingScheduler,
                                             EngineConfig, InferenceEngine,
                                             Request)

    init = os.path.join(out_dir, "init.npz")
    cfg = EngineConfig(**ENGINE)
    oracle = InferenceEngine(make_lm(init, args["lm"]), cfg, device="cpu")
    mesh = init_device_mesh("cpu", (size,), mesh_dim_names=("model",))
    tp = InferenceEngine(make_lm(init, args["lm"]), cfg, plan="tp",
                         mesh=mesh, device="cpu")
    res = {"k_pages_local": list(tp._cache[0].k_pages.to_local().shape),
           "k_pages_global": list(tp._cache[0].k_pages.shape),
           "streams": {}, "oracle": {}, "logits_rel": {}, "bitwise": {},
           "margins": {}}
    for name, spec in args["sampling"].items():
        sp = _sampling(spec)
        for j, prompt in enumerate(args["prompts"]):
            key = f"{name}/{j}"
            got = tp.generate(prompt, args["n_new"], sampling=sp)
            want = oracle.generate(prompt, args["n_new"], sampling=sp)
            res["streams"][key], res["oracle"][key] = got, want
            a = _teacher_forced(tp, prompt, want)
            b = _teacher_forced(oracle, prompt, want)
            res["bitwise"][key] = bool(np.array_equal(a, b))
            res["logits_rel"][key] = float(
                np.abs(a - b).max() / np.abs(b).max())
            top2 = np.sort(b, axis=-1)[:, -2:]
            res["margins"][key] = (top2[:, 1] - top2[:, 0]).tolist()
            res["tf_diff"] = max(res.get("tf_diff", 0.0),
                                 float(np.abs(a - b).max()))
    # A decode batch through the scheduler, in 2 pipeline microbatches.
    tp.pp_stages = 2
    sched = ContinuousBatchingScheduler(tp)
    for i, p in enumerate(args["prompts"]):
        sched.add_request(Request(request_id=i, prompt=list(p),
                                  max_new_tokens=args["n_new"]))
    out = sched.run_to_completion()
    res["batched"] = [out[i].generated for i in range(len(args["prompts"]))]
    # The truncated-model draft on the placed parameters.
    draft_cfg = EngineConfig(**ENGINE, draft="model", draft_layers=1)
    d_tp = InferenceEngine(make_lm(init, args["lm"]), draft_cfg, plan="tp",
                           mesh=mesh, device="cpu")
    d_one = InferenceEngine(make_lm(init, args["lm"]), draft_cfg,
                            device="cpu")
    ctx = args["prompts"][0]
    res["draft"] = [d_tp.propose_draft(ctx, 4), d_one.propose_draft(ctx, 4)]
    res["draft_placed"] = all(
        type(p).__name__ == "DTensor"
        for p in d_tp.draft_model.model.parameters())
    # int8 pages: the scales stay whole and equal on every rank.
    q_cfg = EngineConfig(**ENGINE, kv_dtype="int8")
    q_tp = InferenceEngine(make_lm(init, args["lm"]), q_cfg, plan="tp",
                           mesh=mesh, device="cpu")
    q_one = InferenceEngine(make_lm(init, args["lm"]), q_cfg, device="cpu")
    res["int8"] = [q_tp.generate(p, args["n_new"])
                   for p in args["prompts"]]
    res["int8_oracle"] = [q_one.generate(p, args["n_new"])
                          for p in args["prompts"]]
    sc = q_tp._cache[0].k_scales.to_local()
    res["int8_scales_sha"] = hashlib.sha256(sc.numpy().tobytes()).hexdigest()
    res["int8_scales_shape"] = list(sc.shape)
    res["int8_scales_diff"] = float(
        (sc - q_one._cache[0].k_scales).abs().max())
    res["int8_err"] = [q_tp.stats()["kv_quant_err"],
                       q_one.stats()["kv_quant_err"]]
    return res


def _sp(rank, size, args, out_dir):
    """``EngineConfig.sp`` on ``size`` ranks: the reference's SP traffic
    through the scheduler against the engine without SP, and one slice's
    pages against the unsharded chunk's, bitwise."""
    from chainermn_tpu_torch.serving import (ContinuousBatchingScheduler,
                                             EngineConfig, InferenceEngine,
                                             Request)

    init = os.path.join(out_dir, "init.npz")
    lm = make_lm(init, args["lm"])
    eng = dict(block_size=4, n_blocks=64, max_len=64, max_batch=4,
               prefill_chunk=8)

    def run(engine):
        sched = ContinuousBatchingScheduler(engine)
        for i, p in enumerate(args["prompts"]):
            sched.add_request(Request(
                request_id=i, prompt=list(p), max_new_tokens=5,
                sampling=_sampling(None if i % 2 else args["sampled"])))
        out = sched.run_to_completion()
        engine.kv.assert_consistent()
        return [out[i].generated for i in range(len(args["prompts"]))]

    plain = InferenceEngine(lm, EngineConfig(**eng), device="cpu")
    res = {"want": run(plain)}
    for sp in args["sps"]:
        if sp > size:
            continue
        e = InferenceEngine(lm, EngineConfig(**eng, sp=sp), device="cpu")
        st_before = e.stats()["decode_compiles"]
        res[f"sp{sp}"] = run(e)
        st = e.stats()
        res[f"stats{sp}"] = {"sp": st["sp"],
                             "sp_chunk_compiles": st["sp_chunk_compiles"],
                             "decode_compiles": st["decode_compiles"] -
                             st_before,
                             "used_blocks": e.kv.used_blocks,
                             "in_group": e._sp_comm is not None}
        # One 16-token slice written by both engines into fresh pages.
        a = InferenceEngine(lm, EngineConfig(**eng, sp=sp), device="cpu")
        b = InferenceEngine(lm, EngineConfig(**eng), device="cpu")
        doc = args["prompts"][-1][:16]
        la = lb = None
        for e2 in (a, b):
            e2.kv.allocate("d", len(doc))
        la = a.chunk([doc], ["d"], [0])
        lb = b.chunk([doc], ["d"], [0])
        res[f"pages{sp}"] = all(
            torch.equal(x, y)
            for ca, cb in zip(a._cache, b._cache)
            for x, y in zip(ca.leaves().values(), cb.leaves().values()))
        res[f"chunk_logits{sp}"] = float(np.abs(la - lb).max())
        res[f"sp_shapes{sp}"] = a.stats()["sp_chunk_compiles"]
        res[f"shared{sp}"] = (a._sp_comm is e._sp_comm and
                              a._sp_comm.group is e._sp_comm.group)
    return res


def _snapshot(rank, size, args, out_dir):
    """A running sequence's pages extracted on rank 0, sent over the
    port's object plane, restored on rank 1 and continued there: rank 1
    returns the continued stream and whether the restored pages equal
    the sent ones bitwise, for bf16, fp32 and int8 pages."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.serving import EngineConfig, InferenceEngine
    from chainermn_tpu_torch.serving.cluster import (extract_sequence,
                                                     recv_snapshot,
                                                     restore_sequence,
                                                     send_snapshot)

    comm = create_communicator("naive", device="cpu")
    init = os.path.join(out_dir, "init.npz")
    res = {}
    prompt, n_pre, n_post = args["prompt"], 3, 4
    for name, dtype, kv in (("fp32", torch.float32, None),
                            ("bf16", torch.bfloat16, None),
                            ("int8", torch.float32, "int8")):
        lm = make_lm(init, args["lm"], dtype)
        cfg = EngineConfig(**ENGINE, kv_dtype=kv)
        eng = InferenceEngine(lm, cfg, device="cpu")
        whole = eng.generate(prompt, n_pre + n_post)
        if rank == 0:
            eng.kv.allocate("s", len(prompt))
            logits = eng.prefill(prompt, "s")
            toks = [int(np.argmax(logits))]
            for i in range(n_pre - 1):
                L = len(prompt) + i
                eng.kv.extend("s", L + 1)
                toks.append(int(np.argmax(
                    eng.decode([toks[-1]], ["s"], [L])[0])))
            snap = extract_sequence(eng, "s")
            send_snapshot(comm, 1, snap, tag=7)
            comm.send_obj({"toks": toks, "sha": [
                hashlib.sha256(p.tobytes()).hexdigest()
                for p in snap.pages]}, 1, tag=8)
        else:
            snap = recv_snapshot(comm, 0, tag=7, timeout_ms=30_000)
            meta = comm.recv_obj(0, tag=8, timeout_ms=30_000)
            toks = meta["toks"]
            restore_sequence(eng, snap, "s")
            back = extract_sequence(eng, "s")
            res[f"{name}_wire_equal"] = meta["sha"] == [
                hashlib.sha256(p.tobytes()).hexdigest() for p in snap.pages]
            res[f"{name}_pages_equal"] = all(
                a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes()
                for a, b in zip(snap.pages, back.pages))
            res[f"{name}_dtypes"] = list(snap.dtypes)
            L = len(prompt) + n_pre - 1
            for i in range(n_post):
                eng.kv.extend("s", L + 1)
                toks.append(int(np.argmax(
                    eng.decode([toks[-1]], ["s"], [L])[0])))
                L += 1
            res[f"{name}_stream"] = toks
            res[f"{name}_whole"] = whole
            eng.kv.assert_consistent()
    comm.barrier()
    return res


# -- across cards (NCCL, one process a card) -----------------------------------

# Phase 4's LM widths at serving geometry (chip_smoke.py phase 12): 16
# heads shard four ways; bf16, random weights from seed 0.
SERVE_FULL = dict(vocab=32768, d_model=2048, n_heads=16, d_ff=8192,
                  n_layers=8, max_len=2048)
SERVE_GEO = dict(block_size=16, n_blocks=512, max_len=2048)
SERVE_TRAFFIC = dict(requests=16, prompt_len=64, new_tokens=32, batch=8,
                     long_requests=4, long_len=1024, slice=256)


def _full_lm(dev, cfg):
    from chainermn_tpu_torch.models.transformer import TransformerLM

    lm = TransformerLM(**cfg, dtype=torch.bfloat16, device=dev, seed=0)
    lm.requires_grad_(False)
    return lm


def _prompts(n, length, seed, vocab):
    rs = np.random.RandomState(seed)
    return rs.randint(0, vocab, size=(n, length)).tolist()


def _sync(dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def _serve_args(args):
    """(device, LM config, geometry, traffic) of a serving case: the card
    defaults, or ``args``' smaller ones for a rehearsal on gloo."""
    return (args.get("device", "cuda"), args.get("lm", SERVE_FULL),
            args.get("geo", SERVE_GEO), args.get("traffic", SERVE_TRAFFIC))


def _served(engine, prompts, new_tokens, dev):
    """Every prompt through the frontend at once (after a warm-up
    request): streams, tokens/s over the wall time, TTFT percentiles."""
    import time

    from chainermn_tpu_torch.serving import (ContinuousBatchingScheduler,
                                             ServeFrontend)

    fe = ServeFrontend(ContinuousBatchingScheduler(engine),
                       max_queue=len(prompts) + 1)
    fe.submit(prompts[0], 4)
    fe.run_until_idle()
    first = {}
    _sync(dev)
    t0 = time.perf_counter()
    hs = [fe.submit(p, new_tokens, on_token=lambda rid, tok:
                    first.setdefault(rid, time.perf_counter()))
          for p in prompts]
    fe.run_until_idle()
    wall = time.perf_counter() - t0
    ttft = sorted(v - t0 for v in first.values())
    return {"streams": [list(h.tokens) for h in hs],
            "tokens_per_s": sum(len(h.tokens) for h in hs) / wall,
            "ttft_p50_ms": ttft[len(ttft) // 2] * 1e3,
            "ttft_max_ms": ttft[-1] * 1e3}


def _decode_step_profile(engine, prompts, dev):
    """One decode step at B = len(prompts) after their prefills, under
    ``torch.profiler``: wall, device busy and NCCL kernel time (ms)."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ids = list(range(len(prompts)))
    toks, lens = [], []
    for i, p in zip(ids, prompts):
        engine.kv.allocate(i, len(p))
        toks.append(int(np.argmax(engine.prefill(p, i))))
        engine.kv.extend(i, len(p) + 1)
        lens.append(len(p))
    for _ in range(3):
        engine.decode(toks, ids, lens)
    _sync(dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev == "cuda" else [])
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        engine.decode(toks, ids, lens)
        _sync(dev)
        wall = (time.perf_counter() - t) * 1e3
    rows = [(ev.self_device_time_total / 1e3, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA]
    for i in ids:
        engine.kv.free(i)
    return {"wall_ms": wall, "busy_ms": sum(r[0] for r in rows),
            "nccl_ms": sum(ms for ms, k in rows if "nccl" in k.lower())}


def _prefill(engine, prompt, sid):
    """The prompt's last-token logits through the path the scheduler
    takes: one prefill, or slices of ``prefill_chunk`` through the chunk
    step (the sequence-parallel one where it applies)."""
    engine.kv.allocate(sid, len(prompt))
    step = engine.prefill_chunk
    if not step or len(prompt) <= step:
        return engine.prefill(prompt, sid)
    for s0 in range(0, len(prompt), step):
        piece = prompt[s0:s0 + step]
        logits = engine.chunk([piece], [sid], [s0])
    return logits[0, len(piece) - 1]


def _teacher_forced_b8(engine, prompts, streams):
    """fp32 logits of up to 8 rows at a time fed their streams (prefill
    as the scheduler does, then decode at B 8)."""
    out = []
    for g in range(0, len(prompts), 8):
        ids = list(range(g, min(g + 8, len(prompts))))
        rows = {i: [] for i in ids}
        for i in ids:
            rows[i].append(_prefill(engine, prompts[i], i))
        for j in range(len(streams[ids[0]]) - 1):
            starts = [len(prompts[i]) + j for i in ids]
            for i, s0 in zip(ids, starts):
                engine.kv.extend(i, s0 + 1)
            got = engine.decode([streams[i][j] for i in ids], ids, starts)
            for r, i in enumerate(ids):
                rows[i].append(got[r])
        for i in ids:
            engine.kv.free(i)
            out.append(np.stack(rows[i]))
    return out


def _serve_cards(rank, size, args, out_dir):
    """Across the cards: the TP engine under plan ``tp`` (model = size)
    on the serving traffic (streams, tokens/s, TTFT, one profiled decode
    step's NCCL time), then SP prefill at sp 2 and 4 on long prompts in
    slices (streams, tokens/s, TTFT); each engine's teacher-forced logits
    fed the one-card streams of ``args`` go to ``tf_<case>_rank<r>.npz``."""
    from torch.distributed.device_mesh import init_device_mesh

    from chainermn_tpu_torch.serving import EngineConfig, InferenceEngine

    dev, lm_cfg, geo, T = _serve_args(args)
    mesh = init_device_mesh(dev, (size,), mesh_dim_names=("model",))
    prompts = _prompts(T["requests"], T["prompt_len"], 0, lm_cfg["vocab"])
    cfg = EngineConfig(max_batch=T["batch"], **geo)
    lm = _full_lm(dev, lm_cfg)
    engine = InferenceEngine(lm, cfg, plan="tp", mesh=mesh, device=dev)
    res = {"backend": dist.get_backend(), "tp": _served(
        engine, prompts, T["new_tokens"], dev)}
    res["tp"]["profile"] = _decode_step_profile(engine, prompts[:T["batch"]],
                                                dev)
    res["tp"]["local_kv_heads"] = int(
        engine._cache[0].k_pages.to_local().shape[2])
    tf = _teacher_forced_b8(engine, prompts, args["one_card"]["tp"])
    np.savez(os.path.join(out_dir, f"tf_tp_rank{rank}.npz"), *tf)
    del engine, lm
    if dev == "cuda":
        torch.cuda.empty_cache()
    long = _prompts(T["long_requests"], T["long_len"], 1, lm_cfg["vocab"])
    lm = _full_lm(dev, lm_cfg)
    for sp in (2, 4):
        if sp > size:
            continue
        eng = InferenceEngine(lm, EngineConfig(
            max_batch=T["batch"], prefill_chunk=T["slice"], sp=sp, **geo),
            device=dev)
        r = _served(eng, long, T["new_tokens"], dev)
        r["sp_chunk_compiles"] = eng.stats()["sp_chunk_compiles"]
        res[f"sp{sp}"] = r
        tf = _teacher_forced_b8(eng, long, args["one_card"]["long"])
        np.savez(os.path.join(out_dir, f"tf_sp{sp}_rank{rank}.npz"), *tf)
    return res


def _serve_one_card(rank, size, args, out_dir):
    """One card's engine on the same traffic and weights: the TP
    reference (streams, tokens/s, TTFT, B 8 teacher-forced logits fed its
    own streams) and the long prompts in slices without SP."""
    from chainermn_tpu_torch.serving import EngineConfig, InferenceEngine

    dev, lm_cfg, geo, T = _serve_args(args)
    prompts = _prompts(T["requests"], T["prompt_len"], 0, lm_cfg["vocab"])
    lm = _full_lm(dev, lm_cfg)
    engine = InferenceEngine(lm, EngineConfig(max_batch=T["batch"], **geo),
                             device=dev)
    res = {"tp": _served(engine, prompts, T["new_tokens"], dev)}
    res["tp"]["profile"] = _decode_step_profile(engine, prompts[:T["batch"]],
                                                dev)
    tf = _teacher_forced_b8(engine, prompts, res["tp"]["streams"])
    np.savez(os.path.join(out_dir, "tf_tp_one_card.npz"), *tf)
    long = _prompts(T["long_requests"], T["long_len"], 1, lm_cfg["vocab"])
    eng = InferenceEngine(lm, EngineConfig(
        max_batch=T["batch"], prefill_chunk=T["slice"], **geo), device=dev)
    res["long"] = _served(eng, long, T["new_tokens"], dev)
    tf = _teacher_forced_b8(eng, long, res["long"]["streams"])
    np.savez(os.path.join(out_dir, "tf_long_one_card.npz"), *tf)
    return res


KINDS = {"tp": _tp, "sp": _sp, "snapshot": _snapshot,
         "serve_cards": _serve_cards, "serve_one_card": _serve_one_card}


def run(kind: str, rank: int, size: int, init_file: str, out_dir: str,
        args: dict):
    torch.set_num_threads(1)        # one core a rank: no oversubscription
    backend = "gloo"
    if kind.startswith("serve_") and args.get("device", "cuda") == "cuda":
        # One GPU a rank, as a launcher would set it up.
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)
        backend = "nccl"
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=size)
    try:
        res = KINDS[kind](rank, size, args, out_dir)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn(kind: str, size: int, tmp_path, timeout_s: float = 60, **args):
    """Run ``kind`` on ``size`` spawned gloo ranks, each joined under
    ``timeout_s``; returns every rank's JSON result."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(kind, r, size,
                                           str(tmp_path / "rendezvous"),
                                           str(tmp_path), args))
             for r in range(size)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout_s)
            assert p.exitcode is not None, f"rank timed out after {timeout_s}s"
            assert p.exitcode == 0, f"rank exited {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(size)]
