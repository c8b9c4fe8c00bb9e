"""Worker processes for the multi-rank gloo tests of the port's
sequence-parallel tier: ring, zigzag ring and Ulysses attention, the
vocab-parallel embedding and cross-entropy, expert parallelism, and the
long-context example.

Imports only torch, numpy and the port, so a spawned child never loads
JAX.  Each worker joins a ``file://`` rendezvous, runs one kind of check,
and writes its result as JSON to ``<out_dir>/rank<r>.json``.  The inputs
are numpy draws from fixed seeds, shared with the tests, which feed the
same arrays to the reference on as many devices.
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

# -- sequence-parallel attention ------------------------------------------------

B, D = 2, 8


def _case(kind, S=16, H=4, Hk=None, causal=True, seg=None, window=None,
          flash=False):
    return dict(kind=kind, S=S, H=H, Hk=Hk or H, causal=causal, seg=seg,
                window=window, flash=flash)


# Every attention case: ring over contiguous shards, zigzag over the zigzag
# layout (S = 32: chunks of 4 at four ranks), Ulysses over contiguous
# shards.  ``seg``: "local" shards of packed ids, or "full" (B, S) ids on
# every rank (Ulysses' closure form).
SP_CASES = {
    "ring_causal": _case("ring"),
    "ring_noncausal": _case("ring", causal=False),
    "ring_seg_causal": _case("ring", seg="local"),
    "ring_seg_gqa2_noncausal": _case("ring", Hk=2, causal=False,
                                     seg="local"),
    "ring_gqa1_causal": _case("ring", Hk=1),
    "ring_window": _case("ring", window=5),
    "ring_window_gqa_seg": _case("ring", Hk=2, seg="local", window=6),
    "zigzag_dense": _case("zigzag", S=32),
    "zigzag_flash": _case("zigzag", S=32, flash=True),
    "zigzag_seg_gqa2_dense": _case("zigzag", S=32, Hk=2, seg="local"),
    "zigzag_seg_gqa1_flash": _case("zigzag", S=32, Hk=1, seg="local",
                                   flash=True),
    "ulysses_causal": _case("ulysses"),
    "ulysses_noncausal": _case("ulysses", causal=False),
    "ulysses_seg_local": _case("ulysses", seg="local"),
    "ulysses_seg_full_gqa": _case("ulysses", H=8, Hk=4, seg="full"),
    "ulysses_window": _case("ulysses", window=6),
}


def sp_inputs(name: str, n: int):
    """Seeded numpy inputs of case ``name`` at ``n`` shards: q, k, v, the
    output's cotangent weights w and (B, S) segment ids (two documents a
    row, each row's boundary inside a shard), all already in the shard
    layout's sequence order (the zigzag permutation for zigzag)."""
    c = SP_CASES[name]
    S, H, Hk = c["S"], c["H"], c["Hk"]
    rng = np.random.RandomState(sorted(SP_CASES).index(name))
    out = {"q": rng.randn(B, S, H, D), "k": rng.randn(B, S, Hk, D),
           "v": rng.randn(B, S, Hk, D), "w": rng.randn(B, S, H, D)}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    seg = np.zeros((B, S), np.int32)
    seg[0, (3 * S) // 8:] = 1
    seg[1, (5 * S) // 8 + 1:] = 1
    out["seg"] = seg
    if c["kind"] == "zigzag":
        from chainermn_tpu_torch.parallel.ring_attention import zigzag_indices

        idx = zigzag_indices(S, n)
        out = {k: v[:, idx] for k, v in out.items()}
    return out


def _shard(x, r, n):
    s = x.shape[1] // n
    return x[:, r * s:(r + 1) * s]


def _np(t):
    return t.detach().cpu().numpy().tolist()


def sp_case(comm, name: str):
    """Case ``name`` on this rank: its output shard and the gradients of
    ``sum(out * w)`` (summed over the ranks) for its q, k, v shards."""
    from chainermn_tpu_torch.parallel import ring_attention as ra
    from chainermn_tpu_torch.parallel.ulysses import ulysses_attention

    c = SP_CASES[name]
    n, r = comm.size, comm.rank
    inp = sp_inputs(name, n)
    q, k, v = (torch.from_numpy(np.ascontiguousarray(_shard(inp[x], r, n)))
               .requires_grad_() for x in "qkv")
    w = torch.from_numpy(np.ascontiguousarray(_shard(inp["w"], r, n)))
    seg = None
    if c["seg"] == "local":
        seg = torch.from_numpy(np.ascontiguousarray(_shard(inp["seg"], r, n)))
    elif c["seg"] == "full":
        seg = torch.from_numpy(inp["seg"])
    if c["kind"] == "ring":
        out = ra.ring_attention(q, k, v, comm, causal=c["causal"],
                                q_segment_ids=seg, window=c["window"])
    elif c["kind"] == "zigzag":
        out = ra.zigzag_ring_attention(q, k, v, comm, use_flash=c["flash"],
                                       segment_ids=seg)
    else:
        out = ulysses_attention(q, k, v, comm, causal=c["causal"],
                                q_segment_ids=seg, window=c["window"])
    gq, gk, gv = torch.autograd.grad((out * w).sum(), (q, k, v))
    return {"out": _np(out), "q": _np(gq), "k": _np(gk), "v": _np(gv)}


def ulysses_refusal_cases(n: int):
    """(H, Hk) that ``n`` ranks refuse (accepted at one rank): a head count
    the ranks do not divide, and kv heads the ranks do not divide."""
    return {"heads": (3, 3), "kv_heads": (4, max(1, n // 2))}


def sp_errors(comm):
    """Ulysses on :func:`ulysses_refusal_cases`: each error message, or
    None where it ran."""
    from chainermn_tpu_torch.parallel.ulysses import ulysses_attention

    out = {}
    for name, (H, Hk) in ulysses_refusal_cases(comm.size).items():
        q = torch.zeros(B, 4, H, D)
        kv = torch.zeros(B, 4, Hk, D)
        try:
            ulysses_attention(q, kv, kv, comm)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def gather_kv_case(comm):
    """``gather_sequence_kv`` of the ``ring_seg_gqa2_noncausal`` inputs' K/V
    shards: the gathered pair, and the gradients of ``sum(k_full * wk +
    v_full * wv)`` taken on every rank (``wk``, ``wv``: the case's q and
    w, cut to the kv heads)."""
    from chainermn_tpu_torch.parallel.ring_attention import gather_sequence_kv

    n, r = comm.size, comm.rank
    inp = sp_inputs("ring_seg_gqa2_noncausal", n)
    k, v = (torch.from_numpy(np.ascontiguousarray(_shard(inp[x], r, n)))
            .requires_grad_() for x in "kv")
    kf, vf = gather_sequence_kv(k, v, comm)
    wk, wv = (torch.from_numpy(np.ascontiguousarray(inp[x][:, :, :2]))
              for x in ("q", "w"))
    gk, gv = torch.autograd.grad((kf * wk).sum() + (vf * wv).sum(), (k, v))
    return {"k": _np(kf), "v": _np(vf), "gk": _np(gk), "gv": _np(gv)}


def sp_all(comm, kinds=None):
    """Every case of ``SP_CASES`` whose kind is in ``kinds`` (all when
    None), with Ulysses' refusals and ``gather_sequence_kv`` unless
    ``kinds`` leaves out ``ulysses``: a test file runs only its own."""
    out = {name: sp_case(comm, name) for name, c in SP_CASES.items()
           if kinds is None or c["kind"] in kinds}
    if kinds is None or "ulysses" in kinds:
        out["errors"] = sp_errors(comm)
        out["gather_kv"] = gather_kv_case(comm)
    return out


def _sp(rank, size, args):
    return sp_all(_naive_cpu(), args.get("kinds"))


# -- vocab parallelism ------------------------------------------------------------

VOCAB = 64


def vocab_inputs():
    """Seeded inputs of the vocab-parallel cases."""
    rng = np.random.RandomState(3)
    out = {
        "emb": rng.randn(VOCAB, 16).astype(np.float32),
        "toks": rng.randint(0, VOCAB, size=(2, 16)).astype(np.int32),
        "w": rng.randn(2, 16, 16).astype(np.float32),
        "x": rng.randn(2, 16, 8).astype(np.float32),
        "xw": rng.randn(2, 16, 8).astype(np.float32),
        "h": rng.randn(48, 16).astype(np.float32),
        "ce_emb": (rng.randn(VOCAB, 16) * 0.1).astype(np.float32),
        "labels": rng.randint(0, VOCAB, size=48).astype(np.int32),
        "mask": rng.rand(48) < 0.3,
        "e2e_emb": (rng.randn(VOCAB, 16) * 0.3).astype(np.float32),
        "e2e_w": (rng.randn(16, 16) * 0.3).astype(np.float32),
        "e2e_labels": rng.randint(0, VOCAB, size=(2, 16)).astype(np.int32),
    }
    return out


def vocab_case(comm):
    """Every vocab-parallel case on this rank."""
    from chainermn_tpu_torch.parallel import sharding

    n, r = comm.size, comm.rank
    inp = vocab_inputs()
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    v_loc = VOCAB // n
    rows = slice(r * v_loc, (r + 1) * v_loc)
    res = {}
    # The pure-TP contract: the same cotangent on every rank.
    emb = t["emb"][rows].clone().requires_grad_()
    out = sharding.vocab_parallel_embed(t["toks"], emb, comm)
    (g,) = torch.autograd.grad((out * t["w"]).sum(), [emb])
    res["embed"] = {"out": _np(out), "grad": _np(g)}
    # The SP contract: each rank's loss reads its own sequence slice.
    emb = t["emb"][rows].clone().requires_grad_()
    x_f = sharding.vocab_parallel_embed(t["toks"], emb, comm, True)
    (g,) = torch.autograd.grad(
        (_shard(x_f, r, n) * _shard(t["w"], r, n)).sum(), [emb])
    res["embed_grad_reduce"] = {"grad": _np(g)}
    # The head gather: every rank's loss on the gathered tensor.
    x_l = _shard(t["x"], r, n).clone().requires_grad_()
    x_f = sharding.gather_seq_for_replicated_head(x_l, comm, 1)
    (g,) = torch.autograd.grad((x_f * t["xw"]).sum(), [x_l])
    res["gather"] = {"out": _np(x_f), "grad": _np(g)}
    for name, neg in (("ce", False), ("ce_ignored", True)):
        h = t["h"].clone().requires_grad_()
        e = t["ce_emb"][rows].clone().requires_grad_()
        lab = t["labels"].long().clone()
        if neg:
            lab[t["mask"]] = -1
        loss = sharding.vocab_parallel_cross_entropy(h, e, lab, comm,
                                                     chunk=16)
        gh, ge = torch.autograd.grad(loss, [h, e])
        res[name] = {"loss": float(loss.detach()), "h": _np(gh), "emb": _np(ge)}
    # SP + vocab-TP end to end: sharded embed, a stand-in layer on this
    # rank's slice, the head gather and the sharded CE.
    e = t["e2e_emb"][rows].clone().requires_grad_()
    wl = t["e2e_w"].clone().requires_grad_()
    x_f = sharding.vocab_parallel_embed(t["toks"], e, comm, True)
    h_l = torch.tanh(_shard(x_f, r, n) @ wl)
    h_f = sharding.gather_seq_for_replicated_head(h_l, comm, 1)
    loss = sharding.vocab_parallel_cross_entropy(
        h_f, e, t["e2e_labels"].long(), comm, chunk=8)
    ge, gw = torch.autograd.grad(loss, [e, wl])
    res["e2e"] = {"loss": float(loss.detach()), "emb": _np(ge),
                  "w": _np(comm.allreduce(gw, "sum"))}
    return res


def _vocab(rank, size, args):
    return vocab_case(_naive_cpu())


# -- expert parallelism ---------------------------------------------------------

MOE_T = 16          # tokens a rank
MOE_D = 8


def moe_expert_fn(params, x):
    return torch.tanh(x @ params["w"]) @ params["w2"]


# name: (k, capacity_factor, experts_per_device)
MOE_CASES = {"top1": (1, 4.0, 1), "top2": (2, 2.0, 1), "epd2": (1, 2.0, 2)}


def moe_inputs(name: str, n: int):
    """Seeded inputs of MoE case ``name`` at ``n`` ranks: every rank's
    tokens (n T, D), the router (D, E) and every expert's parameters."""
    k, cf, epd = MOE_CASES[name]
    E = n * epd
    rng = np.random.RandomState(10 * n + sorted(MOE_CASES).index(name))
    return {"x": rng.randn(n * MOE_T, MOE_D).astype(np.float32),
            "gate_w": (rng.randn(MOE_D, E) * 0.5).astype(np.float32),
            "w": (rng.randn(E, MOE_D, 16) * 0.3).astype(np.float32),
            "w2": (rng.randn(E, 16, MOE_D) * 0.3).astype(np.float32)}


def moe_case(comm, name: str):
    """MoE case ``name`` on this rank: the output for its tokens, the aux
    dict, the gradients of ``sum(y ** 2)`` summed over the ranks (router)
    and of its experts, and the port's own oracle on its tokens."""
    from chainermn_tpu_torch.parallel import moe

    k, cf, epd = MOE_CASES[name]
    n, r, dev = comm.size, comm.rank, comm.device
    inp = {a: torch.from_numpy(b).to(dev)
           for a, b in moe_inputs(name, n).items()}
    x = inp["x"][r * MOE_T:(r + 1) * MOE_T]
    gate_w = inp["gate_w"].clone().requires_grad_()
    mine = slice(r * epd, (r + 1) * epd)
    experts = {p: inp[p][mine].clone().requires_grad_()
               for p in ("w", "w2")}
    params = experts if epd > 1 else {p: t[0] for p, t in experts.items()}
    y, aux = moe.moe_layer(x, gate_w, moe_expert_fn, params, comm,
                           capacity_factor=cf, k=k, return_aux=True,
                           experts_per_device=epd)
    gg, gw, gw2 = torch.autograd.grad((y ** 2).sum(),
                                      [gate_w, experts["w"], experts["w2"]])
    oracle = moe.dense_moe_oracle(
        x, gate_w.detach(), moe_expert_fn,
        {p: inp[p] for p in ("w", "w2")}, capacity_factor=cf, k=k)
    out = {"y": _np(y), "oracle": _np(oracle),
           "aux": {a: float(b.detach()) for a, b in aux.items()},
           "gate_w": _np(comm.allreduce(gg, "sum")), "w": _np(gw),
           "w2": _np(gw2)}
    if name == "top1":
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            y_old, lbl = moe.moe_layer(x, gate_w, moe_expert_fn, params, comm,
                                       capacity_factor=cf, k=k,
                                       return_aux="scalar")
        out["shim"] = {"warned": [str(w.category.__name__) for w in caught],
                       "y_equal": bool(torch.equal(y_old, y)),
                       "lbl": float(lbl.detach())}
        try:
            moe.moe_layer(x, torch.ones(MOE_D, n + 1, device=dev),
                          moe_expert_fn, params, comm)
            out["gate_error"] = None
        except ValueError as e:
            out["gate_error"] = str(e)
    return out


def _moe(rank, size, args):
    comm = _naive_cpu()
    return {name: moe_case(comm, name) for name in MOE_CASES}


# -- the long-context example ---------------------------------------------------

# The parity runs: a tiny LM (vocab 64, d_model 32, 4 heads, d_ff 64, one
# layer) over 3 steps of a global batch of 4 at S 32, fp32.
LM_FLAGS = ["--seq-len", "32", "--batchsize", "4", "--d-model", "32",
            "--n-heads", "4", "--d-ff", "64", "--layers", "1", "--vocab",
            "64", "--epochs", "1", "--steps-per-epoch", "3", "--dtype",
            "float32"]


def lm_configs(world: int):
    """Every example config at ``world`` ranks, as extra flags."""
    if world == 1:
        return {"none": [],
                "none_packed_gqa_window": ["--packed", "--kv-heads", "2",
                                           "--window", "8"],
                "none_no_flash": ["--no-flash"]}
    dp1 = ["--dp", "1"]
    packed = ["--packed", "--kv-heads", "2"]
    if world == 4:
        return {"ulysses_packed": ["--sp", "ulysses", "--window", "12",
                                   "--packed"] + dp1,
                "none_dp": ["--packed"],
                "ring_dp2": ["--sp", "ring", "--dp", "2"],
                "zigzag_dp2_vocab_tp": ["--sp", "zigzag", "--dp", "2",
                                        "--vocab-tp"]}
    out = {}
    for sp in ("ring", "zigzag", "ulysses"):
        out[sp] = ["--sp", sp] + dp1
        out[f"{sp}_vocab_tp"] = ["--sp", sp, "--vocab-tp"] + dp1
        extra = packed + ([] if sp == "zigzag" else ["--window", "12"])
        out[f"{sp}_packed_gqa"] = ["--sp", sp] + extra + dp1
    return out


def lm_example_run(comm, argv, init_path, device="cpu"):
    """The example's model and step on this rank from the parameters in
    ``init_path`` (a full ``state_dict`` as numpy): every step's loss and
    this rank's final parameters."""
    from chainermn_tpu_torch.examples import train_lm as ex

    args = ex.parser().parse_args(argv + ["--device", device])
    run = ex.LongContextLM(args, comm)
    with np.load(init_path) as z:
        run.load({k: torch.from_numpy(z[k]) for k in z.files})
    stream = ex.data_stream(args, run.seq_perm)
    losses = [float(run.step(*next(stream)))
              for _ in range(args.epochs * args.steps_per_epoch)]
    return {"losses": losses,
            "state": {k: _np(v) for k, v in run.state().items()},
            "inter_rank": comm.inter_rank, "intra_rank": comm.intra_rank}


def _lm(rank, size, args):
    from chainermn_tpu_torch import create_communicator

    out = {}
    comms = {}
    for name, extra in lm_configs(size).items():
        argv = LM_FLAGS + extra
        dp = (int(argv[argv.index("--dp") + 1]) if "--dp" in argv
              else None)
        if dp not in comms:
            comms[dp] = create_communicator("xla_ici", device="cpu",
                                            inter_size=dp)
        out[name] = lm_example_run(comms[dp], argv, args["init"][name])
    return out


# -- across the cards -----------------------------------------------------------

# The example at phase 4's widths with S 32768 (8192 tokens a card on
# four), one sequence, 3 steps.
LC_WIDE = ["--vocab", "32768", "--d-model", "2048", "--n-heads", "16",
           "--d-ff", "8192", "--layers", "8", "--seq-len", "32768",
           "--batchsize", "1", "--dtype", "bfloat16", "--epochs", "1",
           "--steps-per-epoch", "3"]
LC_CARDS = {"ring": ["--sp", "ring", "--dp", "1"],
            "zigzag": ["--sp", "zigzag", "--dp", "1"],
            "ulysses": ["--sp", "ulysses", "--dp", "1"],
            "zigzag_vocab_tp": ["--sp", "zigzag", "--vocab-tp", "--dp", "1"]}


def lc_wide_run(argv, device="cuda"):
    """The example on this world's devices: each step's loss, each step's
    time (host clock around a synchronised step) and peak memory."""
    import time

    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.examples import train_lm as ex

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    args = ex.parser().parse_args(argv + ["--device", device])
    comm = create_communicator("xla_ici", device=device, inter_size=args.dp)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    run = ex.LongContextLM(args, comm)
    stream = ex.data_stream(args, run.seq_perm)
    losses, ms = [], []
    for _ in range(args.epochs * args.steps_per_epoch):
        sync()
        t = time.perf_counter()
        losses.append(float(run.step(*next(stream))))
        sync()
        ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    return {"losses": losses, "step_ms": ms, "peak_gib": peak}


def _lc_nccl(rank, size, args):
    """Across the cards: every layout of ``LC_CARDS`` and ``moe_layer``
    with two experts a rank.  ``args`` may name another ``device`` and
    ``flags`` (a rehearsal on gloo)."""
    dev = args.get("device", "cuda")
    flags = args.get("flags", LC_WIDE)
    out = {"backend": dist.get_backend(),
           "lc": {name: lc_wide_run(flags + extra, dev)
                  for name, extra in LC_CARDS.items()}}
    from chainermn_tpu_torch import create_communicator

    out["moe"] = moe_case(create_communicator("naive", device=dev), "epd2")
    return out


def _lc_one_card(rank, size, args):
    return lc_wide_run(args.get("flags", LC_WIDE) + ["--sp", "none"],
                       args.get("device", "cuda"))


# -- spawning -----------------------------------------------------------------


def _naive_cpu():
    from chainermn_tpu_torch import create_communicator

    return create_communicator("naive", device="cpu")


KINDS = {"sp": _sp, "vocab": _vocab, "moe": _moe, "lm": _lm,
         "lc_nccl": _lc_nccl, "lc_one_card": _lc_one_card}


def run(kind: str, rank: int, size: int, init_file: str, out_dir: str,
        args: dict):
    torch.set_num_threads(1)        # one core a rank: no oversubscription
    backend = "gloo"
    if kind.startswith("lc_") and args.get("device", "cuda") == "cuda":
        # One GPU a rank, as a launcher would set it up.
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)
        backend = "nccl"
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=size)
    try:
        res = KINDS[kind](rank, size, args)
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
