#!/usr/bin/env python3
"""Smoke run of ``chainermn_tpu_torch`` on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, each
of which fails the run when wrong:

1. the card: ``nvidia-smi`` name and power limit, the torch device name;
2. build the flash-attention kernels from ``chainermn_tpu_torch/csrc``
   (``nvcc``, sm_90a) and print the compiler's register, shared-memory and
   spill report, with any note that it serialised ``wgmma``;
3. hold each kernel (forward, dQ, dK/dV) against its plain PyTorch twin
   on the same inputs, in bf16 and fp32, causal and not, GQA, sliding
   window, packed segments with padding rows, ragged S, D in {64, 128},
   and once at the full-width shape, each case tagged with the route each
   kernel took (``wgmma`` or ``simt``); a tiny fp32 LM through the
   kernels against the same LM on dense attention;
4. the main path: the data-parallel LM train step of the port at full
   width (vocab 32768, d_model 2048, 16 heads, d_ff 8192, 8 layers,
   S 4096, batch 4, bf16 compute, fp32 AdamW master weights) through
   ``create_communicator("pure_nccl")`` over NCCL, with every kernel
   launch counted, then one more step under ``torch.profiler`` for the
   device time by kind of kernel (the ``other`` kind split by family and
   by the operator that launched it, with its largest kernels) and the
   device's idle share;
5. per-kernel times at the main path's shapes (CUDA events) beside the
   plain twins, the least time the card could take (and the share of it
   reached), the TFLOP/s, and one PyTorch call computing the same
   function (``scaled_dot_product_attention``), timed here as a yardstick
   only.

The last two lines of standard output are the card's ``name, power.limit``
line before a JSON line of per-kernel numbers, then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

# Published peaks of one H100 SXM (dense bf16 tensor-core rate, HBM3 rate).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

N_WARMUP, N_TIMED = 2, 5     # train steps before and inside the timing

FULL = dict(vocab=32768, d_model=2048, n_heads=16, d_ff=8192, n_layers=8,
            seq=4096, batch=4, ce_chunk=1024)

# The design behind each route: the Hopper kernels (TMA-fed mbarrier ring,
# warp specialisation, wgmma) and the plain SIMT ones.
DESIGNS = {"wgmma": "wgmma_tma", "simt": "simt"}

KERNELS = {
    "flash_fwd": ("chainermn_tpu_torch/csrc/flash_fwd.cu",
                  "chainermn_tpu/ops/flash_attention.py:89"),
    "flash_dq": ("chainermn_tpu_torch/csrc/flash_bwd.cu",
                 "chainermn_tpu/ops/flash_attention.py:233"),
    "flash_dkv": ("chainermn_tpu_torch/csrc/flash_bwd.cu",
                  "chainermn_tpu/ops/flash_attention.py:282"),
}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain twins
# ---------------------------------------------------------------------------


def make_case(torch, BH, BHk, S, D, dtype, seg, seed):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to("cuda", dtype)

    q, k, v, do = rnd(BH, S, D), rnd(BHk, S, D), rnd(BHk, S, D), rnd(BH, S, D)
    qs = ks = None
    if seg:
        ids = torch.zeros(S, dtype=torch.int32)
        ids[S // 3: 2 * S // 3] = 1
        ids[5 * S // 6:] = -1                      # padding rows
        kids = ids.clone()
        kids[kids == -1] = -2                      # padding matches nothing
        qs = ids[None, :, None].repeat(BH, 1, 1).cuda()
        ks = kids[None, :, None].repeat(BHk, 1, 1).cuda()
    return q, k, v, do, qs, ks


# Kernel against twin, two limits on each of o, dq, dk and dv:
#  * every element: |a - b| <= atol + rtol * |b|;
#  * every tile of TILE rows of one head (query rows for o and dq, key rows
#    for dk and dv): ||a - b|| / ||b|| <= tile_l2.
# The row LSE must agree within LSE_ATOL on rows with a live key.  bf16:
# kernel and twin both round P (and dS) to bf16, but from fp32 values that
# differ in their last bits, so a P near 1 can round one bf16 ulp (2^-8)
# apart; times an operand of magnitude up to 4 that moves one element by
# up to 2^-6, which atol covers, and the outputs' own bf16 rounding (at most
# 2^-7 |b|) is within rtol.  Such flips are isolated; an error spread over
# a tile (a skipped or doubled key tile shifts a whole row tile by about
# the typical |o| of 0.02-0.04) fails tile_l2.  fp32: summation order only.
TOL = {"bfloat16": {"atol": 2 ** -6, "rtol": 2e-2, "tile_l2": 1e-2},
       "float32": {"atol": 2e-5, "rtol": 1e-4, "tile_l2": 1e-5}}
TILE = 64
LSE_ATOL = 1e-4


def compare_case(torch, K, case, causal, window, scale, tol):
    """Kernel against twin on one case.  Returns the max abs error of each
    of o, lse, dq, dk, dv, a report line, and the names that fail the
    limits above (or whose fully masked rows are not o = 0, lse ~ -1e30)."""
    q, k, v, do, qs, ks = case
    o, lse = K.flash_fwd(q, k, v, scale, causal, window, qs, ks)
    o_p, lse_p = K.flash_fwd_plain(q, k, v, scale, causal, window, qs, ks)
    delta = (do.float() * o_p.float()).sum(-1, keepdim=True).contiguous()
    dq = K.flash_dq(q, k, v, do, lse_p, delta, scale, causal, window, qs, ks)
    dk, dv = K.flash_dkv(q, k, v, do, lse_p, delta, scale, causal, window,
                         qs, ks)
    dq_p = K.flash_dq_plain(q, k, v, do, lse_p, delta, scale, causal, window,
                            qs, ks)
    dk_p, dv_p = K.flash_dkv_plain(q, k, v, do, lse_p, delta, scale, causal,
                                   window, qs, ks)
    torch.cuda.synchronize()
    errs, notes, bad = {}, [], []
    for name, a, b in (("o", o, o_p), ("dq", dq, dq_p), ("dk", dk, dk_p),
                       ("dv", dv, dv_p)):
        a, b = a.float(), b.float()
        d = (a - b).abs()
        errs[name] = d.max().item()
        # The worst element's share of its limit: the output passes at <= 1.
        worst = (d / (tol["atol"] + tol["rtol"] * b.abs())).max().item()
        tiles = max(
            (dt.norm(dim=(1, 2)) / bt.norm(dim=(1, 2)).clamp_min(1e-30))
            .max().item()
            for dt, bt in zip(d.split(TILE, dim=1), b.split(TILE, dim=1)))
        notes.append(f"{name} {errs[name]:.3g} (worst element {worst:.2f} "
                     f"of limit, worst tile l2 {tiles:.2g})")
        if not (worst <= 1.0 and tiles <= tol["tile_l2"]):
            bad.append(name)
    live = lse_p > -1e29            # rows with at least one live key
    errs["lse"] = (lse - lse_p).abs()[live].max().item() if live.any() else 0.0
    notes.append(f"lse {errs['lse']:.3g}")
    if not errs["lse"] <= LSE_ATOL:
        bad.append("lse")
    dead = ~live
    if dead.any():                  # fully masked rows: o = 0, lse ~ -1e30
        if o[dead.expand_as(o)].abs().max().item() != 0.0:
            bad.append("o_dead")
        if lse[dead].max().item() > -1e29:
            bad.append("lse_dead")
    return errs, "; ".join(notes), bad


def phase_compare(torch, K, log):
    """Every case against its twin, then the full-width shape; fails after
    printing them all.  Returns the full-width errors per kernel."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for D in (64, 128):
            cases += [
                (dtype, 4, 4, 256, D, True, None, False),
                (dtype, 4, 4, 256, D, False, None, False),
                (dtype, 8, 2, 192, D, True, None, False),      # GQA, G = 4
                (dtype, 4, 4, 256, D, True, 17, False),        # window
                (dtype, 4, 2, 256, D, True, None, True),       # segments
                (dtype, 4, 2, 256, D, False, None, True),
                (dtype, 4, 4, 200, D, True, 64, True),         # ragged S
                (dtype, 16, 4, 320, D, True, None, False),     # ragged, G = 4
            ]
    cases.append((torch.bfloat16, 4, 2, 256, 96, True, 33, True))  # SIMT bf16
    # Full width, the main path's shapes.
    S, D = FULL["seq"], FULL["d_model"] // FULL["n_heads"]
    BH = FULL["batch"] * FULL["n_heads"]
    cases.append((torch.bfloat16, BH, BH, S, D, True, None, False))
    for dt, t in TOL.items():
        log(f"compare limits {dt}: |a-b| <= {t['atol']} + {t['rtol']}*|b| "
            f"per element, ||a-b||/||b|| <= {t['tile_l2']} per {TILE}-row "
            f"tile; lse <= {LSE_ATOL}")
    failed = []
    for i, (dtype, BH, BHk, S, D, causal, window, seg) in enumerate(cases):
        case = make_case(torch, BH, BHk, S, D, dtype, seg,
                         seed=99 if i == len(cases) - 1 else i)
        errs, report, bad = compare_case(torch, K, case, causal, window,
                                         D ** -0.5, TOL[str(dtype)[6:]])
        del case
        routes = " ".join(f"{name[6:]}:{K.route(name, dtype, D)}"
                          for name in KERNELS)
        tag = (f"{str(dtype)[6:]} BH={BH} BHk={BHk} S={S} D={D} "
               f"causal={causal} window={window} seg={seg} route {routes}")
        log(f"compare {tag}: {report}" + (f"  FAIL {bad}" if bad else ""))
        if bad:
            failed.append(f"{tag}: {bad}")
    if failed:
        raise AssertionError("kernel disagrees with twin: " + " | ".join(failed))
    return {"flash_fwd": max(errs["o"], errs["lse"]), "flash_dq": errs["dq"],
            "flash_dkv": max(errs["dk"], errs["dv"])}


def phase_tiny_lm(torch, log):
    """A tiny fp32 LM through the kernels vs the same LM on dense
    attention: losses and gradients agree."""
    from chainermn_tpu_torch.models.transformer import TransformerLM
    from chainermn_tpu_torch.ops import make_flash_attention_fn
    from chainermn_tpu_torch.ops.fused_ce import fused_cross_entropy

    cfg = dict(vocab=64, d_model=64, n_heads=4, d_ff=128, n_layers=2,
               max_len=128, dtype=torch.float32, device="cuda", seed=3)
    flash = TransformerLM(**cfg, attention_fn=make_flash_attention_fn())
    dense = TransformerLM(**cfg)
    dense.load_state_dict(flash.state_dict())
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, 64, (2, 128), generator=g).cuda()
    labs = torch.randint(0, 64, (2, 128), generator=g).cuda()
    losses = []
    for m in (flash, dense):
        loss = fused_cross_entropy(m(toks, return_hidden=True),
                                   m.embed.weight, labs)
        loss.backward()
        losses.append(loss.item())
    gerr = max((a.grad - b.grad).abs().max().item()
               for a, b in zip(flash.parameters(), dense.parameters()))
    log(f"tiny fp32 LM: flash loss {losses[0]:.6f} dense {losses[1]:.6f} "
        f"max grad err {gerr:.3g} (tol 1e-4)")
    if abs(losses[0] - losses[1]) > 1e-4 or not gerr <= 1e-4:
        raise AssertionError("tiny LM through the kernels disagrees")


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------


def phase_train(torch, K, log, n_warm, n_timed):
    import numpy as np

    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.models.transformer import TransformerLM
    from chainermn_tpu_torch.ops import make_flash_attention_fn
    from chainermn_tpu_torch.ops.fused_ce import fused_cross_entropy

    comm = create_communicator("pure_nccl", device="cuda")
    backend = torch.distributed.get_backend()
    log(f"communicator {comm!r} backend={backend}")
    if backend != "nccl":
        raise AssertionError(f"expected NCCL, got {backend}")
    t0 = time.perf_counter()
    model = TransformerLM(
        vocab=FULL["vocab"], d_model=FULL["d_model"],
        n_heads=FULL["n_heads"], d_ff=FULL["d_ff"],
        n_layers=FULL["n_layers"], max_len=FULL["seq"],
        dtype=torch.bfloat16, attention_fn=make_flash_attention_fn(causal=True),
        device="cuda", seed=0,
    )
    n_params = sum(p.numel() for p in model.parameters())
    opt = create_multi_node_optimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=0.1),
        comm,
    )
    opt.init()
    rng = np.random.RandomState(0)
    B, S, V = FULL["batch"] * comm.size, FULL["seq"], FULL["vocab"]
    tokens = torch.from_numpy(rng.randint(0, V, size=(B, S))).cuda()
    labels = torch.from_numpy(rng.randint(0, V, size=(B, S))).cuda()
    log(f"model {n_params / 1e6:.1f}M params, set-up "
        f"{time.perf_counter() - t0:.1f}s")

    def loss_fn(batch):
        toks, labs = batch
        h = model(toks, return_hidden=True)
        return fused_cross_entropy(h, model.embed.weight, labs,
                                   chunk=FULL["ce_chunk"])

    step = opt.make_train_step(loss_fn)
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(n_warm + n_timed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step((tokens, labels))
        lv = loss.item()                  # synchronises
        times.append(time.perf_counter() - t)
        losses.append(lv)
        log(f"step {i}: loss {lv:.5f} {times[-1] * 1e3:.1f} ms")
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps = n_warm + n_timed
    log(f"launches over {steps} steps: {launches}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not abs(losses[0] - math.log(V)) < 1.5:
        raise AssertionError(f"step-0 loss {losses[0]} far from ln V = "
                             f"{math.log(V):.3f}")
    for name in KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    timed = sorted(times[n_warm:])
    med = timed[len(timed) // 2]
    tok_s = B * S / med
    log(f"median step {med * 1e3:.1f} ms, {tok_s:.0f} tokens/s, peak "
        f"memory {peak / 2**30:.2f} GiB, losses {losses}")
    profile_step(torch, lambda: step((tokens, labels)), log)
    torch.distributed.destroy_process_group()
    return {"step_ms": med * 1e3, "tokens_per_s": tok_s,
            "peak_mem_gib": peak / 2**30, "launches": launches,
            "steps": steps}


def kernel_kind(name):
    low = name.lower()
    return ("flash" if "flash_" in low else
            "nccl" if "nccl" in low else
            "gemm" if any(w in low for w in ("gemm", "nvjet", "xmma",
                                              "cutlass", "cublas")) else
            "other")


# The ``other`` kind split two ways.  By family, from the kernel's name
# (the first match wins, else "elementwise"):
OTHER_FAMILIES = (
    ("multi-tensor (AdamW)", ("multi_tensor_apply",)),
    ("copy (casts, layout copies)", ("copy",)),
    ("layernorm", ("layer_norm", "layernorm", "gammabeta")),
    ("gelu", ("gelu",)),
    ("exp", ("exp_kernel",)),
    ("reduce", ("reduce_kernel",)),
    ("embedding, index", ("embedding", "index")),
    ("fill", ("fill",)),
)
# By source, from the operators that launched it: the first of these that
# any operator on the path from the launch up to the step's root matches
# (else the launching operator's own name).
OTHER_SOURCES = (
    ("Optimizer.step", "AdamW step"),
    ("FusedCE", "cross-entropy"),
    ("_FlashBH", "flash adapter"),
    ("layer_norm", "layernorm"),
    ("gelu", "gelu"),
    ("aten::_to_copy", "cast (.to)"),
    ("aten::clone", "layout copy (.contiguous, reshape)"),
)


def _ms_table(d):
    return ", ".join(f"{k} {v:.1f}" for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1]))


def profile_step(torch, run_step, log, top=14, top_other=10):
    """One more train step under ``torch.profiler``: device time by kernel
    and by kind, the ``other`` kind by family, by source and its largest
    kernels, and the device's idle share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = sorted(
        ((ev.self_device_time_total / 1e3, ev.count, ev.key)
         for ev in prof.key_averages()
         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total
         and not getattr(ev, "is_user_annotation", False)),
        reverse=True)
    busy = sum(r[0] for r in rows)
    kinds, families = {}, {}
    for ms, _, key in rows:
        kind = kernel_kind(key)
        kinds[kind] = kinds.get(kind, 0.0) + ms
        if kind == "other":
            low = key.lower()
            fam = next((f for f, words in OTHER_FAMILIES
                        if any(w in low for w in words)), "elementwise")
            families[fam] = families.get(fam, 0.0) + ms
    log(f"profile: step wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, "
        f"idle share {1 - busy / wall_ms:.3f}; by kind (ms): "
        + _ms_table(kinds))
    for ms, count, key in rows[:top]:
        log(f"profile:   {ms:9.2f} ms  x{count:<5d} {key[:90]}")
    sources = {}
    for ev in prof.events():
        ks = [k for k in ev.kernels if kernel_kind(k.name) == "other"]
        if not ks:
            continue
        path, e = [], ev
        while e is not None:
            path.append(e.name)
            e = e.cpu_parent
        src = next((label for pat, label in OTHER_SOURCES
                    if any(pat in n for n in path)), ev.name)
        sources[src] = sources.get(src, 0.0) + sum(
            k.duration for k in ks) / 1e3
    log("profile: other by family (ms): " + _ms_table(families))
    log("profile: other by source (ms): " + _ms_table(sources))
    for ms, count, key in [r for r in rows
                           if kernel_kind(r[2]) == "other"][:top_other]:
        log(f"profile:   other {ms:9.2f} ms  x{count:<5d} {key[:160]}")


# ---------------------------------------------------------------------------
# Phase 5: kernel times, bounds and the library yardstick
# ---------------------------------------------------------------------------


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_time(torch, K, log):
    import torch.nn.functional as F

    S, H = FULL["seq"], FULL["n_heads"]
    D, Bt = FULL["d_model"] // H, FULL["batch"]
    BH = Bt * H
    q, k, v, do, _, _ = make_case(torch, BH, BH, S, D, torch.bfloat16, False,
                                  seed=7)
    scale = D ** -0.5
    o, lse = K.flash_fwd(q, k, v, scale, True)
    delta = (do.float() * o.float()).sum(-1, keepdim=True).contiguous()
    pairs = S * (S + 1) // 2 * BH              # live (q, k) pairs, causal
    el = BH * S * D * 2                        # one bf16 operand, bytes
    row = BH * S * 4                           # one fp32 row statistic
    work = {
        "flash_fwd": (4 * D * pairs, 4 * el + row),
        "flash_dq": (6 * D * pairs, 5 * el + 2 * row),
        "flash_dkv": (8 * D * pairs, 6 * el + 2 * row),
    }
    kern = {
        "flash_fwd": lambda: K.flash_fwd(q, k, v, scale, True),
        "flash_dq": lambda: K.flash_dq(q, k, v, do, lse, delta, scale, True),
        "flash_dkv": lambda: K.flash_dkv(q, k, v, do, lse, delta, scale,
                                         True),
    }
    plain = {
        "flash_fwd": lambda: K.flash_fwd_plain(q, k, v, scale, True),
        "flash_dq": lambda: K.flash_dq_plain(q, k, v, do, lse, delta, scale,
                                             True),
        "flash_dkv": lambda: K.flash_dkv_plain(q, k, v, do, lse, delta, scale,
                                               True),
    }
    # Yardstick: PyTorch's fused attention in (B, H, S, D), forward alone,
    # and its backward (dq, dk, dv in one call).
    ql, kl, vl = (x.view(Bt, H, S, D).detach().requires_grad_(True)
                  for x in (q, k, v))
    dol = do.view(Bt, H, S, D)
    with torch.no_grad():
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            ql, kl, vl, is_causal=True), 10)
    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, (ql, kl, vl), dol, retain_graph=True), 10)
    library = {"flash_fwd": lib_fwd, "flash_dq": lib_bwd,
               "flash_dkv": lib_bwd}
    res = {}
    for name in KERNELS:
        flops, nbytes = work[name]
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        ms = time_ms(torch, kern[name], 10)
        res[name] = {
            "ms": ms,
            "plain_ms": time_ms(torch, plain[name], 2),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library[name],
            "design": DESIGNS[K.route(name, torch.bfloat16, D)],
            "tflops": flops / ms / 1e9,
            "bound_share": max(t_ops, t_bytes) / ms,
        }
        r = res[name]
        log(f"time {name} [{r['design']}]: {r['ms']:.3f} ms (plain "
            f"{r['plain_ms']:.3f}, bound {r['bound_ms']:.3f} by "
            f"{r['bound_by']}, library {r['library_ms']:.3f}), "
            f"{r['tflops']:.1f} TFLOP/s, {r['bound_share']:.3f} of bound")
    return res


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log", default=None,
                    help="also append the progress lines to this file")
    args = ap.parse_args(argv)

    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "chainermn_tpu_torch", "csrc")):
        return fail("chainermn_tpu_torch/ is not beside this script; run it "
                    "from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, repo)
    from chainermn_tpu_torch.ops import _kernels as K

    def log(msg):
        print(msg, flush=True)
        if args.log:
            with open(args.log, "a") as f:
                f.write(msg + "\n")

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {kind}, count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    info = K.build()
    log(f"build: {time.perf_counter() - t0:.1f}s wall")
    for name, rec in info.items():
        log(f"build {name}.cu: {rec['seconds']:.1f}s")
        for line in rec["log"].splitlines():
            if re.search(r"Compiling entry|Used \d+ registers|spill|"
                         r"[Ww]arning|Performance Loss", line):
                log("  " + line.strip())
    for name in KERNELS:
        log(f"dynamic shared memory per block, {name}: " + ", ".join(
            f"{str(dt)[6:]} D={d}: {K.smem_bytes(name, dt, d)} B"
            for dt in (torch.bfloat16, torch.float32) for d in (64, 128)))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = phase_compare(torch, K, log)
    phase_tiny_lm(torch, log)
    train = phase_train(torch, K, log, N_WARMUP, N_TIMED)
    times = phase_time(torch, K, log)

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": train["launches"][name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "design": t["design"], "tflops": t["tflops"],
            "bound_share": t["bound_share"],
        })
    summary = {k: train[k] for k in ("step_ms", "tokens_per_s",
                                     "peak_mem_gib", "steps")}
    print(json.dumps({"train": summary}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
