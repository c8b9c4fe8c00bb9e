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
   only;
6. the rest of the data-parallel surface over NCCL in a fresh process
   group: (a) the MNIST example (``examples/train_mnist.py``, ``main(argv)``
   in-process) at its defaults (unit 1000, global batch 256, 5 epochs,
   8192/1024 images) at ZeRO stages 0-3, with double buffering, with the
   overlapped gradient launch off, on the int8 and fp8 gradient wires, and
   stopped after 3 epochs and resumed from its checkpoint; each run's
   accuracy, losses, parameter digest, img/s and wire are checked
   (stages 1-3 equal stage 0 within 1e-5 relative, overlap off bitwise
   equal to on, the resumed digest equal to the uninterrupted one);
   (b) 3 full-width LM steps of phase 4's model, data and seed under
   ZeRO-3 with every flash kernel launched 8 times a step and the losses
   equal to phase 4's within 1e-4;
7. the ImageNet path over NCCL in a fresh process group: (a)
   ``bench.py::bench_resnet``'s step (ResNet-50, 1000 classes, batch 256
   of 224x224x3, SGD lr 0.1 momentum 0.9 through
   ``make_train_step_with_state``, a resident ``RandomState(0)`` batch)
   on fp32 and on uint8 input: median step, img/s, peak memory, the
   model-FLOP share of the bf16 peak and one profiled step (device time
   by kind, idle share); (b) the ImageNet example
   (``examples/train_imagenet.py``, ``main(argv)`` in-process) at full
   width with SGD, with LARS, and stopped at a checkpoint and resumed
   (the loaded state's crc32 equal to the saved one's, the end within a
   stated tolerance of the uninterrupted run); (c) AlexNet, NiN and
   GoogLeNet at 224 px with dropout on; (d) (a) under ZeRO-3 with the
   flat buffer in the module's layouts and in flax's (the reference's
   shards), the losses within a stated tolerance of (a)'s and each median
   step beside (a)'s.  No TPU kernel is on this path: it checks the
   port's cuDNN/ATen path end to end;
8. the model-parallel API and the WMT encoder-decoder over NCCL in a
   fresh process group: (a) the WMT example's model, loss, schedule and
   ``make_train_step`` at Transformer-base widths (d_model 512, 8 heads,
   d_ff 2048, 6+6 layers, vocab 32768, 256-token source and target,
   batch 96) through the two-dimensional communicator on a bf16 wire:
   median step, tokens/s, peak memory, the step-0 loss near ln 32768 and
   one profiled step; then the example's ``main``; (b) the seq2seq
   example (``MultiNodeChainList``, encoder and decoder both on rank 0)
   at unit 1024, 2 layers, vocab 32768, 50 tokens, batch 64, in both
   parameter tiers, their losses within a stated tolerance, with the
   accuracy and BLEU.  No TPU kernel is on this path either;
9. the pipeline tier over NCCL in a fresh process group: (a) ViT-B/16
   (224 px, patch 16, d_model 768, 12 heads, d_ff 3072, 12 layers, 1000
   classes, bf16, batch 256 of a resident seeded batch) through
   ``create_multi_node_optimizer(AdamW, double_buffering=True)
   .make_train_step``: step 0 leaves the parameters as they are, step 1
   equals AdamW's first update on step 0's gradients; median step, img/s,
   peak memory, the model-FLOP count from the shapes and its share of the
   bf16 peak, one profiled step; (b) the ViT example
   (``examples/train_vit.py``) at full width in fp32, global batch 128 in
   4 microbatches: ``gpipe`` and ``1f1b`` with 12 layers a stage and
   ``1f1b --virtual-stages 2`` with 6, 4 steps each on the same weights
   and batches, their losses within a stated tolerance, each run's step,
   img/s and peak memory; (c) the parallel-convolution example
   (``examples/train_parallel_conv.py``) at its defaults, every loss
   finite.  No TPU kernel is on this path: the reference's ViTs run dense
   attention;
10. the sequence-parallel tier over NCCL in a fresh process group: (a)
   the long-context example (``examples/train_lm.py``) at phase 4's
   widths with S 16384 and batch 1 (``--sp none``, bf16): its ``main``
   once, then four variants (plain, ``--kv-heads 4``, ``--packed``,
   ``--window 4096``) for 4 steps each through its ``LongContextLM``,
   every loss finite, step 0 within 1.5 of ln V, each flash kernel
   launched 8 times a step (counts set to 0 before each run and read
   after), the median step, tokens/s, peak memory and one profiled step;
   (b) ``zigzag_ring_attention`` (its three flash half-blocks and the
   merge, 3 launches of each kernel) and ``ulysses_attention`` at world
   size 1 at (a)'s attention shapes (B 1, S 16384, H 16, D 128, bf16;
   also Hk 4) and ``ring_attention`` (dense blocks) at S 4096 in fp32, forward
   and the three gradients against ``flash_attention`` over the whole
   sequence within the bf16 compare limits; (c) ``vocab_parallel_embed``
   + ``vocab_parallel_cross_entropy`` at world size 1 (N 16384, V 32768,
   D 2048) against ``F.embedding`` + ``fused_cross_entropy``; (d)
   ``moe_layer`` with 8 experts on the card, top-2, capacity factor
   1.25, T 8192, D 2048, expert d_ff 8192, bf16, against
   ``dense_moe_oracle``, with its times.

Standard output ends with a JSON line ``{"train": ...}``, a JSON line
``{"dp_surface": ...}``, a JSON line ``{"imagenet": ...}``, a JSON line
``{"model_parallel": ...}``, a JSON line ``{"pipeline": ...}``, a JSON
line ``{"long_context": ...}``, the card's ``name, power.limit`` line, a
JSON line of per-kernel numbers, and ``{"ok": true, "device": {...}}``.
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


def build_lm(torch, log, zero_stage=0):
    """The full-width LM train step over NCCL at ``zero_stage``:
    ``(step, (tokens, labels), tokens per step)``."""
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
        comm, zero_stage=zero_stage,
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

    return opt.make_train_step(loss_fn), (tokens, labels), B * S


def phase_train(torch, K, log, n_warm, n_timed):
    step, batch, n_tokens = build_lm(torch, log)
    tokens, labels = batch
    V = FULL["vocab"]
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
    tok_s = n_tokens / med
    log(f"median step {med * 1e3:.1f} ms, {tok_s:.0f} tokens/s, peak "
        f"memory {peak / 2**30:.2f} GiB, losses {losses}")
    profile_step(torch, lambda: step((tokens, labels)), log)
    torch.distributed.destroy_process_group()
    return {"step_ms": med * 1e3, "tokens_per_s": tok_s,
            "peak_mem_gib": peak / 2**30, "launches": launches,
            "steps": steps, "losses": losses}


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


def profile_step(torch, run_step, log, top=14, top_other=10, what="step",
                 kind_of=None):
    """One more train step (or ``what``) under ``torch.profiler``: device
    time by kernel and by kind, and the device's idle share of the wall
    time; with the LM's :func:`kernel_kind` the ``other`` kind by family,
    by source and its largest kernels, with another ``kind_of`` the
    largest kernel of each kind.  Returns ``(wall ms, device busy ms, ms
    by kind)``."""
    kind_of = kind_of or kernel_kind
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
        kind = kind_of(key)
        kinds[kind] = kinds.get(kind, 0.0) + ms
        if kind == "other":
            low = key.lower()
            fam = next((f for f, words in OTHER_FAMILIES
                        if any(w in low for w in words)), "elementwise")
            families[fam] = families.get(fam, 0.0) + ms
    log(f"profile: {what} wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, "
        f"idle share {1 - busy / wall_ms:.3f}; by kind (ms): "
        + _ms_table(kinds))
    for ms, count, key in rows[:top]:
        log(f"profile:   {ms:9.2f} ms  x{count:<5d} {key[:90]}")
    if kind_of is not kernel_kind:
        for kind in sorted(kinds, key=lambda k: -kinds[k]):
            ms, count, key = next(r for r in rows if kind_of(r[2]) == kind)
            log(f"profile:   largest {kind}: {ms:.2f} ms x{count} {key[:120]}")
        return wall_ms, busy, kinds
    sources = {}
    for ev in prof.events():
        ks = [k for k in ev.kernels if kind_of(k.name) == "other"]
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
                           if kind_of(r[2]) == "other"][:top_other]:
        log(f"profile:   other {ms:9.2f} ms  x{count:<5d} {key[:160]}")
    return wall_ms, busy, kinds


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
# Phase 6: the rest of the data-parallel surface
# ---------------------------------------------------------------------------

MNIST_ACC = 0.99        # last-epoch val/accuracy of every run
ZERO_RTOL = 1e-5        # stages 1-3 against stage 0, each epoch's mean loss
LM_ZERO3_STEPS = 3
LM_ZERO3_ATOL = 1e-4    # ZeRO-3 LM losses against phase 4's


def run_mnist(log, argv, env=None):
    """``train_mnist.main(argv)`` in this process with ``env`` set for the
    run; its output goes to the log behind a ``|``.  Returns its result
    with the run's wall time."""
    import contextlib
    import io

    from chainermn_tpu_torch.examples import train_mnist

    env = env or {}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    buf = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = train_mnist.main(argv)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for line in buf.getvalue().splitlines():
            log("  | " + line)
    out["wall_s"] = time.perf_counter() - t
    return out


def phase_mnist(torch, log, card):
    """6a: the MNIST example at its defaults over NCCL, every variant."""
    import tempfile

    from chainermn_tpu_torch.global_except_hook import remove_hook

    base = ["--communicator", "pure_nccl"]
    plan = [
        ("zero0", [], None),
        ("zero1", ["--zero-stage", "1"], None),
        ("zero2", ["--zero-stage", "2"], None),
        ("zero3", ["--zero-stage", "3"], None),
        ("double_buffering", ["--double-buffering"], None),
        ("overlap_off", [], {"CHAINERMN_TPU_OVERLAP": "0"}),
        ("int8", ["--comm-dtype", "int8"], None),
        ("fp8", ["--comm-dtype", "fp8"], None),
    ]
    runs = {}
    for name, extra, env in plan:
        log(f"mnist {name}: {' '.join(base + extra)}"
            + (f" with {env}" if env else ""))
        runs[name] = run_mnist(log, base + extra, env)
    with tempfile.TemporaryDirectory() as tmp:
        ck = base + ["--checkpoint-dir", tmp, "--checkpoint-every", "10"]
        log(f"mnist stopped: {' '.join(ck)} --epochs 3")
        runs["stopped"] = run_mnist(log, ck + ["--epochs", "3"])
        log(f"mnist resumed: {' '.join(ck)} --epochs 5")
        runs["resumed"] = run_mnist(log, ck + ["--epochs", "5"])
    remove_hook()          # the checkpointed runs installed it
    wall, busy, _ = profile_step(
        torch, lambda: run_mnist(log, base + ["--epochs", "1"]), log,
        top=6, top_other=0, what="mnist run of 1 epoch (set-up included)")

    failed, summary = [], {}
    ref = runs["zero0"]
    log(f"mnist results on {card}:")
    for name, r in runs.items():
        acc = r["metrics"]["val/accuracy"]
        ips = sorted(r["img_per_s"])[len(r["img_per_s"]) // 2]
        mean = r["epoch_mean_losses"]
        summary[name] = {"accuracy": acc, "epoch_mean_losses": mean,
                         "digest": r["params_digest"], "img_per_s": ips,
                         "wire": r["wire"] or "full", "gstep": r["gstep"],
                         "wall_s": r["wall_s"]}
        line = (f"mnist {name}: val/accuracy {acc:.4f}, mean train loss by "
                f"epoch {' '.join(f'{x:.6g}' for x in mean)}, digest "
                f"{r['params_digest']}, {ips:,.0f} img/s (median epoch), "
                f"wire {summary[name]['wire']}, {r['wall_s']:.1f}s")
        if name != "stopped" and not acc >= MNIST_ACC:
            failed.append(f"{name} accuracy {acc} < {MNIST_ACC}")
        if name in ("zero1", "zero2", "zero3"):
            pairs = list(zip(mean, ref["epoch_mean_losses"]))
            rel = max(abs(a - b) / abs(b) if b else float(a != b)
                      for a, b in pairs)
            bitwise = (mean == ref["epoch_mean_losses"]
                       and r["params_digest"] == ref["params_digest"])
            summary[name].update(max_rel_vs_zero0=rel, bitwise=bitwise)
            line += f"; vs zero0 max rel {rel:.3g}, bitwise {bitwise}"
            if not all(abs(a - b) <= ZERO_RTOL * abs(b) for a, b in pairs):
                failed.append(f"{name} losses {rel} from zero0's")
        if name == "overlap_off":
            bitwise = (mean == ref["epoch_mean_losses"]
                       and r["params_digest"] == ref["params_digest"])
            summary[name]["bitwise"] = bitwise
            line += f"; bitwise equal to overlap on: {bitwise}"
            if not bitwise:
                failed.append("overlap off differs from overlap on")
        log(line)
    if runs["int8"]["wire"] != "int8":
        failed.append(f"int8 run took the {runs['int8']['wire']} wire")
    log(f"mnist fp8 wire taken: {runs['fp8']['wire']} (int8 is the fallback "
        "where the backend does not sum float8_e4m3fn)")
    stopped, resumed = runs["stopped"], runs["resumed"]
    log(f"mnist checkpoint: stopped at gstep {stopped['gstep']}, resumed "
        f"from iteration {resumed['resumed_from']}, digest "
        f"{resumed['params_digest']} against uninterrupted "
        f"{ref['params_digest']}")
    if stopped["resumed_from"] is not None or resumed["resumed_from"] is None:
        failed.append("the checkpointed rerun did not resume")
    if resumed["params_digest"] != ref["params_digest"]:
        failed.append("the resumed run's digest differs from the "
                      "uninterrupted run's")
    if resumed["gstep"] != ref["gstep"]:
        failed.append(f"resumed gstep {resumed['gstep']} != {ref['gstep']}")
    if failed:
        raise AssertionError("phase 6a: " + "; ".join(failed))
    summary["profile_1_epoch"] = {"wall_ms": wall, "busy_ms": busy,
                                  "idle_share": 1 - busy / wall}
    return summary


def phase_lm_zero3(torch, K, log, train):
    """6b: phase 4's model, data and seed under ZeRO-3, overlap on."""
    step, batch, n_tokens = build_lm(torch, log, zero_stage=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, times = [], []
    for i in range(LM_ZERO3_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(step(batch).item())
        times.append(time.perf_counter() - t)
        log(f"zero3 step {i}: loss {losses[-1]:.5f} {times[-1] * 1e3:.1f} ms")
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.distributed.destroy_process_group()
    med = sorted(times)[len(times) // 2] * 1e3
    want = train["losses"][:LM_ZERO3_STEPS]
    diff = max(abs(a - b) for a, b in zip(losses, want))
    bitwise = losses == want
    log(f"zero3 LM: launches {launches} over {LM_ZERO3_STEPS} steps; losses "
        f"{losses} against phase 4's {want}: max diff {diff:.3g}, bitwise "
        f"{bitwise}; median step {med:.1f} ms (phase 4 "
        f"{train['step_ms']:.1f}), peak {peak:.2f} GiB (phase 4 "
        f"{train['peak_mem_gib']:.2f})")
    failed = [f"{name} launched {launches[name]} times, not "
              f"{FULL['n_layers'] * LM_ZERO3_STEPS}" for name in KERNELS
              if launches[name] != FULL["n_layers"] * LM_ZERO3_STEPS]
    if not diff <= LM_ZERO3_ATOL:
        failed.append(f"losses {diff} from phase 4's")
    if failed:
        raise AssertionError("phase 6b: " + "; ".join(failed))
    return {"losses": losses, "phase4_losses": want, "max_diff": diff,
            "bitwise": bitwise, "step_ms": med, "peak_gib": peak,
            "phase4_step_ms": train["step_ms"],
            "phase4_peak_gib": train["peak_mem_gib"],
            "tokens_per_s": n_tokens / med * 1e3, "launches": launches}


# ---------------------------------------------------------------------------
# Phase 7: the ImageNet path
# ---------------------------------------------------------------------------

# bench.py::bench_resnet's step: ResNet-50, 1000 classes, 224 px, batch 256.
RESNET = dict(batch=256, image=224, classes=1000)
R_WARM, R_TIMED = 3, 10
R_LOSS0_WINDOW = 2.0        # step-0 loss within this of ln 1000
R_FLOPS_PER_IMAGE = 24.6e9  # 3 x 2 x ResNet-50's ~4.1 GMACs forward
# The example at full width: 3 steps an epoch, 768 training and 256
# validation images (an npz of seeded noise: the synthetic dataset's 1000
# class prototypes alone take seconds of host time to draw, each run).
EX_STEPS, EX_TRAIN, EX_VAL = 3, 768, 256
# A resumed run against the uninterrupted one: cuDNN's weight-gradient
# kernels and the max-pool backward may accumulate in another order from
# run to run, so the two runs' gradients may differ in their last bits; over 6 warm-up steps (lr at
# most 0.005) that moves no parameter tensor by more than RESUME_REL_L2 of
# its norm, nor a loss by more than RESUME_LOSS_ATOL.
RESUME_REL_L2, RESUME_LOSS_ATOL = 1e-4, 1e-3
CONVNET_STEPS = 3
# ZeRO-3 with state against 7a's steps 0-2: the same arithmetic, with the
# same non-deterministic gradient accumulation as above, after updates of
# lr 0.1.
Z3_STATE_STEPS, Z3_STATE_LOSS_ATOL = 3, 1e-3


def resnet_kind(name):
    """Kind of a kernel of the convnet steps, from its name."""
    low = name.lower()
    for kind, words in (
            ("nccl", ("nccl",)),
            ("copy", ("memcpy", "memset", "copy", "nchwtonhwc", "nhwctonchw")),
            ("conv (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "cudnn")),
            ("batch-norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
            ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
            ("optimizer", ("multi_tensor_apply", "foreach")),
            ("pooling", ("pool",)),
            ("reduction", ("reduce",))):
        if any(w in low for w in words):
            return kind
    return "elementwise"


def forward_macs(torch, model, image):
    """Multiply-adds of one image's forward, from the conv and dense
    shapes (a hook on each layer, one forward of a batch of one)."""
    from chainermn_tpu_torch.models.layers import Conv, Dense

    macs = [0]

    def hook(mod, inputs, out):
        macs[0] += out.numel() * mod.weight[0].numel()

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv, Dense))]
    try:
        with torch.no_grad():
            model(torch.zeros(1, image, image, 3, device="cuda"), train=False)
    finally:
        for h in handles:
            h.remove()
    return macs[0]


def resnet_batch(torch, input_dtype):
    """bench_resnet's resident batch: ``RandomState(0)`` fp32 ``randn``
    images (or uint8 ``randint``), then ``randint(0, 1000)`` labels."""
    import numpy as np

    n, s = RESNET["batch"], RESNET["image"]
    rng = np.random.RandomState(0)
    if input_dtype == "uint8":
        x = rng.randint(0, 256, size=(n, s, s, 3), dtype=np.uint8)
    else:
        x = rng.randn(n, s, s, 3).astype(np.float32)
    y = rng.randint(0, RESNET["classes"], size=n)
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def build_resnet(torch, comm, zero_stage=0, flax_layout=False):
    """bench_resnet's step through the port: ResNet-50 from seed 0, SGD lr
    0.1 momentum 0.9, ``make_train_step_with_state``; uint8 images are
    decoded on the device (x / 127.5 - 1 in bf16).  ``flax_layout``: the
    ZeRO buffer in the reference's leaf order and flax's layouts."""
    import torch.nn.functional as F

    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.convert import flax_flat_layout
    from chainermn_tpu_torch.models import ResNet50

    model = ResNet50(num_classes=RESNET["classes"], device="cuda", seed=0)
    params, layout = (flax_flat_layout(model) if flax_layout
                      else (list(model.parameters()), None))
    opt = create_multi_node_optimizer(
        torch.optim.SGD(params, lr=0.1, momentum=0.9), comm,
        zero_stage=zero_stage, flat_layout=layout)
    opt.init()

    def loss_fn(batch):
        x, y = batch
        if x.dtype == torch.uint8:
            x = x.to(torch.bfloat16) / 127.5 - 1.0
        return F.cross_entropy(model(x, train=True), y)

    return model, opt, opt.make_train_step_with_state(loss_fn, model)


def timed_steps(torch, step, batch, n_warm, n_timed):
    """``n_warm`` then ``n_timed`` steps back to back, no readback between
    them: per-step device time from CUDA events between the steps, wall
    time of the timed chain, and every loss (read once, at the end)."""
    losses = [step(batch) for _ in range(n_warm)]
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n_timed + 1)]
    t = time.perf_counter()
    marks[0].record()
    for i in range(n_timed):
        losses.append(step(batch))
        marks[i + 1].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / n_timed * 1e3
    ms = sorted(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))
    return ms[len(ms) // 2], wall, [x.item() for x in losses]


def phase_resnet(torch, log, card, comm):
    """7a: bench_resnet's step on fp32 and on uint8 input."""
    torch.backends.cudnn.benchmark = True
    out = {}
    batch32 = None
    for input_dtype in ("float32", "uint8"):
        batch = resnet_batch(torch, input_dtype)
        model, opt, step = build_resnet(torch, comm)
        flops = 3 * 2 * forward_macs(torch, model, RESNET["image"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        med, wall, losses = timed_steps(torch, step, batch, R_WARM, R_TIMED)
        peak = torch.cuda.max_memory_allocated() / 2**30
        ips = RESNET["batch"] / med * 1e3
        share = flops * RESNET["batch"] / (med / 1e3) / PEAK_BF16_FLOPS
        pwall, busy, kinds = profile_step(
            torch, lambda: step(batch), log, top=12,
            what=f"resnet50 {input_dtype} step", kind_of=resnet_kind)
        rec = {"step_ms": med, "chain_wall_ms_per_step": wall,
               "img_per_s": ips, "peak_gib": peak, "losses": losses,
               "flops_per_image": flops, "bf16_peak_share": share,
               "profile": {"wall_ms": pwall, "busy_ms": busy,
                           "idle_share": 1 - busy / pwall,
                           "ms_by_kind": kinds}}
        out[input_dtype] = rec
        log(f"resnet50 {input_dtype} on {card}: median step {med:.2f} ms "
            f"(chain wall {wall:.2f} ms/step), {ips:.1f} img/s, peak "
            f"{peak:.2f} GiB, step-0 loss {losses[0]:.5f}, losses "
            f"{' '.join(f'{x:.5f}' for x in losses)}; model FLOPs "
            f"{flops / 1e9:.2f} GFLOP/image, {share:.3f} of the bf16 peak; "
            f"profiled step idle share {1 - busy / pwall:.3f}")
        bad = []
        if not all(math.isfinite(x) for x in losses):
            bad.append(f"non-finite loss {losses}")
        if not abs(losses[0] - math.log(RESNET["classes"])) < R_LOSS0_WINDOW:
            bad.append(f"step-0 loss {losses[0]} far from ln 1000")
        if not abs(flops / R_FLOPS_PER_IMAGE - 1) < 0.1:
            bad.append(f"{flops:.3g} FLOP/image, not ~{R_FLOPS_PER_IMAGE:.3g}")
        if bad:
            raise AssertionError(f"phase 7a {input_dtype}: " + "; ".join(bad))
        if input_dtype == "float32":
            batch32 = batch
        del model, opt, step, batch
        torch.cuda.empty_cache()
    return out, batch32


def phase_zero3_state(torch, log, comm, batch, want, stage0_ms):
    """7d: 7a's model, data and seed under ZeRO-3, with state, with the
    flat buffer in the module's layouts (conv kernels OIHW) and in flax's
    (HWIO, the reference's shards; the conv kernels then views of a
    permuted slice): losses against 7a's, the BatchNorm buffers' mean over
    the ranks at world size 1, and each layout's median step against 7a's
    stage-0 step."""
    out = {"phase7a_step_ms": stage0_ms}
    failed = []
    for name, flax in (("torch_layout", False), ("flax_layout", True)):
        model, opt, step = build_resnet(torch, comm, zero_stage=3,
                                        flax_layout=flax)
        med, _, losses = timed_steps(torch, step, batch, R_WARM, R_TIMED)
        losses = losses[:Z3_STATE_STEPS]
        bufs = [b for b in model.buffers() if b.is_floating_point()]
        flat = torch.cat([b.reshape(-1) for b in bufs])
        moved = (comm.allreduce(flat, "mean") - flat).abs().max().item()
        ref = want[:Z3_STATE_STEPS]
        diff = max(abs(a - b) for a, b in zip(losses, ref))
        log(f"resnet50 zero3 with state, {name}: median step {med:.2f} ms "
            f"against 7a's {stage0_ms:.2f} ms ({med / stage0_ms:.4f}x); "
            f"losses {losses} against 7a's {ref}: max diff {diff:.3g} "
            f"(limit {Z3_STATE_LOSS_ATOL}), bitwise {losses == ref}; "
            f"BatchNorm buffers ({flat.numel()} values) moved {moved} by "
            f"their mean over {comm.size} rank(s)")
        if not diff <= Z3_STATE_LOSS_ATOL:
            failed.append(f"{name} losses {diff} from 7a's")
        out[name] = {"step_ms": med, "over_stage0": med / stage0_ms,
                     "losses": losses, "max_diff": diff,
                     "bitwise": losses == ref, "bn_mean_moved": moved,
                     "bn_values": flat.numel()}
        del model, opt, step
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("phase 7d: " + "; ".join(failed))
    return out


def phase_convnets(torch, log, comm, batch):
    """7c: AlexNet, NiN and GoogLeNet at 224 px, dropout on, on 7a's
    batch: a few steps each through ``make_train_step``."""
    import torch.nn.functional as F

    from chainermn_tpu_torch import create_multi_node_optimizer
    from chainermn_tpu_torch.examples.train_imagenet import dropout_seed
    from chainermn_tpu_torch.models import AlexNet, GoogLeNet, NiN

    out = {}
    for name, cls in (("alex", AlexNet), ("nin", NiN),
                      ("googlenet", GoogLeNet)):
        model = cls(num_classes=RESNET["classes"], device="cuda", seed=0)
        opt = create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9), comm)
        opt.init()
        rng = torch.Generator(device="cuda")
        step = opt.make_train_step(lambda b: F.cross_entropy(
            model(b[0], train=True, rng=rng), b[1]))
        losses, times = [], []
        for i in range(CONVNET_STEPS):
            rng.manual_seed(dropout_seed(i, comm.rank))
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(step(batch).item())
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = {"losses": losses, "step_ms": times}
        log(f"{name} (dropout on): losses {losses}, step ms "
            f"{' '.join(f'{x:.1f}' for x in times)}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"phase 7c: {name} non-finite loss {losses}")
        del model, opt, step
        torch.cuda.empty_cache()
    return out


def run_imagenet(log, argv):
    """``train_imagenet.main(argv)`` in this process, its output to the log
    behind a ``|``; returns its result with the run's wall time."""
    import contextlib
    import io

    from chainermn_tpu_torch.examples import train_imagenet

    buf = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = train_imagenet.main(argv)
    finally:
        for line in buf.getvalue().splitlines():
            log("  | " + line)
    out["wall_s"] = time.perf_counter() - t
    return out


def phase_imagenet_example(torch, log, card, tmp):
    """7b: the example at full width (ResNet-50, 1000 classes, 224 px,
    global batch 256) over NCCL: SGD, LARS, and a run stopped at a saved
    step and resumed, against the uninterrupted SGD run."""
    import numpy as np

    from chainermn_tpu_torch.global_except_hook import remove_hook

    rng = np.random.default_rng(0)
    s = RESNET["image"]
    npz = os.path.join(tmp, "imagenet.npz")
    np.savez(npz, images=rng.standard_normal((EX_TRAIN, s, s, 3),
                                             dtype=np.float32),
             labels=rng.integers(0, RESNET["classes"], EX_TRAIN,
                                 dtype=np.int32))
    base = ["--communicator", "pure_nccl", "--arch", "resnet50",
            "--batchsize", str(RESNET["batch"]), "--data-npz", npz,
            "--val-size", str(EX_VAL), "--steps", str(EX_STEPS)]
    ck = ["--checkpoint-dir", os.path.join(tmp, "ck"),
          "--checkpoint-every", str(EX_STEPS)]
    plan = [("sgd", ["--epochs", "2"]),
            ("lars", ["--optimizer", "lars", "--epochs", "1"]),
            ("stopped", ck + ["--epochs", "1"]),
            ("resumed", ck + ["--epochs", "2"])]
    runs = {}
    try:
        for name, extra in plan:
            log(f"imagenet example {name}: {' '.join(base + extra)}")
            runs[name] = run_imagenet(log, base + extra)
    finally:
        remove_hook()          # the checkpointed runs installed it
    failed, summary = [], {}
    for name, r in runs.items():
        losses = [x for epoch in r["step_losses"] for x in epoch]
        summary[name] = {"losses": losses, "gstep": r["gstep"],
                         "img_per_s": r["img_per_s"], "wall_s": r["wall_s"],
                         "metrics": r["metrics"]}
        log(f"imagenet {name} on {card}: gstep {r['gstep']}, losses "
            f"{' '.join(f'{x:.5f}' for x in losses)}, img/s by epoch "
            f"{' '.join(f'{x:.1f}' for x in r['img_per_s'])}, {r['metrics']}")
        if not losses or not all(math.isfinite(x) for x in losses):
            failed.append(f"{name} losses {losses}")
    whole, stopped, resumed = runs["sgd"], runs["stopped"], runs["resumed"]
    saved = stopped["saved_digests"].get(EX_STEPS)
    loaded_ok = saved is not None and resumed["loaded_digest"] == saved
    rel = max(((a - b).norm() / b.norm().clamp_min(1e-30)).item()
              for a, b in zip(resumed["model"].parameters(),
                              whole["model"].parameters()))
    loss_diff = max(abs(a - b) for a, b in zip(
        resumed["step_losses"][-1], whole["step_losses"][-1]))
    summary["resume"] = {
        "resumed_from": resumed["resumed_from"], "loaded_equals_saved":
        loaded_ok, "saved_digest": saved,
        "loaded_digest": resumed["loaded_digest"],
        "param_rel_l2_vs_uninterrupted": rel,
        "epoch1_loss_diff": loss_diff,
        "bitwise": resumed["params_digest"] == whole["params_digest"]}
    log(f"imagenet checkpoint: stopped at gstep {stopped['gstep']} (saved "
        f"{sorted(stopped['saved_digests'])}), resumed from "
        f"{resumed['resumed_from']}; loaded state crc32 "
        f"{resumed['loaded_digest']} against saved {saved}: equal "
        f"{loaded_ok}; against the uninterrupted run: worst parameter "
        f"relative L2 {rel:.3g} (limit {RESUME_REL_L2}), epoch-1 loss diff "
        f"{loss_diff:.3g} (limit {RESUME_LOSS_ATOL}), bitwise "
        f"{summary['resume']['bitwise']}")
    if resumed["resumed_from"] != EX_STEPS or not loaded_ok:
        failed.append("the resumed run did not load the saved state")
    if resumed["gstep"] != whole["gstep"]:
        failed.append(f"resumed gstep {resumed['gstep']} != {whole['gstep']}")
    if not (rel <= RESUME_REL_L2 and loss_diff <= RESUME_LOSS_ATOL):
        failed.append(f"resumed run {rel}, {loss_diff} from uninterrupted")
    del runs
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("phase 7b: " + "; ".join(failed))
    return summary


def phase_imagenet(torch, log, card):
    """Phase 7: 7a, 7d (which reuses 7a's batch), 7c, then 7b."""
    import tempfile

    from chainermn_tpu_torch import create_communicator

    comm = create_communicator("pure_nccl", device="cuda")
    if torch.distributed.get_backend() != "nccl":
        raise AssertionError("expected NCCL")
    t0 = time.perf_counter()
    out = {"card": card}
    out["resnet50"], batch = phase_resnet(torch, log, card, comm)
    out["zero3_state"] = phase_zero3_state(
        torch, log, comm, batch, out["resnet50"]["float32"]["losses"],
        out["resnet50"]["float32"]["step_ms"])
    out["convnets"] = phase_convnets(torch, log, comm, batch)
    del batch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out["example"] = phase_imagenet_example(torch, log, card, tmp)
    torch.distributed.destroy_process_group()
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 7: {out['wall_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# Phase 8: the model-parallel API and the WMT encoder-decoder
# ---------------------------------------------------------------------------

# Transformer-base (Vaswani et al. 2017): d_model 512, 8 heads, d_ff 2048,
# 6+6 layers; tensor2tensor's translate_ende_wmt32k shared vocabulary;
# 256-token source and target; batch 96 (about 25k source tokens).
WMT = ["--d-model", "512", "--n-heads", "8", "--d-ff", "2048", "--layers",
       "6", "--vocab", "32768", "--seq-len", "256", "--batchsize", "96"]
W_WARM, W_TIMED, W_BATCHES = 2, 10, 12
W_LOSS0_WINDOW = 1.5        # step-0 loss within this of ln 32768
# The seq2seq example at full width: Chainer's seq2seq unit, the
# reference's 2 layers, a 32k vocabulary, 50-token sentences, 10 steps.
S2S = ["--unit", "1024", "--vocab", "32768", "--seq-len", "50",
       "--batchsize", "64", "--train-size", "640", "--epochs", "1"]
# Its two parameter tiers run the same operations on the same values (the
# sharded one on views of a flat fp32 row, Adam over that row): every
# loss within this relative distance.
S2S_TIER_RTOL = 1e-5


def wmt_kind(name):
    """Kind of a kernel of the WMT step, from its name."""
    low = name.lower()
    for kind, words in (
            ("nccl", ("nccl",)),
            ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
            ("softmax", ("softmax",)),
            ("layernorm", ("layer_norm", "layernorm", "gammabeta")),
            ("optimizer (AdamW)", ("multi_tensor_apply", "foreach")),
            ("copy (casts, layouts)", ("copy",)),
            ("reduce", ("reduce",)),
            ("embedding, index", ("embedding", "index", "gather",
                                  "scatter"))):
        if any(w in low for w in words):
            return kind
    return "elementwise"


def phase_wmt(torch, log, card, ex):
    """8a: the WMT example's model, loss, schedule and ``make_train_step``
    at Transformer-base widths over the two-dimensional communicator
    (bf16 wire), timed and profiled; then its ``main``."""
    import contextlib
    import io

    from chainermn_tpu_torch.datasets.toy import SyntheticSeqDataset

    args = ex.parser().parse_args(WMT + ["--device", "cuda"])
    comm = ex.make_communicator(args)
    if torch.distributed.get_backend() != "nccl":
        raise AssertionError("expected NCCL")
    t0 = time.perf_counter()
    model = ex.make_model(args, comm.device)
    n_params = sum(p.numel() for p in model.parameters())
    opt = ex.make_optimizer(model, comm, args, args.train_size)
    step = opt.make_train_step(ex.make_loss_fn(model))
    data = SyntheticSeqDataset(n=args.batchsize * W_BATCHES,
                               src_len=args.seq_len, tgt_len=args.seq_len,
                               vocab=args.vocab)
    batches = [(torch.from_numpy(data.src[i:i + args.batchsize]).long()
                .cuda(), torch.from_numpy(data.tgt[i:i + args.batchsize])
                .long().cuda())
               for i in range(0, len(data), args.batchsize)]
    n_tok = batches[0][0].numel() + batches[0][1].numel()
    log(f"wmt transformer {n_params / 1e6:.1f}M params on {card}, "
        f"{comm!r}, wire {comm.allreduce_grad_dtype}; set-up "
        f"{time.perf_counter() - t0:.1f}s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(b) for b in batches[:W_WARM]]
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(W_TIMED + 1)]
    marks[0].record()
    for i, b in enumerate(batches[W_WARM:W_WARM + W_TIMED]):
        losses.append(step(b))
        marks[i + 1].record()
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))
    med = ms[len(ms) // 2]
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [x.item() for x in losses]
    tok_s = n_tok / med * 1e3
    pwall, busy, kinds = profile_step(
        torch, lambda: step(batches[0]), log, top=12,
        what="wmt transformer step", kind_of=wmt_kind)
    log(f"wmt transformer on {card}: median step {med:.2f} ms, "
        f"{tok_s:.0f} tokens/s (src + tgt, {n_tok} a step), peak "
        f"{peak:.2f} GiB, step-0 loss {losses[0]:.5f} (ln V = "
        f"{math.log(args.vocab):.3f}), losses "
        f"{' '.join(f'{x:.5f}' for x in losses)}; profiled step idle "
        f"share {1 - busy / pwall:.3f}")
    bad = []
    if not all(math.isfinite(x) for x in losses):
        bad.append(f"non-finite loss {losses}")
    if not abs(losses[0] - math.log(args.vocab)) < W_LOSS0_WINDOW:
        bad.append(f"step-0 loss {losses[0]} far from ln V")
    del model, opt, step, batches
    torch.cuda.empty_cache()
    argv = WMT + ["--device", "cuda", "--epochs", "1", "--steps", "3",
                  "--train-size", str(3 * 96)]
    log(f"wmt example: {' '.join(argv)}")
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main_loss = ex.main(argv)
    for line in buf.getvalue().splitlines():
        log("  | " + line)
    log(f"wmt example main: last loss {main_loss:.5f}, "
        f"{time.perf_counter() - t:.1f}s")
    if not math.isfinite(main_loss):
        bad.append(f"main's loss {main_loss}")
    if bad:
        raise AssertionError("phase 8a: " + "; ".join(bad))
    torch.cuda.empty_cache()
    return {"step_ms": med, "tokens_per_s": tok_s, "tokens_per_step": n_tok,
            "peak_gib": peak, "losses": losses, "params": n_params,
            "profile": {"wall_ms": pwall, "busy_ms": busy,
                        "idle_share": 1 - busy / pwall, "ms_by_kind": kinds},
            "main_loss": main_loss}


def phase_seq2seq(torch, log, card):
    """8b: the seq2seq example at full width through ``MultiNodeChainList``
    at world size 1 (encoder and decoder both on rank 0: every transfer
    a local pass-through), in both parameter tiers."""
    import contextlib
    import io

    from chainermn_tpu_torch.examples import seq2seq as ex

    out = {}
    for tier, extra in (("replicated", []), ("sharded", ["--sharded-params"])):
        argv = S2S + ["--communicator", "pure_nccl", "--device", "cuda"]
        argv += extra
        log(f"seq2seq example {tier}: {' '.join(argv)}")
        buf = io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = ex.run(ex.parser().parse_args(argv))
        wall = time.perf_counter() - t
        for line in buf.getvalue().splitlines():
            log("  | " + line)
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[tier] = {"losses": res["losses"], "accuracy": res["accuracy"],
                     "bleu": res["bleu"], "wall_s": wall, "peak_gib": peak}
        log(f"seq2seq {tier} on {card}: losses "
            f"{' '.join(f'{x:.5f}' for x in res['losses'])}; accuracy "
            f"{res['accuracy']:.4f}, BLEU {res['bleu'] * 100:.2f}; "
            f"{wall:.1f}s with evaluation, peak {peak:.2f} GiB")
        del res
        torch.cuda.empty_cache()
    rep, shd = out["replicated"]["losses"], out["sharded"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(shd, rep))
    out["tier_max_rel_diff"] = rel
    log(f"seq2seq tiers: worst relative loss difference {rel:.3g} (limit "
        f"{S2S_TIER_RTOL}), bitwise {shd == rep}")
    bad = []
    for tier in ("replicated", "sharded"):
        if len(out[tier]["losses"]) != 10 or not all(
                math.isfinite(x) for x in out[tier]["losses"]):
            bad.append(f"{tier} losses {out[tier]['losses']}")
    if not rel <= S2S_TIER_RTOL:
        bad.append(f"tiers {rel} apart")
    if bad:
        raise AssertionError("phase 8b: " + "; ".join(bad))
    return out


def phase_model_parallel(torch, log, card):
    """Phase 8: 8a then 8b in a fresh NCCL process group."""
    from chainermn_tpu_torch.examples import train_transformer as ex

    t0 = time.perf_counter()
    out = {"card": card, "wmt": phase_wmt(torch, log, card, ex),
           "seq2seq": phase_seq2seq(torch, log, card)}
    torch.distributed.destroy_process_group()
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 8: {out['wall_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# Phase 9: the pipeline tier, ViT-B/16 and the parallel-convolution example
# ---------------------------------------------------------------------------

# ViT-B/16 (Dosovitskiy et al. 2021): 224 px, patch 16, d_model 768, 12
# heads, d_ff 3072, 12 layers, 1000 classes; bf16, batch 256.
VIT_BATCH, VIT_WARM, VIT_TIMED = 256, 2, 8
# The ViT example at full width in fp32 (the reference example's dtype),
# global batch 128 in 4 microbatches, 4 steps a run (the first untimed).
VIT_EX = ["--image-size", "224", "--patch", "16", "--d-model", "768",
          "--n-heads", "12", "--d-ff", "3072", "--n-classes", "1000",
          "--batchsize", "128", "--microbatches", "4", "--epochs", "1"]
VIT_EX_RUNS = {
    "gpipe": ["--schedule", "gpipe", "--layers-per-stage", "12"],
    "1f1b": ["--schedule", "1f1b", "--layers-per-stage", "12"],
    "1f1b_v2": ["--schedule", "1f1b", "--virtual-stages", "2",
                "--layers-per-stage", "6"],
}
VIT_EX_STEPS = 4
# At world size 1 the three runs hold the same weights (each global layer
# from its own seed) and compute the same fp32 gradients, summed in other
# orders (GPipe's loss over the batch against 1F1B's mean of microbatch
# losses; microbatch gradients accumulated in reverse against forward
# order); AdamW (lr 1e-3) normalises each element's step, so an element
# whose gradient cancels to its rounding error can step by a fraction of
# lr: every loss within this relative distance of GPipe's.
VIT_EX_LOSS_RTOL = 1e-4


def vit_forward_flops(image=224, patch=16, d=768, d_ff=3072, layers=12,
                      classes=1000):
    """Model FLOPs of one ViT image forward, from the shapes (a multiply-
    add is 2): the patchify conv, per layer the four projections, the two
    attention products and the MLP, then the head."""
    p = (image // patch) ** 2
    t = p + 1
    conv = 2 * p * d * patch * patch * 3
    layer = 2 * t * d * d * 4 + 2 * t * t * d * 2 + 2 * t * d * d_ff * 2
    return conv + layers * layer + 2 * d * classes


def vit_kind(name):
    low = name.lower()
    if "conv" in low and "nccl" not in low:
        return "conv"
    return wmt_kind(name)


def phase_vit_model(torch, log, card, comm):
    """9a: ViT-B/16 through the multi-node optimizer with double
    buffering: step 0 applies nothing, step 1 applies AdamW to step 0's
    gradients; then timed and profiled steps."""
    import torch.nn.functional as F

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.models.vit import ViT_B16

    t0 = time.perf_counter()
    model = ViT_B16(device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    lr, wd = 1e-3, 0.01
    opt = cmn.create_multi_node_optimizer(
        torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=wd),
        comm, double_buffering=True)
    opt.init()
    step = opt.make_train_step(
        lambda b: F.cross_entropy(model(b[0]), b[1]))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = (torch.randn(VIT_BATCH, 224, 224, 3, device="cuda",
                         generator=gen),
             torch.randint(0, 1000, (VIT_BATCH,), device="cuda",
                           generator=gen))
    log(f"vit-b/16 {n_params / 1e6:.2f}M params on {card}, {comm!r}, bf16, "
        f"batch {VIT_BATCH}; set-up {time.perf_counter() - t0:.1f}s")
    bad = []
    params = list(model.parameters())
    before = [p.detach().clone() for p in params]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(batch)]
    if not all(torch.equal(a, p) for a, p in zip(before, params)):
        bad.append("step 0 moved the parameters")
    # Step 1 must apply AdamW's first update to step 0's gradients.
    stale = [g.detach().clone() for g in opt._stale]
    want = [p.detach().clone().requires_grad_() for p in params]
    ref = torch.optim.AdamW(want, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=wd)
    for w, g in zip(want, stale):
        w.grad = g
    ref.step()
    losses.append(step(batch))
    err = max(float((w - p).detach().abs().max())
              for w, p in zip(want, params))
    del want, ref, stale, before
    if not err <= 1e-6:
        bad.append(f"step 1 is not AdamW on step 0's gradients ({err})")
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(VIT_TIMED + 1)]
    marks[0].record()
    for i in range(VIT_TIMED):
        losses.append(step(batch))
        marks[i + 1].record()
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))
    med = ms[len(ms) // 2]
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [x.item() for x in losses]
    fwd = vit_forward_flops()
    share = 3 * fwd * VIT_BATCH / (med * 1e-3) / PEAK_BF16_FLOPS
    pwall, busy, kinds = profile_step(
        torch, lambda: step(batch), log, top=12, what="vit-b/16 step",
        kind_of=vit_kind)
    log(f"vit-b/16 on {card}: median step {med:.2f} ms, "
        f"{VIT_BATCH / med * 1e3:.0f} img/s, peak {peak:.2f} GiB; "
        f"{fwd / 1e9:.2f} GFLOP an image forward, {3 * fwd / 1e9:.2f} train, "
        f"{share:.3f} of the bf16 peak; step 1 vs AdamW on step 0's "
        f"gradients {err:.3g}; losses {' '.join(f'{x:.5f}' for x in losses)}"
        f"; profiled step idle share {1 - busy / pwall:.3f}")
    if not all(math.isfinite(x) for x in losses):
        bad.append(f"non-finite loss {losses}")
    if not abs(losses[0] - math.log(1000)) < 2.0:
        bad.append(f"step-0 loss {losses[0]} far from ln 1000")
    if bad:
        raise AssertionError("phase 9a: " + "; ".join(bad))
    del model, opt, step, batch, params
    torch.cuda.empty_cache()
    return {"step_ms": med, "img_per_s": VIT_BATCH / med * 1e3,
            "peak_gib": peak, "params": n_params,
            "gflop_forward": fwd / 1e9, "bf16_peak_share": share,
            "step1_err": err, "losses": losses,
            "profile": {"wall_ms": pwall, "busy_ms": busy,
                        "idle_share": 1 - busy / pwall, "ms_by_kind": kinds}}


def phase_vit_example(torch, log, card, comm):
    """9b: the ViT example at full width, three schedules at world size
    1 on the same weights and device-resident batches."""
    from chainermn_tpu_torch.datasets.toy import batch_iterator
    from chainermn_tpu_torch.examples import train_vit as ex

    log("vit example fp32 matmuls: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}, float32_matmul_precision="
        f"{torch.get_float32_matmul_precision()} (full fp32; set once at "
        "the start of this script)")
    base = VIT_EX + ["--device", "cuda", "--train-size",
                     str(128 * VIT_EX_STEPS)]
    t = time.perf_counter()
    args = ex.parser().parse_args(base + VIT_EX_RUNS["gpipe"])
    batches = [(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
               for x, y in batch_iterator(ex.training_set(args), 128, seed=0)]
    log(f"vit example data: {len(batches)} batches of 128 at 224 px on the "
        f"card, {time.perf_counter() - t:.1f}s")
    out, bad = {}, []
    for name, extra in VIT_EX_RUNS.items():
        argv = base + extra
        args = ex.parser().parse_args(argv)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        run = ex.ViTPipeline(args, comm)
        losses = [run.step(*batches[0])]
        torch.cuda.synchronize()
        first = time.perf_counter() - t
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(len(batches))]
        marks[0].record()
        for i, b in enumerate(batches[1:]):
            losses.append(run.step(*b))
            marks[i + 1].record()
        torch.cuda.synchronize()
        ms = sorted(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))
        med = ms[len(ms) // 2]
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [float(x) for x in losses]
        out[name] = {"argv": argv, "losses": losses, "step_ms": med,
                     "img_per_s": 128 / med * 1e3, "peak_gib": peak,
                     "first_step_s": first}
        log(f"vit example {name} on {card}: {' '.join(extra)}; median step "
            f"{med:.1f} ms, {128 / med * 1e3:.0f} img/s, peak {peak:.2f} GiB, "
            f"first step {first:.1f}s; losses "
            f"{' '.join(f'{x:.6f}' for x in losses)}")
        if not all(math.isfinite(x) for x in losses):
            bad.append(f"{name}: non-finite loss {losses}")
        del run
        torch.cuda.empty_cache()
    want = out["gpipe"]["losses"]
    for name in ("1f1b", "1f1b_v2"):
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(out[name]["losses"], want))
        out[name]["max_rel_loss_diff_vs_gpipe"] = rel
        log(f"vit example {name} vs gpipe: worst relative loss difference "
            f"{rel:.3g} (limit {VIT_EX_LOSS_RTOL})")
        if not rel <= VIT_EX_LOSS_RTOL:
            bad.append(f"{name} losses {rel} from gpipe's")
    if bad:
        raise AssertionError("phase 9b: " + "; ".join(bad))
    return out


def phase_parallel_conv(torch, log, card):
    """9c: the parallel-convolution example at its defaults: its ``main``,
    and its net and step with every loss kept."""
    import contextlib
    import io

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.datasets.toy import batch_iterator
    from chainermn_tpu_torch.examples import train_parallel_conv as ex

    t = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main_loss = ex.main(["--device", "cuda"])
    for line in buf.getvalue().splitlines():
        log("  | " + line)
    args = ex.parser().parse_args(["--device", "cuda"])
    comm = cmn.create_communicator(args.communicator, device="cuda")
    model = ex.make_model(args, comm)
    step = ex.make_step(model, comm)
    train = ex.training_set(args)
    losses = [float(step(x, y)) for epoch in range(args.epochs)
              for x, y in batch_iterator(train, args.batchsize, seed=epoch)]
    wall = time.perf_counter() - t
    log(f"parallel conv on {card}: main's last loss {main_loss:.5f}; "
        f"{len(losses)} losses {losses[0]:.5f} ... {losses[-1]:.5f}; "
        f"{wall:.1f}s")
    if not (math.isfinite(main_loss) and all(map(math.isfinite, losses))):
        raise AssertionError(f"phase 9c: non-finite loss {losses}")
    return {"main_loss": main_loss, "losses": losses, "wall_s": wall}


def phase_pipeline(torch, log, card):
    """Phase 9: 9a, 9b and 9c in a fresh NCCL process group."""
    import chainermn_tpu_torch as cmn

    t0 = time.perf_counter()
    comm = cmn.create_communicator("xla_ici", device="cuda")
    if torch.distributed.get_backend() != "nccl":
        raise AssertionError("expected NCCL")
    out = {"card": card, "vit_b16": phase_vit_model(torch, log, card, comm),
           "vit_example": phase_vit_example(torch, log, card, comm),
           "parallel_conv": phase_parallel_conv(torch, log, card)}
    torch.distributed.destroy_process_group()
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 9: {out['wall_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# Phase 10: the long-context example and the sequence-parallel tier
# ---------------------------------------------------------------------------

# Phase 4's model at S 16384 (four times phase 4's sequence), one sequence.
LC = ["--vocab", "32768", "--d-model", "2048", "--n-heads", "16",
      "--d-ff", "8192", "--layers", "8", "--seq-len", "16384",
      "--batchsize", "1", "--dtype", "bfloat16", "--sp", "none",
      "--epochs", "1", "--steps-per-epoch", "4", "--device", "cuda"]
LC_VARIANTS = {"plain": [], "kv_heads4": ["--kv-heads", "4"],
               "packed": ["--packed"], "window4096": ["--window", "4096"]}
LC_STEPS, LC_LAYERS = 4, 8
# 10b/10c/10d shapes: (a)'s attention, its head, and an MoE FFN.
SP_SHAPE = dict(B=1, S=16384, H=16, D=128)
RING_S = 4096
VP = dict(N=16384, V=32768, D=2048)
MOE = dict(T=8192, D=2048, d_ff=8192, E=8, k=2, capacity_factor=1.25)
# The layer and the oracle run the same products on the same operands
# (the all-to-alls of one rank are copies), so they should agree exactly;
# the limit allows one bf16 ulp of an O(1) output.
MOE_ATOL = 2 ** -7


def _within(torch, a, b, tol):
    """(max abs error, worst element's share of ``atol + rtol |b|``, worst
    tile's ||a - b|| / ||b|| over tiles of TILE positions along dim 1)."""
    a, b = a.float(), b.float()
    d = (a - b).abs()
    share = (d / (tol["atol"] + tol["rtol"] * b.abs())).max().item()
    dims = tuple(i for i in range(a.dim()) if i != 1)
    norm = torch.linalg.vector_norm
    tile = max((norm(dt, dim=dims) / norm(bt, dim=dims).clamp_min(1e-30))
               .max().item()
               for dt, bt in zip(d.split(TILE, dim=1), b.split(TILE, dim=1)))
    return d.max().item(), share, tile


def phase_lc_example(torch, K, log, card, comm):
    """10a: the example's ``main(argv)`` once, then each variant through
    its ``LongContextLM`` and ``data_stream``: losses, launches, median
    step, tokens/s, peak memory and one profiled step."""
    import contextlib
    import io

    from chainermn_tpu_torch.examples import train_lm as ex

    V = int(LC[LC.index("--vocab") + 1])
    S = int(LC[LC.index("--seq-len") + 1])
    want = LC_LAYERS * LC_STEPS
    bad = []
    K.reset_launch_counts()
    t = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main_loss = ex.main(LC)
    launches = dict(K.LAUNCHES)
    for line in buf.getvalue().splitlines():
        log("  | " + line)
    log(f"long-context main: last loss {main_loss:.5f}, launches {launches} "
        f"(want {want} each), {time.perf_counter() - t:.1f}s")
    if not math.isfinite(main_loss):
        bad.append(f"main: non-finite loss {main_loss}")
    bad += [f"main: {k} launched {n} times, not {want}"
            for k, n in launches.items() if n != want]
    out = {"main": {"argv": LC, "last_loss": main_loss,
                    "launches": launches}}
    for name, extra in LC_VARIANTS.items():
        args = ex.parser().parse_args(LC + extra)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        run = ex.LongContextLM(args, comm)
        n_params = sum(p.numel() for p in run.model.parameters())
        build_s = time.perf_counter() - t
        stream = ex.data_stream(args, run.seq_perm)
        K.reset_launch_counts()
        losses, times = [], []
        for _ in range(LC_STEPS):
            tok, tgt = next(stream)
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(run.step(tok, tgt).item())
            times.append((time.perf_counter() - t) * 1e3)
        launches = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        med = sorted(times[1:])[len(times[1:]) // 2]
        log(f"long-context {name} on {card}: {' '.join(extra) or 'plain'}; "
            f"{n_params / 1e6:.1f}M params (built in {build_s:.1f}s); "
            f"median step {med:.1f} ms, {S / med * 1e3:.0f} tokens/s, peak "
            f"{peak:.2f} GiB; first step {times[0]:.0f} ms; launches "
            f"{launches}; losses {' '.join(f'{x:.5f}' for x in losses)}")
        if not all(math.isfinite(x) for x in losses):
            bad.append(f"{name}: non-finite loss {losses}")
        if not abs(losses[0] - math.log(V)) < 1.5:
            bad.append(f"{name}: step-0 loss {losses[0]} far from ln V")
        bad += [f"{name}: {k} launched {n} times, not {want}"
                for k, n in launches.items() if n != want]
        pwall, busy, kinds = profile_step(
            torch, lambda: run.step(*next(stream)), log,
            what=f"long-context {name} step")
        out[name] = {"argv": LC + extra, "params": n_params,
                     "losses": losses, "step_ms": med,
                     "tokens_per_s": S / med * 1e3, "peak_gib": peak,
                     "launches": launches,
                     "profile": {"wall_ms": pwall, "busy_ms": busy,
                                 "idle_share": 1 - busy / pwall,
                                 "ms_by_kind": kinds}}
        del run, stream
    if bad:
        raise AssertionError("phase 10a: " + "; ".join(bad))
    return out


def _attention_case(torch, Hk, S, seed, dtype):
    g = torch.Generator().manual_seed(seed)
    B, H, D = SP_SHAPE["B"], SP_SHAPE["H"], SP_SHAPE["D"]

    def rnd(h):
        return torch.randn(B, S, h, D, generator=g).to("cuda", dtype)

    return rnd(H), rnd(Hk), rnd(Hk), rnd(H)


def _fwd_bwd(torch, fn, q, k, v, do):
    qkv = [x.detach().requires_grad_() for x in (q, k, v)]
    o = fn(*qkv)
    return (o.detach(),) + torch.autograd.grad(o, qkv, do)


def phase_sp_functions(torch, K, log, comm):
    """10b: the zigzag ring (its three kernel half-blocks and the merge)
    and Ulysses at world size 1 in bf16, and the dense ring in fp32 (its
    blocks compute in fp32 whatever the input: in bf16 the kernel's
    rounding of P and dS dominates the comparison where dQ cancels),
    forward and the three gradients against ``flash_attention`` over the
    whole sequence."""
    from chainermn_tpu_torch.ops.flash_attention import flash_attention
    from chainermn_tpu_torch.parallel import ring_attention as ra
    from chainermn_tpu_torch.parallel.ulysses import ulysses_attention

    S = SP_SHAPE["S"]
    whole = lambda q, k, v: flash_attention(q, k, v, causal=True)  # noqa
    fns = {"zigzag": lambda q, k, v: ra.zigzag_ring_attention(q, k, v, comm),
           "ulysses": lambda q, k, v: ulysses_attention(q, k, v, comm)}
    want_launches = {"zigzag": 3, "ulysses": 1}
    out, bad = {}, []
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(name, Hk, S, bf) for Hk in (SP_SHAPE["H"], 4) for name in fns]
    cases.append(("ring", SP_SHAPE["H"], RING_S, f32))
    fns["ring"] = lambda q, k, v: ra.ring_attention(q, k, v, comm)
    want_launches["ring"] = 0
    for i, (name, Hk, S_, dtype) in enumerate(cases):
        tol = TOL[str(dtype)[6:]]
        q, k, v, do = _attention_case(torch, Hk, S_, 200 + i, dtype)
        ref = _fwd_bwd(torch, whole, q, k, v, do)
        K.reset_launch_counts()
        got = _fwd_bwd(torch, fns[name], q, k, v, do)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        rep, errs = [], {}
        for part, a, b in zip(("o", "dq", "dk", "dv"), got, ref):
            err, share, tile = _within(torch, a, b, tol)
            errs[part] = err
            rep.append(f"{part} {err:.3g} ({share:.2f} of limit, tile "
                       f"{tile:.2g})")
            if not (share <= 1.0 and tile <= tol["tile_l2"]):
                bad.append(f"{name} {dtype} Hk={Hk} {part}")
        ms = time_ms(torch, lambda: _fwd_bwd(torch, fns[name], q, k, v, do),
                     3)
        ref_ms = time_ms(torch, lambda: _fwd_bwd(torch, whole, q, k, v, do),
                         3)
        tag = f"{name} {str(dtype)[6:]} Hk={Hk} S={S_}"
        log(f"sp {tag}: {'; '.join(rep)}; launches {launches} (want "
            f"{want_launches[name]} each); fwd+bwd {ms:.2f} ms against "
            f"whole-sequence flash {ref_ms:.2f} ms")
        if any(n != want_launches[name] for n in launches.values()):
            bad.append(f"{tag} launches {launches}")
        out[tag] = {"errors": errs, "launches": launches, "ms": ms,
                    "flash_ms": ref_ms}
        del q, k, v, do, ref, got
    for dt, t in TOL.items():
        log(f"sp limits {dt}: |a-b| <= {t['atol']} + {t['rtol']}*|b| per "
            f"element, ||a-b||/||b|| <= {t['tile_l2']} per {TILE} positions "
            "(all heads)")
    if bad:
        raise AssertionError("phase 10b: " + "; ".join(bad))
    return out


def phase_vocab_parallel(torch, log, comm):
    """10c: ``vocab_parallel_embed`` + ``vocab_parallel_cross_entropy`` at
    world size 1 against ``F.embedding`` + ``fused_cross_entropy``."""
    import torch.nn.functional as F

    from chainermn_tpu_torch.ops.fused_ce import fused_cross_entropy
    from chainermn_tpu_torch.parallel import sharding

    N, V, D = VP["N"], VP["V"], VP["D"]
    g = torch.Generator().manual_seed(300)
    emb0 = (torch.randn(V, D, generator=g) * D ** -0.5).cuda()
    toks = torch.randint(0, V, (1, N), generator=g).cuda()
    labels = torch.randint(0, V, (N,), generator=g)
    labels[::7] = -1                               # ignored positions
    labels = labels.cuda()

    def vocab_tp(e):
        x = sharding.vocab_parallel_embed(toks, e, comm, True)
        return sharding.vocab_parallel_cross_entropy(
            x.to(torch.bfloat16), e, labels, comm)

    def dense(e):
        x = F.embedding(toks, e)
        return fused_cross_entropy(x.to(torch.bfloat16), e, labels)

    res = {}
    for name, fn in (("vocab_tp", vocab_tp), ("dense", dense)):
        e = emb0.clone().requires_grad_()
        loss = fn(e)
        (ge,) = torch.autograd.grad(loss, [e])
        ms = time_ms(torch, lambda: torch.autograd.grad(
            fn(e), [e]), 3)
        res[name] = (loss.item(), ge, ms)
    (lv, gv, msv), (ld, gd, msd) = res["vocab_tp"], res["dense"]
    rel = ((gv - gd).norm() / gd.norm()).item()
    log(f"vocab parallel (world 1, N={N} V={V} D={D}): loss {lv:.6f} vs "
        f"{ld:.6f}, table gradient relative l2 {rel:.3g} (limit 1e-6); "
        f"fwd+bwd {msv:.2f} ms vs {msd:.2f} ms")
    if not (abs(lv - ld) <= 1e-6 * abs(ld) and rel <= 1e-6):
        raise AssertionError(f"phase 10c: loss {lv} vs {ld}, grad {rel}")
    return {"loss": lv, "dense_loss": ld, "grad_rel_l2": rel, "ms": msv,
            "dense_ms": msd}


def phase_moe(torch, log, comm):
    """10d: ``moe_layer`` with every expert on the card against
    ``dense_moe_oracle``; its forward and forward + backward times."""
    import torch.nn.functional as F

    from chainermn_tpu_torch.parallel import moe

    T, D, Fd, E = MOE["T"], MOE["D"], MOE["d_ff"], MOE["E"]
    g = torch.Generator().manual_seed(400)
    bf = torch.bfloat16
    x = torch.randn(T, D, generator=g).to("cuda", bf)
    gate_w = (torch.randn(D, E, generator=g) * D ** -0.5).to("cuda", bf)
    params = {"w1": (torch.randn(E, D, Fd, generator=g) * D ** -0.5)
              .to("cuda", bf).requires_grad_(),
              "w2": (torch.randn(E, Fd, D, generator=g) * Fd ** -0.5)
              .to("cuda", bf).requires_grad_()}

    def expert(p, h):
        return F.gelu(h @ p["w1"], approximate="tanh") @ p["w2"]

    kw = dict(capacity_factor=MOE["capacity_factor"], k=MOE["k"])
    y, aux = moe.moe_layer(x, gate_w, expert, params, comm,
                           return_aux=True, experts_per_device=E, **kw)
    want = moe.dense_moe_oracle(x, gate_w, expert, params, **kw)
    err = (y.float() - want.float()).abs().max().item()
    fwd_ms = time_ms(torch, lambda: moe.moe_layer(
        x, gate_w, expert, params, comm, experts_per_device=E, **kw), 3)
    step_ms = time_ms(torch, lambda: torch.autograd.grad(
        moe.moe_layer(x, gate_w, expert, params, comm,
                      experts_per_device=E, **kw).float().square().sum(),
        list(params.values())), 3)
    cap = max(1, int(MOE["capacity_factor"] * MOE["k"] * T / E))
    log(f"moe (world 1, {E} experts on the card, top-{MOE['k']}, capacity "
        f"{cap}, T={T} D={D} d_ff={Fd}, bf16): max |y - oracle| {err:.3g} "
        f"(limit {MOE_ATOL}), load balance {float(aux['load_balance_loss']):.4f}, "
        f"dropped {float(aux['dropped_fraction']):.4f}; forward {fwd_ms:.2f}"
        f" ms, forward + backward {step_ms:.2f} ms")
    if not err <= MOE_ATOL:
        raise AssertionError(f"phase 10d: moe_layer differs from the oracle "
                             f"by {err}")
    return {"max_err": err, "forward_ms": fwd_ms, "step_ms": step_ms,
            "capacity": cap,
            "aux": {a: float(b) for a, b in aux.items()}}


def phase_long_context(torch, K, log, card):
    """Phase 10: 10a-10d in a fresh NCCL process group."""
    import chainermn_tpu_torch as cmn

    t0 = time.perf_counter()
    comm = cmn.create_communicator("xla_ici", device="cuda")
    if torch.distributed.get_backend() != "nccl":
        raise AssertionError("expected NCCL")
    out = {"card": card,
           "example": phase_lc_example(torch, K, log, card, comm),
           "sp": phase_sp_functions(torch, K, log, comm),
           "vocab_parallel": phase_vocab_parallel(torch, log, comm),
           "moe": phase_moe(torch, log, comm)}
    torch.distributed.destroy_process_group()
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 10: {out['wall_s']:.1f}s")
    return out


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
    dp_surface = {"mnist": phase_mnist(torch, log, card),
                  "lm_zero3": phase_lm_zero3(torch, K, log, train),
                  "card": card}
    imagenet = phase_imagenet(torch, log, card)
    model_parallel = phase_model_parallel(torch, log, card)
    pipeline = phase_pipeline(torch, log, card)
    long_context = phase_long_context(torch, K, log, card)

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
    print(json.dumps({"dp_surface": dp_surface}), flush=True)
    print(json.dumps({"imagenet": imagenet}), flush=True)
    print(json.dumps({"model_parallel": model_parallel}), flush=True)
    print(json.dumps({"pipeline": pipeline}), flush=True)
    print(json.dumps({"long_context": long_context}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
