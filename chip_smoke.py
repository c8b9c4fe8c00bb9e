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
   only; the same for the LM head's ``ce_fwd`` (every row) and ``ce_bwd``
   (every chunk of ``fused_ce.DEFAULT_CHUNK`` rows) at N 16384, V 50257,
   D 2048, beside the library product and elementwise torch ops they
   replaced, with the two library products that follow ``ce_bwd``; and
   the expert layer's Triton kernels (``moe_permute``, ``moe_combine``,
   ``moe_combine_bwd``) at one micro-batch of the Trinity-Mini cell (16384
   tokens, top 8 of 128 experts, 64 held, width 2048): their launches in
   one ``DroplessMoE`` call, forward and backward (1, 2, 1), each held to
   its plain twin on that layer's routing and timed beside its bytes'
   bound;
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
   ``dense_moe_oracle``, with its times;
11. the GSPMD step (``parallel.sharding.make_gspmd_train_step``, DTensor
   over a 1 x 1 ``("data", "model")`` ``DeviceMesh``) in a fresh process
   group, on phase 4's model, data, seed and AdamW: (a) plan ``dp_tp``
   for 5 steps, the losses within 1e-4 of phase 4's (bitwise equality
   reported), each flash kernel launched 8 times a step on the local
   heads, the median step and the host's time to return from a step
   beside phase 4's, one profiled step's idle share; (b) plans ``fsdp``
   and ``zero`` for 3 steps each under the same loss limit, each step
   time recorded; (c) ``python -m chainermn_tpu_torch.tools.shardplan
   --lint --format json`` over the nine models, equal to
   ``tests/golden/torch_shardplan_lint.json``;
12. the serving path (``chainermn_tpu_torch.serving``: frontend ->
   continuous-batching scheduler -> engine over paged KV pages) at
   ``bench.py::bench_serve``'s configuration (phase 4's LM widths, bf16,
   seed 0, max_len 512, pages of 16 tokens, 512 pages): (a) 16 requests
   of 64-token prompts, 32 new tokens, greedy, at decode batches 1, 2, 4
   and 8 with 3-token n-gram drafts and without: decode tokens/s,
   per-token p50/p99, TTFT, prefill tokens/s, peak memory, kernel
   launches a decode step, and one profiled decode step at the best
   batch (device time by kind, idle share); (b) 0.75 of every prompt
   shared against the same traffic without the prefix cache; (c) the
   truncated-model draft against n-gram, int8 pages against full
   precision; (d) 8 prompts of 2048 tokens in slices of 512 (max_len
   4096, 2048 pages): TTFT, decode p99, peak memory; (e) three groups of
   streams against reference streams: every stream of (a) and (c)'s
   model draft against each request alone through ``engine.generate``,
   (b)'s prefix-cached streams against its no-cache streams, and a run
   with decode pinned to 8 rows against each request alone at 8 rows;
   each divergence's top-2 margin against the logit differences of the
   reference stream teacher-forced through decode at B 1 and B 8 and
   4-token chunks (limit ``SERVE_TOL``), and the engine against the
   dense model; (f) the ``serve_lm`` example's
   ``main`` at its defaults, every request on the successor pattern.  No
   flash kernel may launch on this path;
13. serving across devices and replicas, on phase 12's module and
   traffic (16 prompts of 64 tokens, 32 new, pages 512 x 16): (a) the
   engine under sharding plan ``tp`` on a 1 x 1 ``DeviceMesh`` over NCCL
   (DTensor parameters and pages), its B 8 streams and B 8
   teacher-forced logits bitwise equal to phase 12's one-device engine,
   and its decode tokens/s, host time a step, idle share of a profiled
   step and launches a step beside the one-device engine's; (b) decode
   in 2 and 4 pipeline microbatches (``pp_stages``), its B 8 streams
   identical to phase 12's; (c) one module
   serving three replicas (a prefill replica and two decoders) through
   ``ReplicaRouter`` and ``ThreadedClusterDriver``: plain, with a decoder
   killed mid-stream (``fail_replica``), and with a decoder drained and
   its live streams migrated (``migrate_out``): tokens/s, TTFT and
   per-token percentiles, peak memory, launches a router step, and the
   prefill replica decoding nothing; every stream of (a)-(c) held to each
   request alone by (e)'s contract; (d) a running sequence's bf16 pages
   through ``extract_sequence`` -> ``send_snapshot``/``recv_snapshot`` ->
   ``restore_sequence`` into a second engine, bitwise, its continued
   stream identical.  No flash kernel may launch;
14. the multi-process serving tier (cell ``serve-fleet-h100-1``: phase
   12's widths, bf16, seed 0, max_len 512, 512 pages of 16 a replica,
   decode batch 8; 16 requests of the CLI's synthetic 32-64-token prompts,
   32 new tokens, every odd one sampled) through ``python -m
   chainermn_tpu_torch.tools.serve``: (a) ``--groups 2 --verify``, a router
   and two replica processes over the transport's ``TCPStore`` and socket
   plane, the flight files stitched into a Chrome trace, the router's
   ``/metrics`` scraped once mid-run for both replicas' series; (b) the
   same fleet routed from this process (the store's master) with two
   replica processes of this script's worker mode (``--fleet-replica``),
   rank 2 SIGKILLed after 40 streamed tokens, its streams failed over;
   (c) ``--tp 2 --verify``, one shard group (a leader and a follower
   mirror).  Every request finishes, every process's weights have this
   process's crc32, every stream equals the oracle's or is explained by
   (e)'s contract; (b)'s flight postmortem has one trace a request, no
   orphans and a failover event.  Records tokens/s (release of the
   traffic to its last token, every replica warm), TTFT and per-token
   percentiles, failovers and each process's GPU memory (``nvidia-smi
   --query-compute-apps``) beside 12a's B 8 engine and 13c's threaded
   fleet;
15. the training host planes: (a) phase 4's model, data, seed and AdamW
   for its 7 steps under a ``Reporter`` and a ``StepRecorder``: the
   losses bitwise phase 4's, 7 ``train_step`` spans and calls, the
   ``grad_pack/*`` counters equal to the packer's plan for the LM's
   gradients, 8 launches of each flash kernel a step, the median step
   beside phase 4's, ``tools.obs summarize`` and ``step_log.recover`` on
   a torn copy of the log; (b) the MNIST example under ``python -m
   chainermn_tpu_torch.tools.elastic --nproc 1`` on the card (``--elastic
   --checkpoint-every 1 --step-log``), unfaulted and with rank 0
   SIGKILLed at step 5: one restart, the same parameter digest; (c) 7b's
   SGD run under the supervisor with rank 0 SIGTERMed at step 3: the
   grace-window checkpoint, exit code 75, one preemption and no restart,
   the world resumed from iteration 3 and ending within 7b's resume
   limits of 7b's uninterrupted run (each parameter tensor within
   ``RESUME_REL_L2`` of its norm: both runs train with deterministic
   algorithms), each incarnation's start-up and img/s; (d)
   the native host library built (``native_impl() == "csrc"``), its
   CRC32C and ``tree_digest`` equal to the pure-Python values, and
   ``parallel_gather`` timed against ``np.stack`` on one ImageNet batch;
16. the tuning plane and the resource fabric (phases 3-15 ran on an empty
   tune cache, ``CHAINERMN_TPU_TUNE_CACHE`` in a fresh directory): (a)
   ``python -m chainermn_tpu_torch.tools.autotune`` on the card at phase
   4's shapes (flash and the CE chunk) and with ``--kv-dtype --draft
   --prefill-chunk --serve-group`` at phase 12's widths, 512 pages of 16
   and B 8: each record's candidates and seconds (the pick is the
   fastest of its own timings by construction: a record, not a check),
   every entry under the card's device kind; (b) the lookups on against
   that cache: phase 4's LM step on the tuned CE chunk (step-0 loss within
   ``TUNED_LOSS_RTOL`` of phase 4's, and the median step, a second timing
   of the pick, within ``TUNED_STEP_RTOL`` of phase 4's on the default
   chunk), phase 12a's B 8 runs on the tuned serving knobs (tokens/s
   recorded beside 12a's), every request finished, streams held by (e)'s
   contract on full-precision pages; (c) ``python -m
   chainermn_tpu_torch.tools.fabric --device cuda``, an oracle arm and an
   arbiter arm side by side, held to the reference soak's assertions (a
   preemption for serving and a return to training, two lease rescales
   and no restart, the digest the oracle's, no stream dropped or off its
   oracle, the ledger conserved at every event); (d) a ``FabricArbiter``
   in this process over two replicas sharing phase 12's module, a ledger
   of 4 cards and the 2-rank fabric worker under the real supervisor,
   through one peak (phase 12's prompts at once) and its trough: the same
   invariants, the digest 16c's oracle's, every stream held by (e)'s
   contract, the drain -> migrate -> retire time.  In (c) and (d) the
   peak offers more requests at once than the fleet's running and queued
   slots hold, so the queue watermark stays crossed for as many fleet
   steps as the backlog lasts, however fast the card decodes; each arm
   logs its longest run of polls at the watermark beside ``k_spike``.
17. the linter (``chainermn_tpu_torch.analysis``; run between phases 15
   and 16, on the static defaults): (a) phase 4's LM step
   built under ``CHAINERMN_TPU_LINT=strict``, whose first call captures
   the step under a dispatch mode and lints it: clean, R001-R005 run (R002
   vacuous at world 1), each flash custom op counted 8 times in the
   capture's census and launched 8 times by it, the batch's taint on
   every attention layer's flash outputs, then the 7 steps with losses
   bitwise phase 4's and the median step within 2% of phase 4's (the
   first call's extra wall, the snapshot's bytes and the peak beside
   phase 4's); (b) ``python -m chainermn_tpu_torch.tools.lint`` four ways
   at once: the clean gate on the card (exit 0), the fixtures on two gloo
   ranks (exit 1, each fixture's rules those of
   ``tests/golden/torch_lint_fixtures.json``), ``--host`` and ``--self``
   (exit 0), each run's wall;
18. the collective audit (``observability.collective_audit``; run after
   17, on the static defaults): (a) ``audit_fn`` on phase 4's LM step, one
   capture of the call: its counts and bytes per axis, each flash custom
   op 8 times in the capture and launched 8 times by it, the audit's wall,
   the peak beside phase 4's, and the next two real steps' losses bitwise
   phase 4's first two; (b) ``tests/_torch_audit_worker.py`` in a
   subprocess (started first): ``audit_allreduce_tree`` of the reference's
   64-leaf tree at 256 KiB buckets on torch's fake process group of 8 as
   2 x 4, at rank 0 (a node leader) and rank 1, for the five
   communicators bucketed, unbucketed, on the int8 wire and overlapped,
   on CUDA tensors and on CPU ones: every result equal; (c) the MNIST
   example with ``--step-log`` on the card: one ``hlo_audit`` row, read
   back by ``tools.obs summarize``.

Standard output ends with a JSON line ``{"train": ...}``, a JSON line
``{"dp_surface": ...}``, a JSON line ``{"imagenet": ...}``, a JSON line
``{"model_parallel": ...}``, a JSON line ``{"pipeline": ...}``, a JSON
line ``{"long_context": ...}``, a JSON line ``{"gspmd": ...}``, a JSON
line ``{"serving": ...}``, a JSON line ``{"serving_cluster": ...}``, a
JSON line ``{"serving_fleet": ...}``, a JSON line ``{"host_planes":
...}``, a JSON line ``{"tuning_fabric": ...}``, a JSON line ``{"lint":
...}``, a JSON line ``{"audit": ...}``, the card's ``name, power.limit`` line, a JSON line of per-kernel numbers, and ``{"ok":
true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import statistics
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


# The LM loss head's kernels (csrc/ce_head.cu), timed in phase 5 at the
# GPT-3 XL head's shape: 16384 tokens, vocabulary 50257, width 2048.
CE_KERNELS = {
    "ce_fwd": ("chainermn_tpu_torch/csrc/ce_head.cu",
               "none: chainermn_tpu/ops/fused_ce.py writes the head in jnp"),
    "ce_bwd": ("chainermn_tpu_torch/csrc/ce_head.cu",
               "none: chainermn_tpu/ops/fused_ce.py writes the head in jnp"),
}
CE_SHAPE = dict(N=16384, V=50257, D=2048)

# The expert layer's kernels (ops/moe_dispatch.py, Triton), timed in phase 5
# at one micro-batch of the benchmark's Trinity-Mini cell: 16384 tokens, top
# 8 of 128 experts of which experts 0-63 are held, width 2048, expert width
# 1024, the published route scale.
MOE_KERNELS = {
    name: ("chainermn_tpu_torch/ops/moe_dispatch.py",
           "none: chainermn_tpu/parallel/moe.py dispatches by einsum")
    for name in ("moe_permute", "moe_combine", "moe_combine_bwd")
}
MOE_SHAPE = dict(T=16384, k=8, experts=128, held=64, d=2048, f=1024,
                 route_scale=2.826)


def flash_launches(K):
    """The flash kernels' launch counts (the phases' checks are about
    them; the CE's counts are read apart)."""
    return {name: K.LAUNCHES[name] for name in KERNELS}


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


def build_lm(torch, log, zero_stage=0, ce_chunk=FULL["ce_chunk"]):
    """The full-width LM train step over NCCL at ``zero_stage``:
    ``(step, (tokens, labels), tokens per step)``.  ``ce_chunk=None``
    lets the fused cross-entropy resolve its chunk (the tune cache)."""
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
                                   chunk=ce_chunk)

    step = opt.make_train_step(loss_fn)
    step.model, step.comm, step.opt = model, comm, opt
    return step, (tokens, labels), B * S


def phase_train(torch, K, log, n_warm, n_timed):
    step, batch, n_tokens = build_lm(torch, log)
    tokens, labels = batch
    V = FULL["vocab"]
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, times, host = [], [], []
    for i in range(n_warm + n_timed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step((tokens, labels))
        host.append(time.perf_counter() - t)
        lv = loss.item()                  # synchronises
        times.append(time.perf_counter() - t)
        losses.append(lv)
        log(f"step {i}: loss {lv:.5f} {times[-1] * 1e3:.1f} ms")
    torch.cuda.synchronize()
    launches = flash_launches(K)
    ce_launches = {name: K.LAUNCHES[name] for name in CE_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    steps = n_warm + n_timed
    log(f"launches over {steps} steps: {launches}, CE {ce_launches}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not abs(losses[0] - math.log(V)) < 1.5:
        raise AssertionError(f"step-0 loss {losses[0]} far from ln V = "
                             f"{math.log(V):.3f}")
    for name in KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    chunks = -(-n_tokens // FULL["ce_chunk"])
    if ce_launches != {"ce_fwd": steps, "ce_bwd": steps * chunks}:
        raise AssertionError(f"CE kernels {ce_launches} over {steps} steps "
                             f"of 1 ce_fwd and {chunks} ce_bwd")
    launches.update(ce_launches)
    timed = sorted(times[n_warm:])
    med = timed[len(timed) // 2]
    tok_s = n_tokens / med
    log(f"median step {med * 1e3:.1f} ms, {tok_s:.0f} tokens/s, peak "
        f"memory {peak / 2**30:.2f} GiB, losses {losses}")
    host_ms = sorted(host[n_warm:])[len(timed) // 2] * 1e3
    wall, busy, _ = profile_step(torch, lambda: step((tokens, labels)), log)
    torch.distributed.destroy_process_group()
    return {"step_ms": med * 1e3, "tokens_per_s": tok_s,
            "peak_mem_gib": peak / 2**30, "launches": launches,
            "steps": steps, "losses": losses, "host_ms": host_ms,
            "idle_share": 1 - busy / wall}


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


def _ce_library_fwd(torch, h16, e16, lab, chunk=512):
    """The LM head's forward as a library product and elementwise torch
    ops over fp32 ``(chunk, V)`` tiles: a yardstick only."""
    lse = torch.empty(h16.shape[0], dtype=torch.float32, device=h16.device)
    loss = torch.zeros((), dtype=torch.float32, device=h16.device)
    for i in range(0, h16.shape[0], chunk):
        logits = torch.mm(h16[i:i + chunk], e16.t(), out_dtype=torch.float32)
        m = logits.amax(dim=-1)
        lse_c = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
        picked = logits.gather(1, lab[i:i + chunk, None].long())[:, 0]
        loss = loss + (lse_c - picked).sum()
        lse[i:i + chunk] = lse_c
    return loss, lse


def _ce_library_dlogits(torch, h16, e16, lab, lse, g_loss, g_lse):
    """The backward's bf16 dlogits of one chunk the same way: a yardstick
    only."""
    logits = torch.mm(h16, e16.t(), out_dtype=torch.float32)
    p = torch.exp(logits - lse[:, None])
    rows = torch.arange(h16.shape[0], device=h16.device)
    d = g_loss * p
    d[rows, lab.long()] -= g_loss
    d = torch.where((lab >= 0)[:, None], d, torch.zeros_like(d))
    return (d + g_lse[:, None] * p).to(torch.bfloat16)


def phase_time_ce(torch, K, log):
    """Phase 5's rows for the LM head's kernels at ``CE_SHAPE``: ``ce_fwd``
    over every row, ``ce_bwd`` over every chunk of ``DEFAULT_CHUNK`` rows,
    each beside its bound, its plain twin and the library path it
    replaced; the two library products that follow ``ce_bwd`` are timed
    as ``products_ms``.  Each kernel's result is held to its twin on the
    first rows: ``ce_fwd``'s lse and label logits within 1e-3;
    ``ce_bwd``'s dlogits, with ``g_lse`` as large as ``g_loss``, within
    1e-2 of the twin's largest entry and 2e-3 of its norm, over every
    entry and again off the labels (the softmax terms, far below the
    label entries)."""
    from chainermn_tpu_torch.ops.fused_ce import DEFAULT_CHUNK

    N, V, D = CE_SHAPE["N"], CE_SHAPE["V"], CE_SHAPE["D"]
    C, v_pad = DEFAULT_CHUNK, K.ce_v_pad(V)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    h16 = torch.randn(N, D, device=dev, generator=g).to(torch.bfloat16)
    e16 = (torch.randn(V, D, device=dev, generator=g) * 0.02).to(
        torch.bfloat16)
    lab = torch.randint(0, V, (N,), device=dev, generator=g).to(torch.int32)
    splits = K.ce_splits(N, V, D, dev)
    m, s, pk = K.ce_fwd(h16, e16, lab, splits)
    lse = (m + torch.log(s)).logsumexp(0)
    g_loss = torch.full((), 1.0 / N, device=dev)
    g_lse = torch.randn(N, device=dev, generator=g) / N

    def bwd_all():
        for i in range(0, N, C):
            K.ce_bwd(h16[i:i + C], e16, lab[i:i + C], lse[i:i + C], g_loss,
                     g_lse[i:i + C])

    def bwd_plain():
        for i in range(0, N, C):
            K.ce_bwd_plain(h16[i:i + C], e16, lab[i:i + C], lse[i:i + C],
                           g_loss, g_lse[i:i + C])

    def bwd_library():
        for i in range(0, N, C):
            _ce_library_dlogits(torch, h16[i:i + C], e16, lab[i:i + C],
                                lse[i:i + C], g_loss, g_lse[i:i + C])

    e_pad = torch.zeros(v_pad, D, device=dev, dtype=torch.bfloat16)
    e_pad[:V] = e16
    d_emb = torch.zeros(v_pad, D, device=dev)
    dl = K.ce_bwd(h16[:C], e16, lab[:C], lse[:C], g_loss, g_lse[:C])

    def products():
        for _ in range(0, N, C):
            torch.mm(dl, e_pad, out_dtype=torch.float32)
            torch.addmm(d_emb, dl.t(), h16[:C], out_dtype=torch.float32,
                        out=d_emb)

    # Held to the twins on the first R rows.
    R = min(512, C)
    wm, ws, wpk = K.ce_fwd_plain(h16[:R], e16, lab[:R], splits)
    errs = {"ce_fwd": max(
        (lse[:R] - (wm + torch.log(ws)).logsumexp(0)).abs().max().item(),
        (pk[:, :R].sum(0) - wpk.sum(0)).abs().max().item())}
    want = K.ce_bwd_plain(h16[:R], e16, lab[:R], lse[:R], g_loss,
                          g_lse[:R]).float()
    got = dl[:R].float()
    errs["ce_bwd"] = (got - want).abs().max().item()
    rel = {}
    for part in ("all", "off_label"):
        if part == "off_label":
            rows = torch.arange(R, device=dev)
            got[rows, lab[:R].long()] = 0
            want[rows, lab[:R].long()] = 0
        rel[part] = ((got - want).abs().max().item()
                     / want.abs().max().item(),
                     (got - want).norm().item() / want.norm().item())
    log(f"ce_bwd against its twin, (max gap / max, norm gap / norm): {rel}")
    del got, want
    flops = 2 * N * V * D
    work = {
        "ce_fwd": (flops, N * D * 2 + V * D * 2 + N * 4 + 3 * splits * N * 4),
        "ce_bwd": (flops, N * D * 2 + N // C * V * D * 2 + N * v_pad * 2
                   + N * 12),
    }
    kern = {"ce_fwd": lambda: K.ce_fwd(h16, e16, lab, splits),
            "ce_bwd": bwd_all}
    plain = {"ce_fwd": lambda: K.ce_fwd_plain(h16, e16, lab, splits),
             "ce_bwd": bwd_plain}
    library = {"ce_fwd": lambda: _ce_library_fwd(torch, h16, e16, lab),
               "ce_bwd": bwd_library}
    res = {}
    for name in CE_KERNELS:
        fl, nbytes = work[name]
        t_ops = fl / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        ms = time_ms(torch, kern[name], 10)
        res[name] = {
            "ms": ms, "plain_ms": time_ms(torch, plain[name], 1),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": time_ms(torch, library[name], 3),
            "design": "wgmma_tma", "tflops": fl / ms / 1e9,
            "bound_share": max(t_ops, t_bytes) / ms,
            "max_abs_err": errs[name],
        }
        r = res[name]
        log(f"time {name} [{r['design']}]: {r['ms']:.3f} ms (plain "
            f"{r['plain_ms']:.3f}, bound {r['bound_ms']:.3f} by "
            f"{r['bound_by']}, library {r['library_ms']:.3f}), "
            f"{r['tflops']:.1f} TFLOP/s, {r['bound_share']:.3f} of bound, "
            f"max abs err against the twin {r['max_abs_err']:.3g}")
    pm = time_ms(torch, products, 3)
    res["ce_bwd"]["products_ms"] = pm
    res["ce_bwd"]["rel_err"] = rel
    log(f"time ce_bwd's products (dh, dE over {N // C} chunks): {pm:.3f} ms, "
        f"{2 * flops / pm / 1e9:.1f} TFLOP/s")
    if errs["ce_fwd"] > 1e-3 or any(a > 1e-2 or b > 2e-3
                                    for a, b in rel.values()):
        raise AssertionError(f"CE kernels against their twins: {errs}, "
                             f"ce_bwd relative {rel}")
    return res


def phase_time_moe(torch, log, shape=MOE_SHAPE, device="cuda"):
    """Phase 5's rows for the expert layer's kernels at ``shape``.  One
    ``DroplessMoE`` call at those widths, forward and backward, must launch
    each kernel as often as the benchmark's readers count (1, 2, 1); then
    each kernel, on that layer's own routing plan, is held to its plain
    twin on the same inputs: ``moe_permute`` and ``moe_combine_bwd``'s
    row gradients bitwise (a copy, one product a row), ``moe_combine`` and
    the gate gradients within 1e-2 of the twin's largest entry and 2e-3
    of its norm (summation order), and timed beside its bound (the bytes
    ``portbench.sparse_yardstick`` counts, over the HBM peak) and its
    twin."""
    from portbench import sparse_yardstick
    from chainermn_tpu_torch.ops import moe_dispatch as md
    from chainermn_tpu_torch.parallel.moe import DroplessMoE

    T, k, E = shape["T"], shape["k"], shape["experts"]
    c, D, F_ = shape["held"], shape["d"], shape["f"]
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(13)
    layer = DroplessMoE(D, F_, E, k, first=0, count=c,
                        route_scale=shape["route_scale"],
                        dtype=torch.bfloat16).to(dev)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, p.shape[-1] ** -0.5, generator=g)
    x = torch.randn(T, D, device=dev, generator=g)
    md.warm_up(dev, D, k)
    md.reset_launch_counts()
    layer(x.clone().requires_grad_()).float().sum().backward()
    launches = dict(md.LAUNCHES)
    log(f"moe layer call (T {T}, top {k} of {E}, {c} held, d {D}, f {F_}), "
        f"forward and backward: launches {launches}")
    with torch.no_grad():
        idx, gates = layer.route(x.to(torch.bfloat16))
        plan = md.dispatch_plan(idx, 0, c)
    held = int(plan.sizes.sum())
    largest = int(plan.sizes.max())
    xb = x.to(torch.bfloat16)
    ys = torch.randn(plan.rows, D, device=dev, generator=g).to(torch.bfloat16)
    dout = torch.randn(T, D, device=dev, generator=g).to(torch.bfloat16)
    w = torch.rand(plan.rows, device=dev, generator=g)
    ops = torch.ops.chainermn_torch
    kern = {
        "moe_permute": lambda: ops.moe_permute(xb, plan.src),
        "moe_combine": lambda: ops.moe_combine(ys, plan.pos, gates),
        "moe_combine_bwd": lambda: ops.moe_combine_bwd(dout, ys, plan.src,
                                                       w),
    }
    plain = {
        "moe_permute": lambda: md.permute_plain(xb, plan.src),
        "moe_combine": lambda: md.combine_plain(ys, plan.pos, gates),
        "moe_combine_bwd": lambda: md.combine_bwd_plain(dout, ys, plan.src,
                                                        w),
    }

    def rel(got, want):
        got, want = got.float(), want.float()
        return ((got - want).abs().max().item() / want.abs().max().item(),
                (got - want).norm().item() / want.norm().item())

    dys, dw = kern["moe_combine_bwd"]()
    wdys, wdw = plain["moe_combine_bwd"]()
    checks = {
        "moe_permute": {"bitwise": torch.equal(kern["moe_permute"](),
                                               plain["moe_permute"]())},
        "moe_combine": {"rel": rel(kern["moe_combine"](),
                                   plain["moe_combine"]())},
        "moe_combine_bwd": {"bitwise": torch.equal(dys, wdys),
                            "rel": rel(dw, wdw)},
    }
    del dys, dw, wdys, wdw
    log(f"moe kernels against their twins ({held} held assignments, "
        f"largest expert {largest}; relative = (max gap / max, norm gap / "
        f"norm)): {checks}")
    per_launch = sparse_yardstick.moe_move_launch_bytes(T, held, D)
    res = {}
    for name in MOE_KERNELS:
        t_bytes = per_launch[name] / PEAK_HBM_BYTES * 1e3
        ms = time_ms(torch, kern[name], 20)
        res[name] = {
            "ms": ms, "plain_ms": time_ms(torch, plain[name], 2),
            "bound_ms": t_bytes, "bound_by": "bytes", "library_ms": None,
            "design": "triton_row", "tflops": 0.0,
            "bound_share": t_bytes / ms, "launches": launches[name],
            "max_abs_err": None, "checks": checks[name],
        }
        r = res[name]
        log(f"time {name} [{r['design']}]: {r['ms']:.3f} ms (plain "
            f"{r['plain_ms']:.3f}, bound {r['bound_ms']:.3f} by bytes, "
            f"{per_launch[name] / 1e6:.1f} MB), {r['bound_share']:.3f} of "
            f"bound, {r['launches']} launches a layer call")
    bad = [f"launches {launches}, want {sparse_yardstick.MOE_MOVE_LAUNCHES}"
           ] if launches != sparse_yardstick.MOE_MOVE_LAUNCHES else []
    for name, chk in checks.items():
        if not chk.get("bitwise", True):
            bad.append(f"{name} not bitwise its twin")
        a, b = chk.get("rel", (0.0, 0.0))
        if not (a <= 1e-2 and b <= 2e-3):
            bad.append(f"{name} relative gap {chk['rel']}")
    if bad:
        raise AssertionError("moe kernels: " + "; ".join(bad))
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
    launches = flash_launches(K)
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
# A resumed run against the uninterrupted one: both take the example's
# resumable path, which trains with deterministic algorithms, and end
# bitwise on the card; a resume that restored the wrong state, or skipped
# or repeated a step, moves a parameter tensor by more than RESUME_REL_L2
# of its norm over 6 warm-up steps (lr at most 0.005), or a loss by more
# than RESUME_LOSS_ATOL.
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
    from chainermn_tpu_torch.examples.train_imagenet import DROPOUT_SEED
    from chainermn_tpu_torch.models import AlexNet, GoogLeNet, NiN

    out = {}
    for name, cls in (("alex", AlexNet), ("nin", NiN),
                      ("googlenet", GoogLeNet)):
        model = cls(num_classes=RESNET["classes"], device="cuda", seed=0)
        opt = create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9), comm)
        opt.init()
        step = opt.make_train_step(lambda b, rng: F.cross_entropy(
            model(b[0], train=True, rng=rng), b[1]), rng=DROPOUT_SEED)
        losses, times = [], []
        for i in range(CONVNET_STEPS):
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


def imagenet_npz(tmp):
    """7b's data: EX_TRAIN images of seeded noise and their labels."""
    import numpy as np

    rng = np.random.default_rng(0)
    s = RESNET["image"]
    npz = os.path.join(tmp, "imagenet.npz")
    np.savez(npz, images=rng.standard_normal((EX_TRAIN, s, s, 3),
                                             dtype=np.float32),
             labels=rng.integers(0, RESNET["classes"], EX_TRAIN,
                                 dtype=np.int32))
    return npz


def imagenet_args(npz):
    return ["--communicator", "pure_nccl", "--arch", "resnet50",
            "--batchsize", str(RESNET["batch"]), "--data-npz", npz,
            "--val-size", str(EX_VAL), "--steps", str(EX_STEPS)]


def phase_imagenet_example(torch, log, card, tmp, keep):
    """7b: the example at full width (ResNet-50, 1000 classes, 224 px,
    global batch 256) over NCCL: SGD, LARS, and a run stopped at a saved
    step and resumed, against the uninterrupted SGD run.  ``keep`` gets
    the SGD run's parameters and last-epoch losses (phase 15c's yardstick)."""
    from chainermn_tpu_torch.global_except_hook import remove_hook

    npz = imagenet_npz(tmp)
    base = imagenet_args(npz)
    ck = ["--checkpoint-dir", os.path.join(tmp, "ck"),
          "--checkpoint-every", str(EX_STEPS)]
    # The uninterrupted run takes the resumable path too (a checkpoint
    # directory it never saves to), so it trains with the same
    # deterministic algorithms as the stopped and resumed runs; one epoch
    # with cuDNN's autotuner gives the img/s that costs.
    whole = ["--checkpoint-dir", os.path.join(tmp, "ck_whole"),
             "--checkpoint-every", str(100 * EX_STEPS)]
    plan = [("sgd", whole + ["--epochs", "2"]),
            ("sgd_autotuned", ["--epochs", "2"]),
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
    det, tuned = runs["sgd"]["img_per_s"], runs["sgd_autotuned"]["img_per_s"]
    summary["deterministic_cost"] = {"img_per_s_deterministic": det,
                                     "img_per_s_autotuned": tuned}
    log(f"imagenet deterministic algorithms on {card}: epoch-1 img/s "
        f"{det[-1]:.1f} against cuDNN's autotuner's {tuned[-1]:.1f}")
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
    keep["params"] = {k: v.detach().float().cpu()
                      for k, v in whole["model"].named_parameters()}
    keep["losses"] = list(whole["step_losses"][-1])
    del runs, whole, stopped, resumed
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("phase 7b: " + "; ".join(failed))
    return summary


def phase_imagenet(torch, log, card, keep):
    """Phase 7: 7a, 7d (which reuses 7a's batch), 7c, then 7b (``keep``
    as :func:`phase_imagenet_example`'s)."""
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
        out["example"] = phase_imagenet_example(torch, log, card, tmp,
                                                keep)
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
    launches = flash_launches(K)
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
        launches = flash_launches(K)
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
        launches = flash_launches(K)
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
# Phase 11: the GSPMD step
# ---------------------------------------------------------------------------

GSPMD_STEPS = 5          # (a) plan dp_tp; times: the median of steps 1-4
GSPMD_PLAN_STEPS = 3     # (b) plans fsdp and zero; of steps 1-2
LINT_GOLDEN = os.path.join("tests", "golden", "torch_shardplan_lint.json")


def run_gspmd(torch, K, log, mesh, plan, steps, want):
    """Phase 4's model, data, seed and AdamW through
    ``make_gspmd_train_step`` under ``plan``: ``steps`` steps with every
    kernel launch counted, the losses against phase 4's ``want``."""
    import numpy as np

    from chainermn_tpu_torch.models.transformer import TransformerLM
    from chainermn_tpu_torch.ops import make_flash_attention_fn
    from chainermn_tpu_torch.parallel.sharding import (lm_loss,
                                                       make_gspmd_train_step)

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = TransformerLM(
        vocab=FULL["vocab"], d_model=FULL["d_model"],
        n_heads=FULL["n_heads"], d_ff=FULL["d_ff"],
        n_layers=FULL["n_layers"], max_len=FULL["seq"],
        dtype=torch.bfloat16, attention_fn=make_flash_attention_fn(causal=True),
        device="cuda", seed=0,
    )
    step, shard_fn = make_gspmd_train_step(
        model, lm_loss(FULL["ce_chunk"]),
        lambda ps: torch.optim.AdamW(ps, lr=3e-4, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=0.1),
        mesh, plan)
    shard_fn()
    rng = np.random.RandomState(0)
    B, S, V = FULL["batch"], FULL["seq"], FULL["vocab"]
    tokens = torch.from_numpy(rng.randint(0, V, size=(B, S))).cuda()
    labels = torch.from_numpy(rng.randint(0, V, size=(B, S))).cuda()
    setup = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, times, host = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step((tokens, labels))
        host.append(time.perf_counter() - t)
        losses.append(loss.item())
        times.append(time.perf_counter() - t)
        log(f"gspmd {plan} step {i}: loss {losses[-1]:.5f} "
            f"{times[-1] * 1e3:.1f} ms (host returned after "
            f"{host[-1] * 1e3:.1f} ms)")
    torch.cuda.synchronize()
    launches = flash_launches(K)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(times[1:]) * 1e3
    host_ms = statistics.median(host[1:]) * 1e3
    diff = max(abs(a - b) for a, b in zip(losses, want))
    out = {"plan": plan, "losses": losses, "phase4_losses": want,
           "max_diff": diff, "bitwise": losses == want, "step_ms": med,
           "host_ms": host_ms, "peak_gib": peak, "launches": launches,
           "setup_s": setup, "tokens_per_s": B * S / med * 1e3}
    log(f"gspmd {plan}: launches {launches} over {steps} steps; losses "
        f"{losses} against phase 4's {want}: max diff {diff:.3g}, bitwise "
        f"{out['bitwise']}; median step {med:.1f} ms, host returned after "
        f"{host_ms:.1f} ms, peak {peak:.2f} GiB, set-up {setup:.1f} s")
    failed = [f"{name} launched {launches[name]} times, not "
              f"{FULL['n_layers'] * steps}" for name in KERNELS
              if launches[name] != FULL["n_layers"] * steps]
    if not diff <= LM_ZERO3_ATOL:
        failed.append(f"losses {diff} from phase 4's")
    if failed:
        raise AssertionError(f"phase 11 {plan}: " + "; ".join(failed))
    return out, (lambda: step((tokens, labels)))


def phase_gspmd(torch, K, log, card, train, repo):
    """Phase 11: (a) ``dp_tp``, (b) ``fsdp`` and ``zero`` on a 1 x 1
    mesh, (c) the shardplan lint against its golden."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.parallel.sharding import build_device_mesh

    t0 = time.perf_counter()
    comm = cmn.create_communicator("pure_nccl", device="cuda")
    if torch.distributed.get_backend() != "nccl":
        raise AssertionError("expected NCCL")
    mesh = build_device_mesh(comm, (1, 1), ("data", "model"), device="cuda")
    out = {"card": card, "mesh": "1x1 (data, model)"}
    a, run_step = run_gspmd(torch, K, log, mesh, "dp_tp", GSPMD_STEPS,
                            train["losses"][:GSPMD_STEPS])
    wall, busy, kinds = profile_step(torch, run_step, log,
                                     what="gspmd dp_tp step")
    a.update(profile={"wall_ms": wall, "busy_ms": busy,
                      "idle_share": 1 - busy / wall},
             phase4={k: train[k] for k in ("step_ms", "host_ms",
                                           "idle_share")})
    log(f"gspmd dp_tp against phase 4: median step {a['step_ms']:.1f} ms vs "
        f"{train['step_ms']:.1f}; host returned after {a['host_ms']:.1f} ms "
        f"vs {train['host_ms']:.1f}; idle share {1 - busy / wall:.3f} vs "
        f"{train['idle_share']:.3f}")
    out["dp_tp"] = a
    del run_step
    for plan in ("fsdp", "zero"):
        out[plan], _ = run_gspmd(torch, K, log, mesh, plan, GSPMD_PLAN_STEPS,
                                 train["losses"][:GSPMD_PLAN_STEPS])
    torch.distributed.destroy_process_group()
    t = time.perf_counter()
    lint = subprocess.run(
        [sys.executable, "-m", "chainermn_tpu_torch.tools.shardplan",
         "--lint", "--format", "json"],
        capture_output=True, text=True, timeout=300, cwd=repo)
    with open(os.path.join(repo, LINT_GOLDEN)) as f:
        golden = json.load(f)
    same = lint.returncode == 0 and json.loads(lint.stdout) == golden
    out["lint"] = {"rc": lint.returncode, "equal_to_golden": same,
                   "targets": len(golden["targets"]),
                   "seconds": time.perf_counter() - t}
    log(f"shardplan --lint: rc {lint.returncode}, {len(golden['targets'])} "
        f"model x plan targets, equal to {LINT_GOLDEN}: {same} "
        f"({out['lint']['seconds']:.1f} s)")
    if not same:
        raise AssertionError("phase 11c: shardplan --lint differs from its "
                             f"golden: {lint.stderr[-2000:]}")
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 11: {out['wall_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# Phase 12: the serving path
# ---------------------------------------------------------------------------

# bench.py::bench_serve's configuration: phase 4's LM widths (bf16, seed 0),
# max_len 512, pages of 16 tokens, 512 pages; 16 requests of 64-token
# prompts, 32 new tokens, greedy, decode batches 1-8, drafts of 3 tokens.
SERVE = dict(max_len=512, block_size=16, n_blocks=512, requests=16,
             prompt_len=64, new_tokens=32, batch_sizes=(1, 2, 4, 8),
             spec_tokens=3, prefix_dup=0.75)
# (d) long prompts at phase 4's context: 8 prompts of 2048 tokens, 64 new
# tokens, prefilled in slices of 512, 2048 pages (2 GiB of bf16 pages).
SERVE_LONG = dict(max_len=4096, block_size=16, n_blocks=2048, requests=8,
                  prompt_len=2048, new_tokens=64, prefill_chunk=512,
                  max_batch=8)
# (e) bf16 logits of one stream through two step shapes (decode at B 1 and
# B 8, a 4-token chunk) or the dense model: every activation is rounded to
# bf16 after each op, and a GEMM of another shape may sum in another order,
# so an activation can move by a bf16 ulp (2^-8 relative) per op; over 8
# layers that reaches the head as a few ulps of the largest logit.  Limit:
# 2^-5 of the row's largest |logit| (8 ulps).  A misrouted page or mask
# moves logits by O(1) of their scale.
SERVE_TOL = 2.0 ** -5


def serve_kind(name):
    low = name.lower()
    return ("flash" if "flash_" in low else
            "gemm" if any(w in low for w in ("gemm", "nvjet", "xmma",
                                              "cutlass", "cublas")) else
            "gather/scatter" if any(w in low for w in ("index", "gather",
                                                        "scatter")) else
            "copy (casts)" if "copy" in low else
            "softmax" if "softmax" in low else
            "layernorm" if "layer_norm" in low or "layernorm" in low else
            "elementwise")


def serve_prompts(n, length, vocab, dup, seed=0):
    """bench_serve's traffic: the leading ``dup`` share of every prompt is
    one shared template, the rest random, from ``RandomState(seed)``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    shared = rng.randint(0, vocab, size=int(length * dup)).tolist()
    return [shared + rng.randint(0, vocab, size=length - len(shared)).tolist()
            for _ in range(n)]


def serve_point(torch, lm, prompts, new_tokens, bs, *, spec_tokens,
                engine_kw=None, pp_stages=1, **ecfg):
    """One measured serving run (bench_serve's sweep point): a fresh engine
    at decode batch ``bs`` (``engine_kw``: a plan and mesh; ``pp_stages``:
    decode microbatches), a warm-up request, then every prompt through
    the frontend at once.  Per-token gaps, TTFT (submit to first token),
    decode tokens/s over the run's wall time, prefill tokens/s over the
    time spent in prefill calls, peak memory; the streams."""
    from chainermn_tpu_torch.serving import (ContinuousBatchingScheduler,
                                             EngineConfig, InferenceEngine,
                                             SamplingParams, ServeFrontend)

    cfg = dict(max_batch=bs)
    cfg.update(ecfg)
    engine = InferenceEngine(lm, EngineConfig(**cfg), **(engine_kw or {}))
    engine.pp_stages = pp_stages
    sched = ContinuousBatchingScheduler(engine, spec_tokens=spec_tokens)
    fe = ServeFrontend(sched, max_queue=len(prompts) + 1)
    fe.submit(prompts[0], new_tokens, sampling=SamplingParams())
    fe.run_until_idle()
    prefill_s = [0.0]

    def timed(fn):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                prefill_s[0] += time.perf_counter() - t
        return call

    engine.prefill = timed(engine.prefill)
    engine.prefill_cached = timed(engine.prefill_cached)
    if spec_tokens == 0 and engine.prefill_chunk:
        engine.chunk = timed(engine.chunk)     # every chunk is a slice
    cached0 = engine.stats()["tokens_prefix_cached"]
    stamps = {}

    def on_token(rid, tok):
        stamps.setdefault(rid, []).append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    handles = [fe.submit(p, new_tokens, sampling=SamplingParams(),
                         on_token=on_token) for p in prompts]
    fe.run_until_idle()
    wall = time.perf_counter() - t0
    st = engine.stats()
    gaps = sorted(b - a for ts in stamps.values() for a, b in zip(ts, ts[1:]))
    ttft = sorted(ts[0] - t0 for ts in stamps.values())

    def pct(xs, q):
        return xs[min(len(xs) - 1, int(q * len(xs)))] * 1e3 if xs else None

    n_prefill = (sum(len(p) for p in prompts)
                 - (st["tokens_prefix_cached"] - cached0))
    res = sched.results()
    row = {
        "batch_size": bs, "spec_tokens": spec_tokens,
        "tokens_per_s": sum(len(h.tokens) for h in handles) / wall,
        "p50_token_ms": pct(gaps, 0.5), "p99_token_ms": pct(gaps, 0.99),
        "ttft_p50_ms": pct(ttft, 0.5), "ttft_p99_ms": pct(ttft, 0.99),
        "prefill_tokens_per_s": n_prefill / max(prefill_s[0], 1e-9),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "wall_s": wall,
        "finished": sum(h.status == "finished" for h in handles),
        "requests": len(handles),
        "preemptions": sum(r.preemptions for r in res.values()),
        "shapes": {k: st[k] for k in ("prefill_compiles", "decode_compiles",
                                      "chunk_compiles")},
        "tokens_prefix_cached": st["tokens_prefix_cached"] - cached0,
        "cow_splits": st["cow_splits"],
    }
    if sched._spec_rows:
        row["spec_accept_len"] = sched._spec_emitted / sched._spec_rows
    if sched._prefix_lookup_tokens:
        row["prefix_hit_rate"] = (sched._prefix_hit_tokens
                                  / sched._prefix_lookup_tokens)
    if "kv_quant_err" in st:
        row["kv_quant_err"] = st["kv_quant_err"]
    if "draft_source" in st:
        row["draft_source"] = st["draft_source"]
    row["streams"] = [list(h.tokens) for h in handles]
    if row["finished"] != len(handles):
        raise AssertionError(f"{len(handles) - row['finished']} requests "
                             f"did not finish at B={bs}")
    return row


def decode_step_fn(torch, lm, prompts, bs, engine_kw=None, **ecfg):
    """``bs`` prompts prefilled on a fresh engine; returns a function
    running one decode step over them (each call rewrites the same slot)."""
    import numpy as np

    from chainermn_tpu_torch.serving import EngineConfig, InferenceEngine

    cfg = dict(max_batch=bs)
    cfg.update(ecfg)
    engine = InferenceEngine(lm, EngineConfig(**cfg), **(engine_kw or {}))
    sids, lens, toks = list(range(bs)), [], []
    for sid, p in zip(sids, prompts[:bs]):
        engine.kv.allocate(sid, len(p))
        toks.append(int(np.argmax(engine.prefill(p, sid))))
        engine.kv.extend(sid, len(p) + 1)
        lens.append(len(p))

    def step():
        return engine.decode(toks, sids, lens)

    step()
    return step


def count_launches(torch, fn):
    """Device kernels (and copies) one call of ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and not getattr(ev, "is_user_annotation", False))


def host_profile(fn, n=5, top=14):
    """``fn`` run ``n`` times under cProfile: host ms a call in all, and
    the port's functions by cumulative host ms a call (where the host's
    time in a decode step goes: the page routing, the attention, the
    projections and their casts)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n):
        fn()
    prof.disable()
    st = pstats.Stats(prof).stats
    total = sum(v[2] for v in st.values()) / n * 1e3
    rows = sorted(((v[3] / n * 1e3, v[1] // n,
                    f"{os.path.basename(k[0])}:{k[1]} {k[2]}")
                   for k, v in st.items()
                   if "chainermn_tpu_torch" in k[0]), reverse=True)
    return total, rows[:top]


def teacher_forced(torch, lm, streams, prompts, how, engine_kw=None,
                   **ecfg):
    """fp32 logits predicting every token of each ``prompts[i] +
    streams[i]``, fed through the engine (``engine_kw``: a plan and
    mesh): ``how`` is ``("decode", B)`` (rows decoded B at a time) or
    ``("chunk", T)`` (T tokens a step, 8 rows at a time).  Returns one
    (len(stream), V) array a request."""
    import numpy as np

    from chainermn_tpu_torch.serving import EngineConfig, InferenceEngine

    kind, width = how
    n = len(prompts)
    group = width if kind == "decode" else 8
    out = [None] * n
    for g0 in range(0, n, group):
        ids = list(range(g0, min(n, g0 + group)))
        cfg = dict(max_batch=len(ids))
        cfg.update(ecfg)
        engine = InferenceEngine(lm, EngineConfig(**cfg),
                                 **(engine_kw or {}))
        rows = {i: [] for i in ids}
        for i in ids:
            engine.kv.allocate(i, len(prompts[i]))
            rows[i].append(engine.prefill(prompts[i], i))
        L = len(streams[ids[0]])
        step = 1 if kind == "decode" else width
        for j in range(0, L - 1, step):
            feed = [streams[i][j:min(j + step, L - 1)] for i in ids]
            starts = [len(prompts[i]) + j for i in ids]
            for i, f, s0 in zip(ids, feed, starts):
                engine.kv.extend(i, s0 + len(f))
            if kind == "decode":
                got = engine.decode([f[0] for f in feed], ids, starts)
                for r, i in enumerate(ids):
                    rows[i].append(got[r])
            else:
                got = engine.chunk(feed, ids, starts)
                for r, i in enumerate(ids):
                    rows[i].extend(got[r, :len(feed[r])])
        for i in ids:
            out[i] = np.stack(rows[i])
    return out


def _rel_rows(a, b):
    """Largest |a - b| of each row over the row's largest |b|."""
    import numpy as np

    return float(np.max(np.abs(a - b).max(-1) / np.abs(b).max(-1)))


def phase_serving_contracts(torch, lm, groups, log, memo=None, phase="12e"):
    """(e): each group is ``name -> (prompts, reference streams, {run:
    streams}, engine config)``.  Every run's streams are held against the
    group's reference streams; a divergence must be explained by the
    reference stream's top-2 margin there against the teacher-forced logit
    differences between step shapes (decode at B 1 and B 8, 4-token
    chunks) on the reference streams; the engine is held against the dense
    model.  ``memo`` keeps each group's teacher-forced logits by name, so
    a later phase holds its runs to the same references without
    recomputing them."""
    import numpy as np

    out, bad = {"tol": SERVE_TOL}, []
    memo = {} if memo is None else memo
    for group, (prompts, refs, runs, ecfg) in groups.items():
        if group not in memo:
            tf1, tf8, tfc = (teacher_forced(torch, lm, refs, prompts, how,
                                            **ecfg)
                             for how in (("decode", 1), ("decode", 8),
                                         ("chunk", 4)))
            dense = []
            with torch.no_grad():
                for p, s, ref in zip(prompts, refs, tf1):
                    toks = torch.tensor([p + s[:-1]], device=lm.device)
                    d = lm(toks)[0, len(p) - 1:].float().cpu().numpy()
                    dense.append(_rel_rows(d, ref))
            memo[group] = (refs, tf1, tf8,
                           [max(_rel_rows(a, b), _rel_rows(c, b))
                            for a, b, c in zip(tf8, tf1, tfc)], dense)
        memo_refs, tf1, tf8, diffs, dense = memo[group]
        if memo_refs != refs:
            raise AssertionError(f"phase {phase}: group {group} reuses "
                                 "teacher-forced logits of other streams")
        g = out[group] = {"teacher_forced_max_rel": max(diffs),
                          "oracle_max_rel": max(dense), "runs": {}}
        for name, streams in runs.items():
            same, divs = 0, []
            for i, (s, a) in enumerate(zip(streams, refs)):
                if s == a:
                    same += 1
                    continue
                j = next(k for k, (x, y) in enumerate(zip(s, a)) if x != y)
                top = np.sort(tf1[i][j])[-2:]
                margin = float((top[1] - top[0]) / np.abs(tf1[i][j]).max())
                divs.append({"request": i, "position": j,
                             "margin_rel": margin,
                             "teacher_forced_rel": diffs[i]})
                if margin > diffs[i]:
                    bad.append(f"{group}/{name} request {i} diverged at {j} "
                               f"with top-2 margin {margin:.3g} > "
                               f"teacher-forced difference {diffs[i]:.3g}")
            g["runs"][name] = {"identical_share": same / len(refs),
                               "divergences": divs}
            log(f"serving contract {group}/{name}: {same}/{len(refs)} "
                f"streams identical to the reference streams; divergences "
                f"{divs}")
        log(f"serving contract {group}: teacher-forced logits (decode B 1 "
            f"vs B 8 and 4-token chunks) max {max(diffs):.3g} of the row's "
            f"largest |logit|, engine vs the dense model {max(dense):.3g} "
            f"(limit {SERVE_TOL:.3g})")
        if max(diffs) > SERVE_TOL:
            bad.append(f"{group}: teacher-forced logits differ by "
                       f"{max(diffs):.3g}")
        if max(dense) > SERVE_TOL:
            bad.append(f"{group}: engine vs the dense model "
                       f"{max(dense):.3g}")
    if bad:
        raise AssertionError(f"phase {phase}: " + "; ".join(bad))
    return out


def phase_serving(torch, K, log, card, keep=None):
    """Phase 12: (a) the bench_serve sweep, (b) shared prefixes against no
    prefix cache, (c) the model draft and int8 pages, (d) long prompts in
    slices, (e) the contracts, (f) the serve_lm example; no flash kernel
    may launch.  ``keep`` (a dict) receives what phase 13 is held to: the
    module, the prompts, the streams and phase 12's teacher-forced
    logits."""
    import numpy as np

    from chainermn_tpu_torch.examples import serve_lm
    from chainermn_tpu_torch.models.transformer import TransformerLM

    S, LG = SERVE, SERVE_LONG
    t0 = time.perf_counter()
    K.reset_launch_counts()
    lm = TransformerLM(vocab=FULL["vocab"], d_model=FULL["d_model"],
                       n_heads=FULL["n_heads"], d_ff=FULL["d_ff"],
                       n_layers=FULL["n_layers"], dtype=torch.bfloat16,
                       max_len=max(S["max_len"], LG["max_len"]), seed=0)
    lm.requires_grad_(False)
    V = lm.vocab
    n_params = sum(p.numel() for p in lm.parameters())
    geo = dict(block_size=S["block_size"], n_blocks=S["n_blocks"],
               max_len=S["max_len"])
    P, N = S["prompt_len"], S["new_tokens"]
    prompts = serve_prompts(S["requests"], P, V, 0.0)
    out = {"card": card, "params_m": n_params / 1e6, "config": S,
           "long_config": LG}
    log(f"serving lm {n_params / 1e6:.1f}M params, {S['requests']} requests "
        f"of {P} tokens, {N} new, pages {S['n_blocks']} x "
        f"{S['block_size']}")

    # (a)
    sweep, runs = [], {}
    for bs in S["batch_sizes"]:
        for spec in (S["spec_tokens"], 0):
            row = serve_point(torch, lm, prompts, N, bs, spec_tokens=spec,
                              **geo)
            runs[f"B{bs}_spec{spec}"] = row.pop("streams")
            row["launches_per_decode_step"] = count_launches(
                torch, decode_step_fn(torch, lm, prompts, bs, **geo))
            sweep.append(row)
            log(f"serve B={bs} spec={spec}: {row['tokens_per_s']:.1f} "
                f"tokens/s, per-token p50 {row['p50_token_ms']:.2f} ms p99 "
                f"{row['p99_token_ms']:.2f} ms, TTFT p50 "
                f"{row['ttft_p50_ms']:.1f} ms, prefill "
                f"{row['prefill_tokens_per_s']:.0f} tokens/s, peak "
                f"{row['peak_gib']:.2f} GiB, launches a decode step "
                f"{row['launches_per_decode_step']}, accept "
                f"{row.get('spec_accept_len')}, shapes {row['shapes']}")
    best = max((r for r in sweep if r["spec_tokens"] == 0),
               key=lambda r: r["tokens_per_s"])
    bb = best["batch_size"]
    out["sweep"] = sweep
    out["best_batch_size"] = bb
    wall, busy, kinds = profile_step(
        torch, decode_step_fn(torch, lm, prompts, bb, **geo),
        log, what=f"decode step B={bb}", kind_of=serve_kind)
    host_ms, host_rows = host_profile(decode_step_fn(torch, lm, prompts, bb,
                                                     **geo))
    out["profile"] = {"batch_size": bb, "wall_ms": wall, "busy_ms": busy,
                      "idle_share": 1 - busy / wall, "by_kind_ms": kinds,
                      "host_ms": host_ms, "host_cumulative_ms": host_rows}
    log(f"host profile: decode step B={bb} {host_ms:.1f} ms of host under "
        f"cProfile; cumulative ms a step by function: "
        + "; ".join(f"{name} {ms:.2f} (x{n})" for ms, n, name in host_rows))

    # (b)
    dup_prompts = serve_prompts(S["requests"], P, V, S["prefix_dup"])
    shared = serve_point(torch, lm, dup_prompts, N, bb,
                         spec_tokens=S["spec_tokens"], **geo)
    base = serve_point(torch, lm, dup_prompts, N, bb,
                       spec_tokens=S["spec_tokens"], prefix_cache=False,
                       **geo)
    prefix_cached = shared.pop("streams")
    dup_base = base.pop("streams")
    out["prefix"] = {"dup": S["prefix_dup"], "shared": shared,
                     "no_sharing": base,
                     "speedup": shared["tokens_per_s"] / base["tokens_per_s"]}
    log(f"serve prefix dup {S['prefix_dup']}: {shared['tokens_per_s']:.1f} "
        f"tokens/s against {base['tokens_per_s']:.1f} without the prefix "
        f"cache (speedup {out['prefix']['speedup']:.3f}), hit rate "
        f"{shared.get('prefix_hit_rate')}, cached tokens "
        f"{shared['tokens_prefix_cached']}, CoW splits "
        f"{shared['cow_splits']}")

    # (c)
    model_draft = serve_point(torch, lm, prompts, N, bb,
                              spec_tokens=S["spec_tokens"], draft="model",
                              **geo)
    runs["model_draft"] = model_draft.pop("streams")
    ngram = next(r for r in sweep if r["batch_size"] == bb
                 and r["spec_tokens"] == S["spec_tokens"])
    int8 = serve_point(torch, lm, prompts, N, bb, spec_tokens=0,
                       kv_dtype="int8", **geo)
    int8_streams = int8.pop("streams")
    out["draft"] = {"model": model_draft, "ngram_tokens_per_s":
                    ngram["tokens_per_s"], "ngram_accept_len":
                    ngram.get("spec_accept_len")}
    out["kv_int8"] = {"int8": int8, "full_tokens_per_s":
                      best["tokens_per_s"],
                      "identical_share": float(np.mean(
                          [a == b for a, b in
                           zip(int8_streams, runs[f"B{bb}_spec0"])]))}
    log(f"serve draft model: {model_draft['tokens_per_s']:.1f} tokens/s, "
        f"accept {model_draft.get('spec_accept_len')} against n-gram "
        f"{ngram['tokens_per_s']:.1f} tokens/s, accept "
        f"{ngram.get('spec_accept_len')}; int8 pages "
        f"{int8['tokens_per_s']:.1f} tokens/s against "
        f"{best['tokens_per_s']:.1f}, kv_quant_err "
        f"{int8['kv_quant_err']:.4g}, streams equal to full precision "
        f"{out['kv_int8']['identical_share']:.3f}")

    # (d)
    long_prompts = serve_prompts(LG["requests"], LG["prompt_len"], V, 0.0,
                                 seed=1)
    lrow = serve_point(torch, lm, long_prompts, LG["new_tokens"],
                       LG["max_batch"], spec_tokens=0,
                       block_size=LG["block_size"], n_blocks=LG["n_blocks"],
                       max_len=LG["max_len"],
                       prefill_chunk=LG["prefill_chunk"])
    lrow.pop("streams")
    out["long"] = lrow
    log(f"serve long {LG['requests']} x {LG['prompt_len']} tokens, slices "
        f"of {LG['prefill_chunk']}: TTFT p50 {lrow['ttft_p50_ms']:.1f} ms "
        f"p99 {lrow['ttft_p99_ms']:.1f} ms, decode p50 "
        f"{lrow['p50_token_ms']:.2f} ms p99 {lrow['p99_token_ms']:.2f} ms, "
        f"{lrow['tokens_per_s']:.1f} tokens/s, prefill "
        f"{lrow['prefill_tokens_per_s']:.0f} tokens/s, peak "
        f"{lrow['peak_gib']:.2f} GiB")

    # (e)
    from chainermn_tpu_torch.serving import EngineConfig, InferenceEngine

    eng = InferenceEngine(lm, EngineConfig(max_batch=8, **geo))
    alone = [eng.generate(p, N) for p in prompts]
    pinned = dict(geo, max_batch=8, batch_buckets=(8,))
    eng8 = InferenceEngine(lm, EngineConfig(**pinned))
    alone8 = [eng8.generate(p, N) for p in prompts]
    pinned_run = serve_point(torch, lm, prompts, N, 8, spec_tokens=0,
                             **pinned)["streams"]
    memo = {}
    out["contracts"] = phase_serving_contracts(torch, lm, {
        "alone": (prompts, alone, runs, geo),
        "prefix": (dup_prompts, dup_base,
                   {"prefix_cached": prefix_cached}, geo),
        "pinned_B8": (prompts, alone8, {"pinned_B8": pinned_run}, pinned),
    }, log, memo=memo)
    if keep is not None:
        keep.update(lm=lm, prompts=prompts, geo=geo, alone=alone, runs=runs,
                    memo=memo, row_b8=next(
                        r for r in sweep if r["batch_size"] == 8
                        and r["spec_tokens"] == 0), row_b8_spec=next(
                        r for r in sweep if r["batch_size"] == 8
                        and r["spec_tokens"] == S["spec_tokens"]))

    # (f)
    t = time.perf_counter()
    vocab = serve_lm.parser().parse_args([]).vocab
    losses, served = serve_lm.main([])
    off = [(p, s) for p, s in served
           if s != [(p[-1] + 1 + j) % vocab for j in range(len(s))]]
    out["example"] = {"final_loss": losses[-1], "requests": len(served),
                      "off_pattern": len(off),
                      "seconds": time.perf_counter() - t}
    log(f"serve_lm example: final loss {losses[-1]:.4f}, {len(served)} "
        f"requests, {len(off)} off the successor pattern "
        f"({out['example']['seconds']:.1f} s)")
    if off:
        raise AssertionError(f"phase 12f: off-pattern streams {off}")

    launches = flash_launches(K)
    out["flash_launches"] = launches
    if any(launches.values()):
        raise AssertionError(f"phase 12: flash kernels launched on the "
                             f"serving path: {launches}")
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 12: flash launches {launches}; {out['wall_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# Phase 13: TP decode, pipelined decode microbatches, the in-process
# serving cluster and the KV snapshot, on phase 12's configuration
# ---------------------------------------------------------------------------

# (c) three replicas on one card sharing phase 12's module: one prefill
# replica (every prompt takes the disaggregated path) and two decoders.
CLUSTER_ROLES = ("prefill", "decode", "decode")
CLUSTER_EVENT_TOKENS = 8     # the event lands once a victim stream has these


def _stamps_row(torch, handles, stamps, t0, wall):
    """tokens/s, TTFT and per-token percentiles, peak memory of a run."""
    gaps = sorted(b - a for ts in stamps.values() for a, b in zip(ts, ts[1:]))
    ttft = sorted(ts[0] - t0 for ts in stamps.values())

    def pct(xs, q):
        return xs[min(len(xs) - 1, int(q * len(xs)))] * 1e3 if xs else None

    return {"tokens_per_s": sum(len(h.tokens) for h in handles) / wall,
            "ttft_p50_ms": pct(ttft, 0.5), "ttft_p99_ms": pct(ttft, 0.99),
            "p50_token_ms": pct(gaps, 0.5), "p99_token_ms": pct(gaps, 0.99),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "wall_s": wall}


def _cluster(lm, n_prompts, geo):
    from chainermn_tpu_torch.serving import EngineConfig, InferenceEngine
    from chainermn_tpu_torch.serving.cluster import (HeartbeatMonitor,
                                                     Replica, ReplicaRouter)

    reps = [Replica(i, InferenceEngine(lm, EngineConfig(max_batch=8, **geo)),
                    role=role, max_queue=n_prompts + 1)
            for i, role in enumerate(CLUSTER_ROLES)]
    health = HeartbeatMonitor(list(range(len(reps))), miss_after_s=1e9)
    return reps, ReplicaRouter(reps, prefill_threshold=1, health=health)


def cluster_run(torch, lm, prompts, new_tokens, geo, event=None):
    """Every prompt through a three-replica router stepped by
    ``ThreadedClusterDriver`` (after one warm-up request); ``event``
    ``"fail"`` kills decode replica 1 once it holds a stream with
    ``CLUSTER_EVENT_TOKENS`` tokens, ``"migrate"`` drains it and moves its
    live streams to replica 2.  Returns (row, streams)."""
    from chainermn_tpu_torch.serving.cluster import ThreadedClusterDriver

    reps, router = _cluster(lm, len(prompts), geo)
    router.submit(prompts[0], new_tokens)
    router.run_until_idle()
    stamps = {}

    def on_token(rid, tok):
        stamps.setdefault(rid, []).append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    moved = 0
    with ThreadedClusterDriver(router) as drv:
        handles = [router.submit(p, new_tokens, on_token=on_token)
                   for p in prompts]
        if event is not None:
            deadline = time.monotonic() + 120
            while not any(h.replica_id == 1 and not h.done
                          and len(h.tokens) >= CLUSTER_EVENT_TOKENS
                          for h in handles):
                if time.monotonic() > deadline:
                    raise AssertionError(f"phase 13c: no stream reached "
                                         f"replica 1 before the {event}")
                router.step(drive_replicas=False)
                time.sleep(0.0005)
            if event == "fail":
                moved = router.fail_replica(1, "phase 13 kill")
            else:
                router.drain(1)
                moved = router.migrate_out(1)
        drv.run_until_idle(timeout_s=300.0)
    wall = time.perf_counter() - t0
    row = _stamps_row(torch, handles, stamps, t0, wall)
    row.update(event=event, moved=moved,
               finished=sum(h.status == "finished" for h in handles),
               failovers=sum(h.failovers for h in handles),
               migrations=sum(h.migrations for h in handles),
               prefill_replica_decoded=reps[0].engine._tokens_decoded,
               replicas=[h.replica_id for h in handles])
    bad = []
    if row["finished"] != len(prompts):
        bad.append(f"{len(prompts) - row['finished']} requests unfinished")
    if row["prefill_replica_decoded"]:
        bad.append(f"the prefill replica decoded "
                   f"{row['prefill_replica_decoded']} tokens")
    if event is not None and not moved:
        bad.append(f"the {event} moved no stream")
    for r in reps:
        if r.alive:
            r.engine.kv.assert_consistent()
    if bad:
        raise AssertionError(f"phase 13c ({event}): " + "; ".join(bad))
    return row, [list(h.tokens) for h in handles]


class _InProcessPlane:
    """An object plane inside one process: frames queued by tag."""

    def __init__(self):
        self.frames = {}

    def send(self, obj, dest, tag=0):
        self.frames.setdefault(tag, []).append(obj)

    def recv(self, source, tag=0, timeout_ms=None):
        return self.frames[tag].pop(0)


def phase_snapshot(torch, lm, prompt, want, geo, new_tokens, log):
    """(d): a running sequence's bf16 pages extracted after 8 decode
    steps, sent and received through an in-process plane, restored into a
    second engine: the pages bitwise equal and the continued stream equal
    to the uninterrupted one."""
    from chainermn_tpu_torch.serving import (EngineConfig, InferenceEngine,
                                             SamplingParams)
    from chainermn_tpu_torch.serving.cluster import (extract_sequence,
                                                     recv_snapshot,
                                                     restore_sequence,
                                                     send_snapshot)

    src = InferenceEngine(lm, EngineConfig(max_batch=8, **geo))
    dst = InferenceEngine(lm, EngineConfig(max_batch=8, **geo))
    sp = SamplingParams()
    src.kv.allocate("s", len(prompt))
    toks = [src.sample(src.prefill(prompt, "s"), sp, len(prompt))]
    cur = len(prompt)
    for _ in range(8):
        src.kv.extend("s", cur + 1)
        toks.append(src.sample(src.decode([toks[-1]], ["s"], [cur])[0], sp,
                               cur + 1))
        cur += 1
    t = time.perf_counter()
    snap = extract_sequence(src, "s", context=prompt + toks[:-1],
                            prompt_len=len(prompt))
    plane = _InProcessPlane()
    send_snapshot(plane, 1, snap)
    got = recv_snapshot(plane, 0)
    restore_sequence(dst, got, "t")
    torch.cuda.synchronize()
    move_ms = (time.perf_counter() - t) * 1e3
    back = extract_sequence(dst, "t")
    equal = all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
                for a, b in zip(snap.pages, back.pages))
    while len(toks) < new_tokens:
        dst.kv.extend("t", cur + 1)
        toks.append(dst.sample(dst.decode([toks[-1]], ["t"], [cur])[0], sp,
                               cur + 1))
        cur += 1
    out = {"pages": snap.n_pages, "leaves": len(snap.pages),
           "mib": snap.nbytes() / 2**20, "dtype": snap.dtypes[0],
           "pages_bitwise": equal, "stream_identical": toks == want,
           "move_ms": move_ms}
    log(f"serve snapshot: {out['pages']} pages x {out['leaves']} leaves "
        f"({out['mib']:.2f} MiB {out['dtype']}) extract -> send -> recv -> "
        f"restore {move_ms:.1f} ms; pages bitwise {equal}; continued "
        f"stream identical {toks == want}")
    if not (equal and toks == want):
        raise AssertionError(f"phase 13d: pages bitwise {equal}, stream "
                             f"identical {toks == want}")
    return out


def phase_serving_cluster(torch, K, log, card, keep):
    """Phase 13 on phase 12's module and traffic: (a) TP decode under plan
    ``tp`` on a 1 x 1 mesh, held bitwise to phase 12's one-device engine;
    (b) ``pp_stages`` 2 and 4, streams identical to ``pp_stages`` 1; (c)
    the three-replica cluster, plain, with a failover and with a live
    migration; (d) the KV snapshot.  Every stream is held to each request
    alone on one engine (phase 12 (e)'s contract); no flash kernel may
    launch."""
    import copy

    import numpy as np

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.parallel.sharding import build_device_mesh

    t0 = time.perf_counter()
    K.reset_launch_counts()
    lm, prompts, geo = keep["lm"], keep["prompts"], keep["geo"]
    alone, runs, row12 = keep["alone"], keep["runs"], keep["row_b8"]
    N = SERVE["new_tokens"]
    out = {"card": card}

    # (a)
    comm = cmn.create_communicator("pure_nccl", device="cuda")
    mesh = build_device_mesh(comm, (1,), ("model",), device="cuda")
    tp_lm = copy.deepcopy(lm)
    tp = dict(engine_kw=dict(plan="tp", mesh=mesh))
    row = serve_point(torch, tp_lm, prompts, N, 8, spec_tokens=0, **tp, **geo)
    tp_streams = row.pop("streams")
    tf_tp = teacher_forced(torch, tp_lm, alone, prompts, ("decode", 8), **tp,
                           **geo)
    tf12 = keep["memo"]["alone"][2]
    tf_equal = all(np.array_equal(a, b) for a, b in zip(tf_tp, tf12))
    steps = {}
    for name, mod, kw in (("plain", lm, {}), ("tp", tp_lm, tp)):
        step = decode_step_fn(torch, mod, prompts, 8, **kw, **geo)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        walls = []
        for _ in range(10):
            t = time.perf_counter()
            step()
            walls.append((time.perf_counter() - t) * 1e3)
        wall, busy, kinds = profile_step(torch, step, log, kind_of=serve_kind,
                                         what=f"decode step B=8 ({name})")
        steps[name] = {"step_ms": float(np.median(walls)),
                       "host_ms": host_profile(step)[0],
                       "profile_wall_ms": wall, "busy_ms": busy,
                       "idle_share": 1 - busy / wall,
                       "launches": count_launches(torch, step)}
    torch.distributed.destroy_process_group()
    local_kv = list(tp_lm.layers[0].attention.key.weight.to_local().shape)
    out["tp"] = {"mesh": "1 (model)", "row": row, "phase12_row": {
        k: row12[k] for k in ("tokens_per_s", "p50_token_ms", "p99_token_ms",
                              "ttft_p50_ms", "launches_per_decode_step")},
        "streams_bitwise": tp_streams == runs["B8_spec0"],
        "teacher_forced_b8_bitwise": tf_equal, "steps": steps,
        "key_weight_local": local_kv}
    log(f"serve tp (plan tp, 1 x 1 mesh): {row['tokens_per_s']:.1f} tokens/s "
        f"at B=8 against phase 12's {row12['tokens_per_s']:.1f}; per-token "
        f"p50 {row['p50_token_ms']:.2f} ms vs {row12['p50_token_ms']:.2f}; "
        f"decode step {steps['tp']['step_ms']:.1f} ms vs "
        f"{steps['plain']['step_ms']:.1f}, host under cProfile "
        f"{steps['tp']['host_ms']:.1f} ms vs {steps['plain']['host_ms']:.1f}, "
        f"idle share {steps['tp']['idle_share']:.3f} vs "
        f"{steps['plain']['idle_share']:.3f}, launches a step "
        f"{steps['tp']['launches']} vs {steps['plain']['launches']}; "
        f"streams bitwise {tp_streams == runs['B8_spec0']}, B=8 "
        f"teacher-forced logits bitwise {tf_equal}")
    if not (tp_streams == runs["B8_spec0"] and tf_equal):
        raise AssertionError("phase 13a: the TP engine on a 1 x 1 mesh is "
                             "not bitwise the one-device engine")
    del tp_lm, tf_tp
    torch.cuda.empty_cache()

    # (b)
    pp = {}
    for stages in (2, 4):
        r = serve_point(torch, lm, prompts, N, 8, spec_tokens=0,
                        pp_stages=stages, **geo)
        pp[f"pp{stages}"] = r.pop("streams")
        out[f"pp{stages}"] = r
        log(f"serve pp_stages={stages}: {r['tokens_per_s']:.1f} tokens/s at "
            f"B=8 (pp_stages 1: {row12['tokens_per_s']:.1f}), decode shapes "
            f"{r['shapes']}, streams identical to pp_stages 1 "
            f"{pp[f'pp{stages}'] == runs['B8_spec0']}")
        if pp[f"pp{stages}"] != runs["B8_spec0"]:
            raise AssertionError(
                f"phase 13b: the pp_stages={stages} streams differ from "
                f"pp_stages 1's")

    # (c)
    cluster = {}
    for event in (None, "fail", "migrate"):
        r, streams = cluster_run(torch, lm, prompts, N, geo, event)
        name = event or "plain"
        cluster[name] = streams
        out[f"cluster_{name}"] = r
        log(f"serve cluster {name}: {r['tokens_per_s']:.1f} tokens/s, TTFT "
            f"p50 {r['ttft_p50_ms']:.1f} ms p99 {r['ttft_p99_ms']:.1f} ms, "
            f"per-token p50 {r['p50_token_ms']:.2f} ms p99 "
            f"{r['p99_token_ms']:.2f} ms, peak {r['peak_gib']:.2f} GiB, "
            f"moved {r['moved']}, failovers {r['failovers']}, migrations "
            f"{r['migrations']}, prefill replica decoded "
            f"{r['prefill_replica_decoded']}")
    reps, router = _cluster(lm, len(prompts), geo)
    handles = [router.submit(p, N) for p in prompts]
    while not all(h.replica_id in (1, 2) and len(h.tokens) >= 2
                  for h in handles):
        router.step()
    out["cluster_launches_a_step"] = count_launches(torch, router.step)
    router.run_until_idle()
    log(f"serve cluster: {out['cluster_launches_a_step']} launches a router "
        f"step with both decode replicas at B=8 (one engine's decode step: "
        f"{row12['launches_per_decode_step']})")
    out["phase12_b8"] = {k: row12[k] for k in (
        "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "p50_token_ms",
        "p99_token_ms", "peak_gib", "launches_per_decode_step")}

    runs13 = dict(pp, tp=tp_streams,
                  **{f"cluster_{k}": v for k, v in cluster.items()})
    out["contracts"] = phase_serving_contracts(
        torch, lm, {"alone": (prompts, alone, runs13, geo)}, log,
        memo=keep["memo"], phase="13")

    # (d)
    out["snapshot"] = phase_snapshot(torch, lm, prompts[0], alone[0], geo, N,
                                     log)

    launches = flash_launches(K)
    out["flash_launches"] = launches
    if any(launches.values()):
        raise AssertionError(f"phase 13: flash kernels launched on the "
                             f"serving path: {launches}")
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 13: flash launches {launches}; {out['wall_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# Phase 14: the multi-process serving tier (cell serve-fleet-h100-1)
# ---------------------------------------------------------------------------

# serve-lm-h100-1's module and pages (phase 4's widths, bf16, seed 0,
# max_len 512, 512 pages of 16 a replica, decode batch 8) through
# ``python -m chainermn_tpu_torch.tools.serve``: 16 requests of the CLI's
# synthetic prompts (32-64 tokens), 32 new tokens, every odd request
# sampled (``--verify`` turns the sampled legs on).  ``--max-queue 8``
# lets each replica queue one batch, so the router's first placement pass
# spreads the 16 requests over two replicas (a full queue rejects and the
# router re-places).  ``--warm-start``: every replica serves a short
# request before its first load beat and the router holds the traffic
# until each has beaten, so the latencies exclude start-up.
FLEET_FLAGS = ["--vocab", "32768", "--d-model", "2048", "--heads", "16",
               "--d-ff", "8192", "--layers", "8", "--max-len", "512",
               "--block-size", "16", "--n-blocks", "512", "--max-batch", "8",
               "--max-queue", "8", "--requests", "16", "--prompt-len", "64",
               "--new-tokens", "32", "--seed", "0", "--warm-start",
               "--timeout-s", "300", "--miss-after-s", "30"]
FLEET_KILL_TOKENS = 40       # (b): replica rank 2 SIGKILLs itself after these
FLEET_RUN_S = 300            # each run's processes are joined under this


class GpuMemory:
    """Samples ``nvidia-smi --query-compute-apps=pid,used_memory`` and the
    card's ``memory.used`` every 0.5 s while running: ``peaks`` is the
    largest MiB seen a listed pid (inside a container every process may be
    listed under one pid), ``card_peak`` the card's largest used MiB."""

    def __init__(self):
        import threading

        self.peaks, self.card_peak = {}, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def _query(flags):
        try:
            return subprocess.run(["nvidia-smi"] + flags, capture_output=True,
                                  text=True, timeout=10).stdout
        except (OSError, subprocess.SubprocessError):
            return ""

    def _run(self):
        while not self._stop.is_set():
            for line in self._query(["--query-compute-apps=pid,used_memory",
                                     "--format=csv,noheader,nounits"]
                                    ).splitlines():
                parts = [x.strip() for x in line.split(",")]
                if len(parts) == 2 and parts[1].isdigit():
                    self.peaks[parts[0]] = max(self.peaks.get(parts[0], 0),
                                               int(parts[1]))
            used = self._query(["--query-gpu=memory.used",
                                "--format=csv,noheader,nounits"]).split()
            if used and used[0].isdigit():
                self.card_peak = max(self.card_peak, int(used[0]))
            self._stop.wait(0.5)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=15)


def fleet_args(extra=(), flags=None):
    """The CLI's own parse of the cell's flags (plus ``extra``)."""
    from chainermn_tpu_torch.tools import serve

    return serve.build_parser().parse_args(
        list(FLEET_FLAGS if flags is None else flags) + list(extra))


def fleet_replica_main(argv) -> int:
    """Worker mode of (b): one replica process of the kill run, through
    the CLI's own store and engine factory and ``service.run_replica``;
    the CLI flags follow ``--``.  Prints one JSON line (its rank,
    weights' crc32 and exit reason)."""
    from chainermn_tpu_torch.serving.cluster import service
    from chainermn_tpu_torch.tools import serve

    cut = argv.index("--")
    ap = argparse.ArgumentParser()
    ap.add_argument("--fleet-replica", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--kill-after-tokens", type=int, default=None)
    ap.add_argument("--flight-dir", required=True)
    a = ap.parse_args(argv[:cut])
    rank = a.fleet_replica
    args = fleet_args(["--role", "replica", "--coordinator", a.coordinator,
                       "--num-processes", str(a.num_processes),
                       "--process-id", str(rank)], flags=argv[cut + 1:])
    serve._init_distributed(args)
    built = []
    out = service.run_replica(
        rank, a.num_processes, serve._engine_factory(args, built),
        max_queue=args.max_queue, kill_after_tokens=a.kill_after_tokens,
        flight_path=os.path.join(a.flight_dir, f"flight_{rank}.jsonl"))
    print(json.dumps({"mode": "replica", "rank": rank,
                      **serve.module_info(built), **out,
                      **serve.cuda_memory(args.device)}), flush=True)
    return 0


def _fleet_reports(text):
    reps = {}
    for line in text.splitlines():
        if line.startswith("{"):
            d = json.loads(line)
            reps[d.get("mode")] = d
    return reps


def _scrape_until(url_file, proc, want, deadline):
    """Scrape the router's ``/metrics`` (its port in ``url_file``) until a
    page carries every string of ``want`` or the run ends; returns the
    last page read (None when none was)."""
    import urllib.request

    page = None
    while time.monotonic() < deadline and proc.poll() is None:
        if os.path.exists(url_file):
            try:
                with open(url_file) as f:
                    url = f"http://127.0.0.1:{int(f.read())}/metrics"
                with urllib.request.urlopen(url, timeout=5) as r:
                    page = r.read().decode()
                if all(w in page for w in want):
                    return page
            except (OSError, ValueError):
                pass
        time.sleep(0.05)
    return page


def fleet_cli(log, extra, tmp, name, meanwhile=None):
    """One run of ``tools.serve`` as a user starts it (router + replica
    processes); ``meanwhile()`` runs here while the replicas start (the
    traffic waits for them).  Returns (router report, launcher report,
    scrape, GPU memory sampled, the CLI's pid, wall s)."""
    flight = os.path.join(tmp, f"{name}_flight")
    port_file = os.path.join(tmp, f"{name}_port")
    cmd = [sys.executable, "-m", "chainermn_tpu_torch.tools.serve"] + \
        FLEET_FLAGS + list(extra) + [
            "--verify", "--flight-dir", flight,
            "--trace-out", os.path.join(tmp, f"{name}_trace.json"),
            "--metrics-port-file", port_file]
    err_path = os.path.join(tmp, f"{name}_stderr.txt")
    t0 = time.perf_counter()
    with GpuMemory() as mem, open(err_path, "w") as err_file:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=err_file,
                                text=True, cwd=os.path.dirname(
                                    os.path.abspath(__file__)))
        if meanwhile is not None:
            meanwhile()
        try:
            scrape = _scrape_until(
                port_file, proc, ['replica="1"', 'replica="2"'],
                time.monotonic() + FLEET_RUN_S) if name == "a" else None
            out = proc.communicate(timeout=FLEET_RUN_S)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            out = proc.communicate()[0]
    wall = time.perf_counter() - t0
    with open(err_path) as f:
        err = f.read()
    if proc.returncode is None or wall > FLEET_RUN_S:
        raise AssertionError(f"phase 14{name}: the CLI did not finish in "
                             f"{FLEET_RUN_S}s:\n{err[-3000:]}")
    reps = _fleet_reports(out)
    if "router" not in reps or "launcher" not in reps:
        raise AssertionError(f"phase 14{name}: no report (rc "
                             f"{proc.returncode}):\n{err[-3000:]}")
    log(f"fleet {name}: CLI exit {proc.returncode}, {wall:.1f}s wall")
    return reps["router"], reps["launcher"], scrape, mem, proc.pid, wall


def _explain(torch, lm, geo, prompts, samplings, oracle, fleet, memo, log,
             run, device="cuda"):
    """Phase 12 (e)'s contract for the streams of ``fleet`` that differ
    from ``oracle`` (both dicts gid -> tokens): teacher-force the oracle
    streams through decode at B 1 and B 8 and 4-token chunks on ``lm``,
    and, at the divergence, prefill the prompt with the oracle's tokens
    so far in one step (the step a failover's re-placement takes).  A
    greedy divergence must have its top-2 margin within the largest of
    those differences, a sampled one must sample the fleet's token from
    one of those step shapes' logits.  Returns the divergences; raises on
    one the contract does not explain."""
    import numpy as np

    from chainermn_tpu_torch.serving import (EngineConfig, InferenceEngine,
                                             SamplingParams)

    bad = [g for g in sorted(fleet) if fleet[g] != oracle[g]]
    if not bad:
        return []
    if "tf" not in memo:
        refs = [oracle[g] for g in range(len(prompts))]
        tf1, tf8, tfc = (teacher_forced(torch, lm, refs, prompts, how,
                                        engine_kw=dict(device=device), **geo)
                         for how in (("decode", 1), ("decode", 8),
                                     ("chunk", 4)))
        diffs = [max(_rel_rows(a, b), _rel_rows(c, b))
                 for a, b, c in zip(tf8, tf1, tfc)]
        memo["tf"] = (tf1, tf8, tfc, diffs)
    tf1, tf8, tfc, diffs = memo["tf"]
    eng = InferenceEngine(lm, EngineConfig(max_batch=1, **geo),
                          device=device)
    out, unexplained = [], []
    for g in bad:
        s, a = fleet[g], oracle[g]
        j = next(k for k, (x, y) in enumerate(zip(s, a)) if x != y)
        ctx = list(prompts[g]) + list(a[:j])
        eng.kv.allocate("x", len(ctx))
        pre = np.asarray(eng.prefill(ctx, "x"))
        eng.kv.free("x")
        pre_rel = _rel_rows(pre[None], tf1[g][j][None])
        limit = max(diffs[g], pre_rel)
        row = {"request": g, "position": j, "sampled": bool(samplings[g]),
               "teacher_forced_rel": diffs[g], "prefill_rel": pre_rel}
        if samplings[g]:
            sp, pos = SamplingParams(**samplings[g]), len(prompts[g]) + j
            alt = {InferenceEngine.sample(np.asarray(t), sp, pos)
                   for t in (tf8[g][j], tfc[g][j], pre)}
            row["step_shape_tokens"] = sorted(int(x) for x in alt)
            ok = s[j] in alt
        else:
            top = np.sort(tf1[g][j])[-2:]
            row["margin_rel"] = float((top[1] - top[0])
                                      / np.abs(tf1[g][j]).max())
            ok = row["margin_rel"] <= limit
        ok = ok and limit <= SERVE_TOL
        out.append(row)
        if not ok:
            unexplained.append(row)
    log(f"fleet {run}: {len(bad)} streams differ from the oracle: {out}")
    if unexplained:
        raise AssertionError(f"phase 14{run}: divergences the contract does "
                             f"not explain: {unexplained}")
    return out


def _postmortem(flight_dir, n_requests):
    """The flight files of every process of a run: one trace a request,
    no orphans, monotone clocks; the failover events seen."""
    from chainermn_tpu_torch.observability import tracing

    rows = tracing.read_flight_dir(os.path.join(flight_dir, "flight_*.jsonl"))
    trees = tracing.stitch(rows)
    vals = [tracing.validate_trace(t["spans"]) for t in trees.values()]
    return {"traces": len(trees), "requests": n_requests,
            "orphans": sum(len(v["orphans"]) for v in vals),
            "connected": sum(v["connected"] for v in vals),
            "monotone": sum(v["monotone"] for v in vals),
            "failover_events": sum(1 for r in rows if r.get("event") == "evt"
                                   and r.get("name") == "failover"),
            "stages": {k: {"count": v["count"], "p50_s": v["p50_s"],
                           "p99_s": v["p99_s"]}
                       for k, v in tracing.stage_percentiles(rows).items()}}


def fleet_kill_run(log, tmp, prompts, samplings):
    """(b): this process routes (the store's master) and two replica
    processes of this script's worker mode serve; rank 2 SIGKILLs itself
    after ``FLEET_KILL_TOKENS`` streamed tokens and the router fails its
    streams over to rank 1.  Returns (results, stats, the replicas' exit
    codes and reports, GPU MiB by pid, wall s)."""
    from chainermn_tpu_torch.communicators import kvtransport
    from chainermn_tpu_torch.serving.cluster import service
    from chainermn_tpu_torch.tools import serve

    flight = os.path.join(tmp, "b_flight")
    os.makedirs(flight, exist_ok=True)
    args = fleet_args(["--role", "router", "--coordinator", "127.0.0.1:0",
                       "--num-processes", "3", "--process-id", "0"])
    store = serve._init_distributed(args)
    me = os.path.abspath(__file__)
    procs, t0 = [], time.perf_counter()
    try:
        with GpuMemory() as mem:
            for rank in (1, 2):
                cmd = [sys.executable, me, "--fleet-replica", str(rank),
                       "--coordinator", f"127.0.0.1:{store.port}",
                       "--num-processes", "3", "--flight-dir", flight]
                if rank == 2:
                    cmd += ["--kill-after-tokens", str(FLEET_KILL_TOKENS)]
                cmd += ["--"] + FLEET_FLAGS
                procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              text=True))
            stats = {}
            requests = [{"prompt": p, "max_new_tokens": args.new_tokens,
                         "timeout_s": args.timeout_s, "sampling": s}
                        for p, s in zip(prompts, samplings)]
            results = service.run_router(
                3, requests, miss_after_s=args.miss_after_s,
                timeout_s=args.timeout_s,
                flight_path=os.path.join(flight, "flight_router.jsonl"),
                wait_ready=True, stats=stats)
            outs = [p.communicate(timeout=FLEET_RUN_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        kvtransport.uninstall()
        del store
    wall = time.perf_counter() - t0
    kids = [{"rank": r, "returncode": p.returncode,
             "report": _fleet_reports(o).get("replica")}
            for r, p, o in zip((1, 2), procs, outs)]
    log(f"fleet b: exits {[k['returncode'] for k in kids]}, {wall:.1f}s wall")
    return results, stats, kids, mem, wall, flight


def phase_serving_fleet(torch, K, log, card, keep, serving_cluster):
    """Phase 14 on the cell serve-fleet-h100-1: (a) ``tools.serve --groups
    2 --verify``: a router and two replica processes, the flight files
    stitched into a Chrome trace, one scrape of the router's ``/metrics``
    mid-run; (b) the same fleet with replica rank 2 SIGKILLed after 40
    streamed tokens, routed from this process; (c) ``tools.serve --tp 2
    --verify``: one shard group, a leader and a follower mirror.  Every
    request finishes, every process holds the same weights (crc32), every
    stream equals the oracle's or is explained by phase 12 (e)'s contract;
    (b)'s postmortem has one trace a request, no orphans and a failover
    event.  Records tokens/s, TTFT and per-token percentiles and each
    process's GPU memory beside 12a's B 8 engine and 13c's threaded fleet
    of this run."""
    import tempfile

    from chainermn_tpu_torch.serving import InferenceEngine, SamplingParams
    from chainermn_tpu_torch.tools import serve

    t0 = time.perf_counter()
    K.reset_launch_counts()
    torch.cuda.empty_cache()
    lm = keep["lm"]
    args = fleet_args()
    geo = dict(block_size=args.block_size, n_blocks=args.n_blocks,
               max_len=args.max_len)
    crc_here = serve.weights_crc32(lm)
    args.sampled = True
    prompts = serve._synthetic_prompts(args)
    samplings = serve._request_samplings(args, len(prompts))
    out = {"card": card, "config": {"flags": FLEET_FLAGS,
                                    "kill_after_tokens": FLEET_KILL_TOKENS,
                                    "prompt_lens": [len(p) for p in prompts]},
           "weights_crc32": crc_here, "smoke_pid": os.getpid()}
    memo, bad = {}, []
    tmp = tempfile.mkdtemp(prefix="fleet_", dir=os.environ.get("TMPDIR"))

    # The oracle, on this process's phase 12 module (the same seed and
    # widths as every replica's; their crc32 must equal crc_here), run
    # while (a)'s replicas build their modules.
    oracle = {}

    def run_oracle():
        eng = InferenceEngine(lm, serve._engine_config(args),
                              device=args.device)
        for g, (p, s) in enumerate(zip(prompts, samplings)):
            oracle[g] = eng.generate(
                p, args.new_tokens,
                sampling=SamplingParams(**s) if s else None)

    def check_run(name, router, kids):
        crcs = {k["report"]["weights_crc32"] for k in kids if k["report"]}
        row = {"statuses": router["statuses"],
               "router_cuda_mib": router.get("cuda_max_reserved_mib"),
               "replica_cuda_mib": [k["report"] and k["report"].get(
                   "cuda_max_reserved_mib") for k in kids],
               "failovers": router["failovers"],
               "tokens": router["tokens"],
               "tokens_per_s": router.get("serve_tokens_per_sec"),
               "ttft_p50_ms": router["latency"]["ttft_p50_s"] * 1e3,
               "ttft_p99_ms": router["latency"]["ttft_p99_s"] * 1e3,
               "p50_token_ms": router["latency"]["per_token_p50_s"] * 1e3,
               "p99_token_ms": router["latency"]["per_token_p99_s"] * 1e3,
               "ready_s": router["ready_s"],
               "serve_wall_s": router["serve_wall_s"],
               "exits": [k["returncode"] for k in kids],
               "streamed": [k["report"] and k["report"].get("streamed")
                            for k in kids]}
        if router["statuses"] != {"finished": len(prompts)}:
            bad.append(f"{name}: statuses {router['statuses']}")
        if crcs != {crc_here}:
            bad.append(f"{name}: weights crc32 {crcs} vs {crc_here}")
        par = router.get("parity_streams") or {}
        fleet = {g: (par[str(g)]["fleet"] if str(g) in par else oracle[g])
                 for g in range(len(prompts))}
        cli_oracle = {g: (par[str(g)]["oracle"] if str(g) in par
                          else oracle[g]) for g in range(len(prompts))}
        if cli_oracle != oracle:
            bad.append(f"{name}: the CLI's oracle differs from this "
                       f"process's")
        row["divergences"] = _explain(torch, lm, geo, prompts, samplings,
                                      oracle, fleet, memo, log, name,
                                      args.device)
        return row

    # (a)
    router, launcher, scrape, mem, cli_pid, wall = fleet_cli(
        log, ["--groups", "2"], tmp, "a", meanwhile=run_oracle)
    kids = launcher["processes"]
    ra = out["a"] = check_run("a", router, kids)
    ra["wall_s"], ra["gpu_mib"] = wall, mem.peaks
    ra["card_peak_mib"] = mem.card_peak
    ra["cli_pid"] = cli_pid
    ra["trace_stages"] = router.get("trace_stages")
    ra["scrape_series"] = sorted(set(re.findall(r'replica="[^"]+"',
                                                scrape or "")))
    if not (scrape and 'replica="1"' in scrape and 'replica="2"' in scrape):
        bad.append(f"a: the /metrics scrape lacks the replicas' series "
                   f"({ra['scrape_series']})")
    if any(k["returncode"] != 0 for k in kids) or min(
            k["report"]["streamed"] for k in kids) == 0:
        bad.append(f"a: replicas {kids}")

    # (b)
    results, stats, kids, mem, wall, flight = fleet_kill_run(
        log, tmp, prompts, samplings)
    fleet = {g: r["tokens"] for g, r in results.items()}
    lat = serve._latency(results)
    rb = out["b"] = {
        "statuses": {s: sum(r["status"] == s for r in results.values())
                     for s in {r["status"] for r in results.values()}},
        "failovers": sum(r["failovers"] for r in results.values()),
        "tokens": sum(len(v) for v in fleet.values()),
        "tokens_per_s": sum(len(v) for v in fleet.values())
        / stats["serve_wall_s"],
        "ttft_p50_ms": lat["ttft_p50_s"] * 1e3,
        "ttft_p99_ms": lat["ttft_p99_s"] * 1e3,
        "p50_token_ms": lat["per_token_p50_s"] * 1e3,
        "p99_token_ms": lat["per_token_p99_s"] * 1e3,
        "ready_s": stats["ready_s"], "serve_wall_s": stats["serve_wall_s"],
        "exits": [k["returncode"] for k in kids], "wall_s": wall,
        "gpu_mib": mem.peaks, "card_peak_mib": mem.card_peak,
        "replica_cuda_mib": [k["report"] and k["report"].get(
            "cuda_max_reserved_mib") for k in kids]}
    rb["postmortem"] = pm = _postmortem(flight, len(prompts))
    rb["divergences"] = _explain(torch, lm, geo, prompts, samplings, oracle,
                                 fleet, memo, log, "b", args.device)
    if rb["statuses"] != {"finished": len(prompts)}:
        bad.append(f"b: statuses {rb['statuses']}")
    if rb["exits"] != [0, -9] or rb["failovers"] == 0:
        bad.append(f"b: exits {rb['exits']}, failovers {rb['failovers']}")
    crc_b = kids[0]["report"] and kids[0]["report"]["weights_crc32"]
    if crc_b != crc_here:
        bad.append(f"b: survivor's weights crc32 {crc_b} vs {crc_here}")
    if not (pm["traces"] == len(prompts) and pm["orphans"] == 0
            and pm["connected"] == len(prompts)
            and pm["failover_events"] > 0):
        bad.append(f"b: postmortem {pm}")

    # (c)
    router, launcher, _, mem, cli_pid, wall = fleet_cli(
        log, ["--tp", "2"], tmp, "c")
    kids = launcher["processes"]
    rc = out["c"] = check_run("c", router, kids)
    rc["wall_s"], rc["gpu_mib"], rc["cli_pid"] = wall, mem.peaks, cli_pid
    rc["card_peak_mib"] = mem.card_peak
    rc["follower_applied"] = kids[1]["report"] and \
        kids[1]["report"].get("applied")
    if [k["returncode"] for k in kids] != [0, 0] or not rc["follower_applied"]:
        bad.append(f"c: shard group {kids}")

    row12 = keep["row_b8"]
    out["phase12_b8"] = {k: row12[k] for k in (
        "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "p50_token_ms",
        "p99_token_ms", "peak_gib")}
    cp = serving_cluster["cluster_plain"]
    out["phase13c_plain"] = {k: cp[k] for k in (
        "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "p50_token_ms",
        "p99_token_ms", "peak_gib")}
    for name in ("a", "b", "c"):
        r = out[name]
        log(f"serve fleet {name}: {r['tokens_per_s']:.1f} tokens/s, TTFT p50 "
            f"{r['ttft_p50_ms']:.1f} ms p99 {r['ttft_p99_ms']:.1f} ms, "
            f"per-token p50 {r['p50_token_ms']:.2f} ms p99 "
            f"{r['p99_token_ms']:.2f} ms, failovers {r['failovers']}, "
            f"ready {r['ready_s']:.1f}s, serving {r['serve_wall_s']:.2f}s, "
            f"CUDA MiB reserved by replica {r['replica_cuda_mib']} (router "
            f"{r.get('router_cuda_mib')}), card peak {r['card_peak_mib']} "
            f"MiB (nvidia-smi by pid {r['gpu_mib']}), divergences "
            f"{len(r['divergences'])}, wall {r['wall_s']:.1f}s")
    log(f"serve fleet against 12a B=8 {row12['tokens_per_s']:.1f} tokens/s "
        f"(TTFT p50 {row12['ttft_p50_ms']:.1f} ms) and 13c threaded fleet "
        f"{cp['tokens_per_s']:.1f} tokens/s (TTFT p50 "
        f"{cp['ttft_p50_ms']:.1f} ms); (b) postmortem {pm}")
    launches = flash_launches(K)
    out["flash_launches"] = launches
    if any(launches.values()):
        bad.append(f"flash kernels launched: {launches}")
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 14: {out['wall_s']:.1f}s")
    if bad:
        raise AssertionError("phase 14: " + "; ".join(bad))
    return out


# ---------------------------------------------------------------------------
# Phase 15: the training host planes
# ---------------------------------------------------------------------------

# 15b: the MNIST example at its defaults but 1 epoch (32 steps), a
# checkpoint a step, on the card under the supervisor, once unfaulted and
# once SIGKILLed at step 5.
HP_MNIST = ["--communicator", "pure_nccl", "--epochs", "1",
            "--checkpoint-every", "1"]
HP_JOB_TIMEOUT_S = 300
# 15a: steps with telemetry off and on, alternating, after the 7.
HP_AB_PAIRS = 5
# 15d: native CRC32C against the pure-Python one on this many bytes.
HP_CRC_BYTES = 1 << 18


def supervised(log, tmp, name, nproc, chaos, rank_cmd):
    """``python -m chainermn_tpu_torch.tools.elastic`` around ``rank_cmd``,
    with a supervisor step log; returns its report, its output and the
    supervisor's rows."""
    from chainermn_tpu_torch.observability.step_log import read_records

    repo = os.path.dirname(os.path.abspath(__file__))
    sup_log = os.path.join(tmp, f"{name}.sup.jsonl")
    cmd = [sys.executable, "-m", "chainermn_tpu_torch.tools.elastic",
           "--nproc", str(nproc), "--workdir", os.path.join(tmp, name),
           "--step-log", sup_log, "--grace", "10"]
    if chaos:
        cmd += ["--chaos", chaos]
    cmd += ["--", *rank_cmd]
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t = time.perf_counter()
    p = subprocess.run(cmd, cwd=repo, env=env, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True,
                       timeout=HP_JOB_TIMEOUT_S)
    wall = time.perf_counter() - t
    for line in p.stdout.splitlines():
        if not re.search(r"c10d|socket\.cpp", line):
            log("  | " + line)
    reports = [ln for ln in p.stdout.splitlines()
               if ln.startswith("ELASTIC_REPORT ")]
    if p.returncode != 0 or not reports:
        raise AssertionError(f"phase 15 {name}: supervisor exit "
                             f"{p.returncode}, no clean report")
    report = json.loads(reports[-1].split(" ", 1)[1])
    report["wall_s"] = wall
    return report, p.stdout, read_records(sup_log)


def spawn_to_first_step(sup_rows, rank_rows, first_steps):
    """Seconds from each incarnation's spawn to the end of its first step
    (rank 0's step row), incarnation by incarnation."""
    spawns = [r["t"] for r in sup_rows
              if r.get("event") == "elastic" and r.get("kind") == "spawn"]
    out = []
    for t_spawn, first in zip(spawns, first_steps):
        ends = [r["t"] for r in rank_rows if r.get("event") == "step"
                and r.get("rank") == 0 and r["step"] == first
                and r["t"] >= t_spawn]
        out.append(min(ends) - t_spawn if ends else None)
    return out


def hp_lm_telemetry(torch, K, log, train, tmp):
    """15a: phase 4's step under a Reporter and a StepRecorder."""
    import shutil

    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch.communicators.packing import GradPacker
    from chainermn_tpu_torch.observability import step_log
    from chainermn_tpu_torch.tools.obs import summarize

    step, batch, n_tokens = build_lm(torch, log)
    params = list(step.model.parameters())
    plan = GradPacker([p.shape for p in params], [p.dtype for p in params],
                      step.comm.resolve_bucket_bytes())
    path = os.path.join(tmp, "lm.jsonl")
    rep = obs.Reporter()
    n = N_WARMUP + N_TIMED
    losses, times, host, spans = [], [], [], []
    with obs.scope(rep), obs.StepRecorder(path) as rec:
        K.reset_launch_counts()
        for i in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = step(batch)
            host.append(time.perf_counter() - t)
            lv = loss.item()
            times.append(time.perf_counter() - t)
            losses.append(lv)
            row = rec.step(step=i, items=n_tokens, loss=lv)
            spans.append(row["spans"]["train_step"])
        launches = flash_launches(K)
    summary = rep.summary()
    # The same process and model, telemetry off and on step by step:
    # the host's time to return and the step, HP_AB_PAIRS of each.
    ab = {"off": {"host": [], "step": []}, "on": {"host": [], "step": []}}
    rec = obs.StepRecorder(os.path.join(tmp, "lm.ab.jsonl"))
    for i in range(2 * HP_AB_PAIRS):
        side = "on" if i % 2 else "off"
        with contextlib.ExitStack() as on:
            if side == "on":
                on.enter_context(obs.scope(obs.Reporter()))
                step_log.install(rec)
                on.callback(step_log.uninstall, rec)
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = step(batch)
            ab[side]["host"].append((time.perf_counter() - t) * 1e3)
            loss.item()
            ab[side]["step"].append((time.perf_counter() - t) * 1e3)
            if side == "on":
                rec.step(step=i, items=n_tokens, loss=loss.item())
    rec.close()
    ab = {side: {k: statistics.median(v) for k, v in d.items()}
          for side, d in ab.items()}
    torch.distributed.destroy_process_group()
    del step, batch, params
    torch.cuda.empty_cache()
    counters = summary["counters"]
    want = {"grad_pack/traces": 1, "grad_pack/leaves": plan.n_leaves,
            "grad_pack/buckets": plan.n_buckets,
            "grad_pack/payload_bytes": plan.payload_bytes,
            "grad_pack/pad_bytes": plan.padded_bytes - plan.payload_bytes}
    got = {k: counters.get(k) for k in want}
    med = sorted(times[N_WARMUP:])[N_TIMED // 2] * 1e3
    host_ms = sorted(host[N_WARMUP:])[N_TIMED // 2] * 1e3
    span_ms = sorted(spans[N_WARMUP:])[N_TIMED // 2] * 1e3
    summ = summarize(step_log.read_records(path))
    torn = os.path.join(tmp, "lm.torn.jsonl")
    shutil.copy(path, torn)
    with open(torn, "ab") as f:
        f.write(b'{"event": "step", "rank": 0, "t": 1.5, "st')
    kept = step_log.recover(torn)
    torn_steps = sum(1 for r in step_log.read_records(torn, strict=True)
                     if r.get("event") == "step")
    bitwise = losses == train["losses"]
    log(f"15a LM under telemetry: losses {losses} bitwise phase 4's "
        f"{bitwise}; train_step spans "
        f"{summary['scalars']['span/train_step']['count']}, "
        f"train_step_calls {counters.get('train_step_calls')}; grad_pack "
        f"{got} (plan {want}); launches {launches}; median step "
        f"{med:.2f} ms with telemetry against phase 4's "
        f"{train['step_ms']:.2f} ms without; host return {host_ms:.2f} ms "
        f"(phase 4 {train['host_ms']:.2f}), span {span_ms:.2f} ms; "
        f"alternating {HP_AB_PAIRS} pairs here: step {ab['on']['step']:.2f} "
        f"ms on, {ab['off']['step']:.2f} off, host return "
        f"{ab['on']['host']:.2f} ms on, {ab['off']['host']:.2f} off; "
        f"summarize steps {summ['steps']['count']}; recover kept {kept} "
        f"rows, {torn_steps} step rows")
    bad = []
    if not bitwise:
        bad.append(f"losses {losses} != phase 4's {train['losses']}")
    if summary["scalars"]["span/train_step"]["count"] != n or \
            counters.get("train_step_calls") != n:
        bad.append("train_step spans/calls != steps")
    if got != want:
        bad.append(f"grad_pack counters {got} != the plan's {want}")
    for name in KERNELS:
        if launches[name] != 8 * n:
            bad.append(f"{name} launched {launches[name]} times, not {8 * n}")
    if summ["steps"]["count"] != n or torn_steps != n:
        bad.append(f"step log: summarize {summ['steps']['count']} steps, "
                   f"{torn_steps} after recover")
    if bad:
        raise AssertionError("phase 15a: " + "; ".join(bad))
    return {"losses": losses, "bitwise_phase4": bitwise, "step_ms": med,
            "phase4_step_ms": train["step_ms"], "host_ms": host_ms,
            "phase4_host_ms": train["host_ms"], "span_ms": span_ms,
            "alternating": ab,
            "launches": launches, "grad_pack": got,
            "train_step_calls": counters.get("train_step_calls")}


def hp_mnist_supervised(log, tmp):
    """15b: MNIST under the supervisor on the card, unfaulted and with
    rank 0 SIGKILLed at step 5: the same parameters bitwise."""
    from chainermn_tpu_torch.observability.step_log import read_records

    runs = {}
    for name, chaos in (("unfaulted", None), ("kill", "kill:rank=0:step=5")):
        rank_log = os.path.join(tmp, f"mnist_{name}.jsonl")
        cmd = [sys.executable, "-m", "chainermn_tpu_torch.examples."
               "train_mnist", *HP_MNIST, "--elastic", "--checkpoint-dir",
               os.path.join(tmp, f"ck_{name}"), "--step-log", rank_log]
        log(f"15b mnist {name}: tools.elastic --nproc 1"
            + (f" --chaos {chaos}" if chaos else "") + f" -- {' '.join(cmd[1:])}")
        report, out, sup_rows = supervised(log, tmp, f"mnist_{name}", 1,
                                           chaos, cmd)
        rows = read_records(rank_log)
        firsts = [0] + ([report["resume_generation"]] if chaos else [])
        report["startup_s"] = spawn_to_first_step(sup_rows, rows, firsts)
        ips = [float(m.group(1).replace(",", "")) for m in
               re.finditer(r"\(([0-9,.]+) img/s\)", out)]
        report["img_per_s"] = ips
        runs[name] = report
        log(f"15b mnist {name}: report {json.dumps(report)}")
    clean, kill = runs["unfaulted"], runs["kill"]
    bad = []
    if kill["status"] != "ok" or kill["restarts"] != 1 \
            or kill["resume_generation"] is None:
        bad.append(f"killed run report {kill}")
    if clean["restarts"] or kill["params_digest"] != clean["params_digest"]:
        bad.append(f"digest {kill['params_digest']} against unfaulted "
                   f"{clean['params_digest']}")
    if bad:
        raise AssertionError("phase 15b: " + "; ".join(bad))
    return runs


def hp_param_distance(got, want):
    """Per tensor: relative L2, and the share of the limit reached, 7b's
    RESUME_REL_L2 of the norm (the resumable path trains with
    deterministic algorithms, so a resume that restores the right state
    ends bitwise)."""
    rel, share = {}, {}
    for k, v in want.items():
        diff = (got[k].float() - v).norm().item()
        norm = v.norm().item()
        rel[k] = diff / max(norm, 1e-30)
        share[k] = diff / max(RESUME_REL_L2 * norm, 1e-30)
    worst = max(share, key=share.get)
    return {"worst": worst, "share": share[worst], "rel_at_worst": rel[worst],
            "max_rel": max(rel.values()), "max_rel_at": max(rel, key=rel.get)}


def hp_imagenet_supervised(torch, log, tmp, ref):
    """15c: 7b's SGD run at full width under the supervisor with rank 0
    SIGTERMed at step 3: the preemption exit, the resumed world, and the
    end within the resume limits of 7b's uninterrupted run."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.observability.step_log import read_records

    npz = imagenet_npz(tmp)
    ck = os.path.join(tmp, "ck_imagenet")
    rank_log = os.path.join(tmp, "imagenet.jsonl")
    cmd = [sys.executable, "-m", "chainermn_tpu_torch.examples."
           "train_imagenet", *imagenet_args(npz), "--epochs", "2",
           "--elastic", "--checkpoint-dir", ck, "--checkpoint-every",
           str(EX_STEPS), "--step-log", rank_log]
    chaos = f"term:rank=0:step={EX_STEPS}"
    log(f"15c imagenet: tools.elastic --nproc 1 --chaos {chaos} -- "
        f"{' '.join(cmd[1:])}")
    torch.cuda.empty_cache()
    report, out, sup_rows = supervised(log, tmp, "imagenet", 1, chaos, cmd)
    rows = [r for r in read_records(rank_log)
            if r.get("event") == "step" and r.get("rank") == 0]
    last = {r["step"]: r["loss"] for r in rows}
    losses = [last[g] for g in range(EX_STEPS, 2 * EX_STEPS)]
    preempted = [r for r in sup_rows if r.get("event") == "elastic"
                 and r.get("kind") == "preempted"]
    codes = preempted[0]["codes"] if preempted else None
    startup = spawn_to_first_step(sup_rows, rows, [0, EX_STEPS])
    ips = [float(m.group(1).replace(",", "")) for m in
           re.finditer(r"([0-9,.]+) img/s \(", out)]
    comm = create_communicator("pure_nccl", device="cuda")
    saved, it = create_multi_node_checkpointer(
        "imagenet", comm, path=ck).maybe_load()
    torch.distributed.destroy_process_group()
    dist = hp_param_distance(
        {k: saved["model"][k] for k in ref["params"]}, ref["params"])
    loss_diff = max(abs(a - b) for a, b in zip(losses, ref["losses"]))
    res = {"report": report, "exit_codes": codes, "final_generation": it,
           "losses": losses, "ref_losses": ref["losses"],
           "loss_diff_vs_7b": loss_diff, "params_vs_7b": dist,
           "startup_s": startup, "img_per_s": ips}
    log(f"15c imagenet: report {json.dumps(report)}; preemption exit codes "
        f"{codes}; resumed from {report['resume_generation']}; last-epoch "
        f"losses {losses} against 7b's {ref['losses']}: diff "
        f"{loss_diff:.3g} (limit {RESUME_LOSS_ATOL}); worst parameter "
        f"{dist['worst']} at {dist['share']:.3g} of its limit (relative L2 "
        f"{dist['rel_at_worst']:.3g}; worst relative L2 {dist['max_rel']:.3g} "
        f"at {dist['max_rel_at']}); spawn to first step {startup} s; img/s "
        f"by incarnation {ips}")
    bad = []
    if report["status"] != "ok" or report["preemptions"] != 1 \
            or report["restarts"] != 0:
        bad.append(f"report {report}")
    if codes != {"0": 75}:
        bad.append(f"preemption exit codes {codes}")
    if f"preempted: checkpoint saved at iteration {EX_STEPS}" not in out:
        bad.append("no grace-window checkpoint line")
    if report["resume_generation"] != EX_STEPS or it != 2 * EX_STEPS:
        bad.append(f"resumed from {report['resume_generation']}, last "
                   f"generation {it}")
    if not (dist["share"] <= 1.0 and loss_diff <= RESUME_LOSS_ATOL):
        bad.append(f"{dist['worst']} at {dist['share']} of its limit, "
                   f"losses {loss_diff} from 7b's uninterrupted run")
    if bad:
        raise AssertionError("phase 15c: " + "; ".join(bad))
    return res


def hp_host_pieces(torch, log):
    """15d: the native host library: built, equal to the CPU's values,
    and ``parallel_gather`` timed against ``np.stack``."""
    import numpy as np

    from chainermn_tpu_torch.utils import native

    impl = native.native_impl()
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, HP_CRC_BYTES, dtype=np.uint8)
    crc, crc_py = native.crc32c(data), native._crc32c_py(data, 0)
    tree = {"w": torch.randn(64, 33, device="cuda").bfloat16(),
            "b": torch.randn(33, device="cuda"),
            "n": [torch.arange(7, device="cuda")]}
    digest = native.tree_digest(tree)
    want = 0
    for leaf in (tree["b"], tree["n"][0], tree["w"]):
        raw = leaf.cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
        want = native._crc32c_py(raw, want)
    s = RESNET["image"]
    items = [rng.standard_normal((s, s, 3), dtype=np.float32)
             for _ in range(RESNET["batch"])]
    times = {"parallel_gather": [], "np_stack": []}
    for _ in range(5):
        for name, fn in (("parallel_gather", native.parallel_gather),
                         ("np_stack", np.stack)):
            t = time.perf_counter()
            out = fn(items)
            times[name].append((time.perf_counter() - t) * 1e3)
    same = np.array_equal(native.parallel_gather(items), np.stack(items))
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    res = {"native_impl": impl, "crc32c_impl": native.crc32c_impl(),
           "crc32c": crc, "crc32c_cpu": crc_py, "tree_digest": digest,
           "tree_digest_cpu": want, "gather_ms": med,
           "gather_equal": bool(same),
           "batch_mib": out.nbytes / 2**20}
    log(f"15d host: native_impl {impl} (crc32c {res['crc32c_impl']}); "
        f"crc32c {crc:08x} against the CPU's {crc_py:08x}; tree_digest "
        f"{digest:08x} against {want:08x}; one ImageNet batch "
        f"({res['batch_mib']:.0f} MiB): parallel_gather "
        f"{med['parallel_gather']:.2f} ms, np.stack {med['np_stack']:.2f} "
        f"ms (median of 5), equal {same}")
    if impl != "csrc" or crc != crc_py or digest != want or not same:
        raise AssertionError(f"phase 15d: {res}")
    return res


def phase_host_planes(torch, K, log, card, train, imagenet_ref):
    """Phase 15: (a) the LM step under telemetry, (b) MNIST and (c)
    ImageNet under the elastic supervisor, (d) the native host library."""
    import tempfile

    t0 = time.perf_counter()
    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        out["lm_telemetry"] = hp_lm_telemetry(torch, K, log, train, tmp)
        out["mnist_supervised"] = hp_mnist_supervised(log, tmp)
        out["imagenet_supervised"] = hp_imagenet_supervised(
            torch, log, tmp, imagenet_ref)
    out["host"] = hp_host_pieces(torch, log)
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 15: {out['wall_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# Phase 16: the tuning plane and the resource fabric
# ---------------------------------------------------------------------------

# (a) the serving knobs at serve-lm-h100-1's geometry (phase 12's widths,
# max_len 512, 512 pages of 16, B 8), one slope sample a candidate
# (``--n1 1 --repeats 1``: the cut that keeps phase 16 within its budget;
# phase 4's shapes are the CLI's defaults and keep its three samples).
TUNE_SERVE_FLAGS = [
    "--kv-dtype", "--draft", "--prefill-chunk", "--serve-group",
    "--draft-vocab", str(FULL["vocab"]), "--draft-d-model",
    str(FULL["d_model"]), "--draft-d-ff", str(FULL["d_ff"]),
    "--draft-layers", str(FULL["n_layers"]), "--draft-max-len",
    str(SERVE["max_len"]), "--draft-blocks", str(SERVE["n_blocks"]),
    "--draft-batch", "8", "--kv-pages", str(SERVE["n_blocks"]),
    "--kv-page-size", str(SERVE["block_size"]), "--kv-batch", "8",
    "--serve-group-batch", "8", "--n1", "1", "--repeats", "1"]
# (c) the reference soak's flags (tests/test_multiprocess.py's fabric
# cases) with its steps and traffic as tests/test_torch_fabric_soak.py
# cuts them: the reference's 60 requests all at once (its peak without
# the clock), three times the 20 slots of two replicas of decode batch 4
# and queue 6, so the 0.8 queue watermark holds while the backlog lasts,
# in fleet steps whatever the card's speed (the reference's 30/s day let
# the card drain its peak before a queue built).
FABRIC_TRAIN = dict(steps=100, batch=24, dim=8, lr=0.05)
FABRIC_K_SPIKE = 3
FABRIC_FLAGS = [
    "--nproc", "2", "--replicas", "2",
    "--train-steps", str(FABRIC_TRAIN["steps"]), "--hb-timeout", "30",
    "--deadline-s", "60", "--k-spike", str(FABRIC_K_SPIKE), "--traffic",
    "requests=60,rate=1000000,tenants=2,vocab=24"]
# (d) the in-process fabric over phase 12's module: two replicas of decode
# batch 2 and queue 8, pressure at half a queue, phase 12's 16 prompts at
# once: after the first step 6 of 8 wait in each queue, and the watermark
# holds until three of a replica's requests have finished.
FABRIC_FULL = dict(max_batch=2, max_queue=8, queue_pressure_frac=0.5,
                   k_spike=2, traffic="requests=16,rate=1000000,vocab=24")
TUNED_LOSS_RTOL = 1e-4
# 16b's LM step on the tuned CE chunk against phase 4's on the default:
# the run-to-run band phase 4 itself is held to.
TUNED_STEP_RTOL = 0.02


def _cli_lines(log, module, args, timeout):
    """``python -m module args``: (JSON records of stdout, wall seconds);
    stderr logged behind ``  | ``."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", module, *args], cwd=repo,
                       env=env, capture_output=True, text=True,
                       timeout=timeout)
    wall = time.perf_counter() - t
    for line in p.stderr.splitlines():
        if not re.search(r"c10d|socket\.cpp", line):
            log("  | " + line)
    if p.returncode != 0:
        raise AssertionError(f"{module} exited {p.returncode}: "
                             f"{p.stdout[-2000:]}")
    return [json.loads(ln) for ln in p.stdout.splitlines()
            if ln.startswith("{")], wall


def _tuned_row(name, rec):
    """One tuned record's candidates, their seconds, the pick and the
    default; fails on a failed candidate or a default that was not timed.
    The pick is the fastest of these timings by construction, so pick
    against default is recorded here and re-timed in 16b."""
    if rec.get("chosen") is None or rec.get("cached"):
        raise AssertionError(f"phase 16a {name}: no fresh pick: {rec}")
    errors = [r["error"] for r in rec["results"] if r["error"]]
    if errors:
        raise AssertionError(f"phase 16a {name}: candidates failed: "
                             f"{errors}")
    if rec["default_seconds"] is None:
        raise AssertionError(f"phase 16a {name}: the default was not "
                             f"timed: {rec}")
    return {"key": rec["key"],
            "candidates": [r["config"] for r in rec["results"]],
            "seconds": [r["seconds"] for r in rec["results"]],
            "chosen": rec["chosen"], "chosen_s": rec["seconds"],
            "default_s": rec["default_seconds"],
            "speedup_vs_default": rec["speedup_vs_default"]}


def t16_autotune(torch, log, kind):
    """16a: ``tools.autotune`` on the card at phase 4's shapes, then the
    serving knobs; every record under the card's device kind."""
    from chainermn_tpu_torch.tuning import TuneCache, cache_path

    mod = "chainermn_tpu_torch.tools.autotune"
    lm_recs, lm_wall = _cli_lines(log, mod, [], 300)
    serve_recs, serve_wall = _cli_lines(log, mod, TUNE_SERVE_FLAGS, 400)
    recs = {}
    for line in lm_recs:
        recs.update(line)
    for line in serve_recs:
        (name, rec), = line.items()
        if name in recs:     # phase 4's shapes again: cached this time
            if not (rec.get("cached") or all(
                    rec[w].get("cached") for w in ("fwd", "bwd"))):
                raise AssertionError(f"phase 16a: {name} re-timed: {rec}")
            continue
        recs[name] = rec
    rows = {"flash_fwd": recs["flash"]["fwd"],
            "flash_bwd": recs["flash"]["bwd"]}
    rows.update((n, recs[n]) for n in ("fused_ce", "kv_dtype", "draft",
                                       "prefill_chunk", "serve_group"))
    out = {"cache_path": cache_path(), "lm_cli_s": lm_wall,
           "serve_cli_s": serve_wall, "records": {}}
    for name, rec in rows.items():
        row = out["records"][name] = _tuned_row(name, rec)
        log(f"16a {name}: candidates {row['candidates']} seconds "
            f"{row['seconds']}; chosen {row['chosen']} at {row['chosen_s']} "
            f"s, default {row['default_s']} s")
    cache = TuneCache(cache_path()).load()
    keys = cache.keys()
    wrong = [k for k in keys if k.split("|")[1] != kind
             or cache.get(k)["device_kind"] != kind]
    if wrong or set(keys) != {r["key"] for r in rows.values()}:
        raise AssertionError(f"phase 16a: cache keys {keys} (not under "
                             f"{kind!r}: {wrong})")
    out["entries"] = len(keys)
    log(f"16a: {len(keys)} entries under {kind!r} in {cache_path()}; CLI "
        f"{lm_wall:.1f} s + {serve_wall:.1f} s")
    return out


def t16_tuned(torch, K, log, train, keep, tuned):
    """16b: the lookups on against 16a's cache: phase 4's LM step with the
    tuned CE chunk, phase 12a's B 8 runs on the tuned serving knobs."""
    from chainermn_tpu_torch.ops.fused_ce import _resolve_chunk
    from chainermn_tpu_torch.serving import EngineConfig, InferenceEngine
    from chainermn_tpu_torch.tuning import runtime_lookup_enabled, \
        shared_cache

    shared_cache().load()    # the CLI wrote the file from its own process
    if not runtime_lookup_enabled():
        raise AssertionError("phase 16b: lookups are off on the card")
    recs = tuned["records"]
    B, S = FULL["batch"], FULL["seq"]
    chunk = _resolve_chunk(None, B * S, FULL["vocab"], FULL["d_model"],
                           torch.bfloat16)
    if chunk != recs["fused_ce"]["chosen"]["chunk"]:
        raise AssertionError(f"phase 16b: CE chunk resolves to {chunk}, "
                             f"16a chose {recs['fused_ce']['chosen']}")
    step, batch, n_tokens = build_lm(torch, log, ce_chunk=None)
    K.reset_launch_counts()
    losses, times = [], []
    for i in range(N_WARMUP + N_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(step(batch).item())
        times.append(time.perf_counter() - t)
    launches = flash_launches(K)
    torch.distributed.destroy_process_group()
    med = statistics.median(times[N_WARMUP:]) * 1e3
    rel = abs(losses[0] - train["losses"][0]) / abs(train["losses"][0])
    out = {"ce_chunk": chunk, "lm_losses": losses, "lm_step_ms": med,
           "phase4_step_ms": train["step_ms"], "loss0_rel": rel,
           "lm_launches": launches}
    log(f"16b LM, CE chunk {chunk} (phase 4: {FULL['ce_chunk']}): losses "
        f"{losses}, step-0 relative difference to phase 4 {rel:.3g}, median "
        f"step {med:.1f} ms beside phase 4's {train['step_ms']:.1f} ms, "
        f"launches {launches}")
    if rel > TUNED_LOSS_RTOL or not all(v > 0 for v in launches.values()):
        raise AssertionError(f"phase 16b: step-0 loss {losses[0]} against "
                             f"{train['losses'][0]} ({rel:.3g}), launches "
                             f"{launches}")
    if med > train["step_ms"] * (1 + TUNED_STEP_RTOL):
        raise AssertionError(f"phase 16b: the LM step on the tuned CE chunk "
                             f"{chunk} took {med:.1f} ms against phase 4's "
                             f"{train['step_ms']:.1f} ms on "
                             f"{FULL['ce_chunk']}")

    lm, prompts, geo = keep["lm"], keep["prompts"], keep["geo"]
    N = SERVE["new_tokens"]
    eng = InferenceEngine(lm, EngineConfig(max_batch=8, **geo))
    resolved = {"kv_dtype": eng.kv_dtype, "draft": eng.draft_source,
                "draft_layers": (eng.draft_model.n_layers
                                 if eng.draft_model is not None else 0),
                "prefill_chunk": eng.prefill_chunk}
    del eng
    want = {"kv_dtype": recs["kv_dtype"]["chosen"]["kv_dtype"],
            "draft": recs["draft"]["chosen"]["draft"],
            "prefill_chunk": recs["prefill_chunk"]["chosen"][
                "prefill_chunk"]}
    if (resolved["kv_dtype"] or "none") != want["kv_dtype"] or \
            resolved["draft"] != want["draft"] or \
            resolved["prefill_chunk"] != want["prefill_chunk"]:
        raise AssertionError(f"phase 16b: the engine resolves {resolved}, "
                             f"16a chose {want}")
    out["serving_resolved"] = resolved
    rows, runs = {}, {}
    for spec, base in ((0, keep["row_b8"]), (SERVE["spec_tokens"],
                                             keep["row_b8_spec"])):
        row = serve_point(torch, lm, prompts, N, 8, spec_tokens=spec, **geo)
        runs[f"tuned_B8_spec{spec}"] = row.pop("streams")
        row["phase12_tokens_per_s"] = base["tokens_per_s"]
        rows[f"spec{spec}"] = row
        log(f"16b serve B=8 spec={spec} on {resolved}: "
            f"{row['tokens_per_s']:.1f} tokens/s beside phase 12a's "
            f"{base['tokens_per_s']:.1f}, {row['finished']}/"
            f"{row['requests']} finished, kv_quant_err "
            f"{row.get('kv_quant_err')}")
    out["serving"] = rows
    if resolved["kv_dtype"] is None:
        out["contracts"] = phase_serving_contracts(
            torch, lm, {"alone": (prompts, keep["alone"], runs, geo)}, log,
            memo=keep["memo"], phase="16b")
    else:
        out["kv_quant_err"] = rows["spec0"]["kv_quant_err"]
    return out


def t16_fabric_cli_start(tmp):
    """16c: start ``tools.fabric --device cuda`` as the oracle arm and the
    arbiter arm, side by side (and beside 16d); returns ``(procs, t0)``,
    each arm's output going to a file under ``tmp``."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=repo
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = {}
    t0 = time.perf_counter()
    for arm, extra in (("oracle", ["--no-arbiter"]), ("arbiter", [])):
        with open(os.path.join(tmp, f"{arm}.out"), "w") as f:
            procs[arm] = subprocess.Popen(
                [sys.executable, "-m", "chainermn_tpu_torch.tools.fabric",
                 "--device", "cuda", *FABRIC_FLAGS, "--workdir",
                 os.path.join(tmp, arm), *extra],
                cwd=repo, env=env, stdout=f, stderr=subprocess.STDOUT)
    return procs, t0


def t16_fabric_cli_finish(log, tmp, procs, t0):
    """16c: each arm's report, held to the reference soak's assertions."""
    from chainermn_tpu_torch.tools.fabric import worker_oracle_digest

    out = {}
    for arm, p in procs.items():
        try:
            p.wait(timeout=max(1.0, 200 - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"phase 16c: the {arm} arm timed out")
        with open(os.path.join(tmp, f"{arm}.out")) as f:
            text = f.read()
        reports = [ln for ln in text.splitlines()
                   if ln.startswith("FABRIC_REPORT ")]
        if p.returncode != 0 or not reports:
            for line in text.splitlines()[-40:]:
                log("  | " + line)
            raise AssertionError(f"phase 16c: the {arm} arm exited "
                                 f"{p.returncode}")
        out[arm] = json.loads(reports[-1].split(" ", 1)[1])
        out[arm]["wall_s"] = time.perf_counter() - t0
    digest = worker_oracle_digest(**FABRIC_TRAIN)
    bad = []
    for arm, r in out.items():
        tr = r["train"]
        if tr["status"] != "ok" or tr["params_digest"] != digest:
            bad.append(f"{arm}: training {tr}")
        if r["dropped_streams"] or r["parity"]["mismatches"] or \
                not r["parity"]["checked"] or not r["ledger_conserved"]:
            bad.append(f"{arm}: dropped {r['dropped_streams']}, parity "
                       f"{r['parity']}, conserved {r['ledger_conserved']}")
        log(f"16c {arm}: wall {r['wall_s']:.1f} s, transitions "
            f"{r['transitions']}, training {tr}, goodput "
            f"{r['serve']['goodput_tps']:.1f} tokens/s, burn rates "
            f"{r['burn_rates']}, {r['parity']['checked']} streams checked, "
            f"queue pressure {r['pressure']} (k_spike {FABRIC_K_SPIKE})")
    arb = out["arbiter"]
    tr = arb["train"]
    if (arb["transitions"].get("preempt_for_serving", 0) < 1
            or arb["transitions"].get("return_to_training", 0) < 1
            or tr["lease_rescales"] < 2 or tr["restarts"] != 0):
        bad.append(f"arbiter: transitions {arb['transitions']}, training "
                   f"{tr}")
    for ev in arb["ledger"]["events"]:
        if ev["granted"] + ev["free"] != ev["total"]:
            bad.append(f"ledger event {ev}")
    if bad:
        raise AssertionError("phase 16c: " + "; ".join(bad))
    out["oracle_digest"] = digest
    return out


def t16_fabric_full(torch, log, keep, oracle_digest):
    """16d: a ``FabricArbiter`` in this process over two replicas sharing
    phase 12's module, a ledger of 4 cards and the 2-rank fabric worker
    under the real supervisor, through one diurnal trace."""
    import dataclasses
    import tempfile

    from chainermn_tpu_torch.fabric import (ChipLedger, FabricArbiter,
                                            FabricPolicy, FabricPolicyConfig,
                                            TrainerHandle)
    from chainermn_tpu_torch.tools.fabric import PressureLog
    from chainermn_tpu_torch.observability.reporter import Reporter
    from chainermn_tpu_torch.serving import (EngineConfig, InferenceEngine,
                                             workload)
    from chainermn_tpu_torch.serving.cluster import (Autoscaler,
                                                     AutoscalerConfig,
                                                     HeartbeatMonitor,
                                                     Replica, ReplicaRouter)
    from chainermn_tpu_torch.tools import fabric as tools_fabric

    lm, prompts, geo = keep["lm"], keep["prompts"], keep["geo"]
    N, F = SERVE["new_tokens"], FABRIC_FULL
    reporter = Reporter()

    def make_replica(rid):
        return Replica(rid, InferenceEngine(lm, EngineConfig(
            max_batch=F["max_batch"], **geo)), role="both",
            reporter=reporter, max_queue=F["max_queue"])

    reps = [make_replica(f"s{i}") for i in range(2)]
    router = ReplicaRouter(reps, reporter=reporter, health=HeartbeatMonitor(
        [r.replica_id for r in reps], miss_after_s=30.0))
    scaler = Autoscaler(router, make_replica, AutoscalerConfig(
        min_replicas=1, max_replicas=64, k_up=2, k_down=10 ** 6,
        cooldown_s=0.5, queue_pressure_frac=F["queue_pressure_frac"]),
        reporter=reporter)
    spec = workload.TrafficSpec.parse(F["traffic"])
    arrivals = [dataclasses.replace(a, prompt=tuple(prompts[a.index]),
                                    max_new_tokens=N, tenant=None)
                for a in workload.generate(spec)]
    args = tools_fabric.build_parser().parse_args(
        ["--nproc", "2", "--train-steps", str(FABRIC_TRAIN["steps"]),
         "--train-batch", str(FABRIC_TRAIN["batch"]), "--train-dim",
         str(FABRIC_TRAIN["dim"]), "--lr", str(FABRIC_TRAIN["lr"]),
         "--hb-timeout", "30"])
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        sup = tools_fabric.trainer_supervisor(args, tmp,
                                              os.path.join(tmp, "ckpt"))
        thread, box = tools_fabric.start_trainer(sup)
        ledger = ChipLedger(4)
        arb = FabricArbiter(ledger, TrainerHandle(sup), scaler,
                            policy=FabricPolicy(FabricPolicyConfig(
                                min_train_ranks=1, min_serve_replicas=1,
                                k_spike=F["k_spike"], k_trough=4,
                                cooldown_s=0.75,
                                max_train_ranks=2)), reporter=reporter)
        arb.bootstrap()
        stamps = {}
        pressure = PressureLog(router, F["queue_pressure_frac"])

        def pump():
            router.step()
            scaler.step()
            pressure.poll()
            ev = arb.step()
            if ev is not None:
                stamps.setdefault(ev["action"], time.perf_counter())

        def submit(a):
            return router.submit(list(a.prompt), a.max_new_tokens,
                                 timeout_s=600.0)

        t0 = time.perf_counter()
        report = workload.replay(arrivals, submit, pump=pump,
                                 drain_timeout_s=300.0)
        serve_s = time.perf_counter() - t0
        deadline = time.monotonic() + 90.0
        while time.monotonic() < deadline and not (
                arb.transitions["return_to_training"] >= 1
                and arb._pending is None):
            pump()
            if not sup.running and arb._pending is None:
                break
            time.sleep(0.01)
        router.run_until_idle()
        thread.join(timeout=300.0)
        arb.step()
        train = box.get("report") or {"status": "timeout"}
    streams = [list(o.handle.tokens) for o in sorted(
        report.outcomes, key=lambda o: o.arrival.index)]
    summary = workload.summarize(report)
    dropped = (summary["offered"] - summary["finished"] - summary["shed"]
               - summary["rejected"])
    out.update(train=train, transitions=dict(arb.transitions),
               events=[{k: v for k, v in ev.items() if k != "t"}
                       for ev in arb.events],
               ledger_conserved=ledger.conserved(), dropped_streams=dropped,
               serve=summary, serve_s=serve_s,
               pressure=pressure.as_report(),
               tokens_per_s=sum(map(len, streams)) / serve_s)
    if "drain_start" in stamps and "regrow_start" in stamps:
        out["drain_to_retire_s"] = stamps["regrow_start"] - \
            stamps["drain_start"]
    log(f"16d: transitions {out['transitions']}, events "
        f"{[e['action'] for e in out['events']]}, training {train}, "
        f"{summary['finished']}/{summary['offered']} finished, dropped "
        f"{dropped}, {out['tokens_per_s']:.1f} tokens/s over {serve_s:.1f} "
        f"s, drain -> migrate -> retire {out.get('drain_to_retire_s')} s, "
        f"ledger conserved {out['ledger_conserved']}, queue pressure "
        f"{out['pressure']} (k_spike {F['k_spike']})")
    bad = []
    if train.get("status") != "ok" or \
            train.get("params_digest") != oracle_digest:
        bad.append(f"training {train} (16c oracle {oracle_digest})")
    if out["transitions"]["preempt_for_serving"] < 1 or \
            out["transitions"]["return_to_training"] < 1:
        bad.append(f"transitions {out['transitions']}")
    if dropped or summary["finished"] != len(prompts) or \
            not out["ledger_conserved"]:
        bad.append(f"dropped {dropped}, finished {summary['finished']}, "
                   f"conserved {out['ledger_conserved']}")
    if bad:
        raise AssertionError("phase 16d: " + "; ".join(bad))
    # Drains migrate a replica's live streams: one more step shape that
    # 12e's teacher-forced limits cover.
    out["contracts"] = phase_serving_contracts(
        torch, lm, {"alone": (prompts, keep["alone"], {"fabric": streams},
                              geo)}, log, memo=keep["memo"], phase="16d")
    return out


def phase_tuning_fabric(torch, K, log, card, kind, train, keep):
    """Phase 16: (a) ``tools.autotune`` on the card, (b) the port on its
    tuned knobs, (c) ``tools.fabric`` on the card, (d) the fabric at full
    width in this process."""
    import tempfile

    from chainermn_tpu_torch.tools.fabric import worker_oracle_digest

    t0 = time.perf_counter()
    out = {"card": card}
    out["autotune"] = t16_autotune(torch, log, kind)
    out["tuned"] = t16_tuned(torch, K, log, train, keep, out["autotune"])
    # 16c's processes and 16d share the card and the host: one trainer
    # and fleet each, started together to keep phase 16 in its budget.
    with tempfile.TemporaryDirectory() as tmp:
        procs, tc = t16_fabric_cli_start(tmp)
        try:
            out["fabric_full"] = t16_fabric_full(
                torch, log, keep, worker_oracle_digest(**FABRIC_TRAIN))
            out["fabric_cli"] = t16_fabric_cli_finish(log, tmp, procs, tc)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    oracle = out["fabric_cli"]["oracle"]["train"]["params_digest"]
    if out["fabric_full"]["train"]["params_digest"] != oracle:
        raise AssertionError(f"phase 16d: digest against 16c's oracle "
                             f"{oracle}")
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 16: {out['wall_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# Phase 17: the linter on the card
# ---------------------------------------------------------------------------

#: ``tools.lint`` runs of 17b: (name, arguments, expected exit code).
LINT_CLI = (
    ("clean_gate", ("--device", "cuda", "--world", "1"), 0),
    ("fixtures", ("--fixtures", "--device", "cpu", "--world", "2"), 1),
    ("host", ("--host",), 0),
    ("self", ("--self",), 0),
)


def lint_lm(torch, K, log, train):
    """17a: phase 4's LM step built under ``CHAINERMN_TPU_LINT=strict``:
    the first call lints (a capture of the step, then the rules) and runs;
    the hooked step's report, the census and the taint of every flash
    custom op, and the losses and times of phase 4's run."""
    from chainermn_tpu_torch.analysis import dataflow
    from chainermn_tpu_torch.analysis.core import LintContext

    # Phase 12's module (kept for phases 13-16) is alive here: peaks are
    # counted above this allocation, as phase 4's are above its empty one.
    base = torch.cuda.memory_allocated()
    os.environ["CHAINERMN_TPU_LINT"] = "strict"
    try:
        step, batch, n_tokens = build_lm(torch, log)
    finally:
        del os.environ["CHAINERMN_TPU_LINT"]
    n = N_WARMUP + N_TIMED
    K.reset_launch_counts()
    losses, times, peaks = [], [], []
    for i in range(n):
        if i < 2:      # the first call (capture + step) and the rest
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(batch)
        lv = loss.item()
        times.append(time.perf_counter() - t)
        losses.append(lv)
        if i == 0:
            peaks.append(torch.cuda.max_memory_allocated())
    torch.cuda.synchronize()
    peaks.append(torch.cuda.max_memory_allocated())
    peaks = [pk - base for pk in peaks]
    peak = max(peaks)
    lint_s = step.lint["seconds"]
    launches = flash_launches(K)
    report = step.lint["report"]
    prog = report.program
    labels = LintContext(program=prog, comm=step.comm).labels()
    res = dataflow.propagate(prog, labels, 0)
    counts = prog.op_counts()
    census = {name: counts.get(f"chainermn_torch.{name}", 0)
              for name in KERNELS}
    tainted = {name: [bool(res.op_out[op.index]) for op in prog.ops
                      if op.name == f"chainermn_torch.{name}"]
               for name in KERNELS}
    torch.distributed.destroy_process_group()
    del step, batch
    torch.cuda.empty_cache()
    med = sorted(times[N_WARMUP:])[N_TIMED // 2] * 1e3
    bitwise = losses == train["losses"]
    out = {"rules_run": list(report.rules_run),
           "rules_skipped": list(report.rules_skipped),
           "findings": [f.summary() for f in report.findings],
           "labels": {k: sorted(v) for k, v in labels.items()},
           "ops": len(prog.ops), "events": len(prog.events),
           "census": census, "captured_launches": prog.launches,
           "tainted_layers": {k: sum(v) for k, v in tainted.items()},
           "snapshot_bytes": prog.snapshot_bytes,
           "first_call_ms": times[0] * 1e3,
           "lint_ms": lint_s * 1e3, "step_ms": med,
           "phase4_step_ms": train["step_ms"],
           "peak_mem_gib": peak / 2**30,
           "peak_first_call_gib": peaks[0] / 2**30,
           "peak_later_steps_gib": peaks[1] / 2**30,
           "held_before_gib": base / 2**30,
           "phase4_peak_gib": train["peak_mem_gib"], "losses": losses,
           "bitwise_phase4": bitwise, "launches": launches}
    log(f"17a LM under CHAINERMN_TPU_LINT=strict: lint clean {report.ok}; "
        f"rules_run {out['rules_run']}, rules_skipped "
        f"{out['rules_skipped']} (R002 ran and is vacuous: every "
        f"data-parallel label has one rank at world 1, {out['labels']}); "
        f"{out['ops']} ops, {out['events']} collectives; census {census}, "
        f"launches of the captured call {prog.launches}; flash outputs "
        f"carrying the batch's taint, per kernel {out['tainted_layers']}; "
        f"snapshot {prog.snapshot_bytes / 2**30:.2f} GiB")
    log(f"17a: first call {times[0] * 1e3:.1f} ms, of which the lint "
        f"(capture and rules) {lint_s * 1e3:.1f} ms; median step "
        f"{med:.2f} ms against "
        f"phase 4's {train['step_ms']:.2f}; peak {peaks[0] / 2**30:.2f} GiB "
        f"in the first call, {peaks[1] / 2**30:.2f} in steps 1-{n - 1} "
        f"(phase 4 {train['peak_mem_gib']:.2f}; counted above the "
        f"{base / 2**30:.2f} GiB earlier phases hold); losses {losses} bitwise "
        f"phase 4's {bitwise}; launches {launches}")
    bad = []
    if not report.ok or report.findings:
        bad.append(f"the LM step does not lint clean: {report.render()}")
    if out["rules_run"] != ["R001", "R002", "R003", "R004", "R005"]:
        bad.append(f"rules_run {out['rules_run']}")
    for name in KERNELS:
        if census[name] != 8 or prog.launches[name] != 8:
            bad.append(f"{name}: census {census[name]}, captured launches "
                       f"{prog.launches[name]} (want 8 and 8)")
        if len(tainted[name]) != 8 or not all(tainted[name]):
            bad.append(f"{name}: tainted outputs per layer {tainted[name]}")
        if launches[name] != 8 * (n + 1):
            bad.append(f"{name} launched {launches[name]} times, not "
                       f"{8 * (n + 1)} (the capture's 8 and {n} steps')")
    if not bitwise:
        bad.append(f"losses {losses} != phase 4's {train['losses']}")
    if abs(med / train["step_ms"] - 1) > 0.02:
        bad.append(f"median step {med:.2f} ms outside 2% of phase 4's "
                   f"{train['step_ms']:.2f}")
    if bad:
        raise AssertionError("phase 17a: " + "; ".join(bad))
    return out


def lint_cli_start(names, tmp):
    """Start the ``LINT_CLI`` runs of ``names`` (stdout and stderr to
    files under ``tmp``): ``{name: (process, waiter, start time, out,
    err)}``; each waiter thread stamps its process's exit time."""
    import threading

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = {}
    for name, args, _ in LINT_CLI:
        if name in names:
            out = os.path.join(tmp, f"{name}.out")
            err = os.path.join(tmp, f"{name}.err")
            with open(out, "w") as so, open(err, "w") as se:
                p = subprocess.Popen(
                    [sys.executable, "-m", "chainermn_tpu_torch.tools.lint",
                     *args, "--format", "json"], cwd=repo, env=env,
                    stdout=so, stderr=se)
            t0 = time.perf_counter()
            ended = []
            waiter = threading.Thread(
                target=lambda p=p, e=ended: (p.wait(),
                                             e.append(time.perf_counter())),
                daemon=True)
            waiter.start()
            procs[name] = (p, waiter, t0, ended, out, err)
    return procs


def lint_cli_finish(log, procs, timeout=300):
    """17b's results: each run's exit code against ``LINT_CLI``'s, its
    wall (start to exit), the fixtures' flagged rules against the port
    golden; kills what is still running at ``timeout``."""
    repo = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(repo, "tests", "golden",
                           "torch_lint_fixtures.json")) as f:
        golden = json.load(f)["flagged_rules"]
    deadline = time.perf_counter() + timeout
    try:
        for p, waiter, *_rest in procs.values():
            waiter.join(max(0.0, deadline - time.perf_counter()))
    finally:
        for p, *_rest in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out, bad = {}, []
    for name, args, want_rc in LINT_CLI:
        if name not in procs:
            continue
        p, _, t0, ended, out_path, err_path = procs[name]
        wall = (ended[0] if ended else float("nan")) - t0
        with open(out_path) as f:
            stdout = f.read()
        with open(err_path) as f:
            stderr = f.read()
        for line in stderr.splitlines()[-20:]:
            if not re.search(r"c10d|socket\.cpp|FutureWarning|return func",
                             line):
                log("  | " + line)
        payload = json.loads(stdout) if stdout.strip() else {}
        targets = payload.get("targets", [])
        flagged = {t["target"]: sorted({f["rule"] for f in t["findings"]})
                   for t in targets}
        out[name] = {"rc": p.returncode, "wall_s": wall,
                     "targets": len(targets), "self": payload.get("self")}
        log(f"17b tools.lint {' '.join(args)}: exit {p.returncode} (want "
            f"{want_rc}), {wall:.1f}s, {len(targets)} targets"
            + (f", self {payload['self']}" if "self" in payload else ""))
        if p.returncode != want_rc:
            bad.append(f"{name} exited {p.returncode}, not {want_rc}: "
                       f"{stdout[-1500:]} {stderr[-1500:]}")
        if name == "fixtures":
            out[name]["equal_golden"] = flagged == golden
            log(f"17b fixtures flag tests/golden/torch_lint_fixtures.json's "
                f"rules: {flagged == golden}")
            if flagged != golden:
                bad.append(f"fixtures {flagged} != golden {golden}")
        if name == "clean_gate":
            out[name]["rules_run"] = sorted(
                {r for t in targets for r in t["rules_run"]})
            if len(targets) != 5 or any(flagged.values()):
                bad.append(f"clean gate: {flagged}")
    if bad:
        raise AssertionError("phase 17b: " + "; ".join(bad))
    return out


def phase_lint(torch, K, log, card, train):
    """Phase 17: (a) the full-width LM step linted at its first call under
    ``CHAINERMN_TPU_LINT=strict``, (b) ``tools.lint``'s clean gate on the
    card, its fixtures on two gloo ranks, ``--host`` and ``--self``.  The
    three CPU runs of (b) start first and run beside (a) and the clean
    gate (the LM step is the card's pace; the host has room)."""
    import tempfile

    t0 = time.perf_counter()
    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        cpu = lint_cli_start(("fixtures", "host", "self"), tmp)
        try:
            out["lm"] = lint_lm(torch, K, log, train)
            gate = lint_cli_finish(
                log, lint_cli_start(("clean_gate",), tmp))
            out["cli"] = {**gate, **lint_cli_finish(log, cpu)}
        finally:
            for p, *_rest in cpu.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 17: {out['wall_s']:.1f}s ({card})")
    return out


# ---------------------------------------------------------------------------
# Phase 18: the collective audit
# ---------------------------------------------------------------------------

AUDIT_WORKER = os.path.join("tests", "_torch_audit_worker.py")
AUDIT_MNIST = ["--communicator", "pure_nccl", "--epochs", "1"]


def audit_worker_start(tmp):
    """18b's subprocess: the fake world's census of the 64-leaf tree at
    ranks 0 and 1, on CUDA tensors and on CPU ones."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out, err = (os.path.join(tmp, f"audit.{k}") for k in ("out", "err"))
    with open(out, "w") as so, open(err, "w") as se:
        proc = subprocess.Popen(
            [sys.executable, AUDIT_WORKER, "--device", "cuda,cpu",
             "--ranks", "0,1", "--no-serving"], cwd=repo, env=env,
            stdout=so, stderr=se)
    return proc, time.perf_counter(), out, err


def audit_worker_finish(log, started, timeout=300):
    proc, t0, out, err = started
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    with open(out) as f:
        text = f.read()
    if rc != 0:
        with open(err) as f:
            for line in f.read().splitlines()[-20:]:
                log("  | " + line)
        raise AssertionError(f"phase 18b: worker exit {rc}")
    res = json.loads(text.strip().splitlines()[-1])
    cuda, cpu = res["cuda"]["ranks"], res["cpu"]["ranks"]
    differ = sorted(f"rank {r} {name} {label}" for r in cpu
                    for name in cpu[r] for label in cpu[r][name]
                    if cuda[r][name][label] != cpu[r][name][label])
    flat = cuda["0"]["flat"]["bucketed"]
    td = cuda["0"]["two_dimensional"]["bucketed"]
    hier = {r: cuda[r]["hierarchical"]["bucketed"]["census"]
            for r in ("0", "1")}
    over = cuda["0"]["naive"]["overlap"]
    log(f"18b fake world 2 x 4, 64 leaves at 256 KiB on CUDA tensors: flat "
        f"{flat['census']} {flat['bytes_per_axis']}; two_dimensional "
        f"{td['census']} {td['bytes_per_axis']}; hierarchical rank 0 "
        f"{hier['0']}, rank 1 {hier['1']}; naive overlapped: async pairs "
        f"{over['async_pairs']}, overlap fraction "
        f"{over['overlap_fraction']:.3f}; every case equal to the CPU's: "
        f"{not differ} ({wall:.1f}s)")
    if differ:
        raise AssertionError(f"phase 18b: CUDA differs from CPU: {differ}")
    return {"cuda": res["cuda"], "equal_to_cpu": not differ,
            "wall_s": wall}


def audit_lm(torch, K, log, train):
    """18a: ``audit_fn`` on phase 4's LM step (one capture of the call,
    which restores what the step touched), then two real steps whose
    losses must be phase 4's first two, bitwise."""
    import inspect

    from chainermn_tpu_torch.observability import audit_fn

    base = torch.cuda.memory_allocated()
    step, batch, _ = build_lm(torch, log)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    a = audit_fn(inspect.unwrap(step), batch, comm=step.comm,
                 state=step.opt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - base
    counts = a.program.op_counts()
    ops = {name: counts.get(f"chainermn_torch.{name}", 0)
           for name in KERNELS}
    launches = {name: a.program.launches[name] for name in KERNELS}
    summary = a.summary()
    losses = [step(batch).item() for _ in range(2)]
    torch.distributed.destroy_process_group()
    del step, batch, a
    torch.cuda.empty_cache()
    out = {**summary, "flash_ops": ops,
           "captured_launches": launches, "audit_ms": wall * 1e3,
           "peak_mem_gib": peak / 2**30,
           "phase4_peak_gib": train["peak_mem_gib"], "losses": losses,
           "bitwise_phase4": losses == train["losses"][:2]}
    log(f"18a audit_fn on phase 4's LM step: {wall * 1e3:.1f} ms; counts "
        f"{summary['counts']}, bytes per axis {summary['bytes_per_axis']} "
        f"(world 1: allreduce_grad issues nothing); flash "
        f"custom ops in the capture {ops}, their launches {launches}; peak "
        f"{peak / 2**30:.2f} GiB against phase 4's "
        f"{train['peak_mem_gib']:.2f} (above the {base / 2**30:.2f} GiB "
        f"earlier phases hold); the next two losses {losses} bitwise phase "
        f"4's {out['bitwise_phase4']}")
    return out


def phase_audit(torch, K, log, card, train):
    """Phase 18: 18a, 18b (a subprocess, started first) and 18c."""
    import tempfile

    from chainermn_tpu_torch.observability.step_log import read_records
    from chainermn_tpu_torch.tools.obs import summarize

    t0 = time.perf_counter()
    out = {"card": card}
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        worker = audit_worker_start(tmp)
        try:
            out["lm"] = audit_lm(torch, K, log, train)
            path = os.path.join(tmp, "mnist.jsonl")
            run_mnist(log, AUDIT_MNIST + ["--step-log", path])
            rows = [r for r in read_records(path)
                    if r.get("event") == "hlo_audit"]
            out["mnist"] = {"rows": rows,
                            "summarize": summarize(read_records(path)).get(
                                "collectives")}
        finally:
            out["fake_world"] = audit_worker_finish(log, worker)
    lm = out["lm"]
    log(f"18c mnist --step-log: hlo_audit rows {rows}; tools.obs "
        f"summarize collectives {out['mnist']['summarize']}")
    for name in KERNELS:
        if lm["flash_ops"][name] != 8 or lm["captured_launches"][name] != 8:
            bad.append(f"18a {name}: {lm['flash_ops'][name]} ops, "
                       f"{lm['captured_launches'][name]} launches (want 8)")
    if not lm["bitwise_phase4"]:
        bad.append(f"18a losses {lm['losses']} after the audit != phase 4's")
    if len(rows) != 1 or set(rows[0]) < {"counts", "bytes_per_axis"}:
        bad.append(f"18c hlo_audit rows {rows}")
    elif out["mnist"]["summarize"] != {
            "counts": rows[0]["counts"],
            "bytes_per_axis": rows[0]["bytes_per_axis"]}:
        bad.append(f"18c summarize {out['mnist']['summarize']}")
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 18: {out['wall_s']:.1f}s ({card})")
    if bad:
        raise AssertionError("phase 18: " + "; ".join(bad))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--fleet-replica" in argv:
        return fleet_replica_main(argv)
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

    # Phases 3-15 run on the static defaults whatever an earlier run left
    # in /tmp: every resolver reads this empty cache (16a fills it).
    import shutil
    import tempfile

    tune_dir = tempfile.mkdtemp(prefix="chainermn_tune_")
    os.environ["CHAINERMN_TPU_TUNE_CACHE"] = os.path.join(tune_dir,
                                                          "tune_cache.json")
    log(f"tune cache: {os.environ['CHAINERMN_TPU_TUNE_CACHE']} (exists: "
        f"{os.path.exists(os.environ['CHAINERMN_TPU_TUNE_CACHE'])})")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = phase_compare(torch, K, log)
    phase_tiny_lm(torch, log)
    train = phase_train(torch, K, log, N_WARMUP, N_TIMED)
    times = phase_time(torch, K, log)
    times.update(phase_time_ce(torch, K, log))
    times.update(phase_time_moe(torch, log))
    dp_surface = {"mnist": phase_mnist(torch, log, card),
                  "lm_zero3": phase_lm_zero3(torch, K, log, train),
                  "card": card}
    imagenet_ref = {}
    imagenet = phase_imagenet(torch, log, card, imagenet_ref)
    model_parallel = phase_model_parallel(torch, log, card)
    pipeline = phase_pipeline(torch, log, card)
    long_context = phase_long_context(torch, K, log, card)
    gspmd = phase_gspmd(torch, K, log, card, train, repo)
    keep = {}
    serving = phase_serving(torch, K, log, card, keep)
    serving_cluster = phase_serving_cluster(torch, K, log, card, keep)
    serving_fleet = phase_serving_fleet(torch, K, log, card, keep,
                                        serving_cluster)
    host_planes = phase_host_planes(torch, K, log, card, train, imagenet_ref)
    del imagenet_ref
    # Phase 17 runs here, before 16 fills the tune cache: its LM step is
    # phase 4's on the same static defaults.
    lint = phase_lint(torch, K, log, card, train)
    audit = phase_audit(torch, K, log, card, train)
    tuning_fabric = phase_tuning_fabric(torch, K, log, card, kind, train,
                                        keep)
    del keep
    shutil.rmtree(tune_dir, ignore_errors=True)

    kernels = []
    for name, (src, replaces) in {**KERNELS, **CE_KERNELS,
                                  **MOE_KERNELS}.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": t.get("launches", train["launches"].get(name)),
            "max_abs_err": errs.get(name, t.get("max_abs_err")),
            "ms": t["ms"],
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
    print(json.dumps({"gspmd": gspmd}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"serving_cluster": serving_cluster}), flush=True)
    print(json.dumps({"serving_fleet": serving_fleet}), flush=True)
    print(json.dumps({"host_planes": host_planes}), flush=True)
    print(json.dumps({"tuning_fabric": tuning_fabric}), flush=True)
    print(json.dumps({"lint": lint}), flush=True)
    print(json.dumps({"audit": audit}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
