"""Minimal serving demo: train a toy LM briefly, then serve it — the port
of ``examples/serve_lm/serve_lm.py``.

Two halves, deliberately end to end:

1. **Train** a small :class:`TransformerLM` (bf16 compute, fp32
   parameters) on the synthetic successor task (next token = current + 1
   mod vocab) with Adam in optax's order
   (:class:`~chainermn_tpu_torch.optim.OptaxAdamW` at weight decay 0, which
   is ``optax.adam``) and optax's cross-entropy on the bf16 logits — enough
   that greedy decoding visibly continues the pattern.
2. **Serve** it through the whole stack: requests with different prompt
   lengths enter the :class:`ServeFrontend` queue, the continuous-batching
   scheduler interleaves their prefill and decode iterations, tokens
   stream back through callbacks, and the Reporter's gauges and counters
   show queue depth and KV-cache occupancy.

The flags and output lines are the reference's, plus ``--device``
(default ``cuda``; ``cpu`` runs on the CPU).  The model is initialised
from seed 0 with the port's initialiser (the reference's flax init draws
other values).  ``main(argv)`` returns the per-step training losses and
the served streams.

Usage::

    python -m chainermn_tpu_torch.examples.serve_lm --device cpu
    python -m chainermn_tpu_torch.examples.serve_lm --requests 8 --new-tokens 24
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from chainermn_tpu_torch.examples.train_transformer import (
    softmax_cross_entropy,
)
from chainermn_tpu_torch.models.transformer import TransformerLM
from chainermn_tpu_torch.observability import Reporter
from chainermn_tpu_torch.optim import OptaxAdamW
from chainermn_tpu_torch.serving import (
    ContinuousBatchingScheduler,
    EngineConfig,
    InferenceEngine,
    SamplingParams,
    ServeFrontend,
)

MAX_LEN = 128


def train_successor_lm(model, vocab, steps, batch, seq_len, lr=1e-2):
    """``steps`` Adam steps on successor sequences drawn from
    ``RandomState(0)``; trains ``model`` in place, returns the losses."""
    rng = np.random.RandomState(0)
    opt = OptaxAdamW(model.parameters(), lr=lr, weight_decay=0.0)
    dev = model.device
    losses = []
    for _ in range(steps):
        start = rng.randint(0, vocab, size=(batch, 1))
        tok = (start + np.arange(seq_len)[None, :]) % vocab
        tok = torch.from_numpy(tok).to(dev)
        tgt = (tok + 1) % vocab
        opt.zero_grad(set_to_none=True)
        loss = softmax_cross_entropy(model(tok), tgt).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses


def make_model(args, device) -> TransformerLM:
    return TransformerLM(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        d_ff=args.d_ff, n_layers=args.layers, max_len=MAX_LEN,
        device=device, seed=0,
    )


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--d-ff", type=int, default=128)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--train-steps", type=int, default=200)
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--new-tokens", type=int, default=12)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--block-size", type=int, default=8,
                   help="KV page size in tokens")
    p.add_argument("--n-blocks", type=int, default=128,
                   help="KV pages in the pool (shrink to watch "
                        "preemption-by-eviction kick in)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy; >0 samples (seeded per request)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    return p


def serve(model, args):
    """Serve ``args.requests`` successor prompts through frontend ->
    scheduler -> engine; prints a line a request and the engine's,
    gauges' and counters' lines.  Returns ``(prompt, tokens)`` pairs."""
    reporter = Reporter()
    engine = InferenceEngine(model, EngineConfig(
        block_size=args.block_size, n_blocks=args.n_blocks,
        max_len=MAX_LEN, max_batch=args.max_batch,
    ), device=model.device)
    sched = ContinuousBatchingScheduler(engine, reporter=reporter)
    frontend = ServeFrontend(sched, max_queue=args.requests + 1)

    rng = np.random.RandomState(1)
    streams = {}

    def on_token(rid, tok):
        streams.setdefault(rid, []).append(tok)

    handles = []
    for i in range(args.requests):
        start = int(rng.randint(0, args.vocab))
        plen = int(rng.randint(3, 9))
        prompt = [(start + j) % args.vocab for j in range(plen)]
        h = frontend.submit(
            prompt, args.new_tokens,
            sampling=SamplingParams(temperature=args.temperature, seed=i),
            on_token=on_token,
        )
        handles.append((prompt, h))
    frontend.run_until_idle()

    for prompt, h in handles:
        want = [(prompt[-1] + 1 + j) % args.vocab
                for j in range(len(h.tokens))]
        tag = "" if args.temperature else (
            " <- successor" if h.tokens == want else " (off-pattern)"
        )
        print(f"req {h.request_id}: prompt {prompt} -> {h.tokens}{tag}")
        if streams[h.request_id] != h.tokens:
            raise RuntimeError(f"request {h.request_id}: the streamed "
                               f"tokens differ from the final ones")

    summary = reporter.summary()
    print("engine:", json.dumps({
        k: v for k, v in engine.stats().items()
        if k in ("prefill_compiles", "decode_compiles",
                 "tokens_prefilled", "tokens_decoded")
    }))
    print("gauges:", json.dumps(
        {k: d["value"] for k, d in summary["gauges"].items()}
    ))
    print("counters:", json.dumps(summary["counters"]))
    return [(prompt, list(h.tokens)) for prompt, h in handles]


def main(argv=None):
    args = parser().parse_args(argv)
    model = make_model(args, args.device)
    losses = train_successor_lm(model, args.vocab, args.train_steps,
                                batch=16, seq_len=32)
    loss = losses[-1] if losses else float("nan")
    print(f"trained {args.train_steps} steps, final loss {loss:.3f}")
    return losses, serve(model, args)


if __name__ == "__main__":
    main()
