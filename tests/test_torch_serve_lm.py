"""The port's ``serve_lm`` example against the reference's
(``examples/serve_lm/serve_lm.py``), on the CPU.

* Training: both examples' ``train_successor_lm`` from the same initial
  weights (the reference's flax init, converted) on the same successor
  batches, 40 steps.  The loss is a bf16 scalar on both sides (optax's
  cross-entropy on bf16 logits, its mean rounded to bf16), so 1e-4
  relative means bitwise: held over the first 10 steps (the reference
  smoke test runs 2).  Later, the two sides' fp32 sums fall on either
  side of a bf16 rounding boundary now and then (5 of 40 steps on the CPU),
  so every step is held to one bf16 ulp of the reference's loss.  The
  reference's jitted step is wrapped to record its losses.
* Serving: the reference's trained weights, converted, in both engines
  (bf16, the example's dtype).  The reference's served streams are
  teacher-forced through both engines: the logits at every position
  agree within 2^-6 of the largest logit (four bf16 ulps at that
  magnitude: the two sides may sum the same bf16 products in another
  order), and the port's greedy id equals the reference's wherever the
  reference's top-2 margin exceeds that bound.
* ``main`` end to end at the reference smoke test's flags.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.serving import engine as jengine
from chainermn_tpu_torch import convert
from chainermn_tpu_torch.examples import serve_lm
from chainermn_tpu_torch.serving import EngineConfig, InferenceEngine

REPO = pathlib.Path(__file__).resolve().parent.parent
FLAGS = ["--vocab", "64", "--d-model", "16", "--n-heads", "4", "--d-ff",
         "32", "--layers", "2"]
BOUND = 2.0 ** -6


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_serve_lm", REPO / "examples" / "serve_lm" / "serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trained():
    """The reference example trained 40 steps, its per-step losses, and
    the port trained from the same initial weights."""
    ref = _reference_example()
    args = serve_lm.parser().parse_args(FLAGS + ["--device", "cpu"])
    jm = ref.TransformerLM(vocab=64, d_model=16, n_heads=4, d_ff=32,
                           n_layers=2, max_len=serve_lm.MAX_LEN)
    init = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32), jnp.int32))
    losses = []
    real_jit = jax.jit

    def recording_jit(fn):
        jitted = real_jit(fn)

        def step(*a):
            out = jitted(*a)
            losses.append(float(out[2]))
            return out

        return step

    jax.jit = recording_jit
    try:
        params, last = ref.train_successor_lm(jm, 64, 40, batch=16,
                                              seq_len=32)
    finally:
        jax.jit = real_jit
    assert last == losses[-1]
    model = serve_lm.make_model(args, "cpu")
    model.load_state_dict(convert.flax_to_state_dict(jax.device_get(init)))
    port_losses = serve_lm.train_successor_lm(model, 64, 40, batch=16,
                                              seq_len=32)
    return dict(jm=jm, params=params, ref_losses=losses,
                port_losses=port_losses, args=args)


def test_training_losses_match_reference(trained):
    ref, port = np.asarray(trained["ref_losses"]), np.asarray(
        trained["port_losses"])
    assert len(port) == len(ref) == 40
    np.testing.assert_allclose(port[:10], ref[:10], rtol=1e-4, atol=0)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref))) - 7)
    assert np.all(np.abs(port - ref) <= ulp), np.abs(port - ref) / ulp
    assert port[-1] < port[0] / 2


def _teacher_forced(engine, prompt, stream):
    engine.kv.allocate("s", len(prompt))
    rows = [engine.prefill(prompt, "s")]
    cur = len(prompt)
    for tok in stream[:-1]:
        engine.kv.extend("s", cur + 1)
        rows.append(engine.decode([tok], ["s"], [cur])[0])
        cur += 1
    engine.kv.free("s")
    return np.stack(rows)


def test_served_streams_match_reference_teacher_forced(trained):
    args = trained["args"]
    cfg = dict(block_size=args.block_size, n_blocks=args.n_blocks,
               max_len=serve_lm.MAX_LEN, max_batch=args.max_batch)
    jeng = jengine.InferenceEngine(trained["jm"], trained["params"],
                                   jengine.EngineConfig(**cfg))
    model = serve_lm.make_model(args, "cpu")
    model.load_state_dict(convert.flax_to_state_dict(
        jax.device_get(trained["params"])))
    teng = InferenceEngine(model, EngineConfig(**cfg), device="cpu")
    rng = np.random.RandomState(1)
    checked = 0
    for _ in range(args.requests):
        start = int(rng.randint(0, args.vocab))
        plen = int(rng.randint(3, 9))
        prompt = [(start + j) % args.vocab for j in range(plen)]
        stream = jeng.generate(prompt, args.new_tokens)
        want = _teacher_forced(jeng, prompt, stream)
        got = _teacher_forced(teng, prompt, stream)
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= BOUND * scale
        top2 = np.sort(want, axis=-1)[:, -2:]
        for pos in np.nonzero(top2[:, 1] - top2[:, 0] > BOUND * scale)[0]:
            assert int(np.argmax(got[pos])) == stream[pos]
            checked += 1
    assert checked > args.requests


def test_main_end_to_end(capsys):
    losses, served = serve_lm.main(
        ["--train-steps", "2", "--requests", "3", "--new-tokens", "4",
         "--n-blocks", "32", "--d-model", "16", "--d-ff", "32",
         "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "req 0:" in out and "gauges:" in out and "counters:" in out
    assert '"serving/tokens": 12' in out
    assert [len(toks) for _, toks in served] == [4, 4, 4]
    assert torch.get_default_dtype() == torch.float32
