"""The port's serving stack (engine, scheduler, frontend, workload) against
the JAX package, on the CPU.

One tiny fp32 ``TransformerLM`` (vocab 32, d_model 16, 2 heads, d_ff 32, 2
layers, max_len 64): the reference's flax init, converted into the port.

* Engine against the reference engine, step for step: prefill, decode
  and chunk logits within 1e-5 relative (int8 pages: 1e-4 against the
  reference's int8 logits, ``kv_quant_err`` within 1e-6), ``generate``
  ids equal, the same ``stats()`` shape counts on the same traffic, and
  the same streams through both schedulers.  The reference engines pin
  small bucket ladders so that XLA compiles few programs.
* The port against its own dense full-recompute oracle: the reference's
  scheduler contracts (``tests/test_serving.py``) held token for token
  in fp32 — batching, preemption, FCFS, tenant DRR, prefix sharing with
  copy-on-write and the full-hit rewind, n-gram and model drafts, chunked
  prefill, streaming registration, bucket growth, gauges and counters.
  No bf16 oracle equality is asserted: the reference's own bf16 oracle
  tests fail at near ties (ROADMAP §C).
* The frontend's backpressure, fake-clock deadlines and streaming; the
  workload's arrivals equal to the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.models.transformer import generate as jax_generate
from chainermn_tpu.serving import engine as jengine
from chainermn_tpu.serving import workload as jworkload
from chainermn_tpu.serving.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler,
)
from chainermn_tpu.serving.scheduler import Request as JaxRequest
from chainermn_tpu_torch import convert
from chainermn_tpu_torch.models.transformer import TransformerLM, generate
from chainermn_tpu_torch.observability import Reporter
from chainermn_tpu_torch.serving import (
    ContinuousBatchingScheduler,
    EngineConfig,
    InferenceEngine,
    QueueFull,
    Request,
    SamplingParams,
    ServeFrontend,
)
from chainermn_tpu_torch.serving import engine as tengine
from chainermn_tpu_torch.serving import workload as tworkload
from chainermn_tpu_torch.serving.spec import DraftModel

VOCAB = 32
CFG = dict(vocab=VOCAB, d_model=16, n_heads=2, d_ff=32, n_layers=2,
           max_len=64)
# The reference engines' ladders: one prompt, table and chunk bucket.
PINNED = dict(prefill_buckets=(16,), batch_buckets=(1, 4),
              table_width_buckets=(16,), chunk_buckets=(8,))


@pytest.fixture(scope="module")
def ref():
    jlm = JaxLM(**CFG, dtype=jnp.float32)
    params = jlm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jlm, params


@pytest.fixture(scope="module")
def lm(ref):
    m = TransformerLM(**CFG, dtype=torch.float32, device="cpu")
    m.load_state_dict(convert.flax_to_state_dict(jax.device_get(ref[1])))
    return m


@pytest.fixture(scope="module")
def oracle(lm):
    """Greedy full recompute on the port's dense model (no cache)."""
    memo = {}

    def run(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            toks, out = [int(t) for t in prompt], []
            with torch.no_grad():
                for _ in range(n):
                    logits = lm(torch.tensor([toks]))
                    out.append(int(np.argmax(logits[0, -1].float().numpy())))
                    toks.append(out[-1])
            memo[key] = out
        return list(memo[key])

    return run


def make_engine(lm, **over):
    cfg = dict(block_size=4, n_blocks=64, max_len=64, max_batch=4)
    cfg.update(over)
    return InferenceEngine(lm, EngineConfig(**cfg), device="cpu")


def make_ref_engine(ref, **over):
    cfg = dict(block_size=4, n_blocks=64, max_len=64, max_batch=4, **PINNED)
    cfg.update(over)
    return jengine.InferenceEngine(ref[0], ref[1],
                                   jengine.EngineConfig(**cfg))


def prompts_for(n, rng_seed=7, lo=3, hi=13):
    rng = np.random.default_rng(rng_seed)
    return [[int(t) for t in rng.integers(0, VOCAB, size=int(n_))]
            for n_ in rng.integers(lo, hi, size=n)]


def _shared_prefix_prompts():
    rng = np.random.default_rng(11)
    shared = [int(t) for t in rng.integers(0, VOCAB, size=8)]
    out = []
    for i in range(6):
        tail = [int(t) for t in rng.integers(0, VOCAB, size=3 + i % 3)]
        out.append(shared + tail if i % 2 == 0 else tail)
    out.append(list(shared))
    return out


def _stats(engine):
    return {k: v for k, v in engine.stats().items()
            if not k.endswith("_jit_cache_size")}


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# ---------------------------------------------------------------------------
# Engine against the reference engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_engine_steps_match_reference(ref, lm, kv_dtype):
    """The same accounting ops and steps on both engines: prefill,
    batched decode, a multi-row chunk, a copy-on-write split, a
    defragment; logits, pages' accounting and stats equal."""
    tol = 1e-5 if kv_dtype is None else 1e-4
    engines = [make_ref_engine(ref, kv_dtype=kv_dtype),
               make_engine(lm, kv_dtype=kv_dtype, **PINNED)]
    pa, pb = prompts_for(2, rng_seed=3, lo=5, hi=11)
    got = [[], []]
    for e, out in zip(engines, got):
        e.kv.allocate("a", len(pa))
        e.kv.allocate("b", len(pb))
        out.append(e.prefill(pa, "a"))
        out.append(e.prefill(pb, "b"))
        e.kv.register_prefix("a", pa)
        la, lb = len(pa), len(pb)
        for step in range(3):
            e.kv.extend("a", la + 1)
            e.kv.extend("b", lb + 1)
            out.append(e.decode([step + 1, step + 2], ["a", "b"], [la, lb]))
            la, lb = la + 1, lb + 1
        e.kv.allocate("c", 4, prefix_pages=e.kv.match_prefix(pa)[:1])
        e.make_writable("c", 3)                 # CoW split of a's page
        e.kv.extend("a", la + 3)
        e.kv.extend("c", 6)
        out.append(e.chunk([[5, 6, 7], [8, 9]], ["a", "c"], [la, 4]))
        e.kv.allocate("hole", 8)
        e.kv.free("b")
        e.defragment()
        e.kv.extend("a", la + 4)
        out.append(e.decode([3], ["a"], [la + 3]))
    for r, p in zip(*got):
        assert p.shape == r.shape and p.dtype == np.float32
        assert _rel(p, r) <= tol, _rel(p, r)
    assert engines[1].kv.block_table("a") == engines[0].kv.block_table("a")
    assert _stats(engines[1]) == {k: v for k, v in _stats(engines[0]).items()
                                  if k != "kv_quant_err"} | (
        {"kv_quant_err": engines[1].stats()["kv_quant_err"]}
        if kv_dtype else {})
    if kv_dtype:
        assert abs(engines[1].stats()["kv_quant_err"]
                   - engines[0].stats()["kv_quant_err"]) <= 1e-6
        assert engines[1].stats()["kv_quant_err"] > 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_engine_generate_ids_match_reference(ref, lm, kv_dtype):
    jeng = make_ref_engine(ref, kv_dtype=kv_dtype)
    teng = make_engine(lm, kv_dtype=kv_dtype)
    for p in prompts_for(3, rng_seed=21):
        assert teng.generate(p, 8) == jeng.generate(p, 8)
    sp = SamplingParams(temperature=0.8, top_k=8, seed=5)
    jsp = jengine.SamplingParams(temperature=0.8, top_k=8, seed=5)
    p = prompts_for(1, rng_seed=22)[0]
    assert teng.generate(p, 8, sampling=sp) == jeng.generate(p, 8,
                                                              sampling=jsp)


def test_engine_pages_follow_the_engine_kv_dtype_not_the_model(lm,
                                                               monkeypatch):
    """A model built with ``kv_dtype="int8"`` under an engine left at its
    default (off) serves from full-precision pages, as the reference's
    engine does (it hands its own resolved dtype to the step programs);
    an engine asking for int8 gets int8 pages and reports their error."""
    monkeypatch.delenv("CHAINERMN_TPU_KV_DTYPE", raising=False)
    lm8 = TransformerLM(**CFG, dtype=torch.float32, kv_dtype="int8",
                        device="cpu")
    lm8.load_state_dict(lm.state_dict())
    off, plain = make_engine(lm8), make_engine(lm)
    assert off.kv_dtype is None
    assert {c.k_pages.dtype for c in off._cache} == {torch.float32}
    assert all(c.k_scales is None for c in off._cache)
    for p in prompts_for(2, rng_seed=23):
        assert off.generate(p, 6) == plain.generate(p, 6)
    assert "kv_quant_err" not in off.stats()
    assert "kv_dtype" not in off.stats()
    on = make_engine(lm8, kv_dtype="int8")
    assert {c.k_pages.dtype for c in on._cache} == {torch.int8}
    on.generate(prompts_for(1, rng_seed=23)[0], 6)
    assert on.stats()["kv_dtype"] == "int8"
    assert on.stats()["kv_quant_err"] > 0
    # The model's own field still sets the default of direct callers.
    assert lm8.init_paged_cache(4, 4)[0].k_pages.dtype == torch.int8
    assert lm8.init_paged_cache(4, 4, kv_dtype=None)[0].k_pages.dtype \
        == torch.float32


def _run_both(ref, lm, prompts, n_new, engine_over=None, sched_over=None,
              sampling=None):
    engine_over = engine_over or {}
    sched_over = sched_over or {}
    jeng = make_ref_engine(ref, **engine_over)
    teng = make_engine(lm, **PINNED, **engine_over)
    js = JaxScheduler(jeng, **sched_over)
    ts = ContinuousBatchingScheduler(teng, **sched_over)
    jsp = None if sampling is None else jengine.SamplingParams(
        **dataclasses.asdict(sampling))
    for i, p in enumerate(prompts):
        js.add_request(JaxRequest(request_id=i, prompt=list(p),
                                  max_new_tokens=n_new,
                                  **({"sampling": jsp} if jsp else {})))
        ts.add_request(Request(request_id=i, prompt=list(p),
                               max_new_tokens=n_new,
                               **({"sampling": sampling} if sampling
                                  else {})))
    return (jeng, js.run_to_completion()), (teng, ts.run_to_completion())


@pytest.mark.parametrize("case", ["spec_prefix", "chunked_model_draft"])
def test_scheduler_streams_and_shapes_match_reference(ref, lm, oracle,
                                                      case):
    if case == "spec_prefix":
        prompts = _shared_prefix_prompts()
        kw = dict(sched_over=dict(spec_tokens=3))
    else:
        prompts = prompts_for(3, rng_seed=19, lo=14, hi=26)
        kw = dict(engine_over=dict(prefill_chunk=4, draft="model"),
                  sched_over=dict(spec_tokens=3),
                  sampling=SamplingParams(temperature=0.8, top_k=8, seed=3))
    (jeng, jres), (teng, tres) = _run_both(ref, lm, prompts, 8, **kw)
    for i, p in enumerate(prompts):
        assert tres[i].state.value == "finished", tres[i].error
        assert tres[i].generated == jres[i].generated, f"request {i}"
        if case == "spec_prefix":
            assert tres[i].generated == oracle(p, 8)
    assert _stats(teng) == _stats(jeng)
    assert teng.stats()["chunk_compiles"] >= 1


def test_engine_carries_the_reference_cache_mid_stream(ref, lm):
    """The reference engine prefills and decodes a few steps; its flax
    ``cache`` and block tables move into the port's engine, which
    continues: the remaining logits agree within 1e-5 (fp32)."""
    jeng = make_ref_engine(ref)
    teng = make_engine(lm, **PINNED)
    prompt = prompts_for(1, rng_seed=31, lo=9, hi=10)[0]
    L = len(prompt)
    for e in (jeng, teng):
        e.kv.allocate("s", L)
    logits = jeng.prefill(prompt, "s")
    toks = []
    for step in range(3):
        toks.append(int(np.argmax(logits)))
        for e in (jeng, teng):
            e.kv.extend("s", L + step + 1)
        logits = jeng.decode([toks[-1]], ["s"], [L + step])[0]
    assert teng.kv.block_table("s") == jeng.kv.block_table("s")
    teng._cache = convert.flax_cache_to_pages(jax.device_get(jeng._cache),
                                              CFG["n_layers"])
    back = convert.pages_to_flax_cache(teng._cache)
    for name, leaf in back["layer_1"]["MultiHeadAttention_0"].items():
        np.testing.assert_array_equal(
            leaf, np.asarray(jeng._cache["layer_1"]["MultiHeadAttention_0"][name]))
    cur = L + 3
    for _ in range(4):
        nxt = int(np.argmax(logits))
        for e in (jeng, teng):
            e.kv.extend("s", cur + 1)
        logits = jeng.decode([nxt], ["s"], [cur])[0]
        port = teng.decode([nxt], ["s"], [cur])[0]
        assert _rel(port, logits) <= 1e-5
        cur += 1


def test_chunk_positions_past_max_len_clamp_as_the_reference(ref, lm):
    """A chunk bucket padded past ``max_len`` places its padding tokens at
    positions the table does not have: the engine clamps them, as the
    reference's gather does, and the live rows agree; the model itself
    still refuses an explicit position outside its table."""
    engines = [make_ref_engine(ref), make_engine(lm, **PINNED)]
    prompt = prompts_for(1, rng_seed=33, lo=60, hi=61)[0]
    outs = []
    for e in engines:
        e.kv.allocate("s", 60)
        e.prefill(prompt, "s")
        e.kv.extend("s", 62)
        outs.append(e.chunk([[1, 2]], ["s"], [60]))   # bucket 8: 60..67
    assert _rel(outs[1][0, :2], outs[0][0, :2]) <= 1e-5
    with pytest.raises(IndexError):
        lm(torch.tensor([[1]]), position_offset=torch.tensor([[64]]))


# ---------------------------------------------------------------------------
# Module-level generate and the model's modes
# ---------------------------------------------------------------------------
def test_module_generate_matches_reference_and_oracle(ref, lm, oracle):
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, VOCAB, size=(2, 6)).astype(np.int32)
    want = np.asarray(jax_generate(ref[0], ref[1], jnp.asarray(prompt), 8))
    got = generate(lm, torch.from_numpy(prompt).long(), 8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 6:].tolist() == oracle(prompt[0].tolist(), 8)
    g = torch.Generator().manual_seed(2)
    out = generate(lm, torch.zeros(1, 4, dtype=torch.long), 4, rng=g,
                   temperature=1.0, device="cpu")
    assert out.shape == (1, 8)
    with pytest.raises(ValueError, match="exceed max_len"):
        generate(lm, torch.zeros(1, 60, dtype=torch.long), 5, device="cpu")
    with pytest.raises(ValueError, match="requires rng"):
        generate(lm, torch.zeros(1, 4, dtype=torch.long), 2,
                 temperature=0.5, device="cpu")


def test_paged_modes_refuse_what_the_reference_refuses(lm):
    with pytest.raises(ValueError, match="mutually exclusive"):
        TransformerLM(**CFG, decode=True, paged="decode", device="cpu")
    with pytest.raises(ValueError, match="paged must be"):
        TransformerLM(**CFG, paged="verify", device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        TransformerLM(**CFG, kv_dtype="fp8", device="cpu")
    with pytest.raises(ValueError, match="attention_fn"):
        TransformerLM(**CFG, paged="decode", attention_fn=lambda *a: a[0],
                      device="cpu")
    with pytest.raises(ValueError, match="require a cache"):
        lm(torch.zeros(1, 1, dtype=torch.long), paged="decode")
    cache = lm.init_paged_cache(8, 4)
    with pytest.raises(ValueError, match="one token per call"):
        lm(torch.zeros(1, 2, dtype=torch.long), cache=cache, paged="decode",
           block_tables=torch.zeros(1, 1, dtype=torch.int32),
           seq_lens=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="one token per call"):
        lm(torch.zeros(1, 2, dtype=torch.long), cache=lm.init_decode_cache(1),
           decode=True)
    # sp_axis shards the chunk step only (the reference's refusal); in
    # chunk mode a mesh dimension name needs the mesh at the call.
    for mode in (None, "prefill", "decode"):
        with pytest.raises(ValueError, match="chunk step only"):
            TransformerLM(**CFG, paged=mode, sp_axis="sp", device="cpu")
    sp_lm = TransformerLM(**CFG, paged="chunk", sp_axis="sp", device="cpu")
    assert sp_lm.layers[0].attention.sp_axis == "sp"
    with pytest.raises(ValueError, match="mesh="):
        sp_lm(torch.zeros(1, 2, dtype=torch.long), cache=cache,
              block_tables=torch.zeros(1, 1, dtype=torch.int32),
              seq_lens=torch.zeros(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Entry points, resolution, the next slice's refusals
# ---------------------------------------------------------------------------
def test_entry_points_refuse_the_cpu_unless_asked(lm):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from chainermn_tpu_torch.examples import serve_lm

    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(lm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeFrontend(ContinuousBatchingScheduler(InferenceEngine(lm)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(lm, torch.zeros(1, 2, dtype=torch.long), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_lm.main(["--train-steps", "1"])


def test_multi_device_branches_name_the_next_slice(lm):
    """The multi-device branches now run (tests/test_torch_serving_tp.py
    holds them to the reference); what remains refused is the reference's
    own refusals: a plan without a mesh, a name that is no plan, ``sp``
    with a plan, ``sp`` not a power of two or wider than the world, and
    (a refusal of the port's) int8 pages under a plan."""
    with pytest.raises(ValueError, match="mesh"):
        InferenceEngine(lm, plan="tp", device="cpu")
    with pytest.raises(TypeError, match="ShardingPlan"):
        InferenceEngine(lm, plan=3, device="cpu")
    with pytest.raises(KeyError, match="unknown sharding plan"):
        InferenceEngine(lm, plan="bogus", device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        InferenceEngine(lm, EngineConfig(max_len=64, sp=2), plan="tp",
                        device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        make_engine(lm, sp=3)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_engine(lm, sp=2)
    e = make_engine(lm)
    e.pp_stages = 2
    e.kv.allocate("a", 3)
    e.kv.allocate("b", 3)
    e.prefill([1, 2, 3], "a")
    e.prefill([1, 2, 4], "b")
    e.kv.extend("a", 4)
    e.kv.extend("b", 4)
    split = e.decode([1, 2], ["a", "b"], [3, 3])
    e.pp_stages = 1
    assert e.stats()["decode_shapes"] == [(1, 1)]
    # Per-row results; a GEMM of one row may round differently from one
    # of two (the engine's docstring), so the rows agree to fp32 rounding.
    np.testing.assert_allclose(split, e.decode([1, 2], ["a", "b"], [3, 3]),
                               rtol=1e-5, atol=1e-6)


def test_config_resolution_matches_reference(ref, lm, monkeypatch):
    cfgs = [dict(), dict(draft="model", prefill_chunk=3, kv_dtype="none")]
    envs = [{}, {"CHAINERMN_TPU_DRAFT": "model",
                 "CHAINERMN_TPU_PREFILL_CHUNK": "8",
                 "CHAINERMN_TPU_KV_DTYPE": "int8"},
            {"CHAINERMN_TPU_DRAFT": "bogus",
             "CHAINERMN_TPU_PREFILL_CHUNK": "x",
             "CHAINERMN_TPU_KV_DTYPE": "fp4"}]
    for env in envs:
        for k in ("CHAINERMN_TPU_DRAFT", "CHAINERMN_TPU_PREFILL_CHUNK",
                  "CHAINERMN_TPU_KV_DTYPE"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for c in cfgs:
            jc, tc = jengine.EngineConfig(**c), EngineConfig(**c)
            assert tengine._resolve_draft(tc) == jengine._resolve_draft(
                jc, ref[0])
            assert (tengine._resolve_prefill_chunk(tc)
                    == jengine._resolve_prefill_chunk(jc))
            assert tengine._resolve_kv_dtype(tc) == \
                    jengine._resolve_kv_dtype(jc, ref[0])
    assert EngineConfig(max_len=100, block_size=16).resolved() == \
        EngineConfig(**dataclasses.asdict(jengine.EngineConfig(
            max_len=100, block_size=16).resolved()))
    with pytest.raises(ValueError, match="draft must be"):
        make_engine(lm, draft="oracle")


def test_sampling_matches_reference_and_is_counter_based():
    with pytest.raises(ValueError):
        SamplingParams(temperature=-1.0)
    with pytest.raises(ValueError):
        SamplingParams(top_k=-1)
    logits = np.random.default_rng(0).normal(size=VOCAB).astype(np.float32)
    sp = SamplingParams(temperature=0.8, top_k=5, seed=3)
    jsp = jengine.SamplingParams(temperature=0.8, top_k=5, seed=3)
    for pos in range(50):
        tok = InferenceEngine.sample(logits, sp, pos)
        assert tok == jengine.InferenceEngine.sample(logits, jsp, pos)
        assert tok in set(np.argsort(logits)[-5:])
    assert InferenceEngine.sample(logits, SamplingParams(), 0) == int(
        np.argmax(logits))


# ---------------------------------------------------------------------------
# The engine against the port's dense oracle
# ---------------------------------------------------------------------------
def test_engine_greedy_matches_full_recompute_oracle(lm, oracle):
    engine = make_engine(lm)
    for prompt in prompts_for(4):
        assert engine.generate(prompt, 6) == oracle(prompt, 6)
    engine.kv.assert_consistent()
    assert engine.kv.used_blocks == 0


def test_engine_recompile_count_tracks_buckets(lm):
    engine = make_engine(lm)
    lengths = [3, 5, 9, 12]
    rng = np.random.default_rng(0)
    for L in lengths:
        engine.generate([int(t) for t in rng.integers(0, VOCAB, L)], 3)
    st1 = engine.stats()
    assert 0 < st1["prefill_compiles"] <= 3, st1
    for L in lengths * 2:
        engine.generate([int(t) for t in rng.integers(0, VOCAB, L)], 3)
    st2 = engine.stats()
    assert st2["prefill_compiles"] == st1["prefill_compiles"]
    assert st2["decode_compiles"] == st1["decode_compiles"]
    engine.generate(list(range(30)), 3)
    assert engine.stats()["prefill_compiles"] > st2["prefill_compiles"]


def test_engine_defragment_mid_stream_keeps_numerics(lm, oracle):
    engine = make_engine(lm)
    prompt = prompts_for(1)[0]
    want = oracle(prompt, 5)
    engine.kv.allocate("s", len(prompt))
    logits = engine.prefill(prompt, "s")
    got, cur = [], len(prompt)
    for step in range(5):
        nxt = int(np.argmax(logits))
        got.append(nxt)
        if step == 4:
            break
        engine.kv.extend("s", cur + 1)
        if step == 1:
            engine.kv.allocate("lo", engine.kv.block_size)
            engine.kv.allocate("hi", engine.kv.block_size)
            engine.kv.free("lo")
            assert engine.defragment() > 0
            engine.kv.free("hi")
        logits = engine.decode([nxt], ["s"], [cur])[0]
        cur += 1
    engine.kv.free("s")
    assert got == want


def test_mirrored_steps_replay_to_the_same_pages(lm):
    """A follower engine replaying the leader's mirrored ops (prefill,
    decode, verify chunks, CoW, defragment) ends with bitwise equal
    pages, as a shard-group follower must."""
    leader, follower = make_engine(lm), make_engine(lm)
    ops = []
    leader.mirror_sink = lambda op, payload: ops.append((op, payload))
    sched = ContinuousBatchingScheduler(leader, spec_tokens=3)
    for i, p in enumerate(_shared_prefix_prompts()):
        sched.add_request(Request(request_id=i, prompt=list(p),
                                  max_new_tokens=6))
    steps = 0
    while sched.has_work:
        sched.step()
        steps += 1
        if steps % 4 == 0:
            leader.defragment()
    assert {op for op, _ in ops} >= {"prefill", "decode", "chunk", "cow",
                                     "defrag"}
    for op, payload in ops:
        follower.apply_step(op, payload)
    for a, b in zip(leader._cache, follower._cache):
        for name, leaf in a.leaves().items():
            assert torch.equal(leaf, b.leaves()[name]), name
    with pytest.raises(ValueError, match="unknown mirrored op"):
        follower.apply_step("swap", ())


# ---------------------------------------------------------------------------
# Scheduler contracts
# ---------------------------------------------------------------------------
def _run(engine, prompts, n, sampling=None, **sched_kw):
    sched = ContinuousBatchingScheduler(engine, **sched_kw)
    for i, p in enumerate(prompts):
        sched.add_request(Request(request_id=i, prompt=list(p),
                                  max_new_tokens=n,
                                  **({"sampling": sampling} if sampling
                                     else {})))
    return sched, sched.run_to_completion()


def _assert_drained(engine):
    engine.kv.assert_consistent()
    assert engine.kv.used_blocks == 0


def test_scheduler_batched_equals_sequential(lm, oracle):
    engine = make_engine(lm)
    prompts = prompts_for(6)
    _, res = _run(engine, prompts, 6)
    for i, p in enumerate(prompts):
        assert res[i].state.value == "finished"
        assert res[i].generated == oracle(p, 6), f"request {i} diverged"
    _assert_drained(engine)


def test_scheduler_preemption_recompute_is_bit_exact(lm, oracle):
    engine = make_engine(lm, n_blocks=10)
    prompts = prompts_for(4, rng_seed=11)
    _, res = _run(engine, prompts, 6, watermark_blocks=0)
    assert sum(r.preemptions for r in res.values()) > 0
    for i, p in enumerate(prompts):
        assert res[i].state.value == "finished", res[i].error
        assert res[i].generated == oracle(p, 6)
    _assert_drained(engine)


def test_scheduler_admission_is_fcfs(lm):
    engine = make_engine(lm, max_batch=2)
    sched = ContinuousBatchingScheduler(engine)
    order = []
    for i, p in enumerate(prompts_for(4, rng_seed=3)):
        req = Request(request_id=i, prompt=p, max_new_tokens=4)
        req.on_token = (lambda rid, tok: order.append(rid)
                        if rid not in order else None)
        sched.add_request(req)
    sched.step()
    assert sorted(r.request_id for r in sched.running) == [0, 1]
    sched.run_to_completion()
    assert order == [0, 1, 2, 3]


def test_scheduler_rejects_impossible_requests(lm):
    engine = make_engine(lm, n_blocks=2)
    sched = ContinuousBatchingScheduler(engine)
    sched.add_request(Request(request_id=0, prompt=list(range(30)),
                              max_new_tokens=50))
    sched.add_request(Request(request_id=1, prompt=list(range(20)),
                              max_new_tokens=4))
    sched.add_request(Request(request_id=2, prompt=[], max_new_tokens=4))
    res = sched.run_to_completion()
    assert res[0].state.value == "failed" and "max_len" in res[0].error
    assert res[1].state.value == "failed"
    assert res[2].state.value == "failed"
    _assert_drained(engine)


def test_scheduler_tenant_drr_shares_and_gauges(lm):
    def run(weights, n, pick, rep=None):
        engine = make_engine(lm, max_batch=1)
        sched = ContinuousBatchingScheduler(engine, reporter=rep)
        sched.set_tenant_weights(weights)
        order = []
        for i in range(n):
            req = Request(request_id=i, prompt=[1 + i % 8, 2, 3],
                          max_new_tokens=4, tenant=pick(i))
            req.on_token = (lambda rid, tok: order.append(rid)
                            if rid not in order else None)
            sched.add_request(req)
        sched.run_to_completion()
        return order

    half = lambda i: "a" if i < 4 else "b"  # noqa: E731
    assert run({"a": 1.0, "b": 1.0}, 8, half) == [0, 4, 1, 5, 2, 6, 3, 7]
    assert run(None, 8, half) == list(range(8))
    rep = Reporter()
    order = run({"a": 2.0, "b": 1.0}, 24,
                lambda i: "a" if i % 2 == 0 else "b", rep)
    assert sum(1 for r in order[:9] if r % 2 == 0) == 6
    for parity in (0, 1):
        got = [r for r in order if r % 2 == parity]
        assert got == sorted(got)
    assert any(k.startswith("serve/tenant_deficit/")
               for k in rep.summary()["gauges"])


def test_scheduler_publishes_gauges_and_counters(lm):
    rep = Reporter()
    engine = make_engine(lm)
    sched = ContinuousBatchingScheduler(engine, reporter=rep, spec_tokens=3)
    for i, p in enumerate(prompts_for(3)):
        sched.add_request(Request(request_id=i, prompt=p, max_new_tokens=4))
    sched.step()
    mid = rep.summary()["gauges"]
    assert mid["serving/running"]["value"] > 0
    assert mid["serving/cache_utilization"]["value"] > 0
    sched.run_to_completion()
    shared = [1, 2, 3, 4, 1, 2, 3, 4]
    for rid, p in ((3, shared), (4, shared + [5, 6])):
        sched.add_request(Request(request_id=rid, prompt=list(p),
                                  max_new_tokens=4))
        sched.run_to_completion()
    s = rep.summary()
    assert s["gauges"]["serving/running"]["value"] == 0
    assert s["counters"]["serving/tokens"] == 20
    assert s["gauges"]["serve/prefix_hit_rate"]["value"] > 0
    assert s["gauges"]["serve/spec_accept_len"]["value"] >= 1.0


def test_kv_page_seconds_scheduler_attribution(lm):
    rep = Reporter()
    engine = make_engine(lm)
    sched = ContinuousBatchingScheduler(engine, reporter=rep)
    sched.add_request(Request(request_id=0, prompt=[1, 2, 3, 4, 5],
                              max_new_tokens=4, tenant="ta"))
    sched.add_request(Request(request_id=1, prompt=[6, 7, 8],
                              max_new_tokens=4, tenant="tb"))
    sched.run_to_completion()
    ps = engine.kv.page_seconds()
    assert set(ps) == {"ta", "tb"}
    assert sum(ps.values()) == pytest.approx(engine.kv.pool_page_seconds())
    s = rep.summary()
    assert s["gauges"]["tenant/ta/kv_page_seconds"]["value"] == \
        pytest.approx(ps["ta"])
    assert s["counters"]["tenant/ta/tokens_out"] == 4


@pytest.mark.parametrize("spec", [0, 3])
def test_prefix_cached_and_speculative_streams_bit_exact(lm, oracle, spec):
    prompts = _shared_prefix_prompts()
    engine = make_engine(lm)
    sched, res = _run(engine, prompts, 10, spec_tokens=spec)
    for i, p in enumerate(prompts):
        assert res[i].state.value == "finished", res[i].error
        assert res[i].generated == oracle(p, 10), f"request {i} diverged"
    assert sched._prefix_hit_tokens > 0
    st = engine.stats()
    assert st["cow_splits"] >= 1
    assert st["tokens_prefix_cached"] > 0
    if spec:
        assert sched._spec_rows > 0
        assert sched._spec_emitted > sched._spec_rows
    _assert_drained(engine)


@pytest.mark.parametrize("draft", ["ngram", "model"])
@pytest.mark.parametrize("sampling", [
    SamplingParams(), SamplingParams(temperature=0.8, top_k=8, seed=5),
], ids=["greedy", "sampled"])
def test_speculative_streams_equal_sequential(lm, draft, sampling):
    prompts = _shared_prefix_prompts()
    seq = make_engine(lm)
    want = [seq.generate(p, 8, sampling=sampling) for p in prompts]
    engine = make_engine(lm, draft=draft)
    sched, res = _run(engine, prompts, 8, sampling=sampling, spec_tokens=3)
    for i, w in enumerate(want):
        assert res[i].state.value == "finished", res[i].error
        assert res[i].generated == w, f"request {i} diverged"
    assert sched._spec_rows_by.get(draft, 0) > 0
    if draft == "model":
        assert engine.stats()["draft_layers"] == 1
    _assert_drained(engine)


@pytest.mark.parametrize("draft", ["ngram", "model"])
def test_speculation_under_pool_pressure_and_defrag(lm, oracle, draft):
    prompts = _shared_prefix_prompts()
    engine = make_engine(lm, n_blocks=14, max_batch=3, draft=draft)
    sched = ContinuousBatchingScheduler(engine, watermark_blocks=0,
                                        spec_tokens=3)
    for i, p in enumerate(prompts):
        sched.add_request(Request(request_id=i, prompt=list(p),
                                  max_new_tokens=6))
    steps = 0
    while sched.has_work:
        sched.step()
        steps += 1
        if steps % 5 == 0:
            engine.defragment()
            engine.kv.assert_consistent()
        assert steps < 10_000
    res = sched.results()
    for i, p in enumerate(prompts):
        assert res[i].state.value == "finished", res[i].error
        assert res[i].generated == oracle(p, 6)
    _assert_drained(engine)


def test_chunk_recompile_counts_pinned(lm):
    prompts = _shared_prefix_prompts()
    engine = make_engine(lm)
    _run(engine, prompts, 8, spec_tokens=3)
    st1 = engine.stats()
    assert st1["chunk_compiles"] == len(st1["chunk_shapes"]) > 0
    engine.reset()
    _run(engine, prompts, 8, spec_tokens=3)
    st2 = engine.stats()
    assert [st2[k] for k in ("prefill_compiles", "decode_compiles",
                             "chunk_compiles")] == \
        [st1[k] for k in ("prefill_compiles", "decode_compiles",
                          "chunk_compiles")]


def test_model_draft_exact_when_full_depth_and_shares_parameters(lm):
    engine = make_engine(lm, draft="model", draft_layers=2)
    sched, res = _run(engine, prompts_for(1, rng_seed=2, lo=8, hi=9), 9,
                      spec_tokens=3)
    assert res[0].state.value == "finished"
    assert sched._spec_emitted == 4 * sched._spec_rows
    dm = make_engine(lm, draft="model").draft_model
    assert dm.n_layers == 1 and len(dm.model.layers) == 1
    assert dm.model.embed.weight is lm.embed.weight
    assert dm.model.layers[0].attention.query.weight is \
        lm.layers[0].attention.query.weight
    assert dm.model.final_norm.weight is lm.final_norm.weight
    with pytest.raises(ValueError):
        DraftModel(lm, 3, ())
    with pytest.raises(ValueError):
        DraftModel(lm, 0, ())


@pytest.mark.parametrize("sampling", [
    SamplingParams(), SamplingParams(temperature=0.7, top_k=6, seed=9),
], ids=["greedy", "sampled"])
def test_chunked_prefill_streams_bit_exact(lm, sampling):
    prompts = prompts_for(4, rng_seed=17, lo=14, hi=30)
    seq = make_engine(lm)
    want = [seq.generate(p, 6, sampling=sampling) for p in prompts]
    engine = make_engine(lm, prefill_chunk=4)
    _, res = _run(engine, prompts, 6, sampling=sampling)
    for i, w in enumerate(want):
        assert res[i].state.value == "finished", res[i].error
        assert res[i].generated == w, f"request {i} diverged"
    assert engine.stats()["prefill_chunk"] == 4
    _assert_drained(engine)


def test_chunked_prefill_interleaves_and_preempts(lm, oracle):
    engine = make_engine(lm, prefill_chunk=4)
    sched = ContinuousBatchingScheduler(engine)
    short = prompts_for(1, rng_seed=4, lo=4, hi=5)[0]
    long_p = prompts_for(1, rng_seed=8, lo=28, hi=29)[0]
    shortreq = Request(request_id=0, prompt=short, max_new_tokens=10)
    sched.add_request(shortreq)
    sched.step()
    sched.add_request(Request(request_id=1, prompt=long_p, max_new_tokens=4))
    sched.step()
    longreq = next(r for r in sched.running if r.request_id == 1)
    assert longreq.prefill_pos is not None
    emitted = 0
    while longreq.prefill_pos is not None:
        before = len(shortreq.generated)
        sched.step()
        emitted += len(shortreq.generated) - before
    assert emitted > 0
    res = sched.run_to_completion()
    assert res[0].generated == oracle(short, 10)
    assert res[1].generated == oracle(long_p, 4)
    _assert_drained(engine)
    # preempted mid-prefill: the whole prompt recomputes
    engine = make_engine(lm, prefill_chunk=4)
    sched = ContinuousBatchingScheduler(engine)
    long_p = prompts_for(1, rng_seed=23, lo=20, hi=21)[0]
    sched.add_request(Request(request_id=0, prompt=long_p, max_new_tokens=5))
    sched.step()
    req = sched.running[0]
    assert req.prefill_pos is not None and req.prefill_pos < len(long_p)
    assert sched._preempt_one()
    assert req.prefill_pos is None and req.preemptions == 1
    res = sched.run_to_completion()
    assert res[0].generated == oracle(long_p, 5)
    _assert_drained(engine)


def test_chunked_prefill_over_prefix_hit_covers_suffix_only(lm, oracle):
    engine = make_engine(lm, prefill_chunk=4)
    shared = prompts_for(1, rng_seed=5, lo=12, hi=13)[0]
    _run(engine, [shared], 4)
    p2 = shared + prompts_for(1, rng_seed=6, lo=10, hi=11)[0]
    starts = []
    real = engine.chunk

    def spy(rows, ids, st):
        starts.append(int(st[0]))
        return real(rows, ids, st)

    engine.chunk = spy
    try:
        sched, res = _run(engine, [p2], 5)
    finally:
        engine.chunk = real
    assert res[0].generated == oracle(p2, 5)
    assert starts and min(starts) == len(shared)
    assert sched._prefix_hit_tokens >= len(shared)
    _assert_drained(engine)


def _slice_spy(engine):
    calls = []
    real = engine.chunk

    def spy(rows, ids, starts):
        for row, sid, st in zip(rows, ids, starts):
            if int(st) >= 0:
                calls.append((sid, int(st), int(st) + len(row)))
        return real(rows, ids, starts)

    engine.chunk = spy
    return calls, real


def test_streaming_registration_prefills_a_document_once(lm, oracle):
    doc = prompts_for(1, rng_seed=41, lo=40, hi=41)[0]
    want = oracle(doc, 5)
    body = (len(doc) - 1) // 4 * 4

    def interleaved(stream, rep):
        engine = make_engine(lm, prefill_chunk=4)
        sched = ContinuousBatchingScheduler(engine, stream_prefix=stream,
                                            reporter=rep)
        calls, real = _slice_spy(engine)
        try:
            sched.add_request(Request(request_id=0, prompt=list(doc),
                                      max_new_tokens=5))
            sched.step()
            sched.step()
            sched.add_request(Request(request_id=1, prompt=list(doc),
                                      max_new_tokens=5))
            res = sched.run_to_completion()
        finally:
            engine.chunk = real
        for i in (0, 1):
            assert res[i].generated == want, f"request {i} diverged"
        _assert_drained(engine)
        return calls, sched

    rep_on, rep_off = Reporter(), Reporter()
    on_calls, on_sched = interleaved(True, rep_on)
    cov = [0] * len(doc)
    for _, s, e in on_calls:
        for i in range(s, min(e, len(doc))):
            cov[i] += 1
    assert all(c == 1 for c in cov[:body]), cov
    assert on_sched._stream_hit_tokens > 0
    off_calls, off_sched = interleaved(False, rep_off)
    assert len(off_calls) > len(on_calls)
    assert on_sched._dup_prefill_slices < off_sched._dup_prefill_slices
    assert rep_on.summary()["counters"]["serve/prefill_stream_hits"] > 0
    assert rep_off.summary()["counters"]["serve/dup_prefill_slices"] > 0


def test_streaming_registration_survives_preemption_and_defrag(lm, oracle):
    doc = prompts_for(1, rng_seed=43, lo=36, hi=37)[0]
    engine = make_engine(lm, prefill_chunk=4)
    sched = ContinuousBatchingScheduler(engine)
    sched.add_request(Request(request_id=0, prompt=list(doc),
                              max_new_tokens=4))
    for _ in range(3):
        sched.step()
    assert sched._preempt_one()
    sched.add_request(Request(request_id=1, prompt=list(doc),
                              max_new_tokens=4))
    res = sched.run_to_completion()
    for i in (0, 1):
        assert res[i].generated == oracle(doc, 4), f"request {i} diverged"
    assert sched._prefix_hit_tokens > 0
    _assert_drained(engine)
    doc = prompts_for(1, rng_seed=45, lo=40, hi=41)[0]
    engine = make_engine(lm, prefill_chunk=4)
    sched = ContinuousBatchingScheduler(engine)
    sched.add_request(Request(request_id=0, prompt=list(doc),
                              max_new_tokens=4))
    sched.step()
    sched.step()
    sched.add_request(Request(request_id=1, prompt=list(doc),
                              max_new_tokens=4))
    steps = 0
    while sched.has_work:
        sched.step()
        steps += 1
        if steps % 3 == 0:
            engine.kv.allocate("lo", engine.kv.block_size)
            engine.kv.allocate("hi", engine.kv.block_size)
            engine.kv.free("lo")
            engine.defragment()
            engine.kv.free("hi")
            engine.kv.assert_consistent()
        assert steps < 10_000
    res = sched.results()
    for i in (0, 1):
        assert res[i].generated == oracle(doc, 4), f"request {i} diverged"
    _assert_drained(engine)


def test_bucket_ladders_grow_lazily(lm, oracle):
    engine = make_engine(lm, prefill_buckets=(8,))
    prompt = prompts_for(1, rng_seed=47, lo=20, hi=21)[0]
    assert engine.generate(prompt, 4) == oracle(prompt, 4)
    st = engine.stats()
    assert st["bucket_growths"] >= 2 and st["max_bucket"] >= len(prompt)
    assert engine.generate(prompt, 4) == oracle(prompt, 4)
    assert engine.stats()["prefill_compiles"] == st["prefill_compiles"]
    frozen = make_engine(lm, prefill_buckets=(8,), max_len_growth=False)
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        frozen.generate(prompt, 4)
    engine = make_engine(lm, prefill_buckets=(8,), chunk_buckets=(2,),
                         prefill_chunk=4)
    prompt = prompts_for(1, rng_seed=53, lo=40, hi=41)[0]
    _, res = _run(engine, [prompt], 4)
    assert res[0].generated == oracle(prompt, 4)
    assert engine.stats()["bucket_growths"] >= 1
    assert engine.max_bucket >= len(prompt)
    _assert_drained(engine)


# ---------------------------------------------------------------------------
# Frontend
# ---------------------------------------------------------------------------
def test_frontend_backpressure_queue_full(lm):
    fe = ServeFrontend(ContinuousBatchingScheduler(make_engine(lm)),
                       max_queue=2)
    p = prompts_for(1)[0]
    fe.submit(p, 4)
    fe.submit(p, 4)
    with pytest.raises(QueueFull):
        fe.submit(p, 4)
    fe.step()
    fe.submit(p, 4)
    fe.run_until_idle()


def test_frontend_timeout_fake_clock(lm, oracle):
    now = [0.0]
    fe = ServeFrontend(ContinuousBatchingScheduler(make_engine(lm)),
                       clock=lambda: now[0])
    prompts = prompts_for(2, rng_seed=5)
    h_ok = fe.submit(prompts[0], 4)
    h_to = fe.submit(prompts[1], 40, timeout_s=0.5)
    fe.step()
    now[0] = 1.0
    fe.run_until_idle()
    assert h_ok.status == "finished"
    assert h_ok.tokens == oracle(prompts[0], 4)
    assert h_to.status == "timeout" and h_to.done
    assert h_to.error == "deadline exceeded"
    with pytest.raises(TimeoutError):
        fe.result(h_to)
    _assert_drained(fe.scheduler.engine)


def test_frontend_streaming_matches_final_tokens(lm):
    fe = ServeFrontend(ContinuousBatchingScheduler(make_engine(lm)))
    streamed = {}
    handles = [fe.submit(p, 5, on_token=lambda rid, tok:
                         streamed.setdefault(rid, []).append(tok))
               for p in prompts_for(3, rng_seed=9)]
    fe.run_until_idle()
    for h in handles:
        assert h.status == "finished" and len(h.tokens) == 5
        assert streamed[h.request_id] == h.tokens


def test_frontend_temperature_stream_independent_of_batching(lm):
    sp = SamplingParams(temperature=0.7, top_k=8, seed=42)
    prompt = prompts_for(1, rng_seed=13)[0]

    def run(extra):
        fe = ServeFrontend(ContinuousBatchingScheduler(make_engine(lm)))
        h = fe.submit(prompt, 6, sampling=sp)
        for q in extra:
            fe.submit(q, 6, sampling=SamplingParams(temperature=1.3, seed=1))
        fe.run_until_idle()
        return h.tokens

    assert run([]) == run(prompts_for(3, rng_seed=17))


# ---------------------------------------------------------------------------
# Workload
# ---------------------------------------------------------------------------
SPECS = [
    "default",
    "rate=80,requests=48,burst=6,abusive_frac=0.2,seed=3",
    "rate=150,requests=40,long_frac=0.25,long_buckets=40-60:1.0,"
    "tenants=4,diurnal=0.5,seed=9",
]


@pytest.mark.parametrize("spec", SPECS)
def test_workload_arrivals_equal_reference(spec):
    js, ts = jworkload.TrafficSpec.parse(spec), tworkload.TrafficSpec.parse(spec)
    assert ts.format() == js.format()
    got = [dataclasses.astuple(a) for a in tworkload.generate(ts)]
    want = [dataclasses.astuple(a) for a in jworkload.generate(js)]
    assert got == want and len(got) == ts.requests
