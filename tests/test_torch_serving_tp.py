"""The port's serving engine across ranks against the JAX package: the
tensor-parallel engine (``plan="tp"`` over a ``DeviceMesh``), the
sequence-parallel chunk prefill (``EngineConfig.sp``) and the pipelined
decode microbatches (``pp_stages``), on the CPU.

The multi-rank cases spawn gloo workers from
``tests/_torch_serve_worker.py`` (one spawn a world, shared by the tests
of that world); weights cross from the reference's flax init through
``convert.py``.  Contracts:

* TP, at 1 rank: logits bitwise equal to the one-device engine, streams
  equal to the reference's.  At 2 and 4 ranks the row-parallel sums are
  reduced in another order than one GEMM's, so the fp32 logits hold to
  1e-5 relative, and a stream may leave the one-device engine's only
  where its top-2 margin is below the teacher-forced logit difference
  (in these cases every stream is equal).
* SP at 2 and 4: the pages one slice writes equal the unsharded
  chunk's bitwise, and the reference's SP traffic gives the streams of
  the engine without SP (the reference's own streams, in fp32).
* ``pp_stages`` 1, 2 and 3: the reference's oracle streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_serve_worker as worker
from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.serving import engine as jengine
from chainermn_tpu.serving.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler,
)
from chainermn_tpu.serving.scheduler import Request as JaxRequest
from chainermn_tpu_torch import convert
from chainermn_tpu_torch.models.transformer import TransformerLM
from chainermn_tpu_torch.serving import (
    ContinuousBatchingScheduler,
    EngineConfig,
    InferenceEngine,
    Request,
)

# The reference's TP fixture (tests/test_shardplan.py:make_engine_pair);
# four ranks take four KV heads (two cannot shard four ways).
TP_LM = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
             max_len=32, n_kv_heads=2)
TP_PROMPTS = [[5, 9, 3, 17, 2], [1, 2, 3, 4, 5, 6, 7], [40, 41]]
TP_NEW = 12
TP_SAMPLING = {"greedy": None,
               "sampled": dict(temperature=0.8, top_k=5, seed=123)}
# The reference's SP fixture (tests/test_serving.py).
SP_LM = dict(vocab=32, d_model=16, n_heads=2, d_ff=32, n_layers=2,
             max_len=64)
SP_SAMPLED = dict(temperature=0.7, top_k=6, seed=5)


def prompts_for(n, rng_seed=7, lo=3, hi=13, vocab=32):
    rng = np.random.default_rng(rng_seed)
    return [[int(t) for t in rng.integers(0, vocab, size=int(n_))]
            for n_ in rng.integers(lo, hi, size=n)]


def _ref_lm(cfg):
    jlm = JaxLM(**cfg, dtype=jnp.float32)
    params = jlm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jlm, params


def _write_init(tmp_path, params):
    sd = convert.flax_to_state_dict(jax.device_get(params["params"]))
    np.savez(tmp_path / "init.npz", **{k: v.numpy() for k, v in sd.items()})


def _ref_engine(jlm, params, **cfg):
    return jengine.InferenceEngine(jlm, params, jengine.EngineConfig(**cfg))


def _tp_cfg(size):
    return dict(TP_LM, n_kv_heads=4) if size == 4 else dict(TP_LM)


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Every TP world's worker results and the reference's streams on the
    same weights: its TP engine on ``size`` devices, equal to its
    one-device engine."""
    out = {}
    for size in (1, 2, 4):
        tmp = tmp_path_factory.mktemp(f"tp{size}")
        jlm, params = _ref_lm(_tp_cfg(size))
        _write_init(tmp, params)
        ref = _ref_engine(jlm, params, **worker.ENGINE)
        want = {}
        for name, spec in TP_SAMPLING.items():
            sp = (jengine.SamplingParams() if spec is None
                  else jengine.SamplingParams(**spec))
            for j, p in enumerate(TP_PROMPTS):
                want[f"{name}/{j}"] = ref.generate(p, TP_NEW, sampling=sp)
        # The reference's own TP engine on as many devices (its
        # tests/test_shardplan.py holds it bit-exact to one device).
        from jax.sharding import Mesh

        devs = jax.devices()[:size]
        rtp = jengine.InferenceEngine(
            jlm, params, jengine.EngineConfig(**worker.ENGINE), plan="tp",
            mesh=Mesh(np.array(devs), ("model",)))
        want_tp = {}
        for name, spec in TP_SAMPLING.items():
            sp = (jengine.SamplingParams() if spec is None
                  else jengine.SamplingParams(**spec))
            for j, p in enumerate(TP_PROMPTS):
                want_tp[f"{name}/{j}"] = rtp.generate(p, TP_NEW, sampling=sp)
        assert len(devs) == size and want_tp == want
        res = worker.spawn("tp", size, tmp, lm=_tp_cfg(size),
                           prompts=TP_PROMPTS, n_new=TP_NEW,
                           sampling=TP_SAMPLING)
        out[size] = (res, want)
    return out


def _margin_ok(res, key):
    """Phase 12 (e)'s contract: a stream that leaves the one-device
    engine's does so where the top-2 margin is below the teacher-forced
    logit difference."""
    got, want = res["streams"][key], res["oracle"][key]
    if got == want:
        return True
    i = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    return res["margins"][key][i] < res["tf_diff"]


@pytest.mark.parametrize("size", [1, 2, 4])
def test_tp_streams_match_reference(tp_runs, size):
    res, want = tp_runs[size]
    for r, out in enumerate(res):
        assert out["oracle"] == want, r          # one device = reference
        for key in want:
            assert _margin_ok(out, key), (r, key)
            if size == 1:
                assert out["bitwise"][key], key
                assert out["streams"][key] == want[key]
            else:
                assert out["logits_rel"][key] <= 1e-5, (key, out)
        assert out["streams"] == res[0]["streams"]    # lockstep ranks


@pytest.mark.parametrize("size", [1, 2, 4])
def test_tp_pages_shard_over_model(tp_runs, size):
    """Each rank's local ``k_pages`` holds 1/size of the KV heads."""
    res, _ = tp_runs[size]
    n_kv = _tp_cfg(size)["n_kv_heads"]
    for out in res:
        assert out["k_pages_global"][2] == n_kv
        assert out["k_pages_local"][2] == n_kv // size


@pytest.mark.parametrize("size", [1, 2, 4])
def test_tp_model_draft_runs_on_placed_params(tp_runs, size):
    """After ``rebind`` the truncated-model draft holds the placed
    (DTensor) parameters and proposes the one-device draft's tokens."""
    res, _ = tp_runs[size]
    for out in res:
        assert out["draft_placed"]
        assert out["draft"][0] == out["draft"][1]


@pytest.mark.parametrize("size", [2, 4])
def test_tp_batched_pipelined_decode_matches(tp_runs, size):
    """The TP engine under the scheduler, its decode batch in two
    pipeline microbatches, gives the reference's greedy streams."""
    res, want = tp_runs[size]
    for out in res:
        assert out["batched"] == [want[f"greedy/{j}"]
                                  for j in range(len(TP_PROMPTS))]


def test_tp_refusals():
    """The reference's refusals (a plan without a mesh, a plan that is no
    plan or no registry name, a mesh without the plan's axes) and the
    port's refusal to place an already placed module under another plan,
    on a one-rank gloo world."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from chainermn_tpu_torch import create_communicator

    create_communicator("naive", device="cpu")      # joins a 1-rank world
    lm = TransformerLM(**TP_LM, dtype=torch.float32, device="cpu")
    cfg = EngineConfig(**worker.ENGINE)
    with pytest.raises(ValueError, match="mesh"):
        InferenceEngine(lm, cfg, plan="tp", device="cpu")
    with pytest.raises(TypeError, match="ShardingPlan"):
        InferenceEngine(lm, cfg, plan=object(), device="cpu")
    data = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    with pytest.raises(ValueError, match="the mesh lacks"):
        InferenceEngine(lm, cfg, plan="tp", mesh=data, device="cpu")
    with pytest.raises(KeyError, match="unknown sharding plan"):
        InferenceEngine(lm, cfg, plan="bogus", device="cpu")
    assert type(lm.embed.weight).__name__ == "Parameter"   # not placed
    model = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
    InferenceEngine(lm, cfg, plan="tp", mesh=model, device="cpu")
    with pytest.raises(ValueError, match="already placed"):
        InferenceEngine(lm, cfg, plan="dp", mesh=data, device="cpu")


@pytest.mark.parametrize("size", [1, 2, 4])
def test_tp_int8_pages_keep_whole_scales(tp_runs, size):
    """int8 pages under the plan: the pages shard by head, the per-head
    scales stay whole and equal on every rank (the reference's replicated
    leaves), equal to the one-device engine's, and the streams equal the
    one-device int8 engine's."""
    res, _ = tp_runs[size]
    n_kv = _tp_cfg(size)["n_kv_heads"]
    for out in res:
        assert out["int8"] == out["int8_oracle"]
        assert out["int8_scales_shape"][2] == n_kv
        assert out["int8_scales_sha"] == res[0]["int8_scales_sha"]
        assert out["int8_scales_diff"] <= 1e-6
        # K and V from a GEMM over 1/size of the columns round on their
        # own, and the error is a max over them.
        np.testing.assert_allclose(*out["int8_err"], rtol=1e-4)


# ---------------------------------------------------------------------------
# Sequence-parallel chunk prefill
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    jlm, params = _ref_lm(SP_LM)
    _write_init(tmp, params)
    prompts = prompts_for(3, rng_seed=59, lo=17, hi=33)
    ref = _ref_engine(jlm, params, block_size=4, n_blocks=64, max_len=64,
                      max_batch=4, prefill_chunk=8)
    sched = JaxScheduler(ref)
    for i, p in enumerate(prompts):
        sched.add_request(JaxRequest(
            request_id=i, prompt=list(p), max_new_tokens=5,
            sampling=(jengine.SamplingParams() if i % 2
                      else jengine.SamplingParams(**SP_SAMPLED))))
    out = sched.run_to_completion()
    want = [out[i].generated for i in range(len(prompts))]
    res = worker.spawn("sp", 4, tmp, lm=SP_LM, prompts=prompts, sps=[2, 4],
                       sampled=SP_SAMPLED)
    return res, want


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_streams_equal_engine_without_sp(sp_run, sp):
    """The reference's ``test_sp_sharded_prefill_streams_bit_exact``
    traffic, greedy and sampled: streams equal to the engine without SP
    and to the reference's; decode runs the plain step."""
    res, want = sp_run
    for r, out in enumerate(res):
        assert out["want"] == want
        assert out[f"sp{sp}"] == want, (r, sp)
        st = out[f"stats{sp}"]
        assert st["sp"] == sp and st["sp_chunk_compiles"] >= 1
        assert st["decode_compiles"] >= 1 and st["used_blocks"] == 0
        assert st["in_group"]            # every rank in a group of sp


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_pages_bitwise_equal_unsharded(sp_run, sp):
    """After one 16-token slice, every rank's pages equal the unsharded
    engine's bitwise (the K/V gather is a pure concatenation), and so do
    the slice's logits here."""
    res, _ = sp_run
    for out in res:
        assert out[f"pages{sp}"]
        assert out[f"sp_shapes{sp}"] == 1
        assert out[f"chunk_logits{sp}"] <= 1e-6


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_engines_share_one_group(sp_run, sp):
    """Two engines with the same ``sp`` on the same ranks share one
    communicator and process group: building engines makes no new
    groups."""
    res, _ = sp_run
    for r, out in enumerate(res):
        assert out[f"shared{sp}"], (r, sp)


# ---------------------------------------------------------------------------
# Pipelined decode microbatches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pp", [1, 2, 3])
def test_pp_microbatched_decode_streams_match_reference(pp):
    """The reference's ``test_pp_microbatched_decode_streams_bit_exact``:
    the decode batch split into ``pp`` contiguous microbatches gives the
    reference's sequential oracle streams (fp32)."""
    jlm, params = _ref_lm(SP_LM)
    prompts = prompts_for(4, rng_seed=23)
    ref = _ref_engine(jlm, params, block_size=4, n_blocks=64, max_len=64,
                      max_batch=4)
    want = [ref.generate(p, 6) for p in prompts]
    import torch

    lm = TransformerLM(**SP_LM, dtype=torch.float32, device="cpu")
    lm.load_state_dict(convert.flax_to_state_dict(
        jax.device_get(params["params"])))
    eng = InferenceEngine(lm, EngineConfig(block_size=4, n_blocks=64,
                                           max_len=64, max_batch=4),
                          device="cpu")
    eng.pp_stages = pp
    sched = ContinuousBatchingScheduler(eng)
    for i, p in enumerate(prompts):
        sched.add_request(Request(request_id=i, prompt=list(p),
                                  max_new_tokens=6))
    while sched.has_work:
        sched.step()
    res = sched.results()
    assert [res[i].generated for i in range(len(prompts))] == want
    widths = {b for b, _ in eng.stats()["decode_shapes"]}
    assert max(widths) <= (4 if pp == 1 else 2)
