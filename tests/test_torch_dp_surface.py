"""The port's data-parallel surface against the JAX package: ZeRO 1-3, the
quantized and overlapped gradient wire, every communicator, the object
plane and ``split``, and the evaluator and iterators over several ranks.

Multi-rank runs are real gloo process groups spawned from
``tests/_torch_dp_worker.py`` (which imports no JAX); each spawn runs a
batch of cases once per module and the tests below read its results.
The reference runs on the 8-device CPU mesh with the same numpy inputs:

* ZeRO: stages 1-3 x SGD (momentum) and Adam x {plain, ``n_accum=2``,
  ``double_buffering``, ``loss_scale``}, three steps, the port at 1, 2 and
  4 ranks against the reference's stage of the same number, fp32 within
  1e-6 as in ``test_torch_optimizer.py``;
* quant: ``quantize``/``dequantize_mean`` byte-equal to the reference's,
  the quantized mean within ``error_bound`` (and > 0) on every
  communicator at 2 and 4 ranks, fp8 falling back to the int8 wire on
  gloo, the constructor/environment resolution;
* overlap: the reference's schedule for the same bucket plan, and the
  hook-launched allreduce byte-equal to the eager one through three train
  steps.
"""

import importlib
import json
import multiprocessing as mp

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_dp_worker as worker
from chainermn_tpu.communicators import build_mesh
from chainermn_tpu.communicators import create_communicator as jax_comm
from chainermn_tpu.communicators import overlap as jax_overlap
from chainermn_tpu.communicators import packing as jax_packing
from chainermn_tpu.optimizers import create_multi_node_optimizer as jax_mno
from chainermn_tpu_torch import create_communicator
from chainermn_tpu_torch.communicators import overlap, packing, quant

jax_quant = importlib.import_module("chainermn_tpu.communicators.quant")

TOL = dict(rtol=1e-6, atol=1e-6)
JOIN_TIMEOUT_S = 60
SIZES = (1, 2, 4)


def spawn(kind, size, tmp_path, **args):
    """Run ``worker.run(kind, ...)`` on ``size`` gloo ranks; every rank
    must exit 0 within ``JOIN_TIMEOUT_S``.  Returns each rank's JSON."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker.run,
                         args=(kind, r, size, str(tmp_path / "rendezvous"),
                               str(tmp_path), args))
             for r in range(size)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
            assert p.exitcode is not None, \
                f"{kind}: rank timed out after {JOIN_TIMEOUT_S}s"
            assert p.exitcode == 0, f"{kind}: rank exited {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(size)]


@pytest.fixture(scope="module")
def zero_runs(tmp_path_factory):
    return {n: spawn("zero", n, tmp_path_factory.mktemp(f"zero{n}"))
            for n in SIZES}


@pytest.fixture(scope="module")
def comm_runs(tmp_path_factory):
    return {n: spawn("comm", n, tmp_path_factory.mktemp(f"comm{n}"))
            for n in (2, 4)}


# -- ZeRO ------------------------------------------------------------------

def jax_loss(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] + params["b"] - y) ** 2)


_JAX_ZERO = {}


def jax_zero_run(devices8, stage, opt_name, variant):
    """The reference's trajectory for one ZeRO case (cached per module)."""
    key = (stage, opt_name, variant)
    if key not in _JAX_ZERO:
        x, y, w = worker.linear_problem()
        mesh = build_mesh(inter_size=1, intra_size=8, devices=devices8)
        opt = (optax.sgd(0.1, momentum=0.9) if opt_name == "sgd"
               else optax.adam(1e-2))
        mno = jax_mno(opt, jax_comm("xla_ici", mesh=mesh),
                      double_buffering=variant == "double_buffering",
                      zero_stage=stage)
        params = {"w": jnp.asarray(w), "b": jnp.zeros((1,), jnp.float32)}
        state = mno.init(params)
        kw = {"n_accum": 2} if variant == "n_accum2" else (
            {"loss_scale": 1024.0} if variant == "loss_scale" else {})
        step = mno.make_train_step(jax_loss, donate=False, **kw)
        cur = mno.shard_params(params) if stage == 3 else params
        losses = []
        for _ in range(worker.ZERO_STEPS):
            cur, state, loss = step(cur, state,
                                    (jnp.asarray(x), jnp.asarray(y)))
            losses.append(float(loss))
        final = mno.materialize(cur) if stage == 3 else cur
        _JAX_ZERO[key] = (np.asarray(final["w"]).ravel(),
                          np.asarray(final["b"]).ravel(), losses)
    return _JAX_ZERO[key]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("variant", worker.ZERO_VARIANTS)
@pytest.mark.parametrize("opt_name", worker.ZERO_OPTS)
@pytest.mark.parametrize("stage", worker.ZERO_STAGES)
def test_zero_matches_reference(zero_runs, devices8, stage, opt_name,
                                variant, size):
    jw, jb, jl = jax_zero_run(devices8, stage, opt_name, variant)
    res = zero_runs[size]
    for out in res:
        got = out[f"{stage}/{opt_name}/{variant}"]
        np.testing.assert_allclose(got["w"], jw, **TOL)
        np.testing.assert_allclose(got["b"], jb, **TOL)
        np.testing.assert_allclose(got["losses"], jl, rtol=1e-6)
        # The shard of 5 parameters: padded to a multiple of the world.
        assert got["shard"] == -(-5 // size)
    # Every rank ends with the same parameters.
    first = res[0][f"{stage}/{opt_name}/{variant}"]
    for out in res[1:]:
        assert out[f"{stage}/{opt_name}/{variant}"]["w"] == first["w"]


def test_zero_double_buffering_first_step_reduces_only():
    """Under ZeRO too, step 0 of double buffering leaves the parameters
    unchanged and keeps the stale gradient as a 1/n shard."""
    from chainermn_tpu_torch import create_multi_node_optimizer

    x, y, w = worker.linear_problem()
    for stage in (1, 2, 3):
        wp = torch.nn.Parameter(torch.from_numpy(w.copy()))
        bp = torch.nn.Parameter(torch.zeros(1))
        mno = create_multi_node_optimizer(
            torch.optim.SGD([wp, bp], lr=0.1),
            create_communicator("naive", device="cpu"),
            double_buffering=True, zero_stage=stage)
        mno.init()
        step = mno.make_train_step(
            lambda b: ((b[0] @ wp + bp - b[1]) ** 2).mean())
        step((torch.from_numpy(x), torch.from_numpy(y)))
        mno.materialize()
        np.testing.assert_array_equal(wp.detach().numpy(), w)
        assert mno._stale.shape == (5,) and mno.step_count == 1


def test_zero3_keeps_only_the_shard_between_steps():
    """Stage 3: the module's parameters hold no storage between steps;
    ``materialize`` fills them and returns the module's ``state_dict``;
    ``shard_params`` takes them back; the imperative ``setup``/``update``/
    ``target`` API trains."""
    from chainermn_tpu_torch import create_multi_node_optimizer

    x, y, _ = worker.linear_problem()
    lin = torch.nn.Linear(4, 1)
    comm = create_communicator("naive", device="cpu")
    mno = create_multi_node_optimizer(torch.optim.Adam(lin.parameters(),
                                                       lr=1e-2),
                                      comm, zero_stage=3)
    mno.setup(lin, lambda b: ((lin(b[0]) - b[1]) ** 2).mean())
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    losses = [float(mno.update(batch)) for _ in range(5)]
    assert losses[-1] < losses[0]
    assert all(p.numel() == 0 for p in lin.parameters())
    sd = mno.materialize(lin)
    assert sd["weight"].shape == (1, 4) and sd["bias"].shape == (1,)
    flat = mno.shard_params()
    assert flat.shape == (5,) and all(p.numel() == 0 for p in lin.parameters())
    assert mno.target is lin and lin.weight.shape == (1, 4)
    np.testing.assert_array_equal(lin.weight.detach().numpy().ravel(),
                                  flat[:4].numpy())
    with pytest.raises(ValueError, match="zero_stage=3"):
        create_multi_node_optimizer(torch.optim.SGD(lin.parameters(), lr=1),
                                    comm, zero_stage=1).shard_params()


# -- quant -----------------------------------------------------------------

def test_comm_dtype_names_match_reference():
    for name in ("none", "off", "0", "float32", "bf16", "int8", "s8", "fp8",
                 "e4m3", "float8_e4m3fn", "e2m1", " INT8 ", "", None):
        assert quant.canonical_comm_dtype(name) == \
            jax_quant.canonical_comm_dtype(name), name
    for mod in (quant, jax_quant):
        with pytest.raises(ValueError, match="comm_dtype"):
            mod.canonical_comm_dtype("int4")


def test_per_rank_qmax_is_an_integer_budget():
    """127/8 = 15.875 would round up to 16 on the worst rank and the
    8-rank sum 128 wraps int8: the budget floors to an integer."""
    assert quant.per_rank_qmax(torch.int8, 8) == 15.0
    assert quant.per_rank_qmax(torch.int8, 1) == 127.0
    assert quant.per_rank_qmax(torch.int8, 500) == 1.0
    for world in (1, 2, 3, 8, 64):
        for tdt, jdt in ((torch.int8, jnp.int8),
                         (torch.float8_e4m3fn, jnp.float8_e4m3fn)):
            assert quant.per_rank_qmax(tdt, world) == \
                jax_quant.per_rank_qmax(jdt, world)
        assert quant.per_rank_qmax(torch.int8, world) * world <= 127
        for cd in ("int8", "fp8"):
            assert quant.error_bound(cd, 3.5, world) == \
                jax_quant.error_bound(cd, 3.5, world)


@pytest.mark.parametrize("world", [1, 4, 8])
@pytest.mark.parametrize("chunk", [None, 512])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_quantize_and_dequantize_byte_equal_to_reference(wire, chunk, world):
    rng = np.random.RandomState(world)
    buf = (rng.randn(4096) * rng.choice([1e-3, 1.0, 30.0], 4096)) \
        .astype(np.float32)
    buf[:512] = 0.0                         # an all-zero chunk: scale 1
    tdt = torch.int8 if wire == "int8" else torch.float8_e4m3fn
    jdt = jnp.int8 if wire == "int8" else jnp.float8_e4m3fn
    t_amax = quant.local_amax(torch.from_numpy(buf), chunk)
    j_amax = jax_quant.local_amax(jnp.asarray(buf), chunk)
    np.testing.assert_array_equal(t_amax.numpy(), np.asarray(j_amax))
    t_scale = quant.scale_for(t_amax, tdt, world)
    j_scale = jax_quant.scale_for(j_amax, jdt, world)
    np.testing.assert_array_equal(t_scale.numpy(), np.asarray(j_scale))
    tq = quant.quantize(torch.from_numpy(buf), t_scale, tdt, chunk)
    jq = np.asarray(jax_quant.quantize(jnp.asarray(buf), j_scale, jdt, chunk))
    assert tq.view(torch.uint8).numpy().tobytes() == \
        jq.view(np.uint8).tobytes()
    # The dequantized mean of a world-wide sum (here: world copies).
    if wire == "int8":
        tsum = tq * world
        jsum = jnp.asarray(jq) * world
    else:
        tsum = (tq.float() * world).to(tdt)
        jsum = (jnp.asarray(jq).astype(jnp.float32) * world).astype(jdt)
    assert tsum.view(torch.uint8).numpy().tobytes() == \
        np.asarray(jsum).view(np.uint8).tobytes()
    tm = quant.dequantize_mean(tsum, t_scale, world, torch.float32, chunk)
    jm = jax_quant.dequantize_mean(jsum, j_scale, world, jnp.float32, chunk)
    assert tm.numpy().tobytes() == np.asarray(jm).tobytes()
    bound = jax_quant.error_bound(wire, np.abs(buf).max(), world)
    assert np.abs(tm.numpy() - buf).max() <= bound * (1 + 1e-6)
    assert np.all(tm.numpy()[:512] == 0.0)


def test_comm_dtype_ctor_env_resolution(monkeypatch):
    """Constructor beats the environment, ``"none"`` pins the wire off, an
    unset constructor falls through to ``CHAINERMN_TPU_COMM_DTYPE``; on
    gloo ``fp8`` resolves to the int8 wire (gloo sums no float8)."""
    monkeypatch.delenv(quant.ENV_COMM_DTYPE, raising=False)
    comm = create_communicator("naive", device="cpu")
    assert comm.resolve_comm_dtype() is None and comm.wire_dtype() is None
    monkeypatch.setenv(quant.ENV_COMM_DTYPE, "int8")
    assert comm.resolve_comm_dtype() == "int8"
    assert comm.wire_dtype() == torch.int8
    off = create_communicator("naive", device="cpu", comm_dtype="none")
    assert off.resolve_comm_dtype() is None
    fp8 = create_communicator("naive", device="cpu", comm_dtype="fp8")
    monkeypatch.setenv(quant.ENV_COMM_DTYPE, "none")
    assert fp8.resolve_comm_dtype() == "fp8"
    assert fp8.wire_dtype() == torch.int8
    with pytest.raises(ValueError, match="comm_dtype"):
        create_communicator("naive", device="cpu", comm_dtype="int4")


def test_world1_quantizes_and_full_precision_is_untouched(monkeypatch):
    """The quantized wire runs at world 1 too (nonzero error within the
    bound); a full-precision wire leaves the gradients' bytes alone."""
    monkeypatch.delenv(quant.ENV_COMM_DTYPE, raising=False)
    grads = worker.rank_grads(0)
    amax = max(float(np.abs(g).max()) for g in grads)
    comm = create_communicator("xla_ici", device="cpu", comm_dtype="int8")
    ts = [torch.from_numpy(g.copy()) for g in grads]
    comm.allreduce_grad(ts)
    err = max(float(np.abs(t.numpy() - g).max()) for t, g in zip(ts, grads))
    assert 0 < err <= quant.error_bound("int8", amax, 1)
    assert [t.dtype for t in ts] == [torch.from_numpy(g).dtype for g in grads]
    assert quant.measure_comm_quant_error(
        comm, [torch.from_numpy(g) for g in grads]) == err
    plain = create_communicator("xla_ici", device="cpu")
    ts = [torch.from_numpy(g.copy()) for g in grads]
    plain.allreduce_grad(ts)
    assert all(np.array_equal(t.numpy(), g) for t, g in zip(ts, grads))
    with pytest.raises(ValueError, match="resolved comm_dtype"):
        quant.measure_comm_quant_error(plain, ts)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("name", worker.ALL_NAMES)
def test_quantized_mean_within_error_bound(comm_runs, name, wire, size):
    for out in comm_runs[size]:
        got = out["quant"][f"{name}/{wire}"]
        assert 0.0 < got["err"] <= got["bound"] * (1 + 1e-6), got
        # Against the communicator's own full-precision mean rather than
        # numpy's: the same error up to fp32 summation order.
        assert abs(got["self_err"] - got["err"]) < 1e-6
        assert got["dtypes"] == ["torch.float32"] * 5 + ["torch.float64"]
        # Gloo sums no float8: the fp8 wire falls back to int8, and gives
        # the int8 wire's bytes.
        assert got["wire"] == "int8"
        assert got["err"] == out["quant"][f"{name}/int8"]["err"]
    # The error is the same whichever pattern carried the sum.
    errs = {out["quant"][f"{n}/{wire}"]["err"] for out in comm_runs[size]
            for n in worker.ALL_NAMES}
    assert len(errs) == 1


@pytest.mark.parametrize("size", [2, 4])
def test_gloo_sums_int8(comm_runs, size):
    """Gloo's all-reduce sums int8 exactly, so the CPU tests hold the int8
    wire byte for byte."""
    want = sum(worker.int8_payload(r) for r in range(size)).tolist()
    for out in comm_runs[size]:
        assert out["int8_sum"] == want


# -- overlap ---------------------------------------------------------------

def _grad_list():
    rng = np.random.RandomState(0)
    shapes = [(300,), (17, 3), (1,), (1024,), (5, 5, 5), (2,), (40,)]
    dts = [np.float32, np.float32, np.float64, np.float32, np.float16,
           np.float64, np.float32]
    return [rng.randn(*s).astype(d) for s, d in zip(shapes, dts)]


@pytest.mark.parametrize("granularity", [1, 2, 3])
@pytest.mark.parametrize("bucket_bytes", [64, 1024, 4096])
def test_overlap_schedule_matches_reference(bucket_bytes, granularity):
    grads = _grad_list()
    plan = packing.GradPacker.for_tensors([torch.from_numpy(g)
                                           for g in grads], bucket_bytes)
    ref = jax_packing.GradPacker.for_tree(list(grads), bucket_bytes)
    got = overlap.build_overlap_schedule(plan, granularity)
    want = jax_overlap.build_overlap_schedule(ref, granularity)
    assert got.stages == want.stages and got.describe() == want.describe()
    assert sorted(got.order) == list(range(plan.n_buckets))


def test_overlap_env_gates(monkeypatch):
    assert (overlap.ENV_OVERLAP, overlap.ENV_OVERLAP_GRANULARITY,
            quant.ENV_COMM_DTYPE) == (
        jax_overlap.ENV_OVERLAP, jax_overlap.ENV_OVERLAP_GRANULARITY,
        jax_quant.ENV_COMM_DTYPE)
    monkeypatch.delenv(overlap.ENV_OVERLAP, raising=False)
    monkeypatch.delenv(overlap.ENV_OVERLAP_GRANULARITY, raising=False)
    comm = create_communicator("naive", device="cpu")
    assert comm.resolve_overlap() is True
    assert comm.resolve_overlap_granularity() == 1
    for raw, on in (("0", False), ("off", False), ("no", False), ("1", True)):
        monkeypatch.setenv(overlap.ENV_OVERLAP, raw)
        assert comm.resolve_overlap() is on
        assert overlap.overlap_enabled() == jax_overlap.overlap_enabled()
    assert comm.resolve_overlap(True) is True
    pinned = create_communicator("naive", device="cpu", overlap=True,
                                 overlap_granularity=3)
    assert pinned.resolve_overlap() is True
    monkeypatch.setenv(overlap.ENV_OVERLAP_GRANULARITY, "5")
    assert comm.resolve_overlap_granularity() == 5
    assert pinned.resolve_overlap_granularity() == 3
    monkeypatch.setenv(overlap.ENV_OVERLAP_GRANULARITY, "junk")
    assert overlap.resolve_granularity() == jax_overlap.resolve_granularity()
    with pytest.raises(ValueError, match="overlap_granularity"):
        create_communicator("naive", device="cpu", overlap_granularity=0)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("case", list(worker.OVERLAP_CASES))
def test_overlapped_allreduce_byte_equal_to_eager(comm_runs, case, size):
    """Three Adam steps with the hooks and three without: the parameters'
    bytes and the losses are equal; hooks ran only when overlap was on."""
    for out in comm_runs[size]:
        got = out["overlap"][case]
        assert got["equal"] and got["losses_equal"], got
        assert got["hooked"] == [True, False]
    losses = [out["overlap"][case]["losses"] for out in comm_runs[size]]
    assert all(ls == losses[0] for ls in losses)


def test_no_hooks_on_one_rank_full_precision(monkeypatch):
    """At world 1 on a full-precision wire the step installs no hooks and
    runs no collective and no packing (the bucket plan is built once, for
    the telemetry report only): the mean is the gradient itself."""
    from chainermn_tpu_torch import create_multi_node_optimizer

    def no_packing(*a, **k):
        raise AssertionError("a bucket was packed on one rank")

    monkeypatch.setattr(packing.GradPacker, "pack", no_packing)
    monkeypatch.setattr(packing.GradPacker, "pack_bucket", no_packing)

    monkeypatch.delenv(quant.ENV_COMM_DTYPE, raising=False)
    net = worker._Net()
    comm = create_communicator("xla_ici", device="cpu", overlap=True,
                               bucket_bytes=96)

    def no_collective(*a, **k):
        raise AssertionError("a collective ran on one rank")

    comm._allreduce_impl = comm._allreduce_async = no_collective
    mno = create_multi_node_optimizer(torch.optim.SGD(net.parameters(),
                                                      lr=0.1), comm)
    mno.init()
    step = mno.make_train_step(lambda b: net(b).sum())
    step(torch.ones(4, 6))
    step(torch.ones(4, 6))
    assert mno._overlap is None and len(comm._packers) == 1


# -- communicators ---------------------------------------------------------

@pytest.mark.parametrize("bucket_bytes", [None, 0, 256])
@pytest.mark.parametrize("name", ["two_dimensional", "single_node"])
def test_two_dimensional_and_single_node_means_at_4_ranks(
        comm_runs, name, bucket_bytes):
    res = comm_runs[4]
    for r, out in enumerate(res):
        got = out["full"][f"{name}/{bucket_bytes}"]
        assert got["err"] < 1e-6, got
        if name == "two_dimensional":      # inter 2 x intra 2
            assert got["topology"] == [r // 2, 2, r % 2, 2]
        else:                              # one node of 4
            assert got["topology"] == [0, 1, r, 4]
        assert out["full"]["single_node_multi_node_raises"]


def test_single_host_raises_over_several_nodes():
    from chainermn_tpu_torch.communicators import (SingleHostCommunicator,
                                                   Topology)

    topo = Topology(device=torch.device("cpu"), rank=0, size=4,
                    intra_rank=0, intra_size=2, inter_rank=0, inter_size=2,
                    intra_group=None, inter_group=None)
    with pytest.raises(ValueError, match="inter_size == 1"):
        SingleHostCommunicator(topo)


def _expected_collectives(n):
    """numpy values of ``worker._tensor_collectives`` on a communicator of
    ``n`` ranks (its inputs name the communicator's rank, so a result in
    the wrong rank order shows)."""
    xs = [np.arange(2 * n, dtype=np.float32) + 100 * r for r in range(n)]
    root = n - 1
    stack = np.stack(xs)
    out = {}
    for r in range(n):
        scat = np.arange(2 * n, dtype=np.float32) * (root + 1)
        out[r] = {
            "allreduce_sum": stack.sum(0), "allreduce_mean": stack.mean(0),
            "allreduce_max": stack.max(0), "allreduce_min": stack.min(0),
            "allgather": stack, "allgather_tiled": stack.reshape(-1),
            "gather": stack if r == root else np.zeros_like(stack),
            "scatter": scat[2 * r:2 * r + 2],
            "alltoall": np.concatenate([x[2 * r:2 * r + 2] for x in xs]),
            "reduce_scatter": stack.sum(0)[2 * r:2 * r + 2],
            "bcast": xs[root],
        }
    return out


def test_object_plane_at_4_ranks(comm_runs):
    res = comm_runs[4]
    want = _expected_collectives(4)
    for r, out in enumerate(res):
        o = out["objects"]
        assert o["ring"] == (r - 1) % 4
        assert o["bcast_obj"] == 2
        assert o["gather_root"] == ([0, 10, 20, 30] if r == 1 else None)
        assert o["gather_timeout"] == ([0, 10, 20, 30] if r == 2 else None)
        assert o["allgather_timeout"] == [0, 1, 2, 3]
        assert o["allgather"] == [0, 1, 4, 9]
        assert o["allreduce_obj"] == 10
        assert o["allreduce_obj_op"] == [0, 1, 2, 3]
        assert o["scatter_obj"] == f"to{r}"
        for k, v in want[r].items():
            np.testing.assert_allclose(o[f"world/{k}"], v, rtol=1e-6,
                                       err_msg=k)
    # A receive that timed out raised, and its retry got the message.
    assert res[0]["objects"]["timeout"] == "raised"
    assert res[0]["objects"]["retry"] == "late"


def test_split_at_4_ranks(comm_runs):
    """``split(rank % 2, key=-rank)``: two colors, each ordered by
    descending global rank, so sub rank 1 (a root below) is the lower
    global rank of its color."""
    res = comm_runs[4]
    for r, out in enumerate(res):
        o = out["objects"]
        members = sorted([m for m in range(4) if m % 2 == r % 2],
                         reverse=True)
        sub_rank = members.index(r)
        assert o["sub"] == [sub_rank, 2, "NaiveCommunicator"]
        assert o["sub_allgather"] == members
        assert o["sub_bcast"] == members[1]
        assert o["sub_gather"] == (members if sub_rank == 1 else None)
        assert o["sub_scatter"] == f"s{sub_rank}"
        assert o["sub_grad_err"] < 1e-6
        want = _expected_collectives(2)[sub_rank]
        for k, v in want.items():
            np.testing.assert_allclose(o[f"sub/{k}"], v, rtol=1e-6,
                                       err_msg=k)
        assert o["solo"] == [0, 1, [r]]
        assert o["undefined"] == (None if r == 3 else [r, 3])
        assert o["degraded"] == "XlaIciCommunicator"


def test_evaluator_and_iterators_at_4_ranks(comm_runs):
    res = comm_runs[4]
    for r, out in enumerate(res):
        o = out["eval_iter"]
        # Rank r's batches hold 10 r + i; the mean over batches then ranks.
        assert o["evaluator"] == {"m": 16.0, "s": 64.0}
        assert o["wrapped"] == {"v": 1.5}
        assert o["multi_node"] == [[1, 0], [1, 1], [1, 2]]
        # Rank 0 has 2 batches: every rank stops after 2.
        assert o["synchronized"] == [[r, 0], [r, 1]]


def test_factory_builds_all_reference_names():
    from chainermn_tpu.communicators import _COMMUNICATORS as jax_names

    from chainermn_tpu_torch.communicators import _COMMUNICATORS

    assert set(_COMMUNICATORS) == set(jax_names)
    for name in _COMMUNICATORS:
        comm = create_communicator(name, device="cpu")
        assert comm.size == 1 and comm.split(0).size == 1



def test_facade_carries_the_reference_names():
    import chainermn_tpu
    import chainermn_tpu_torch

    for name in ("create_communicator", "CommunicatorBase",
                 "create_multi_node_optimizer", "MultiNodeOptimizer",
                 "scatter_dataset", "create_empty_dataset",
                 "create_multi_node_evaluator",
                 "create_multi_node_checkpointer",
                 "create_multi_node_iterator",
                 "create_synchronized_iterator", "create_prefetch_iterator",
                 "global_except_hook"):
        assert getattr(chainermn_tpu, name) is not None
        assert getattr(chainermn_tpu_torch, name).__name__.split(".")[-1] \
            == getattr(chainermn_tpu, name).__name__.split(".")[-1]
    with pytest.raises(AttributeError):
        chainermn_tpu_torch.MultiNodeChainList       # the next slice's
