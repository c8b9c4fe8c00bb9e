"""The port's collective audit (``chainermn_tpu_torch.observability.
collective_audit``) and packing reporters against the reference's wire
goldens.

One subprocess (``tests/_torch_audit_worker.py``) joins torch's process
group without peers, a world of 8 forced to 2 x 4, as rank 0 (a node
leader) and rank 1, and audits ``allreduce_grad`` of the reference's
64-leaf tree on the five communicators; then the serving steps on a world
of 2.  The goldens are read as data, never regenerated.  Each expected
value is the golden's number, or one worked out from it here by the
port's algorithm (the arithmetic is in the comment beside it); none is
taken from a run of the port.  The reference's packer and schedule run in
this process for ``describe``/``wire_bytes`` and the overlap order.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
COMMUNICATORS = ("naive", "flat", "xla_ici", "hierarchical",
                 "two_dimensional")
INTRA = 4                         # the goldens' mesh is (inter 2, intra 4)
RANKS = ("0", "1")                # a node leader and a rank that is not


def _golden(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def audits():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get(
                   "PYTHONPATH", "")]))
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests",
                                      "_torch_audit_worker.py")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=180)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _expected(name, rank, g):
    """The port's census of one golden row (``g``: a communicator's
    ``bucketed``/``unbucketed`` entry or an int8/overlap row) at ``rank``:
    ``(census, reductions, bytes_per_axis, op_bytes)``."""
    census = dict(g["hlo_collectives"])
    red = g["reduction_collectives"]
    axes = dict(g["per_axis_operand_bytes"])
    ob = g["op_bytes"]
    if name in ("naive", "flat", "xla_ici"):
        return census, red, axes, {"all_reduce": ob["psum"]}
    if name == "two_dimensional":
        return census, red, axes, {"reduce_scatter": ob["reduce_scatter"],
                                   "all_reduce": ob["psum"],
                                   "all_gather": ob["all_gather"]}
    # hierarchical: the reference's two psums a buffer (intra, then
    # inter) are the port's reduce to the node leader, the leaders'
    # all-reduce and the broadcast back.  The golden's psum list holds
    # each buffer twice, intra then inter.  The reduce and the broadcast
    # each move the whole buffer within the node: intra bytes are twice
    # the golden's.  Only a leader crosses nodes: at rank 1 no inter
    # all-reduce, one psum a buffer fewer and no inter bytes.
    intra, inter = ob["psum"][0::2], ob["psum"][1::2]
    assert intra == inter
    axes = {"intra": 2 * axes["intra"], "inter": axes["inter"]}
    out = {"reduce": intra, "all_reduce": inter, "broadcast": intra}
    if rank != "0":
        census["psum"] -= len(inter)
        red -= len(inter)
        del axes["inter"], out["all_reduce"]
    return census, red, axes, out


def _check(got, want):
    census, red, axes, op_bytes = want
    assert got["census"] == census
    assert got["reduction_collectives"] == red
    assert got["bytes_per_axis"] == axes
    assert got["op_bytes"] == op_bytes


@pytest.mark.parametrize("label", ["bucketed", "unbucketed"])
@pytest.mark.parametrize("name", COMMUNICATORS)
def test_census_matches_the_64_leaf_golden(audits, name, label):
    golden = _golden("allreduce_census_64leaf.json")
    assert golden["mesh"] == [2, INTRA]
    g = golden["communicators"][name][label]
    for rank in RANKS:
        _check(audits["ranks"][rank][name][label], _expected(name, rank, g))


def test_two_dimensional_inter_savings():
    """flat's and two_dimensional's audits on the same tree: the 2D
    claim holds exactly, bucketed and not; a profile that breaks it
    raises."""
    from chainermn_tpu_torch.observability import (
        assert_two_dimensional_inter_savings)

    golden = _golden("allreduce_census_64leaf.json")["communicators"]
    for label in ("bucketed", "unbucketed"):
        flat = golden["flat"][label]["per_axis_operand_bytes"]
        td = golden["two_dimensional"][label]["per_axis_operand_bytes"]
        assert td["inter"] * INTRA == flat["inter"]
    with pytest.raises(AssertionError, match="2D bandwidth claim"):
        assert_two_dimensional_inter_savings(
            {"flat": {"inter": 1000}, "two_dimensional": {"inter": 500}},
            INTRA)
    with pytest.raises(AssertionError):
        assert_two_dimensional_inter_savings(
            {"flat": {"inter": 1000}, "two_dimensional": {}}, INTRA)
    # one side missing: nothing to hold
    assert_two_dimensional_inter_savings({"flat": {"inter": 1}}, INTRA)


@pytest.mark.parametrize("label", ["bucketed", "unbucketed", "int8",
                                   "overlap", "one_buffer"])
def test_port_profiles_hold_the_two_dimensional_claim(audits, label):
    """The port's own flat and two_dimensional profiles, every scenario,
    both ranks: two_dimensional's inter bytes x 4 equal flat's."""
    from chainermn_tpu_torch.observability import (
        assert_two_dimensional_inter_savings)

    for rank in RANKS:
        r = audits["ranks"][rank]
        profiles = {}
        for n in ("flat", "two_dimensional"):
            got = r[n][label]
            # the int8 wire's amax words ride both axes at full size (a
            # MAX all-reduce over the world); the claim is the sums'.
            amax = got["bytes_per_primitive"].get("all_reduce:MAX", 0)
            profiles[n] = {k: v - amax
                           for k, v in got["bytes_per_axis"].items()}
        assert_two_dimensional_inter_savings(profiles, INTRA)
        assert profiles["two_dimensional"]["inter"] * INTRA == \
            profiles["flat"]["inter"]


@pytest.mark.parametrize("name", COMMUNICATORS)
def test_audit_allreduce_one_buffer(audits, name):
    """``audit_allreduce`` of 1 MiB: tests/test_observability.py's
    numbers, the flat backend's one psum charging the whole buffer to
    both axes and two_dimensional's inter leg a quarter of it; the
    hierarchical leader's reduce and broadcast twice the buffer within
    the node and the buffer once across nodes."""
    nbytes = 1 << 20
    for rank in RANKS:
        got = audits["ranks"][rank][name]["one_buffer"]
        if name in ("naive", "flat", "xla_ici"):
            assert got["census"]["psum"] == 1
            assert got["bytes_per_axis"] == {"inter": nbytes,
                                             "intra": nbytes}
        elif name == "two_dimensional":
            assert got["counts"] == {"reduce_scatter": 1, "all_reduce": 1,
                                     "all_gather": 1}
            assert got["bytes_per_axis"]["inter"] * INTRA == nbytes
            # the reduce-scatter's whole buffer plus the gather's shard
            assert got["bytes_per_axis"]["intra"] == nbytes + nbytes // INTRA
        else:
            assert got["bytes_per_axis"]["intra"] == 2 * nbytes
            assert got["bytes_per_axis"].get("inter", 0) == (
                nbytes if rank == "0" else 0)


def _ref_plan(n_leaves, total, bucket_bytes):
    from chainermn_tpu.communicators.packing import (GradPacker,
                                                     synthetic_grad_tree)

    return GradPacker.for_tree(synthetic_grad_tree(n_leaves, total),
                               bucket_bytes=bucket_bytes)


@pytest.mark.parametrize("name", COMMUNICATORS)
def test_bucketed_census_does_not_depend_on_the_leaf_count(audits, name):
    """tests/test_packing.py:379's counterpart (24 leaves, 64 KiB
    buckets): reductions are the reference plan's bucket count times the
    reductions a bucket takes (one; two for the two-level patterns, whose
    non-leader ranks in hierarchical skip the inter leg), and the bytes
    per axis cover the payload as there."""
    plan = _ref_plan(24, 512 * 1024, 64 * 1024)
    assert plan.n_buckets < plan.n_leaves
    per_bucket = {"hierarchical": 2, "two_dimensional": 2}.get(name, 1)
    for rank in RANKS:
        got = audits["ranks"][rank][name]["small_bucketed"]
        n = per_bucket - (name == "hierarchical" and rank != "0")
        assert got["reduction_collectives"] == n * plan.n_buckets
        assert got["bytes_per_axis"].get("intra", 0) >= plan.payload_bytes
        if not (name == "hierarchical" and rank != "0"):
            assert got["bytes_per_axis"].get("inter", 0) >= \
                plan.payload_bytes // INTRA


def test_unbucketed_census_scales_with_the_leaves(audits):
    """tests/test_packing.py:403's counterpart: naive without buckets
    reduces every one of the 24 leaves."""
    for rank in RANKS:
        got = audits["ranks"][rank]["naive"]["small_unbucketed"]
        assert got["reduction_collectives"] == 24


@pytest.mark.parametrize("name", COMMUNICATORS)
def test_int8_census_matches_its_golden(audits, name):
    """``comm_dtype="int8"``: the golden's psums on the narrow buffers.
    The port sends each bucket's fp32 amax (4 bytes) in its own MAX
    all-reduce over the world before the sum; the reference's census
    leaves its pmax out, so the census is the golden's and each axis
    carries 4 bytes a bucket more (the world group charges both)."""
    golden = _golden("allreduce_census_64leaf_int8.json")
    assert golden["comm_dtype"] == "int8"
    g = golden["communicators"][name]
    n_buckets = len(g["op_bytes"]["psum"]) // (
        2 if name == "hierarchical" else 1)
    for rank in RANKS:
        got = audits["ranks"][rank][name]["int8"]
        census, red, axes, op_bytes = _expected(name, rank, g)
        axes = {k: v + 4 * n_buckets for k, v in axes.items()}
        axes.setdefault("inter", 4 * n_buckets)
        op_bytes["all_reduce:MAX"] = [4] * n_buckets
        assert got["counts"]["all_reduce:MAX"] == n_buckets
        _check(got, (census, red, axes, op_bytes))


@pytest.mark.parametrize("comm_dtype", [None, "int8", "fp8"])
def test_describe_and_wire_bytes_equal_the_reference(comm_dtype):
    """The port's plan of the 64-leaf tree at 256 KiB, described at full
    precision and on both narrow wires: the reference's dict.  Its
    per-bucket ``+ 4`` is the amax word, which the port's wire sends in
    its own MAX all-reduce (see the int8 census above): the bytes are
    the same."""
    from chainermn_tpu_torch.communicators.packing import (
        GradPacker, synthetic_grad_tree)

    ref = _ref_plan(64, 8 * 1024 * 1024, 256 * 1024)
    port = GradPacker.for_tree(synthetic_grad_tree(64, 8 * 1024 * 1024),
                               bucket_bytes=256 * 1024)
    assert port.describe(comm_dtype) == ref.describe(comm_dtype)
    assert port.wire_bytes(comm_dtype) == ref.wire_bytes(comm_dtype)
    for pb, rb in zip(port.buckets, ref.buckets):
        assert pb.quantizable == rb.quantizable
        assert pb.wire_bytes(1) == rb.wire_bytes(1)
        assert pb.wire_bytes() == rb.wire_bytes()


def test_quant_wire_dtype_and_fp8_supported():
    from chainermn_tpu_torch.communicators import quant

    assert quant.wire_dtype(None) is None
    assert quant.wire_dtype("none") is None
    assert quant.wire_dtype("int8") is torch.int8
    assert quant.fp8_supported() is True
    assert quant.wire_dtype("fp8") is torch.float8_e4m3fn
    with pytest.raises(ValueError):
        quant.wire_dtype("int4")


def test_overlap_schedule_matches_its_golden():
    from chainermn_tpu_torch.communicators import build_overlap_schedule
    from chainermn_tpu_torch.communicators.packing import (
        GradPacker, synthetic_grad_tree)

    golden = _golden("allreduce_census_64leaf_overlap.json")
    plan = GradPacker.for_tree(synthetic_grad_tree(64, 8 * 1024 * 1024),
                               bucket_bytes=golden["bucket_bytes"])
    sched = build_overlap_schedule(plan, golden["schedule"]["granularity"])
    assert plan.n_buckets == golden["n_buckets"]
    assert sched.describe()["order"] == golden["schedule"]["order"]
    assert [list(s) for s in sched.stages] == golden["schedule"]["stages"]


@pytest.mark.parametrize("name", COMMUNICATORS)
def test_overlapped_census_matches_its_golden(audits, name):
    """The backward-overlapped launch: the eager counts, the golden's
    census, bytes and per-bucket sizes in schedule order.  naive, flat
    and xla_ici launch each bucket as one ``async_op=True`` all-reduce
    waited on in ``finish()``: one pair a bucket, and backward compute
    between issue and wait for all but the last-launched bucket.  The
    two-level patterns run their legs in order, without pairs."""
    golden = _golden("allreduce_census_64leaf_overlap.json")
    g = golden["communicators"][name]
    for rank in RANKS:
        r = audits["ranks"][rank][name]
        got = r["overlap"]
        assert got["counts"] == r["bucketed"]["counts"]
        _check(got, _expected(name, rank, g))
        if name in ("naive", "flat", "xla_ici"):
            assert got["async_pairs"] == golden["n_buckets"]
            assert 0.9 < got["overlap_fraction"] <= 1.0, got
            eager = r["bucketed"]
            assert eager["async_pairs"] == golden["n_buckets"]
            assert eager["overlap_fraction"] == 0.0
        else:
            assert got["async_pairs"] == 0


def test_decode_step_is_collective_free():
    """The engine's decode step at world 1: the golden's empty census."""
    from chainermn_tpu_torch.analysis.fixtures import fixture_serving_decode
    from chainermn_tpu_torch.observability import audit_fn

    golden = _golden("serving_decode_census.json")
    t = fixture_serving_decode()
    a = audit_fn(t["fn"], *t["args"], state=t["state"])
    assert a.census() == golden["hlo_collectives"]
    assert a.reduction_collectives() == golden["reduction_collectives"]
    assert a.bytes_per_axis == golden["per_axis_operand_bytes"] == {}


def test_tp_decode_census_matches_its_golden(audits):
    """Plan ``tp`` on a world of 2: two all-reduces a layer (the
    attention output and FFN down projections; the 2-layer step minus the
    1-layer one) and a collective-free sampling tail (the leader samples
    on the host)."""
    golden = _golden("serving_tp_decode_census.json")
    s = audits["serving"]
    one, two = s["tp_decode_1"]["census"], s["tp_decode_2"]["census"]
    assert one == golden["hlo_collectives"]
    assert {k: two[k] - one[k] for k in one} == \
        golden["per_layer_collectives"]
    assert s["tp_decode_1"]["reduction_collectives"] == \
        golden["reduction_collectives"]
    assert s["sampling_tail"]["census"] == \
        golden["sampling_tail_collectives"]
    assert s["sampling_tail"]["reduction_collectives"] == \
        golden["sampling_tail_reduction_collectives"]


def test_sp_prefill_census_matches_its_golden(audits):
    """The ``sp`` chunk prefill on a world of 2: gathers only, no
    reduction.  The golden's two are the layer's K and V gathers; the
    port gathers the chunk's logits back to the whole slice in one more
    (the reference's program returns them sharded, its ``out_specs``
    gathering outside the program)."""
    golden = _golden("serving_sp_prefill_census.json")
    got = audits["serving"]["sp_prefill"]
    want = dict(golden["hlo_collectives"])
    want["all_gather"] += 1
    assert got["census"] == want
    assert got["reduction_collectives"] == golden["reduction_collectives"]


def test_audit_fn_on_a_toy_step(audits):
    """tests/test_observability.py's toy cases: one all-reduce of a
    (256,) fp32 buffer over the world charges 1 KiB to both axes; a step
    without collectives has an empty census; the summary's keys are the
    reference's."""
    from chainermn_tpu_torch.observability import audit_fn

    for rank in RANKS:
        toy = audits["ranks"][rank]["toy"]
        assert toy["psum"]["counts"] == {"all_reduce": 1}
        assert toy["psum"]["bytes_per_axis"] == {"inter": 1024,
                                                 "intra": 1024}
        assert toy["psum"]["async_pairs"] == 0
        assert toy["local"]["counts"] == {}
        assert toy["local"]["census"]["psum"] == 0
    a = audit_fn(lambda x: x * 2, torch.ones(4))
    assert a.counts == {} and a.census()["psum"] == 0
    assert set(a.summary()) == {
        "counts", "bytes_per_axis", "bytes_per_primitive", "op_bytes",
        "reduction_collectives", "async_pairs", "overlap_fraction"}


def test_summary_keys_equal_the_reference():
    from chainermn_tpu.observability.hlo_audit import CollectiveAudit as Ref

    from chainermn_tpu_torch.observability import CollectiveAudit

    ref = Ref({"psum": 1}, {"inter": 4}, {"psum": 4}, {"psum": [4]})
    port = CollectiveAudit({"all_reduce": 1}, {"inter": 4},
                           {"all_reduce": 4}, {"all_reduce": [4]})
    assert set(port.summary()) == set(ref.summary())
    assert port.census() == ref.census()
    assert port.reduction_collectives() == ref.reduction_collectives()


def test_audit_restores_state_and_rng():
    """A capture leaves the tensors it is given and the RNG as it found
    them: a step that updates a parameter and draws a random number runs
    under the audit, then for real, and matches a run without it."""
    from chainermn_tpu_torch.observability import audit_fn

    def run(audit):
        torch.manual_seed(0)
        m = torch.nn.Module()
        m.w = torch.nn.Parameter(torch.ones(8))

        def step(x):
            loss = (m.w * x + torch.rand(8)).sum()
            loss.backward()
            with torch.no_grad():
                m.w.sub_(0.1 * m.w.grad)
            return loss

        x = torch.arange(8.0)
        if audit:
            audit_fn(step, x, state=m)
            assert m.w.grad is None
        return step(x).item(), m.w.detach().clone(), torch.rand(1)

    plain, audited = run(False), run(True)
    assert plain[0] == audited[0]
    assert torch.equal(plain[1], audited[1])
    assert torch.equal(plain[2], audited[2])


# ---------------------------------------------------------------------------
# The examples' hlo_audit row
# ---------------------------------------------------------------------------
MNIST = ["--device", "cpu", "--communicator", "naive", "--epochs", "1",
         "--unit", "16", "--train-size", "256", "--val-size", "64",
         "--batchsize", "64"]
IMAGENET = ["--device", "cpu", "--communicator", "naive", "--arch",
            "resnet18", "--batchsize", "8", "--image-size", "32",
            "--num-classes", "10", "--train-size", "16", "--val-size", "8",
            "--steps", "2", "--epochs", "1", "--prefetch", "0"]


@pytest.mark.parametrize("example", ["mnist", "imagenet"])
def test_example_writes_one_hlo_audit_row(tmp_path, example):
    """``--step-log`` adds one ``hlo_audit`` row (at world 1 the step
    issues no collective: an empty census), ``tools.obs summarize`` reads
    it, and the losses and parameters are bitwise those of the same run
    without the flag."""
    from chainermn_tpu_torch.examples import train_imagenet, train_mnist
    from chainermn_tpu_torch.observability.step_log import read_records
    from chainermn_tpu_torch.tools.obs import summarize

    mod, argv = {"mnist": (train_mnist, MNIST),
                 "imagenet": (train_imagenet, IMAGENET)}[example]
    plain = mod.main(argv)
    log = tmp_path / "steps.jsonl"
    logged = mod.main(argv + ["--step-log", str(log)])
    assert logged["params_digest"] == plain["params_digest"]
    key = "step_losses" if example == "imagenet" else "epoch_losses"
    assert np.array_equal(np.asarray(logged[key]), np.asarray(plain[key]))
    rows = read_records(str(log))
    audit = [r for r in rows if r["event"] == "hlo_audit"]
    assert len(audit) == 1
    assert audit[0]["counts"] == {} and audit[0]["bytes_per_axis"] == {}
    assert summarize(rows)["collectives"] == {"counts": {},
                                              "bytes_per_axis": {}}
