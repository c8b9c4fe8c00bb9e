"""The port's host utilities against the JAX package's: ``utils.native``
(the g++ build of the port's ``csrc/hostbuf.cpp`` and its Python
fallbacks), ``utils.debug.CollectiveTrace`` and ``testing``'s dummy
communicator, on the same inputs made from a seed with numpy."""

import json

import numpy as np
import pytest
import torch

import chainermn_tpu.testing as ref_testing
import chainermn_tpu.utils.native as ref_native
from chainermn_tpu.communicators import build_mesh
from chainermn_tpu.communicators import create_communicator as jax_comm
from chainermn_tpu.utils.debug import CollectiveTrace as RefTrace
from chainermn_tpu_torch import testing
from chainermn_tpu_torch.utils import native
from chainermn_tpu_torch.utils.debug import CollectiveTrace


@pytest.fixture(params=["csrc", "fallback"])
def impl(request, monkeypatch):
    """The port with its g++ build, and with the build taken away (the
    Python fallbacks)."""
    if request.param == "csrc":
        assert native.native_impl() == "csrc"
    else:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_load_failed", True)
        monkeypatch.setattr(native, "_loaded_from", None)
        assert native.native_impl() is None and native.get_lib() is None
    return request.param


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(3, 5).astype(np.float32),
            rng.randint(-9, 9, (7,)).astype(np.int64),
            np.asarray(rng.randn(), np.float64),          # 0-d
            rng.randint(0, 255, (2, 3, 4)).astype(np.uint8),
            rng.randn(1000).astype(np.float16)]


def test_crc32c_matches_reference(impl):
    rng = np.random.RandomState(1)
    for n in (0, 1, 7, 8, 9, 1000, 65537):
        data = rng.randint(0, 256, n).astype(np.uint8)
        assert native.crc32c(data) == ref_native.crc32c(data)
        assert native.crc32c(data.tobytes(), seed=123) == \
            ref_native.crc32c(data.tobytes(), seed=123)
    assert native.crc32c(b"123456789") == 0xE3069283   # the known vector
    strided = np.arange(40, dtype=np.int32)[::2]
    assert native.crc32c(strided) == ref_native.crc32c(strided)


def test_tree_digest_matches_reference(impl):
    arrs = _arrays()
    tree = {"z": arrs[0], "a": [arrs[1], arrs[2]], "m": {"q": arrs[3],
                                                       "b": arrs[4]},
            "none": None}
    want = ref_native.tree_digest(tree)
    assert native.tree_digest(tree) == want
    as_tensors = {"z": torch.from_numpy(arrs[0]),
                  "a": [torch.from_numpy(arrs[1]),
                        torch.from_numpy(arrs[2])],
                  "m": {"q": torch.from_numpy(arrs[3]),
                        "b": torch.from_numpy(arrs[4])}}
    assert native.tree_digest(as_tensors) == want
    # bf16 through the tensor's storage: its raw 16-bit words.
    t = torch.randn(9, generator=torch.Generator().manual_seed(0))
    bf = t.bfloat16()
    assert native.tree_digest([bf]) == \
        ref_native.tree_digest([bf.view(torch.int16).numpy()])


def test_pack_unpack_match_reference(impl):
    arrs = _arrays()
    packed = native.pack_buffers(arrs)
    np.testing.assert_array_equal(packed, ref_native.pack_buffers(arrs))
    outs = [np.empty_like(a) for a in arrs]
    native.unpack_buffers(packed, outs)
    for a, b in zip(outs, arrs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        native.pack_buffers(arrs, out=np.empty(3, np.uint8))
    with pytest.raises(ValueError):
        native.unpack_buffers(packed[:5], outs)


def test_parallel_gather_matches_reference_and_np_stack(impl):
    rng = np.random.RandomState(2)
    items = [rng.randn(32, 32, 3).astype(np.float32) for _ in range(64)]
    got = native.parallel_gather(items, n_threads=4)
    np.testing.assert_array_equal(got, np.stack(items))
    np.testing.assert_array_equal(got, ref_native.parallel_gather(items))
    with pytest.raises(ValueError):
        native.parallel_gather([items[0], items[1][:3]])


def test_native_queue_round_trip(impl):
    q = native.NativeQueue(capacity=3)
    payloads = [bytes([i]) * (i + 1) for i in range(3)]
    for p in payloads:
        assert q.push(p)
    assert q.size() == 3
    assert [q.pop(16) for _ in payloads] == payloads
    q.close()
    assert q.pop(16) == b"" and not q.push(b"x")


def test_crc32c_impl_names():
    assert native.crc32c_impl() in ("hw", "sw")
    assert native.native_impl() == "csrc"


# ---------------------------------------------------------------------------
# CollectiveTrace
# ---------------------------------------------------------------------------

def _ops(trace, tensors):
    # The reference's device-plane ops run inside shard_map only: their
    # entries are recorded as its wrapper records them, before the call.
    trace._record("allreduce_grad", tensors)
    trace._record("allgather", tensors[next(iter(tensors))]
                  if isinstance(tensors, dict) else tensors[0])
    trace.bcast_obj({"k": 1})
    trace.allreduce_obj(3)
    trace.gather_obj("x", root=0)
    trace.barrier()


def test_fingerprint_matches_reference(devices8):
    """The same op sequence gives the reference's log and fingerprint.
    Object-plane entries name the plane by the communicator's creation
    count in its process; both are named alike here."""
    from chainermn_tpu_torch import create_communicator

    arrs = _arrays()
    mesh = build_mesh(inter_size=1, intra_size=1, devices=devices8[:1])
    ref = RefTrace(jax_comm("xla_ici", mesh=mesh))
    import jax.numpy as jnp

    _ops(ref, {"a": jnp.asarray(arrs[0]), "b": jnp.asarray(arrs[4])})
    comm = create_communicator("xla_ici", device="cpu")
    comm.plane_name = ref._comm._obj_plane.namespace
    port = CollectiveTrace(comm)
    _ops(port, [torch.from_numpy(arrs[0].copy()),
                torch.from_numpy(arrs[4].copy())])
    assert port.log == ref.log
    assert json.loads(port.log[0])["args"][1]["dtype"] == "float16"
    assert port.fingerprint() == ref.fingerprint()
    assert port.verify_across_hosts() == port.fingerprint()
    # Through the wrapper the port records before it runs the op.
    wrapped = CollectiveTrace(comm)
    out = wrapped.allreduce_grad([torch.from_numpy(arrs[0].copy()),
                                  torch.from_numpy(arrs[4].copy())])
    assert wrapped.log == port.log[:1] and len(out) == 2
    port.reset()
    assert port.log == [] and port.fingerprint() == native.crc32c(b"")


def test_fingerprint_skips_point_to_point():
    comm = testing.DummyCommunicator()
    comm.plane_name = "comm1"
    comm.send_obj = lambda obj, dest, tag=0: None
    trace = CollectiveTrace(comm)
    before = trace.fingerprint()
    trace.send_obj("payload", 1, tag=5)
    assert len(trace.log) == 1 and trace.fingerprint() == before
    entry = json.loads(trace.log[0])
    assert entry == {"op": "send_obj", "plane": "comm1",
                     "args": ["payload", 1], "kwargs": {"tag": 5}}


# ---------------------------------------------------------------------------
# DummyCommunicator
# ---------------------------------------------------------------------------

def _dummy_results(mod):
    out = {}
    one = mod.DummyCommunicator()
    out["one"] = [one.bcast_obj(5), one.gather_obj(2), one.allgather_obj(3),
                  one.allreduce_obj(4), one.scatter_obj([7, 8]),
                  one.barrier(), one.gather_obj(1, root=0)]
    group = mod.dummy_communicators(3)
    out["bcast"] = [c.bcast_obj(f"from{c.rank}", root=1) for c in group]
    out["gather"] = [c.gather_obj(c.rank, root=2, timeout_ms=5)
                     for c in group]
    out["allgather"] = [c.allgather_obj(c.rank) for c in group]
    out["sum"] = [c.allreduce_obj(c.rank + 1) for c in group]
    out["max"] = [c.allreduce_obj(c.rank, op=max) for c in group]
    out["dict"] = [c.allreduce_obj({"a": 1.5},
                                   op=lambda a, b: {"a": a["a"] + b["a"]})
                   for c in group]
    out["scatter"] = [c.scatter_obj(["x", "y", "z"]) for c in group]
    errors = []
    for name in ("allreduce", "bcast", "allgather", "alltoall",
                 "reduce_scatter", "scatter", "ppermute", "allreduce_grad",
                 "broadcast_data", "shard_map", "axis_index", "nope"):
        try:
            getattr(group[0], name)
        except (NotImplementedError, AttributeError) as e:
            errors.append((name, type(e).__name__))
    out["errors"] = errors
    try:
        group[0].gather_obj(1, timeout_ms=5)
    except ValueError as e:
        out["timeout_needs_root"] = str(e)
    return out


def test_dummy_communicator_matches_reference():
    assert _dummy_results(testing) == _dummy_results(ref_testing)


def test_verify_across_hosts_at_two_ranks(tmp_path):
    """Two gloo ranks: the same sequence verifies to one fingerprint on
    both; one extra entry on rank 1 raises on both, naming the entry."""
    from test_torch_telemetry import spawn

    ranks = spawn(2, tmp_path, which="debug")
    assert ranks[0]["common"] == ranks[1]["common"] == \
        ranks[0]["fingerprint"]
    for r in ranks:
        assert "collective order mismatch" in r["mismatch"]
        assert "first differing call #2" in r["mismatch"]
        assert "<missing>" in r["mismatch"]
