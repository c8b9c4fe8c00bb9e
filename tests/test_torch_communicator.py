"""The port's communicators, packing and dataset scatter.

Multi-rank runs are real gloo process groups: workers start with the
``spawn`` method from ``tests/_torch_dist_worker.py`` (which imports no
JAX), meet at a ``file://`` rendezvous under ``tmp_path``, and each
rank's mean gradient is checked against the numpy mean of every rank's
gradients.  Gloo sums in fp32/fp64, so the mean agrees to 1e-6.  Packing
is a pure layout move and round-trips bit-exact; the dataset shards are
the reference's index for index.
"""

import importlib
import json
import multiprocessing as mp

import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from chainermn_tpu.communicators import packing as jax_packing
from chainermn_tpu_torch import create_communicator
from chainermn_tpu_torch.communicators import packing

# The modules, not the same-named functions the packages re-export.
jax_scatter = importlib.import_module("chainermn_tpu.datasets.scatter_dataset")
port_scatter = importlib.import_module(
    "chainermn_tpu_torch.datasets.scatter_dataset")

JOIN_TIMEOUT_S = 120


def _spawn(kind, size, tmp_path, **args):
    ctx = mp.get_context("spawn")
    init = tmp_path / "rendezvous"
    procs = [ctx.Process(target=worker.run,
                         args=(kind, r, size, str(init), str(tmp_path), args))
             for r in range(size)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
            assert p.exitcode is not None, f"rank timed out after {JOIN_TIMEOUT_S}s"
            assert p.exitcode == 0, f"rank exited {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(size)]


@pytest.mark.parametrize("comm,size,bucket_bytes,dtype", [
    ("naive", 2, None, None),
    ("pure_nccl", 2, None, None),
    ("pure_nccl", 2, 0, "float64"),
    ("naive", 2, 64, None),
    ("hierarchical", 4, None, None),
])
def test_allreduce_grad_is_the_numpy_mean(tmp_path, comm, size, bucket_bytes,
                                          dtype):
    res = _spawn("allreduce", size, tmp_path, comm=comm,
                 bucket_bytes=bucket_bytes, dtype=dtype)
    for r, out in enumerate(res):
        assert out["max_err"] < 1e-6, (r, out)
        assert out["dtypes"] == ["torch.float32"] * 5 + ["torch.float64"]
        assert out["plans"] == (0 if bucket_bytes == 0 else 1)
    if comm == "hierarchical":
        assert [o["topology"] for o in res] == [
            [0, 2, 0, 2], [0, 2, 1, 2], [1, 2, 0, 2], [1, 2, 1, 2]]


def test_two_rank_sgd_matches_single_device(tmp_path):
    """Rank 1 starts from other weights; the first broadcast replaces
    them, and each rank's half-batch gradients average to the full
    batch's."""
    res = _spawn("sgd", 2, tmp_path, comm="pure_nccl")
    x, y, w = worker.linear_problem()
    wr = torch.nn.Parameter(torch.from_numpy(w))
    sgd = torch.optim.SGD([wr], lr=0.1)
    for _ in range(3):
        sgd.zero_grad()
        ((torch.from_numpy(x) @ wr - torch.from_numpy(y)) ** 2).mean() \
            .backward()
        sgd.step()
    for out in res:
        np.testing.assert_allclose(out["w"], wr.detach().numpy().ravel(),
                                   rtol=1e-6, atol=1e-6)
    assert res[0]["losses"] == res[1]["losses"]


def _grad_list():
    rng = np.random.RandomState(0)
    shapes = [(300,), (17, 3), (1,), (1024,), (5, 5, 5), (2,)]
    dts = [np.float32, np.float32, np.float64, np.float32, np.float16,
           np.float64]
    return [rng.randn(*s).astype(d) for s, d in zip(shapes, dts)]


@pytest.mark.parametrize("bucket_bytes", [64, 1024, 4096, 1 << 22])
def test_grad_packer_round_trips_and_matches_reference_plan(bucket_bytes):
    grads = _grad_list()
    tensors = [torch.from_numpy(g) for g in grads]
    plan = packing.GradPacker.for_tensors(tensors, bucket_bytes)
    bufs = plan.pack(tensors)
    assert [b.numel() for b in bufs] == [b.padded_elems for b in plan.buckets]
    back = plan.unpack(bufs)
    for a, b in zip(tensors, back):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    # The reference's plan over the same leaves in the same order (a list
    # flattens in order): same buckets, same padding.
    ref = jax_packing.GradPacker.for_tree(list(grads), bucket_bytes)
    assert [(b.leaf_indices, b.elems, b.padded_elems) for b in plan.buckets] \
        == [(b.leaf_indices, b.elems, b.padded_elems) for b in ref.buckets]


def test_pack_tree_round_trip_and_padding():
    ts = [torch.arange(6.0).reshape(2, 3), torch.ones(4)]
    flat, unpack = packing.pack_tree(ts, pad_to=16)
    assert flat.numel() == 16 and torch.all(flat[10:] == 0)
    assert all(torch.equal(a, b) for a, b in zip(ts, unpack(flat)))
    with pytest.raises(ValueError, match="pad_to"):
        packing.pack_tree(ts, pad_to=4)
    with pytest.raises(ValueError, match="positive"):
        packing.GradPacker([(2,)], [torch.float32], bucket_bytes=0)


class _Comm:
    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    def bcast_obj(self, obj, root=0):
        return obj


@pytest.mark.parametrize("n,size", [(10, 3), (64, 8), (7, 4), (5, 1)])
@pytest.mark.parametrize("shuffle,seed", [(False, None), (True, 3)])
def test_scatter_dataset_indices_identical_to_reference(n, size, shuffle, seed):
    data = list(range(100, 100 + n))
    for r in range(size):
        got = port_scatter.scatter_dataset(data, _Comm(r, size),
                                           shuffle=shuffle, seed=seed)
        want = jax_scatter.scatter_dataset(data, _Comm(r, size),
                                           shuffle=shuffle, seed=seed)
        np.testing.assert_array_equal(got.indices, want.indices)
        assert [got[i] for i in range(len(got))] == \
            [want[i] for i in range(len(want))]
    empty = port_scatter.create_empty_dataset(data)
    assert len(empty) == n and empty[0] == ()


def test_factory_names_and_errors():
    comm = create_communicator("naive", device="cpu")
    assert (comm.rank, comm.size, comm.intra_rank, comm.intra_size,
            comm.inter_rank, comm.inter_size) == (0, 1, 0, 1, 0, 1)
    for name in ("flat", "xla_ici", "pure_nccl", "hierarchical",
                 "non_cuda_aware", "two_dimensional", "single_host",
                 "single_node"):
        assert create_communicator(name, device="cpu").size == 1
    with pytest.raises(ValueError, match="choose from"):
        create_communicator("bogus", device="cpu")
    with pytest.raises(ValueError, match="bucket_bytes"):
        create_communicator("naive", device="cpu", bucket_bytes=-1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_communicator("pure_nccl")


def test_one_rank_allreduce_and_broadcast_keep_values():
    comm = create_communicator("pure_nccl", device="cpu",
                               allreduce_grad_dtype=torch.float64)
    grads = [torch.from_numpy(g.copy()) for g in _grad_list()]
    comm.allreduce_grad(grads)
    for g, want in zip(grads, _grad_list()):
        assert g.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(g.numpy(), want)
    params = [torch.ones(3)]
    comm.broadcast_data(params)
    comm.barrier()
    assert torch.equal(params[0], torch.ones(3))


def test_one_rank_allreduce_runs_no_collective_and_keeps_the_cast():
    """On one rank the mean is the input: no bucket plan and no
    collective, but a narrower ``allreduce_grad_dtype`` still rounds the
    gradients as the reference's cast round trip does."""
    comm = create_communicator("pure_nccl", device="cpu",
                               allreduce_grad_dtype=torch.bfloat16)

    def no_collective(tensors):
        raise AssertionError("a collective ran on one rank")

    comm._allreduce_impl = no_collective
    grads = [torch.from_numpy(g.astype(np.float32)) for g in _grad_list()]
    want = [g.to(torch.bfloat16).float() for g in grads]
    comm.allreduce_grad(grads)
    for g, w in zip(grads, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    assert comm._packers == {}
