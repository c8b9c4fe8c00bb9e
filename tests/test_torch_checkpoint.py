"""The port's checkpointer, except hook and iterators, mirroring
``tests/test_extensions.py`` and ``tests/test_iterators.py``.

The checkpointer keeps the reference's layout (``snapshot_iter_N.rankR``,
``done_iter_N.rankR`` markers holding the world size, ``rotated_iter_N``
tombstones, ``*.quarantined``) with its own snapshot format (a header and
raw tensor bytes, each under a ``zlib.crc32``).  Multi-rank cases run on
gloo workers from ``tests/_torch_dp_worker.py`` under a 60 s limit.
"""

import json
import multiprocessing as mp
import os
import shutil
import struct
import subprocess
import sys
import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dp_worker as worker
from chainermn_tpu.communicators import build_mesh
from chainermn_tpu.communicators import create_communicator as jax_comm
from chainermn_tpu.extensions import (
    create_multi_node_checkpointer as jax_checkpointer)
from chainermn_tpu_torch import (create_communicator,
                                 create_multi_node_optimizer)
from chainermn_tpu_torch.datasets.multiprocess_iterator import (
    MultiprocessBatchLoader)
from chainermn_tpu_torch.datasets.toy import (ExplodingDataset,
                                              SyntheticImageDataset,
                                              batch_iterator)
from chainermn_tpu_torch.extensions import (CheckpointCorruptionError,
                                            create_multi_node_checkpointer)
from chainermn_tpu_torch.extensions.checkpoint import (_MAGIC,
                                                       _read_snapshot,
                                                       _write_snapshot)
from chainermn_tpu_torch.iterators import (create_multi_node_iterator,
                                           create_prefetch_iterator,
                                           create_synchronized_iterator)

JOIN_TIMEOUT_S = 60
WORKER = os.path.join(os.path.dirname(__file__), "_torch_dp_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def comm():
    return create_communicator("naive", device="cpu")


def _cp(comm, tmp_path, name="job", **kw):
    return create_multi_node_checkpointer(name, comm, path=str(tmp_path),
                                          **kw)


def _corrupt_payload(path):
    """Flip one byte of the payload (past magic, u64 + u32, header)."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    assert bytes(data[:len(_MAGIC)]) == _MAGIC
    (hlen,) = struct.unpack_from("<Q", data, len(_MAGIC))
    data[len(_MAGIC) + 12 + hlen] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))


# -- checkpointer ------------------------------------------------------------

def test_checkpointer_roundtrip(tmp_path, comm):
    cp = _cp(comm, tmp_path)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3),
                        "h": torch.ones(3, dtype=torch.bfloat16)},
             "step": 5, "arr": np.arange(4, dtype=np.int16),
             "nested": [torch.zeros(2), (1, "x")]}
    got, it = cp.maybe_load(state)
    assert it is None and got is state
    cp.save(state, iteration=10)
    nxt = {**state, "params": {k: v + 1 for k, v in state["params"].items()},
           "step": 6}
    cp.save(nxt, iteration=20)
    got, it = cp.maybe_load(state)
    assert it == 20 and got["step"] == 6
    assert torch.equal(got["params"]["w"], torch.arange(6.0).reshape(2, 3) + 1)
    assert got["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["h"], torch.full((3,), 2.0,
                                                      dtype=torch.bfloat16))
    np.testing.assert_array_equal(got["arr"], np.arange(4, dtype=np.int16))
    assert got["arr"].dtype == np.int16
    assert torch.equal(got["nested"][0], torch.zeros(2))
    assert got["nested"][1] == (1, "x")


def test_checkpointer_layout_matches_reference(tmp_path, comm, devices8):
    """The same saves give the same file names as the reference's
    checkpointer, and the markers hold the world size."""
    mesh = build_mesh(inter_size=1, intra_size=8, devices=devices8)
    ours = _cp(comm, tmp_path / "port", keep=2)
    ref = jax_checkpointer("job", jax_comm("naive", mesh=mesh),
                           path=str(tmp_path / "ref"), keep=2)
    for it in (1, 2, 3, 5):
        ours.save({"x": torch.zeros(3)}, it)
        ref.save({"x": jnp.zeros(3)}, it)
    assert sorted(os.listdir(ours.dir)) == sorted(os.listdir(ref.dir))
    assert sorted(os.listdir(ours.dir)) == [
        "done_iter_3.rank0", "done_iter_5.rank0",
        "snapshot_iter_3.rank0", "snapshot_iter_5.rank0"]
    with open(ours._marker(5, 0)) as f:
        assert f.read().split() == ["ok", "1"]


def test_checkpointer_detects_corruption_and_falls_back(tmp_path, comm):
    cp = _cp(comm, tmp_path)
    state = {"w": torch.arange(4.0), "step": 0}
    cp.save(state, iteration=1)
    cp.save({"w": state["w"] + 1, "step": 1}, iteration=2)
    _corrupt_payload(cp._snap(2, comm.rank))
    with pytest.warns(UserWarning, match="corrupt"):
        got, it = cp.maybe_load(state)
    assert it == 1 and torch.equal(got["w"], torch.arange(4.0))
    # Every generation corrupt: refuse to restart from scratch silently.
    _corrupt_payload(cp._snap(1, comm.rank))
    with pytest.warns(UserWarning), pytest.raises(CheckpointCorruptionError):
        cp.maybe_load(state)


def test_checkpointer_detects_truncation(tmp_path, comm):
    cp = _cp(comm, tmp_path)
    cp.save({"w": torch.arange(64.0)}, iteration=3)
    snap = cp._snap(3, comm.rank)
    with open(snap, "rb") as f:
        data = f.read()
    with open(snap, "wb") as f:
        f.write(data[:len(data) // 2])
    with pytest.warns(UserWarning), pytest.raises(CheckpointCorruptionError):
        cp.maybe_load({"w": torch.zeros(64)})


def test_snapshot_header_corruption_and_zero_size_leaves(tmp_path):
    path = str(tmp_path / "snap")
    state = {"empty": np.zeros((0, 4), np.float32), "t0": torch.zeros(0, 2),
             "big": torch.arange(100_000, dtype=torch.float32)}
    _write_snapshot(path, state)
    back = _read_snapshot(path)
    assert back["empty"].shape == (0, 4) and back["t0"].shape == (0, 2)
    assert torch.equal(back["big"], state["big"])
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[len(_MAGIC) + 12 + 5] ^= 0x01            # inside the header
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(CheckpointCorruptionError, match="header"):
        _read_snapshot(path)
    with open(path, "wb") as f:
        f.write(b"not a snapshot at all")
    with pytest.raises(CheckpointCorruptionError, match="not a snapshot"):
        _read_snapshot(path)


@pytest.mark.parametrize("keep,keep_last_n,want", [
    (2, None, [4, 5]), (2, 3, [3, 4, 5]), (1, None, [5])])
def test_checkpointer_rotation(tmp_path, comm, keep, keep_last_n, want):
    cp = _cp(comm, tmp_path, keep=keep, keep_last_n=keep_last_n)
    for it in (1, 2, 3, 4, 5):
        cp.save({"x": torch.zeros(3)}, iteration=it)
    assert cp._consistent_generations() == want
    names = set(os.listdir(cp.dir))
    assert not any(n.startswith("rotated_iter_") for n in names)
    assert {f"snapshot_iter_{i}.rank0" for i in want} <= names


def test_checkpointer_quarantines_corrupt_generation(tmp_path, comm):
    cp = _cp(comm, tmp_path)
    state = {"w": torch.arange(4.0)}
    cp.save(state, iteration=1)
    cp.save({"w": state["w"] + 1}, iteration=2)
    _corrupt_payload(cp._snap(2, comm.rank))
    with pytest.warns(UserWarning, match="quarantin"):
        got, it = cp.maybe_load(state)
    assert it == 1 and torch.equal(got["w"], torch.arange(4.0))
    for path in (cp._snap(2, 0), cp._marker(2, 0)):
        assert not os.path.exists(path)
        assert os.path.exists(path + ".quarantined")
    assert cp._consistent_generations() == [1]
    assert cp._quarantined_generations() == [2]
    with warnings.catch_warnings():       # never re-verified
        warnings.simplefilter("error")
        _, it = cp.maybe_load(state)
    assert it == 1


def test_checkpointer_async_save_copies_now(tmp_path, comm):
    """``block=False`` copies the state at the call: mutating it right
    after does not change the snapshot; the next save or ``wait`` joins."""
    cp = _cp(comm, tmp_path, name="async_job")
    w = torch.arange(8.0)
    cp.save({"w": w, "step": 3}, 1, block=False)
    w.add_(100)
    cp.wait()
    loaded, it = cp.maybe_load({"w": w})
    assert it == 1 and torch.equal(loaded["w"], torch.arange(8.0))
    cp.save({"w": w}, 2, block=False)
    cp.save({"w": w}, 3)
    _, it = cp.maybe_load({"w": w})
    assert it == 3


def test_checkpointer_async_error_surfaces(tmp_path, comm):
    cp = _cp(comm, tmp_path, name="err_job")
    cp.save({"w": torch.ones(2)}, 1)
    shutil.rmtree(cp.dir)                 # the async write must fail loudly
    cp.save({"w": torch.ones(2)}, 2, block=False)
    with pytest.raises(OSError):
        cp.wait()
    cp.wait()                             # the error is raised once


def test_checkpointer_zero3_roundtrip(tmp_path, comm):
    """ZeRO-3's master shard and the rebuilt optimizer's state survive a
    save and load and give the identical next step."""
    rng = np.random.RandomState(0)
    w = torch.nn.Parameter(torch.from_numpy(rng.randn(4, 2)
                                            .astype(np.float32)))
    x = torch.from_numpy(rng.randn(16, 4).astype(np.float32))
    y = torch.from_numpy(rng.randn(16, 2).astype(np.float32))
    opt = create_multi_node_optimizer(torch.optim.Adam([w], lr=1e-2), comm,
                                      zero_stage=3)
    opt.init()
    step = opt.make_train_step(lambda b: ((b[0] @ w - b[1]) ** 2).mean())
    step((x, y))
    cp = _cp(comm, tmp_path, name="z3_job")
    cp.save({"opt": opt.state_dict()}, 1)
    l1 = float(step((x, y)))
    w1 = opt.materialize()[0].detach().clone()
    loaded, it = cp.maybe_load({"opt": opt.state_dict()})
    assert it == 1
    opt.load_state_dict(loaded["opt"])
    l2 = float(step((x, y)))
    assert l1 == l2
    assert torch.equal(opt.materialize()[0], w1)


class _StubRankComm:
    """rank/size/barrier and the object-plane calls the checkpointer makes,
    for two ranks simulated in one process."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    def barrier(self):
        pass

    def allreduce_obj(self, v):
        return v * self.size

    def allgather_obj(self, v):
        return [v] * self.size


def test_checkpointer_async_cleanup_no_leak(tmp_path):
    """Own-rank async cleanup still rotates every rank's files: rotation is
    decided by tombstone while the generation is consistent."""
    cps = [create_multi_node_checkpointer("leak_job", _StubRankComm(r, 2),
                                          path=str(tmp_path), keep=1)
           for r in (0, 1)]
    for it in (1, 2, 3):
        for cp in cps:
            cp.save({"x": torch.zeros(3)}, iteration=it, block=False)
        for cp in cps:
            cp.wait()
    for cp in cps:
        cp._cleanup(ranks=(cp.comm.rank,))
    names = set(os.listdir(tmp_path / "leak_job"))
    for it in (1, 2):
        for r in (0, 1):
            assert f"snapshot_iter_{it}.rank{r}" not in names, names
            assert f"done_iter_{it}.rank{r}" not in names, names
        assert f"rotated_iter_{it}" not in names, names
    for r in (0, 1):
        assert f"snapshot_iter_3.rank{r}" in names
    assert cps[1].maybe_load({"x": torch.zeros(3)})[1] == 3


def _spawn(kind, size, tmp_path, **args):
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
            assert p.exitcode == 0, f"rank exited {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(size)]


def test_checkpointer_two_ranks(tmp_path):
    """A generation corrupt on rank 1 only is skipped by both ranks (they
    vote), with a warning on each; ZeRO-3 saves each rank's shard and the
    reloaded shards give the same next step."""
    res = _spawn("ckpt", 2, tmp_path, path=str(tmp_path / "ck"))
    for r, out in enumerate(res):
        assert out["it"] == 1 and out["warned"]
        assert out["w"] == [float(v + r) for v in range(4)]
        assert out["z3_shard_numel"] == 3          # 5 parameters over 2
        assert out["z3_resumed_loss_equal"]
    names = set(os.listdir(tmp_path / "ck" / "z3"))
    assert {"snapshot_iter_1.rank0", "snapshot_iter_1.rank1"} <= names


# -- except hook -------------------------------------------------------------

def _env():
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def test_global_except_hook_exits_loudly(tmp_path):
    post = tmp_path / "postmortem.jsonl"
    code = ("import chainermn_tpu_torch.global_except_hook as h\n"
            "h.add_hook()\n"
            "raise RuntimeError('boom')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60,
                          env=dict(_env(),
                                   CHAINERMN_TPU_POSTMORTEM_FILE=str(post)))
    assert proc.returncode == 13
    assert "uncaught exception on rank -1" in proc.stderr
    assert "boom" in proc.stderr
    row = json.loads(post.read_text())
    assert row["event"] == "crash" and "boom" in row["exc"]


def test_global_except_hook_install_remove():
    import chainermn_tpu_torch.global_except_hook as h

    h.add_hook()
    try:
        assert sys.excepthook is h._handle_uncaught
    finally:
        h.remove_hook()
    assert sys.excepthook is sys.__excepthook__


def test_global_except_hook_ends_both_ranks(tmp_path):
    """Rank 1 raises; its hook ends it at once, and rank 0, waiting in a
    barrier, fails too (its hook turns the error into an exit) instead of
    hanging: both exit non-zero within the limit."""
    init = tmp_path / "rendezvous"
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, WORKER, "hook", str(r), "2",
                               str(init)], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert time.monotonic() - t0 < JOIN_TIMEOUT_S
    assert [p.returncode for p in procs] == [13, 13], outs
    assert "rank 1 fails on purpose" in outs[1][1]
    assert "uncaught exception on rank 1/2" in outs[1][1]
    assert "uncaught exception on rank 0/2" in outs[0][1]
    assert "passed a barrier" not in outs[0][0]


# -- iterators ---------------------------------------------------------------

def test_multi_node_and_synchronized_iterators_single_process(comm):
    assert list(create_multi_node_iterator([1, 2, 3], comm)) == [1, 2, 3]
    assert list(create_synchronized_iterator([5, 6], comm)) == [5, 6]


def test_prefetch_preserves_order_and_content():
    batches = [(np.full((4, 3), i, np.float32), np.full((4,), i, np.int32),
                {"t": torch.full((2,), float(i))})
               for i in range(10)]
    out = list(create_prefetch_iterator(iter(batches), size=3,
                                        device="cpu"))
    assert len(out) == 10
    for i, (x, y, d) in enumerate(out):
        assert isinstance(x, torch.Tensor) and x.dtype == torch.float32
        np.testing.assert_array_equal(x.numpy(), batches[i][0])
        np.testing.assert_array_equal(y.numpy(), batches[i][1])
        assert torch.equal(d["t"], batches[i][2]["t"])


def test_prefetch_overlaps_producer_work():
    produced = []

    def gen():
        for i in range(5):
            produced.append(i)
            yield np.full((2,), i, np.float32)

    it = create_prefetch_iterator(gen(), size=4, device="cpu")
    first = next(it)
    time.sleep(0.5)                       # the producer runs ahead
    assert len(produced) >= 4
    assert len(list(it)) == 4
    np.testing.assert_array_equal(first.numpy(), np.zeros(2))


def test_prefetch_propagates_producer_exception_and_bad_size():
    def gen():
        yield np.zeros((2,), np.float32)
        raise RuntimeError("producer exploded")

    it = create_prefetch_iterator(gen(), size=2, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="producer exploded"):
        next(it)
    with pytest.raises(ValueError, match="size"):
        create_prefetch_iterator(iter([]), size=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_prefetch_iterator(iter([]))


def test_prefetch_shutdown_on_abandon():
    n_before = threading.active_count()

    def gen():
        for i in range(100):
            yield np.full((2,), i, np.float32)

    it = create_prefetch_iterator(gen(), size=2, device="cpu")
    next(it)
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= n_before


@pytest.fixture(scope="module")
def loader_ds():
    return SyntheticImageDataset(n=64, shape=(8, 8))


def test_mp_loader_matches_batch_iterator_and_reshuffles(loader_ds):
    """Same (shuffle, seed, drop_last): byte-identical batches in the same
    order as ``batch_iterator``, across passes and after an abandoned
    pass; ``repeat`` reshuffles with seed + epoch; ``copy=False`` views are
    exact within their window."""
    ref = list(batch_iterator(loader_ds, 16, shuffle=True, seed=3))
    with MultiprocessBatchLoader(loader_ds, 16, n_workers=2, shuffle=True,
                                 seed=3) as ld:
        assert len(ld) == len(ref) == 4
        for _ in range(2):
            got = list(ld)
            assert len(got) == 4
            for (rx, ry), (gx, gy) in zip(ref, got):
                assert rx.tobytes() == gx.tobytes()
                assert ry.tobytes() == gy.tobytes()
            it = iter(ld)
            next(it)
            del it
    with MultiprocessBatchLoader(loader_ds, 16, n_workers=2, repeat=True,
                                 copy=False, seed=3) as ld:
        it = iter(ld)
        for k in range(9):                # epoch boundary at k = 4
            x, y = next(it)
            epoch, j = divmod(k, 4)
            idx = np.random.RandomState(3 + epoch).permutation(64)[
                j * 16:(j + 1) * 16]
            np.testing.assert_array_equal(
                x, np.stack([loader_ds[int(i)][0] for i in idx]))
            np.testing.assert_array_equal(
                y, np.stack([loader_ds[int(i)][1] for i in idx]))


def test_mp_loader_worker_exception_and_clean_shutdown(loader_ds):
    bad = ExplodingDataset(loader_ds, explode_at=7)
    with MultiprocessBatchLoader(bad, 16, n_workers=2, shuffle=False) as ld:
        with pytest.raises(RuntimeError, match="synthetic item failure"):
            list(ld)
    ld = MultiprocessBatchLoader(loader_ds, 16, n_workers=2)
    procs = list(ld._procs)
    it = iter(ld)
    next(it)
    ld.close()
    deadline = time.time() + 10
    while any(p.is_alive() for p in procs) and time.time() < deadline:
        time.sleep(0.05)
    assert not any(p.is_alive() for p in procs)
    assert ld._shms == []
    with pytest.raises(RuntimeError, match="closed"):
        iter(ld)


def test_mp_loader_len_and_empty_guards(loader_ds):
    with MultiprocessBatchLoader(loader_ds, 16, n_workers=1,
                                 repeat=True) as ld:
        with pytest.raises(TypeError, match="infinite"):
            len(ld)
        assert bool(ld)
    with pytest.raises(ValueError, match="empty"):
        MultiprocessBatchLoader([], 4, drop_last=False)
    with pytest.raises(ValueError, match="smaller than one batch"):
        MultiprocessBatchLoader(loader_ds, 100)


def test_reference_snapshots_are_refused(tmp_path):
    """The port reads none of the JAX package's snapshots (weights cross
    through ``convert.py``): one fails loudly instead of loading wrong."""
    from chainermn_tpu.extensions.checkpoint import (
        _write_snapshot as jax_write_snapshot)

    path = str(tmp_path / "snap")
    jax_write_snapshot(path, {"w": np.arange(4.0, dtype=np.float32)})
    with pytest.raises(CheckpointCorruptionError, match="not a snapshot"):
        _read_snapshot(path)
