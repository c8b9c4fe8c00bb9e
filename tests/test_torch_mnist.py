"""The port's MNIST slice against the JAX package: the MLP converted from
flax, the synthetic datasets and ``batch_iterator`` byte for byte, the
example's pipeline at small width step by step (stage 0 and ZeRO-3), and
the port's example end to end on the CPU (training, checkpoint resume,
the host-plane flags it refuses).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from chainermn_tpu.communicators import build_mesh
from chainermn_tpu.communicators import create_communicator as jax_comm
from chainermn_tpu.extensions import Evaluator as JaxEvaluator
from chainermn_tpu.models.mlp import MLP as FlaxMLP
from chainermn_tpu.optimizers import create_multi_node_optimizer as jax_mno
from chainermn_tpu_torch import (create_communicator,
                                 create_multi_node_optimizer)
from chainermn_tpu_torch.convert import (mlp_flax_to_state_dict,
                                         mlp_state_dict_to_flax)
from chainermn_tpu_torch.extensions import Evaluator
from chainermn_tpu_torch.models import MLP

jax_toy = importlib.import_module("chainermn_tpu.datasets.toy")
port_toy = importlib.import_module("chainermn_tpu_torch.datasets.toy")
jax_scatter = importlib.import_module("chainermn_tpu.datasets.scatter_dataset")
port_scatter = importlib.import_module(
    "chainermn_tpu_torch.datasets.scatter_dataset")
train_mnist = importlib.import_module(
    "chainermn_tpu_torch.examples.train_mnist")

UNIT, BATCH, N_TRAIN, N_VAL = 32, 64, 256, 64


def flax_params(n_units=UNIT, seed=0):
    return FlaxMLP(n_units=n_units, n_out=10).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28)))


def port_mlp(params, n_units=UNIT):
    model = MLP(n_units=n_units, device="cpu")
    model.load_state_dict(mlp_flax_to_state_dict(params))
    return model


def test_mlp_converted_from_flax_gives_the_same_logits():
    params = flax_params()
    x = np.random.RandomState(0).randn(8, 28, 28).astype(np.float32)
    want = np.asarray(FlaxMLP(n_units=UNIT, n_out=10).apply(params, x))
    got = port_mlp(params)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # The round trip is a pure layout move.
    back = mlp_state_dict_to_flax(mlp_flax_to_state_dict(params))
    for k, layer in back.items():
        for name, arr in layer.items():
            np.testing.assert_array_equal(
                arr, np.asarray(params["params"][k][name]))


def test_mlp_shapes_and_seeded_init():
    a, b = MLP(n_units=16, device="cpu", seed=3), MLP(n_units=16,
                                                      device="cpu", seed=3)
    assert [tuple(p.shape) for p in a.parameters()] == [
        (16, 784), (16,), (16, 16), (16,), (10, 16), (10,)]
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    assert a(torch.zeros(2, 28, 28)).shape == (2, 10)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MLP(n_units=4)


@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_datasets_equal_reference(seed):
    for cls, kw in (("SyntheticImageDataset", dict(n=128)),
                    ("SyntheticImageDataset", dict(n=32, flat=True)),
                    ("SyntheticSeqDataset", dict(n=64))):
        got = getattr(port_toy, cls)(seed=seed, **kw)
        want = getattr(jax_toy, cls)(seed=seed, **kw)
        assert len(got) == len(want)
        for i in (0, 5, len(got) - 1):
            for a, b in zip(got[i], want[i]):
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
                assert np.asarray(a).dtype == np.asarray(b).dtype


class _Comm:
    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    def bcast_obj(self, obj, root=0):
        return obj


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False),
                                               (True, False)])
def test_batch_iterator_equals_reference_byte_for_byte(shuffle, drop_last):
    """Over a scattered shard, as the example draws it: the same batches,
    the same bytes, the same order."""
    for r in range(2):
        ds_p = port_scatter.scatter_dataset(
            port_toy.SyntheticImageDataset(n=100, seed=0), _Comm(r, 2),
            shuffle=True, seed=42)
        ds_j = jax_scatter.scatter_dataset(
            jax_toy.SyntheticImageDataset(n=100, seed=0), _Comm(r, 2),
            shuffle=True, seed=42)
        got = list(port_toy.batch_iterator(ds_p, 16, shuffle=shuffle,
                                           seed=7, drop_last=drop_last))
        want = list(jax_toy.batch_iterator(ds_j, 16, shuffle=shuffle,
                                           seed=7, drop_last=drop_last))
        assert len(got) == len(want) == (3 if drop_last else 4)
        for gb, wb in zip(got, want):
            for a, b in zip(gb, wb):
                assert a.shape == b.shape and a.dtype == b.dtype
                assert a.tobytes() == b.tobytes()


def _data():
    train = port_toy.SyntheticImageDataset(n=N_TRAIN, seed=0)
    val = port_toy.SyntheticImageDataset(n=N_VAL, seed=1)
    comm = _Comm(0, 1)
    return (port_scatter.scatter_dataset(train, comm, shuffle=True, seed=42),
            port_scatter.scatter_dataset(val, comm))


def jax_pipeline(devices8, stage):
    """The reference example's loop at small width: per-step losses and
    the epoch's val metrics."""
    mesh = build_mesh(inter_size=1, intra_size=8, devices=devices8)
    comm = jax_comm("xla_ici", mesh=mesh)
    model = FlaxMLP(n_units=UNIT, n_out=10)
    params = flax_params()

    def loss_fn(p, batch):
        x, y = batch
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply(p, x), y).mean()

    def metric_fn(p, batch):
        x, y = batch
        logits = model.apply(p, x)
        return {"val/loss": optax.softmax_cross_entropy_with_integer_labels(
                    logits, y).mean(),
                "val/accuracy": (logits.argmax(-1) == y).mean()}

    opt = jax_mno(optax.adam(1e-3), comm, zero_stage=stage)
    state = opt.init(params)
    if stage == 3:
        params = opt.shard_params(params)
    step = opt.make_train_step(loss_fn, donate=False)
    train, val = _data()
    losses = []
    for batch in jax_toy.batch_iterator(train, BATCH, seed=0):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    if stage == 3:
        params = opt.materialize(params)
    metrics = JaxEvaluator(metric_fn, comm).evaluate(
        params, jax_toy.batch_iterator(val, BATCH, shuffle=False))
    return losses, metrics


def port_pipeline(stage):
    comm = create_communicator("xla_ici", device="cpu")
    model = port_mlp(flax_params())
    opt = create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3), comm,
        zero_stage=stage)
    opt.init()
    step = opt.make_train_step(
        lambda b: F.cross_entropy(model(b[0]), b[1]), local_batch=True)
    train, val = _data()

    def tensors(batch):
        return torch.from_numpy(batch[0]), torch.from_numpy(batch[1]).long()

    losses = [float(step(tensors(b)))
              for b in port_toy.batch_iterator(train, BATCH, seed=0)]
    if stage == 3:
        opt.materialize()

    def metric_fn(m, batch):
        logits = m(batch[0])
        return {"val/loss": F.cross_entropy(logits, batch[1]),
                "val/accuracy": (logits.argmax(-1) == batch[1]).float()
                .mean()}

    metrics = Evaluator(metric_fn, comm).evaluate(
        model, (tensors(b) for b in port_toy.batch_iterator(
            val, BATCH, shuffle=False)))
    return losses, metrics


@pytest.mark.parametrize("stage", [0, 3])
def test_pipeline_matches_reference_step_by_step(devices8, stage):
    jl, jm = jax_pipeline(devices8, stage)
    pl, pm = port_pipeline(stage)
    assert len(pl) == len(jl) == N_TRAIN // BATCH
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert set(pm) == set(jm)
    assert pm["val/accuracy"] == jm["val/accuracy"]
    np.testing.assert_allclose(pm["val/loss"], jm["val/loss"], rtol=1e-5)


SMALL = ["--device", "cpu", "--communicator", "naive", "--unit", "32",
         "--batchsize", "64", "--train-size", "256", "--val-size", "64"]


def test_example_main_end_to_end(capsys):
    out = train_mnist.main(SMALL + ["--epochs", "2"])
    assert out["metrics"]["val/accuracy"] >= 0.9
    assert out["gstep"] == 8 and out["wire"] is None
    assert len(out["epoch_mean_losses"]) == 2
    assert out["epoch_mean_losses"][1] < out["epoch_mean_losses"][0]
    printed = capsys.readouterr().out
    assert f"final gstep 8 params_digest {out['params_digest']}" in printed
    # ZeRO-3 and stage 0 do the same arithmetic at one rank.
    z3 = train_mnist.main(SMALL + ["--epochs", "2", "--zero-stage", "3"])
    assert z3["params_digest"] == out["params_digest"]
    assert z3["epoch_mean_losses"] == out["epoch_mean_losses"]


def test_example_resumes_from_its_checkpoint(tmp_path, capsys):
    """Stopped after one epoch and rerun for two, the run resumes from its
    newest generation and ends with the uninterrupted run's digest."""
    import chainermn_tpu_torch.global_except_hook as hook

    whole = train_mnist.main(SMALL + ["--epochs", "2"])
    ck = SMALL + ["--checkpoint-dir", str(tmp_path), "--checkpoint-every",
                  "3"]
    try:
        first = train_mnist.main(ck + ["--epochs", "1"])
        second = train_mnist.main(ck + ["--epochs", "2"])
    finally:
        hook.remove_hook()
    assert first["resumed_from"] is None and first["gstep"] == 4
    assert second["resumed_from"] == 3
    assert "resumed from iteration 3 (epoch 0, step 3)" in \
        capsys.readouterr().out
    assert second["params_digest"] == whole["params_digest"]
    assert second["gstep"] == whole["gstep"] == 8


def test_example_step_log_and_elastic_outside_a_supervisor(tmp_path):
    """``--step-log`` writes a step row a step (its loss and the
    ``train_step`` span) and an eval row an epoch, which ``tools.obs``
    reads; ``--elastic`` outside the supervisor is a plain run: the same
    parameters."""
    from chainermn_tpu_torch.observability.step_log import read_records
    from chainermn_tpu_torch.tools.obs import summarize

    small = SMALL + ["--epochs", "2"]
    plain = train_mnist.main(small)
    log = tmp_path / "steps.jsonl"
    out = train_mnist.main(small + ["--elastic", "--step-log", str(log)])
    assert out["params_digest"] == plain["params_digest"]
    rows = read_records(str(log))
    steps = [r for r in rows if r["event"] == "step"]
    assert [r["step"] for r in steps] == list(range(out["gstep"]))
    assert all("train_step" in r["spans"] and r["items"] == 64
               for r in steps)
    assert len([r for r in rows if r["event"] == "eval"]) == 2
    assert summarize(rows)["steps"]["count"] == out["gstep"]
    assert out["telemetry"]["counters"]["train_step_calls"] == out["gstep"]


def test_example_int8_wire_converges():
    out = train_mnist.main(SMALL + ["--epochs", "2", "--comm-dtype", "int8"])
    assert out["wire"] == "int8"
    assert out["metrics"]["val/accuracy"] >= 0.9
    fp8 = train_mnist.main(SMALL + ["--epochs", "2", "--comm-dtype", "fp8"])
    assert fp8["wire"] == "int8"           # gloo: the int8 fallback
    assert fp8["params_digest"] == out["params_digest"]


def test_example_at_two_ranks(tmp_path):
    """``main`` on two gloo ranks: both end with the same parameters; at
    two ranks ZeRO-3 and the overlap-off run equal stage 0 bit for bit
    (a sum of two values does not depend on its order); the int8 wire
    converges; a run stopped after one epoch resumes and ends with the
    uninterrupted run's digest."""
    res = _spawn_pair("mnist", tmp_path, path=str(tmp_path / "ck"))
    for r, out in enumerate(res):
        for name, run in out.items():
            assert run["digest"] == res[0][name]["digest"], (r, name)
            assert run["gstep"] == (4 if name == "stopped" else 12), name
            if name != "stopped":                   # one epoch only
                assert run["accuracy"] >= 0.9, name
        assert out["zero3"]["digest"] == out["zero0"]["digest"]
        assert out["zero3"]["losses"] == out["zero0"]["losses"]
        assert out["overlap_off"]["digest"] == out["zero0"]["digest"]
        assert out["int8"]["digest"] != out["zero0"]["digest"]
        assert out["stopped"]["resumed_from"] is None
        assert out["resumed"]["resumed_from"] == 3
        assert out["resumed"]["digest"] == out["zero0"]["digest"]
    assert "global batch 64 over 2 ranks" in res[0]["zero0"]["printed"]
    assert res[1]["zero0"]["printed"] == ""          # rank 0 logs


def _spawn_pair(kind, tmp_path, **args):
    import json
    import multiprocessing as mp

    import _torch_dp_worker as worker

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker.run,
                         args=(kind, r, 2, str(tmp_path / "rendezvous"),
                               str(tmp_path), args)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(60)
            assert p.exitcode == 0, f"rank exited {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(2)]


@pytest.mark.parametrize("n,bs", [(100, 16), (96, 16), (1, 8), (0, 4)])
def test_get_n_iterations_for_one_epoch_equals_reference(n, bs):
    from chainermn_tpu.datasets import get_n_iterations_for_one_epoch as want
    from chainermn_tpu_torch.datasets import get_n_iterations_for_one_epoch

    ds = port_toy.SyntheticSeqDataset(n=n, src_len=2, tgt_len=2)
    assert get_n_iterations_for_one_epoch(ds, bs) == want(ds, bs) \
        == -(-n // bs)
