"""The port's ImageNet slice against the JAX package: ``linear_schedule``,
SGD and ``LARS`` against optax on random tensors; ``MultiNodeOptimizer
.make_train_step_with_state`` against the reference's, step by step, at
1, 2 and 4 ranks (gloo workers from ``_torch_dp_worker.py``) against
meshes of as many devices, at stage 0, overlap off, double buffering,
ZeRO-1 and ZeRO-3 and LARS under ZeRO-1 and ZeRO-3, every parameter
value; and the port's example end to end on the CPU (training, every
architecture, checkpoint resume, the host-plane flags it refuses).

Tolerances: optimizer updates rtol 1e-6 (one fp32 expression each, the
same order of operations, fused differently); the 4-step training
comparison rtol 1e-4 on losses, parameters and BatchNorm buffers, with
atol 1e-6 for values near zero (fp32 convolutions and reductions in
another summation order, compounded over four steps).
"""

import json
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_dp_worker as worker
from chainermn_tpu.communicators import build_mesh
from chainermn_tpu.communicators import create_communicator as jax_comm
from chainermn_tpu.models.resnet import BottleneckBlock as FlaxBottleneck
from chainermn_tpu.models.resnet import ResNet as FlaxResNet
from chainermn_tpu.optimizers import create_multi_node_optimizer as jax_mno
from chainermn_tpu_torch import create_communicator
from chainermn_tpu_torch.convert import (convnet_flax_to_state_dict,
                                         convnet_state_dict_to_flax)
from chainermn_tpu_torch.examples import train_imagenet
from chainermn_tpu_torch.optim import LARS, linear_schedule

UPDATE = dict(rtol=1e-6, atol=1e-9)
TRAIN = dict(rtol=1e-4, atol=1e-6)


# -- optimizers against optax ---------------------------------------------

@pytest.mark.parametrize("init,end,steps", [(0.0, 0.1, 5), (0.2, 0.05, 3),
                                            (0.3, 0.0, 0)])
def test_linear_schedule_matches_optax(init, end, steps):
    ours = linear_schedule(init, end, steps)
    want = optax.linear_schedule(init, end, steps)
    for count in range(steps + 4):
        np.testing.assert_allclose(ours(count), float(want(count)), **UPDATE)
    assert ours(0) == init


def _tensors(seed, zero_first=False):
    """Three parameter-like tensors and four steps of gradients; the
    first parameter is all zeros when asked (a zero-initialised BatchNorm
    scale: LARS's trust ratio is 1 there)."""
    rng = np.random.RandomState(seed)
    params = [rng.randn(4, 3).astype(np.float32), rng.randn(7).astype(
        np.float32), rng.randn(2, 2, 3).astype(np.float32)]
    if zero_first:
        params[0][:] = 0
    grads = [[rng.randn(*p.shape).astype(np.float32) for p in params]
             for _ in range(4)]
    grads[2][1][:] = 0          # a zero update: ratio 1 as well
    return params, grads


def _optax_run(tx, params, grads):
    params = [jnp.asarray(p) for p in params]
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, updates)
    return [np.asarray(p) for p in params]


def _torch_run(make, schedule, params, grads):
    ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = make(ps)
    for count, g in enumerate(grads):
        for group in opt.param_groups:
            group["lr"] = schedule(count)
        for p, x in zip(ps, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    return [p.detach().numpy() for p in ps]


@pytest.mark.parametrize("zero_first", [False, True])
def test_sgd_and_lars_match_optax(zero_first):
    params, grads = _tensors(3, zero_first)
    sched = optax.linear_schedule(0.0, 0.1, 3)
    ours = linear_schedule(0.0, 0.1, 3)
    cases = {
        "sgd": (optax.sgd(sched, momentum=0.9),
                lambda ps: torch.optim.SGD(ps, lr=0.0, momentum=0.9)),
        "lars": (optax.lars(sched, momentum=0.9, weight_decay=1e-4),
                 lambda ps: LARS(ps, momentum=0.9, weight_decay=1e-4)),
    }
    for name, (tx, make) in cases.items():
        want = _optax_run(tx, params, grads)
        got = _torch_run(make, ours, params, grads)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **UPDATE, err_msg=name)
        # The first update has lr 0: nothing moves, only the trace.
        assert not all(np.array_equal(g, p) for g, p in zip(got, params))


# -- make_train_step_with_state against the reference ---------------------

def _flax_variables():
    """The reference's variables from the port's seeded model, so both
    sides start from the same weights."""
    return jax.tree_util.tree_map(
        jnp.asarray,
        convnet_state_dict_to_flax(worker.state_model().state_dict()))


def reference_run(variant, n):
    """The reference's ``make_train_step_with_state`` on an ``n``-device
    mesh: losses and the final state as a port ``state_dict``."""
    cfg = {"stage": 0, "overlap": None, "double_buffering": False,
           "optimizer": "sgd", **worker.STATE_VARIANTS[variant]}
    comm = jax_comm("xla_ici", mesh=build_mesh(
        inter_size=1, intra_size=n, devices=jax.devices()[:n]))
    sched = optax.linear_schedule(0.0, worker.STATE_LR, worker.STATE_WARMUP)
    tx = (optax.lars(sched, momentum=0.9, weight_decay=1e-4)
          if cfg["optimizer"] == "lars" else optax.sgd(sched, momentum=0.9))
    opt = jax_mno(tx, comm, double_buffering=cfg["double_buffering"],
                  zero_stage=cfg["stage"])
    model = FlaxResNet(block_cls=FlaxBottleneck, dtype=jnp.float32,
                       **worker.STATE_NET)

    def loss_fn(params, batch_stats, batch):
        x, y = batch
        logits, upd = model.apply(
            {"params": params, "batch_stats": batch_stats}, x, train=True,
            mutable=["batch_stats"])
        return (optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean(), upd["batch_stats"])

    variables = _flax_variables()
    params, stats = variables["params"], variables["batch_stats"]
    state = opt.init(params)
    if cfg["stage"] == 3:
        params = opt.shard_params(params)
    step = opt.make_train_step_with_state(loss_fn, donate=False,
                                          overlap=cfg["overlap"])
    batch = worker.state_batch()
    losses = []
    for _ in range(worker.STATE_STEPS):
        params, state, stats, loss = step(params, state, stats, batch)
        losses.append(float(loss))
    if cfg["stage"] == 3:
        params = opt.materialize(params)
    sd = convnet_flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": params, "batch_stats": stats}))
    return losses, {k: v.numpy().ravel() for k, v in sd.items()}


def _assert_matches(got, want_losses, want_state, tag):
    np.testing.assert_allclose(got["losses"], want_losses, **TRAIN,
                               err_msg=tag)
    assert set(got["state"]) == set(want_state), tag
    for k, v in want_state.items():
        np.testing.assert_allclose(got["state"][k], v, **TRAIN,
                                   err_msg=f"{tag} {k}")


@pytest.mark.parametrize("variant", list(worker.STATE_VARIANTS))
def test_with_state_step_matches_reference_one_rank(variant):
    got = worker.state_run(variant,
                           create_communicator("xla_ici", device="cpu"))
    want_losses, want_state = reference_run(variant, 1)
    _assert_matches(got, want_losses, want_state, variant)
    # Double buffering's reduce-only first step is not an update.
    skipped = 1 if variant == "double_buffering" else 0
    assert got["updates"] == worker.STATE_STEPS - skipped


ACROSS = {2: ("stage0", "double_buffering", "zero3", "lars_zero1",
              "lars_zero3"),
          4: tuple(worker.STATE_VARIANTS)}
# LARS under ZeRO takes its trust ratio per flat shard.  The workers hand
# the optimizer its parameters in the reference's leaf order and the flat
# buffer holds each in flax's layout (``convert.flax_flat_layout``), so
# every shard, a conv kernel that straddles two shards included, holds the
# reference shard's elements and every parameter value is held to it.


@pytest.mark.parametrize("size", list(ACROSS))
def test_with_state_step_matches_reference_across_ranks(tmp_path, size):
    """Each rank computes on its slice of the global batch with its local
    batch statistics; after every step the ranks hold the same
    parameters and the mean of their BatchNorm buffers, as the
    reference's replicas do."""
    res = _spawn(size, tmp_path, variants=list(ACROSS[size]))
    for variant in ACROSS[size]:
        want_losses, want_state = reference_run(variant, size)
        for r, out in enumerate(res):
            assert out[variant]["state"] == res[0][variant]["state"], \
                (variant, r)
            _assert_matches(out[variant], want_losses, want_state,
                            f"{variant} rank {r}")


def _spawn(size, tmp_path, **args):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker.run,
                         args=("state", r, size, str(tmp_path / "rdv"),
                               str(tmp_path), args)) for r in range(size)]
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
            for r in range(size)]


# -- the example on the CPU ------------------------------------------------

SMALL = ["--device", "cpu", "--communicator", "naive", "--batchsize", "16",
         "--image-size", "32", "--num-classes", "10", "--train-size", "64",
         "--val-size", "32", "--steps", "2", "--warmup-steps", "2"]


@pytest.mark.parametrize("extra", [
    ["--arch", "resnet18"],
    ["--arch", "resnet18", "--optimizer", "lars", "--prefetch", "0"],
    ["--arch", "nin", "--image-size", "64"],
], ids=["resnet18", "resnet18-lars-noprefetch", "nin-dropout"])
def test_example_main_end_to_end(capsys, extra):
    out = train_imagenet.main(SMALL + extra + ["--epochs", "2"])
    assert out["gstep"] == 4
    losses = [x for epoch in out["step_losses"] for x in epoch]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert set(out["metrics"]) == {"val/loss", "val/accuracy"}
    printed = capsys.readouterr().out
    assert printed.strip().splitlines()[-1] == \
        f"final gstep 4 params_digest {out['params_digest']}"


def test_example_resumes_from_its_checkpoint(tmp_path, capsys):
    """Stopped after one epoch (its last step saved) and rerun for two,
    the run loads exactly what was saved (parameters, BatchNorm buffers,
    momentum, the schedule's count), resumes and ends with the
    uninterrupted run's digest."""
    import chainermn_tpu_torch.global_except_hook as hook

    base = SMALL + ["--arch", "resnet18"]
    whole = train_imagenet.main(base + ["--epochs", "2"])
    ck = base + ["--checkpoint-dir", str(tmp_path), "--checkpoint-every",
                 "2"]
    try:
        first = train_imagenet.main(ck + ["--epochs", "1"])
        second = train_imagenet.main(ck + ["--epochs", "2"])
    finally:
        hook.remove_hook()
    assert first["resumed_from"] is None and first["gstep"] == 2
    assert second["resumed_from"] == 2
    assert "resumed from iteration 2 (epoch 0, step 2)" in \
        capsys.readouterr().out
    # The state the relaunch holds is byte for byte the saved generation.
    assert second["loaded_digest"] == first["saved_digests"][2]
    assert set(first["saved_digests"]) == {2}
    assert set(second["saved_digests"]) == {4}
    assert second["params_digest"] == whole["params_digest"]
    assert second["gstep"] == whole["gstep"] == 4
    assert second["step_losses"][-1] == whole["step_losses"][-1]


def test_example_step_log_and_elastic_outside_a_supervisor(tmp_path):
    """``--step-log`` records each step's loss (read back once a step) and
    an eval row an epoch; ``--elastic`` outside the supervisor is a plain
    run with the same losses and parameters."""
    from chainermn_tpu_torch.observability.step_log import read_records

    small = SMALL + ["--arch", "resnet18", "--epochs", "2"]
    plain = train_imagenet.main(small)
    log = tmp_path / "steps.jsonl"
    out = train_imagenet.main(small + ["--elastic", "--step-log", str(log)])
    assert out["params_digest"] == plain["params_digest"]
    rows = read_records(str(log))
    steps = [r for r in rows if r["event"] == "step"]
    assert [r["step"] for r in steps] == list(range(out["gstep"]))
    assert [r["loss"] for r in steps] == \
        [x for epoch in out["step_losses"] for x in epoch]
    assert len([r for r in rows if r["event"] == "eval"]) == 2
