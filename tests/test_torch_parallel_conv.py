"""The port's parallel-convolution example against the reference's.

The reference's ``examples/parallel_convolution/train_parallel_conv.py``
runs as it is, its ``main(argv)`` at the smoke's flags
(``tests/test_examples.py``: 16 global channels, batch 8, 32 images, 4
steps) on a mesh of 1, 2 and 4 devices, recording its initial per-device
channel shards (``optax.adam``'s ``init``), each step's per-device loss
(its jitted step's output) and its final shards (``optax.apply_updates``).
The port's example (``ShardedConvNet`` and its step, one process a rank
on gloo, workers from ``_torch_pp_worker.py``) starts from those shards,
converted by ``convert.parallel_conv_flax_to_state_dict``, and takes the
same steps on the same replicated global batches.  Each rank's losses
must agree with its device's within 1e-4 relative, and its final shards
within 1e-4 relative (5e-5 absolute: Adam normalises each element's step
of lr 1e-3, so an element whose gradient cancels to its rounding error
may step by a few percent differently).  Then ``main(argv)`` end to end
at the smoke's flags on every rank count.
"""

import contextlib
import importlib.util
import io
import pathlib

import jax
import numpy as np
import optax
import pytest
import torch

import _torch_pp_worker as worker
import chainermn_tpu
from chainermn_tpu.communicators import build_mesh
from chainermn_tpu_torch.convert import parallel_conv_flax_to_state_dict

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL, STEP_ATOL = 1e-4, 5e-5


def run_reference(n, argv):
    """The reference example's ``main(argv)`` on ``n`` devices: its
    initial and final stacked parameters and each step's per-device
    losses."""
    path = REPO / "examples" / "parallel_convolution" / "train_parallel_conv.py"
    spec = importlib.util.spec_from_file_location("reference_pconv", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    real = (chainermn_tpu.create_communicator, jax.jit, optax.adam,
            optax.apply_updates)
    rec = {"init": None, "params": [], "losses": []}

    def create_communicator(name, **kw):
        mesh = build_mesh(inter_size=1, intra_size=n,
                          devices=jax.devices()[:n])
        return real[0](name, mesh=mesh, **kw)

    def jit(fn, *a, **kw):
        jitted = real[1](fn, *a, **kw)

        def call(*args):
            out = jitted(*args)
            if isinstance(out, tuple) and len(out) == 2 and \
                    getattr(out[1], "shape", None) == (n,):
                rec["losses"].append(np.asarray(out[1]).tolist())
            return out

        return call

    def adam(*a, **kw):
        inner = real[2](*a, **kw)

        def init(params):
            rec["init"] = jax.tree_util.tree_map(np.asarray, params)
            return inner.init(params)

        return optax.GradientTransformation(init, inner.update)

    def apply_updates(params, updates):
        out = real[3](params, updates)
        rec["params"].append(out)
        return out

    (chainermn_tpu.create_communicator, jax.jit, optax.adam,
     optax.apply_updates) = create_communicator, jit, adam, apply_updates
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            last = ref.main(argv)
    finally:
        (chainermn_tpu.create_communicator, jax.jit, optax.adam,
         optax.apply_updates) = real
    return {"init": rec["init"], "losses": rec["losses"], "last": last,
            "final": jax.tree_util.tree_map(np.asarray, rec["params"][-1])}


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda n: f"{n}ranks")
def runs(request, tmp_path_factory):
    n = request.param
    tmp = tmp_path_factory.mktemp(f"pconv{n}")
    ref = run_reference(n, worker.PCONV_SMOKE)
    arrays = {f"r{d}/{k}": v.numpy() for d in range(n) for k, v in
              parallel_conv_flax_to_state_dict(ref["init"], d).items()}
    init = str(tmp / "init.npz")
    np.savez(init, **arrays)
    if n == 1:
        from chainermn_tpu_torch import create_communicator
        from chainermn_tpu_torch.examples import train_parallel_conv as ex

        comm = create_communicator("naive", device="cpu")
        out = worker.pconv_run(comm, init)
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            out["main_loss"] = ex.main(worker.PCONV_SMOKE + ["--device",
                                                             "cpu"])
        out["printed"] = printed.getvalue()
        port = [out]
    else:
        port = worker.spawn("pconv", n, tmp, init=init)
    return n, ref, port


def test_net_and_step_match_reference(runs):
    n, ref, port = runs
    assert len(ref["losses"]) == 4
    for d, out in enumerate(port):
        np.testing.assert_allclose(out["losses"],
                                   [step[d] for step in ref["losses"]],
                                   rtol=RTOL, err_msg=f"rank {d}")
        want = parallel_conv_flax_to_state_dict(ref["final"], d)
        assert set(out["state"]) == set(want)
        for k, w in want.items():
            got = np.asarray(out["state"][k])
            assert np.linalg.norm(got - w.numpy()) <= \
                RTOL * np.linalg.norm(w.numpy()), (d, k)
            np.testing.assert_allclose(got, w.numpy(), rtol=RTOL,
                                       atol=STEP_ATOL, err_msg=f"{d} {k}")
    # The reference returns device 0's loss.
    assert ref["last"] == pytest.approx(ref["losses"][-1][0])


def test_channel_shards_differ_by_rank(runs):
    """Each rank's shard has C/n output channels and its own
    initialisation (the reference folds the rank into its key)."""
    n, ref, port = runs
    for out in port:
        assert np.asarray(out["state"]["conv_0.weight"]).shape == \
            (16 // n, 3, 3, 3)
        assert np.asarray(out["state"]["conv_1.weight"]).shape == \
            (16 // n, 16, 3, 3)
    if n > 1:
        a, b = (np.asarray(p["state"]["head.weight"]) for p in port[:2])
        assert not np.array_equal(a, b)


def test_main_end_to_end(runs):
    n, _, port = runs
    for out in port:
        assert np.isfinite(out["main_loss"])
        assert out["main_loss"] == port[0]["main_loss"]     # rank 0's
    assert f"epoch 0: loss {port[0]['main_loss']:.4f}" in port[0]["printed"]
    assert all(out["printed"] == "" for out in port[1:])


def test_refuses_indivisible_channels():
    from chainermn_tpu_torch.examples import train_parallel_conv as ex

    class Comm:
        size, rank, device = 3, 0, torch.device("cpu")

    args = ex.parser().parse_args(["--channels", "16"])
    with pytest.raises(SystemExit, match="divisible by 3"):
        ex.make_model(args, Comm())
