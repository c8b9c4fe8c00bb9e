"""The port's ViT data + pipeline example against the reference example.

The reference's ``examples/vit/train_vit.py`` runs as it is, its
``main(argv)`` on a mesh of as many devices as the port has ranks (its
``create_communicator`` given that mesh) with its jitted step wrapped to
record each call: the initial parameters, each step's loss and the final
parameters.  The port's example (``ViTPipeline``, one process a rank on
gloo, workers from ``_torch_pp_worker.py``) starts from those initial
parameters, converted by ``convert.vit_example_flax_to_state_dict``, and
takes the same 3 steps on the same global batches: ``gpipe``, ``1f1b``
and ``1f1b --virtual-stages 2``, each with and without double buffering,
at world 1 and at 2 ranks (pp=2) here, at 4 ranks (dp=2 x pp=2 and pp=4)
in ``test_torch_vit_example_4ranks.py``.  Losses must agree within
1e-4 relative, and every final parameter tensor within 1e-4 relative L2,
each element within 1e-4 relative or 5e-5 absolute (5% of one AdamW
step of lr 1e-3: Adam normalises each element's step, so an element
whose gradient cancels to its rounding error may step differently).

This covers, each against the reference's arithmetic: the double
buffering of the example (step 0 runs AdamW's update on zeros and
scales it by 0, so step 1 bias-corrects with count 2), the GPipe path's
gradients (the pipeline size times the 1F1B path's, as the reference's
``psum`` gives them), and each rank's data row of the global batch.
Then ``main(argv)`` end to end at the reference smokes' flags.
"""

import contextlib
import importlib.util
import io
import pathlib

import jax
import numpy as np
import pytest

import _torch_pp_worker as worker
import chainermn_tpu
from chainermn_tpu.communicators import build_mesh
from chainermn_tpu_torch.convert import vit_example_flax_to_state_dict

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-4
# AdamW moves each element by about lr (1e-3) a step whatever its
# gradient's size, so an element whose gradient cancels to the size of
# its rounding can step a little differently: a few percent of one step
# (observed 1.9e-5 on one element of 512, pp=4 interleaved).
STEP_ATOL = 5e-5


def _load_reference(path):
    spec = importlib.util.spec_from_file_location(
        f"reference_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_reference_vit(world, argv):
    """The reference example's ``main(argv)`` on ``world`` devices: its
    initial parameters, per-step losses and final parameters (numpy)."""
    ref = _load_reference(REPO / "examples" / "vit" / "train_vit.py")
    real_cc, real_jit = chainermn_tpu.create_communicator, jax.jit
    calls = []

    def create_communicator(name, inter_size=None, **kw):
        inter = inter_size or 1
        mesh = build_mesh(inter_size=inter, intra_size=world // inter,
                          devices=jax.devices()[:world])
        return real_cc(name, mesh=mesh, **kw)

    def jit(fn, *a, **kw):
        jitted = real_jit(fn, *a, **kw)
        if getattr(fn, "__name__", "") != "step":
            return jitted

        def call(*args):
            out = jitted(*args)
            calls.append((args[0], out[0], float(out[3]), out[2]))
            return out

        return call

    chainermn_tpu.create_communicator, jax.jit = create_communicator, jit
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            ref.main(argv)
    finally:
        chainermn_tpu.create_communicator, jax.jit = real_cc, real_jit
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    kept = calls[0][3]          # step 0's averaged gradients (kept)
    norms = {g: float(np.sqrt(sum(np.sum(np.square(a)) for a in
                                  jax.tree_util.tree_leaves(kept[g]))))
             for g in ("embed", "stages", "head")}
    return {"init": as_np(calls[0][0]), "losses": [c[2] for c in calls],
            "final": as_np(calls[-1][1]), "grad_norms0": norms}


def _virtual(argv):
    return int(argv[argv.index("--virtual-stages") + 1]) \
        if "--virtual-stages" in argv else 1


def layout_runs(world, dp, tmp):
    """Every config of ``worker.vit_configs(dp)`` on the reference, and on
    the port at ``world`` ranks from the reference's initial parameters:
    ``{name: (reference, [rank results])}``."""
    configs = worker.vit_configs(dp)
    pp = world // (dp or 1)
    refs, inits = {}, {}
    for name, argv in configs.items():
        refs[name] = run_reference_vit(world, argv)
        arrays = {}
        for d in range(pp):
            sd = vit_example_flax_to_state_dict(refs[name]["init"], d,
                                                _virtual(argv))
            for group, tensors in sd.items():
                for k, t in tensors.items():
                    arrays[f"r{d}/{group}/{k}"] = t.numpy()
        inits[name] = str(tmp / f"{name}.npz")
        np.savez(inits[name], **arrays)
    if world == 1:
        from chainermn_tpu_torch import create_communicator

        comm = create_communicator("xla_ici", device="cpu")
        port = [{name: worker.vit_example_run(comm, argv, inits[name])
                 for name, argv in configs.items()}]
    else:
        port = worker.spawn("vit", world, tmp, dp=dp, init=inits)
    return {name: (refs[name], [r[name] for r in port]) for name in configs}


def check_layout(runs, name):
    ref, ranks = runs[name]
    argv = worker.vit_configs(None)[name]
    assert len(ref["losses"]) == 3
    for out in ranks:
        np.testing.assert_allclose(out["losses"], ref["losses"], rtol=RTOL)
        want = vit_example_flax_to_state_dict(ref["final"], out["pp_rank"],
                                              _virtual(argv))
        for group, tensors in want.items():
            assert set(out["state"][group]) == set(tensors), group
            for k, t in tensors.items():
                got, w = np.asarray(out["state"][group][k]), t.numpy()
                rel = np.linalg.norm(got - w) / np.linalg.norm(w)
                assert rel <= RTOL, (name, group, k, rel)
                np.testing.assert_allclose(got, w, rtol=RTOL, atol=STEP_ATOL,
                                           err_msg=f"{name} {group}/{k}")
    # Training moved the parameters (double buffering: from step 1 on).
    init = vit_example_flax_to_state_dict(ref["init"], 0, _virtual(argv))
    moved = np.asarray(ranks[0]["state"]["head"]["weight"])
    assert not np.array_equal(moved, init["head"]["weight"].numpy())


@pytest.fixture(scope="module", params=[(1, None), (2, None)],
                ids=["1rank", "pp2"])
def runs(request, tmp_path_factory):
    world, dp = request.param
    return layout_runs(world, dp, tmp_path_factory.mktemp(f"vit{world}"))


@pytest.mark.parametrize("name", sorted(worker.vit_configs(None)))
def test_example_matches_reference(runs, name):
    check_layout(runs, name)


def test_gpipe_gradients_are_pipeline_size_times_1f1b(runs):
    """The reference's GPipe path differentiates every pipeline rank's
    copy of the head loss through its ``psum``, so its gradients are the
    pipeline size times the 1F1B path's (2.0 at pp=2, 1.0 at one rank);
    the port's are too, group by group."""
    check_gradient_scale(runs)


def check_gradient_scale(runs):
    gp, ob = runs["gpipe_db"], runs["1f1b_db"]
    pp = len({r["pp_rank"] for r in gp[1]})
    for group in ("embed", "stages", "head"):
        ratio = gp[0]["grad_norms0"][group] / ob[0]["grad_norms0"][group]
        np.testing.assert_allclose(ratio, pp, rtol=1e-4, err_msg=group)
        for a, b in zip(gp[1], ob[1]):
            np.testing.assert_allclose(
                a["grad_norms0"][group] / b["grad_norms0"][group],
                pp, rtol=1e-4, err_msg=group)


def test_double_buffering_applies_nothing_at_step_0():
    """The reference's double-buffered step 0 leaves the parameters as
    they are, and the port's does too; without double buffering step 0
    moves them.  (Step 1's bias correction with count 2 is held by the
    parity above.)"""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.datasets.toy import batch_iterator
    from chainermn_tpu_torch.examples import train_vit as ex

    comm = create_communicator("xla_ici", device="cpu")
    for db, moved in (([], False), (["--no-double-buffering"], True)):
        args = ex.parser().parse_args(worker.VIT_FLAGS + db +
                                      ["--device", "cpu"])
        run = ex.ViTPipeline(args, comm)
        before = [p.detach().clone() for p in run.params]
        x, y = next(batch_iterator(ex.training_set(args), 8, seed=0))
        run.step(x, y)
        same = all(np.array_equal(a.numpy(), p.detach().numpy())
                   for a, p in zip(before, run.params))
        assert same != moved
        assert run.opt.count == 1


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_example_main_end_to_end(capsys, schedule):
    """The reference smokes' flags (``tests/test_examples.py``) on the
    CPU: one epoch of two steps, a finite loss, the reference's lines."""
    from chainermn_tpu_torch.examples import train_vit as ex

    loss = ex.main(worker.VIT_SMOKE + ["--schedule", schedule,
                                       "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "mesh: data=1 x pipeline=1 (+1 per-stage DP subgroups); " \
        "double_buffering=True" in printed
    assert f"epoch 0: loss {loss:.4f}" in printed
    assert np.isfinite(loss)


def test_example_refuses_bad_flags():
    from chainermn_tpu_torch.examples import train_vit as ex

    with pytest.raises(SystemExit, match="requires --schedule 1f1b"):
        ex.main(worker.VIT_SMOKE + ["--virtual-stages", "2",
                                    "--device", "cpu"])
    with pytest.raises(SystemExit, match=">= 1"):
        ex.main(worker.VIT_SMOKE + ["--virtual-stages", "0",
                                    "--device", "cpu"])
