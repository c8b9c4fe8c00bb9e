"""The reference side of the long-context example's parity tests
(``test_torch_long_context*.py``): the reference example's ``main`` on a
sub-mesh with its steps recorded, the port's runs from the same initial
parameters, and the comparison (bounds in ``test_torch_long_context.py``'s
docstring)."""

import contextlib
import importlib.util
import io
import pathlib

import jax
import numpy as np
import pytest

import _torch_sp_worker as worker
import chainermn_tpu
from chainermn_tpu.communicators import build_mesh
from chainermn_tpu_torch.convert import flax_to_state_dict, vocab_shard

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-4
STEP_ATOL = 1.5e-5


def _load_reference():
    path = REPO / "examples" / "long_context" / "train_lm.py"
    spec = importlib.util.spec_from_file_location("reference_train_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def reference_on(world):
    """The reference example's ``create_communicator`` on a mesh of
    ``world`` devices, every jitted ``shard_map`` step recorded: yields
    the list of ``(args, outputs)`` of its calls."""
    real_cc, real_jit = chainermn_tpu.create_communicator, jax.jit
    calls = []

    def create_communicator(name, inter_size=None, **kw):
        inter = inter_size or 1
        mesh = build_mesh(inter_size=inter, intra_size=world // inter,
                          devices=jax.devices()[:world])
        comm = real_cc(name, mesh=mesh, **kw)
        smap = comm.shard_map

        def shard_map(fn, *a, **k):
            mapped = smap(fn, *a, **k)
            mapped._record_calls = True
            return mapped

        comm.shard_map = shard_map
        return comm

    def jit(fn, *a, **kw):
        jitted = real_jit(fn, *a, **kw)
        if not getattr(fn, "_record_calls", False):
            return jitted

        def call(*args):
            out = jitted(*args)
            calls.append((args, out))
            return out

        return call

    chainermn_tpu.create_communicator, jax.jit = create_communicator, jit
    try:
        yield calls
    finally:
        chainermn_tpu.create_communicator, jax.jit = real_cc, real_jit


def run_reference_lm(world, argv):
    """The reference example's ``main(argv)`` on ``world`` devices: its
    initial parameters (a flax tree, the full table included), per-step
    losses and final parameters (numpy)."""
    ref = _load_reference()
    with reference_on(world) as calls, \
            contextlib.redirect_stdout(io.StringIO()):
        ref.main(argv)
    steps = [(a, o) for a, o in calls
             if isinstance(o, tuple) and np.ndim(o[-1]) == 0]
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    vocab_tp = "--vocab-tp" in argv

    def params(tree, emb):
        p = dict(as_np(tree)["params"])
        if vocab_tp:
            p["embed"] = {"embedding": np.asarray(emb)}
        return {"params": p}

    first, last = steps[0], steps[-1]
    return {"init": params(first[0][0], first[0][1]),
            "final": params(last[1][0], last[1][1]),
            "losses": [float(o[-1]) for _, o in steps]}


def layout_runs(world, tmp):
    """Every config of ``worker.lm_configs(world)`` on the reference, and
    on the port at ``world`` ranks from the reference's initial
    parameters: ``{name: (reference, [rank results])}``."""
    configs = worker.lm_configs(world)
    refs, inits = {}, {}
    for name, extra in configs.items():
        argv = worker.LM_FLAGS + extra
        refs[name] = run_reference_lm(world, argv)
        sd = flax_to_state_dict(refs[name]["init"])
        inits[name] = str(tmp / f"{name}.npz")
        np.savez(inits[name], **{k: v.numpy() for k, v in sd.items()})
    if world == 1:
        from chainermn_tpu_torch import create_communicator

        comm = create_communicator("xla_ici", device="cpu")
        port = [{name: worker.lm_example_run(comm, worker.LM_FLAGS + extra,
                                             inits[name])
                 for name, extra in configs.items()}]
    else:
        port = worker.spawn("lm", world, tmp, init=inits)
    return {name: (refs[name], [r[name] for r in port]) for name in configs}


def check_config(runs, name, world):
    ref, ranks = runs[name]
    assert len(ref["losses"]) == 3
    want = flax_to_state_dict(ref["final"])
    extra = worker.lm_configs(world)[name]
    for out in ranks:
        np.testing.assert_allclose(out["losses"], ref["losses"], rtol=RTOL,
                                   err_msg=name)
        state = dict(out["state"])
        if "--vocab-tp" in extra:
            n = world // (int(extra[extra.index("--dp") + 1]))
            rows = vocab_shard(want["embed.weight"].numpy(),
                               out["intra_rank"], n)
            np.testing.assert_allclose(np.asarray(state.pop("embed_shard")),
                                       rows, rtol=RTOL,
                                       atol=STEP_ATOL,
                                       err_msg=f"{name} embed rows")
            want_keys = set(want) - {"embed.weight"}
        else:
            want_keys = set(want)
        assert set(state) == want_keys, name
        for k in want_keys:
            got, w = np.asarray(state[k]), want[k].numpy()
            rel = np.linalg.norm(got - w) / np.linalg.norm(w)
            assert rel <= RTOL, (name, k, rel)
            np.testing.assert_allclose(got, w, rtol=RTOL, atol=STEP_ATOL,
                                       err_msg=f"{name} {k}")
    # Training moved the parameters.
    init = flax_to_state_dict(ref["init"])
    k = "final_norm.weight"
    assert not np.array_equal(np.asarray(ranks[0]["state"][k]),
                              init[k].numpy())


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """``layouts(world)``: :func:`layout_runs` at ``world``, run once."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = layout_runs(world,
                                       tmp_path_factory.mktemp(f"lm{world}"))
        return cache[world]

    return get
