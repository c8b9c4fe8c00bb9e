"""The port's pipeline tier against the JAX package's.

Each of the seven schedule functions of ``parallel/pipeline.py`` runs on
2 and 4 gloo ranks (workers from ``_torch_pp_worker.py``, one process a
stage) and on a mesh of as many devices of the reference, on the same
seeded numpy inputs, over ``tests/test_pipeline.py``'s parametrisations:
GPipe at ``n_micro`` 1, 2 and 4 and its loss, 1F1B at 2, 4 and 8,
interleaved at ``(v, M)`` (2, 4), (2, 8), (3, 4), circular at (1, 4),
(2, 4), (2, 8), (3, 4), and the composed forms with a head inside the
schedule and the input cotangents out.  Each rank's outputs (the
forward's on every rank, zeros off the last), loss, stage gradients,
head gradients (nonzero on the last rank only) and input cotangents
(nonzero on rank 0 only) are held to the reference device's.  At one
rank the same cases run in this process.  The argument errors, the tick
algebra and the three pure-Python helpers (equal to the reference's
exactly) close the file.

Tolerance: rtol 1e-5 in fp32, with atol 1e-6 for elements that cancel to
near zero (a gradient summed over microbatches in another order; torch's
and XLA's ``tanh`` differ in the last bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import _torch_pp_worker as worker
from chainermn_tpu.communicators import build_mesh
from chainermn_tpu.communicators.base import shard_map_compat as shard_map
from chainermn_tpu.parallel import pipeline as ref
from chainermn_tpu_torch.parallel import pipeline as port

TOL = dict(rtol=1e-5, atol=1e-6)


def _stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _mse(out, target):
    return jnp.mean((out - target) ** 2)


def _head_loss(hw, out, target):
    return jnp.mean((out @ hw - target) ** 2)


def reference_case(n: int, name: str) -> dict:
    """The case on a mesh of ``n`` devices: each output with a leading
    device axis (per device, unreduced)."""
    kind, M, v, composed = worker.PP_CASES[name]
    inp = worker.pp_inputs(n, v)
    mesh = build_mesh(inter_size=1, intra_size=n, devices=jax.devices()[:n])
    if kind in ("gpipe", "gpipe_loss", "1f1b"):
        stacked = {"w": inp["w"], "b": inp["b"]}
    else:
        stacked = {k: worker.per_device(inp[k], n, v) for k in ("w", "b")}
    x, tgt = jnp.asarray(inp["x"]), jnp.asarray(inp["tgt"])

    def mapped(body, n_in, n_out):
        return jax.jit(shard_map(
            body, mesh=mesh, in_specs=(P("intra"),) + (P(),) * n_in,
            out_specs=(P("intra"),) * n_out, check_vma=False))

    def mine(stacked):
        return jax.tree.map(lambda p: jnp.squeeze(p, 0), stacked)

    if kind in ("gpipe", "circular_fwd"):
        def body(stacked, x):
            if kind == "gpipe":
                out = ref.spmd_pipeline(_stage, mine(stacked), x, "intra", M)
            else:
                out = ref.spmd_pipeline_circular(_stage, mine(stacked), x,
                                                 "intra", M, v)
            return (out[None],)

        (out,) = mapped(body, 1, 1)(stacked, x)
        return {"out": np.asarray(out)}
    if kind == "gpipe_loss":
        def dist_loss(stacked, x):
            def body(stacked, x, tgt):
                return ref.pipeline_forward_and_loss(
                    _stage, _mse, mine(stacked), x, tgt, "intra", M)

            return shard_map(body, mesh=mesh, in_specs=(P("intra"), P(), P()),
                             out_specs=P(), check_vma=False)(stacked, x, tgt)

        loss, (g, gx) = jax.jit(jax.value_and_grad(dist_loss, (0, 1)))(
            stacked, x)
        return {"loss": float(loss), "w": np.asarray(g["w"]),
                "b": np.asarray(g["b"]), "x": np.asarray(gx)}
    fn = {"1f1b": ref.pipeline_1f1b_loss_and_grads,
          "interleaved": ref.pipeline_interleaved_1f1b_loss_and_grads,
          "circular": ref.pipeline_circular_1f1b_loss_and_grads}[kind]
    extra = () if kind == "1f1b" else (v,)
    expand = lambda t: jax.tree.map(lambda a: a[None], t)  # noqa: E731
    if not composed:
        def body(stacked, x, tgt):
            loss, g = fn(_stage, _mse, mine(stacked), x, tgt, "intra", M,
                         *extra)
            return loss[None], expand(g)

        loss, g = mapped(body, 2, 2)(stacked, x, tgt)
        return {"loss": float(loss[0]), "w": np.asarray(g["w"]),
                "b": np.asarray(g["b"])}

    def body(stacked, ew, hw, x, tgt):
        tokens, embed_vjp = jax.vjp(lambda w: jnp.tanh(x @ w), ew)
        loss, g, hg, gtok = fn(_stage, _head_loss, mine(stacked), tokens, tgt,
                               "intra", M, *extra, loss_params=hw,
                               with_input_grads=True)
        (eg,) = embed_vjp(jax.lax.psum(gtok, "intra"))
        return (loss[None], expand(g), hg[None], gtok[None],
                jax.lax.psum(hg, "intra")[None], eg[None])

    loss, g, hg, gtok, hsum, eg = mapped(body, 4, 6)(
        stacked, jnp.asarray(inp["embed_w"]), jnp.asarray(inp["head_w"]), x,
        tgt)
    return {"loss": float(loss[0]), "w": np.asarray(g["w"]),
            "b": np.asarray(g["b"]), "head": np.asarray(hg),
            "gtok": np.asarray(gtok), "head_sum": np.asarray(hsum),
            "embed": np.asarray(eg)}


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda n: f"{n}ranks")
def runs(request, tmp_path_factory):
    """Every case on ``n`` ranks: ``(n, [rank results])``."""
    n = request.param
    if n == 1:
        return n, [worker._pipeline(0, 1)]
    return n, worker.spawn("pipeline", n,
                           tmp_path_factory.mktemp(f"pipeline{n}"))


@pytest.mark.parametrize("name", sorted(worker.PP_CASES))
def test_schedule_matches_reference(runs, name):
    """Every output of the case on every rank against the reference's on
    the same device; the input gradient of the GPipe loss (the
    reference's, of a replicated input, is the sum over the devices)
    against the sum over the ranks."""
    n, res = runs
    want = reference_case(n, name)
    kind = worker.PP_CASES[name][0]
    for d, out in enumerate(res):
        got = out[name]
        assert set(got) == set(want), (set(got), set(want))
        for key, w in want.items():
            if key == "loss":
                np.testing.assert_allclose(got[key], w, rtol=1e-5)
            elif key != "x":
                np.testing.assert_allclose(np.asarray(got[key]), w[d],
                                           err_msg=f"{key} rank {d}", **TOL)
        # Ownership: the forward's output and the head gradients on the
        # last rank, the input cotangents on rank 0, zeros elsewhere.
        if n > 1 and "head" in got:
            assert np.any(got["head"]) == (d == n - 1)
            assert np.any(got["gtok"]) == (d == 0)
        if n > 1 and "out" in got:
            assert np.any(got["out"]) == (d == n - 1)
    if "x" in want:
        np.testing.assert_allclose(sum(np.asarray(o[name]["x"]) for o in res),
                                   want["x"], **TOL)
        assert not any(np.any(o[name]["x"]) for o in res[1:])


def test_argument_errors(runs):
    n, res = runs
    for out in res:
        errs = out["errors"]
        assert "divisible" in errs["gpipe"]
        assert "divisible" in errs["1f1b"]
        for name in ("interleaved", "circular", "circular_fwd"):
            if n == 1:
                assert errs[name] is None       # every M is a round of one
            else:
                assert "rounds" in errs[name], (name, errs[name])


@pytest.mark.parametrize("n,M,v", [(2, 4, 2), (4, 4, 2), (4, 8, 3),
                                   (3, 6, 4), (4, 4, 1), (1, 3, 2)])
def test_tick_algebra_matches_reference(n, M, v):
    """Each rank's units, tick by tick, are those of the reference's
    formulas: circular ``t = d + r n v + l n + j``; coupled forward ``t =
    r v n + s + j`` and backward ``t = r v n + j + 2(L - 1) - s``.  Every
    circular handoff lands one tick before its use, each rank is gapless
    over ``[d, d + M v)``, and the tick counts are the reference's."""
    L = n * v
    T = port.circular_schedule_ticks(n, M, v)
    assert T == ref.circular_schedule_ticks(n, M, v) == M * v + n - 1
    Tc = port.coupled_schedule_ticks(n, M, v)
    assert Tc == M * v + n * v + n - 2
    want_circ, want_f, want_b = {}, {}, {}
    for m in range(M):
        r, j = divmod(m, n)
        for s in range(L):
            d, l = s % n, s // n
            want_circ[(d, d + r * n * v + l * n + j)] = (m, l)
            want_f[(d, r * v * n + s + j)] = (m, l)
            want_b[(d, r * v * n + j + 2 * (L - 1) - s)] = (m, l)
    got_circ, got_f, got_b = {}, {}, {}
    for d in range(n):
        for t in range(-2, Tc + 2):
            for got, fn in ((got_circ, port.circular_unit),
                            (got_f, port.coupled_forward_unit),
                            (got_b, port.coupled_backward_unit)):
                u = fn(t, d, n, M, v)
                if u is not None:
                    got[(d, t)] = u
    assert got_circ == want_circ
    assert got_f == want_f
    assert got_b == want_b
    assert max(t for _, t in got_circ) + 1 == T
    assert max(t for _, t in got_b) + 1 == Tc
    for d in range(n):
        assert sorted(t for dd, t in got_circ if dd == d) == list(
            range(d, d + M * v))
    for (d, t), (m, l) in got_circ.items():
        s = l * n + d
        if s > 0:
            prev = ((s - 1) % n, t - 1)
            assert got_circ[prev] == (m, (s - 1) // n)
    # GPipe is the circular schedule with one chunk: microbatch t - d.
    for d in range(n):
        for t in range(M + n - 1):
            u = port.circular_unit(t, d, n, M, 1)
            assert u == ((t - d, 0) if 0 <= t - d < M else None)


def test_helpers_equal_reference():
    for n in range(0, 9):
        for s in range(0, 5):
            assert port.decode_microbatches(n, s) == \
                ref.decode_microbatches(n, s)
    for n_micro in range(0, 6):
        for n_stages in range(0, 5):
            assert port.serve_pipeline_order(n_micro, n_stages) == \
                ref.serve_pipeline_order(n_micro, n_stages)
    for n, M, v in [(2, 4, 2), (4, 4, 2), (4, 8, 3), (3, 6, 4), (4, 4, 1)]:
        assert port.circular_schedule_ticks(n, M, v) == \
            ref.circular_schedule_ticks(n, M, v)
