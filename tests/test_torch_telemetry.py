"""The port's training telemetry against the JAX package's.

Both packages' train steps, communicators and evaluators run under a
``Reporter`` and a ``StepRecorder`` on the same numpy problem
(``_torch_telemetry_worker.problem``): the reference on 1 and 2 devices of
the CPU mesh, the port at 1 rank in this process and at 2 gloo ranks
spawned from ``_torch_telemetry_worker.py``.  Held equal: the
``train_step`` span and ``train_step_calls``, the ``grad_pack/*`` plan
counters (full-precision and int8 wires), the ``comm/quant_abs_err``
gauge, and the evaluator's ``eval/*`` scalars and ``eval`` row (within
the evaluator's 1e-5).  Also the step log's ``recover``/``recording``
on the same torn file, and the crash row of the except hook.
"""

import json
import multiprocessing as mp
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import _torch_telemetry_worker as tw
from chainermn_tpu import observability as jobs
from chainermn_tpu.communicators import build_mesh
from chainermn_tpu.communicators import create_communicator as jax_comm
from chainermn_tpu.communicators.quant import (
    measure_comm_quant_error as jax_measure)
from chainermn_tpu.extensions import Evaluator as JaxEvaluator
from chainermn_tpu.observability import step_log as jstep_log
from chainermn_tpu.optimizers import create_multi_node_optimizer as jax_mno
from chainermn_tpu_torch.observability import step_log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 60
GRAD_PACK = ("grad_pack/traces", "grad_pack/leaves", "grad_pack/buckets",
             "grad_pack/payload_bytes", "grad_pack/pad_bytes")
QUANT = ("grad_pack/quant_buckets", "grad_pack/quant_wire_bytes")


# -- the reference side -------------------------------------------------------

def _ref_comm(n_dev, comm_dtype=None):
    mesh = build_mesh(inter_size=1, intra_size=n_dev,
                      devices=jax.devices()[:n_dev])
    return jax_comm("xla_ici", mesh=mesh, bucket_bytes=tw.BUCKET_BYTES,
                    comm_dtype=comm_dtype)


def _ref_forward(p, x):
    return jax.nn.relu(x @ p["a"] + p["b"]) @ p["c"]


def _ref_installed(tmp, tag, body):
    rep = jobs.Reporter()
    path = str(tmp / f"ref_{tag}.jsonl")
    with jobs.scope(rep), jobs.StepRecorder(
            path, capture_compile_events=False, mem_every=0):
        res = body()
    return rep.summary(), jstep_log.read_records(path), res


def ref_train(tmp, n_dev, comm_dtype=None):
    comm = _ref_comm(n_dev, comm_dtype)
    params, (x, y), _ = tw.problem()
    p = {k: jnp.asarray(v) for k, v in params.items()}
    mno = jax_mno(optax.sgd(0.1), comm)
    state = mno.init(p)
    step = mno.make_train_step(
        lambda p, b: jnp.mean((_ref_forward(p, b[0]) - b[1]) ** 2),
        donate=False)

    def body():
        nonlocal p, state
        rec = jstep_log.current_recorder()
        losses = []
        for _ in range(tw.STEPS):
            p, state, loss = step(p, state, (x, y))
            losses.append(float(loss))
            rec.step(loss=losses[-1])
        return losses

    summary, rows, losses = _ref_installed(tmp, f"train{n_dev}{comm_dtype}",
                                           body)
    spans = sorted({n for r in rows if r["event"] == "step"
                    for n in r.get("spans", {})})
    return {"summary": summary, "span_names": spans, "losses": losses}


def ref_quant(tmp, n_dev):
    comm = _ref_comm(n_dev, "int8")
    params, _, _ = tw.problem()
    tree = {k: jnp.asarray(v) for k, v in params.items()}
    summary, _, err = _ref_installed(tmp, f"quant{n_dev}",
                                     lambda: jax_measure(comm, tree))
    return {"err": err, "gauges": summary.get("gauges", {})}


def ref_eval(tmp, n_dev):
    comm = _ref_comm(n_dev)
    params, _, evals = tw.problem()
    p = {k: jnp.asarray(v) for k, v in params.items()}

    def metric_fn(p, b):
        err = _ref_forward(p, b[0]) - b[1]
        return {"val/mse": jnp.mean(err ** 2),
                "val/pos": jnp.mean((err > 0).astype(jnp.float32))}

    summary, rows, metrics = _ref_installed(
        tmp, f"eval{n_dev}",
        lambda: JaxEvaluator(metric_fn, comm).evaluate(p, evals))
    return {"metrics": metrics, "scalars": summary["scalars"],
            "eval_rows": [r["metrics"] for r in rows
                          if r["event"] == "eval"]}


# -- the port side ------------------------------------------------------------

def spawn(size, tmp, which="all"):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=tw.run,
                         args=(r, size, str(tmp / "rendezvous"), str(tmp),
                               which))
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
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(size)]


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every case at 1 rank (here) and at 2 gloo ranks (rank 0's)."""
    one = tw.all_cases(str(tmp_path_factory.mktemp("port1")))
    two = spawn(2, tmp_path_factory.mktemp("port2"))
    return {1: one, 2: two[0]}


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("ref")
    return {n: {"plain": ref_train(tmp, n), "int8": ref_train(tmp, n, "int8"),
                "quant": ref_quant(tmp, n), "eval": ref_eval(tmp, n)}
            for n in (1, 2)}


def _counters(run, keys):
    return {k: run["summary"]["counters"].get(k) for k in keys}


@pytest.mark.parametrize("n", [1, 2])
def test_train_step_span_and_calls_match_reference(port_runs, ref_runs, n):
    """The reference's one span, ``train_step``; the port also times the
    step's phases inside it (the reference's step is one XLA program)."""
    port, ref = port_runs[n]["plain"], ref_runs[n]["plain"]
    assert ref["span_names"] == ["train_step"]
    assert port["span_names"] == ["train_step"] + [
        f"train_step/{p}" for p in ("backward", "forward", "grad_sync",
                                    "update")]
    assert _counters(port, ["train_step_calls"]) == \
        _counters(ref, ["train_step_calls"]) == {"train_step_calls": tw.STEPS}
    assert port["summary"]["scalars"]["span/train_step"]["count"] == \
        ref["summary"]["scalars"]["span/train_step"]["count"] == tw.STEPS
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-6)


@pytest.mark.parametrize("wire", ["plain", "int8"])
@pytest.mark.parametrize("n", [1, 2])
def test_grad_pack_plan_counters_match_reference(port_runs, ref_runs, n,
                                                 wire):
    """The plan is published once a layout at every world size (one rank
    on a full-precision wire included, though nothing is packed there).
    The reference publishes at each trace of its jitted step, and it
    traces twice (the second call's inputs are the first call's placed
    outputs): its counters are held per trace."""
    port, ref = port_runs[n][wire], ref_runs[n][wire]
    keys = GRAD_PACK + (QUANT if wire == "int8" else ())
    traces = ref["summary"]["counters"]["grad_pack/traces"]
    want = {k: v // traces for k, v in _counters(ref, keys).items()}
    assert all(v * traces == ref["summary"]["counters"][k]
               for k, v in want.items())
    assert want["grad_pack/traces"] == 1 and want["grad_pack/buckets"] == 2
    assert _counters(port, keys) == want
    hist = ref["summary"]["histograms"]["grad_pack/bucket_bytes"]
    assert port["summary"]["histograms"]["grad_pack/bucket_bytes"] == \
        {b: c // traces for b, c in hist.items()}
    if wire == "plain":
        assert not any(k in port["summary"]["counters"] for k in QUANT)


@pytest.mark.parametrize("n", [1, 2])
def test_quant_abs_err_gauge_published(port_runs, ref_runs, n):
    port, ref = port_runs[n]["quant"], ref_runs[n]["quant"]
    assert port["gauges"]["comm/quant_abs_err"]["value"] == port["err"]
    assert "comm/quant_abs_err" not in port["silent_gauges"]
    assert ref["gauges"]["comm/quant_abs_err"]["value"] == ref["err"]
    # The same int8 payloads; the dequantized means round in fp32 in
    # another order at two ranks (values up to ~1.5: an ulp is ~1e-7).
    np.testing.assert_allclose(port["err"], ref["err"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2])
def test_eval_metrics_published_like_reference(port_runs, ref_runs, n):
    port, ref = port_runs[n]["eval"], ref_runs[n]["eval"]
    assert set(port["metrics"]) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(port["metrics"][k], v, rtol=1e-5)
        for side in (port, ref):
            assert side["scalars"][f"eval/{k}"]["count"] == 1
        np.testing.assert_allclose(port["scalars"][f"eval/{k}"]["last"],
                                   ref["scalars"][f"eval/{k}"]["last"],
                                   rtol=1e-5)
    assert len(port["eval_rows"]) == len(ref["eval_rows"]) == 1
    assert set(port["eval_rows"][0]) == set(ref["eval_rows"][0])
    assert port["scalars"]["span/evaluate"]["count"] == \
        ref["scalars"]["span/evaluate"]["count"] == 1


def test_instrumented_step_fast_path_is_one_check(monkeypatch):
    """With no telemetry installed a step consults ``telemetry_active``
    once and never enters a span."""
    import torch

    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.observability import spans

    w = torch.nn.Parameter(torch.ones(3))
    b = torch.nn.Parameter(torch.zeros(1))
    mno = create_multi_node_optimizer(
        torch.optim.SGD([w, b], lr=0.1),
        create_communicator("naive", device="cpu"))
    mno.init()
    step = mno.make_train_step(lambda x: ((x @ w + b) ** 2).mean())
    x = torch.ones(4, 3)
    step(x)                          # first use: the plan's one check too
    calls = []
    real = spans.telemetry_active
    monkeypatch.setattr(spans, "telemetry_active",
                        lambda: calls.append(1) or real())

    def no_span(name):
        raise AssertionError("span entered with telemetry off")

    monkeypatch.setattr(spans, "span", no_span)
    for _ in range(3):
        step(x)
    assert len(calls) == 3
    assert step.__name__ == "step"


def test_instrumented_with_state_and_setup_counted_once(tmp_path):
    import torch

    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch import observability as obs

    model = torch.nn.Sequential(torch.nn.Linear(3, 2),
                                torch.nn.BatchNorm1d(2))
    comm = create_communicator("naive", device="cpu")
    mno = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), comm)
    mno.init()
    with_state = mno.make_train_step_with_state(
        lambda x: model(x).pow(2).mean(), model)
    mno2 = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), comm)
    mno2.setup(model, lambda x: model(x).pow(2).mean())
    rep = obs.Reporter()
    with obs.scope(rep):
        with_state(torch.ones(4, 3))
        mno2.update(torch.ones(4, 3))
    s = rep.summary()
    assert s["counters"]["train_step_calls"] == 2
    assert s["scalars"]["span/train_step"]["count"] == 2


# -- the step log's recovery --------------------------------------------------

def _torn_file(path):
    rows = [{"event": "step", "rank": 0, "t": 1.0 + i, "step": i,
             "loss": 0.5 / (i + 1)} for i in range(5)]
    data = "".join(json.dumps(r) + "\n" for r in rows).encode()
    path.write_bytes(data + b'{"event": "step", "rank": 0, "t": 9.0, "st')
    return len(data)


def test_recover_matches_reference_on_torn_file(tmp_path):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    whole = _torn_file(a)
    _torn_file(b)
    assert step_log.recover(str(a)) == jstep_log.recover(str(b)) == 5
    assert a.read_bytes() == b.read_bytes()
    assert len(a.read_bytes()) == whole
    assert step_log.recover(str(a)) == 5          # idempotent
    assert step_log.read_records(str(a), strict=True) == \
        jstep_log.read_records(str(b), strict=True)


def test_recover_without_newline_and_with_corrupt_row(tmp_path):
    p = tmp_path / "c.jsonl"
    p.write_bytes(b'{"event": "st')
    assert step_log.recover(str(p)) == 0 and p.read_bytes() == b""
    p.write_bytes(b'{"event": "step"}\nnot json\n')
    with pytest.raises(ValueError):
        step_log.recover(str(p))


def test_recording_installs_and_closes(tmp_path):
    path = tmp_path / "r.jsonl"
    with step_log.recording(str(path), mem_every=0) as rec:
        assert step_log.current_recorder() is rec
        rec.step(loss=1.0)
    assert step_log.current_recorder() is None
    assert rec._fd is None
    with jstep_log.recording(str(tmp_path / "j.jsonl"), mem_every=0,
                             capture_compile_events=False) as jrec:
        jrec.step(loss=1.0)
    mine, theirs = (step_log.read_records(str(path)),
                    jstep_log.read_records(str(tmp_path / "j.jsonl")))
    strip = [{k: v for k, v in r.items() if k != "t"} for r in mine]
    assert strip == [{k: v for k, v in r.items() if k != "t"}
                     for r in theirs]


# -- the except hook's crash row ----------------------------------------------

_CRASH = (
    "import sys\n"
    "import {pkg}.global_except_hook as geh\n"
    "from {pkg}.observability.step_log import StepRecorder\n"
    "rec = StepRecorder(sys.argv[1], mem_every=0{kw}).__enter__()\n"
    "geh.add_hook()\n"
    "geh.set_current_step(7)\n"
    "raise RuntimeError('chaos-postmortem-test')\n"
)
_ROW_KEYS = ("event", "rank", "size", "step", "exc")


def _crash_rows(tmp_path, pkg, kw=""):
    pm = tmp_path / f"{pkg}.postmortem.jsonl"
    log = tmp_path / f"{pkg}.steps.jsonl"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               CHAINERMN_TPU_POSTMORTEM_FILE=str(pm),
               CHAINERMN_TPU_ELASTIC_RANK="3", JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", _CRASH.format(pkg=pkg, kw=kw), str(log)],
        capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 13, res.stderr
    file_rows = [json.loads(x) for x in pm.read_text().splitlines()]
    rec_rows = [r for r in step_log.read_records(str(log))
                if r.get("event") == "crash"]
    return file_rows, rec_rows


def test_postmortem_row_carries_step_in_both_sinks(tmp_path):
    """A rank that raises at step 7 with a recorder installed and the
    elastic rank in the environment: the crash row equals the
    reference's (but for ``t`` and the traceback's paths) in the
    postmortem file and in the recorder."""
    ref_file, ref_rec = _crash_rows(tmp_path, "chainermn_tpu",
                                    ", capture_compile_events=False")
    port_file, port_rec = _crash_rows(tmp_path, "chainermn_tpu_torch")
    assert len(port_file) == len(port_rec) == len(ref_file) == 1
    for port, ref in ((port_file[0], ref_file[0]), (port_rec[0], ref_rec[0])):
        assert {k: port[k] for k in _ROW_KEYS} == \
            {k: ref[k] for k in _ROW_KEYS}
        assert set(port) == set(ref)
        assert port["step"] == 7 and port["rank"] == 3
        assert "chaos-postmortem-test" in port["traceback"]
