"""The port's elastic supervisor and its CLI against the reference's.

The supervisor is process plumbing alone, so these run with the stdlib
dummy ranks of ``_torch_elastic_dummy_worker.py`` (no torch in the
ranks): the reference's supervisor tests (``tests/test_elastic.py``)
against ``chainermn_tpu_torch.elastic`` and ``tools.elastic``, and one
parity case that runs both packages' supervisors over the same schedules
and compares their reports and step-log counters.  The training soaks
over real gloo ranks are in ``test_torch_elastic_soak.py``.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from chainermn_tpu_torch.elastic import (
    EXIT_PREEMPTED,
    ElasticSupervisor,
    SupervisorConfig,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DUMMY = os.path.join(os.path.dirname(__file__),
                      "_torch_elastic_dummy_worker.py")


def _env():
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def _fields(tmp_path, mode, nproc=1, **kw):
    cfg = dict(
        argv=[sys.executable, _DUMMY, mode],
        nproc=nproc,
        heartbeat_timeout_s=1.0,
        start_grace_s=10.0,
        poll_s=0.02,
        grace_s=2.0,
        backoff_s=0.05,
        workdir=str(tmp_path / "sup"),
        echo=False,
        barrier_timeout_s=30.0,
    )
    cfg.update(kw)
    return cfg


def _config(tmp_path, mode, nproc=1, **kw):
    return SupervisorConfig(**_fields(tmp_path, mode, nproc, **kw))


def test_exit_preempted_is_the_reference_code():
    from chainermn_tpu.elastic import EXIT_PREEMPTED as ref

    assert EXIT_PREEMPTED == ref == 75


def test_supervisor_clean_run(tmp_path):
    report = ElasticSupervisor(_config(tmp_path, "ok")).run()
    assert report["status"] == "ok"
    assert report["restarts"] == 0
    assert report["preemptions"] == 0
    assert report["incarnations"] == 1
    assert report["params_digest"] == "abad1dea"


def test_supervisor_restarts_after_crash(tmp_path):
    sup = ElasticSupervisor(_config(tmp_path, "crash_once"))
    report = sup.run()
    assert report["status"] == "ok"
    assert report["restarts"] == 1
    assert report["incarnations"] == 2
    # the dummy's incarnation-1 output carries "resumed from iteration 10"
    assert report["resume_generation"] == 10
    kinds = [e["kind"] for e in sup.events]
    assert "failure" in kinds and "success" in kinds


def test_supervisor_exhausts_restart_budget(tmp_path):
    t0 = time.monotonic()
    sup = ElasticSupervisor(
        _config(tmp_path, "crash_always", max_restarts=1))
    report = sup.run()
    assert report["status"] == "failed"
    assert report["restarts"] == 2  # budget 1 exceeded on the 2nd crash
    assert report["incarnations"] == 2
    assert any(e["kind"] == "give_up" and e["reason"] == "max_restarts"
               for e in sup.events)
    assert time.monotonic() - t0 < 30  # bounded: no deadline-less waits


def test_supervisor_teardown_is_bounded_and_sigkills(tmp_path):
    """Rank 1 crashes while rank 0 ignores SIGTERM and beats forever: the
    supervisor SIGKILLs rank 0 within its grace window, then respawns and
    finishes."""
    t0 = time.monotonic()
    sup = ElasticSupervisor(_config(tmp_path, "teardown", nproc=2))
    report = sup.run()
    elapsed = time.monotonic() - t0
    assert report["status"] == "ok"
    assert report["restarts"] == 1
    td = [e for e in sup.events if e["kind"] == "teardown"]
    assert any(0 in e["sigkilled"] for e in td), td
    assert elapsed < 30, f"teardown not bounded: {elapsed:.1f}s"


def test_supervisor_heartbeat_deadline_detects_stall(tmp_path):
    """Rank 1 stays alive but stops beating: only the heartbeat deadline
    can catch it (exit-code polling never fires)."""
    sup = ElasticSupervisor(
        _config(tmp_path, "stall", nproc=2, heartbeat_timeout_s=0.5,
                start_grace_s=5.0))
    report = sup.run()
    assert report["status"] == "ok"
    assert report["restarts"] == 1
    fails = [e for e in sup.events if e["kind"] == "failure"]
    assert any(1 in e["heartbeat_dead"] for e in fails), fails


def test_supervisor_lets_a_finished_rank_fall_silent(tmp_path):
    """Rank 0 exits 0 while rank 1 beats on past the deadline: a rank
    that finished is no heartbeat death, so nothing restarts."""
    sup = ElasticSupervisor(
        _config(tmp_path, "rank0_finishes_first", nproc=2,
                heartbeat_timeout_s=0.5))
    report = sup.run()
    assert report["status"] == "ok", sup.events
    assert report["restarts"] == 0
    assert not [e for e in sup.events if e["kind"] == "failure"]


def test_supervisor_rescales_to_survivors(tmp_path):
    sup = ElasticSupervisor(
        _config(tmp_path, "crash_rank1_once", nproc=2,
                rescale_on_failure=True, min_nproc=1))
    report = sup.run()
    assert report["status"] == "ok"
    assert report["nproc"] == 2
    assert report["world"] == 1  # shrank to the survivor count
    assert any(e["kind"] == "rescale" and e["to_world"] == 1
               for e in sup.events)


def test_supervisor_rescale_keeps_ranks_that_left_through_the_hook(
        tmp_path):
    """Rank 1 is SIGKILLed and its peers leave through the crash hook
    (exit 13) as their collective fails: only rank 1's host is gone, so
    three ranks rescale to two."""
    sup = ElasticSupervisor(
        _config(tmp_path, "kill_rank1_peers_follow", nproc=3,
                rescale_on_failure=True, min_nproc=1))
    report = sup.run()
    assert report["status"] == "ok" and report["restarts"] == 1
    assert report["world"] == 2
    fail = [e for e in sup.events if e["kind"] == "failure"][0]
    assert sorted(c for _, c in fail["exited"]) in ([-9], [-9, 13],
                                                    [-9, 13, 13])


def test_worker_refuses_two_nccl_ranks_on_one_card(monkeypatch):
    import torch

    from chainermn_tpu_torch import _device
    from chainermn_tpu_torch.elastic import worker

    monkeypatch.setattr(_device, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="world of 2 ranks over NCCL "
                       "needs 2 cards .* has 1"):
        worker._distributed_init("127.0.0.1:1", 2, 1, 10.0, "cuda")


def test_supervisor_counts_preemption_separately(tmp_path):
    report = ElasticSupervisor(_config(tmp_path, "preempt_once")).run()
    assert report["status"] == "ok"
    assert report["preemptions"] == 1
    assert report["restarts"] == 0  # preemption is not a crash
    assert report["incarnations"] == 2
    assert report["exit_codes"] == {"0": 0}


def test_supervisor_counters_through_obs(tmp_path):
    """The elastic/* counters ride the step log into the port's
    ``tools.obs`` summary and Prometheus export."""
    log = tmp_path / "sup.jsonl"
    ElasticSupervisor(
        _config(tmp_path, "crash_once", step_log=str(log))).run()
    from chainermn_tpu_torch.observability.step_log import read_records
    from chainermn_tpu_torch.tools.obs import summarize, to_prometheus

    rows = read_records(str(log))
    summary = summarize(rows)
    assert summary["counters"]["elastic/restarts"] == 1
    assert summary["counters"]["elastic/preemptions"] == 0
    assert summary["counters"]["elastic/resume_generation"] == 10
    prom = to_prometheus(summary)
    assert 'counter_total{name="elastic/restarts"} 1' in prom
    kinds = {r.get("kind") for r in rows if r.get("event") == "elastic"}
    assert {"spawn", "failure", "teardown", "success"} <= kinds


def test_supervisor_metrics_port_serves_elastic_gauges(tmp_path):
    """``metrics_port`` runs the port's exporter over the supervisor's
    Reporter while the job runs; it is stopped with the job."""
    sup = ElasticSupervisor(
        _config(tmp_path, "crash_once", metrics_port=0))
    report = sup.run()
    assert report["status"] == "ok"
    assert sup.metrics_url and sup.metrics_url.startswith("http://")
    assert sup._exporter is None


def test_fabric_surface_refuses_when_not_running(tmp_path):
    sup = ElasticSupervisor(_config(tmp_path, "ok", nproc=2))
    sup.set_lease_tag("lease-7")
    assert sup.lease_tag == "lease-7"
    assert sup.request_world(1) is False
    assert sup.yield_ranks(1) is False and sup.grant_ranks(1) is False


def test_postmortem_file_tolerates_torn_tail(tmp_path):
    pm = tmp_path / "postmortem.jsonl"
    row = json.dumps({"event": "crash", "rank": 0, "step": 1, "exc": "X",
                      "traceback": "tb", "t": 0.0, "size": 1})
    pm.write_text(row + "\n" + row[: len(row) // 2])
    from chainermn_tpu_torch.observability.step_log import read_records

    rows = read_records(str(pm))
    assert len(rows) == 1 and rows[0]["rank"] == 0


# ---------------------------------------------------------------------------
# parity: both packages' supervisors over the same schedules
# ---------------------------------------------------------------------------

_PARITY = [
    ("crash_once", 1, {}),
    ("preempt_once", 1, {}),
    ("crash_rank1_once", 2, {"rescale_on_failure": True, "min_nproc": 1}),
]
_REPORT_KEYS = ("status", "restarts", "preemptions", "incarnations",
                "resume_generation", "world", "nproc")


@pytest.mark.parametrize("mode,nproc,kw", _PARITY,
                         ids=[m for m, _, _ in _PARITY])
def test_supervisor_parity_with_reference(tmp_path, mode, nproc, kw):
    from chainermn_tpu.elastic import ElasticSupervisor as RefSupervisor
    from chainermn_tpu.elastic import SupervisorConfig as RefConfig
    from chainermn_tpu.observability.step_log import read_records as rrr
    from chainermn_tpu.tools.obs import summarize as ref_summarize

    from chainermn_tpu_torch.observability.step_log import read_records
    from chainermn_tpu_torch.tools.obs import summarize

    out = {}
    for name, sup_cls, cfg_cls, read, summ in (
            ("ref", RefSupervisor, RefConfig, rrr, ref_summarize),
            ("port", ElasticSupervisor, SupervisorConfig, read_records,
             summarize)):
        log = tmp_path / f"{name}.jsonl"
        fields = _fields(tmp_path / name, mode, nproc, step_log=str(log),
                         **kw)
        sup = sup_cls(cfg_cls(**fields))
        report = sup.run()
        rows = read(str(log))
        out[name] = (report, summ(rows)["counters"],
                     sorted(e["kind"] for e in sup.events))
    ref, port = out["ref"], out["port"]
    assert {k: port[0][k] for k in _REPORT_KEYS} == \
        {k: ref[0][k] for k in _REPORT_KEYS}
    elastic = {k: v for k, v in ref[1].items() if k.startswith("elastic/")}
    assert elastic and {k: port[1][k] for k in elastic} == elastic
    assert port[2] == ref[2]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _cli(tmp_path, *args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "chainermn_tpu_torch.tools.elastic", *args],
        capture_output=True, text=True, env=_env(), timeout=timeout,
        cwd=str(tmp_path))


def test_cli_smoke(tmp_path):
    res = _cli(tmp_path, "--nproc", "1", "--max-restarts", "0", "--no-echo",
               "--workdir", str(tmp_path / "sup"), "--", sys.executable,
               "-c", "print('hello from the rank')")
    assert res.returncode == 0, res.stdout + res.stderr
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("ELASTIC_REPORT ")]
    assert len(line) == 1 and res.stdout.splitlines()[-1] == line[0]
    report = json.loads(line[0].split(" ", 1)[1])
    assert report["status"] == "ok"
    assert report["nproc"] == 1


def test_cli_failed_job_exits_nonzero(tmp_path):
    res = _cli(tmp_path, "--nproc", "1", "--max-restarts", "0", "--no-echo",
               "--workdir", str(tmp_path / "sup"), "--", sys.executable,
               _DUMMY, "crash_always")
    assert res.returncode == 1, res.stdout + res.stderr
    report = json.loads(res.stdout.splitlines()[-1].split(" ", 1)[1])
    assert report["status"] == "failed" and report["restarts"] == 1


def test_cli_rejects_bad_chaos_schedule(tmp_path):
    res = _cli(tmp_path, "--nproc", "1", "--chaos", "explode:rank=0:step=1",
               "--workdir", str(tmp_path / "sup"), "--", sys.executable,
               "-c", "print('never runs')")
    assert res.returncode != 0
    assert "never runs" not in res.stdout


def test_cli_requires_command(tmp_path):
    res = _cli(tmp_path, "--nproc", "1")
    assert res.returncode == 2  # argparse usage error


def test_supervisor_imports_no_torch():
    code = ("import sys, chainermn_tpu_torch.tools.elastic, "
            "chainermn_tpu_torch.elastic\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=60)
    assert res.returncode == 0, res.stderr
    assert EXIT_PREEMPTED == 75


# ---------------------------------------------------------------------------
# ElasticContext.reshard
# ---------------------------------------------------------------------------

def _restored():
    import torch

    from chainermn_tpu_torch import create_communicator

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 6), torch.nn.ReLU(),
                                torch.nn.Linear(6, 2))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.ones(3, 4)).sum().backward()
    opt.step()
    return create_communicator("naive", device="cpu"), model, opt


@pytest.mark.parametrize("plan,params_sharded,moments_sharded", [
    ("dp", False, False), ("zero", False, True), ("fsdp", True, True)])
def test_reshard_places_through_the_plan(plan, params_sharded,
                                         moments_sharded):
    """A replicated spec leaves a plain tensor on the rank's device; a
    sharded one becomes a DTensor at the plan's placements, parameters
    and moments each by its own rules (one gloo rank: a world of 1)."""
    from torch.distributed.tensor import DTensor, Shard

    from chainermn_tpu_torch.elastic import ElasticContext

    comm, model, opt = _restored()
    values = [p.detach().clone() for p in model.parameters()]
    ctx = ElasticContext(0, 1, "127.0.0.1:1", 0, None, None)
    out, state, report = ctx.reshard(model, opt, comm, plan=plan)
    assert out is model and state is opt and report.ok
    assert report.n_leaves == 4 and report.n_sharded == (
        2 if plan == "fsdp" else 0)
    for (name, p), v in zip(model.named_parameters(), values):
        sharded = params_sharded and name.endswith("weight")
        assert isinstance(p.data, DTensor) == sharded, name
        if sharded:
            assert p.placements == (Shard(0),)
        assert torch_equal(p, v)
    assert [p for g in opt.param_groups for p in g["params"]] == \
        list(model.parameters())
    for p in model.parameters():
        buf = opt.state[p]["momentum_buffer"]
        sharded = moments_sharded and p.dim() == 2
        assert isinstance(buf, DTensor) == sharded


def torch_equal(a, b):
    full = a.full_tensor() if hasattr(a, "full_tensor") else a
    return bool((full.detach() == b).all())


def test_reshard_validates_only_and_refuses_uncovered_state():
    from chainermn_tpu_torch.elastic import ElasticContext

    comm, model, opt = _restored()
    ctx = ElasticContext(0, 1, "127.0.0.1:1", 0, None, None)
    before = [id(p) for p in model.parameters()]
    _, _, report = ctx.reshard(model, opt, comm, plan="fsdp", place=False)
    assert report.ok and report.n_sharded == 2
    assert [id(p) for p in model.parameters()] == before
    with pytest.raises(ValueError, match="pass the DeviceMesh"):
        ctx.reshard(model, opt, comm, plan="dp_tp")
    with pytest.raises(ValueError, match="does not cover"):
        ctx.reshard({"weight": __import__("torch").ones(3, 5)}, None, comm,
                    plan="fsdp", mesh={"data": 2})
