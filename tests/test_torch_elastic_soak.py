"""The elastic soaks of ``tests/test_multiprocess.py`` on the port: the
supervisor CLI (``chainermn_tpu_torch.tools.elastic``) around real gloo
ranks of the port's MNIST example (``_torch_elastic_train_worker.py``), at
a small size.

Every step's global batch is the whole training set (``--train-size`` =
``--batchsize``), so a step computes the same sums at any world size: a
respawned world is bitwise its unfaulted twin, and a rescaled one stays on
its loss curve up to summation order — the reference soak's contract.
The ImageNet example's preemption (BatchNorm, momentum, the warm-up
schedule) is held bitwise too.  Each supervised job is bounded at 60 s.
"""

import json
import os
import re
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(os.path.dirname(__file__),
                       "_torch_elastic_train_worker.py")
# 8 one-step epochs of a 16-image set, 16-unit MLP, a checkpoint a step.
_MNIST = ["--device", "cpu", "--communicator", "naive", "--unit", "16",
          "--train-size", "16", "--batchsize", "16", "--val-size", "16",
          "--epochs", "8", "--checkpoint-every", "1"]
_JOIN_S = 60


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO
                + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _rank_cmd(ckpt, step_log=None):
    cmd = [sys.executable, _WORKER, *_MNIST, "--elastic",
           "--checkpoint-dir", str(ckpt)]
    if step_log is not None:
        cmd += ["--step-log", str(step_log)]
    return cmd


def _run_elastic(tmp, nproc, *extra, sup_log=None):
    """One supervised job.  Returns (proc, stdout, report, rank-0 losses
    by step from the ranks' step log, the last row of a step winning)."""
    rank_log = tmp / "ranks.jsonl"
    cmd = [sys.executable, "-m", "chainermn_tpu_torch.tools.elastic",
           "--nproc", str(nproc), "--workdir", str(tmp / "work"),
           "--hb-timeout", "30", "--grace", "5"]
    if sup_log is not None:
        cmd += ["--step-log", str(sup_log)]
    cmd += [*extra, "--", *_rank_cmd(tmp / "ckpt", rank_log)]
    try:
        p = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True, env=_env(),
                           timeout=_JOIN_S)
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"supervisor timed out:\n{e.stdout}")
    reports = [ln for ln in p.stdout.splitlines()
               if ln.startswith("ELASTIC_REPORT ")]
    assert reports, p.stdout
    from chainermn_tpu_torch.observability.step_log import read_records

    losses = {r["step"]: r["loss"] for r in read_records(str(rank_log))
              if r.get("event") == "step" and r.get("rank") == 0}
    return p, p.stdout, json.loads(reports[-1].split(" ", 1)[1]), losses


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The uninterrupted 2-rank supervised run."""
    tmp = tmp_path_factory.mktemp("elastic_oracle")
    p, out, report, losses = _run_elastic(tmp, 2)
    assert p.returncode == 0, out
    assert report["status"] == "ok" and report["incarnations"] == 1, report
    assert report["params_digest"], report
    assert sorted(losses) == list(range(8)), losses
    return {"digest": report["params_digest"], "losses": losses}


def test_supervised_kill9_digest_equals_unfaulted(tmp_path, oracle):
    """SIGKILL one rank mid-run: the supervisor tears the survivor down,
    respawns the world, and the resumed run's parameters are bitwise the
    unfaulted run's; the elastic/* counters reach tools.obs."""
    log = tmp_path / "sup.jsonl"
    p, out, report, _ = _run_elastic(
        tmp_path, 2, "--chaos", "kill:rank=1:step=5", sup_log=log)
    assert p.returncode == 0, out
    assert report["status"] == "ok", report
    assert report["restarts"] >= 1, report
    assert report["resume_generation"] is not None, report
    assert "chaos: SIGKILL" in out
    assert report["params_digest"] == oracle["digest"], (report, out)

    from chainermn_tpu_torch.observability.step_log import read_records
    from chainermn_tpu_torch.tools.obs import summarize, to_prometheus

    summary = summarize(read_records(str(log)))
    assert summary["counters"]["elastic/restarts"] >= 1, summary
    assert summary["counters"]["elastic/resume_generation"] >= 1, summary
    assert summary["counters"]["elastic/preemptions"] == 0, summary
    prom = to_prometheus(summary)
    assert 'counter_total{name="elastic/restarts"}' in prom, prom


def test_supervised_rescale_2_to_1_stays_on_curve(tmp_path, oracle):
    """Kill a rank with --rescale-on-failure: the world restarts at 1, the
    restored state is re-placed through plan ``dp`` (validated on the new
    world), and every loss stays within 2e-3 of the 2-rank run's."""
    p, out, report, losses = _run_elastic(
        tmp_path, 2, "--rescale-on-failure", "--min-nproc", "1",
        "--chaos", "kill:rank=1:step=4")
    assert p.returncode == 0, out
    assert report["status"] == "ok", report
    assert report["world"] == 1 and report["restarts"] >= 1, report
    assert "elastic_reshard plan=dp ok=True" in out, out
    assert "world=1" in out, out
    assert sorted(losses) == list(range(8)), losses
    for g, loss in losses.items():
        want = oracle["losses"][g]
        assert abs(loss - want) <= 2e-3 * max(1.0, abs(want)), (g, loss, want)


def test_supervised_preemption_checkpoints_and_resumes(tmp_path, oracle):
    """SIGTERM is a preemption: the grace-window checkpoint on every rank,
    the preemption exit (counted apart from restarts), and a resumed run
    bitwise the unfaulted one."""
    log = tmp_path / "sup.jsonl"
    p, out, report, _ = _run_elastic(
        tmp_path, 2, "--chaos", "term:rank=0:step=6", sup_log=log)
    assert p.returncode == 0, out
    assert report["status"] == "ok", report
    assert report["preemptions"] >= 1 and report["restarts"] == 0, report
    assert "preempted: checkpoint saved at iteration 6" in out, out
    assert report["resume_generation"] == 6, report
    assert report["params_digest"] == oracle["digest"], report

    from chainermn_tpu_torch.observability.step_log import read_records
    from chainermn_tpu_torch.tools.obs import summarize

    counters = summarize(read_records(str(log)))["counters"]
    assert counters["elastic/preemptions"] == 1, counters
    assert counters["elastic/restarts"] == 0, counters
    assert counters["elastic/resume_generation"] == 6, counters


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_world(tmp, nproc, chaos=None):
    """Both ranks with the supervisor's environment, started here (no
    supervisor): returns each rank's (exit code, output)."""
    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    for r in range(nproc):
        env = _env()
        env.update(CHAINERMN_TPU_ELASTIC="1",
                   CHAINERMN_TPU_ELASTIC_RANK=str(r),
                   CHAINERMN_TPU_ELASTIC_NPROC=str(nproc),
                   CHAINERMN_TPU_ELASTIC_COORD=coord,
                   CHAINERMN_TPU_ELASTIC_INCARNATION="0",
                   CHAINERMN_TPU_BARRIER_TIMEOUT_S="30")
        env.pop("CHAINERMN_TPU_CHAOS", None)
        if chaos:
            env["CHAINERMN_TPU_CHAOS"] = chaos
        procs.append(subprocess.Popen(
            _rank_cmd(tmp / "ckpt"), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=_JOIN_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("ranks timed out:\n" + "\n".join(outs))
    return [p.returncode for p in procs], outs


def test_kill9_both_ranks_then_relaunch_resumes_bitwise(tmp_path, oracle):
    """Both ranks SIGKILL themselves at step 6 with no supervisor; the
    same command relaunched resumes from a saved generation and ends
    bitwise equal to the uninterrupted run."""
    codes, outs = _launch_world(tmp_path, 2, chaos="kill:step=6")
    assert -9 in codes, (codes, outs)
    assert all(c != 0 for c in codes), (codes, outs)
    codes, outs = _launch_world(tmp_path, 2)
    assert codes == [0, 0], outs
    m = re.search(r"resumed from iteration (\d+)", outs[0])
    assert m and 1 <= int(m.group(1)) <= 6, outs[0]
    digest = re.search(r"params_digest ([0-9a-f]{8})", outs[0]).group(1)
    assert digest == oracle["digest"]


def test_supervised_imagenet_preemption_resumes_bitwise(tmp_path):
    """The ImageNet example (ResNet-18 with BatchNorm, SGD with momentum,
    the warm-up schedule, the prefetch thread) under the supervisor,
    SIGTERMed at step 2: the grace-window checkpoint, the preemption exit,
    and a resumed run bitwise the unfaulted one's (run here on one
    thread, as the supervised rank runs)."""
    import torch

    from chainermn_tpu_torch.examples import train_imagenet

    args = ["--device", "cpu", "--communicator", "naive", "--arch",
            "resnet18", "--batchsize", "8", "--image-size", "32",
            "--num-classes", "10", "--train-size", "16", "--val-size", "8",
            "--steps", "2", "--epochs", "2", "--elastic",
            "--checkpoint-every", "2"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        clean = train_imagenet.main(args + ["--checkpoint-dir",
                                            str(tmp_path / "ck_clean")])
    finally:
        torch.set_num_threads(threads)
    cmd = [sys.executable, "-m", "chainermn_tpu_torch.tools.elastic",
           "--nproc", "1", "--workdir", str(tmp_path / "work"), "--chaos",
           "term:rank=0:step=2", "--", sys.executable, "-m",
           "chainermn_tpu_torch.examples.train_imagenet", *args,
           "--checkpoint-dir", str(tmp_path / "ck_term")]
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True, env=_env(), timeout=_JOIN_S)
    assert p.returncode == 0, p.stdout
    out = p.stdout
    term = json.loads(out.splitlines()[-1].split(" ", 1)[1])
    assert term["preemptions"] == 1 and term["restarts"] == 0, term
    assert term["resume_generation"] == 2, term
    assert "preempted: checkpoint saved at iteration 2" in out, out
    assert "elastic_reshard plan=dp ok=True" in out, out
    assert term["params_digest"] == clean["params_digest"], (term, clean)
