"""The port's linter (``chainermn_tpu_torch.analysis``, ``tools.lint``,
the runtime hook) against the reference's (``chainermn_tpu.analysis``).

Held to the reference in this process wherever both run: the rule
registry (ids, names, one-line summaries — R005's reads an update in
place where the reference's reads buffer donation, ROADMAP §C), the
``summary()`` JSON layout, the suppression surfaces
(``tests/test_analysis.py``'s contract).  Every fixture at two gloo ranks
(``tests/_torch_lint_worker.py``, one spawn joined under 60 s) flags the
rules of the reference's ``tests/golden/lint_fixtures.json`` for its name;
the clean gate is clean on the five communicators; a step whose ranks
diverge is linted without a hang; the 64-leaf census matches
``tests/golden/allreduce_census_64leaf.json``; the LM's taint crosses the
flash custom ops.  A capture restores every tensor and RNG state bitwise.

Golden regen (the CLI's view at two gloo ranks)::

    python tests/test_torch_analysis.py --regen
"""

import json
import multiprocessing as mp
import os
import subprocess
import sys
import warnings

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:       # run as a script (--regen)
    sys.path.insert(0, REPO)

import _torch_lint_worker as lw  # noqa: E402
GOLDEN = os.path.join(REPO, "tests", "golden", "torch_lint_fixtures.json")
REF_GOLDEN = os.path.join(REPO, "tests", "golden", "lint_fixtures.json")
CENSUS_GOLDEN = os.path.join(REPO, "tests", "golden",
                             "allreduce_census_64leaf.json")
JOIN_TIMEOUT_S = 60


def _flagged(report):
    return sorted({f.rule for f in report.findings})


def _golden_view(payload):
    return {t["target"]: sorted({f["rule"] for f in t["findings"]})
            for t in payload["targets"]}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, os.path.join(REPO, "tests"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


def _cli(*args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "chainermn_tpu_torch.tools.lint", *args],
        capture_output=True, text=True, timeout=timeout, env=_env(),
        cwd=REPO)


# ----------------------------------------------------------------------
# Two gloo ranks: one spawn for every rank case
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lint2")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=lw.run,
                         args=(r, 2, str(tmp / "rendezvous"), str(tmp)))
             for r in range(2)]
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
            for r in range(2)]


def _ref_golden():
    with open(REF_GOLDEN) as f:
        return json.load(f)["flagged_rules"]


def _local_report(name):
    from chainermn_tpu_torch.analysis.fixtures import FIXTURES
    from chainermn_tpu_torch.tools.lint import _lint_one

    return _lint_one(FIXTURES[name](), None, None)


def _fixture_names():
    from chainermn_tpu_torch.analysis.fixtures import FIXTURES

    return sorted(FIXTURES)


@pytest.mark.parametrize("name", _fixture_names())
def test_fixture_flags_the_reference_golden(two, name):
    """The union over both ranks (r001: rank 0 alone all-reduces, so the
    other rank applies unreduced gradients) flags the reference golden's
    rules for the fixture of the same name."""
    from chainermn_tpu_torch.analysis.fixtures import LOCAL_FIXTURES

    want = _ref_golden()[name]
    if name in LOCAL_FIXTURES:
        got = sorted({f["rule"] for f in _local_report(name)["findings"]})
    else:
        got = sorted(set(two[0]["fixtures"][name]["rules"])
                     | set(two[1]["fixtures"][name]["rules"]))
    assert got == want, (name, got, want)


def test_port_golden_matches_reference_golden():
    with open(GOLDEN) as f:
        port = json.load(f)["flagged_rules"]
    assert port == _ref_golden()


def test_clean_gate_on_every_communicator(two):
    for rank in two:
        for name, res in rank["clean"].items():
            assert res["ok"] and res["rules"] == [], (name, res)
            # all five device-plane rules ran: a clean pass by skipping is
            # no pass
            assert res["rules_run"] == ["R001", "R002", "R003", "R004",
                                        "R005"], (name, res)
            assert res["events"] >= 2, (name, res)   # a bucket + the loss


def test_diverging_ranks_are_linted_without_a_hang(two):
    for rank in two:
        assert rank["diverge"]["rules"] == ["R001"], rank["diverge"]
    assert [r["diverge"]["events"] for r in two] == [1, 3]


def test_census_of_the_64_leaf_tree_matches_the_golden(two):
    """Explicit reductions of ``allreduce_grad`` over the reference's
    64-leaf tree at 256 KiB buckets: one all-reduce a bucket, as the
    golden's bucketed count (no fixed offset: the golden audits
    ``allreduce_grad`` alone, without the train step's loss mean)."""
    with open(CENSUS_GOLDEN) as f:
        golden = json.load(f)
    assert golden["bucket_bytes"] == lw.BUCKET_BYTES
    for name in lw.CENSUS_COMMUNICATORS:
        want = golden["communicators"][name]["bucketed"][
            "reduction_collectives"]
        for rank in two:
            got = rank["census"][name]
            assert got["reduction_collectives"] == want, (name, got)
            assert got["census"] == {"c10d.allreduce_": want}


def test_r002_through_the_flash_custom_ops(two):
    """The LM step on the flash kernels' CPU route: R002 fires when the
    gradients are never averaged and is silent when they are; the batch's
    taint crosses every attention layer's custom ops."""
    for rank in two:
        assert rank["lm"]["reduced"]["rules"] == []
        assert rank["lm"]["skip"]["rules"] == ["R002"]
        flash = rank["lm"]["reduced"]["flash"]
        assert sorted(flash) == ["chainermn_torch.flash_dkv",
                                 "chainermn_torch.flash_dq",
                                 "chainermn_torch.flash_fwd"]
        for name, taints in flash.items():
            assert len(taints) == lw.LM["n_layers"], (name, taints)
            assert all("intra" in t for t in taints), (name, taints)


# ----------------------------------------------------------------------
# The registry and the report against the reference's
# ----------------------------------------------------------------------
def test_list_rules_ids_names_and_summaries_equal_the_reference():
    import chainermn_tpu.analysis as ref
    import chainermn_tpu_torch.analysis as port

    mine, theirs = port.list_rules(), ref.list_rules()
    assert [r[:2] for r in mine] == [r[:2] for r in theirs]
    for a, b in zip(mine, theirs):
        if a[0] == "R005":   # an update in place, not donation (§C)
            assert a[2] != b[2]
        else:
            assert a[2] == b[2], a[0]


def test_summary_json_keys_equal_the_reference():
    import chainermn_tpu.analysis as ref
    from chainermn_tpu.analysis.fixtures import FIXTURES as REF_FIXTURES

    t = REF_FIXTURES["r006"]()
    theirs = ref.analyze_plan(t["plan"], t["params"])
    mine = _local_report("r006")
    assert set(mine) - {"target", "expect"} == set(theirs.summary())
    assert set(mine["findings"][0]) == set(theirs.findings[0].summary())
    assert mine["rules_run"] == list(theirs.rules_run) == ["R006"]
    assert mine["rules_skipped"] == list(theirs.rules_skipped)


def test_findings_are_structured():
    rep = _analyze("r003_bare_int8")
    f = next(f for f in rep.findings if f.rule == "R003")
    assert f.axes and f.bytes > 0 and "int8" in f.message
    assert "amax" in f.message and "comm_dtype" in f.fix_hint
    assert set(f.summary()) == {"rule", "severity", "message", "eqn_path",
                                "axes", "bytes", "fix_hint"}


# ----------------------------------------------------------------------
# One rank in this process: the library surface and suppression
# ----------------------------------------------------------------------
def _analyze(name, **kw):
    from chainermn_tpu_torch.analysis import analyze_fn
    from chainermn_tpu_torch.analysis.fixtures import FIXTURES

    t = FIXTURES[name]()
    return analyze_fn(t["fn"], *t["args"], comm=t["comm"],
                      state=t.get("state", ()), **kw)


def test_r005_fires_at_one_rank_and_other_rules_stay_clean():
    rep = _analyze("r005")
    assert _flagged(rep) == ["R005"] and not rep.ok
    f = rep.findings[0]
    assert f.bytes == 16 * 32 * 32 * 4 and f.fix_hint


def test_assert_lint_clean_raises_with_report():
    from chainermn_tpu_torch.analysis import LintError, assert_lint_clean
    from chainermn_tpu_torch.analysis.fixtures import FIXTURES

    t = FIXTURES["r005"]()
    with pytest.raises(LintError) as ei:
        assert_lint_clean(t["fn"], *t["args"], comm=t["comm"],
                          state=t["state"])
    assert "R005" in str(ei.value) and "R005" in _flagged(ei.value.report)


def test_disable_kwarg_suppresses():
    rep = _analyze("r005", disable=("R005",))
    assert rep.ok and rep.suppressed == 1


def test_env_disable_suppresses(monkeypatch):
    from chainermn_tpu_torch.analysis import ENV_DISABLE

    monkeypatch.setenv(ENV_DISABLE, "R005")
    assert _analyze("r005").ok


def test_source_comment_suppresses():
    from chainermn_tpu_torch.analysis import analyze_fn
    from chainermn_tpu_torch.analysis.fixtures import FIXTURES

    t = FIXTURES["r003_bare_int8"]()
    inner = t["fn"]

    def blessed(tree):  # lint: disable=R003
        return inner(tree)

    assert not analyze_fn(inner, *t["args"], comm=t["comm"]).ok
    rep = analyze_fn(blessed, *t["args"], comm=t["comm"])
    assert rep.ok and rep.suppressed == 1


def test_rules_allowlist_scopes_the_run():
    rep = _analyze("r005", rules=["R001", "R003"])
    assert rep.ok and set(rep.rules_run) == {"R001", "R003"}


def test_unknown_rule_id_errors():
    from chainermn_tpu_torch.analysis import analyze_fn

    with pytest.raises(ValueError, match="R999"):
        analyze_fn(lambda x: x, torch.ones(()), rules=["R999"])


def test_register_rule_extension_point():
    from chainermn_tpu_torch.analysis import (Finding, analyze_fn,
                                              register_rule)
    from chainermn_tpu_torch.analysis.core import RULES

    @register_rule("X901", "always-fires", "test-only rule")
    def check_x901(ctx):
        return [Finding(rule="X901", severity="warning", message="hi")]

    try:
        rep = analyze_fn(lambda x: x + 1, torch.ones(2), rules=["X901"])
        assert [f.rule for f in rep.findings] == ["X901"]
        assert rep.ok   # warnings do not fail the gate
    finally:
        del RULES["X901"]


def test_analyze_program_accepts_a_bare_census():
    """A bare census runs the census rules (R004); the op-stream rules
    land in rules_skipped instead of erroring."""
    from chainermn_tpu_torch.analysis import analyze_program
    from chainermn_tpu_torch.analysis.capture import (CollectiveCensus,
                                                      CollectiveEvent)

    ev = CollectiveEvent(path="op[0] c10d.allreduce_",
                         name="c10d.allreduce_", group=(0, 1),
                         dtype="float32", shape=(4,), bytes=16,
                         kind="all_reduce", reduce_op="SUM")
    rep = analyze_program(CollectiveCensus([ev] * 16), n_leaves=16)
    assert _flagged(rep) == ["R004"]
    assert "R002" in rep.rules_skipped and "R004" in rep.rules_run
    assert analyze_program(CollectiveCensus([ev] * 4), n_leaves=16).ok


def test_unknown_collective_raises_and_is_not_run(monkeypatch):
    """A c10d op the capture does not know is refused, never run on the
    caller's group."""
    import torch.distributed as dist

    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.analysis import CaptureError, capture, \
        capture_step

    comm = create_communicator("naive", device="cpu")
    known = dict(capture._C10D)
    del known["allreduce_"]
    monkeypatch.setattr(capture, "_C10D", known)
    x = torch.ones(4)
    with pytest.raises(CaptureError, match="allreduce_"):
        capture_step(lambda t: dist.all_reduce(t * 3, group=comm.group), x)


def test_capture_restores_every_tensor_and_rng_state_bitwise():
    """A capture after a real step (AdamW moments and gradients exist)
    leaves parameters, gradients, moments, counts, the CPU RNG and every
    storage as they were."""
    step, opt, batch, comm = lw.lm_step(skip_allreduce=False, seed=1)
    step(batch)                                  # moments now exist
    for p in opt.params:
        p.grad = torch.randn_like(p)
    model_ps = opt.params
    snap = {
        "p": [p.detach().clone() for p in model_ps],
        "g": [p.grad.clone() for p in model_ps],
        "ptr": [p.data_ptr() for p in model_ps],
        "gptr": [p.grad.data_ptr() for p in model_ps],
        "m": [{k: v.clone() for k, v in st.items()
               if isinstance(v, torch.Tensor)}
              for st in opt.actual_optimizer.state.values()],
        "mptr": [{k: v.data_ptr() for k, v in st.items()
                  if isinstance(v, torch.Tensor)}
                 for st in opt.actual_optimizer.state.values()],
    }
    counts = (opt.step_count, opt.update_count)
    torch.manual_seed(123)
    rng = torch.get_rng_state()
    from chainermn_tpu_torch.analysis import capture_step

    prog = capture_step(step, batch, comm=comm, state=opt)
    assert prog.snapshot_bytes >= sum(4 * p.numel() for p in model_ps) * 4
    assert torch.equal(torch.get_rng_state(), rng)
    assert (opt.step_count, opt.update_count) == counts
    for i, p in enumerate(model_ps):
        assert torch.equal(p.detach(), snap["p"][i])
        assert torch.equal(p.grad, snap["g"][i])
        assert p.data_ptr() == snap["ptr"][i]
        assert p.grad.data_ptr() == snap["gptr"][i]
    states = list(opt.actual_optimizer.state.values())
    assert len(states) == len(snap["m"])
    for st, want, ptrs in zip(states, snap["m"], snap["mptr"]):
        for k, v in want.items():
            assert torch.equal(st[k], v) and st[k].data_ptr() == ptrs[k]


def test_capture_frees_the_steps_tensors_without_the_collector(
        monkeypatch):
    """The gradients and moments the captured step made are freed when
    the capture returns, not at the next garbage collection (a reference
    cycle held them, and the steps after a linted first call carried a
    second copy of them on the card)."""
    import gc
    import weakref

    from chainermn_tpu_torch.analysis import capture

    step, opt, batch, comm = lw.lm_step(skip_allreduce=False, seed=4)
    made = []
    after = capture._after_refs

    def spy(snap, state):
        out = after(snap, state)
        made.extend(weakref.ref(t) for kind, _, t in out if kind == "opt")
        made.extend(weakref.ref(p.grad) for p in opt.params)
        return out

    monkeypatch.setattr(capture, "_after_refs", spy)
    gc.collect()
    gc.disable()
    try:
        capture.capture_step(step, batch, comm=comm, state=opt)
        alive = sum(r() is not None for r in made)
    finally:
        gc.enable()
    assert len(made) > 2 * len(opt.params) and alive == 0, (alive,
                                                            len(made))


def test_capture_of_the_first_step_leaves_no_optimizer_state():
    step, opt, batch, comm = lw.lm_step(skip_allreduce=False, seed=2)
    from chainermn_tpu_torch.analysis import capture_step

    before = [p.detach().clone() for p in opt.params]
    prog = capture_step(step, batch, comm=comm, state=opt)
    assert len(opt.actual_optimizer.state) == 0
    assert all(p.grad is None for p in opt.params)
    assert all(torch.equal(a, p.detach())
               for a, p in zip(before, opt.params))
    assert prog.launches == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    counts = prog.op_counts()
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        assert counts[f"chainermn_torch.{name}"] == lw.LM["n_layers"]


# ----------------------------------------------------------------------
# The runtime hook (CHAINERMN_TPU_LINT)
# ----------------------------------------------------------------------
class _RebindingSGD(torch.optim.Optimizer):
    """Plain SGD that rebinds ``p.data`` (the R005 violation)."""

    def __init__(self, params, lr=0.1):
        super().__init__(params, {"lr": lr})

    @torch.no_grad()
    def step(self):
        for g in self.param_groups:
            for p in g["params"]:
                p.data = p.data - g["lr"] * p.grad


def _tiny_step(rebind):
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.analysis.fixtures import _Leafy

    comm = create_communicator("naive", device="cpu")
    model = _Leafy(4, (8, 8))
    inner = (_RebindingSGD if rebind else torch.optim.SGD)(
        model.parameters(), lr=0.1)
    opt = create_multi_node_optimizer(inner, comm)
    opt.init()
    return opt.make_train_step(model.loss), model, torch.ones(2, 4)


def test_runtime_hook_strict_raises(monkeypatch):
    from chainermn_tpu_torch.analysis import LintError

    monkeypatch.setenv("CHAINERMN_TPU_LINT", "strict")
    step, _, batch = _tiny_step(rebind=True)
    with pytest.raises(LintError, match="R005"):
        step(batch)


def test_runtime_hook_warns_once_and_reports(monkeypatch, tmp_path):
    from chainermn_tpu_torch.observability import Reporter, recording, scope

    monkeypatch.setenv("CHAINERMN_TPU_LINT", "1")
    step, _, batch = _tiny_step(rebind=True)
    log = tmp_path / "steps.jsonl"
    rep = Reporter()
    with scope(rep), recording(str(log)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step(batch)
            step(batch)   # second call: the hook is done
    msgs = [str(w.message) for w in caught]
    assert sum("R005" in m for m in msgs) == 1, msgs
    counters = rep.summary()["counters"]
    assert counters["lint/errors"] >= 1 and counters["lint/findings"] >= 1
    assert counters["train_step_calls"] == 2   # the capture is not a call
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    lint_rows = [r for r in rows if r.get("event") == "lint"]
    assert len(lint_rows) == 1
    assert lint_rows[0]["findings"][0]["rule"] == "R005"


def test_runtime_hook_off_by_default(monkeypatch):
    monkeypatch.delenv("CHAINERMN_TPU_LINT", raising=False)
    step, _, batch = _tiny_step(rebind=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step(batch)
    assert not any("R005" in str(w.message) for w in caught)


def test_runtime_hook_clean_step_silent(monkeypatch):
    monkeypatch.setenv("CHAINERMN_TPU_LINT", "strict")
    step, _, batch = _tiny_step(rebind=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        loss = step(batch)
    assert torch.isfinite(loss)
    assert not any("LINT" in str(w.message) for w in caught)


@pytest.mark.parametrize("with_state", [False, True])
def test_runtime_hook_keeps_losses_bitwise(monkeypatch, with_state):
    """Three LM steps with the hook on give the losses and parameters of
    three steps with it off: the capture of the first call leaves no
    trace (``make_train_step`` and ``make_train_step_with_state``)."""
    def run(mode):
        if mode is None:
            monkeypatch.delenv("CHAINERMN_TPU_LINT", raising=False)
        else:
            monkeypatch.setenv("CHAINERMN_TPU_LINT", mode)
        opt, loss_fn, model, batch, comm = lw.lm_setup(False, seed=3)
        step = (opt.make_train_step_with_state(loss_fn, model) if with_state
                else opt.make_train_step(loss_fn))
        losses = [step(batch).item() for _ in range(3)]
        return losses, [p.detach().clone() for p in opt.params]

    off, p_off = run(None)
    on, p_on = run("strict")
    assert on == off
    assert all(torch.equal(a, b) for a, b in zip(p_on, p_off))


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------
def test_cli_list_rules_json(capsys):
    from chainermn_tpu_torch.tools import lint as cli

    assert cli.main(["--list-rules", "--format", "json"]) == 0
    data = json.loads(capsys.readouterr().out)
    assert [r["id"] for r in data["rules"]] == [
        "H001", "H002", "H003", "H004", "H005",
        "R001", "R002", "R003", "R004", "R005", "R006",
    ]


def test_cli_rules_filter_and_exit_zero(capsys):
    from chainermn_tpu_torch.tools import lint as cli

    # r005's fixture is clean under every OTHER rule.
    rc = cli.main(["--fixtures", "r005", "--rules", "R001", "--device",
                   "cpu", "--world", "1", "--format", "json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0 and payload["ok"] is True
    rc = cli.main(["--fixtures", "r005", "--device", "cpu", "--world", "1",
                   "--format", "json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1 and _golden_view(payload) == {"r005": ["R005"]}


def test_cli_fixtures_json_matches_the_port_golden():
    """The CLI as a user runs it: two gloo ranks, rank findings merged."""
    proc = _cli("--fixtures", "--device", "cpu", "--world", "2",
                "--format", "json")
    assert proc.returncode == 1, proc.stderr[-2000:]
    payload = json.loads(proc.stdout)
    assert payload["ok"] is False
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert _golden_view(payload) == golden["flagged_rules"], (
        f"regenerate with: python {__file__} --regen")


def test_cli_clean_gate_on_a_two_by_two_topology():
    """Four gloo ranks as 2 nodes x 2: ``hierarchical`` reduces to each
    node's leader, all-reduces over the leaders and broadcasts back, so
    R002 must take each broadcast's taint from its root (exchanged over
    the object plane); ``two_dimensional`` reduce-scatters, all-reduces
    and all-gathers.  Both lint clean."""
    proc = _cli("--device", "cpu", "--world", "4", "--communicators",
                "hierarchical,two_dimensional", "--format", "json")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    payload = json.loads(proc.stdout)
    assert [t["target"] for t in payload["targets"]] == [
        "clean:hierarchical", "clean:two_dimensional"]
    assert all(t["ok"] and t["findings"] == [] for t in payload["targets"])


def test_cli_entry_point_subprocess():
    proc = _cli("--entry", "_torch_lint_worker:lint_target", "--device",
                "cpu", "--world", "2", "--format", "json")
    assert proc.returncode == 1, proc.stderr[-2000:]
    payload = json.loads(proc.stdout)
    assert _golden_view(payload) == {
        "_torch_lint_worker:lint_target": ["R002"]}


def test_cli_self_check_is_clean():
    from chainermn_tpu_torch.tools import lint as cli

    problems, engine = cli._self_check()
    assert problems == [], problems
    assert engine in ("ruff", "builtin-ast")


def test_cli_refuses_cuda_without_a_card(monkeypatch, capsys):
    from chainermn_tpu_torch.tools import lint as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--device", "cuda"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


# ----------------------------------------------------------------------
# --regen
# ----------------------------------------------------------------------
def _regen():
    proc = _cli("--fixtures", "--device", "cpu", "--world", "2", "--format",
                "json", timeout=600)
    payload = json.loads(proc.stdout)
    flagged = _golden_view(payload)
    for t in payload["targets"]:
        if t["expect"] is None:
            assert flagged[t["target"]] == [], t
        else:
            assert t["expect"] in flagged[t["target"]], t
    with open(GOLDEN, "w") as f:
        json.dump({"flagged_rules": flagged}, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--regen", action="store_true",
                    help="regenerate the port's lint-fixtures golden")
    if not ap.parse_args().regen:
        ap.error("run under pytest, or pass --regen to regenerate")
    _regen()
