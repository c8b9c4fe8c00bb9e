"""The port's host-plane rules (``chainermn_tpu_torch.analysis.hostlint``,
H001–H005) against the reference's, on the same sources.

Held equal: every H snippet of the reference's fixtures gives the port's
``analyze_host`` the reference's findings (rule, severity, message,
path); the reference's ``analyze_host`` over the port's own host-plane
sources gives the port's H001, H002, H004 and H005 findings (H003 reads
the port's ``_run`` steps by design, ROADMAP §C).  The port's host plane
lints clean against its own lockfile ``tests/golden/torch_wire_schemas.json``
with its one justified suppression; the lockfile is current; every
struct both lockfiles hold has the reference's fields, the listed
exception aside; ``--regen-schemas`` round-trips.
"""

import copy
import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_LOCK = os.path.join(REPO, "tests", "golden", "torch_wire_schemas.json")
REF_LOCK = os.path.join(REPO, "tests", "golden", "wire_schemas.json")

#: the port's in-tree ``# hostlint: disable`` comments, each justified
#: where it stands and held load-bearing below (router.py's ``rep.alive``).
SUPPRESSION_BUDGET = 1

#: structs whose fields differ between the lockfiles, with the reason.
LOCK_EXCEPTIONS = {
    # bf16 KV pages travel as their uint16 bits (numpy has no bfloat16),
    # so the snapshot names each leaf's dtype: a trailing field with a
    # default, the sanctioned wire evolution.
    "dataclass:KVSnapshot": "dtypes",
    "meta:kv_snapshot": "dtypes",
}

H_NAMES = ["h001", "h001_clean", "h002", "h002_clean", "h003", "h003_clean",
           "h004", "h004_clean", "h005", "h005_clean"]


def _rows(report):
    return [(f.rule, f.severity, f.message, f.eqn_path)
            for f in report.findings]


def _port_files(**over):
    from chainermn_tpu_torch.analysis import hostlint

    files = hostlint.package_host_files()
    for name, src in over.items():
        files = [hostlint.make_host_file(f.name, src, wire=f.wire, det=f.det)
                 if f.name.endswith(name) else f for f in files]
    return files


def _as_ref(files):
    from chainermn_tpu.analysis import hostlint as ref

    return [ref.make_host_file(f.name, f.source, wire=f.wire, det=f.det)
            for f in files]


def _source(rel):
    with open(os.path.join(REPO, "chainermn_tpu_torch", rel),
              encoding="utf-8") as fh:
        return fh.read()


def _lock(path):
    with open(path) as fh:
        return json.load(fh)


# ----------------------------------------------------------------------
# The snippets: the reference's findings, rule for rule
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", H_NAMES)
def test_snippet_findings_equal_the_reference(name):
    from chainermn_tpu.analysis import hostlint as ref
    from chainermn_tpu.analysis.fixtures import FIXTURES as REF
    from chainermn_tpu_torch.analysis import hostlint
    from chainermn_tpu_torch.analysis.fixtures import FIXTURES

    def run(mod, t):
        hf = mod.make_host_file(t["target"], t["source"],
                                wire=t.get("wire", False),
                                det=t.get("det", False))
        return mod.analyze_host([hf], wire_lock=t.get("wire_lock"))

    mine, theirs = run(hostlint, FIXTURES[name]()), run(ref, REF[name]())
    assert _rows(mine) == _rows(theirs)
    assert mine.suppressed == theirs.suppressed
    t = FIXTURES[name]()
    if t["expect"] is None:
        assert mine.findings == []
    else:
        assert t["expect"] in {f.rule for f in mine.findings}
        assert all(f.message and f.fix_hint for f in mine.findings)


# ----------------------------------------------------------------------
# The port's sources under both implementations
# ----------------------------------------------------------------------
def _both(files, lock):
    from chainermn_tpu.analysis import hostlint as ref
    from chainermn_tpu_torch.analysis import hostlint

    keep = ["H001", "H002", "H004", "H005"]
    mine = hostlint.analyze_host(files, rules=keep, wire_lock=lock)
    theirs = ref.analyze_host(_as_ref(files), rules=keep, wire_lock=lock)
    return mine, theirs


def test_reference_rules_over_the_port_sources_agree():
    mine, theirs = _both(_port_files(), _lock(PORT_LOCK))
    assert _rows(mine) == _rows(theirs) == []
    assert mine.suppressed == theirs.suppressed == SUPPRESSION_BUDGET


def test_reference_rules_agree_on_a_tampered_port_router():
    """Strip the router's justified suppression: both implementations
    report the same bare ``rep.alive`` access."""
    src = _source("serving/cluster/router.py")
    assert "# hostlint: disable=H001" in src
    bare = src.replace("  # hostlint: disable=H001", "")
    mine, theirs = _both(_port_files(**{"router.py": bare}), None)
    assert _rows(mine) == _rows(theirs)
    assert any(r[0] == "H001" and "rep.alive" in r[2] for r in _rows(mine))


def test_reference_rules_agree_on_a_tampered_lock():
    lock = copy.deepcopy(_lock(PORT_LOCK))
    fields = lock["schemas"]["dataclass:ReplicaLoad"]["fields"]
    fields[0], fields[1] = fields[1], fields[0]
    del lock["schemas"]["frame:tok"]
    mine, theirs = _both(_port_files(), lock)
    assert _rows(mine) == _rows(theirs)
    assert {r[0] for r in _rows(mine)} == {"H004"}


# ----------------------------------------------------------------------
# The port's gate, lockfile and H003
# ----------------------------------------------------------------------
def test_port_host_plane_clean_against_its_lockfile():
    from chainermn_tpu_torch.analysis import hostlint

    report = hostlint.analyze_host(_port_files(),
                                   wire_lock=_lock(PORT_LOCK))
    assert report.ok and report.findings == [], report.render()
    assert set(report.rules_run) == {"H001", "H002", "H003", "H004", "H005"}
    assert report.suppressed == SUPPRESSION_BUDGET
    assert len(hostlint.HOST_PLANE_FILES) == 19


def test_host_plane_files_are_the_reference_list():
    from chainermn_tpu.analysis import hostlint as ref
    from chainermn_tpu_torch.analysis import hostlint

    assert hostlint.HOST_PLANE_FILES == ref.HOST_PLANE_FILES
    for rel, _, _ in hostlint.HOST_PLANE_FILES:
        assert os.path.exists(os.path.join(REPO, "chainermn_tpu_torch", rel))


def test_wire_lockfile_is_current():
    from chainermn_tpu_torch.analysis import hostlint

    current = hostlint.extract_wire_schemas(_port_files())
    stripped = {k: {kk: vv for kk, vv in v.items() if kk != "loc"}
                for k, v in current.items()}
    assert stripped == _lock(PORT_LOCK)["schemas"], (
        "regenerate with: python -m chainermn_tpu_torch.tools.lint --host "
        "--regen-schemas")


def test_lockfiles_agree_struct_by_struct():
    mine = _lock(PORT_LOCK)["schemas"]
    theirs = _lock(REF_LOCK)["schemas"]
    assert set(mine) == set(theirs)
    for key in sorted(mine):
        if key in LOCK_EXCEPTIONS:
            a, b = mine[key], theirs[key]
            field = LOCK_EXCEPTIONS[key]
            if "fields" in a:
                assert a["fields"][:len(b["fields"])] == b["fields"]
                assert a["fields"][len(b["fields"]):] == [[field, True]]
            else:
                assert sorted(set(a["keys"]) - set(b["keys"])) == [field]
                assert set(b["keys"]) <= set(a["keys"])
        else:
            assert mine[key] == theirs[key], key


def _engine_src():
    return _source("serving/engine.py")


def test_h003_fires_on_a_mirror_stripped_engine_clone():
    """Delete the decode path's mirror emit from a clone of the port's
    engine: the port's H003 catches it; the reference's, which reads
    ``self.*_jit`` steps the port does not have, does not (by design)."""
    from chainermn_tpu.analysis import hostlint as ref
    from chainermn_tpu_torch.analysis import hostlint

    lines = _engine_src().splitlines(keepends=True)
    stripped = [ln for ln in lines
                if not re.search(r'self\._mirror\(\s*"decode"', ln)]
    assert len(stripped) == len(lines) - 1
    src = "".join(stripped)
    hits = [f for f in hostlint.analyze_host(
        [("engine_clone.py", src)]).findings if f.rule == "H003"]
    assert [f.message.split(" ")[0] for f in hits] == \
        ["InferenceEngine._decode_step"], hits
    assert not [f for f in ref.analyze_host(
        [("engine_clone.py", src)]).findings if f.rule == "H003"]


@pytest.mark.parametrize("op", ["prefill", "chunk", "cow", "defrag"])
def test_h003_guards_every_mirrored_step(op):
    from chainermn_tpu_torch.analysis import hostlint

    src = _engine_src()
    pat = re.compile(rf'^\s*self\._mirror\("{op}".*\n', re.M)
    assert len(pat.findall(src)) == 1
    report = hostlint.analyze_host([("engine_clone.py", pat.sub("", src))])
    assert [f.rule for f in report.findings] == ["H003"], report.render()


def test_h003_accepts_the_engine_as_it_stands():
    from chainermn_tpu_torch.analysis import hostlint

    report = hostlint.analyze_host([("engine.py", _engine_src())])
    assert report.findings == [], report.render()


def test_h001_router_suppression_is_load_bearing():
    from chainermn_tpu_torch.analysis import hostlint

    src = _source("serving/cluster/router.py")
    bare = src.replace("  # hostlint: disable=H001", "")
    hits = [f for f in hostlint.analyze_host(
        [("router_bare.py", bare)]).findings if f.rule == "H001"]
    assert any("rep.alive" in f.message for f in hits)
    assert not re.search(r"\.alive\s*=\s*True", src)


# ----------------------------------------------------------------------
# H004 tamper cases and the bless flow
# ----------------------------------------------------------------------
def _current_and_lock():
    from chainermn_tpu_torch.analysis import hostlint

    return hostlint.extract_wire_schemas(_port_files()), _lock(PORT_LOCK)


@pytest.mark.parametrize("tamper", ["reorder", "defaultless", "removal"])
def test_h004_breaking_changes_fail(tamper):
    from chainermn_tpu_torch.analysis import hostlint

    current, lock = _current_and_lock()
    t = copy.deepcopy(current)
    if tamper == "reorder":
        f = t["dataclass:ReplicaLoad"]["fields"]
        f[0], f[1] = f[1], f[0]
        want = "reordered"
    elif tamper == "defaultless":
        t["dataclass:ReplicaLoad"]["fields"].append(["bogus", False])
        want = "no default"
    else:
        del t["frame:tok"]
        want = "frame:tok"
    findings = hostlint.compare_wire_schemas(t, lock)
    assert any(f.severity == "error" and want in f.message
               for f in findings), [f.render() for f in findings]


def test_h004_defaulted_append_and_new_struct_pass():
    from chainermn_tpu_torch.analysis import hostlint

    current, lock = _current_and_lock()
    grown = copy.deepcopy(current)
    grown["dataclass:ReplicaLoad"]["fields"].append(["extra", True])
    grown["cmd:brand_new"] = {"keys": ["op"], "loc": ("x.py", 1)}
    findings = hostlint.compare_wire_schemas(grown, lock)
    assert not [f for f in findings if f.severity == "error"]
    assert any("brand_new" in f.message for f in findings)


def test_regen_schemas_round_trips(tmp_path, monkeypatch):
    from chainermn_tpu_torch.analysis import hostlint
    from chainermn_tpu_torch.tools import lint as cli

    target = tmp_path / "torch_wire_schemas.json"
    monkeypatch.setattr(cli, "_wire_schemas_path", lambda: str(target))
    assert cli.main(["--host", "--regen-schemas"]) == 0
    regenerated = json.loads(target.read_text())
    assert regenerated == _lock(PORT_LOCK)
    current = hostlint.extract_wire_schemas(_port_files())
    assert hostlint.compare_wire_schemas(current, regenerated) == []
    assert cli.main(["--host", "--format", "json"]) == 0


# ----------------------------------------------------------------------
# Shared suppression surfaces and the CLI
# ----------------------------------------------------------------------
def test_line_scoped_suppression_counts():
    from chainermn_tpu_torch.analysis import hostlint
    from chainermn_tpu_torch.analysis.fixtures import _H001_BAD

    src = _H001_BAD.replace(
        "        self.value = 0\n",
        "        # single-threaded teardown path\n"
        "        self.value = 0  # hostlint: disable=H001\n",
    )
    report = hostlint.analyze_host([("s.py", src)])
    assert report.ok and report.suppressed == 1


def test_env_disable_applies_to_host_rules(monkeypatch):
    from chainermn_tpu_torch.analysis import ENV_DISABLE, hostlint
    from chainermn_tpu_torch.analysis.fixtures import _H001_BAD

    monkeypatch.setenv(ENV_DISABLE, "H001")
    report = hostlint.analyze_host([("s.py", _H001_BAD)])
    assert report.ok and report.suppressed == 1


def test_cli_host_in_process(capsys):
    from chainermn_tpu_torch.tools import lint as cli

    assert cli.main(["--host", "--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    (host,) = payload["targets"]
    assert host["target"] == "host" and host["ok"]
    assert host["suppressed"] == SUPPRESSION_BUDGET
    assert host["rules_run"] == ["H001", "H002", "H003", "H004", "H005"]


def test_cli_host_subprocess_and_fixture_exit():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "chainermn_tpu_torch.tools.lint", "--host",
         "--format", "json"], capture_output=True, text=True, timeout=240,
        env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert [t["target"] for t in json.loads(proc.stdout)["targets"]] == \
        ["host"]
    proc = subprocess.run(
        [sys.executable, "-m", "chainermn_tpu_torch.tools.lint",
         "--fixtures", "h003", "--format", "json"], capture_output=True,
        text=True, timeout=240, env=env, cwd=REPO)
    payload = json.loads(proc.stdout)
    assert proc.returncode == 1 and payload["ok"] is False
    assert {f["rule"] for t in payload["targets"]
            for f in t["findings"]} == {"H003"}
