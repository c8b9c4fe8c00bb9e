"""No module that a run loads is JAX or the JAX package (top-level names
compared whole: ``chainermn_tpu_torch`` begins with ``chainermn_tpu``),
and the plain references load nothing of the program."""

import ast
import json
import os
import subprocess
import sys

from portbench import harness
from portbench.tests.tiny import REPO

PB = os.path.join(REPO, "portbench")


def _top_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(PB, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        found = set(_top_imports(path)) & set(harness.FORBIDDEN)
        assert not found, (path, found)


def test_references_import_nothing_of_the_program():
    for path in _sources("reference"):
        found = set(_top_imports(path)) & set(harness.FORBIDDEN
                                               + (harness.PROGRAM,))
        assert not found, (path, found)


def _modules_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_forbidden_module(tmp_path):
    code = (
        "from portbench.tests import tiny\n"
        "from portbench import harness\n"
        f"root = tiny.make_root({str(tmp_path)!r})\n"
        "out = harness.run_rank(tiny.spec(root, 'tiny-lm.s32', trace=1))\n"
        "assert out['forbidden'] == [], out['forbidden']\n")
    mods = _modules_after(code)
    assert harness.PROGRAM in mods
    assert not mods & set(harness.FORBIDDEN), mods & set(harness.FORBIDDEN)


def test_the_references_load_no_program_module():
    mods = _modules_after(
        "import portbench.reference.lm, portbench.reference.resnet, "
        "portbench.reference.optim, portbench.inputs, portbench.check")
    assert not mods & set(harness.FORBIDDEN + (harness.PROGRAM,))
