"""The port stands alone: ``chainermn_tpu_torch`` and ``chip_smoke.py``
import neither JAX (nor flax/optax) nor anything of ``chainermn_tpu``.

Two checks: every module imports in a fresh interpreter where those
packages are poisoned in ``sys.modules``, and an AST walk finds no import
statement naming them.  Names are matched exactly (``chainermn_tpu`` or
``chainermn_tpu.*``), not by prefix: the port's own name starts with
``chainermn_tpu``.
"""

import ast
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "chainermn_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chainermn_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    return sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _module_names():
    names = []
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_forbidden_matches_exact_names_only():
    assert _forbidden("chainermn_tpu") and _forbidden("chainermn_tpu.ops")
    assert _forbidden("jax.numpy") and not _forbidden("jaxtyping")
    assert not _forbidden("chainermn_tpu_torch")
    assert not _forbidden("chainermn_tpu_torch.ops.flash_attention")


def test_no_forbidden_import_statements():
    bad = []
    for path in _sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_every_module_imports_with_jax_poisoned():
    modules = _module_names()
    assert "chainermn_tpu_torch.ops._kernels" in modules
    code = "\n".join([
        "import importlib, sys",
        f"for name in {FORBIDDEN!r}:",
        "    sys.modules[name] = None",
        f"for mod in {modules!r}:",
        "    importlib.import_module(mod)",
        "import chip_smoke",
        "loaded = [m for m, v in sys.modules.items() if v is not None and (",
        f"    m in {FORBIDDEN!r} or m.split('.')[0] in {FORBIDDEN!r})]",
        "assert not loaded, loaded",
        "print('ok', len(sys.modules))",
    ])
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_refuses_to_run_without_the_repo(tmp_path):
    """Alone in a directory, the script exits non-zero and prints no
    result line."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_refuses_to_run_without_a_gpu():
    """Here, with no CUDA device, the script fails before any phase."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py is run on it directly")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
