"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the program's name begins with the JAX package's),
and the plain references import nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from conftest import REPO
from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "image_restoration_agent_tpu"}
PROGRAM = "image_restoration_agent_tpu_torch"


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((REPO / "portbench").rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not FORBIDDEN & set(imported_tops(f)), f


def test_the_references_import_nothing_of_the_program():
    for f in sorted((REPO / "portbench" / "reference").glob("*.py")):
        assert PROGRAM not in set(imported_tops(f)), f


def test_the_served_path_loads_no_jax():
    """A process that imports the harness and the program's served path
    holds none of the forbidden top-level names; a name that only begins
    with the JAX package's is not one of them."""
    code = ("import sys; sys.path.insert(0, '.'); "
            "from portbench import harness; "
            "from image_restoration_agent_tpu_torch.engine import Engine; "
            "sys.modules['image_restoration_agent_tpu_torchx'] = sys; "
            "print(harness.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                       capture_output=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
    assert harness.forbidden_modules.__doc__
    sys.modules["jaxlib_fake_for_test"] = sys
    try:
        assert "jaxlib" not in harness.forbidden_modules()
    finally:
        del sys.modules["jaxlib_fake_for_test"]
