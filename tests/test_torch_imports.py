"""The port stands alone: importing it loads neither jax nor the JAX
package, and no module of it (nor chip_smoke.py) imports them."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import quatro_tpu  # noqa: F401  (both packages load side by side here)
import quatro_tpu_torch  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "quatro_tpu")


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _sources():
    files = sorted((ROOT / "quatro_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_import_loads_no_jax():
    code = ("import sys, quatro_tpu_torch, quatro_tpu_torch.pipeline, "
            "quatro_tpu_torch.ops.frontend, quatro_tpu_torch.io.synthetic; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_forbidden_imports(path):
    assert path.exists(), path
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"
