"""The port stands alone: importing it loads neither jax, the JAX package
nor PyYAML (the card's machine has none), no module of it (nor
chip_smoke.py) imports them, and neither does its CLI run as
``python -m quatro_tpu_torch.cli``."""

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
FORBIDDEN = ("jax", "jaxlib", "flax", "quatro_tpu", "yaml")


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
            "quatro_tpu_torch.ops.frontend, quatro_tpu_torch.io.synthetic, "
            "quatro_tpu_torch.odometry, quatro_tpu_torch.sequence, "
            "quatro_tpu_torch.registration, quatro_tpu_torch.ops.scancontext, "
            "quatro_tpu_torch.parallel.posegraph, quatro_tpu_torch.io.kitti, "
            "quatro_tpu_torch.parallel.mesh, "
            "quatro_tpu_torch.parallel.sharding, "
            "quatro_tpu_torch.parallel.distributed, "
            "quatro_tpu_torch.parallel.diagnostics, "
            "quatro_tpu_torch.preprocessing.metadata, quatro_tpu_torch.cli, "
            "quatro_tpu_torch.eval, quatro_tpu_torch.config_io, "
            "quatro_tpu_torch.native, quatro_tpu_torch.io.ply, "
            "quatro_tpu_torch.io.pcd, quatro_tpu_torch.utils.linalg, "
            "quatro_tpu_torch.utils.profiling; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_cli_module_run_loads_no_jax_or_yaml():
    """``python -m quatro_tpu_torch.cli`` (a one-trial ``sweep`` on the
    CPU, which loads the CLI, the harness and the solver) imports no
    forbidden module: ``-X importtime`` lists every module it loads."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "quatro_tpu_torch.cli",
         "sweep", "--rates", "0.5", "--n-trials", "1", "--n-corr", "16",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert '"0.5"' in res.stdout
    loaded = [line.rsplit("|", 1)[-1].strip() for line in
              res.stderr.splitlines() if line.startswith("import time:")]
    assert {"quatro_tpu_torch", "quatro_tpu_torch.eval"} <= set(loaded)
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


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
