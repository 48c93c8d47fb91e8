"""Boundaries of the PyTorch port: it imports nothing of JAX, flax or the
JAX package; chip_smoke.py refuses to run without a GPU."""
import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "yolov3_tensorflow_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "yolov3_tensorflow_tpu")


def port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return out


def imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_or_jax_package():
    files = port_files()
    assert len(files) > 15
    for path in files:
        bad = sorted(set(imported_roots(path)) & set(FORBIDDEN))
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("checks the GPU-less behaviour")
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:  # a directory holding chip_smoke.py and nothing else
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    proc = subprocess.run([sys.executable, script], cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
