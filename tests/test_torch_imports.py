"""The port stands alone: ray_tpu_torch and the chip scripts import neither
jax nor anything of the ray_tpu package, the chip scripts refuse to run
without a CUDA device, and chip_smoke.py without the rest of the
repository."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_bwd_accuracy.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "ray_tpu", "optax", "orbax", "flax", "ml_dtypes",
                   "cloudpickle")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_ray_tpu_import_in_source(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_importing_the_port_loads_no_jax_and_no_ray_tpu():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(".__init__", "")
        for p in (ROOT / "ray_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu', 'ml_dtypes', 'orbax',\n"
        "                              'cloudpickle')]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                          text=True, timeout=120, env=env)


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a CUDA device")
    out = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_bwd_accuracy_fails_without_cuda_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a CUDA device")
    out = _run_smoke(ROOT, ROOT / "chip_bwd_accuracy.py")
    assert out.returncode != 0
    assert "[seed" not in out.stdout


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    out = _run_smoke(tmp_path, script)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
