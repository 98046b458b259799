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


def test_running_the_trainer_and_tune_loads_no_jax_ray_tpu_or_cloudpickle(tmp_path):
    """The JAX package's trainer and tuner import cloudpickle inside the
    calls that launch workers; the port's must not, nor jax or ray_tpu: a
    TorchTrainer fit with a failure and a restart, and a two-trial Tuner
    over it, run in a fresh interpreter that then holds none of them."""
    code = (
        "import sys, tempfile\n"
        "import ray_tpu_torch as rt\n"
        "from ray_tpu_torch import train, tune\n"
        "def loop(config):\n"
        "    ck = train.get_checkpoint()\n"
        "    for step in range(1 if ck else 0, 3):\n"
        "        d = tempfile.mkdtemp(dir=config['dir'])\n"
        "        train.save_pytree({'step': step}, d)\n"
        "        train.report({'step': step, 'x': config.get('x', 0)},\n"
        "                     checkpoint=train.Checkpoint(d))\n"
        "        if step == 1 and ck is None:\n"
        "            raise RuntimeError('injected')\n"
        "rt.init(local_mode=True, num_cpus=2)\n"
        f"store = {str(tmp_path)!r}\n"
        "trainer = train.TorchTrainer(\n"
        "    loop, train_loop_config={'dir': store},\n"
        "    scaling_config=train.ScalingConfig(use_gpu=False),\n"
        "    run_config=train.RunConfig(storage_path=store,\n"
        "                               failure_config=train.FailureConfig(max_failures=1)))\n"
        "result = trainer.fit()\n"
        "assert result.error is None and result.metrics['step'] == 2, result\n"
        "grid = tune.Tuner(trainer, param_space={'x': tune.grid_search([1, 2])},\n"
        "                  tune_config=tune.TuneConfig(metric='x', mode='max'),\n"
        "                  run_config=train.RunConfig(storage_path=store)).fit()\n"
        "assert grid.get_best_result().metrics['x'] == 2\n"
        "rt.shutdown()\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu', 'cloudpickle')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_flight_recorder_kinds_are_declared(path):
    """Every literal dotted kind the port records has its prefix in the port's
    KIND_PREFIXES, as tools/lint checks the JAX package's."""
    from ray_tpu_torch.observability.flight_recorder import KIND_PREFIXES

    recorders = {"record", "_frec", "_flight_record"}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and node.args
                and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
                and getattr(node.func, "id", getattr(node.func, "attr", None)) in recorders
                and "." in node.args[0].value):
            assert node.args[0].value.split(".", 1)[0] in KIND_PREFIXES, (path, node.lineno)
