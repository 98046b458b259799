"""The port's flag table and version against the JAX package's
(ray_tpu_torch/utils/config.py, ray_tpu_torch/_version.py): the same 26
flags with the same defaults, the same effective values under the same
RAY_TPU_<NAME> overrides (read at import, so each set runs in a fresh
interpreter), the module constants the port's code reads bound to them,
and the same version string.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json
from ray_tpu.utils import config as jcfg
from ray_tpu_torch.utils import config as tcfg
print(json.dumps({"jax": jcfg.all_flags(), "torch": tcfg.all_flags(),
                  "constants": {k: getattr(tcfg, k.upper()) for k in tcfg.all_flags()},
                  "attrs": {k: getattr(tcfg.CONFIG, k) for k in tcfg.all_flags()}}))
"""

# (environment, the effective values it must give)
OVERRIDES = [
    ({}, {"gcs_shards": 8, "heartbeat_timeout_s": 5.0, "worker_zygote": True,
          "data_executor": "v2", "worker_pool": True, "object_store_memory": 256 << 20}),
    ({"RAY_TPU_GCS_SHARDS": "3", "RAY_TPU_HEARTBEAT_TIMEOUT_S": "2.5",
      "RAY_TPU_WORKER_ZYGOTE": "0", "RAY_TPU_DATA_EXECUTOR": "v1"},
     {"gcs_shards": 3, "heartbeat_timeout_s": 2.5, "worker_zygote": False,
      "data_executor": "v1"}),
    ({"RAY_TPU_WORKER_POOL": "false", "RAY_TPU_OBJECT_STORE_MEMORY": "1048576",
      "RAY_TPU_SPILL_THRESHOLD": "0.5", "RAY_TPU_WORKER_POOL_PREFORK": "5"},
     {"worker_pool": False, "object_store_memory": 1048576, "spill_threshold": 0.5,
      "worker_pool_prefork": 5}),
]


@pytest.mark.parametrize("env,want", OVERRIDES, ids=["defaults", "set-a", "set-b"])
def test_flags_agree_under_the_same_overrides(env, want):
    clean = {k: v for k, v in os.environ.items() if not k.startswith("RAY_TPU_")}
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, env={**clean, **env, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(seen["jax"]) == 26
    assert seen["torch"] == seen["jax"]
    assert seen["constants"] == seen["torch"] == seen["attrs"]
    for key, value in want.items():
        assert seen["torch"][key] == value and type(seen["torch"][key]) is type(value), key


def test_version_matches():
    import ray_tpu
    import ray_tpu_torch

    assert ray_tpu_torch.__version__ == ray_tpu.__version__ == "0.1.0"
    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        assert 'version = "0.1.0"' in f.read()
