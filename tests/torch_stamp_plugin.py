"""Test fixture: an external runtime-env plugin of the port, loaded by its
raylets through RAY_TPU_RUNTIME_ENV_PLUGINS (the counterpart of
tests/_stamp_plugin.py; see test_torch_runtime_env.test_plugin_abc_end_to_end)."""

from ray_tpu_torch.core.runtime_env import RuntimeEnvPlugin


class StampPlugin(RuntimeEnvPlugin):
    name = "stamp"
    priority = 3

    def process(self, value, renv, gcs):
        return f"processed:{value}"

    def materialize(self, value, resolved, ctx, gcs, cache_dir):
        ctx.env_vars["RTPU_STAMP"] = value
