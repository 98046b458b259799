"""Runtime envs on the port's cluster runtime (ray_tpu_torch/core/
runtime_env.py, the raylet's spawn by env, the `runtime_env` option) against
the JAX package's, case by case: tests/test_runtime_env.py's cases
(working_dir through a GCS package, py_modules, the pip venv, env_vars, the
cache GC, an external plugin loaded by the raylets, the conda and image_uri
gates, plugin priority) and tests/test_options.py's four runtime_env cases
(env_vars, working_dir, an actor's env, an unknown field); plus a failure to
materialise (a package the GCS KV does not hold), which reaches the caller
as the task's error.

`test_pip_venv_isolated_package` builds a real venv from a local source
package (offline, --no-build-isolation) and stays `slow`, as in the JAX
file.

Each package boots one cluster for the file (every JAX `Cluster()` sweeps
/dev/shm, ROADMAP Queue 3), its raylets started with
RAY_TPU_RUNTIME_ENV_PLUGINS naming that package's stamp plugin
(tests/_stamp_plugin.py, tests/torch_stamp_plugin.py).
"""

import functools
import importlib
import os
import sys
import textwrap
import types

import pytest

from ray_tpu_torch.core import serialization
import torch_modes

serialization.register_pickle_by_value(sys.modules[__name__])

PKGS = ("jax", "torch")
_ROOT = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}
_STAMP = {"jax": "tests._stamp_plugin:StampPlugin",
          "torch": "tests.torch_stamp_plugin:StampPlugin"}
_PLUGINS_ENV = "RAY_TPU_RUNTIME_ENV_PLUGINS"


def _renv_mod(name):
    return importlib.import_module(f"{_ROOT[name]}.core.runtime_env")


@pytest.fixture(scope="module")
def clusters():
    booted = {}
    for name in PKGS:
        importlib.import_module(_ROOT[name]).shutdown()
    try:
        yield booted
    finally:
        for c in booted.values():
            try:
                torch_modes.shutdown_cluster(c.cluster, c.runtime.shutdown)
            finally:
                c.base.set_runtime(None)


@pytest.fixture(params=PKGS)
def c(request, clusters):
    name = request.param
    if name not in clusters:
        saved = os.environ.get(_PLUGINS_ENV)
        os.environ[_PLUGINS_ENV] = _STAMP[name]  # the raylets read it at boot
        try:
            Cluster = importlib.import_module(f"{_ROOT[name]}.core.cluster_runtime").Cluster
            kw = {"num_gpus": 0} if name == "torch" else {}
            boot = (torch_modes.boot_jax_cluster if name == "jax"
                    else functools.partial(torch_modes.boot_cluster, Cluster))
            cluster = boot(num_cpus=2, num_workers=1, **kw)
        finally:
            if saved is None:
                os.environ.pop(_PLUGINS_ENV, None)
            else:
                os.environ[_PLUGINS_ENV] = saved
        clusters[name] = types.SimpleNamespace(
            name=name, cluster=cluster, runtime=cluster.runtime(),
            rt=importlib.import_module(_ROOT[name]), renv=_renv_mod(name),
            base=importlib.import_module(f"{_ROOT[name]}.core.runtime_base"))
    cl = clusters[name]
    cl.base.set_runtime(cl.runtime)
    yield cl
    cl.base.set_runtime(None)


# ------------------------------------------------ tests/test_runtime_env.py
def test_working_dir_packaged_through_gcs(c, tmp_path):
    rt = c.rt
    (tmp_path / "data.txt").write_text("hello from package")

    @rt.remote(runtime_env={"working_dir": str(tmp_path)})
    def read_data():
        with open("data.txt") as f:
            return f.read()

    assert rt.get(read_data.remote(), timeout=60) == "hello from package"


def test_py_modules(c, tmp_path):
    rt = c.rt
    mod = tmp_path / "rtpu_testmod"
    mod.mkdir()
    (mod / "__init__.py").write_text("VALUE = 42\n")

    @rt.remote(runtime_env={"py_modules": [str(mod)]})
    def use_mod():
        import rtpu_testmod

        return rtpu_testmod.VALUE

    assert rt.get(use_mod.remote(), timeout=60) == 42
    with pytest.raises(ImportError):
        import rtpu_testmod  # noqa: F401 - must not leak into the driver


@pytest.mark.slow
def test_pip_venv_isolated_package(c, tmp_path):
    rt = c.rt
    pkg = tmp_path / "rtpu_pippkg"
    (pkg / "rtpu_pippkg").mkdir(parents=True)
    (pkg / "rtpu_pippkg" / "__init__.py").write_text("MAGIC = 'venv-ok'\n")
    (pkg / "setup.py").write_text(textwrap.dedent("""
        from setuptools import setup, find_packages
        setup(name="rtpu-pippkg", version="0.1", packages=find_packages())
        """))

    @rt.remote(runtime_env={"pip": ["--no-build-isolation", str(pkg)]})
    def use_pkg():
        import rtpu_pippkg

        return rtpu_pippkg.MAGIC, sys.prefix != sys.base_prefix

    magic, in_venv = rt.get(use_pkg.remote(), timeout=300)
    assert magic == "venv-ok"
    assert in_venv, "worker did not run inside the virtualenv"


def test_env_vars_still_apply_with_packages(c):
    rt = c.rt

    @rt.remote(runtime_env={"env_vars": {"RTPU_TEST_FLAG": "on"}})
    def read_env():
        return os.environ.get("RTPU_TEST_FLAG")

    assert rt.get(read_env.remote(), timeout=60) == "on"


@pytest.mark.parametrize("name", PKGS)
def test_cache_gc(name, tmp_path):
    re_mod = _renv_mod(name)
    pkgs = tmp_path / "pkgs"
    pkgs.mkdir()
    for i in range(re_mod.MAX_CACHED_PACKAGES + 4):
        d = pkgs / f"digest{i:02d}"
        d.mkdir()
        os.utime(d, (i, i))  # older mtime = lower i
    re_mod.gc_cache(str(tmp_path))
    left = sorted(os.listdir(pkgs))
    assert len(left) == re_mod.MAX_CACHED_PACKAGES
    assert "digest00" not in left


def test_plugin_abc_end_to_end(c, monkeypatch):
    """The stamp plugin's process hook runs in the driver, its materialize
    hook in the raylet (which loaded it from RAY_TPU_RUNTIME_ENV_PLUGINS at
    boot), and its env var reaches the worker."""
    rt, re_mod = c.rt, c.renv
    monkeypatch.setenv(_PLUGINS_ENV, _STAMP[c.name])
    re_mod._load_external_plugins.__globals__["_EXTERNAL_LOADED"] = False
    try:
        @rt.remote(runtime_env={"stamp": "hello"})
        def read():
            return os.environ.get("RTPU_STAMP")

        assert rt.get(read.remote(), timeout=120) == "processed:hello"
    finally:
        re_mod._PLUGINS.pop("stamp", None)


@pytest.mark.parametrize("name", PKGS)
def test_conda_plugin_gates_cleanly(name, tmp_path, monkeypatch):
    import shutil as _sh

    re_mod = _renv_mod(name)
    monkeypatch.setattr(_sh, "which", lambda _: None)
    ctx = re_mod.RuntimeEnvContext()
    with pytest.raises(RuntimeError, match="conda binary"):
        re_mod.CondaPlugin().materialize({"dependencies": ["python=3.12"]}, {}, ctx, None,
                                         str(tmp_path))


@pytest.mark.parametrize("name", PKGS)
def test_image_uri_prefix_and_gating(name, tmp_path, monkeypatch):
    import shutil as _sh

    re_mod = _renv_mod(name)
    prefix = re_mod.ImageUriPlugin.command_prefix("/usr/bin/podman", "myimage:latest",
                                                  str(tmp_path))
    assert prefix[0] == "/usr/bin/podman" and prefix[-1] == "myimage:latest"
    assert "--ipc=host" in prefix
    assert any(str(tmp_path) in p for p in prefix)
    monkeypatch.setattr(_sh, "which", lambda _: None)
    ctx = re_mod.RuntimeEnvContext()
    with pytest.raises(RuntimeError, match="podman or docker"):
        re_mod.ImageUriPlugin().materialize("img", {}, ctx, None, str(tmp_path))


@pytest.mark.parametrize("name", PKGS)
def test_plugin_priority_orders_materialization(name):
    re_mod = _renv_mod(name)
    order = []

    class A(re_mod.RuntimeEnvPlugin):
        name = "zz_a"
        priority = 1

        def materialize(self, value, resolved, ctx, gcs, cache_dir):
            order.append("a")

    class B(re_mod.RuntimeEnvPlugin):
        name = "aa_b"
        priority = 30

        def materialize(self, value, resolved, ctx, gcs, cache_dir):
            order.append("b")

    re_mod.register_plugin(A())
    re_mod.register_plugin(B())
    try:
        re_mod.materialize_runtime_env({"zz_a": 1, "aa_b": 2}, None)
        assert order == ["a", "b"]
    finally:
        re_mod._PLUGINS.pop("zz_a", None)
        re_mod._PLUGINS.pop("aa_b", None)


# ---------------------------------------------- tests/test_options.py cases
def test_runtime_env_env_vars(c):
    rt = c.rt

    @rt.remote(runtime_env={"env_vars": {"MY_FLAG": "hello"}})
    def read_env():
        return os.environ.get("MY_FLAG")

    @rt.remote
    def read_plain():
        return os.environ.get("MY_FLAG")

    assert rt.get(read_env.remote(), timeout=30) == "hello"
    assert rt.get(read_plain.remote(), timeout=30) is None


def test_runtime_env_working_dir(c, tmp_path):
    rt = c.rt
    (tmp_path / "wd_module.py").write_text("VALUE = 'from-working-dir'\n")

    @rt.remote(runtime_env={"working_dir": str(tmp_path)})
    def use_module():
        import wd_module

        return wd_module.VALUE, os.getcwd()

    value, cwd = rt.get(use_module.remote(), timeout=30)
    assert value == "from-working-dir"
    assert cwd != str(tmp_path)  # the extracted package, not the driver's path
    assert os.path.exists(os.path.join(cwd, "wd_module.py"))


def test_runtime_env_actor(c):
    rt = c.rt

    @rt.remote(runtime_env={"env_vars": {"ACTOR_ENV": "yes"}})
    class EnvActor:
        def read(self):
            return os.environ.get("ACTOR_ENV")

    a = EnvActor.remote()
    assert rt.get(a.read.remote(), timeout=30) == "yes"


def test_runtime_env_unsupported_field_raises(c):
    rt = c.rt

    @rt.remote(runtime_env={"no_such_plugin": 1})
    def f():
        return 1

    with pytest.raises(ValueError, match="no plugin"):
        f.remote()


# ------------------------------------------------------------ both packages
def test_materialize_failure_is_the_tasks_error(c):
    """An env the raylet cannot materialise (a package URI the GCS KV does
    not hold) fails the task that needed it, with the plugin's message."""
    rt = c.rt

    @rt.remote(runtime_env={"working_dir": "pkg:0123456789abcdef01234567"})
    def f():
        return 1

    with pytest.raises(Exception, match="not in GCS KV"):
        rt.get(f.remote(), timeout=60)

    @rt.remote
    def g():
        return 2

    assert rt.get(g.remote(), timeout=60) == 2
