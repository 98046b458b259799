"""Runtime environments: per-task/actor dependency management (the port of
ray_tpu/core/runtime_env.py).

Re-design of the reference's runtime-env subsystem (reference:
python/ray/_private/runtime_env/ — pip.py:45 pip/venv plugin,
packaging.py zip-to-GCS packages, uri_cache.py cached+GC'd URIs,
working_dir.py / py_modules.py). The shape is the same three stages:

1. DRIVER side (`process_runtime_env`): local `working_dir`/`py_modules`
   directories are zipped, content-addressed (sha256), and uploaded ONCE
   into the GCS KV under `pkg:<hash>` — the runtime_env dict that travels
   in the task spec carries URIs, never file paths, so any node can
   materialize it.
2. RAYLET side (`materialize_runtime_env`): before spawning a worker for
   an env, packages are downloaded+extracted into a node-local content-
   addressed cache, and a `pip` spec creates a virtualenv (system
   site-packages visible, so torch and numpy stay importable)
   keyed by the hash of its requirements; the worker is spawned with the
   venv's python and env vars pointing at the extracted paths.
3. WORKER side: chdir into the working dir, prepend py_module paths to
   sys.path (worker_proc._apply_working_dir).

Caches are GC'd LRU by directory mtime (`gc_cache`), mirroring
uri_cache.py's used/unused accounting collapsed to one knob.

The raylet (core/raylet.py) materialises an env before it spawns a worker
for it, and Popens that worker when the env sets variables, an interpreter
or a command prefix (a fork from the zygote would keep the zygote's
imports); working_dir and py_modules alone still fork. This module never
imports torch.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

PKG_PREFIX = "pkg:"
DEFAULT_CACHE = os.path.join(tempfile.gettempdir(), "rtpt_env_cache")
MAX_CACHED_PACKAGES = 16
MAX_CACHED_VENVS = 8


# ------------------------------------------------------------- plugin ABC
class RuntimeEnvContext:
    """What materialization produces for the worker spawn (reference:
    _private/runtime_env/context.py RuntimeEnvContext): the interpreter to
    exec, extra env vars, and an optional command prefix (container
    plugins wrap the worker command)."""

    def __init__(self):
        self.py_executable: str = sys.executable
        self.env_vars: Dict[str, str] = {}
        self.command_prefix: List[str] = []


class RuntimeEnvPlugin:
    """One runtime_env key's lifecycle (reference:
    _private/runtime_env/plugin.py RuntimeEnvPlugin ABC). Override:

    - `process(value, renv, gcs)` — DRIVER side, once per submission:
      normalize the value into something any node can materialize
      (upload local dirs, inline file contents). Returns the stored value.
    - `materialize(value, resolved, ctx, gcs, cache_dir)` — NODE side,
      before worker spawn: realize the env locally; mutate `resolved`
      (local paths) and `ctx` (interpreter/env/prefix).
    - `gc(cache_dir)` — cache eviction hook, called opportunistically.

    `priority` orders execution (lower first) — e.g. conda/pip must pick
    the interpreter before a container plugin wraps the command.
    """

    name: str = ""
    priority: int = 10

    def process(self, value: Any, renv: dict, gcs) -> Any:
        return value

    def materialize(
        self, value: Any, resolved: dict, ctx: RuntimeEnvContext, gcs, cache_dir: str
    ) -> None:
        pass

    def gc(self, cache_dir: str) -> None:
        pass


_PLUGINS: Dict[str, RuntimeEnvPlugin] = {}


def register_plugin(plugin: RuntimeEnvPlugin) -> None:
    """Registers a plugin for its `name` key in runtime_env dicts. Must be
    registered in the raylet/driver process before use (reference:
    plugin.py's RuntimeEnvPluginManager + entry-point loading, collapsed
    to an explicit call)."""
    if not plugin.name:
        raise ValueError("plugin needs a name")
    _PLUGINS[plugin.name] = plugin


_EXTERNAL_LOADED = False


def _load_external_plugins() -> None:
    """Imports plugins named in RAY_TPU_RUNTIME_ENV_PLUGINS
    ("pkg.module:ClassName,..."), once per process — how user plugins
    reach raylet daemons, which inherit the env var at spawn (reference:
    RAY_RUNTIME_ENV_PLUGINS entry-point loading in plugin.py)."""
    global _EXTERNAL_LOADED
    if _EXTERNAL_LOADED:
        return
    _EXTERNAL_LOADED = True
    spec = os.environ.get("RAY_TPU_RUNTIME_ENV_PLUGINS")
    if not spec:
        return
    import importlib

    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        mod_name, _, cls_name = item.partition(":")
        cls = getattr(importlib.import_module(mod_name), cls_name)
        register_plugin(cls())


def _ordered_plugins(renv: dict) -> List[Tuple[str, RuntimeEnvPlugin]]:
    _load_external_plugins()
    present = [(k, p) for k, p in _PLUGINS.items() if k in renv]
    return sorted(present, key=lambda kp: kp[1].priority)


# --------------------------------------------------------------- packaging
def zip_directory(path: str, include_base: bool = False) -> bytes:
    """Deterministic zip of a directory tree (fixed timestamps so the
    content hash is stable across rebuilds — reference: packaging.py
    creating reproducible working_dir packages). `include_base` keeps the
    directory's own name as the top-level entry — py_modules packages
    must extract as `<dir>/mymod/...` so `import mymod` works with the
    extraction dir on sys.path."""
    buf = io.BytesIO()
    base = os.path.basename(os.path.normpath(path)) if include_base else None
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(path):
            dirs.sort()
            if "__pycache__" in dirs:
                dirs.remove("__pycache__")
            for name in sorted(files):
                full = os.path.join(root, name)
                rel = os.path.relpath(full, path)
                if base is not None:
                    rel = os.path.join(base, rel)
                info = zipfile.ZipInfo(rel, date_time=(1980, 1, 1, 0, 0, 0))
                info.external_attr = (os.stat(full).st_mode & 0xFFFF) << 16
                with open(full, "rb") as f:
                    zf.writestr(info, f.read())
    return buf.getvalue()


def upload_package(gcs, path: str, include_base: bool = False) -> str:
    """Zips + uploads a local directory to the GCS KV; returns its URI.
    Content-addressed: identical trees dedupe to one upload."""
    blob = zip_directory(path, include_base=include_base)
    digest = hashlib.sha256(blob).hexdigest()[:24]
    uri = f"{PKG_PREFIX}{digest}"
    if gcs.call("kv_get", f"__pkg__/{digest}") is None:
        gcs.call("kv_put", f"__pkg__/{digest}", blob)
    return uri


def process_runtime_env(renv: Optional[dict], gcs) -> Optional[dict]:
    """Driver-side normalization via the plugin registry: local dirs ->
    uploaded package URIs, file specs inlined. Idempotent (URIs pass
    through). NOTE: the API layer validates keys against the DRIVER's
    registry before this runs — a plugin must be registered (or named in
    RAY_TPU_RUNTIME_ENV_PLUGINS) in the driver process as well as on the
    nodes; there are no node-side-only keys."""
    if not renv:
        return renv
    out = dict(renv)
    for key, plugin in _ordered_plugins(out):
        out[key] = plugin.process(out[key], out, gcs)
    return out


# ------------------------------------------------------------ materialize
def _fetch_package(gcs, uri: str, cache_dir: str) -> str:
    """Ensures `pkg:<hash>` is extracted locally; returns its directory."""
    digest = uri[len(PKG_PREFIX):]
    dest = os.path.join(cache_dir, "pkgs", digest)
    if os.path.isdir(dest):
        os.utime(dest)  # LRU touch
        return dest
    blob = gcs.call("kv_get", f"__pkg__/{digest}")
    if blob is None:
        raise FileNotFoundError(f"package {uri} not in GCS KV")
    tmp = dest + f".tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        zf.extractall(tmp)
    try:
        os.rename(tmp, dest)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)  # raced another worker
    return dest


def _venv_python(pip_spec: List[str], cache_dir: str) -> str:
    """Creates (or reuses) a virtualenv with `pip_spec` installed; returns
    its python executable (reference: pip.py:45 building the per-env
    virtualenv with inherited site-packages)."""
    digest = hashlib.sha256(
        json.dumps([sys.executable, sorted(pip_spec)]).encode()
    ).hexdigest()[:24]
    venv_dir = os.path.join(cache_dir, "venvs", digest)
    py = os.path.join(venv_dir, "bin", "python")
    ready = os.path.join(venv_dir, ".ready")
    lock = venv_dir + ".lock"
    if os.path.exists(ready):
        os.utime(venv_dir)
        return py
    os.makedirs(os.path.dirname(venv_dir), exist_ok=True)
    # Cross-process creation lock (concurrent spawns for the same env).
    import fcntl

    with open(lock, "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            if os.path.exists(ready):
                return py
            if os.path.isdir(venv_dir):
                shutil.rmtree(venv_dir, ignore_errors=True)
            subprocess.run(
                [sys.executable, "-m", "venv", "--system-site-packages", venv_dir],
                check=True,
                capture_output=True,
            )
            # --system-site-packages points at the BASE interpreter's
            # site; when this process itself runs in a venv, the parent's
            # packages (torch, numpy, setuptools, ...) would be invisible. A .pth appends the parent's
            # site-packages AFTER the venv's own, so pip-installed
            # packages still shadow inherited ones.
            parent_sites = [p for p in sys.path if p.rstrip("/").endswith("site-packages")]
            if parent_sites:
                import glob as _glob

                for site_dir in _glob.glob(
                    os.path.join(venv_dir, "lib", "python*", "site-packages")
                ):
                    with open(os.path.join(site_dir, "_parent_sites.pth"), "w") as f:
                        f.write("\n".join(parent_sites) + "\n")
            if pip_spec:
                subprocess.run(
                    [py, "-m", "pip", "install", "--no-input", *pip_spec],
                    check=True,
                    capture_output=True,
                )
            with open(ready, "w") as f:
                f.write("ok")
        except subprocess.CalledProcessError as e:
            raise RuntimeError(
                f"runtime_env pip setup failed: {e.stderr.decode(errors='replace')[-2000:]}"
            ) from e
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)
    return py


def materialize_runtime_env(
    renv: Optional[dict], gcs, cache_dir: str = DEFAULT_CACHE
) -> Tuple[str, dict]:
    """Node-side realization before worker spawn, via the plugin
    registry: returns (python_executable, resolved_env) where
    resolved_env has local paths for working_dir/py_modules, env_vars
    merged with plugin-added ones, and `_command_prefix` when a container
    plugin wraps the worker command. Cheap when everything is cached."""
    if not renv:
        return sys.executable, {}
    os.makedirs(cache_dir, exist_ok=True)
    resolved = dict(renv)
    ctx = RuntimeEnvContext()
    for key, plugin in _ordered_plugins(resolved):
        plugin.materialize(resolved[key], resolved, ctx, gcs, cache_dir)
    if ctx.env_vars:
        merged = dict(ctx.env_vars)
        merged.update(resolved.get("env_vars") or {})  # user vars win
        resolved["env_vars"] = merged
    if ctx.command_prefix:
        resolved["_command_prefix"] = ctx.command_prefix
    gc_cache(cache_dir)
    return ctx.py_executable, resolved


# --------------------------------------------------------- builtin plugins


class WorkingDirPlugin(RuntimeEnvPlugin):
    name = "working_dir"
    priority = 5

    def process(self, value, renv, gcs):
        if value and not value.startswith(PKG_PREFIX) and os.path.isdir(value):
            return upload_package(gcs, value)
        return value

    def materialize(self, value, resolved, ctx, gcs, cache_dir):
        if value and value.startswith(PKG_PREFIX):
            resolved["working_dir"] = _fetch_package(gcs, value, cache_dir)


class PyModulesPlugin(RuntimeEnvPlugin):
    name = "py_modules"
    priority = 5

    def process(self, value, renv, gcs):
        uris = []
        for m in value or []:
            if isinstance(m, str) and not m.startswith(PKG_PREFIX) and os.path.isdir(m):
                uris.append(upload_package(gcs, m, include_base=True))
            else:
                uris.append(m)
        return uris

    def materialize(self, value, resolved, ctx, gcs, cache_dir):
        paths = []
        for m in value or []:
            if isinstance(m, str) and m.startswith(PKG_PREFIX):
                paths.append(_fetch_package(gcs, m, cache_dir))
            else:
                paths.append(m)
        resolved["py_modules"] = paths


class PipPlugin(RuntimeEnvPlugin):
    """Virtualenv per requirements hash (reference: pip.py:45)."""

    name = "pip"
    priority = 10

    def process(self, value, renv, gcs):
        if isinstance(value, str):
            # requirements.txt path: inline lines so the env hash captures
            # content, not the path (reference: pip.py reading requirements).
            with open(value) as f:
                return [
                    ln.strip() for ln in f if ln.strip() and not ln.startswith("#")
                ]
        return value

    def materialize(self, value, resolved, ctx, gcs, cache_dir):
        if value:
            ctx.py_executable = _venv_python(list(value), cache_dir)


class CondaPlugin(RuntimeEnvPlugin):
    """Conda env from a spec dict (environment.yml content) or an existing
    env name (reference: _private/runtime_env/conda.py — spec envs are
    content-hashed and created under the cache; named envs resolve to
    their interpreter)."""

    name = "conda"
    priority = 10

    def process(self, value, renv, gcs):
        if isinstance(value, str) and (
            value.endswith(".yml") or value.endswith(".yaml")
        ) and os.path.exists(value):
            import yaml  # type: ignore

            with open(value) as f:
                return yaml.safe_load(f)
        return value

    def materialize(self, value, resolved, ctx, gcs, cache_dir):
        conda = shutil.which("conda")
        if conda is None:
            raise RuntimeError(
                "runtime_env 'conda' requires a conda binary on PATH of every "
                "node; none found (use the 'pip' field, or install miniconda on "
                "the nodes)"
            )
        if isinstance(value, str):
            # Existing named env.
            base = subprocess.run(
                [conda, "info", "--base"], capture_output=True, text=True, check=True
            ).stdout.strip()
            py = os.path.join(base, "envs", value, "bin", "python")
            if not os.path.exists(py):
                raise RuntimeError(f"conda env {value!r} not found under {base}/envs")
            ctx.py_executable = py
            return
        digest = hashlib.sha256(
            json.dumps(value, sort_keys=True).encode()
        ).hexdigest()[:24]
        env_dir = os.path.join(cache_dir, "conda", digest)
        py = os.path.join(env_dir, "bin", "python")
        ready = os.path.join(env_dir, ".ready")
        if os.path.exists(ready):
            os.utime(env_dir)
            ctx.py_executable = py
            return
        os.makedirs(os.path.dirname(env_dir), exist_ok=True)
        import fcntl

        with open(env_dir + ".lock", "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                if os.path.exists(ready):
                    ctx.py_executable = py
                    return
                spec_file = env_dir + ".yml"
                with open(spec_file, "w") as f:
                    json.dump(value, f)  # YAML is a JSON superset
                subprocess.run(
                    [conda, "env", "create", "-p", env_dir, "-f", spec_file],
                    check=True,
                    capture_output=True,
                )
                with open(ready, "w") as f:
                    f.write("ok")
            except subprocess.CalledProcessError as e:
                raise RuntimeError(
                    "conda env create failed: "
                    + e.stderr.decode(errors="replace")[-2000:]
                ) from e
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)
        ctx.py_executable = py


class ImageUriPlugin(RuntimeEnvPlugin):
    """Containerized workers (reference: _private/runtime_env/image_uri.py):
    the worker command is wrapped in `podman run` with the session dir
    (UDS sockets + shm store) and env cache bind-mounted so the container
    reaches the raylet and object store. Priority AFTER interpreter
    plugins: the prefix wraps whatever interpreter they chose."""

    name = "image_uri"
    priority = 20

    def materialize(self, value, resolved, ctx, gcs, cache_dir):
        runtime = shutil.which("podman") or shutil.which("docker")
        if runtime is None:
            raise RuntimeError(
                "runtime_env 'image_uri' requires podman or docker on every "
                "node; neither found on PATH"
            )
        ctx.command_prefix = self.command_prefix(runtime, value, cache_dir)

    # Sentinel the raylet replaces with `--env K=V` pairs for every env
    # var it ADDS at spawn (RAY_TPU_RUNTIME_ENV, CUDA_VISIBLE_DEVICES, user
    # env_vars) — docker has no --env-host, and without these the worker
    # inside the container never sees its runtime env.
    ENV_ARGS_SENTINEL = "__RAY_TPU_ENV_ARGS__"

    @classmethod
    def command_prefix(cls, runtime: str, image: str, cache_dir: str) -> List[str]:
        tmp = tempfile.gettempdir()
        prefix = [
            runtime,
            "run",
            "--rm",
            "--network=host",
            "--ipc=host",  # shm store segments must be shared
            "-v",
            f"{tmp}:{tmp}",  # session dir: UDS sockets, store, logs
            "-v",
            f"{cache_dir}:{cache_dir}",
        ]
        if runtime.endswith("podman"):
            prefix.append("--env-host")  # podman forwards the full client env
        else:
            prefix.append(cls.ENV_ARGS_SENTINEL)  # docker: explicit --env pairs
        prefix.append(image)
        return prefix


class EnvVarsPlugin(RuntimeEnvPlugin):
    name = "env_vars"
    priority = 1
    # env_vars ride the resolved dict untouched; the raylet applies them
    # at spawn. The plugin exists so ordering/registry is uniform.


for _p in (
    EnvVarsPlugin(),
    WorkingDirPlugin(),
    PyModulesPlugin(),
    PipPlugin(),
    CondaPlugin(),
    ImageUriPlugin(),
):
    register_plugin(_p)


MIN_EVICT_AGE_S = 3600.0  # never evict anything touched within the hour


def gc_cache(cache_dir: str = DEFAULT_CACHE) -> None:
    """Evicts least-recently-used packages/venvs beyond the caps
    (reference: uri_cache.py size-capped GC of unused URIs). Entries
    touched within MIN_EVICT_AGE_S are never evicted regardless of the
    cap — a recently-materialized env is very likely backing a LIVE
    worker (the reference keeps explicit used/unused accounting; the age
    gate is the collapsed version, trading a bounded cache overshoot for
    not deleting a running worker's interpreter)."""
    now = time.time()
    for sub, cap in (("pkgs", MAX_CACHED_PACKAGES), ("venvs", MAX_CACHED_VENVS)):
        root = os.path.join(cache_dir, sub)
        try:
            entries = [
                (os.path.getmtime(os.path.join(root, d)), os.path.join(root, d))
                for d in os.listdir(root)
                if not d.endswith(".lock") and not d.endswith(".tmp")
            ]
        except OSError:
            continue
        entries.sort(reverse=True)
        for mtime, path in entries[cap:]:
            if now - mtime < MIN_EVICT_AGE_S:
                continue
            shutil.rmtree(path, ignore_errors=True)
