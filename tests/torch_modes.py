"""Both runtimes of both packages for the side-by-side Serve, LLM and Tune
tests: each case runs on `init(local_mode=True)` and on a cluster of worker
processes, in the JAX package and in the port.

A test file boots at most one cluster of each package (its module fixture
wraps `Clusters`), on first use: every JAX `Cluster()` sweeps
/dev/shm/rtpu_* and can unlink a starting node's pool in another test
process (ROADMAP Queue 3), so it boots once per file. A case takes the
cluster's runtime for its run and puts it back after, so local-mode cases
of the same file run in between.
"""

import contextlib
import importlib

PARAMS = [(p, m) for p in ("jax", "torch") for m in ("local", "cluster")]
# Local-mode cases keep the ids they had before the cluster mode came.
IDS = [p if m == "local" else f"{p}-{m}" for p, m in PARAMS]
PACKAGES = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}


class Clusters:
    """One cluster of each package, booted when a case first asks for it."""

    def __init__(self, num_cpus):
        self.num_cpus = num_cpus
        self._booted = {}

    def runtime(self, name):
        if name not in self._booted:
            if name == "jax":
                from ray_tpu.core.cluster_runtime import Cluster

                cluster = Cluster(num_cpus=self.num_cpus, num_workers=2)
            else:
                from ray_tpu_torch.core.cluster_runtime import Cluster

                cluster = Cluster(num_cpus=self.num_cpus, num_gpus=0)
            self._booted[name] = (cluster, cluster.runtime())
        return self._booted[name][1]

    def booted(self, name):
        return self._booted.get(name, (None, None))[1]

    def shutdown(self):
        for cluster, runtime in self._booted.values():
            try:
                runtime.shutdown()
            finally:
                cluster.shutdown()
        self._booted.clear()


@contextlib.contextmanager
def runtime_for(clusters, name, mode, num_cpus):
    """Makes `name`'s package run on `mode` for the body; yields the
    package module."""
    pkg = importlib.import_module(PACKAGES[name])
    base = importlib.import_module(f"{PACKAGES[name]}.core.runtime_base")
    current = base.maybe_runtime()
    if current is not None and (clusters is None or current is not clusters.booted(name)):
        pkg.shutdown()
    base.set_runtime(None)
    if mode == "local":
        pkg.init(local_mode=True, num_cpus=num_cpus)
    else:
        base.set_runtime(clusters.runtime(name))
    try:
        yield pkg
    finally:
        if mode == "local":
            pkg.shutdown()
        else:
            base.set_runtime(None)
