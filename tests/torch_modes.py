"""Both runtimes of both packages for the side-by-side Serve, LLM and Tune
tests: each case runs on `init(local_mode=True)` and on a cluster of worker
processes, in the JAX package and in the port.

A test file boots at most one cluster of each package (its module fixture
wraps `Clusters`), on first use: every JAX `Cluster()` sweeps
/dev/shm/rtpu_* and can unlink a starting node's pool in another test
process (ROADMAP Queue 3), so it boots once per file. A case takes the
cluster's runtime for its run and puts it back after, so local-mode cases
of the same file run in between.

Every test_torch_* file boots the JAX package's clusters through
`boot_jax_cluster` (or `jax_boot` for `start_worker_node`).
"""

import contextlib
import faulthandler
import fcntl
import hashlib
import importlib
import os
import shutil
import signal
import tempfile
import threading

import pytest

class CaseTimeLimitError(Exception):
    """A case ran past its own time limit (case_time_limit)."""


def _raise_time_limit(signum, frame):
    raise CaseTimeLimitError("the case ran past its time limit; every thread's stack is "
                             "printed above it on stderr")


@contextlib.contextmanager
def case_time_limit(request, seconds, grace=30.0):
    """A case's own limit, so a hang (a deadlock of the JAX package's runtime,
    ROADMAP Queue 3) fails that case alone instead of holding its xdist
    worker until the whole run is cut. Past `seconds` a watchdog thread
    prints every thread's stack to the process's real stderr (pytest's
    capture set aside) and interrupts the main thread (SIGUSR1), whose
    blocking call then raises CaseTimeLimitError: the case fails and its
    teardown runs. A case still not unwound `grace` seconds later exits the
    worker; since xdist's loadfile scheduling runs a crashed case again on
    the next worker, that run finds the case's marker and fails at once."""
    run_id = os.environ.get("PYTEST_XDIST_TESTRUNUID") or str(os.getpid())
    key = hashlib.sha1(f"{run_id} {request.node.nodeid}".encode()).hexdigest()[:20]
    marker = os.path.join(tempfile.gettempdir(), "rtpt_case_limit", key)
    if os.path.exists(marker):
        pytest.fail(f"{request.node.nodeid} ran past its {seconds} s limit in an earlier "
                    "worker of this run (its stacks are printed there): not run again")
    capman = request.config.pluginmanager.getplugin("capturemanager")
    with capman.global_and_fixture_disabled() if capman else contextlib.nullcontext():
        err_fd = os.dup(2)
    main, done = threading.main_thread().ident, threading.Event()

    def watchdog():
        if done.wait(seconds):
            return
        os.makedirs(os.path.dirname(marker), exist_ok=True)
        open(marker, "w").close()
        os.write(err_fd, f"\n{request.node.nodeid} ran past its {seconds} s limit; every "
                         f"thread's stack:\n".encode())
        faulthandler.dump_traceback(file=err_fd, all_threads=True)
        signal.pthread_kill(main, signal.SIGUSR1)
        if not done.wait(grace):
            os.write(err_fd, f"{request.node.nodeid} did not unwind within {grace} s: "
                             "exiting this worker\n".encode())
            os._exit(1)

    previous = signal.signal(signal.SIGUSR1, _raise_time_limit)
    threading.Thread(target=watchdog, daemon=True, name="case-time-limit").start()
    try:
        yield
    finally:
        done.set()
        signal.signal(signal.SIGUSR1, previous)
        os.close(err_fd)


# One lock file for every test process of the port: a JAX boot holds it from
# its sweep of /dev/shm/rtpu_* until the cluster answers.
JAX_BOOT_LOCK = os.path.join(tempfile.gettempdir(), "rtpt_jax_boot.lock")


@contextlib.contextmanager
def _jax_boot_lock():
    fd = os.open(JAX_BOOT_LOCK, os.O_RDWR | os.O_CREAT, 0o666)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def jax_boot(fn, *args, **kwargs):
    """fn(*args, **kwargs) under the JAX boot lock: a JAX `Cluster()` or
    `start_worker_node`, whose session looks dead to a sweep until its
    sockets answer. The lock keeps the port's test processes from sweeping
    during each other's boots; the JAX package's own test files do not take
    it (hence the retry in `boot_jax_cluster`)."""
    with _jax_boot_lock():
        return fn(*args, **kwargs)


def _lost_own_socket(cluster, err) -> bool:
    """The swept-session signature: a connect to a socket in this boot's own
    session dir found no file (another process's sweep removed the dir)."""
    session = getattr(cluster, "session_dir", None)
    return (session is not None and isinstance(err.last_error, FileNotFoundError)
            and os.path.dirname(os.path.realpath(err.address)) == os.path.realpath(session))


def _discard_half_booted(cluster) -> None:
    """Kills what a failed JAX `Cluster()` started (its daemons and whatever
    names its session dir on its command line: the zygote, workers) and
    removes its pools and session dir."""
    session = getattr(cluster, "session_dir", None)
    procs = list(getattr(cluster, "_procs", []))
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait(timeout=10)
    if session:
        for pid in os.listdir("/proc"):
            if not pid.isdigit() or int(pid) == os.getpid():
                continue
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmd = f.read()
            except OSError:
                continue
            if session.encode() in cmd:
                try:
                    os.kill(int(pid), signal.SIGKILL)
                except OSError:
                    pass
    for path in getattr(cluster, "_store_paths", {}).values():
        try:
            os.unlink(path)
        except OSError:
            pass
    if session:
        shutil.rmtree(session, ignore_errors=True)


def boot_jax_cluster(**kwargs):
    """The JAX package's `Cluster(**kwargs)`, booted under the JAX boot lock.
    A boot that fails with the swept-session signature (ROADMAP Queue 3: the
    JAX sweep unlinked this boot's own socket) is shut down and booted once
    more; any other failure, or a second one, is raised. The port's own boot
    is never retried."""
    from ray_tpu.core.cluster_runtime import Cluster
    from ray_tpu.exceptions import RpcUnavailableError

    for attempt in (1, 2):
        cluster = Cluster.__new__(Cluster)
        try:
            jax_boot(cluster.__init__, **kwargs)
            return cluster
        except RpcUnavailableError as e:
            _discard_half_booted(cluster)
            if attempt == 2 or not _lost_own_socket(cluster, e):
                raise
            print(f"JAX Cluster() lost its own socket {e.address} (the JAX pool sweep of "
                  f"another process, ROADMAP Queue 3): shut it down, booting once more",
                  flush=True)
        except BaseException:
            _discard_half_booted(cluster)
            raise

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
                cluster = boot_jax_cluster(num_cpus=self.num_cpus, num_workers=2)
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
