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
import sys
import tempfile
import threading

import pytest

class CaseTimeLimitError(Exception):
    """A case ran past its own time limit (case_time_limit)."""


class FixtureTimeLimitError(Exception):
    """A module fixture's cluster boot or teardown ran past its limit
    (fixture_time_limit)."""


@contextlib.contextmanager
def _watchdog(seconds, err_fd, label, on_expiry, error, grace=30.0):
    """Bounds the block by `seconds`. Past them a watchdog thread writes
    `label` and every thread's stack to `err_fd` (a dup of the real stderr,
    closed on exit), calls `on_expiry()` and interrupts the main thread
    (SIGUSR1), whose blocking call then raises `error`. A block still not
    unwound `grace` seconds later exits the worker, which xdist reports as a
    crash. Entered off the main thread, it prints and calls `on_expiry` but
    interrupts nothing."""
    main, done = threading.main_thread().ident, threading.Event()
    in_main = threading.current_thread() is threading.main_thread()

    def raise_error(signum, frame):
        raise error

    def watchdog():
        if done.wait(seconds):
            return
        os.write(err_fd, f"\n{label} ran past its {seconds} s limit; every thread's "
                         "stack:\n".encode())
        faulthandler.dump_traceback(file=err_fd, all_threads=True)
        try:
            on_expiry()
        except Exception as e:  # noqa: BLE001 - the interrupt below still fails it
            os.write(err_fd, f"{label}: on_expiry raised {e!r}\n".encode())
        if not in_main:
            return
        signal.pthread_kill(main, signal.SIGUSR1)
        if not done.wait(grace):
            os.write(err_fd, f"{label} did not unwind within {grace} s of its limit: exiting "
                             "this worker\n".encode())
            os._exit(1)

    previous = signal.signal(signal.SIGUSR1, raise_error) if in_main else None
    threading.Thread(target=watchdog, daemon=True, name="time-limit").start()
    try:
        yield
    finally:
        done.set()
        if in_main:
            signal.signal(signal.SIGUSR1, previous)
        os.close(err_fd)


@contextlib.contextmanager
def case_time_limit(request, seconds, grace=30.0):
    """A case's own limit, so a hang (a deadlock of the JAX package's runtime,
    ROADMAP Queue 3) fails that case alone instead of holding its xdist
    worker until the whole run is cut: `_watchdog` prints every thread's
    stack to the process's real stderr (pytest's capture set aside), and the
    case's blocking call raises CaseTimeLimitError, so the case fails and
    its teardown runs. Past the limit it also leaves a marker: since xdist's
    loadfile scheduling runs a case that crashed its worker again on the
    next worker, that run finds the marker and fails at once."""
    run_id = os.environ.get("PYTEST_XDIST_TESTRUNUID") or str(os.getpid())
    key = hashlib.sha1(f"{run_id} {request.node.nodeid}".encode()).hexdigest()[:20]
    marker = os.path.join(tempfile.gettempdir(), "rtpt_case_limit", key)
    if os.path.exists(marker):
        pytest.fail(f"{request.node.nodeid} ran past its {seconds} s limit in an earlier "
                    "worker of this run (its stacks are printed there): not run again")
    capman = request.config.pluginmanager.getplugin("capturemanager")
    with capman.global_and_fixture_disabled() if capman else contextlib.nullcontext():
        err_fd = os.dup(2)

    def leave_marker():
        os.makedirs(os.path.dirname(marker), exist_ok=True)
        open(marker, "w").close()

    error = CaseTimeLimitError("the case ran past its time limit; every thread's stack is "
                               "printed above it on stderr")
    with _watchdog(seconds, err_fd, request.node.nodeid, leave_marker, error, grace):
        yield


# The limits of a module fixture's cluster boot and teardown: about three
# times the slowest seen in the port's test files under 6 xdist workers
# (`pytest --durations=0`'s setup and teardown rows: boot 13.3 s, teardown
# 22.3 s; CHANGES.md), and never under 60 s.
BOOT_LIMIT_S = 60.0
TEARDOWN_LIMIT_S = 90.0


@contextlib.contextmanager
def fixture_time_limit(seconds, on_expiry, grace=30.0):
    """Bounds a module fixture's cluster boot or teardown, which no case limit
    covers (a JAX cluster's teardown once held an xdist worker for ~18
    minutes, ROADMAP Queue 3), with `_watchdog`: past `seconds` it prints
    every thread's stack to the real stderr, calls `on_expiry()` (which
    kills what the cluster started), and the block's blocking call raises
    FixtureTimeLimitError naming the file, so the fixture fails and its
    cases error. It never holds the worker and never passes silently.
    Entered off the main thread (a boot under torch_waits.bounded, whose own
    deadline fails the case), it prints and kills but interrupts nothing."""
    where = _fixture_site()
    label = f"{where}: a module fixture's cluster boot or teardown"
    error = FixtureTimeLimitError(f"{label} ran past its {seconds} s limit; every thread's "
                                  "stack is printed above it on stderr")
    with _watchdog(seconds, _real_stderr_fd(), label, on_expiry, error, grace):
        yield


def _fixture_site() -> str:
    """The test file whose fixture is bounded, and pytest's current case."""
    frame, name = sys._getframe(1), "an unknown file"
    while frame is not None:
        base = os.path.basename(frame.f_code.co_filename)
        if base.startswith("test_"):
            name = base
            break
        frame = frame.f_back
    return f"{name} ({os.environ.get('PYTEST_CURRENT_TEST', 'no case')})"


def _real_stderr_fd() -> int:
    """A dup of the process's real stderr, pytest's capture set aside: its
    capture manager is found through the `request` (or `item`) of a pytest
    frame up the stack, as fixtures take no request of their own here."""
    frame = sys._getframe(1)
    while frame is not None:
        for name in ("request", "item"):
            config = getattr(frame.f_locals.get(name), "config", None)
            capman = config and config.pluginmanager.getplugin("capturemanager")
            if capman:
                with capman.global_and_fixture_disabled():
                    return os.dup(2)
        frame = frame.f_back
    return os.dup(2)


def boot_cluster(cls, **kwargs):
    """`cls(**kwargs)` (the port's Cluster) under fixture_time_limit: a boot
    past BOOT_LIMIT_S kills what it started and fails the fixture."""
    cluster = cls.__new__(cls)
    with fixture_time_limit(BOOT_LIMIT_S, lambda: discard_cluster(cluster)):
        cluster.__init__(**kwargs)
    return cluster


def descendants() -> set:
    """The pids of every living process under this one."""
    children = {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        children.setdefault(ppid, []).append(int(pid))
    out, todo = set(), [os.getpid()]
    while todo:
        for child in children.get(todo.pop(), ()):
            if child not in out:
                out.add(child)
                todo.append(child)
    return out


def kill_started_since(before: set) -> None:
    for pid in descendants() - before:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass


def bounded_init(pkg, **kwargs):
    """`pkg.init(**kwargs)` (a cluster behind the package's own runtime)
    under fixture_time_limit: past BOOT_LIMIT_S every process the boot
    started under this one is killed and the fixture fails."""
    before = descendants()
    with fixture_time_limit(BOOT_LIMIT_S, lambda: kill_started_since(before)):
        pkg.init(**kwargs)


def shutdown_init(pkg):
    """`pkg.shutdown()` of a runtime `bounded_init` started, under
    fixture_time_limit; past TEARDOWN_LIMIT_S the cluster's processes are
    killed, found through the runtime's cluster."""
    base = importlib.import_module(f"{pkg.__name__}.core.runtime_base")
    cluster = getattr(base.maybe_runtime(), "_cluster", None)
    with fixture_time_limit(TEARDOWN_LIMIT_S, lambda: cluster and discard_cluster(cluster)):
        pkg.shutdown()


def shutdown_cluster(cluster, *first):
    """Each of `first()` (a runtime's or a package's shutdown), then
    `cluster.shutdown()` even if one raised, under fixture_time_limit: a
    teardown past TEARDOWN_LIMIT_S kills what the cluster started and fails
    the fixture instead of holding the worker."""
    with fixture_time_limit(TEARDOWN_LIMIT_S, lambda: discard_cluster(cluster)):
        try:
            for fn in first:
                fn()
        finally:
            cluster.shutdown()


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


def discard_cluster(cluster) -> None:
    """Kills what a failed or stalled `Cluster()` of either package started
    (its daemons and whatever names its session dir on its command line:
    the zygote, workers) and removes its pools and session dir. Safe on a
    cluster whose boot did not finish."""
    session = getattr(cluster, "session_dir", None)
    procs = getattr(cluster, "_procs", [])
    procs = list(procs.values() if isinstance(procs, dict) else procs)  # the port keys them
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
            with fixture_time_limit(BOOT_LIMIT_S, lambda: discard_cluster(cluster)):
                jax_boot(cluster.__init__, **kwargs)
            return cluster
        except RpcUnavailableError as e:
            discard_cluster(cluster)
            if attempt == 2 or not _lost_own_socket(cluster, e):
                raise
            print(f"JAX Cluster() lost its own socket {e.address} (the JAX pool sweep of "
                  f"another process, ROADMAP Queue 3): shut it down, booting once more",
                  flush=True)
        except BaseException:
            discard_cluster(cluster)
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

                cluster = boot_cluster(Cluster, num_cpus=self.num_cpus, num_gpus=0)
            self._booted[name] = (cluster, cluster.runtime())
        return self._booted[name][1]

    def booted(self, name):
        return self._booted.get(name, (None, None))[1]

    def shutdown(self):
        errors = []
        for cluster, runtime in self._booted.values():
            try:
                shutdown_cluster(cluster, runtime.shutdown)
            except BaseException as e:  # noqa: BLE001 - the others still go down
                errors.append(e)
        self._booted.clear()
        if errors:
            raise errors[0]


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
