"""Zygote: forks pre-warmed worker processes (the port of
ray_tpu/core/zygote.py).

Re-design of the reference's worker start-up (reference: worker_pool.h
prestarted idle workers). A fresh worker pays the interpreter and
`import torch` (about 2 s on a CPU box) before it can poll for work. The
zygote pays that once: a daemon with one Python thread that imports the
worker stack and torch, listens on a UDS, and `fork()`s a ready worker per
request.

CUDA and fork. The zygote imports torch and never touches CUDA: no
`torch.cuda` query (`is_available`, `device_count`, ...) and no tensor
operation, so the CUDA driver is never initialised here and no CPU op has
started torch's intra-op or OpenMP thread pool, after which a fork can hang.
A forked child that then uses CUDA is not in a "bad fork": its first
`cuInit` happens in the child. Children are device-agnostic until assigned:
the assignment carries the worker's environment, CUDA_VISIBLE_DEVICES
included, and the driver reads that variable at the child's first `cuInit`,
so a leased device id takes effect. Variables that a library reads at import
(OMP_NUM_THREADS, MKL_*) keep the zygote's values, so a spawn whose
environment changes them must not fork from here (the raylet Popens those).
`stats` reports `torch.cuda.is_initialized()`, which reads a flag and
initialises nothing, so a test can check the contract.

Two tiers serve a spawn request:

- **Parked pre-forks** (the warm path): children forked ahead of time, each
  blocked on a private pipe until the zygote writes its assignment. A pop
  is one pipe write. The raylet's pool manager sizes this pool
  (`{"pool": N}`).
- **Cold fork** (the miss path): fork on demand when no child is parked.

Batched spawns (`{"batch": [...]}`) cost one socket round trip for N
workers.

The device stack. On a machine with an NVIDIA driver (`/dev/nvidiactl`; a
file test, not a CUDA call) the zygote also imports what the first dispatch
of the registered flash op imports (`torch._dynamo`, `torch._inductor`,
sympy: ~840 modules, seconds), so a forked GPU worker does not pay it at its
first `flash_attention`. The readiness socket does not wait for it: once no
spawn has come for `_QUIET_BEFORE_IMPORT_S` (since binding, or since the
last spawn, so a burst of launches is served first), the accept loop imports
one module of that stack whenever no request is waiting (a request that
comes during an import waits for that one module), then re-forks its parked
children so they hold it too; `stats` says when it is in (`device_stack`).
Importing these touches no CUDA (the cluster phase of chip_smoke.py checks
the zygote's `cuda_initialized` and its /dev/nvidia* files).

Exit status. The zygote reaps its children, so the raylet cannot wait for
them; a spawn request may name a `status` file, and the zygote writes the
child's exit status there, decoded as Popen's `returncode` (the exit code,
or minus the number of the signal that killed it), before it reaps the
child: it peeks with `waitid(WNOWAIT)`, writes, then reaps. A dead child's
/proc entry (a zombie's) thus lasts until its status is on disk, and
`PidHandle` reads the file once /proc shows the worker gone. The JAX
zygote drops the status (its `_reap`), and its PidHandle reports -1 for
every forked worker however it died.

Protocol (one JSON line per request and reply over the UDS):
  {"argv": [...], "env": {...}, "out": path, "err": path[, "status": path]}
      -> {"pid": N, "warm": bool}
  {"batch": [spawn_req, ...]}   -> {"spawns": [{"pid": N, "warm": b}|{"error": s}]}
  {"pool": N}                   -> {"parked": N_now, "forked": K}
  {"stats": true}               -> {"parked": N, "pid": pid, "cuda_initialized": b,
                                    "device_stack": b}
  {"reset": true}               -> {"drained": K}   (parked children exit)
  {"stop": true}                -> (daemon exits; parked children die with it)
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import select
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

# PR_SET_PDEATHSIG, bound at import so set_pdeathsig() allocates and
# imports nothing: it runs in a fork child.
_PRCTL = None
try:
    import ctypes as _ctypes

    _PRCTL = _ctypes.CDLL(None, use_errno=True).prctl
except (OSError, AttributeError):  # no libc prctl: stays a no-op
    _PRCTL = None
_PR_SET_PDEATHSIG = 1


def set_pdeathsig(sig: int = signal.SIGTERM) -> None:
    """Parent-death signal, so a killed zygote leaks no forked worker. It
    fires when the parent THREAD that forked dies, which for a zygote child
    is the zygote's only thread. No-op where prctl is missing; fork clears
    it, so every child arms it again."""
    if _PRCTL is None:
        return
    _PRCTL(_PR_SET_PDEATHSIG, int(sig), 0, 0, 0)


# Status files of assigned children, pid -> path, and the statuses of
# children reaped before (or without) an assignment, pid -> returncode. Both
# are touched by the SIGCHLD handler and by the main loop, which holds
# SIGCHLD blocked while it forks and books a child (_sigchld_held).
_STATUS_PATHS: Dict[int, str] = {}
_UNCLAIMED: "collections.OrderedDict[int, int]" = collections.OrderedDict()
_UNCLAIMED_CAP = 256


@contextlib.contextmanager
def _sigchld_held():
    """SIGCHLD blocked for the body: a child forked inside it is booked
    before the reaper can see it. A fork child inherits the mask and drops
    it in _child_exec."""
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGCHLD})
    try:
        yield
    finally:
        signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGCHLD})


def _write_status(path: str, rc: int) -> None:
    try:
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            f.write(str(rc))
        os.replace(tmp, path)
    except OSError:
        pass  # the raylet then reads the status as unknown (-1)


def _booked(pid: int, path: Optional[str]) -> None:
    """A fresh fork's bookkeeping (SIGCHLD held): a status left under a
    recycled pid is dropped, and the child's status file is noted."""
    _UNCLAIMED.pop(pid, None)
    if path:
        _STATUS_PATHS[pid] = path


def _claim(pid: int, path: Optional[str]) -> None:
    """A parked child's assignment names its status file; a status reaped
    before the claim is written at once."""
    if not path:
        return
    _STATUS_PATHS[pid] = path
    rc = _UNCLAIMED.pop(pid, None)
    if rc is not None and _STATUS_PATHS.pop(pid, None) is not None:
        _write_status(path, rc)


def _reap(signum, frame):
    """Collects exited children, so none lingers as a zombie. Each one's
    status is peeked (WNOWAIT) and written to its status file before the
    reap, so the raylet, which sees death through /proc, finds the file as
    soon as the pid is gone."""
    while True:
        try:
            info = os.waitid(os.P_ALL, 0, os.WEXITED | os.WNOHANG | os.WNOWAIT)
        except ChildProcessError:
            return
        if info is None or info.si_pid == 0:
            return
        pid = info.si_pid
        rc = info.si_status if info.si_code == os.CLD_EXITED else -info.si_status
        path = _STATUS_PATHS.pop(pid, None)
        if path:
            _write_status(path, rc)
        else:
            _UNCLAIMED[pid] = rc
            while len(_UNCLAIMED) > _UNCLAIMED_CAP:
                _UNCLAIMED.popitem(last=False)
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass


_CHILD_CLOSE: list = []  # sockets a fork child must not inherit
# Parked children: [(pid, assignment pipe write fd)]. Every fork child closes
# the current write ends at once (_close_inherited), so each parked child's
# pipe has one writer, the zygote, and its close is a reliable exit signal.
_PARKED: List[Tuple[int, int]] = []


def _close_inherited() -> None:
    """Drops the fds a fork child must not keep: the listener (an inherited
    backlog would make clients of a dead zygote block in connect), accepted
    connections, and the parked siblings' pipe write ends."""
    for s in _CHILD_CLOSE:
        try:
            s.close()
        except OSError:
            pass
    for _pid, wfd in _PARKED:
        try:
            os.close(wfd)
        except OSError:
            pass


def _child_exec(req: dict) -> None:
    """Runs in the fork child: applies the assignment (log redirects,
    environment, argv) and becomes the worker. Never returns."""
    try:
        out = os.open(req["out"], os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        err = os.open(req["err"], os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        os.dup2(out, 1)
        os.dup2(err, 2)
        os.close(out)
        os.close(err)
        os.environ.clear()
        os.environ.update(req["env"])
        signal.signal(signal.SIGCHLD, signal.SIG_DFL)
        signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGCHLD})
        from ray_tpu_torch.core import worker_proc

        worker_proc.main(req["argv"])
        os._exit(0)
    except SystemExit as e:
        os._exit(int(e.code or 0))
    except BaseException:  # noqa: BLE001 - the child must never return into the zygote
        import traceback

        traceback.print_exc()
        os._exit(1)


def _spawn(req: dict) -> int:
    """Cold fork: forks and applies the assignment at once."""
    with _sigchld_held():
        pid = os.fork()
        if pid != 0:
            _booked(pid, req.get("status"))
            return pid
    try:
        _close_inherited()
        os.setsid()  # its own process group: the raylet's signals reach it alone
        set_pdeathsig(signal.SIGTERM)
    except BaseException:  # noqa: BLE001 - a fork child exits, never returns
        os._exit(1)
    _child_exec(req)


def _prefork() -> Optional[Tuple[int, int]]:
    """Forks one parked child, blocked on a private pipe until the zygote
    writes its assignment (a pop) or closes the write end (reset or zygote
    death). Returns (pid, write fd), or None when the fork failed (pid or
    memory pressure must neither leak the pipe nor take the daemon down)."""
    try:
        rfd, wfd = os.pipe()
    except OSError:
        return None
    with _sigchld_held():
        try:
            pid = os.fork()
        except OSError:
            os.close(rfd)
            os.close(wfd)
            return None
        if pid != 0:
            _booked(pid, None)
            os.close(rfd)
            return (pid, wfd)
    try:
        os.close(wfd)
        _close_inherited()
        os.setsid()
        set_pdeathsig(signal.SIGTERM)
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = os.read(rfd, 65536)
            if not chunk:
                os._exit(0)  # write end closed: reset or zygote death
            buf += chunk
        os.close(rfd)
        req = json.loads(buf)
    except BaseException:  # noqa: BLE001 - a fork child exits, never returns
        os._exit(1)
    _child_exec(req)


def _write_all(fd: int, data: bytes) -> None:
    """os.write until every byte lands: an assignment (env and argv) is
    often over PIPE_BUF, and a SIGCHLD mid-write returns a partial count."""
    view = memoryview(data)
    while view:
        n = os.write(fd, view)
        view = view[n:]


def _pop_parked(req: dict) -> Optional[int]:
    """Assigns `req` to a parked child; None when none is parked or every
    parked child turned out dead."""
    while _PARKED:
        pid, wfd = _PARKED.pop(0)
        try:
            _write_all(wfd, (json.dumps(req) + "\n").encode())
            os.close(wfd)
            return pid
        except OSError:  # died while parked: EPIPE; try the next one
            try:
                os.close(wfd)
            except OSError:
                pass
    return None


def _kill_parked(pid: int, wfd: int) -> None:
    """Closes a parked child's pipe (EOF: it exits) and sends SIGTERM for
    one stuck outside its read."""
    try:
        os.close(wfd)
    except OSError:
        pass
    try:
        os.kill(pid, signal.SIGTERM)
    except OSError:
        pass


def _drain_parked() -> int:
    n = 0
    while _PARKED:
        _kill_parked(*_PARKED.pop())
        n += 1
    return n


def _fill_pool(target: int) -> int:
    """Pre-forks parked children up to `target`; returns the forks done."""
    forked = 0
    while len(_PARKED) < target:
        entry = _prefork()
        if entry is None:
            break
        _PARKED.append(entry)
        forked += 1
    return forked


def _do_spawn(req: dict) -> dict:
    pid = _pop_parked(req)
    if pid is not None:
        _claim(pid, req.get("status"))
        return {"pid": pid, "warm": True}
    try:
        return {"pid": _spawn(req), "warm": False}
    except OSError as e:
        # The daemon is healthy, this fork failed: an answer (not a closed
        # socket) keeps the raylet from respawning the zygote for it.
        return {"error": f"fork failed: {e}"}


def _handle(req: dict) -> Optional[dict]:
    """One protocol request -> its reply (None: stop)."""
    if req.get("stop"):
        return None
    if req.get("stats"):
        torch = sys.modules.get("torch")
        return {"parked": len(_PARKED), "pid": os.getpid(),
                "cuda_initialized": bool(torch is not None and torch.cuda.is_initialized()),
                "device_stack": all(m in sys.modules for m in _PREWARM_DEVICE)}
    if req.get("reset"):
        return {"drained": _drain_parked()}
    if "pool" in req:
        target = max(0, int(req["pool"]))
        forked = _fill_pool(target)
        while len(_PARKED) > target:  # shrink, newest first
            _kill_parked(*_PARKED.pop())
        return {"parked": len(_PARKED), "forked": forked}
    if req.get("deadline", float("inf")) < time.time():
        # Its client timed out and went on without it (a Popen under a new
        # worker id): a fork now would only start a worker nobody adopts.
        return {"error": "spawn request expired before the daemon read it"}
    _LAST_SPAWN[0] = time.monotonic()
    if "batch" in req:
        return {"spawns": [_do_spawn(r) for r in req["batch"]]}
    return _do_spawn(req)


# The worker's import graph, loaded once here so a forked child inherits it.
# Import only: none of these touches CUDA or runs a torch op at import.
_PREWARM = (
    "torch",
    "numpy",
    "ray_tpu_torch.core.worker_proc",
    "ray_tpu_torch.core.cluster_runtime",
    "ray_tpu_torch.core.fastpath",
    "ray_tpu_torch.core.serialization",
    "ray_tpu_torch.core.shm_store",
    "ray_tpu_torch.ops.flash_attention",
    "ray_tpu_torch.models.transformer",
    "ray_tpu_torch.serve",
    "ray_tpu_torch.serve.llm",
    "ray_tpu_torch.train",
    "ray_tpu_torch.tune",
    "ray_tpu_torch.data",
)


# The first dispatch of `torch.ops.ray_tpu_torch.flash_fwd` (a
# torch.library.custom_op) through `flash_attention`: imported after the
# socket is bound, between requests, beside a card only (module docstring).
_PREWARM_DEVICE = ("sympy", "torch._dynamo", "torch._inductor")
# Those imports wait for this long without a spawn request.
_QUIET_BEFORE_IMPORT_S = 1.0
_LAST_SPAWN = [0.0]  # monotonic time of the last spawn request (or of binding)


def _prewarm_worker_stack() -> None:
    for mod in _PREWARM:
        __import__(mod)


def _device_stack_to_import() -> list:
    """The device stack's modules still to import: all of them beside an
    NVIDIA driver and none elsewhere (a CPU machine runs no flash kernel)."""
    if not os.path.exists("/dev/nvidiactl"):
        return []
    return [m for m in _PREWARM_DEVICE if m not in sys.modules]


def _import_when_idle(srv: socket.socket, pending: list) -> bool:
    """Imports the next module of `pending` once no spawn has come for
    `_QUIET_BEFORE_IMPORT_S` and no request is waiting; once the last one
    is in, re-forks the parked children so that they hold it. True when it
    imported something."""
    if not pending or time.monotonic() - _LAST_SPAWN[0] < _QUIET_BEFORE_IMPORT_S:
        return False
    if select.select([srv], [], [], 0)[0]:
        return False
    __import__(pending.pop(0))
    if not pending and _PARKED:
        n = _drain_parked()
        _fill_pool(n)
    return True


def main(sock_path: str, parent_pid: Optional[int] = None) -> None:
    # The zygote dies with its raylet: its accept loop watches the parent
    # pid (the raylet starts it from a thread that may exit, so pdeathsig
    # cannot tie the two), and its children die with it by pdeathsig. The
    # raylet passes its pid: one read here could already be init's, had the
    # raylet died before this line.
    boot_ppid = parent_pid or os.getppid()
    # Children inherit SIGUSR2 ignored until their worker binds its flight
    # dump to it (install_crash_hooks): a dump fan-out reaching a child
    # still in its boot must not kill it.
    signal.signal(signal.SIGUSR2, signal.SIG_IGN)
    signal.signal(signal.SIGCHLD, _reap)
    _prewarm_worker_stack()
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.settimeout(2.0)
    _CHILD_CLOSE.append(srv)
    if os.path.exists(sock_path):
        os.unlink(sock_path)
    srv.bind(sock_path + ".tmp")
    srv.listen(64)
    os.rename(sock_path + ".tmp", sock_path)  # readiness, atomically
    device_stack = _device_stack_to_import()
    _LAST_SPAWN[0] = time.monotonic()
    while True:
        if _import_when_idle(srv, device_stack):
            continue
        # While the device stack waits for a quiet second, look again soon.
        srv.settimeout(0.25 if device_stack else 2.0)
        try:
            conn, _ = srv.accept()
        except socket.timeout:
            if os.getppid() != boot_ppid:
                return  # the raylet died: the parked pool goes with us
            continue
        except InterruptedError:
            continue  # SIGCHLD during accept
        except OSError:
            return
        conn.settimeout(None)
        _CHILD_CLOSE.append(conn)
        try:
            f = conn.makefile("rwb")
            line = f.readline()
            if not line:
                continue
            reply = _handle(json.loads(line))
            if reply is None:
                return  # stop
            f.write((json.dumps(reply) + "\n").encode())
            f.flush()
        except Exception as e:  # noqa: BLE001 - one bad request must not end the daemon
            # console-output: the zygote logs to its stderr file (no structured logger before fork)
            print(f"zygote: request failed: {e!r}", file=sys.stderr, flush=True)
        finally:
            try:
                conn.close()
            except OSError:
                pass
            _CHILD_CLOSE.remove(conn)


class ZygoteSpawnError(RuntimeError):
    """The daemon answered but THIS fork failed (resource pressure): the
    caller Popens this one worker and keeps the daemon."""


class ZygoteClient:
    """The raylet's handle on the daemon. A lost daemon shows as an OSError
    from any request; the pool manager then respawns it."""

    def __init__(self, sock_path: str):
        self.sock_path = sock_path

    def _request(self, req: dict, timeout: float = 10.0) -> dict:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        try:
            s.connect(self.sock_path)
            f = s.makefile("rwb")
            f.write((json.dumps(req) + "\n").encode())
            f.flush()
            line = f.readline()
            if not line:
                raise ConnectionError("zygote closed the connection without a reply")
            return json.loads(line)
        finally:
            s.close()

    @staticmethod
    def spawn_spec(argv: List[str], env: dict, out: str, err: str,
                   status: Optional[str] = None) -> dict:
        spec = {"argv": argv, "env": env, "out": out, "err": err}
        if status:
            spec["status"] = status
        return spec

    def spawn(self, argv: List[str], env: dict, out: str, err: str,
              timeout: float = 10.0, status: Optional[str] = None) -> Tuple[int, bool]:
        """Forks one worker; (pid, warm), warm when a parked child took the
        assignment. Raises ZygoteSpawnError when the fork itself failed. The
        request carries its deadline: a daemon that reads it later drops it.
        `status` names the file the child's exit status goes to."""
        req = dict(self.spawn_spec(argv, env, out, err, status),
                   deadline=time.time() + timeout)
        reply = self._request(req, timeout=timeout)
        if "error" in reply:
            raise ZygoteSpawnError(reply["error"])
        return int(reply["pid"]), bool(reply.get("warm"))

    def spawn_batch(self, specs: List[dict]) -> List[Tuple[int, bool]]:
        """N forks in one round trip. Any failed fork raises
        ZygoteSpawnError; the batch's forked workers are then never adopted,
        and each exits on the raylet's stop reply to its first poll."""
        reply = self._request({"batch": specs, "deadline": time.time() + 30.0}, timeout=30.0)
        errors = [r["error"] for r in reply["spawns"] if "error" in r]
        if errors:
            raise ZygoteSpawnError("; ".join(errors))
        return [(int(r["pid"]), bool(r.get("warm"))) for r in reply["spawns"]]

    def ensure_pool(self, target: int) -> dict:
        """Fills (or shrinks) the parked pool to `target`."""
        return self._request({"pool": int(target)}, timeout=30.0)

    def stats(self) -> dict:
        return self._request({"stats": True})

    def reset(self) -> int:
        """Drains every parked child."""
        return int(self._request({"reset": True}).get("drained", 0))


def _proc_starttime(pid: int):
    """Kernel start time of `pid` (field 22 of /proc/<pid>/stat): the pair
    (pid, start time) is unique across pid reuse."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read()
        return stat.rsplit(b") ", 1)[1].split()[19]
    except (OSError, IndexError):
        return None


class PidHandle:
    """The part of Popen's surface the raylet uses (poll, wait, kill,
    terminate, send_signal) over a zygote-forked pid. The zygote reaps its
    children, so death shows as a missing /proc entry or one with another
    start time: a recycled pid is never taken for our worker, nor
    signalled. The return code is the one the zygote wrote to
    `status_path` before the reap (Popen's convention: minus the signal's
    number for a killed worker), and -1 when no status came back (no file
    named, or the zygote died before its child)."""

    def __init__(self, pid: int, status_path: Optional[str] = None):
        self.pid = pid
        self._rc = None
        self._status_path = status_path
        self._starttime = _proc_starttime(pid)

    def _alive(self) -> bool:
        st = _proc_starttime(self.pid)
        return st is not None and st == self._starttime

    def _set_dead(self) -> int:
        rc = -1
        if self._status_path:
            try:
                with open(self._status_path) as f:
                    rc = int(f.read())
            except (OSError, ValueError):
                pass
        self._rc = rc
        return rc

    def poll(self):
        if self._rc is not None:
            return self._rc
        if self._alive():
            return None
        return self._set_dead()

    def wait(self, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() >= deadline:
                raise subprocess.TimeoutExpired(f"pid {self.pid}", timeout)
            time.sleep(0.02)
        return self._rc

    def send_signal(self, sig: int) -> None:
        if self._rc is not None or not self._alive():
            self.poll()
            return  # the pid may be recycled: never signal a stranger
        try:
            os.kill(self.pid, sig)
        except ProcessLookupError:
            self.poll()

    def kill(self) -> None:
        self.send_signal(signal.SIGKILL)

    def terminate(self) -> None:
        self.send_signal(signal.SIGTERM)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else None)
