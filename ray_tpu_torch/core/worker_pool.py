"""Warm worker pool: demand-sized prestart and the zygote's lifecycle (the
port of ray_tpu/core/worker_pool.py).

Re-design of the reference's worker-pool prestart (reference: worker_pool.h
PrestartWorkers) as a standing control loop, so that a launch almost never
waits for a worker's start-up:

- **Tier 1, live idle workers** (the raylet's `_idle` map), popped at
  dispatch. The manager refills this pool after pops, up to a demand-sized
  target.
- **Tier 2, the zygote's parked pre-forks** (core/zygote.py `{"pool": N}`):
  forked children that already imported the worker stack and torch, waiting
  for an assignment. A tier-1 miss is served by one pipe write instead of a
  fork or a fresh interpreter.

The target follows demand: a sliding-window estimate of this raylet's
launch rate (times a horizon) plus the GCS heartbeat's `pool_hint`, this
node's share of the demand forecasts reported to the GCS
(`report_demand_forecast`).

The manager owns the zygote daemon's lifecycle: boot, death detection,
respawn with backoff and the rebuild of the parked pool. The chaos point
`zygote.spawn` (action `kill`: SIGKILL the daemon at a spawn) drills it.

When the raylet is fenced (core/raylet.py `_fence`), `on_fence` drains the
zygote's parked children: no pre-forked worker outlives the incarnation that
forked it.

Pool sizes follow the GCS's demand forecast (each heartbeat's `pool_hint`),
which autoscaler_v2's InstanceManager relays (`set_pending_actors`).
"""

from __future__ import annotations

import collections
import logging
import math
import os
import subprocess
import sys
import threading
import time
from typing import Any, List, Optional, Tuple

from ..chaos.controller import maybe_inject as _chaos_inject
from ..observability.flight_recorder import record as _flight_record
from ..utils import config
from ..utils import internal_metrics as imet
from .zygote import ZygoteClient, ZygoteSpawnError

_log = logging.getLogger("ray_tpu_torch.worker_pool")


class ZygoteUnavailableError(RuntimeError):
    """The zygote cannot serve this spawn (dead, booting, or the fork
    failed): the caller Popens while the manager respawns it."""


class LaunchRate:
    """Sliding-window launch rate: a bounded deque of event stamps; per_s()
    counts the events inside the window (an EWMA would lag a burst's
    leading edge, which is when the pool must grow)."""

    def __init__(self, window_s: float = 2.0, cap: int = 512):
        self.window_s = window_s
        self._stamps: "collections.deque[float]" = collections.deque(maxlen=cap)
        self._lock = threading.Lock()

    def note(self, n: int = 1) -> None:
        now = time.monotonic()
        with self._lock:
            for _ in range(n):
                self._stamps.append(now)

    def per_s(self) -> float:
        cutoff = time.monotonic() - self.window_s
        with self._lock:
            while self._stamps and self._stamps[0] < cutoff:
                self._stamps.popleft()
            return len(self._stamps) / self.window_s


class WorkerPoolManager:
    """The zygote's lifecycle and the pool's sizing for one raylet. The
    raylet owns the worker table and the spawn itself (`_prestart_idle`,
    `_retire_idle`); demand, refill, respawn and metrics live here."""

    def __init__(self, raylet: Any, prestart: int = 0):
        self._raylet = raylet
        self._prestart = max(0, int(prestart))
        self._rate = LaunchRate(window_s=max(0.5, 4 * config.WORKER_POOL_INTERVAL_S))
        self._lock = threading.Lock()
        self._hint = 0  # the GCS heartbeat's pool_hint
        self._hits = {"idle": 0, "prefork": 0}
        self._misses = {"zygote": 0, "popen": 0}
        self._last_miss = 0.0
        self._last_pop = 0.0
        self._last_trickle = 0.0
        self._respawns = 0
        # A daemon that dies at boot every time must not be started twice a
        # second forever: the wait doubles per failed boot, up to 30 s.
        self._respawn_backoff_s = 1.0
        self._respawn_not_before = 0.0
        # The parked pool's size at the last round. stats() reads this and
        # never the daemon: the zygote serves one request at a time, and a
        # heartbeat must not queue behind a batch of forks.
        self._parked = 0
        self._zygote_pid: Optional[int] = None
        self._zygote_proc: Optional[subprocess.Popen] = None
        # Orders a boot against stop(): a zygote started after stop() began
        # would outlive its raylet.
        self._proc_lock = threading.Lock()
        self._zygote: Optional[ZygoteClient] = None
        self._zygote_failed = threading.Event()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._maintenance, daemon=True,
                                        name="worker-pool")

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        """Drains the parked pool (the zygote reaps those children), then
        kills the zygote; a child it missed dies with it (pdeathsig)."""
        self._stop.set()
        self._wake.set()
        z = self._zygote
        if z is not None:
            try:
                z.reset()
            except (OSError, ValueError) as e:
                _log.debug("zygote reset at stop failed: %r", e)
        with self._proc_lock:
            proc = self._zygote_proc
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=5.0)

    # -------------------------------------------------------- demand signal
    def note_demand(self, n: int = 1) -> None:
        """A launch (actor creation or lease spawn) feeds the rate window."""
        self._rate.note(n)
        self._wake.set()

    def note_hit(self, tier: str) -> None:
        with self._lock:
            self._hits[tier] = self._hits.get(tier, 0) + 1
            self._last_pop = time.monotonic()
        imet.WORKER_POOL_HITS.inc(tier=tier)
        _flight_record("pool.pop", tier)
        self._wake.set()  # a pop leaves a hole: refill

    def note_miss(self, mode: str) -> None:
        with self._lock:
            self._misses[mode] = self._misses.get(mode, 0) + 1
            self._last_miss = time.monotonic()
        imet.WORKER_POOL_MISSES.inc(mode=mode)
        _flight_record("pool.miss", mode)
        self._wake.set()

    def set_hint(self, n: int) -> None:
        """The heartbeat reply's pool_hint: this node's share of the demand
        forecast, net of the registrations the GCS counted against it."""
        fresh = max(0, int(n))
        with self._lock:
            changed, self._hint = fresh != self._hint, fresh
        if changed:
            self._wake.set()

    def _demand(self) -> int:
        with self._lock:
            hint = self._hint
        return math.ceil(self._rate.per_s() * config.WORKER_POOL_HORIZON_S) + hint

    def target(self) -> int:
        """The idle pool's target: the prestart floor or the demand."""
        return min(config.WORKER_POOL_MAX, max(self._prestart, self._demand()))

    def _prefork_target(self) -> int:
        """The parked pool's target: the same demand over its own floor
        (parked children cost shared pages only, so the floor stays above
        zero even when the idle pool's is zero)."""
        if self._zygote is None or not config.WORKER_ZYGOTE:
            return 0
        return min(config.WORKER_POOL_PREFORK_MAX,
                   max(config.WORKER_POOL_PREFORK, self._demand()))

    # --------------------------------------------------------------- zygote
    def zygote_spawn(self, argv, env, out, err, status=None) -> Tuple[int, bool]:
        """One fork through the zygote; (pid, warm). Raises
        ZygoteUnavailableError when it cannot: the caller Popens. The
        zygote writes the child's exit status to `status`."""
        self._chaos_spawn_point(f"spawn:{argv[3] if len(argv) > 3 else ''}")
        z = self._zygote
        if z is None:
            raise ZygoteUnavailableError("zygote not running")
        try:
            return z.spawn(argv, env, out, err, status=status)
        except ZygoteSpawnError as e:  # the daemon is fine; this fork failed
            raise ZygoteUnavailableError(f"zygote fork failed: {e}") from e
        except (OSError, ValueError) as e:
            self._note_zygote_failure(e)
            raise ZygoteUnavailableError(f"zygote spawn failed: {e!r}") from e

    def zygote_spawn_batch(self, specs: List[dict]) -> List[Tuple[int, bool]]:
        """N forks in one round trip."""
        self._chaos_spawn_point(f"batch:{len(specs)}")
        z = self._zygote
        if z is None:
            raise ZygoteUnavailableError("zygote not running")
        try:
            return z.spawn_batch(specs)
        except ZygoteSpawnError as e:
            raise ZygoteUnavailableError(f"zygote fork failed: {e}") from e
        except (OSError, ValueError) as e:
            self._note_zygote_failure(e)
            raise ZygoteUnavailableError(f"zygote batch failed: {e!r}") from e

    def _chaos_spawn_point(self, detail: str) -> None:
        rule = _chaos_inject("zygote.spawn", detail)
        if rule is None:
            return
        if rule.action == "kill":
            # Kills the DAEMON (not this raylet): the spawn in flight falls
            # back to Popen, and the maintenance loop finds the corpse,
            # respawns the zygote and rebuilds the parked pool.
            proc = self._zygote_proc
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=5.0)
        elif rule.action == "delay":
            time.sleep(rule.delay_s)
        elif rule.action == "raise":
            raise ZygoteUnavailableError("chaos: injected zygote.spawn failure")

    def _note_zygote_failure(self, err: Exception) -> None:
        """A request found the daemon gone: the maintenance loop respawns
        it and rebuilds the pool. A request that timed out found it slow,
        not gone (a loaded machine): it stays, and the caller Popens this
        one spawn, since killing it would take every worker it forked with
        it (they die with their parent, pdeathsig). The daemon drops that
        request once it reads it past its deadline; and should it fork it
        all the same, the Popen went under another worker id, so the stray
        child is never adopted."""
        if isinstance(err, TimeoutError):
            _log.warning("zygote daemon slow (%r); this request falls back", err)
            _flight_record("pool.zygote_slow", repr(err)[:80])
            return
        _log.warning("zygote daemon unreachable (%r); scheduling respawn", err)
        _flight_record("pool.zygote_lost", repr(err)[:80])
        self._zygote = None
        with self._lock:
            self._parked = 0
        self._zygote_failed.set()
        self._wake.set()

    def on_fence(self) -> None:
        """The fenced node's pool teardown: the parked children were forked
        under the old incarnation and go with it (the same reap the fence
        applies to live workers); the maintenance loop refills the pool for
        the fresh incarnation."""
        z = self._zygote
        if z is None:
            return
        try:
            drained = z.reset()
        except (OSError, ValueError) as e:
            # The daemon may have died meanwhile: respawned either way.
            self._note_zygote_failure(e)
            return
        with self._lock:
            self._parked = 0
        self._wake.set()
        if drained:
            _log.info("fence drained %d parked pre-forked workers", drained)

    def zygote_stats(self) -> dict:
        """The daemon's own answer (pid, parked, whether CUDA initialised
        in it); {} when it is down."""
        z = self._zygote
        if z is None:
            return {}
        try:
            return z.stats()
        except (OSError, ValueError):
            return {}

    def _zygote_sock(self) -> str:
        r = self._raylet
        return os.path.join(os.path.dirname(r.sock_path) or ".", f"zyg_{r.node_id[:8]}.sock")

    def _boot_zygote(self) -> bool:
        """Starts (or restarts) the daemon and waits for its socket; True
        when a client is ready."""
        r = self._raylet
        sock = self._zygote_sock()
        with self._proc_lock:
            if self._stop.is_set():
                return False
            with open(os.path.join(r._log_dir, "zygote.log"), "ab", buffering=0) as log:
                self._zygote_proc = subprocess.Popen(
                    [sys.executable, "-m", "ray_tpu_torch.core.zygote", sock, str(os.getpid())],
                    stdout=log, stderr=log)
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and not self._stop.is_set():
            if self._zygote_proc.poll() is not None:
                return False  # died at boot: Popen serves every spawn
            if os.path.exists(sock):
                client = ZygoteClient(sock)
                try:
                    self._zygote_pid = client.stats()["pid"]
                except OSError:  # a stale socket file, not the daemon
                    time.sleep(0.05)
                    continue
                self._zygote = client
                self._zygote_failed.clear()
                return True
            time.sleep(0.05)
        return False

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        """The pool's health (heartbeat stats, debug_state). Cached state
        only, read without the raylet's workers lock: a spawn holds that lock
        while the daemon answers, and the heartbeat must not wait on the
        daemon (a slow fork would cost the node its liveness)."""
        r = self._raylet
        idle_lists = [list(lst) for lst in list(r._idle.values())]
        idle = sum(len(lst) for lst in idle_lists)
        ready = sum(1 for lst in idle_lists for wid in lst
                    if (w := r._workers.get(wid)) is not None and w.ready)
        with self._lock:
            hits, misses = dict(self._hits), dict(self._misses)
            respawns, parked = self._respawns, self._parked
        target = self.target()
        return {"idle": idle, "ready": ready, "preforked": parked, "target": target,
                "refill_lag": max(0, target - idle), "hits": hits, "misses": misses,
                "zygote_alive": self._zygote is not None, "zygote_pid": self._zygote_pid,
                "zygote_respawns": respawns}

    # ---------------------------------------------------------- maintenance
    def _maintenance(self) -> None:
        """The pool's loop: the zygote's liveness and respawn, the idle
        pool's refill toward its target, the parked pool's top-up, gauges."""
        first = True
        while not self._stop.is_set():
            if not first:
                self._wake.wait(timeout=config.WORKER_POOL_INTERVAL_S)
                self._wake.clear()
                # Pops wake this loop, so under steady load the wake is
                # always set: a floor between rounds keeps it from spinning
                # on the workers lock that dispatch needs.
                if self._stop.wait(0.1):
                    return
            try:
                self._maintain_once(first)
            except Exception as e:  # noqa: BLE001 - a dead loop would leave every launch cold
                _log.warning("pool maintenance round failed: %r", e)
            first = False

    def _maintain_once(self, first: bool) -> None:
        r = self._raylet
        proc = self._zygote_proc
        died = self._zygote_failed.is_set() or (proc is not None and proc.poll() is not None)
        if not config.WORKER_ZYGOTE:
            pass  # RAY_TPU_WORKER_ZYGOTE=0: every spawn Popens
        elif died:
            self._zygote = None
            if not self._stop.is_set() and time.monotonic() >= self._respawn_not_before:
                _log.warning("zygote daemon died (exit %s): respawning and rebuilding the pool",
                             proc.poll() if proc is not None else "?")
                _flight_record("pool.zygote_respawn", r.node_id[:12])
                if proc is not None and proc.poll() is None:
                    # Flagged unreachable but still there (wedged): kill it
                    # first, or two daemons race for the socket path.
                    proc.kill()
                    proc.wait(timeout=5.0)
                if self._boot_zygote():
                    with self._lock:
                        self._respawns += 1
                    imet.ZYGOTE_RESPAWNS.inc()
                    self._respawn_backoff_s = 1.0
                else:
                    self._respawn_not_before = time.monotonic() + self._respawn_backoff_s
                    self._respawn_backoff_s = min(30.0, self._respawn_backoff_s * 2)
        elif proc is None:
            self._boot_zygote()
        if first:
            # The prestart floor, in one go, before the first burst.
            self._refill(self._prestart, force=True)
            if config.WORKER_POOL:
                self._ensure_prefork()
            self._update_gauges()
            return
        if not config.WORKER_POOL:
            # RAY_TPU_WORKER_POOL=0: the boot prestart only, forks on demand.
            self._update_gauges()
            return
        self._refill(self.target())
        self._ensure_prefork()
        # Retire surplus idle workers once demand decays, a couple a round
        # and with slack, so a brief lull does not churn the pool.
        with r._workers_lock:
            surplus = sum(len(v) for v in r._idle.values()) - self.target() - 2
        if surplus > 0:
            r._retire_idle(min(surplus, 2))
        self._update_gauges()

    def _refill(self, target: int, force: bool = False) -> None:
        """Tops the idle pool up toward `target`. `force` (the boot
        prestart) skips the pacing."""
        r = self._raylet
        if self._zygote is None and not force:
            # While the zygote is down, Popen refills would only steal CPU
            # from the spawns that serve demand: hold the floor.
            target = min(target, self._prestart)
        with r._workers_lock:
            idle = sum(len(v) for v in r._idle.values())
        # A bounded batch a round, so demand-path forks do not queue behind
        # one giant batch in the zygote; the boot prestart fills at once.
        short = (target - idle) if force else min(target - idle, 8)
        if short <= 0:
            return
        if not force:
            now = time.monotonic()
            with self._lock:
                missing = now - self._last_miss < 2.0
                popping = now - self._last_pop < 2.0
                hinted = self._hint > 0
            if not missing:
                if popping:
                    return  # served warm mid-burst: do not steal its CPU
                if not hinted:
                    # A quiet pool with no declared demand rebuilds one
                    # worker a second.
                    if now - self._last_trickle < 1.0:
                        return
                    self._last_trickle = now
                    short = 1
        spawned = r._prestart_idle(short)
        if spawned:
            _flight_record("pool.refill", (spawned, target))
            r._sched_wake.set()

    def _ensure_prefork(self) -> None:
        z = self._zygote
        if z is None:
            return
        try:
            reply = z.ensure_pool(self._prefork_target())
        except (OSError, ValueError) as e:
            self._note_zygote_failure(e)
            return
        with self._lock:
            self._parked = int(reply.get("parked", 0))

    def _update_gauges(self) -> None:
        r = self._raylet
        with r._workers_lock:
            idle = sum(len(v) for v in r._idle.values())
        with self._lock:
            parked = self._parked
        target = self.target()
        imet.WORKER_POOL_SIZE.set(idle, tier="idle")
        imet.WORKER_POOL_SIZE.set(parked, tier="prefork")
        imet.WORKER_POOL_TARGET.set(target)
        imet.WORKER_POOL_REFILL_LAG.set(max(0, target - idle))
