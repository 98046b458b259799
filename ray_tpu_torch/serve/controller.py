"""Serve controller + replica actors (copy of ray_tpu/serve/controller.py
for the PyTorch port).

Re-design of the reference's control plane (reference:
python/ray/serve/_private/controller.py:84 ServeController actor;
deployment_state.py:1245 DeploymentState reconciler; replica.py:828
UserCallableWrapper; autoscaling_state.py + autoscaling_policy.py). The
controller actor holds the desired state (apps -> deployments -> target
replica count), reconciles actual replica actors toward it on a control
loop, and serves the replica directory that handles long-poll against
(version counter instead of the reference's LongPollHost).

On the cluster runtime the controller also watches node events
(utils/node_events.py): a replica on a node that got a preemption notice is
replaced on another node, and the swapped replica set is published before
the old replica is drained and killed. The in-process runtime has no nodes
to drain.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from .. import api
from .. import tracing as _tracing

_log = logging.getLogger(__name__)

CONTROLLER_NAME = "__serve_controller__"

# Sentinel: "the stream produced no first chunk" (distinct from a handler
# legitimately yielding None).
_STREAM_EXHAUSTED = object()


class Replica:
    """Replica actor body wrapping the user callable (reference:
    serve/_private/replica.py:828 UserCallableWrapper)."""

    STREAM_MARKER = "__ray_tpu_stream__"

    def __init__(self, target, init_args, init_kwargs, app_name: str = ""):
        # The JAX package ships the class as cloudpickle bytes; the
        # in-process runtime hands over the class itself.
        if isinstance(target, type):
            self._callable = target(*init_args, **init_kwargs)
        else:
            self._callable = target
        self._app_name = app_name
        self._ongoing = 0
        self._lock = threading.Lock()
        self._total = 0
        # Per-deployment request latency + QPS (reference:
        # serve_deployment_processing_latency_ms in metric_defs/serve
        # metrics; flushed via the worker's internal-metrics pipeline).
        from ..utils import internal_metrics as imet

        self._m_requests = imet.SERVE_REQUESTS.labels(deployment=app_name)
        self._m_latency = imet.SERVE_REQUEST_LATENCY.labels(deployment=app_name)
        # TTFT (first result/chunk) + live queue depth: the serving
        # efficiency signals the history layer and the serve_ttft_p99
        # watchdog rule consume.
        self._m_ttft = imet.SERVE_TTFT.labels(deployment=app_name)
        self._m_qdepth = imet.SERVE_QUEUE_DEPTH.labels(deployment=app_name)
        # Engine-bearing callables (serve/llm deployment.py) get a
        # graceful teardown before kill; one cached attr check is the
        # whole cost for everyone else.
        self._llm_engine = bool(getattr(self._callable, "__llm_engine__", False))
        # Streaming responses: generator outputs run in a background thread
        # into a bounded queue, pulled chunk-wise by the caller (reference:
        # replica.py handle_request_streaming over the streaming generator
        # protocol — here a pull protocol over actor RPCs, which gives the
        # same incremental delivery + backpressure without a new channel
        # primitive).
        self._streams: Dict[str, Any] = {}
        # Client-side stream cancellation (handle-path close()): tokens
        # arrive over a separate actor call, the drain loop checks
        # between chunks. Bounded so tokens for already-finished (or
        # never-started) streams cannot accumulate.
        self._stream_cancels: "OrderedDict[str, bool]" = OrderedDict()

    def cancel_stream(self, token: str) -> bool:
        """Best-effort cancel of a streaming request by its client-side
        token. Generic half: mark the token so handle_request_stream's
        drain loop closes the handler generator at the next chunk
        boundary. Handler half: a callable exposing `cancel_stream`
        (the LLM deployment) is told immediately — it can interrupt the
        in-flight producer (engine.cancel frees KV pages within one
        decode step) instead of waiting for the next chunk."""
        with self._lock:
            self._stream_cancels[token] = True
            while len(self._stream_cancels) > 256:
                self._stream_cancels.popitem(last=False)
        fn = getattr(self._callable, "cancel_stream", None)
        if fn is not None:
            try:
                fn(token)
            except Exception:  # lint: swallow-ok(cancel is best-effort; stream may already be gone)
                pass
        return True

    def _stream_cancelled(self, token) -> bool:
        if token is None:
            return False
        with self._lock:
            return token in self._stream_cancels

    def handle_request(self, method: str, args, kwargs, context=None):
        import asyncio
        import inspect
        import queue as _queue
        import time as _time
        import uuid

        with self._lock:
            self._ongoing += 1
            self._total += 1
            # Gauge set under the lock: a lost-update race between two
            # finishing requests would otherwise pin a stale depth.
            self._m_qdepth.set(self._ongoing)
        self._m_requests.inc()
        req_t0 = _time.perf_counter()
        streaming = False
        succeeded = False
        try:
            # Per-request context (multiplexed model id etc.) for
            # serve.get_multiplexed_model_id() inside the callable
            # (reference: serve/context.py _serve_request_context).
            # ALWAYS set: pool threads are reused, and a stale model id
            # from the previous request must not leak into this one.
            from .batching import set_request_context

            set_request_context(
                multiplexed_model_id=(context or {}).get("multiplexed_model_id", ""),
                cancel_token="",  # pool threads are reused; clear stream state
            )
            fn = self._callable if method == "__call__" else getattr(self._callable, method)
            if method == "__call__" and not callable(self._callable):
                raise TypeError("deployment target is not callable")
            # Replica-side serve span: nests under the actor-task
            # execution span (whose trace_ctx came from the router), so
            # proxy/router/replica share one trace_id and the gap between
            # the router span's start and this span's start IS the
            # routing+dispatch half of TTFT.
            with _tracing.span(
                f"serve.replica {self._app_name}",
                {"app": self._app_name, "serve_method": method},
            ):
                out = fn(*args, **kwargs)
                if inspect.iscoroutine(out):
                    out = asyncio.run(out)
            if inspect.isgenerator(out) or inspect.isasyncgen(out):
                # Register a stream instead of materializing it. The
                # request stays in the _ongoing count until the stream
                # finishes (load accounting/autoscaling must see active
                # streams); the pump gives up if the consumer disappears.
                stream_id = uuid.uuid4().hex
                q: "_queue.Queue" = _queue.Queue(maxsize=16)  # backpressure
                finished = threading.Event()

                first_chunk_at: List[float] = []

                def finish_stream():
                    if finished.is_set():
                        return
                    finished.set()
                    with self._lock:
                        self._ongoing -= 1
                        self._m_qdepth.set(self._ongoing)
                    self._streams.pop(stream_id, None)
                    # Stream latency covers first byte to drain completion.
                    self._m_latency.observe((_time.perf_counter() - req_t0) * 1e3)

                def put_or_abandon(item) -> bool:
                    try:
                        # No pull for this long = consumer gone (client
                        # disconnect / dropped generator): abandon.
                        q.put(item, timeout=60.0)
                        if item[0] == "chunk" and not first_chunk_at:
                            # First chunk produced: the stream's TTFT.
                            first_chunk_at.append(_time.perf_counter())
                            self._m_ttft.observe(
                                (first_chunk_at[0] - req_t0) * 1e3
                            )
                        return True
                    except _queue.Full:
                        finish_stream()
                        return False

                def pump(gen=out):
                    try:
                        if inspect.isasyncgen(gen):
                            async def drain():
                                async for chunk in gen:
                                    if not put_or_abandon(("chunk", chunk)):
                                        return False
                                return True

                            if not asyncio.run(drain()):
                                return
                        else:
                            for chunk in gen:
                                if not put_or_abandon(("chunk", chunk)):
                                    return
                        put_or_abandon(("done", None))
                    except BaseException as e:  # noqa: BLE001
                        put_or_abandon(("error", e))

                threading.Thread(target=pump, daemon=True).start()
                self._streams[stream_id] = {"q": q, "finish": finish_stream}
                streaming = True
                return {self.STREAM_MARKER: stream_id}
            succeeded = True
            return out
        finally:
            if not streaming:
                with self._lock:
                    self._ongoing -= 1
                    self._m_qdepth.set(self._ongoing)
                latency_ms = (_time.perf_counter() - req_t0) * 1e3
                self._m_latency.observe(latency_ms)
                if succeeded:
                    # Non-streaming: the whole result IS the first
                    # result. An errored request produced none — its
                    # wall time must not pollute the TTFT histogram the
                    # serve_ttft_p99 SLO rule fires on.
                    self._m_ttft.observe(latency_ms)

    def handle_request_stream(self, method: str, args, kwargs, context=None):
        """Streaming request path: runs as a num_returns="streaming" actor
        task, so each yielded chunk ships to the caller as produced via
        the core streaming-generator protocol (reference: serve
        replica.py handle_request_streaming — here layered directly on the
        runtime primitive instead of a bespoke pull protocol)."""
        import asyncio
        import inspect
        import time as _time

        with self._lock:
            self._ongoing += 1
            self._total += 1
            # Gauge set under the lock: a lost-update race between two
            # finishing requests would otherwise pin a stale depth.
            self._m_qdepth.set(self._ongoing)
        self._m_requests.inc()
        req_t0 = _time.perf_counter()
        cancel_token = (context or {}).get("cancel_token")
        try:
            from .batching import set_request_context

            set_request_context(
                multiplexed_model_id=(context or {}).get("multiplexed_model_id", ""),
                cancel_token=cancel_token or "",
            )
            fn = self._callable if method == "__call__" else getattr(self._callable, method)
            if method == "__call__" and not callable(self._callable):
                raise TypeError("deployment target is not callable")
            # Streaming: the span covers handler invocation THROUGH the
            # first chunk — the serve-level TTFT. A generator's body runs
            # nothing until first pulled, so the first pull happens inside
            # the span; the rest of the drain (the caller's pace, not the
            # replica's) stays outside it.
            first = _STREAM_EXHAUSTED
            loop = None
            try:
                with _tracing.span(
                    f"serve.replica {self._app_name}",
                    {"app": self._app_name, "serve_method": method, "stream": True},
                ):
                    out = fn(*args, **kwargs)
                    if inspect.iscoroutine(out):
                        out = asyncio.run(out)
                    if inspect.isasyncgen(out):
                        loop = asyncio.new_event_loop()
                        try:
                            first = loop.run_until_complete(out.__anext__())
                        except StopAsyncIteration:
                            pass
                    elif inspect.isgenerator(out):
                        # A cancel that raced ahead of this task starting
                        # (client closed before the stream was scheduled)
                        # stops before the first chunk. Re-delegate: the
                        # handler registered its cancel hook inside fn()
                        # above, AFTER the early cancel_stream call ran —
                        # and close() on a never-started generator skips
                        # its finally, so this is the only cancel path.
                        if self._stream_cancelled(cancel_token):
                            self.cancel_stream(cancel_token)
                            out.close()
                            return
                        first = next(out, _STREAM_EXHAUSTED)
                    else:
                        first = out  # non-generator handler: a one-chunk stream
                if first is _STREAM_EXHAUSTED:
                    return
                # First chunk in hand: the streaming path's TTFT.
                self._m_ttft.observe((_time.perf_counter() - req_t0) * 1e3)
                yield first
                if inspect.isasyncgen(out):
                    while True:
                        try:
                            yield loop.run_until_complete(out.__anext__())
                        except StopAsyncIteration:
                            break
                elif inspect.isgenerator(out):
                    while True:
                        # Checked between chunks: close() lands at the
                        # next chunk boundary even for handlers with no
                        # cancel_stream hook of their own.
                        if self._stream_cancelled(cancel_token):
                            out.close()
                            break
                        try:
                            chunk = next(out)
                        except StopIteration:
                            break
                        yield chunk
            finally:
                # One close for every exit: first-chunk failure, a consumer
                # abandoning the stream (GeneratorExit at any yield), or a
                # clean drain — leaked loops cost an epoll fd each.
                if loop is not None:
                    loop.close()
        finally:
            with self._lock:
                self._ongoing -= 1
                self._m_qdepth.set(self._ongoing)
                if cancel_token:
                    self._stream_cancels.pop(cancel_token, None)
            self._m_latency.observe((_time.perf_counter() - req_t0) * 1e3)

    def next_chunks(self, stream_id: str, max_n: int = 8, timeout: float = 2.0):
        """Pulls up to max_n chunks; returns (chunks, done). Short blocking
        window so slow streams don't pin replica concurrency slots — the
        consumer loops. Raises the generator's exception where it occurred."""
        import queue as _queue

        entry = self._streams.get(stream_id)
        if entry is None:
            raise KeyError(f"unknown stream {stream_id}")
        q = entry["q"]
        if "pending_error" in entry:
            entry["finish"]()
            raise entry["pending_error"]
        chunks: List[Any] = []
        try:
            kind, payload = q.get(timeout=timeout)
        except _queue.Empty:
            return chunks, False
        while True:
            if kind == "done":
                entry["finish"]()
                return chunks, True
            if kind == "error":
                if chunks:
                    # Deliver the chunks produced before the failure; the
                    # error raises on the NEXT pull.
                    entry["pending_error"] = payload
                    return chunks, False
                entry["finish"]()
                raise payload
            chunks.append(payload)
            if len(chunks) >= max_n:
                return chunks, False
            try:
                kind, payload = q.get_nowait()
            except _queue.Empty:
                return chunks, False

    def queue_len(self) -> int:
        return self._ongoing

    def stats(self) -> Dict[str, int]:
        return {"ongoing": self._ongoing, "total": self._total}

    def health_check(self) -> bool:
        return True

    def prepare_shutdown(self) -> bool:
        """Called by the controller before a graceful kill. LLM replicas
        tear down their resident engine here — the feed channels close so
        attached clients fail fast (ActorDiedError) instead of waiting
        out a read timeout, and in-flight sequences release their KV
        pages instead of dying mid-decode."""
        if self._llm_engine:
            try:
                self._callable.shutdown_engine()
            except Exception:  # lint: swallow-ok(kill follows regardless; engine may be half-built)
                pass
        return True


def _prepare_replica_shutdown(replica, timeout: float = 5.0) -> None:
    try:
        api.get(replica.prepare_shutdown.remote(), timeout=timeout)
    except Exception:  # lint: swallow-ok(replica may already be dead)
        pass


class ServeController:
    """Named controller actor (reference: controller.py:84)."""

    def __init__(self):
        self._apps: Dict[str, Dict[str, Any]] = {}  # app -> spec
        self._replicas: Dict[str, List[Any]] = {}  # app -> replica handles
        self._app_gen: Dict[str, int] = {}  # bumped on deploy/delete
        self._version = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # Preemption awareness: replicas on a departing node are replaced
        # (and de-routed) before the machine dies, not found dead after.
        self._node_watcher = None
        self._handled_draining: set = set()
        self._drain_thread: Optional[threading.Thread] = None
        try:
            from ..core import runtime_base
            from ..utils.node_events import NodeEventWatcher

            gcs = getattr(runtime_base.current_runtime(), "_gcs", None)
            if gcs is not None:
                self._node_watcher = NodeEventWatcher(gcs)
        except Exception:  # noqa: BLE001 - no watcher: replicas are found dead instead
            self._node_watcher = None
        self._loop = threading.Thread(target=self._control_loop, daemon=True)
        self._loop.start()
        self._last_scale_action: Dict[str, float] = {}

    # ------------------------------------------------------------- deploy
    def deploy(
        self,
        app_name: str,
        cls_blob,
        init_args,
        init_kwargs,
        num_replicas: int,
        max_ongoing: int,
        autoscaling: Optional[dict],
        actor_options: Dict[str, Any],
        children: Optional[List[str]] = None,
    ) -> bool:
        with self._lock:
            redeploy = app_name in self._apps
            old_replicas = self._replicas.get(app_name, []) if redeploy else []
            old_children = (
                list(self._apps[app_name].get("children", [])) if redeploy else []
            )
            self._apps[app_name] = {
                "cls_blob": cls_blob,
                "init_args": init_args,
                "init_kwargs": init_kwargs,
                "target_replicas": num_replicas,
                "max_ongoing": max_ongoing,
                "autoscaling": autoscaling,
                "actor_options": actor_options,
                # Composition-created inner apps: delete cascades to them
                # (they exist only to serve this app).
                "children": list(children or []),
            }
            # Redeploy replaces the code: existing replicas run the OLD
            # blob and must be torn down so the reconciler rebuilds them
            # (reference: deployment_state version-change rollout).
            self._replicas[app_name] = []
            self._app_gen[app_name] = self._app_gen.get(app_name, 0) + 1
            self._version += 1
        for r in old_replicas:
            _prepare_replica_shutdown(r)
            try:
                api.kill(r)
            except Exception:  # lint: swallow-ok(replica may already be dead)
                pass
        # Composition children the new bind no longer references would
        # otherwise leak their replica actors until controller shutdown.
        dropped = set(old_children) - set(children or [])
        for child in dropped:
            self.delete_app(child)
        self._reconcile()
        return True

    def delete_app(self, app_name: str) -> bool:
        with self._lock:
            spec = self._apps.pop(app_name, None)
            replicas = self._replicas.pop(app_name, [])
            self._app_gen[app_name] = self._app_gen.get(app_name, 0) + 1
            self._version += 1
        for r in replicas:
            _prepare_replica_shutdown(r)
            try:
                api.kill(r)
            except Exception:  # lint: swallow-ok(replica may already be dead)
                pass
        # Cascade to composition-created inner apps: deleting only the
        # outer app would leak their replica actors.
        for child in (spec or {}).get("children", []):
            self.delete_app(child)
        return True

    def _drain_then_kill(self, replica, timeout_s: float = 30.0) -> None:
        """Waits for a de-routed replica's in-flight requests (bounded),
        then kills it (reference: replica graceful_shutdown_timeout_s)."""
        from .. import exceptions as exc

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                if api.get(replica.queue_len.remote(), timeout=5) == 0:
                    break
            except exc.GetTimeoutError:
                # Busy (every concurrency slot occupied by long requests) —
                # exactly the case draining exists for: keep waiting.
                continue
            except Exception:
                break  # actor already dead
            time.sleep(0.25)
        _prepare_replica_shutdown(replica)
        try:
            api.kill(replica)
        except Exception:  # lint: swallow-ok(replica may already be dead)
            pass

    # ---------------------------------------------------------- reconcile
    def _reconcile(self) -> None:
        """Drives actual replica sets toward targets (reference:
        deployment_state.py DeploymentState.update). Write-back is guarded
        by a per-app generation so a concurrent deploy()/delete_app() (which
        resets the replica list) is never clobbered by an in-flight pass."""
        with self._lock:
            apps = dict(self._apps)
            gens = dict(self._app_gen)
        for name, spec in apps.items():
            with self._lock:
                current = list(self._replicas.get(name, []))
            target = spec["target_replicas"]
            opts = {"max_concurrency": spec["max_ongoing"], **spec["actor_options"]}
            replica_cls = api.remote(**opts)(Replica)
            changed = False
            created = []
            while len(current) < target:
                r = replica_cls.remote(
                    spec["cls_blob"], spec["init_args"], spec["init_kwargs"], name
                )
                current.append(r)
                created.append(r)
                changed = True
            victims = []
            while len(current) > target:
                victims.append(current.pop())
                changed = True
            with self._lock:
                stale = self._app_gen.get(name, 0) != gens.get(name, 0) or name not in self._apps
                if not stale:
                    self._replicas[name] = current
                    if changed:
                        self._version += 1
            if stale:
                # The app was redeployed/deleted mid-pass: our replicas run
                # outdated code — tear them down instead of publishing them
                # (deploy/delete handles the previously published set).
                for r in created + victims:
                    try:
                        api.kill(r)
                    except Exception:  # lint: swallow-ok(outdated replica may already be dead)
                        pass
                continue
            # Graceful drain (reference: deployment_state graceful
            # shutdown) — started only AFTER the shrunken replica list is
            # published: routers stop sending new work first, THEN the
            # victim finishes in-flight requests and dies (a drain racing
            # publication could kill an idle victim still being routed to).
            for victim in victims:
                threading.Thread(
                    target=self._drain_then_kill, args=(victim,), daemon=True
                ).start()

    def _control_loop(self) -> None:
        while not self._stop.wait(0.25):
            try:
                self._kick_drain_replacement()
                self._autoscale()
                self._reconcile()
            except Exception:
                # One bad tick must not kill the loop, but a silently
                # failing controller is how serve apps rot: say what broke.
                _log.warning("serve control-loop tick failed", exc_info=True)

    # ---------------------------------------------------- preemption drain
    def _kick_drain_replacement(self) -> None:
        """Runs the drain migration (replacement construction and health
        checks: slow) in its own thread, so a replacement waiting for
        capacity stalls no other app's autoscaling or reconciliation. At
        most one pass at a time."""
        watcher = self._node_watcher
        if watcher is None:
            return
        if not (watcher.draining_nodes() - self._handled_draining):
            return
        t = self._drain_thread
        if t is not None and t.is_alive():
            return
        self._drain_thread = threading.Thread(target=self._replace_draining_replicas,
                                              daemon=True)
        self._drain_thread.start()

    def _replace_draining_replicas(self) -> None:
        """Preemption reaction (reference: deployment_state's drain-node
        replica migration): for every replica on a DRAINING node, build its
        replacement first (placement already avoids draining nodes), publish
        the swapped replica list so routers move new traffic over, and only
        then drain and kill the old replica, which serves until the
        replacement is routable."""
        from ..core import runtime_base
        from ..observability.flight_recorder import record as _frec_record
        from ..utils.node_events import actor_locations

        watcher = self._node_watcher
        if watcher is None:
            return
        draining = watcher.draining_nodes() - self._handled_draining
        if not draining:
            return
        gcs = getattr(runtime_base.current_runtime(), "_gcs", None)
        locations = actor_locations(gcs) if gcs is not None else {}
        if not locations:
            return
        with self._lock:
            apps = dict(self._apps)
            gens = dict(self._app_gen)
        handled_all = True
        for name, spec in apps.items():
            with self._lock:
                current = list(self._replicas.get(name, []))
            victims = [r for r in current if locations.get(r._actor_id.hex()) in draining]
            if not victims:
                continue
            _frec_record("serve.drain_replace",
                         (name, len(victims), tuple(sorted(draining))[:4]))
            opts = {"max_concurrency": spec["max_ongoing"], **spec["actor_options"]}
            replica_cls = api.remote(**opts)(Replica)
            replacements = []
            try:
                for _ in victims:
                    replacements.append(replica_cls.remote(
                        spec["cls_blob"], spec["init_args"], spec["init_kwargs"], name))
                # Constructed before the victims are de-routed: a router
                # switching to a booting replica would stall requests the
                # old one could still serve.
                api.get([r.health_check.remote() for r in replacements], timeout=60)
            except Exception:  # noqa: BLE001 - no capacity yet: retried next tick
                for r in replacements:
                    try:
                        api.kill(r)
                    except Exception:  # noqa: BLE001 - may already be dead
                        pass
                handled_all = False
                continue
            with self._lock:
                stale = self._app_gen.get(name, 0) != gens.get(name, 0) or name not in self._apps
                if not stale:
                    # Against the LIVE list: reconcile kept ticking while the
                    # replacements booted, and a swap on the earlier snapshot
                    # would drop (and leak) a replica it added meanwhile.
                    self._replicas[name] = [r for r in self._replicas.get(name, [])
                                            if r not in victims] + replacements
                    # A reconcile pass that snapshotted the pre-swap list
                    # must discard its write-back, not resurrect the victims.
                    self._app_gen[name] = self._app_gen.get(name, 0) + 1
                    self._version += 1
            if stale:
                for r in replacements:
                    try:
                        api.kill(r)
                    except Exception:  # noqa: BLE001 - may already be dead
                        pass
                continue
            # The old replicas finish their in-flight requests, then die.
            for victim in victims:
                threading.Thread(target=self._drain_then_kill, args=(victim,),
                                 daemon=True).start()
        if handled_all:
            self._handled_draining |= draining

    # ---------------------------------------------------------- autoscale
    def _autoscale(self) -> None:
        """Queue-depth autoscaling (reference: serve/autoscaling_policy.py
        replica-queue-length policy)."""
        now = time.monotonic()
        with self._lock:
            apps = dict(self._apps)
        for name, spec in apps.items():
            asc = spec.get("autoscaling")
            if not asc:
                continue
            replicas = self._replicas.get(name, [])
            if not replicas:
                continue
            try:
                loads = api.get([r.queue_len.remote() for r in replicas], timeout=2)
            except Exception:  # lint: swallow-ok(replica busy or dying; autoscale skips the round)
                continue
            total = sum(loads)
            per = total / max(1, len(replicas))
            target = spec["target_replicas"]
            new_target = target
            if per > asc["target_ongoing_requests"] and target < asc["max_replicas"]:
                if now - self._last_scale_action.get(name, 0) >= asc["upscale_delay_s"]:
                    new_target = min(asc["max_replicas"], target + 1)
            elif per < asc["target_ongoing_requests"] / 2 and target > asc["min_replicas"]:
                if now - self._last_scale_action.get(name, 0) >= asc["downscale_delay_s"]:
                    new_target = max(asc["min_replicas"], target - 1)
            if new_target != target:
                self._last_scale_action[name] = now
                with self._lock:
                    if name in self._apps:
                        self._apps[name]["target_replicas"] = new_target

    # ------------------------------------------------------------ queries
    def get_replicas(self, app_name: str) -> Tuple[int, List[Any]]:
        """Returns (version, replica handles) — the handle long-polls by
        comparing versions (reference: long_poll.py LongPollHost)."""
        with self._lock:
            return self._version, list(self._replicas.get(app_name, []))

    def list_apps(self) -> List[str]:
        with self._lock:
            return list(self._apps)

    def version(self) -> int:
        with self._lock:
            return self._version

    def num_replicas(self, app_name: str) -> int:
        with self._lock:
            return len(self._replicas.get(app_name, []))

    def shutdown(self) -> bool:
        self._stop.set()
        if self._node_watcher is not None:
            self._node_watcher.stop()
        for name in list(self._replicas):
            self.delete_app(name)
        return True


def get_or_create_controller():
    try:
        return api.get_actor(CONTROLLER_NAME)
    except ValueError:
        pass
    controller_cls = api.remote(max_concurrency=16, name=CONTROLLER_NAME, lifetime="detached")(
        ServeController
    )
    try:
        return controller_cls.remote()
    except ValueError:
        # lost the naming race
        return api.get_actor(CONTROLLER_NAME)
