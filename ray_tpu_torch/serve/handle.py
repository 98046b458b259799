"""DeploymentHandle + power-of-two-choices routing (copy of
ray_tpu/serve/handle.py for the PyTorch port).

Re-design of the reference's request path (reference:
python/ray/serve/handle.py:625 DeploymentHandle.remote;
router.py:559 AsyncioRouter.assign_request;
replica_scheduler/pow_2_scheduler.py:52 PowerOfTwoChoicesReplicaScheduler,
choose_replica_for_request :813; proxy.py:779 HTTPProxy). The handle
keeps client-side outstanding counters per replica and picks the less
loaded of two random candidates — the same O(1) balancing argument as the
reference's queue-length-probe scheduler without the probe RPC.

Left out: the HTTP proxy (ProxyASGIApp, start_proxy) and the gRPC proxy of
ray_tpu/serve/grpc_proxy.py; requests reach a deployment through its
handle or, for LLM apps, the channel feed (serve/llm/feed.py).
"""

from __future__ import annotations

import random
import threading
from typing import Any, Dict, List, Optional

from .. import api
from .. import tracing as _tracing
from .controller import CONTROLLER_NAME, Replica

_STREAM_MARKER = Replica.STREAM_MARKER  # single definition of the sentinel

class DeploymentResponse:
    """Future-like response (reference: serve/handle.py DeploymentResponse)."""

    def __init__(self, ref, on_done, replica=None, trace=None):
        self._ref = ref
        self._on_done = on_done
        self._replica = replica
        self._done = False
        # (app, trace_ctx) from the handle: result() re-roots the request
        # span's context (same trace_id) and ends the request->response
        # flow arrow via the flow id riding the ctx.
        self._trace = trace

    def _finish(self):
        if not self._done:
            self._done = True
            self._on_done()

    def result(self, timeout: Optional[float] = None) -> Any:
        import contextlib
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        span_cm = contextlib.nullcontext()
        if self._trace and _tracing.is_enabled():
            app, ctx = self._trace
            span_cm = _tracing.continue_context(
                ctx, f"serve.response {app}", {"app": app}
            )
        try:
            with span_cm:
                out = api.get(self._ref, timeout=timeout)
        except BaseException:
            self._finish()
            raise
        if isinstance(out, dict) and _STREAM_MARKER in out:
            # A generator response consumed non-streaming: drain it within
            # the caller's deadline. The replica stays "loaded" in the
            # router's counters until the drain completes.
            try:
                return list(self._iter_stream(out[_STREAM_MARKER], deadline))
            finally:
                self._finish()
        self._finish()
        return out

    def _iter_stream(self, stream_id: str, deadline: Optional[float] = None):
        import time as _time

        from .. import exceptions as exc

        while True:
            remaining = 60.0
            if deadline is not None:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    raise exc.GetTimeoutError("stream drain timed out")
            chunks, done = api.get(
                self._replica.next_chunks.remote(stream_id),
                timeout=min(60.0, remaining + 10.0),
            )
            yield from chunks
            if done:
                return


class DeploymentResponseGenerator:
    """Iterates a streaming deployment response chunk-by-chunk.

    Rides the CORE streaming-generator primitive: the replica method runs
    as a `num_returns="streaming"` actor task, each yielded chunk becomes
    a return object delivered as produced, and this wrapper resolves them
    to values (reference: serve/handle.py DeploymentResponseGenerator over
    the streaming generator protocol of _raylet.pyx:281 — here the same
    layering, serve on top of core streaming)."""

    def __init__(self, ref_gen, on_done, on_cancel=None):
        self._gen = ref_gen
        self._on_done = on_done
        self._on_cancel = on_cancel
        self._finished = False

    def _finish(self):
        if not self._finished:
            self._finished = True
            self._on_done()

    def __iter__(self):
        return self

    def __next__(self):
        if self._gen is None:
            raise StopIteration
        # The outstanding counter holds until the stream is drained, so
        # pow-2 routing sees long-lived streams as load.
        try:
            ref = next(self._gen)
        except BaseException:
            self._finish()
            raise
        try:
            return api.get(ref)
        except BaseException:
            self._finish()
            raise

    def close(self):
        """Cancels the stream server-side (client disconnect). The
        replica's cancel_stream stops the handler at the next chunk
        boundary — and immediately for handlers with their own
        cancel_stream hook (the LLM engine frees the request's KV pages
        and batch slot within one decode step); unconsumed chunk objects
        free when the underlying ref generator is dropped."""
        if self._finished:
            self._gen = None  # already drained/errored: nothing to cancel
            return
        if self._on_cancel is not None:
            try:
                self._on_cancel()
            except Exception:  # lint: swallow-ok(cancel is best-effort; replica may be dead already)
                pass
        self._gen = None  # drops the ref generator -> stream_done frees
        self._finish()

    def __del__(self):
        # An abandoned stream (for-loop break, dropped handle) must not
        # keep producing server-side.
        try:
            self.close()
        except Exception:  # lint: swallow-ok(__del__ during interpreter teardown)
            pass


class DeploymentHandle:
    """(reference: serve/handle.py:625)"""

    def __init__(self, app_name: str, method_name: str = "__call__"):
        self._app = app_name
        self._method = method_name
        self._stream = False
        self._mux_id: Optional[str] = None
        self._controller = api.get_actor(CONTROLLER_NAME)
        self._version = -1
        self._replicas: List[Any] = []
        self._outstanding: Dict[Any, int] = {}
        self._lock = threading.Lock()
        self._refresh()

    def __reduce__(self):
        # Handles travel into replica constructors (deployment
        # composition): rebuild from names at the destination — the
        # resolved controller actor, lock, and replica cache are
        # process-local (reference: serve handles are serializable and
        # re-resolve server-side).
        return (_rebuild_handle, (self._app, self._method, self._stream, self._mux_id))

    def options(
        self,
        method_name: Optional[str] = None,
        stream: Optional[bool] = None,
        multiplexed_model_id: Optional[str] = None,
    ) -> "DeploymentHandle":
        h = DeploymentHandle.__new__(DeploymentHandle)
        h.__dict__.update(self.__dict__)
        if method_name is not None:
            h._method = method_name
        if stream is not None:
            h._stream = stream
        if multiplexed_model_id is not None:
            h._mux_id = multiplexed_model_id
        return h

    def _refresh(self, force: bool = False) -> None:
        version = api.get(self._controller.version.remote())
        if version == self._version and not force and self._replicas:
            return
        self._version, self._replicas = api.get(
            self._controller.get_replicas.remote(self._app)
        )
        with self._lock:
            self._outstanding = {r._id: self._outstanding.get(r._id, 0) for r in self._replicas}

    def _choose_replica(self):
        """Power of two choices over client-side outstanding counts
        (reference: pow_2_scheduler.py:813). Multiplexed requests route by
        model-id hash instead: the same model consistently lands on the
        same replica, so its weights stay resident in that replica's HBM
        (reference: the model-locality ranking in
        replica_scheduler/pow_2_scheduler — collapsed to consistent
        hashing, which needs no cross-client model registry)."""
        self._refresh()
        if not self._replicas:
            raise RuntimeError(f"no replicas for app {self._app!r}")
        if len(self._replicas) == 1:
            return self._replicas[0]
        if self._mux_id is not None:
            import zlib

            idx = zlib.crc32(self._mux_id.encode()) % len(self._replicas)
            return self._replicas[idx]
        a, b = random.sample(self._replicas, 2)
        with self._lock:
            return a if self._outstanding.get(a._id, 0) <= self._outstanding.get(b._id, 0) else b

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        replica = self._choose_replica()
        rid = replica._id
        with self._lock:
            self._outstanding[rid] = self._outstanding.get(rid, 0) + 1

        def done():
            with self._lock:
                if rid in self._outstanding:
                    self._outstanding[rid] -= 1

        context = (
            {"multiplexed_model_id": self._mux_id} if self._mux_id is not None else None
        )
        # Router span: the replica-side handling span parents to it (and
        # shares its trace_id) via the actor-task trace_ctx the core
        # submission path injects; `flow_out` additionally arrows
        # request->response in the Perfetto view. TTFT falls out of the
        # replica span's start minus this span's start.
        traced = _tracing.is_enabled()
        resp_flow = _tracing.new_flow_id() if traced else None
        span_cm = (
            _tracing.span(
                f"serve.request {self._app}",
                {
                    "app": self._app,
                    "method": self._method,
                    "replica": str(rid),
                    "flow_out": resp_flow,
                },
            )
            if traced
            else None
        )
        if self._stream:
            import uuid as _uuid

            # Client-generated: travels in the request context so a later
            # close() can name this stream to the replica.
            cancel_token = _uuid.uuid4().hex
            context = {**(context or {}), "cancel_token": cancel_token}
            with span_cm or _tracing.null_span():
                ref_gen = replica.handle_request_stream.options(
                    num_returns="streaming"
                ).remote(self._method, args, kwargs, context)

            def cancel():
                replica.cancel_stream.remote(cancel_token)

            return DeploymentResponseGenerator(ref_gen, done, on_cancel=cancel)
        resp_ctx = None
        with span_cm or _tracing.null_span() as sp:
            ref = replica.handle_request.remote(self._method, args, kwargs, context)
            if sp is not None:
                resp_ctx = {
                    "trace_id": sp["trace_id"],
                    "span_id": sp["span_id"],
                    "flow": resp_flow,
                }
        return DeploymentResponse(
            ref,
            done,
            replica=replica,
            trace=(self._app, resp_ctx) if resp_ctx else None,
        )


def _rebuild_handle(
    app_name: str, method_name: str, stream: bool, mux_id: Optional[str] = None
) -> "DeploymentHandle":
    h = DeploymentHandle(app_name, method_name)
    h._stream = stream
    h._mux_id = mux_id
    return h
