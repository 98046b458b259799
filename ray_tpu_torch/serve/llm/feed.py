"""Persistent-channel request feed for LLM deployments (copy of
ray_tpu/serve/llm/feed.py for the PyTorch port).

The serve handle path pays a full actor-task round trip per call —
right for request/response deployments, wrong for an engine whose unit
of work is one token. The feed instead rides core/channel.py's
ring+listener channels: a client attaches ONCE to a replica, then every
request and every streamed token crosses a persistent channel pair with
no per-call submission.

Wire protocol (pickled tuples):
  client -> replica (request channel):
    ("gen", crid, [tokens], max_new_tokens) | ("cancel", crid) | ("detach",)
  replica -> client (response channel):
    (crid, "tok", int) | (crid, "done", reason) | (crid, "error", exc)

Failure semantics carry the chaos contract: a dead replica surfaces to
every in-flight client request as ActorDiedError (fail-fast, never a
hang); a dead client surfaces replica-side as a response-channel
ChannelClosed, which cancels that client's outstanding sequences so
their KV pages free within one decode step.
"""

from __future__ import annotations

import itertools
import logging
import queue
import shutil
import tempfile
import threading
from typing import Dict, Optional, Sequence

from ...core.channel import ChannelClosed, ChannelReader, ChannelWriter
from ...exceptions import ActorDiedError, RayTpuError

logger = logging.getLogger(__name__)

_FEED_CAPACITY = 1 << 20


class FeedServer:
    """Replica-side: one request-pump + one response-emitter thread per
    attached client, feeding the resident engine."""

    def __init__(self, engine, name: str = "llm"):
        self.engine = engine
        self.name = name
        self._dir = tempfile.mkdtemp(prefix="rtpu-llmfeed-")
        self._clients: Dict[str, "_ClientSession"] = {}
        self._lock = threading.Lock()
        self._closed = False

    def attach(self, resp_spec):
        """Accepts a client's response-channel spec; returns the spec of
        a fresh request channel dedicated to that client."""
        with self._lock:
            if self._closed:
                raise RayTpuError("feed server is shut down")
            sess = _ClientSession(self, resp_spec)
            self._clients[sess.cid] = sess
            return sess.req_reader.spec()

    def _drop(self, cid: str) -> None:
        with self._lock:
            self._clients.pop(cid, None)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            sessions = list(self._clients.values())
            self._clients.clear()
        for sess in sessions:
            sess.shutdown()
        shutil.rmtree(self._dir, ignore_errors=True)


class _ClientSession:
    def __init__(self, server: FeedServer, resp_spec):
        self.server = server
        self.cid = resp_spec.name
        self.req_reader = ChannelReader(
            server._dir, capacity=_FEED_CAPACITY
        )
        self.resp_writer = ChannelWriter(
            resp_spec, metrics_label=f"llmfeed.{server.name}"
        )
        self._out: "queue.SimpleQueue" = queue.SimpleQueue()
        self._rids: Dict[int, int] = {}  # crid -> engine rid
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._pump = threading.Thread(
            target=self._pump_requests, name=f"llmfeed-pump-{self.cid}", daemon=True
        )
        self._emit = threading.Thread(
            target=self._emit_responses, name=f"llmfeed-emit-{self.cid}", daemon=True
        )
        self._pump.start()
        self._emit.start()

    # ------------------------------------------------------------ threads

    def _sink_for(self, crid: int):
        def sink(ev: str, val) -> None:
            if ev in ("done", "error"):
                with self._mu:
                    self._rids.pop(crid, None)
            self._out.put((crid, ev, val))

        return sink

    def _pump_requests(self) -> None:
        while not self._stop.is_set():
            try:
                msg = self.req_reader.read(timeout=1.0)
            except TimeoutError:
                continue
            except (ChannelClosed, OSError):
                break
            kind = msg[0]
            if kind == "gen":
                _, crid, prompt, max_new = msg
                try:
                    rid = self.server.engine.submit(
                        prompt, max_new, sink=self._sink_for(crid)
                    )
                    with self._mu:
                        self._rids[crid] = rid
                except Exception as e:  # noqa: BLE001 - shed/validation per request
                    self._out.put((crid, "error", e))
            elif kind == "cancel":
                with self._mu:
                    rid = self._rids.get(msg[1])
                if rid is not None:
                    self.server.engine.cancel(rid)
            elif kind == "detach":
                break
        self.shutdown()

    def _emit_responses(self) -> None:
        while True:
            item = self._out.get()
            if item is None:
                break
            try:
                self.resp_writer.write(item, timeout=10.0)
            except (ChannelClosed, TimeoutError, OSError):
                # Client died (or wedged past the credit window): reclaim
                # every sequence it still holds — pages free within one
                # decode step of the cancels landing.
                logger.info("llm feed client %s gone; cancelling its requests", self.cid)
                self.shutdown()
                break

    # ------------------------------------------------------------ cleanup

    def shutdown(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        with self._mu:
            rids = list(self._rids.values())
            self._rids.clear()
        for rid in rids:
            self.server.engine.cancel(rid)
        self._out.put(None)  # unblock the emitter
        try:
            self.req_reader.close()
        except Exception:  # lint: swallow-ok(idempotent teardown; reader may be mid-read)
            pass
        try:
            self.resp_writer.close()
        except Exception:  # lint: swallow-ok(peer may already be gone)
            pass
        self.server._drop(self.cid)


class LLMClient:
    """Client-side: attaches to one replica of an LLM app and multiplexes
    request streams over the channel pair."""

    def __init__(self, app_name: str, replica=None, attach_timeout: float = 20.0):
        from ..controller import get_or_create_controller
        from ... import api as rtpu

        if replica is None:
            controller = get_or_create_controller()
            _, replicas = rtpu.get(controller.get_replicas.remote(app_name))
            if not replicas:
                raise RuntimeError(f"no replicas for app {app_name!r}")
            replica = replicas[0]
        self._replica = replica
        self._dir = tempfile.mkdtemp(prefix="rtpu-llmcli-")
        self.resp_reader = ChannelReader(self._dir, capacity=_FEED_CAPACITY)
        req_spec = rtpu.get(
            replica.handle_request.remote(
                "attach_feed", (self.resp_reader.spec(),), {}
            ),
            timeout=attach_timeout,
        )
        self.req_writer = ChannelWriter(req_spec)
        self._crid = itertools.count(1)
        self._mu = threading.Lock()
        self._queues: Dict[int, "queue.SimpleQueue"] = {}
        self._dead: Optional[BaseException] = None
        self._demux = threading.Thread(
            target=self._demux_responses, name="llmfeed-demux", daemon=True
        )
        self._demux.start()

    def _demux_responses(self) -> None:
        while True:
            try:
                crid, ev, val = self.resp_reader.read(timeout=1.0)
            except TimeoutError:
                continue
            except (ChannelClosed, OSError):
                err = ActorDiedError(reason="llm replica died (feed channel closed)")
                with self._mu:
                    self._dead = err
                    waiters = list(self._queues.values())
                    self._queues.clear()
                for q in waiters:
                    q.put(("error", err))
                return
            with self._mu:
                q = self._queues.get(crid)
                if ev in ("done", "error"):
                    self._queues.pop(crid, None)
            if q is not None:
                q.put((ev, val))

    def generate(self, prompt: Sequence[int], max_new_tokens: Optional[int] = None):
        """Submits over the channel; returns a blocking token iterator.
        Raises (typed) if the replica already failed. Closing the
        iterator sends a cancel for the in-flight request."""
        with self._mu:
            if self._dead is not None:
                raise self._dead
            crid = next(self._crid)
            q: "queue.SimpleQueue" = queue.SimpleQueue()
            self._queues[crid] = q
        self.req_writer.write(("gen", crid, [int(t) for t in prompt], max_new_tokens))

        def _iter():
            finished = False
            try:
                while True:
                    ev, val = q.get()
                    if ev == "tok":
                        yield val
                    elif ev == "done":
                        finished = True
                        return
                    else:
                        finished = True
                        raise val
            finally:
                if not finished:
                    self.cancel(crid)

        return _iter()

    def cancel(self, crid: int) -> None:
        with self._mu:
            self._queues.pop(crid, None)
        try:
            self.req_writer.write(("cancel", crid), timeout=5.0)
        except (ChannelClosed, TimeoutError, OSError):
            pass  # lint: swallow-ok(replica gone; its pages died with it)

    def close(self) -> None:
        try:
            self.req_writer.write(("detach",), timeout=2.0)
        except Exception:  # lint: swallow-ok(detach is best-effort; reader close is authoritative)
            pass
        try:
            self.req_writer.close()
        except Exception:  # lint: swallow-ok(idempotent teardown)
            pass
        try:
            self.resp_reader.close()
        except Exception:  # lint: swallow-ok(idempotent teardown)
            pass
        shutil.rmtree(self._dir, ignore_errors=True)
