"""Request batching + model multiplexing (copy of ray_tpu/serve/batching.py
for the PyTorch port).

Re-design of the reference's serve batching (reference:
python/ray/serve/batching.py _BatchQueue/@serve.batch) and multiplexing
(reference: python/ray/serve/api.py:558 @serve.multiplexed,
serve/multiplex.py _ModelMultiplexWrapper). Batching is the accelerator
inference lever: a model wants fixed, large batch shapes — pad the batch
your handler receives up to `max_batch_size` and one program shape serves
every request.

Execution model difference vs the reference: our replicas run requests
on a thread pool (actor max_concurrency), not an asyncio loop, so the
batcher is built on threading primitives — the first request in an empty
queue becomes the batch LEADER, waits until the batch fills or the
timeout lapses, invokes the underlying function ONCE with the list of
requests, and distributes results to the followers.
"""

from __future__ import annotations

import asyncio
import collections
import functools
import inspect
import logging
import threading
import time
from typing import Any, Callable, List, Optional

_request_ctx = threading.local()


def set_request_context(**kwargs) -> None:
    """Called by the replica around each request invocation."""
    for k, v in kwargs.items():
        setattr(_request_ctx, k, v)


def get_multiplexed_model_id() -> str:
    """The model id of the CURRENT request (set by
    `handle.options(multiplexed_model_id=...)`; reference:
    serve/context.py get_multiplexed_model_id)."""
    return getattr(_request_ctx, "multiplexed_model_id", "")


def get_request_cancel_token() -> str:
    """The cancel token of the CURRENT streaming request ("" outside a
    stream). Handlers that hold resources per stream (the LLM engine's
    KV pages) key their cancellation registry on it; the replica's
    `cancel_stream(token)` delegates to a callable method of the same
    name so a client-side `close()` reaches the handler even while the
    stream thread is blocked producing the next chunk."""
    return getattr(_request_ctx, "cancel_token", "")


class _BatchItem:
    __slots__ = ("request", "event", "result", "error")

    def __init__(self, request):
        self.request = request
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class _BatchState:
    def __init__(self):
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.items: List[_BatchItem] = []
        self.leader_active = False


def _call_fn(fn, self_obj, requests):
    out = fn(self_obj, requests) if self_obj is not None else fn(requests)
    if inspect.iscoroutine(out):
        out = asyncio.run(out)
    return out


def _distribute(fn, self_obj, batch_items) -> None:
    """Runs the handler once and routes results to each item's waiter.

    Per-item error isolation: a handler that can fail one request without
    poisoning its batchmates returns an Exception INSTANCE in that item's
    result slot — only that waiter raises (typed: taxonomy errors pass
    through, anything else wraps in BatchItemError), the rest of the
    batch completes normally. Only a handler that RAISES (or returns the
    wrong count) fails the whole batch — there are no per-item results to
    salvage in that case."""
    from ..exceptions import BatchItemError, RayTpuError

    try:
        results = _call_fn(fn, self_obj, [i.request for i in batch_items])
        if len(results) != len(batch_items):
            raise ValueError(
                f"@serve.batch handler returned {len(results)} results "
                f"for {len(batch_items)} requests"
            )
        for idx, (i, r) in enumerate(zip(batch_items, results)):
            if isinstance(r, BaseException):
                i.error = r if isinstance(r, RayTpuError) else BatchItemError(r, index=idx)
            else:
                i.result = r
    except BaseException as e:  # noqa: BLE001
        for i in batch_items:
            i.error = e


def batch(
    _func: Optional[Callable] = None,
    *,
    max_batch_size: int = 8,
    batch_wait_timeout_s: float = 0.01,
):
    """Decorator: turns `handler(self, requests: List[T]) -> List[R]` into
    a per-request `handler(self, request: T) -> R` that batches
    concurrent callers (reference: python/ray/serve/batching.py).

    The handler sees up to `max_batch_size` requests at once; a partial
    batch is dispatched after `batch_wait_timeout_s`. For compiled
    models, pad the list to `max_batch_size` inside the handler so every
    invocation hits the same compiled program shape.
    """

    def deco(fn):
        state_attr = f"__serve_batch_{fn.__name__}"

        @functools.wraps(fn)
        def wrapper(self_or_req, *maybe_req):
            if maybe_req:
                self_obj, request = self_or_req, maybe_req[0]
                holder = self_obj
            else:  # function deployment (no self)
                self_obj, request = None, self_or_req
                holder = wrapper
            st = getattr(holder, state_attr, None)
            if st is None:
                # dict.setdefault is atomic under the GIL — race-free
                # install without a module-global lock.
                st = holder.__dict__.setdefault(state_attr, _BatchState())
                st = getattr(holder, state_attr)
            item = _BatchItem(request)
            with st.cv:
                st.items.append(item)
                st.cv.notify_all()
                if st.leader_active:
                    leader = False
                else:
                    st.leader_active = True
                    leader = True
            if not leader:
                item.event.wait()
                if item.error is not None:
                    raise item.error
                return item.result

            # Leader: wait for the batch to fill or the window to lapse.
            deadline = time.monotonic() + batch_wait_timeout_s
            with st.cv:
                while len(st.items) < max_batch_size:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    st.cv.wait(timeout=remaining)
                batch_items, st.items = (
                    st.items[:max_batch_size],
                    st.items[max_batch_size:],
                )
                st.leader_active = False
                if st.items:
                    # Late arrivals beyond this batch need their own
                    # leader; wake one follower to claim it.
                    st.cv.notify_all()
            # Followers left behind re-elect: the first of them to wake
            # finds leader_active False and takes over. (They are blocked
            # on item.event, not the cv — promote explicitly instead.)
            _promote_follower(st, fn, self_obj, max_batch_size, batch_wait_timeout_s)
            try:
                _distribute(fn, self_obj, batch_items)
            finally:
                for i in batch_items:
                    if i is not item:
                        i.event.set()
            if not any(i is item for i in batch_items):
                # A backlog predating this leader filled the slice before
                # our own item: it rides a later batch (helper thread).
                item.event.wait()
            if item.error is not None:
                raise item.error
            return item.result

        wrapper.__serve_batch__ = True  # type: ignore[attr-defined]
        return wrapper

    if _func is not None:
        return deco(_func)
    return deco


def _promote_follower(st: _BatchState, fn, self_obj, max_batch_size, timeout_s) -> None:
    """Items queued past the leader's cut need a new leader; run one on a
    helper thread (they are parked on their events)."""
    with st.cv:
        if not st.items or st.leader_active:
            return
        st.leader_active = True

    def lead():
        deadline = time.monotonic() + timeout_s
        with st.cv:
            while len(st.items) < max_batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                st.cv.wait(timeout=remaining)
            batch_items, st.items = (
                st.items[:max_batch_size],
                st.items[max_batch_size:],
            )
            st.leader_active = False
        if not batch_items:
            return
        try:
            _distribute(fn, self_obj, batch_items)
        finally:
            for i in batch_items:
                i.event.set()
        _promote_follower(st, fn, self_obj, max_batch_size, timeout_s)

    threading.Thread(target=lead, daemon=True, name="serve-batch").start()


def multiplexed(
    _func: Optional[Callable] = None, *, max_num_models_per_replica: int = 3
):
    """Decorator for a model loader `def get_model(self, model_id)`:
    caches up to `max_num_models_per_replica` loaded models per replica
    with LRU eviction (reference: python/ray/serve/api.py:558 +
    multiplex.py). Call with no argument inside a request to load the
    model named by the request's multiplexed model id."""

    def deco(fn):
        cache_attr = f"__serve_mux_{fn.__name__}"

        @functools.wraps(fn)
        def wrapper(self, model_id: Optional[str] = None):
            if model_id is None:
                model_id = get_multiplexed_model_id()
            if not model_id:
                raise ValueError(
                    "no model id: pass one explicitly or set "
                    "handle.options(multiplexed_model_id=...)"
                )
            st = getattr(self, cache_attr, None)
            if st is None:
                self.__dict__.setdefault(
                    cache_attr,
                    {"lock": threading.Lock(), "models": collections.OrderedDict()},
                )
                st = getattr(self, cache_attr)
            with st["lock"]:
                if model_id in st["models"]:
                    st["models"].move_to_end(model_id)
                    return st["models"][model_id]
            model = fn(self, model_id)
            if inspect.iscoroutine(model):
                model = asyncio.run(model)
            with st["lock"]:
                st["models"][model_id] = model
                st["models"].move_to_end(model_id)
                while len(st["models"]) > max_num_models_per_replica:
                    _mid, evicted = st["models"].popitem(last=False)
                    # Give the model a chance to release device memory.
                    unload = getattr(evicted, "__serve_unload__", None)
                    if callable(unload):
                        try:
                            unload()
                        except Exception:
                            # A failed unload hook may leak device memory
                            # until the replica dies — say which model.
                            logging.getLogger(__name__).warning(
                                "__serve_unload__ failed for evicted model %r",
                                _mid, exc_info=True,
                            )
            return model

        wrapper.__serve_multiplexed__ = True  # type: ignore[attr-defined]
        return wrapper

    if _func is not None:
        return deco(_func)
    return deco
