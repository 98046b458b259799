"""LLMDeployment: the inference engine as a serve deployment (copy of
ray_tpu/serve/llm/deployment.py for the PyTorch port).

Each replica runs one resident InferenceEngine (its decode loop is the
replica gang's long-lived program) and exposes four surfaces:

- `__call__(prompt, max_new_tokens)` — the ordinary serve path: a
  generator of token ids riding the existing streaming protocol
  (handle.options(stream=True), TTFT observed at the first chunk);
- `attach_feed(resp_spec)` — the channel fast path: LLMClient
  (feed.py) attaches once and every subsequent request/token crosses
  persistent channels with no per-call actor-task submission;
- `engine_stats()` — pool occupancy / queue depth for tests and drills;
- `cancel_stream(token)` — the replica's client-disconnect hook: a
  handle-side `close()` names its stream by cancel token and the engine
  interrupts it mid-decode (pages + slot free within one step).

The deployment callable carries `__llm_engine__` so replica plumbing
can recognize engine-bearing deployments without importing this module;
non-LLM deployments never construct any of this.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, Optional

from ..batching import get_request_cancel_token
from ..deployment import deployment
from .engine import EngineConfig, InferenceEngine
from .feed import FeedServer


class LLMServer:
    """The deployment class serve instantiates per replica."""

    __llm_engine__ = True

    def __init__(
        self,
        model_builder,
        model_kwargs: Optional[Dict[str, Any]] = None,
        engine_config: Optional[EngineConfig] = None,
        name: str = "llm",
    ):
        self.name = name
        self.model = model_builder(**(model_kwargs or {}))
        self.engine = InferenceEngine(self.model, engine_config, name=name)
        self.feed = FeedServer(self.engine, name=name)
        # cancel_token -> engine rid, so a client-side stream close()
        # reaches engine.cancel while the stream thread is blocked in
        # decode. Bounded: entries for streams that complete uncancelled
        # age out (a stale cancel of a finished rid is a no-op).
        self._cancel_rids: "OrderedDict[str, int]" = OrderedDict()
        self._cancel_lock = threading.Lock()

    def __call__(self, prompt, max_new_tokens: Optional[int] = None):
        # submit() runs eagerly inside generate(): backpressure surfaces
        # as a typed raise on the request, not a broken stream.
        token = get_request_cancel_token()
        on_submit = None
        if token:

            def on_submit(rid, _tok=token):
                with self._cancel_lock:
                    self._cancel_rids[_tok] = rid
                    while len(self._cancel_rids) > 1024:
                        self._cancel_rids.popitem(last=False)

        return self.engine.generate(prompt, max_new_tokens, on_submit=on_submit)

    def cancel_stream(self, token: str) -> bool:
        """Replica plumbing calls this on a client close(): interrupts
        the in-flight request so its KV pages and batch slot free within
        one decode step instead of at end-of-generation."""
        with self._cancel_lock:
            rid = self._cancel_rids.pop(token, None)
        if rid is None:
            return False
        self.engine.cancel(rid)
        return True

    def attach_feed(self, resp_spec):
        return self.feed.attach(resp_spec)

    def engine_stats(self) -> dict:
        return self.engine.stats()

    def shutdown_engine(self) -> bool:
        self.feed.close()
        self.engine.close()
        return True


def llm_deployment(
    model_builder,
    *,
    name: str = "llm",
    model_kwargs: Optional[Dict[str, Any]] = None,
    engine_config: Optional[EngineConfig] = None,
    num_replicas: int = 1,
    max_ongoing_requests: int = 64,
    ray_actor_options: Optional[Dict[str, Any]] = None,
):
    """Builds a bound, ready-to-`serve.run` LLM application.

    `model_builder` is a callable (e.g. serve.llm.model.tiny_paged_lm or
    llama2_7b_paged_lm) returning an object with the model-adapter
    protocol (model.py); the replica calls it with `model_kwargs`. The
    in-process runtime passes it as it is, so a closure or a
    functools.partial works too."""
    dep = deployment(
        LLMServer,
        name=name,
        num_replicas=num_replicas,
        max_ongoing_requests=max_ongoing_requests,
        ray_actor_options=ray_actor_options,
    )
    return dep.bind(model_builder, model_kwargs, engine_config, name)
