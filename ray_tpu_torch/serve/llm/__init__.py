"""serve.llm for the PyTorch port: continuous batching, paged KV cache with
prefix reuse, and the paged prefill/decode adapter.

- kv_cache: free-list page allocator, refcounted pages, hashed-prefix radix
  index (shared system prompts cost one physical copy);
- engine:   resident continuous-batching loop (token-level join/leave,
  prefill admission against a token budget, typed reject-with-backpressure
  shedding);
- model:    PagedLM over models/transformer.py, and StubModel.

The Serve deployment and the cgraph feed (ray_tpu/serve/llm/deployment.py,
feed.py) are not ported yet: they need the runtime.
"""

from .engine import EngineConfig, InferenceEngine
from .kv_cache import PagedKVAllocator, SeqPages
from .model import PagedLM, StubModel

__all__ = [
    "EngineConfig",
    "InferenceEngine",
    "PagedKVAllocator",
    "PagedLM",
    "SeqPages",
    "StubModel",
]
