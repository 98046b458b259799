"""serve.llm for the PyTorch port: continuous batching, paged KV cache with
prefix reuse, the paged prefill/decode adapter, and the engine as a Serve
deployment.

- kv_cache:   free-list page allocator, refcounted pages, hashed-prefix
              radix index (shared system prompts cost one physical copy);
- engine:     resident continuous-batching loop (token-level join/leave,
              prefill admission against a token budget, typed
              reject-with-backpressure shedding);
- model:      PagedLM over models/transformer.py, StubModel, and the
              builders a deployment takes (tiny_paged_lm, stub_model,
              llama2_7b_paged_lm);
- feed:       persistent channel request path (no per-call actor task);
- deployment: LLMServer / llm_deployment, the serve-facing surface.
"""

from .deployment import LLMServer, llm_deployment
from .engine import EngineConfig, InferenceEngine
from .feed import FeedServer, LLMClient
from .kv_cache import PagedKVAllocator, SeqPages
from .model import PagedLM, StubModel, llama2_7b_paged_lm, stub_model, tiny_paged_lm

__all__ = [
    "EngineConfig",
    "FeedServer",
    "InferenceEngine",
    "LLMClient",
    "LLMServer",
    "PagedKVAllocator",
    "PagedLM",
    "SeqPages",
    "StubModel",
    "llama2_7b_paged_lm",
    "llm_deployment",
    "stub_model",
    "tiny_paged_lm",
]
