"""Model adapters for the LLM engine (counterpart of
ray_tpu/serve/llm/model.py).

The engine schedules against a small protocol: an object with
`prefill(prompt, pages, cached_tokens) -> token` and
`decode(last_tokens, positions, block_tables) -> tokens`, plus the pool
geometry attributes. StubModel is a deterministic model for scheduler
tests; PagedLM runs models/transformer.py's paged prefill and decode. The
module-level builders (tiny_paged_lm, stub_model, llama2_7b_paged_lm) are
what `llm_deployment` hands each replica.
"""

from __future__ import annotations

import math
import threading
from typing import List, Sequence

import torch

from ...models import transformer as tfm
from .kv_cache import TRASH_PAGE


class StubModel:
    """Deterministic model for scheduler tests: next token =
    (last + 1) % vocab. `step_delay_s` simulates decode latency so tests
    can observe continuous batching join/leave behaviour."""

    def __init__(
        self,
        *,
        vocab: int = 256,
        max_slots: int = 4,
        max_pages_per_seq: int = 8,
        step_delay_s: float = 0.0,
    ):
        self.vocab = vocab
        self.max_slots = max_slots
        self.max_pages_per_seq = max_pages_per_seq
        self.step_delay_s = step_delay_s
        self.prefill_calls = 0
        self.decode_calls = 0

    def prefill(self, prompt: Sequence[int], pages: Sequence[int], cached_tokens: int) -> int:
        self.prefill_calls += 1
        return (sum(prompt) + 1) % self.vocab

    def decode(self, last_tokens, positions, block_tables) -> List[int]:
        self.decode_calls += 1
        if self.step_delay_s:
            import time

            time.sleep(self.step_delay_s)
        return [
            (int(t) + 1) % self.vocab if int(p) >= 0 else 0
            for t, p in zip(last_tokens, positions)
        ]


class PagedLM:
    """Paged-KV inference adapter over models/transformer.py.

    Owns the params and the physical page pool; the engine owns the page
    bookkeeping and passes block tables in. Decode runs at fixed shapes
    ([max_slots] tokens, [max_slots, max_pages_per_seq] block tables) and
    prefill pads prompts to a power-of-two number of pages. Greedy argmax
    runs on the device, so only int tokens cross to the host.
    """

    def __init__(
        self,
        cfg: tfm.TransformerConfig = None,
        params=None,
        *,
        seed: int = 0,
        device=None,
        num_pages: int = 128,
        page_tokens: int = 16,
        max_slots: int = 4,
        max_pages_per_seq: int = 8,
    ):
        from ..._device import resolve_device

        self.device = resolve_device(device)
        if cfg is None:
            cfg = tfm.tiny(attn_impl="naive", dtype=torch.float32)
        self.cfg = cfg
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = tfm.init_params(cfg, gen, self.device)
        self.params = params
        self.vocab = cfg.vocab_size
        self.num_pages = num_pages
        self.page_tokens = page_tokens
        self.max_slots = max_slots
        self.max_pages_per_seq = max_pages_per_seq
        self.kv = tfm.init_kv_pages(cfg, num_pages, page_tokens, self.device)
        # One lock around every model step: the engine loop is the only
        # steady-state caller, but tests call prefill directly.
        self._mu = threading.Lock()

    def _bucket_pages(self, n_pages: int) -> int:
        return min(self.max_pages_per_seq, 1 << max(0, math.ceil(math.log2(n_pages))))

    def prefill(self, prompt: Sequence[int], pages: Sequence[int], cached_tokens: int) -> int:
        T = self.page_tokens
        n_pages = max(1, -(-len(prompt) // T))
        bucket = self._bucket_pages(n_pages)
        S = bucket * T
        toks = torch.zeros((1, S), dtype=torch.long)
        toks[0, : len(prompt)] = torch.as_tensor(list(prompt), dtype=torch.long)
        bt = torch.full((bucket,), TRASH_PAGE, dtype=torch.long)
        bt[: len(pages)] = torch.as_tensor(list(pages), dtype=torch.long)
        with self._mu, torch.inference_mode():
            logits, _ = tfm.forward_prefill(
                self.params, toks.to(self.device), self.cfg, self.kv,
                bt.to(self.device), len(prompt), int(cached_tokens),
            )
            return int(torch.argmax(logits[0]))

    def decode(self, last_tokens, positions, block_tables) -> List[int]:
        B, P = self.max_slots, self.max_pages_per_seq
        toks = torch.zeros((B,), dtype=torch.long)
        pos = torch.full((B,), -1, dtype=torch.long)
        bts = torch.full((B, P), TRASH_PAGE, dtype=torch.long)
        toks[: len(last_tokens)] = torch.as_tensor(list(last_tokens), dtype=torch.long)
        pos[: len(positions)] = torch.as_tensor(list(positions), dtype=torch.long)
        for i, row in enumerate(block_tables):
            bts[i, : len(row)] = torch.as_tensor(list(row), dtype=torch.long)
        with self._mu, torch.inference_mode():
            logits, _ = tfm.forward_decode(
                self.params, toks.to(self.device), pos.to(self.device), self.cfg,
                self.kv, bts.to(self.device),
            )
            return torch.argmax(logits, dim=-1).tolist()


def tiny_paged_lm(**kw) -> PagedLM:
    """Builder for deployments and tests: PagedLM(**kw), by default the
    test-sized transformer on the paged decode path."""
    return PagedLM(**kw)


def stub_model(**kw) -> StubModel:
    return StubModel(**kw)


def llama2_7b_paged_lm(*, seed: int = 0, device=None, **geometry) -> PagedLM:
    """Builder for `llm_deployment`: Llama-2-7B at full width and depth in
    bf16, random weights from `seed`, on `device` (the current CUDA device
    by default). `geometry` sets the pool (num_pages, page_tokens,
    max_slots, max_pages_per_seq)."""
    return PagedLM(tfm.llama2_7b(dtype=torch.bfloat16), seed=seed, device=device, **geometry)
