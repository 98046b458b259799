"""Paged KV-cache allocator with prefix reuse (copy of
ray_tpu/serve/llm/kv_cache.py for the PyTorch port).

The physical cache (device arrays, models/transformer.py init_kv_pages)
is a pool of fixed-size pages; this module owns the BOOKKEEPING: which
pages are free, which sequence holds which pages (its block table), and
which full pages hold content that future prompts can share.

Prefix reuse is a hashed-prefix radix index (vLLM's automatic prefix
caching, SGLang's RadixAttention): each FULL page of a prompt is keyed
by the chain (parent_key, tokens-in-page), so two prompts that share a
system prefix resolve to the same physical pages and the shared prefix
costs one physical copy. Pages are refcounted; when the last holder
releases an indexed page it parks on an eviction LRU with its content
intact — a later identical prefix revives it for free, while allocation
pressure evicts from the LRU's cold end before declaring the pool
exhausted.

Sizing knobs (read by the engine, documented in README):
  RAY_TPU_KV_PAGE_TOKENS  tokens per page        (default 16)
  RAY_TPU_KV_POOL_PAGES   pages in the pool      (default 128)
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ...exceptions import KVPoolExhaustedError

# Page index 0 is the model's trash page (masked writes land there); the
# allocator never hands it out.
TRASH_PAGE = 0

_PrefixKey = Tuple  # nested (parent_key, tokens_tuple); () is the root


@dataclass
class SeqPages:
    """One sequence's slice of the pool: its block table plus how much of
    the prompt arrived via the prefix cache (prefill may skip re-writing
    those positions — the bytes are already on device)."""

    pages: List[int]
    cached_tokens: int  # prompt positions covered by shared prefix pages
    released: bool = field(default=False, repr=False)

    @property
    def num_pages(self) -> int:
        return len(self.pages)


class PagedKVAllocator:
    """Free-list page allocator + refcounts + hashed-prefix radix index.

    Thread-safe: the engine loop extends/releases while submitters
    allocate. `metrics` is an optional dict of pre-bound instrument
    handles ({"hits", "misses", "used", "total"}) so the allocator stays
    importable without pulling a deployment label in here.
    """

    def __init__(self, num_pages: int, page_tokens: int, metrics: Optional[dict] = None):
        if num_pages < 2:
            raise ValueError(f"pool needs >= 2 pages (1 is the trash page), got {num_pages}")
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        self.page_tokens = page_tokens
        self.num_pages = num_pages
        self._lock = threading.Lock()
        self._free: List[int] = list(range(num_pages - 1, TRASH_PAGE, -1))
        self._ref: Dict[int, int] = {}
        # prefix index: key -> page, and the reverse map for eviction
        self._index: Dict[_PrefixKey, int] = {}
        self._page_key: Dict[int, _PrefixKey] = {}
        # zero-ref indexed pages, oldest-released first (eviction order)
        self._evictable: "collections.OrderedDict[int, None]" = collections.OrderedDict()
        self._metrics = metrics or {}
        self.prefix_hits = 0
        self.prefix_misses = 0
        g = self._metrics.get("total")
        if g is not None:
            g.set(self.total_pages)

    # ---------------------------------------------------------- capacity

    @property
    def total_pages(self) -> int:
        return self.num_pages - 1  # trash page excluded

    def used_pages(self) -> int:
        with self._lock:
            return len(self._ref)

    def free_pages(self) -> int:
        """Pages allocatable right now (free list + evictable LRU)."""
        with self._lock:
            return len(self._free) + len(self._evictable)

    def pages_for(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.page_tokens))

    # --------------------------------------------------------- allocation

    def _take_page_locked(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        if self._evictable:
            page, _ = self._evictable.popitem(last=False)  # coldest first
            key = self._page_key.pop(page, None)
            if key is not None:
                self._index.pop(key, None)
            return page
        return None

    def _return_page_locked(self, page: int) -> None:
        key = self._page_key.get(page)
        if key is not None and self._index.get(key) == page:
            # Content stays addressable: park on the LRU, revive on match.
            self._evictable[page] = None
        else:
            self._page_key.pop(page, None)
            self._free.append(page)

    def allocate(self, tokens) -> SeqPages:
        """Reserves pages covering `tokens`, reusing indexed full pages.

        Raises KVPoolExhaustedError (typed, a BackpressureError) when the
        pool — after evicting every cold cached page — still cannot hold
        the prompt. Nothing is reserved on failure.
        """
        tokens = list(tokens)
        need = self.pages_for(len(tokens))
        with self._lock:
            # Walk the radix index over FULL pages of the prompt.
            matched: List[int] = []
            key: _PrefixKey = ()
            n_full = len(tokens) // self.page_tokens
            for i in range(n_full):
                chunk = tuple(tokens[i * self.page_tokens:(i + 1) * self.page_tokens])
                key = (key, chunk)
                page = self._index.get(key)
                if page is None:
                    break
                matched.append(page)
            fresh_needed = need - len(matched)
            free_now = len(self._free) + len(self._evictable)
            # Matched evictable pages are revived, not consumed from the
            # allocatable count — but a matched page sitting on the LRU
            # both "frees" and "is used", so count conservatively: fresh
            # pages must come from pages NOT in the match set.
            revivable = sum(1 for p in matched if p in self._evictable)
            if fresh_needed > free_now - revivable:
                raise KVPoolExhaustedError(
                    needed_pages=fresh_needed,
                    free_pages=free_now - revivable,
                    total_pages=self.total_pages,
                )
            for page in matched:
                if page in self._evictable:
                    del self._evictable[page]
                self._ref[page] = self._ref.get(page, 0) + 1
            fresh: List[int] = []
            for _ in range(fresh_needed):
                page = self._take_page_locked()
                assert page is not None  # guaranteed by the check above
                self._ref[page] = 1
                fresh.append(page)
            self.prefix_hits += len(matched)
            self.prefix_misses += fresh_needed
            self._observe_locked(hits=len(matched), misses=fresh_needed)
            return SeqPages(pages=matched + fresh, cached_tokens=len(matched) * self.page_tokens)

    def extend(self, seq: SeqPages) -> int:
        """Appends one decode-growth page to `seq`'s block table."""
        with self._lock:
            page = self._take_page_locked()
            if page is None:
                raise KVPoolExhaustedError(
                    needed_pages=1, free_pages=0, total_pages=self.total_pages
                )
            self._ref[page] = 1
            seq.pages.append(page)
            self._observe_locked()
            return page

    def commit(self, seq: SeqPages, tokens) -> None:
        """Indexes `seq`'s full prompt pages so later prompts can share
        them. Called after prefill (the pages now hold real k/v)."""
        tokens = list(tokens)
        with self._lock:
            key: _PrefixKey = ()
            for i in range(len(tokens) // self.page_tokens):
                chunk = tuple(tokens[i * self.page_tokens:(i + 1) * self.page_tokens])
                key = (key, chunk)
                page = seq.pages[i]
                cur = self._index.get(key)
                if cur is None and page not in self._page_key:
                    self._index[key] = page
                    self._page_key[page] = key
                elif cur != page:
                    # A concurrent twin committed the same content first;
                    # ours stays private and frees normally.
                    break

    def release(self, seq: SeqPages) -> None:
        """Drops `seq`'s references. Idempotent — the cancel path and the
        normal finish path may race to release the same sequence."""
        with self._lock:
            if seq.released:
                return
            seq.released = True
            for page in seq.pages:
                n = self._ref.get(page, 0) - 1
                if n > 0:
                    self._ref[page] = n
                else:
                    self._ref.pop(page, None)
                    self._return_page_locked(page)
            self._observe_locked()

    # ----------------------------------------------------------- metrics

    def _observe_locked(self, hits: int = 0, misses: int = 0) -> None:
        g = self._metrics.get("used")
        if g is not None:
            g.set(len(self._ref))
        if hits:
            c = self._metrics.get("hits")
            if c is not None:
                c.inc(hits)
        if misses:
            c = self._metrics.get("misses")
            if c is not None:
                c.inc(misses)

    def stats(self) -> dict:
        with self._lock:
            return {
                "total_pages": self.total_pages,
                "used_pages": len(self._ref),
                "free_pages": len(self._free),
                "evictable_pages": len(self._evictable),
                "indexed_pages": len(self._page_key),
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
            }
