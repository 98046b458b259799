"""Continuous-batching inference engine (copy of
ray_tpu/serve/llm/engine.py for the PyTorch port).

One resident loop per replica owns a fixed set of decode SLOTS (the
compiled step's batch width). Requests join a slot the moment one frees
up — token-level scheduling, not request-level: a finishing sequence
leaves the batch between two decode steps and an admitted prefill takes
its slot for the next step (Orca's iteration-level scheduling; vLLM's
engine loop). Prefill admission is interleaved against a token budget so
a burst of long prompts cannot starve decode latency for running
sequences.

Admission control is synchronous reject-with-backpressure: submit()
either reserves KV pages for the whole prompt or raises
KVPoolExhaustedError/BackpressureError (typed) immediately — the caller
sheds load instead of queueing into a pool that cannot hold it.

Token emission is push-based via per-request sinks; generate() adapts a
sink to the blocking iterator the serve streaming path consumes. A
dropped consumer cancels the request: its pages and slot are reclaimed
within one decode step (the cancel queue drains at the top of every loop
iteration).
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence

from ...chaos.controller import kill_now as _chaos_kill
from ...chaos.controller import maybe_inject as _chaos_inject
from ...exceptions import BackpressureError, KVPoolExhaustedError, RayTpuError
from ...utils import internal_metrics as imet
from .kv_cache import PagedKVAllocator, SeqPages

logger = logging.getLogger(__name__)

Sink = Callable[[str, object], None]  # events: "tok" int | "done" str | "error" exc


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass(frozen=True)
class EngineConfig:
    page_tokens: int = field(default_factory=lambda: _env_int("RAY_TPU_KV_PAGE_TOKENS", 16))
    pool_pages: int = field(default_factory=lambda: _env_int("RAY_TPU_KV_POOL_PAGES", 128))
    # Prompt tokens admitted (prefilled) per loop iteration; running
    # sequences get a decode step between admission rounds regardless.
    prefill_token_budget: int = field(
        default_factory=lambda: _env_int("RAY_TPU_LLM_PREFILL_BUDGET", 256)
    )
    max_queue: int = 64
    max_new_tokens: int = 32
    eos_token: Optional[int] = None


class _Seq:
    __slots__ = (
        "rid", "prompt", "max_new", "pages", "sink", "slot",
        "last_token", "n_out", "cancelled", "finished",
    )

    def __init__(self, rid: int, prompt: List[int], max_new: int, pages: SeqPages, sink: Sink):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.pages = pages
        self.sink = sink
        self.slot: Optional[int] = None
        self.last_token = 0
        self.n_out = 0
        self.cancelled = False
        self.finished = False

    def write_pos(self) -> int:
        """Cache position the NEXT decode step writes (last emitted
        token's k/v): prompt positions [0, len) are prefilled, generated
        token i lands at len(prompt) + i."""
        return len(self.prompt) + self.n_out - 1


class InferenceEngine:
    """Schedules sequences over a paged-KV model adapter (serve/llm/model.py
    protocol: `prefill`, `decode`, and the pool-geometry attributes)."""

    def __init__(self, model, config: Optional[EngineConfig] = None, name: str = "llm"):
        self.model = model
        self.config = config or EngineConfig()
        self.name = name
        cfg = self.config
        labels = {"deployment": name}
        self._m_tpot = imet.SERVE_TPOT.labels(**labels)
        self._m_tps = imet.SERVE_TOKENS_PER_S.labels(**labels)
        self._m_shed = imet.SERVE_REQUESTS_SHED.labels(**labels)
        self.alloc = PagedKVAllocator(
            cfg.pool_pages,
            cfg.page_tokens,
            metrics={
                "used": imet.KV_PAGES_USED.labels(**labels),
                "total": imet.KV_PAGES_TOTAL.labels(**labels),
                "hits": imet.PREFIX_CACHE_HITS.labels(**labels),
                "misses": imet.PREFIX_CACHE_MISSES.labels(**labels),
            },
        )
        self._rid = itertools.count(1)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._waiting: Deque[_Seq] = collections.deque()
        self._slots: List[Optional[_Seq]] = [None] * model.max_slots
        self._by_rid: Dict[int, _Seq] = {}
        self._cancels: Deque[int] = collections.deque()
        self._stop = False
        self.shed_total = 0
        self.tokens_emitted = 0
        self.decode_steps = 0
        self._tok_window = 0
        self._t_window = time.monotonic()
        self._thread = threading.Thread(
            target=self._loop, name=f"llm-engine-{name}", daemon=True
        )
        self._thread.start()

    # ---------------------------------------------------------- admission

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: Optional[int] = None,
        *,
        sink: Sink,
    ) -> int:
        """Reserves pages and enqueues; raises BackpressureError (shed)
        when the queue or the page pool cannot take the request."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        max_new = int(max_new_tokens or self.config.max_new_tokens)
        cap = self.model.max_pages_per_seq * self.config.page_tokens
        if len(prompt) + max_new - 1 > cap:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new}) exceeds "
                f"per-sequence KV capacity ({cap} positions)"
            )
        with self._cond:
            if self._stop:
                raise RuntimeError("engine is shut down")
            if len(self._waiting) >= self.config.max_queue:
                self.shed_total += 1
                self._m_shed.inc()
                raise BackpressureError(
                    reason=f"admission queue full ({self.config.max_queue})"
                )
            try:
                pages = self.alloc.allocate(prompt)
            except KVPoolExhaustedError:
                self.shed_total += 1
                self._m_shed.inc()
                raise
            rid = next(self._rid)
            seq = _Seq(rid, prompt, max_new, pages, sink)
            self._by_rid[rid] = seq
            self._waiting.append(seq)
            self._cond.notify()
            return rid

    def generate(
        self,
        prompt: Sequence[int],
        max_new_tokens: Optional[int] = None,
        on_submit=None,
    ):
        """Blocking token iterator over a submitted request — the shape
        the serve streaming path consumes. Closing the generator (client
        disconnect) cancels the request and frees its pages. `on_submit`
        (if given) receives the request id once admission succeeds, so
        callers can cancel() from another thread while this iterator is
        blocked producing."""
        q: "queue.SimpleQueue" = queue.SimpleQueue()
        rid = self.submit(
            prompt, max_new_tokens, sink=lambda ev, val: q.put((ev, val))
        )
        if on_submit is not None:
            on_submit(rid)

        def _iter():
            try:
                while True:
                    ev, val = q.get()
                    if ev == "tok":
                        yield val
                    elif ev == "done":
                        return
                    else:
                        raise val
            finally:
                self.cancel(rid)

        return _iter()

    def cancel(self, rid: int) -> None:
        """Requests removal; the loop reclaims the slot and pages at the
        top of its next iteration (<= one decode step later). Idempotent,
        and a no-op for already-finished requests."""
        with self._cond:
            seq = self._by_rid.get(rid)
            if seq is None or seq.finished:
                return
            seq.cancelled = True
            self._cancels.append(rid)
            self._cond.notify()

    # --------------------------------------------------------------- loop

    def _finish_locked(self, seq: _Seq, event: str, payload) -> None:
        seq.finished = True
        if seq.slot is not None:
            self._slots[seq.slot] = None
            seq.slot = None
        self._by_rid.pop(seq.rid, None)
        self.alloc.release(seq.pages)
        try:
            seq.sink(event, payload)
        except Exception:  # lint: swallow-ok(sink owner gone; request is already torn down)
            pass

    def _drain_cancels_locked(self) -> None:
        while self._cancels:
            rid = self._cancels.popleft()
            seq = self._by_rid.get(rid)
            if seq is None:
                continue
            try:
                self._waiting.remove(seq)
            except ValueError:
                pass  # not waiting: running in a slot (or already gone)
            self._finish_locked(seq, "done", "cancelled")

    def _pick_admissions_locked(self) -> List[_Seq]:
        """Pops waiting sequences into free slots up to the prefill token
        budget. Slots are reserved here (under the lock); the prefill
        compute itself runs outside it."""
        budget = self.config.prefill_token_budget
        admitted: List[_Seq] = []
        while self._waiting and None in self._slots:
            seq = self._waiting[0]
            new_tokens = len(seq.prompt) - seq.pages.cached_tokens
            if admitted and new_tokens > budget:
                break  # interleave: let running sequences decode first
            self._waiting.popleft()
            slot = self._slots.index(None)
            seq.slot = slot
            self._slots[slot] = seq
            budget -= new_tokens
            admitted.append(seq)
        return admitted

    def _finalize_admission_locked(self, seq: _Seq, tok: Optional[int], err) -> None:
        if seq.finished:
            return  # cancelled and reaped while prefilling
        if err is not None:
            self._finish_locked(seq, "error", _typed(err))
            return
        if seq.cancelled:
            self._finish_locked(seq, "done", "cancelled")
            return
        self.alloc.commit(seq.pages, seq.prompt)
        seq.last_token = tok
        self._emit_locked(seq, tok)
        if self._done_after_emit(seq, tok):
            self._finish_locked(seq, "done", "stop")

    def _emit_locked(self, seq: _Seq, tok: int) -> None:
        seq.n_out += 1
        self.tokens_emitted += 1
        self._tok_window += 1
        try:
            seq.sink("tok", int(tok))
        except Exception:
            # lint: swallow-ok(consumer gone mid-emit; cancellation frees
            # the sequence on the next iteration)
            seq.cancelled = True
            self._cancels.append(seq.rid)

    def _done_after_emit(self, seq: _Seq, tok: int) -> bool:
        if seq.n_out >= seq.max_new:
            return True
        eos = self.config.eos_token
        return eos is not None and int(tok) == int(eos)

    def _loop(self) -> None:
        T = self.config.page_tokens
        while True:
            with self._cond:
                self._drain_cancels_locked()
                while (
                    not self._stop
                    and not self._waiting
                    and not any(self._slots)
                    and not self._cancels
                ):
                    self._m_tps.set(0.0)
                    self._cond.wait(timeout=1.0)
                if self._stop:
                    for seq in list(self._by_rid.values()):
                        self._finish_locked(seq, "error", RayTpuError("engine shut down"))
                    return
                self._drain_cancels_locked()
                admitted = self._pick_admissions_locked()

            # Prefill outside the lock (prompt-sized device work):
            # submit/cancel stay responsive while prompts burn in.
            prefilled = []
            for seq in admitted:
                tok, err = None, None
                try:
                    tok = self.model.prefill(
                        seq.prompt, seq.pages.pages, seq.pages.cached_tokens
                    )
                except Exception as e:  # noqa: BLE001 - fail one request, not the loop
                    err = e
                prefilled.append((seq, tok, err))

            with self._cond:
                for seq, tok, err in prefilled:
                    self._finalize_admission_locked(seq, tok, err)
                batch = [s for s in self._slots if s is not None]
                # Grow block tables for sequences crossing a page
                # boundary this step; pool exhaustion here fail-fasts the
                # one sequence (its pages recycle for the rest).
                for seq in list(batch):
                    if seq.write_pos() >= seq.pages.num_pages * T:
                        try:
                            self.alloc.extend(seq.pages)
                        except KVPoolExhaustedError as e:
                            batch.remove(seq)
                            self._finish_locked(seq, "error", e)
                if not batch:
                    continue
                tokens = [0] * len(self._slots)
                positions = [-1] * len(self._slots)
                tables: List[List[int]] = [[] for _ in self._slots]
                for seq in batch:
                    tokens[seq.slot] = seq.last_token
                    positions[seq.slot] = seq.write_pos()
                    tables[seq.slot] = seq.pages.pages

            # Model step runs OUTSIDE the lock: submit/cancel stay
            # responsive for the full decode latency.
            t0 = time.monotonic()
            try:
                rule = _chaos_inject("serve.decode", self.name)
                if rule is not None:
                    if rule.action == "delay":
                        time.sleep(rule.delay_s)
                    elif rule.action == "kill":
                        _chaos_kill("serve.decode", self.name)
                    else:
                        raise RayTpuError(
                            f"chaos: injected decode fault ({self.name})"
                        )
                next_tokens = self.model.decode(tokens, positions, tables)
                step_err: Optional[BaseException] = None
            except Exception as e:  # noqa: BLE001 - batch fail-fast, loop survives
                next_tokens, step_err = None, e

            step_ms = (time.monotonic() - t0) * 1000.0
            with self._cond:
                if step_err is not None:
                    # Fail-fast every sequence that was in the failed
                    # step — never wedge: pages free, slots recycle, the
                    # engine keeps serving whatever arrives next.
                    logger.warning("decode step failed on %s: %r", self.name, step_err)
                    for seq in batch:
                        if not seq.finished:
                            self._finish_locked(seq, "error", _typed(step_err))
                    continue
                self.decode_steps += 1
                self._m_tpot.observe(step_ms)
                for seq in batch:
                    if seq.finished or seq.cancelled:
                        continue
                    tok = int(next_tokens[seq.slot])
                    seq.last_token = tok
                    self._emit_locked(seq, tok)
                    if self._done_after_emit(seq, tok):
                        self._finish_locked(seq, "done", "stop")
                now = time.monotonic()
                dt = now - self._t_window
                if dt >= 0.5:
                    self._m_tps.set(self._tok_window / dt)
                    self._tok_window = 0
                    self._t_window = now

    # -------------------------------------------------------------- admin

    def stats(self) -> dict:
        with self._cond:
            running = sum(1 for s in self._slots if s is not None)
            return {
                "running": running,
                "waiting": len(self._waiting),
                "slots": len(self._slots),
                "tokens_emitted": self.tokens_emitted,
                "decode_steps": self.decode_steps,
                "shed_total": self.shed_total,
                "kv": self.alloc.stats(),
            }

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=10.0)


def _typed(err: BaseException) -> BaseException:
    """Errors crossing the streaming boundary keep taxonomy identity;
    anything else wraps so callers always get a RayTpuError subclass."""
    if isinstance(err, RayTpuError):
        return err
    wrapped = RayTpuError(f"{type(err).__name__}: {err}")
    wrapped.__cause__ = err
    return wrapped
