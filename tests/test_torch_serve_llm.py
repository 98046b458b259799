"""The port's LLM serving path (ray_tpu_torch.serve.llm) on the CPU.

- the paged prefill/decode path against the port's own full forward
  (the port of tests/test_models.py::test_paged_decode_matches_full_forward);
- PagedLM and the paged forwards against the JAX package's, on one param
  tree moved across as numpy, float32, JAX at `highest` matmul precision;
- InferenceEngine over the port's PagedLM, and the scheduler and allocator
  copies over StubModel (mirrors of tests/test_serve_llm.py).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtfm
from ray_tpu_torch.exceptions import BackpressureError, KVPoolExhaustedError, RayTpuError
from ray_tpu_torch.models import transformer as ttfm
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.serve.llm import (
    EngineConfig,
    InferenceEngine,
    PagedKVAllocator,
    PagedLM,
    StubModel,
)


@pytest.fixture(autouse=True)
def _exact_matmuls():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


def _wait_for(predicate, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        last = predicate()
        if last:
            return last
        time.sleep(interval)
    return last


def _gold(lm, prompt, n):
    """Greedy tokens from the port's full forward, recomputed per token."""
    seq, out = list(prompt), []
    for _ in range(n):
        logits = ttfm.forward(lm.params, torch.tensor([seq]), lm.cfg)
        nxt = int(torch.argmax(logits[0, len(seq) - 1]))
        out.append(nxt)
        seq.append(nxt)
    return out


def _paged(lm, alloc, prompt, n, sp, slot):
    """Decode `n` tokens for `sp` in `slot`; the other slot idles (position
    -1, writes to the trash page)."""
    T = lm.page_tokens
    got = [lm.prefill(prompt, sp.pages, sp.cached_tokens)]
    alloc.commit(sp, prompt)
    while len(got) < n:
        pos = len(prompt) + len(got) - 1
        if pos >= sp.num_pages * T:
            alloc.extend(sp)
        toks, poss, tabs = [0, 0], [-1, -1], [[], []]
        toks[slot], poss[slot], tabs[slot] = got[-1], pos, sp.pages
        got.append(int(lm.decode(toks, poss, tabs)[slot]))
    return got


# 13-token prompt: crosses a page boundary mid-prompt and during decode
# (position 16 needs a third page via alloc.extend).
P1 = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9]


@pytest.mark.parametrize("attn_impl", ["naive", "full"])
def test_paged_decode_matches_full_forward(attn_impl):
    cfg = ttfm.tiny(attn_impl=attn_impl, dtype=torch.float32)
    T = 8
    lm = PagedLM(cfg, seed=0, device="cpu", num_pages=32, page_tokens=T, max_slots=2,
                 max_pages_per_seq=8)
    alloc = PagedKVAllocator(32, T)
    assert _paged(lm, alloc, P1, 8, alloc.allocate(P1), slot=0) == _gold(lm, P1, 8)
    # Prefix-cached sequence in the other slot: shares P1's first full page
    # physically (prefill skips re-writing it) and must still match.
    p2 = P1[:T] + [7, 7]
    sp2 = alloc.allocate(p2)
    assert sp2.cached_tokens == T
    assert _paged(lm, alloc, p2, 5, sp2, slot=1) == _gold(lm, p2, 5)


def _twin_models(T=8, num_pages=32):
    from ray_tpu.serve.llm.model import PagedLM as JaxPagedLM

    jcfg = jtfm.tiny(attn_impl="full", dtype=jnp.float32)
    tcfg = ttfm.tiny(attn_impl="full", dtype=torch.float32)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    geo = dict(num_pages=num_pages, page_tokens=T, max_slots=2, max_pages_per_seq=8)
    jlm = JaxPagedLM(jcfg, jparams, **geo)
    tlm = PagedLM(tcfg, params_from_numpy(np_params, tcfg, device="cpu"), device="cpu", **geo)
    return jlm, tlm


def test_paged_lm_greedy_tokens_match_jax():
    jlm, tlm = _twin_models()

    def run(lm):
        alloc = PagedKVAllocator(32, 8)
        p2 = P1[:8] + [7, 7]  # prefix-cached in the second slot
        first = _paged(lm, alloc, P1, 8, alloc.allocate(P1), slot=0)
        return first, _paged(lm, alloc, p2, 5, alloc.allocate(p2), slot=1)

    assert run(tlm) == run(jlm)


def test_paged_forwards_logits_and_pool_match_jax():
    jlm, tlm = _twin_models()
    T, S = 8, 32
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, (1, S), dtype=np.int32)
    block_table = np.array([3, 7, 1, 9], dtype=np.int32)
    length, write_from = 21, 8  # first page counts as prefix-cached

    jlogits, jkv = jtfm.forward_prefill(
        jlm.params, jnp.asarray(tokens), jlm.cfg, jlm.kv, jnp.asarray(block_table),
        jnp.int32(length), jnp.int32(write_from),
    )
    tlogits, tkv = ttfm.forward_prefill(
        tlm.params, torch.from_numpy(tokens), tlm.cfg, tlm.kv, torch.from_numpy(block_table),
        length, write_from,
    )
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
    for name in ("k", "v"):
        real = [3, 7, 1]  # pages the prompt covers (the trash page is never read)
        np.testing.assert_allclose(
            tkv[name].numpy()[:, real], np.asarray(jkv[name])[:, real], atol=1e-5
        )

    # Slot 0 continues the sequence at position 21; slot 1 is inactive.
    dtoks = np.array([17, 0], dtype=np.int32)
    positions = np.array([length, -1], dtype=np.int32)
    tables = np.zeros((2, 8), dtype=np.int32)
    tables[0, :4] = block_table
    jdl, jkv = jtfm.forward_decode(
        jlm.params, jnp.asarray(dtoks), jnp.asarray(positions), jlm.cfg, jkv, jnp.asarray(tables)
    )
    tdl, tkv = ttfm.forward_decode(
        tlm.params, torch.from_numpy(dtoks), torch.from_numpy(positions), tlm.cfg, tkv,
        torch.from_numpy(tables),
    )
    np.testing.assert_allclose(tdl.numpy()[0], np.asarray(jdl)[0], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        tkv["k"].numpy()[:, 1, length % T], np.asarray(jkv["k"])[:, 1, length % T], atol=1e-5
    )


def test_engine_serves_concurrent_requests_on_paged_lm():
    cfg = ttfm.tiny(attn_impl="full", dtype=torch.float32)
    lm = PagedLM(cfg, seed=1, device="cpu", num_pages=64, page_tokens=8, max_slots=4,
                 max_pages_per_seq=8)
    eng = InferenceEngine(lm, EngineConfig(page_tokens=8, pool_pages=64), name="torch-cpu")
    prompts = [P1, [9, 9, 8, 7, 2], list(range(20, 41))]
    results = {}
    try:
        def run(i):
            results[i] = list(eng.generate(prompts[i], 6))

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for i, p in enumerate(prompts):
            assert results[i] == _gold(lm, p, 6), i
        assert eng.stats()["tokens_emitted"] == 18
        assert _wait_for(lambda: eng.alloc.used_pages() == 0)
    finally:
        eng.close()


def test_paged_lm_without_a_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedLM()


# ------------------------------------------------ allocator (port's copy)


def test_allocator_alloc_release_and_exhaustion():
    a = PagedKVAllocator(num_pages=4, page_tokens=4)  # 3 usable pages
    assert a.total_pages == 3
    sp = a.allocate(list(range(8)))
    assert sp.num_pages == 2 and 0 not in sp.pages
    with pytest.raises(KVPoolExhaustedError) as ei:
        a.allocate(list(range(100, 108)))
    assert isinstance(ei.value, BackpressureError)
    assert ei.value.needed_pages == 2 and ei.value.free_pages == 1
    assert a.used_pages() == 2  # the failed allocation reserved nothing
    a.release(sp)
    a.release(sp)  # idempotent
    assert a.free_pages() == 3


def test_allocator_prefix_reuse_and_eviction():
    a = PagedKVAllocator(num_pages=10, page_tokens=4)
    system = list(range(8))
    s1 = a.allocate(system + [50, 51])
    a.commit(s1, system + [50, 51])
    s2 = a.allocate(system + [60])
    assert s2.pages[:2] == s1.pages[:2] and s2.cached_tokens == 8
    assert a.stats()["prefix_hits"] == 2
    a.release(s1)
    a.release(s2)
    s3 = a.allocate(system + [70])  # revived from the eviction LRU
    assert s3.pages[:2] == s1.pages[:2]
    a.release(s3)
    big = a.allocate(list(range(100, 136)))  # evicts cold cached pages
    assert big.num_pages == 9
    a.release(big)


# --------------------------------------------------- engine (port's copy)


def _stub_tokens(prompt, n, vocab=256):
    first = (sum(prompt) + 1) % vocab
    return [(first + i) % vocab for i in range(n)]


def test_engine_stream_cancel_and_shed():
    eng = InferenceEngine(StubModel(step_delay_s=0.02), EngineConfig(page_tokens=4, pool_pages=4))
    try:
        assert list(eng.generate([1, 2, 3], 4)) == _stub_tokens([1, 2, 3], 4)
        it = eng.generate([1] * 8, 25)  # holds 2 of 3 pages
        next(it)
        with pytest.raises(KVPoolExhaustedError):
            eng.submit([2] * 8, 2, sink=lambda ev, v: None)
        assert eng.stats()["shed_total"] == 1
        it.close()  # client disconnect cancels and frees within a step
        assert _wait_for(lambda: eng.alloc.used_pages() == 0, timeout=5.0)
        with pytest.raises(ValueError):
            eng.submit([], 4, sink=lambda ev, v: None)
    finally:
        eng.close()


def test_engine_queue_full_and_close_fail_typed():
    eng = InferenceEngine(StubModel(), EngineConfig(page_tokens=4, pool_pages=16, max_queue=0))
    try:
        with pytest.raises(BackpressureError):
            eng.submit([1], 1, sink=lambda ev, v: None)
    finally:
        eng.close()
    eng = InferenceEngine(StubModel(step_delay_s=0.05), EngineConfig(page_tokens=4, pool_pages=16))
    it = eng.generate([1, 2], 25)
    next(it)
    eng.close()
    with pytest.raises(RayTpuError):
        list(it)
    assert eng.alloc.used_pages() == 0


def test_engine_decode_fault_fails_batch_typed_then_recovers():
    class FlakyStub(StubModel):
        def decode(self, last_tokens, positions, block_tables):
            if self.decode_calls == 0:
                self.decode_calls += 1
                raise RuntimeError("device fault")
            return super().decode(last_tokens, positions, block_tables)

    eng = InferenceEngine(FlakyStub(), EngineConfig(page_tokens=4, pool_pages=16))
    try:
        with pytest.raises(RayTpuError, match="device fault"):
            list(eng.generate([1, 2, 3], 10))
        assert _wait_for(lambda: eng.alloc.used_pages() == 0, timeout=5.0)
        assert list(eng.generate([1, 2, 3], 4)) == _stub_tokens([1, 2, 3], 4)
    finally:
        eng.close()
