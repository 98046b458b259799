"""Runs the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases, each printing its own line, any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel from ray_tpu_torch/ops/csrc/;
  3. kernel: each kernel against its plain PyTorch version on the card, with
     its time, the plain version's, one PyTorch library call's and the bound;
  4. paged: PagedLM prefill+decode against the port's full forward, Llama-2-7B
     width, 2 layers, float32: greedy tokens must be equal;
  5. serve: InferenceEngine over PagedLM at full Llama-2-7B width in bf16
     (random weights from a seed) answers 8 requests; the flash kernel's
     launch count on that path is checked.
Then one JSON line with every kernel's numbers, and the device line last.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Published dense peaks of one H100 SXM (NVIDIA data sheet): tensor-core bf16
# and plain fp32 FLOP/s, and HBM bytes/s.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def flash_bound_ms(b, s, h, h_kv, d, dtype_name, causal):
    """Least time for one flash forward: the larger of its FLOPs (QK^T and PV
    over the unmasked pairs) over the peak for its type and its bytes (q, k,
    v read once, o and lse written once) over HBM bandwidth."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 2 * 2 * b * h * pairs * d
    es = 2 if dtype_name == "bfloat16" else 4
    nbytes = es * (2 * b * s * h * d + 2 * b * s * h_kv * d) + 4 * b * h * s
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: chip_smoke needs a CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} device {name}", flush=True)
    print(smi.splitlines()[0], flush=True)
    return name


def phase_build():
    from ray_tpu_torch.ops import _build

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    _build.build(names)
    dt = time.perf_counter() - t0
    for n in names:
        _build.load(n)
        regs = [ln.strip() for ln in _build.ptxas_reports.get(n, "").splitlines() if "registers" in ln]
        print(f"[build] {n}.cu ptxas: {' | '.join(regs) or 'cached'}", flush=True)
    print(f"[build] kernels {names} built in {dt:.1f} s", flush=True)


def phase_kernel():
    """Flash forward kernel against reference_attention_with_lse on the card."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash_attention import flash_fwd, reference_attention_with_lse

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tol = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-2)}  # (o, lse)
    # (b, s, h, h_kv, d, dtype, causal); s=1024 is the serve phase's largest
    # prefill bucket, the shape reported in the JSON line.
    cases = [(1, s, 32, 32, 128, torch.bfloat16, True) for s in (16, 128, 512, 1024, 2048)]
    cases += [(2, 256, 8, 2, 128, torch.bfloat16, True), (1, 300, 8, 8, 64, torch.float32, False),
              (1, 40, 4, 2, 16, torch.float32, True)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = None
    for b, s, h, h_kv, d, dt, causal in cases:
        q = torch.randn((b, s, h, d), generator=gen, device="cuda", dtype=torch.float32).to(dt)
        k = torch.randn((b, s, h_kv, d), generator=gen, device="cuda", dtype=torch.float32).to(dt)
        v = torch.randn((b, s, h_kv, d), generator=gen, device="cuda", dtype=torch.float32).to(dt)
        scale = d ** -0.5
        o, lse = flash_fwd(q, k, v, causal=causal, scale=scale)
        torch.cuda.synchronize()
        kr, vr = k.repeat_interleave(h // h_kv, 2), v.repeat_interleave(h // h_kv, 2)
        o_ref, lse_ref = reference_attention_with_lse(q, kr, vr, causal=causal, scale=scale)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_l = (lse - lse_ref).abs().max().item()
        name = str(dt).replace("torch.", "")
        ok = math.isfinite(err_o) and err_o <= tol[name][0] and err_l <= tol[name][1]
        ms = _time_ms(lambda: flash_fwd(q, k, v, causal=causal, scale=scale))
        plain_ms = _time_ms(lambda: reference_attention_with_lse(q, kr, vr, causal=causal, scale=scale), iters=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=h != h_kv))
        bound, by = flash_bound_ms(b, s, h, h_kv, d, name, causal)
        print(f"[kernel] flash_fwd b={b} s={s} h={h} h_kv={h_kv} d={d} {name} causal={causal}: "
              f"err o {err_o:.3g} (tol {tol[name][0]}) lse {err_l:.3g} (tol {tol[name][1]}); "
              f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
              f"bound_ms {bound:.4f} ({by})", flush=True)
        if not ok:
            _fail(f"flash_fwd disagrees with its plain version at s={s} d={d} {name}")
        if (b, s, h, d, dt, causal) == (1, 1024, 32, 128, torch.bfloat16, True):
            report = {
                "name": "flash_fwd", "route": "cuda",
                "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
                "replaces": "ray_tpu/ops/flash_attention.py:64",
                "launches": None, "max_abs_err": err_o, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            }
    return report


def phase_paged():
    """PagedLM prefill+decode against the port's full forward at Llama-2-7B
    width, 2 layers, float32: one prompt crossing a page boundary, the
    other decode slot idle. Greedy tokens must be equal."""
    import torch

    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.serve.llm import PagedKVAllocator, PagedLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tfm.llama2_7b(n_layers=2, dtype=torch.float32)
    T, n_new = 16, 8
    lm = PagedLM(cfg, seed=1, device="cuda", num_pages=16, page_tokens=T, max_slots=2,
                 max_pages_per_seq=4)
    alloc = PagedKVAllocator(16, T)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (20,), generator=gen).tolist()
    sp = alloc.allocate(prompt)
    got = [lm.prefill(prompt, sp.pages, sp.cached_tokens)]
    while len(got) < n_new:
        pos = len(prompt) + len(got) - 1
        if pos >= sp.num_pages * T:
            alloc.extend(sp)
        got.append(lm.decode([got[-1], 0], [pos, -1], [sp.pages, []])[0])
    seq, gold = list(prompt), []
    with torch.inference_mode():
        for _ in range(n_new):
            logits = tfm.forward(lm.params, torch.tensor([seq], device="cuda"), cfg)
            gold.append(int(torch.argmax(logits[0, -1])))
            seq.append(gold[-1])
    print(f"[paged] llama2_7b width, 2 layers, fp32, prompt 20 tokens over pages of {T}: "
          f"paged {got} gold {gold}", flush=True)
    if got != gold:
        _fail("paged prefill/decode disagrees with the full forward")
    del lm
    torch.cuda.empty_cache()


def _timed(fn, log):
    """fn, appending each call's host milliseconds to `log` (each PagedLM
    step ends in a device-to-host copy of its tokens, so that waits for the
    device)."""
    def wrapper(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        log.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapper


def _print_profile(prof, wall_s):
    """Device time by kernel over the serve window, and the device's busy
    share of that window (one stream, so kernel times do not overlap)."""
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"[profile] device busy {busy_us / 1e3:.1f} ms of {wall_s * 1e3:.1f} ms wall "
          f"({100 * busy_us / 1e3 / (wall_s * 1e3):.1f}%)", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"[profile] {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d} x  {e.key[:90]}",
              flush=True)


def phase_serve(profile: bool = False):
    """InferenceEngine over PagedLM at full Llama-2-7B width in bf16 answers
    8 requests; returns the flash kernel's launch count on that path."""
    import contextlib
    import random
    import statistics
    import threading

    import torch

    from ray_tpu_torch.models.transformer import llama2_7b
    from ray_tpu_torch.ops.flash_attention import flash_fwd
    from ray_tpu_torch.serve.llm import EngineConfig, InferenceEngine, PagedLM

    t0 = time.perf_counter()
    lm = PagedLM(llama2_7b(dtype=torch.bfloat16), seed=0, device="cuda", num_pages=256,
                 page_tokens=16, max_slots=8, max_pages_per_seq=64)
    torch.cuda.synchronize()
    print(f"[serve] llama2_7b bf16 random weights from seed 0 on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    n_new = 32
    prefill_ms, decode_ms = [], []
    lm.prefill = _timed(lm.prefill, prefill_ms)
    lm.decode = _timed(lm.decode, decode_ms)
    eng = InferenceEngine(lm, EngineConfig(page_tokens=16, pool_pages=256, max_new_tokens=n_new),
                          name="chip-smoke")
    try:
        list(eng.generate([1, 2, 3, 4], 2))  # warm-up: cuBLAS handles, first launches
        rng = random.Random(0)

        def toks(n):
            return [rng.randrange(1, 32000) for _ in range(n)]

        prefix = toks(256)
        prompts = [prefix + toks(24)] + [toks(n) for n in (700, 20, 310, 96, 450, 64)]
        prompts.append(prefix + toks(40))  # submitted once the first has committed its pages
        events = [[] for _ in prompts]
        done = [threading.Event() for _ in prompts]

        def sink_for(i):
            def sink(ev, val):
                events[i].append((time.perf_counter(), ev, val))
                if ev != "tok":
                    done[i].set()
            return sink

        torch.cuda.reset_peak_memory_stats()
        del prefill_ms[:], decode_ms[:]
        prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                   torch.profiler.ProfilerActivity.CUDA])
                if profile else contextlib.nullcontext())
        with prof:
            t_window = time.perf_counter()
            flash_fwd.launches = 0
            t_submit = {}
            for i in range(7):
                t_submit[i] = time.perf_counter()
                eng.submit(prompts[i], n_new, sink=sink_for(i))
            deadline = time.monotonic() + 300
            while not any(ev == "tok" for _, ev, _ in events[0]):
                if time.monotonic() > deadline or done[0].is_set():
                    _fail(f"first request produced no token: {events[0]}")
                time.sleep(0.005)
            t_submit[7] = time.perf_counter()
            eng.submit(prompts[7], n_new, sink=sink_for(7))
            for i, d in enumerate(done):
                if not d.wait(timeout=max(1.0, deadline - time.monotonic())):
                    _fail(f"request {i} did not finish")
            launches = flash_fwd.launches
            torch.cuda.synchronize()
            t_window = time.perf_counter() - t_window
        stats = eng.stats()
    finally:
        eng.close()
    if profile:
        _print_profile(prof, t_window)
    ttft, first_tok, last_tok, n_decode = [], [], [], 0
    for i, evs in enumerate(events):
        out = [v for _, ev, v in evs if ev == "tok"]
        end = [(ev, v) for _, ev, v in evs if ev != "tok"]
        if end != [("done", "stop")] or len(out) != n_new:
            _fail(f"request {i} ended {end} after {len(out)} tokens")
        if not all(0 <= t < lm.vocab for t in out):
            _fail(f"request {i} produced out-of-vocabulary tokens")
        tok_times = [t for t, ev, _ in evs if ev == "tok"]
        ttft.append((tok_times[0] - t_submit[i]) * 1e3)
        first_tok.append(tok_times[0])
        last_tok.append(tok_times[-1])
        n_decode += len(out) - 1
    ttft.sort()
    p50 = (ttft[3] + ttft[4]) / 2
    decode_tps = n_decode / (max(last_tok) - min(first_tok))
    hits = stats["kv"]["prefix_hits"]
    n_prefills = len(prompts)
    print(f"[serve] 8 requests, prompts {[len(p) for p in prompts]}, {n_new} new tokens each: "
          f"TTFT p50 {p50:.1f} ms (min {ttft[0]:.1f}, max {ttft[-1]:.1f}); decode {decode_tps:.1f} "
          f"tok/s over {stats['decode_steps']} steps; prefix hits {hits} pages; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"flash_fwd launches {launches}", flush=True)
    print(f"[serve] prefill ms per call {[round(t, 1) for t in prefill_ms]} (buckets s="
          f"{[lm._bucket_pages(-(-len(p) // 16)) * 16 for p in prompts]}); decode step ms "
          f"p50 {statistics.median(decode_ms):.1f} (min {min(decode_ms):.1f}, max "
          f"{max(decode_ms):.1f}, {len(decode_ms)} steps)", flush=True)
    if hits < 256 // 16:
        _fail(f"shared 256-token prefix missed the radix cache ({hits} page hits)")
    if launches < lm.cfg.n_layers * n_prefills:
        _fail(f"flash_fwd launched {launches} times, want >= {lm.cfg.n_layers} x {n_prefills}")
    return launches


def main() -> int:
    import argparse

    import ray_tpu_torch  # noqa: F401  (fails at once outside a checkout)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve phase with torch.profiler and print device time by kernel")
    args = ap.parse_args()

    name = phase_device()
    phase_build()
    flash_row = phase_kernel()
    phase_paged()
    flash_row["launches"] = phase_serve(profile=args.profile)
    print(json.dumps({"kernels": [flash_row]}), flush=True)
    import torch

    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
