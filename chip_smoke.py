"""Runs the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases, each printing its own line, any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel from ray_tpu_torch/ops/csrc/ and prints
     each kernel's registers and spills as ptxas reports them;
  3. kernel: each kernel (flash forward, and the backward's dq and dk/dv)
     against its plain PyTorch version on the card, with its time, the plain
     version's, one PyTorch library call's and the bound; at the train shape
     in bf16 the backward must also repeat bit for bit, and one pass through
     flash_attention(...).backward must give the same gradients;
  4. paged: PagedLM prefill+decode against the port's full forward, Llama-2-7B
     width, 2 layers, float32: greedy tokens must be equal;
  5. serve: InferenceEngine over PagedLM at full Llama-2-7B width in bf16
     (random weights from a seed) answers 8 requests; the flash kernel's
     launch count on that path is checked;
  6. train-parity: 3 AdamW steps at Llama-2-7B width, 2 layers, float32,
     through the kernels and through plain autograd from the same params:
     the first step's gradients and every step's loss must agree;
  7. train: 6 AdamW steps of Llama-2-7B at full width, 8 layers, bf16, on a
     2 x 2048-token batch: a finite, falling loss, step time, tokens/s, MFU,
     peak memory, and each kernel's launch count on that path.
Then one JSON line with every kernel's numbers, and the device line last.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import json
import math
import re
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


def _bound_ms(flops, nbytes, dtype_name):
    """The larger of FLOPs over the peak for their type and bytes over HBM
    bandwidth, and which of the two it is."""
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_bound_ms(kernel, b, s, h, h_kv, d, dtype_name, causal):
    """Least time for one flash kernel on the unmasked (q, k) pairs, each
    input read once and each output written once:
      fwd: QK^T, PV; reads q, k, v, writes o and lse (fp32);
      dq:  QK^T, dO.V^T, dS.K; reads q, do, k, v, lse, delta, writes dq;
      dkv: QK^T, dO.V^T, P^T.dO, dS^T.Q; reads q, do, k, v, lse, delta,
           writes dk and dv."""
    pairs = s * (s + 1) // 2 if causal else s * s
    es = 2 if dtype_name == "bfloat16" else 4
    q_size, kv_size, row = b * s * h * d, b * s * h_kv * d, b * h * s
    products, nbytes = {
        "fwd": (2, es * (2 * q_size + 2 * kv_size) + 4 * row),
        "dq": (3, es * (3 * q_size + 2 * kv_size) + 8 * row),
        "dkv": (4, es * (2 * q_size + 4 * kv_size) + 8 * row),
    }[kernel]
    return _bound_ms(products * 2 * b * h * pairs * d, nbytes, dtype_name)


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


def ptxas_kernels(report: str):
    """[(kernel, registers, spill bytes)] from nvcc's -Xptxas -v report, each
    kernel named from its mangled name as `name<type, head_dim>` where the
    name carries template arguments."""
    rows, name, spill = [], None, 0
    for ln in report.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", ln):
            name, spill = m.group(1), 0
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", ln)) and name:
            # a length-prefixed identifier, then I<type>?Li<head_dim>E
            if t := re.search(r"\d(flash_[A-Za-z_]+?)I(13__nv_bfloat16|f)?Li(\d+)E", name):
                dtype = {"13__nv_bfloat16": "bf16, ", "f": "f32, "}.get(t.group(2), "")
                name = f"{t.group(1)}<{dtype}{t.group(3)}>"
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


def phase_build():
    from ray_tpu_torch.ops import _build

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    _build.build(names)
    dt = time.perf_counter() - t0
    for n in names:
        _build.load(n)
        kernels = ptxas_kernels(_build.ptxas_reports.get(n, ""))
        print(f"[build] {n}.cu ptxas: " + (" | ".join(
            f"{k} {regs} regs {spill} B spilled" for k, regs, spill in kernels) or "cached"),
            flush=True)
    print(f"[build] kernels {names} built in {dt:.1f} s", flush=True)


def _check_fwd():
    """Flash forward kernel against reference_attention_with_lse on the card."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash_attention import flash_fwd, reference_attention_with_lse

    tol = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-2)}  # (o, lse)
    # (b, s, h, h_kv, d, dtype, causal); s=1024 is the serve phase's largest
    # prefill bucket, the shape reported in the JSON line; b=2, s=2048 is the
    # train phase's.
    cases = [(1, s, 32, 32, 128, torch.bfloat16, True) for s in (16, 128, 512, 1024, 2048)]
    cases += [(2, 2048, 32, 32, 128, torch.bfloat16, True),
              (2, 256, 8, 2, 128, torch.bfloat16, True), (1, 300, 8, 8, 64, torch.float32, False),
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
        bound, by = flash_bound_ms("fwd", b, s, h, h_kv, d, name, causal)
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


# The backward kernels' check: each entry of dq, dk and dv is held to
# tol x (|ref| + rms(ref)), ref the plain version's result. That is relative
# where an entry is large, with a floor at the tensor's typical magnitude
# where it is near 0: a causal row's dq shrinks as its row grows, and row 0's
# is 0 up to rounding. bf16: 2**-6 (four bf16 ulps); at the train shape the
# tensor-core kernels read at most 0.0113 over three seeds (the outputs round
# to bf16, and a P or dS near a rounding boundary rounds one ulp apart; the
# plain version itself reads up to 0.0112 against a float64 one), one 64-row
# tile of one head scaled by 0.9 reads 0.06-0.08. fp32: 1e-4, where the
# readings are at most 6e-6 (sums in another order).
BWD_TOL = {"float32": 1e-4, "bfloat16": 2 ** -6}


def bwd_err(got, want) -> float:
    """max over entries of |got - want| / (|want| + rms(want))."""
    g, w = got.float(), want.float()
    return ((g - w).abs() / (w.abs() + w.pow(2).mean().sqrt())).max().item()


def _planted_faults(t):
    """Wrong versions of a [b, s, h, d] gradient that the check must refuse:
    every row past the first 64-row tile halved, and one 64-row tile of one
    head scaled by 0.9."""
    halved, tile = t.clone(), t.clone()
    halved[:, 64:] *= 0.5
    tile[:, 1024:1088, 5] *= 0.9
    return {"x0.5 past row 64": halved, "x0.9 on rows 1024-1087 of head 5": tile}


def _check_bwd():
    """The backward kernels (flash_bwd_dq, flash_bwd_dkv) against their plain
    versions on the card; times at the train phase's shape."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    bf, f32 = torch.bfloat16, torch.float32
    # (b, s, h, h_kv, d, dtype, causal): the train phase's shape first (the
    # one reported) and again in fp32, then every head_dim in both dtypes,
    # causal or not, GQA and MQA, and lengths that are not a multiple of the
    # 64-row tile.
    cases = [(2, 2048, 32, 32, 128, bf, True), (2, 2048, 32, 32, 128, f32, True),
             (1, 1000, 8, 4, 128, bf, False), (1, 256, 4, 2, 128, f32, True),
             (1, 300, 8, 8, 64, bf, False), (1, 200, 8, 2, 64, f32, True),
             (1, 96, 4, 4, 32, bf, True), (1, 130, 2, 2, 32, f32, False),
             (1, 40, 4, 2, 16, bf, True), (2, 128, 4, 1, 16, f32, False)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for b, s, h, h_kv, d, dt, causal in cases:
        q, k, v, do = (torch.randn((b, s, hh, d), generator=gen, device="cuda").to(dt)
                       for hh in (h, h_kv, h_kv, h))
        scale = d ** -0.5
        o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=scale)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, lse, do, delta)
        kw = dict(causal=causal, scale=scale)
        got = {"dq": (fa.flash_bwd_dq(*args, **kw),), "dkv": fa.flash_bwd_dkv(*args, **kw)}
        torch.cuda.synchronize()
        want = {"dq": (fa.reference_flash_bwd_dq(*args, **kw),),
                "dkv": fa.reference_flash_bwd_dkv(*args, **kw)}
        name = str(dt).replace("torch.", "")
        tol = BWD_TOL[name]
        where = f"b={b} s={s} h={h} h_kv={h_kv} d={d} {name} causal={causal}"
        errs, planted = {}, {}
        for kern in ("dq", "dkv"):
            for label, g, w in zip(("dq",) if kern == "dq" else ("dk", "dv"), got[kern],
                                   want[kern]):
                err = bwd_err(g, w)
                errs[label] = (err, (g.float() - w.float()).abs().max().item())
                if not (math.isfinite(err) and err <= tol):
                    _fail(f"flash_bwd {label} disagrees with its plain version at {where}: "
                          f"{err:.3g} (tol {tol})")
                if s >= 1088 and h > 5:
                    for fault, bad in _planted_faults(g).items():
                        planted[f"{label} {fault}"] = bwd_err(bad, w)
        print(f"[kernel] flash_bwd {where}: max |err| / (|ref| + rms(ref)) "
              + "; ".join(f"{lb} {e:.3g} (max abs {a:.3g})" for lb, (e, a) in errs.items())
              + f"; tol {tol}", flush=True)
        if planted:
            print(f"[kernel] flash_bwd {where}: planted faults read "
                  + "; ".join(f"{f} {e:.3g}" for f, e in planted.items()), flush=True)
            if min(planted.values()) <= tol:
                _fail(f"the backward check passes a planted fault at {where}: {planted}")
        if rows:
            continue
        # The train phase's shape: no atomics, so a second launch repeats the
        # first bit for bit; the autograd path reaches the same kernels.
        again = (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args, **kw))
        torch.cuda.synchronize()
        same = [torch.equal(x, y) for x, y in zip((*got["dq"], *got["dkv"]), again)]
        print(f"[kernel] flash_bwd {where}: a second launch equals the first bit for bit: "
              f"dq {same[0]}, dk {same[1]}, dv {same[2]}", flush=True)
        if not all(same):
            _fail(f"flash_bwd is not deterministic at {where}")
        del again
        _check_autograd_bwd(q, k, v, do, want, causal, scale, tol, where)
        # Times. SDPA's backward (its fwd+bwd less its fwd) computes dq, dk
        # and dv together: one number for both rows, and for the pair.
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, scale=scale,
                                                  enable_gqa=h != h_kv)

        lib_ms = (_time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot), iters=10)
                  - _time_ms(sdpa, iters=10))
        for kern, fn, plain in (("dq", fa.flash_bwd_dq, fa.reference_flash_bwd_dq),
                                ("dkv", fa.flash_bwd_dkv, fa.reference_flash_bwd_dkv)):
            ms = _time_ms(lambda: fn(*args, **kw), iters=10)
            plain_ms = _time_ms(lambda: plain(*args, **kw), iters=3, warmup=1)
            bound, by = flash_bound_ms(kern, b, s, h, h_kv, d, name, causal)
            labels = ("dq",) if kern == "dq" else ("dk", "dv")
            print(f"[kernel] flash_bwd_{kern} b={b} s={s} h={h} h_kv={h_kv} d={d} {name} "
                  f"causal={causal}: ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
                  f"(SDPA backward: dq, dk and dv together) bound_ms {bound:.4f} ({by})",
                  flush=True)
            rows[kern] = {
                "name": f"flash_bwd_{kern}", "route": "cuda",
                "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
                "replaces": ("ray_tpu/ops/flash_attention.py:104" if kern == "dq"
                             else "ray_tpu/ops/flash_attention.py:133"),
                "launches": None, "max_abs_err": max(errs[lb][1] for lb in labels), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            }
        pair_ms = _time_ms(lambda: (fa.flash_bwd_dq(*args, **kw), fa.flash_bwd_dkv(*args, **kw)),
                           iters=10)
        print(f"[kernel] flash_bwd pair (dq + dkv) b={b} s={s} h={h} h_kv={h_kv} d={d} {name} "
              f"causal={causal}: ms {pair_ms:.4f}; SDPA backward {lib_ms:.4f} ms; ratio "
              f"{pair_ms / lib_ms:.2f}", flush=True)
    return rows


def _check_autograd_bwd(q, k, v, do, want, causal, scale, tol, where):
    """One pass through flash_attention(...).backward(do): q, k and v's .grad
    against the plain versions' gradients `want`, entry by entry, and one
    launch of each backward kernel."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    before = _launch_counts()
    fa.flash_attention(*leaves, causal=causal, scale=scale).backward(do)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in _launch_counts().items()}
    errs = {label: bwd_err(x.grad, w)
            for label, x, w in zip(("dq", "dk", "dv"), leaves, (*want["dq"], *want["dkv"]))}
    print(f"[kernel] flash_attention(...).backward {where}: max |err| / (|ref| + rms(ref)) "
          + "; ".join(f"{lb} {e:.3g}" for lb, e in errs.items())
          + f"; tol {tol}; launches {launched}", flush=True)
    if not all(math.isfinite(e) and e <= tol for e in errs.values()):
        _fail(f"the autograd backward disagrees with the plain versions at {where}: {errs}")
    if launched != {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}:
        _fail(f"the autograd backward launched {launched}, want one of each kernel")


def phase_kernel():
    """Every kernel against its plain version on the card; returns the JSON
    rows of flash_fwd (serve shape), flash_bwd_dq and flash_bwd_dkv (train
    shape), launches still to fill in."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fwd_row = _check_fwd()
    bwd_rows = _check_bwd()
    torch.cuda.empty_cache()
    return fwd_row, bwd_rows["dq"], bwd_rows["dkv"]


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


# CUPTI's overhead records (host-side waits such as a full launch queue),
# which the profiler lists beside kernels: they are not device work.
_CUPTI_OVERHEAD = {"Unknown", "Buffer Flush", "Instrumentation", "Resource",
                   "Runtime Triggered Module Loading", "Lazy Function Loading",
                   "Command Buffer Full", "Activity Buffer Request", "UVM Activity Init"}


def _print_profile(prof, wall_s, phase):
    """Device time by kernel over a phase's traced window, and the device's
    busy share of that window (one stream, so kernel times do not overlap).
    Only kernels count: the profiler also credits each CPU op of the tracing
    thread, and each user annotation such as Optimizer.step, with the
    kernels it launched."""
    import torch

    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in _CUPTI_OVERHEAD
            and not e.is_user_annotation and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"[profile {phase}] device busy {busy_us / 1e3:.1f} ms of {wall_s * 1e3:.1f} ms wall "
          f"({100 * busy_us / 1e3 / (wall_s * 1e3):.1f}%)", flush=True)
    groups = {"flash kernels": ("flash_",), "cuBLAS": ("nvjet", "gemm", "gemv", "cutlass")}
    sums = dict.fromkeys([*groups, "other"], 0.0)
    for e in rows:
        group = next((g for g, marks in groups.items() if any(m in e.key for m in marks)), "other")
        sums[group] += e.self_device_time_total / 1e3
    print(f"[profile {phase}] by kind: " + ", ".join(f"{g} {ms:.1f} ms" for g, ms in sums.items()),
          flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"[profile {phase}] {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d} x  {e.key[:90]}",
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
            _zero_launch_counts()
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
            launches = _launch_counts()["flash_fwd"]
            torch.cuda.synchronize()
            t_window = time.perf_counter() - t_window
        stats = eng.stats()
    finally:
        eng.close()
    if profile:
        _print_profile(prof, t_window, "serve")
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


def _launch_counts():
    from ray_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.flash_fwd.launches, "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def _zero_launch_counts():
    from ray_tpu_torch.ops import flash_attention as fa

    fa.flash_fwd.launches = fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0


def _named_leaves(tree, prefix=""):
    """[(path, tensor)] of a param tree, e.g. ("blocks/attn/wq", t)."""
    if isinstance(tree, dict):
        return [leaf for key, sub in tree.items()
                for leaf in _named_leaves(sub, f"{prefix}{key}/")]
    return [(prefix.rstrip("/"), tree)]


def phase_train_parity():
    """3 AdamW steps at Llama-2-7B width, 2 layers, float32 with TF32 off,
    b=1, s=256, through the kernels (attn_impl="full") and through plain
    autograd over attention_reference ("naive"), from the same params and
    tokens. The first step's gradient of every leaf agrees within 1e-5 of
    that leaf's norm (readings at most 2.6e-6: fp32 sums in another order);
    Adam's updates hide a gradient off by a factor, so the losses alone do
    not show one. Losses agree within 5e-5 relative at every step: Adam
    carries the gradients' rounding into the next steps."""
    import torch

    from ray_tpu_torch.models import transformer as tfm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rtol, grad_rtol, n_layers, n_steps = 5e-5, 1e-5, 2, 3
    tokens = torch.randint(0, 32000, (1, 256), generator=torch.Generator().manual_seed(3))
    losses, launches, grads = {}, {}, {}
    for impl in ("full", "naive"):
        cfg = tfm.llama2_7b(n_layers=n_layers, dtype=torch.float32, attn_impl=impl)
        init, step = tfm.build_train_step(cfg, tfm.adamw(1e-4), device="cuda")
        params, opt = init(torch.Generator(device="cuda").manual_seed(2))
        _zero_launch_counts()
        losses[impl] = [step(params, opt, tokens).item()]
        # step leaves each leaf's gradient in .grad until the next step
        grads[impl] = {name: t.grad.clone() for name, t in _named_leaves(params)}
        losses[impl] += [step(params, opt, tokens).item() for _ in range(n_steps - 1)]
        launches[impl] = _launch_counts()
        del params, opt
        torch.cuda.empty_cache()
    grad_diff = {name: ((g - grads["naive"][name]).norm() / grads["naive"][name].norm()).item()
                 for name, g in grads["full"].items()}
    del grads
    torch.cuda.empty_cache()
    diff = max(abs(a - b) / abs(b) for a, b in zip(losses["full"], losses["naive"]))
    print(f"[train-parity] llama2_7b width, 2 layers, fp32, b=1 s=256, adamw(1e-4), remat dots: "
          f"losses kernels {[round(x, 6) for x in losses['full']]} plain "
          f"{[round(x, 6) for x in losses['naive']]}; max rel diff {diff:.3g} (tol {rtol}); "
          f"launches kernels {launches['full']} plain {launches['naive']}", flush=True)
    print("[train-parity] first-step gradient, |kernels - plain| / |plain| per leaf: "
          + ", ".join(f"{n} {e:.3g}" for n, e in grad_diff.items()) + f" (tol {grad_rtol})",
          flush=True)
    if not all(math.isfinite(x) for x in losses["full"] + losses["naive"]) or diff > rtol:
        _fail("train-parity: the kernels' losses disagree with plain autograd")
    if not all(e <= grad_rtol for e in grad_diff.values()):
        _fail("train-parity: the kernels' first-step gradients disagree with plain autograd")
    # remat runs each layer's forward (its flash kernel too) again in the backward.
    want = {"flash_fwd": 2 * n_layers * n_steps, "flash_bwd_dq": n_layers * n_steps,
            "flash_bwd_dkv": n_layers * n_steps}
    if launches["full"] != want or any(launches["naive"].values()):
        _fail(f"train-parity launches {launches}, want {want} through the kernels")


def phase_train(profile: bool = False):
    """6 AdamW steps of llama2_7b(n_layers=8) in bf16, remat "dots", on one
    fixed batch of 2 x 2048 random tokens; returns each kernel's launches."""
    import gc
    import statistics

    import torch

    from ray_tpu_torch.models import transformer as tfm

    cfg = tfm.llama2_7b(n_layers=8, dtype=torch.bfloat16)
    b, s, n_steps = 2, 2048, 6
    init, step = tfm.build_train_step(cfg, tfm.adamw(1e-4), device="cuda")
    gc.collect()  # what earlier phases left in reference cycles
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params, opt = init(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    n_params = tfm.param_count(params)
    print(f"[train] llama2_7b width, {cfg.n_layers} layers ({n_params / 1e9:.3f} B params), bf16, "
          f"random weights from seed 0 on the card in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    losses, step_ms = [], []
    for _ in range(n_steps):
        t = time.perf_counter()
        losses.append(step(params, opt, tokens).item())  # .item() waits for the device
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    p50 = statistics.median(step_ms[1:])
    tok_s = b * s / (p50 / 1e3)
    mfu = tfm.flops_per_token(cfg, s) * tok_s / PEAK_FLOPS["bfloat16"]
    print(f"[train] {n_steps} steps of adamw(1e-4) on {b} x {s} tokens, remat dots: losses "
          f"{[round(x, 4) for x in losses]}; step ms {[round(t, 1) for t in step_ms]}, p50 over "
          f"steps 2-{n_steps} {p50:.1f}; {tok_s:.0f} tokens/s; MFU {100 * mfu:.2f}% (against "
          f"the H100 bf16 dense peak, 989 TFLOP/s); max_memory_allocated {peak / 2**30:.2f} GiB "
          f"({held / 2**30:.2f} GiB held before the phase); launches {launches}", flush=True)
    if profile:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        with prof:
            t = time.perf_counter()
            step(params, opt, tokens).item()
            wall = time.perf_counter() - t
        _print_profile(prof, wall, "train")
    del params, opt
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses):
        _fail(f"train: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        _fail(f"train: the loss did not fall: {losses}")
    for kern in ("flash_bwd_dq", "flash_bwd_dkv"):
        if launches[kern] < cfg.n_layers * n_steps:
            _fail(f"train: {kern} launched {launches[kern]} times, want >= "
                  f"{cfg.n_layers} x {n_steps}")
    # remat runs each layer's forward, the flash kernel included, again in the backward.
    if launches["flash_fwd"] < 2 * cfg.n_layers * n_steps:
        _fail(f"train: flash_fwd launched {launches['flash_fwd']} times, want >= "
              f"2 x {cfg.n_layers} x {n_steps}")
    return launches


def main() -> int:
    import argparse

    import ray_tpu_torch  # noqa: F401  (fails at once outside a checkout)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve phase and one more train step with torch.profiler "
                         "and print device time by kernel")
    args = ap.parse_args()

    name = phase_device()
    phase_build()
    fwd_row, dq_row, dkv_row = phase_kernel()
    phase_paged()
    fwd_row["launches"] = phase_serve(profile=args.profile)
    phase_train_parity()
    train_launches = phase_train(profile=args.profile)
    dq_row["launches"] = train_launches["flash_bwd_dq"]
    dkv_row["launches"] = train_launches["flash_bwd_dkv"]
    print(json.dumps({"kernels": [fwd_row, dq_row, dkv_row]}), flush=True)
    import torch

    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
