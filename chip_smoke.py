"""Runs the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases, each printing its own line, any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel from ray_tpu_torch/ops/csrc/ and prints
     each kernel's registers and spills as ptxas reports them;
  3. kernel: each kernel (flash forward, and the backward's dq and dk/dv)
     against its plain PyTorch version on the card, bf16 outputs entry by
     entry, with its time, the plain version's, one PyTorch library call's
     and the bound; at the train shape in bf16 each check must refuse two
     planted faults, each kernel must repeat bit for bit, and one pass
     through flash_attention_with_lse (forward) and
     flash_attention(...).backward must give the same results; the same at
     GPT-J's shape (b=1, s=2048, 16 heads of 256, causal) in bf16 and fp32,
     and in fp32 with batch x heads = 65600; at the train shape the backward
     kernels also take the lse variant (a dlse != 0 from merging the block
     with a seeded second one by their lse, as ring attention does),
     directly and through flash_attention_with_lse's backward, planted
     faults refused;
  4. paged: PagedLM prefill+decode against the port's full forward, Llama-2-7B
     width, 2 layers, float32: greedy tokens must be equal;
  5. gptj: gpt_j_6b(n_layers=2) at full width (head_dim 256), bf16: a paged
     prefill and decode, then 3 AdamW steps under remat "hot"; all three
     kernels must launch at head_dim 256 and the loss fall;
  6. serve: InferenceEngine over PagedLM at full Llama-2-7B width in bf16
     (random weights from a seed) answers 8 requests; the flash kernel's
     launch count on that path is checked;
  7. deploy: the same model at full width and depth as a Serve deployment
     (llm_deployment on init(local_mode=True)): 8 requests through the
     streaming handle and 8 through LLMClient's feed at once must give the
     greedy tokens of InferenceEngine driven directly, and a handle close()
     must free its request's pages within one decode step; TTFT and
     decode tokens/s of handle, feed and direct engine; then the same on
     init() with the replica an actor in a worker process leased GPU 0
     (num_gpus=1): the same gates, flash_fwd's launches (>= 32 x 16, the
     backward kernels 0) read in the replica's process, its pid,
     CUDA_VISIBLE_DEVICES and start-up time, no process or pool left;
  8. train-parity: 3 AdamW steps at Llama-2-7B width, 2 layers, float32,
     through the kernels and through plain autograd from the same params,
     under remat "dots" and "hot": the first step's gradients and every
     step's loss must agree, and the flash forward runs 2 (dots) or 1 (hot)
     times per layer per step;
  9. train: 6 AdamW steps of Llama-2-7B at full width, 8 layers, bf16, on a
     2 x 2048-token batch, under remat "hot", "dots" and "attn": a finite,
     falling loss, step time, tokens/s, MFU, peak memory, and each kernel's
     launch count on that path;
  10. zero: ZeRO-1 (train/zero.py) over a NCCL group of one rank against the
     plain step, 2 layers, bf16: losses and params bitwise equal after 3
     steps; each optimizer state's bytes;
  11. checkpoint: 3 steps, an elastic checkpoint at world 1 resharded to 4 on
     disk, restored into a fresh run, 3 more steps: bitwise equal to 6
     uninterrupted steps; then an HF safetensors export and reload, bitwise,
     with the same greedy tokens from PagedLM;
  12. fit: the zero phase's configuration trained through TorchTrainer.fit
     on init(local_mode=True), 8 steps with an elastic checkpoint reported
     at step 3, uninterrupted (A) and with a failure after step 5 and a
     restart from that checkpoint (B): the resumed run equals the
     uninterrupted one and build_train_step driven directly, bit for bit;
     keep-1 checkpoints, goodput, MFU and each kernel's launches; the
     trainer's step p50 against the plain step's, driven from the main
     thread and, as a control, from a plain thread with no runtime
     (--profile traces one step of each);
  13. tune: Tuner over that TorchTrainer, two lrs trained at once on the
     card: each trial bitwise equal to a direct run, the best trial named,
     each kernel's launches;
  14. parallel: (a) next_token_loss with attn_impl "ring" and "ulysses" on a
     DeviceMesh with seq=1 over a NCCL group of one rank against "full"
     (llama2_7b(n_layers=2), bf16, "hot", b=1, s=2048): loss and every
     leaf's gradient, bitwise or not; and moe_apply at Switch-Base's width
     over that world against no mesh, bitwise; (b) 4 processes of this script
     sharing the card over gloo (collectives staged through host memory;
     their times are not multi-GPU speed): ring_attention and
     ulysses_attention at Llama-2-7B's attention width (32 heads of 128,
     bf16, causal, global s=8192) against one flash_attention call, output
     and dq/dk/dv, with each call's launches across ranks; then in fp32 the
     model's ring and Ulysses over seq=4 and next_token_loss_pipelined over
     stage=4 (4 layers, 4 microbatches) against the unsplit model: loss,
     every leaf's gradient and launches; (c) tensor parallelism at
     llama2_7b(n_layers=2)'s full width on params from shard_tree, tensor=4
     and fsdp=2 x tensor=2: in fp32 the first step's loss and every rank's
     gradient shard of every leaf against the unsplit model, then 3 AdamW
     steps' losses; TP x SP (tensor=2 x seq=2, ring and Ulysses); in bf16
     one forward and backward with each kernel's launches; (d) the Switch
     MoE at Switch-Base's expert width (768 / 3072, 128 experts, capacity
     factor 1.25, 8192 tokens) over expert=4 against the unsplit layer:
     y, x's gradient, the aux loss and every param's gradient shard, with
     the tokens dropped; peak memory per rank;
  15. cluster: the cluster runtime (init() with no arguments: a GCS, a
     raylet, its zygote and worker processes forked from it): (a)
     cluster_resources()["GPU"] from the GPU manager; the time until the
     zygote parks a child; a num_gpus=1 task on a parked child sees
     CUDA_VISIBLE_DEVICES="0" and the card, is the zygote's child and not in
     a bad fork, and its latency; the zygote is no compute process of the
     card and never initialised CUDA; two num_gpus=0.5 tasks held at once by a barrier actor share
     device 0; a bf16 4096 x 11008 CUDA tensor through put, get and a GPU
     task and back, bitwise, twice (GB/s); flash_attention at the serve
     shape in an actor's process against its plain version; no-op tasks and
     calls to one actor per second; (b) TorchTrainer with one worker process
     over NCCL, the fit phase's model, 4 steps: losses and params_sha256
     bitwise equal to the in-process trainer's and build_train_step's,
     launches 8 / 8 / 8 in the worker, step p50 beside the in-process
     trainer's; (c) two worker processes sharing the card over gloo,
     MeshSpec(data=2), fp32: 3 AdamW steps against one process (first loss
     1e-6, trajectory 1e-5, every leaf 1e-5 of its norm), then ZeRO-1 over
     "data" against the plain two-rank run; no process and no
     /dev/shm/rtpt_* pool left after shutdown; (d) a head on
     tcp://127.0.0.1:0 with an auth token and a worker node joined by
     start_worker_node, this process a remote client (init(address=)): the
     bf16 tensor through its put, a num_gpus=1 task on the joined node and
     its get, bitwise; a connection without the token refused;
  16. elastic: node drain and preemption on a fresh init() whose head leases
     GPU 0, nodes added (Cluster.add_node(num_gpus=1)) and removed, notices
     through the GCS's report_preemption: (a) TorchTrainer with one NCCL
     worker on an added node, the fit phase's model, an elastic checkpoint
     every 2 steps and one more on train.drain_requested(),
     max_failures=0: preempted after its second checkpoint (removed at a
     20 s deadline, a replacement node added), restored in a new process
     on the replacement; losses and params_sha256 bitwise equal to
     build_train_step driven directly, every step once, drain-wait time,
     no process of the removed node left, K1-K3 in both processes; notice
     to drain seen, checkpoint landed, restore done and first fresh step;
     (b) two gloo ranks on two added nodes, elastic (min_workers=1,
     capacity_wait_s=3), fp32 as cluster part (c) but 1 layer, 5 steps with
     a checkpoint after each but the last: one node preempted after the
     first with no replacement (world 1, the whole global batch), a node
     added once the first step at world 1 is checkpointed (world 2 again at
     the next checkpoint, two steps at world 1 on):
     worlds 2..1..2, each step once, one downsize and one growback,
     degraded time, losses and final params within part (c)'s tolerance of
     one process, K1-K3 at every world; (c) a num_gpus=0.5 deployment running flash_attention at
     the serve shape per request, its node given a 60 s notice while a
     client calls all along: a new replica on another node, no failed
     request, K1 in both replicas' processes; nothing left after shutdown.
Then one JSON line with every kernel's numbers (the backward kernels'
launches from the "hot" train run; each kernel's numbers at head_dim 256,
with the gptj phase's launches, under "at_d256"; its launches in the fit,
tune, parallel, cluster and elastic phases' model paths (ring, ulysses,
pipeline, the TP meshes and TP x SP; the deploy phase's cluster replica; the
cluster's actor, NCCL trainer worker and gloo ranks; the preempted and
restored workers, each elastic world, the old and new Serve replicas) under
"launches_by_path"), and the
device line last.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
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


# Per-entry checks: each entry of a kernel's output is held to
# tol x (|ref| + rms(ref)), ref the plain version's result. That is relative
# where an entry is large, with a floor at the tensor's typical magnitude
# where it is near 0: a causal row's dq shrinks as its row grows, and row 0's
# is 0 up to rounding. bf16: 2**-6 (four bf16 ulps). Backward: at the train
# shape the tensor-core kernels read at most 0.0113 over three seeds (the
# outputs round to bf16, and a P or dS near a rounding boundary rounds one
# ulp apart; the plain version itself reads up to 0.0112 against a float64
# one), one 64-row tile of one head scaled by 0.9 reads 0.06-0.08. fp32: 1e-4,
# where the readings are at most 6e-6 (sums in another order). The bf16
# forward's o is held the same way to 2**-6, its lse (fp32, the log of a sum
# of unrounded P) to 1e-3 absolute; the fp32 forward keeps max |err| 1e-4 for
# both.
BWD_TOL = {"float32": 1e-4, "bfloat16": 2 ** -6}
FWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2 ** -6, 1e-3)}  # (o, lse)


def entry_err(got, want, rms=None) -> float:
    """max over entries of |got - want| / (|want| + rms(want)); `rms` given
    where `want` is a part of a larger reference (the whole one's rms)."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean().sqrt() if rms is None else rms
    return ((g - w).abs() / (w.abs() + rms)).max().item()


def _planted_faults(t):
    """Wrong versions of a [b, s, h, d] kernel output that the check must
    refuse: every row past the first 64-row tile halved, and one 64-row tile
    of one head scaled by 0.9."""
    halved, tile = t.clone(), t.clone()
    halved[:, 64:] *= 0.5
    tile[:, 1024:1088, 5] *= 0.9
    return {"x0.5 past row 64": halved, "x0.9 on rows 1024-1087 of head 5": tile}


def _check_fwd():
    """The flash forward kernel against reference_flash_fwd (the plain
    version, rounding P where the Pallas kernel does) on the card; at the
    train shape in bf16 also planted faults, determinism and the autograd
    path."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    # (b, s, h, h_kv, d, dtype, causal); s=1024 is the serve phase's largest
    # prefill bucket, the shape reported in the JSON line; b=2, s=2048 is the
    # train phase's; h=16, d=256 GPT-J's (the gptj phase's train shape), in
    # both dtypes; b x h = 65600 puts more blocks on grid x than y could hold.
    cases = [(1, s, 32, 32, 128, torch.bfloat16, True) for s in (16, 128, 512, 1024, 2048)]
    cases += [(2, 2048, 32, 32, 128, torch.bfloat16, True),
              (2, 256, 8, 2, 128, torch.bfloat16, True), (1, 300, 8, 8, 64, torch.float32, False),
              (1, 40, 4, 2, 16, torch.float32, True),
              GPTJ_SHAPE + (torch.bfloat16, True), GPTJ_SHAPE + (torch.float32, True),
              (4100, 40, 16, 4, 16, torch.float32, True)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = None
    for b, s, h, h_kv, d, dt, causal in cases:
        q = torch.randn((b, s, h, d), generator=gen, device="cuda", dtype=torch.float32).to(dt)
        k = torch.randn((b, s, h_kv, d), generator=gen, device="cuda", dtype=torch.float32).to(dt)
        v = torch.randn((b, s, h_kv, d), generator=gen, device="cuda", dtype=torch.float32).to(dt)
        kw = dict(causal=causal, scale=d ** -0.5)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.reference_flash_fwd(q, k, v, **kw)
        name = str(dt).replace("torch.", "")
        where = f"b={b} s={s} h={h} h_kv={h_kv} d={d} {name} causal={causal}"
        max_abs = (o.float() - o_ref.float()).abs().max().item()
        bf16 = dt == torch.bfloat16
        err_o = entry_err(o, o_ref) if bf16 else max_abs
        err_l = (lse - lse_ref).abs().max().item()
        tol_o, tol_l = FWD_TOL[name]
        ok = math.isfinite(err_o) and err_o <= tol_o and err_l <= tol_l
        ms = _time_ms(lambda: fa.flash_fwd(q, k, v, **kw))
        plain_ms = _time_ms(lambda: fa.reference_flash_fwd(q, k, v, **kw), iters=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=kw["scale"], enable_gqa=h != h_kv))
        bound, by = flash_bound_ms("fwd", b, s, h, h_kv, d, name, causal)
        measure = "max |err| / (|ref| + rms(ref))" if bf16 else "max |err|"
        print(f"[kernel] flash_fwd {where}: o {measure} {err_o:.3g} (max abs {max_abs:.3g}; "
              f"tol {tol_o:.3g}) lse max |err| {err_l:.3g} (tol {tol_l}); ms {ms:.4f} "
              f"plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms {bound:.4f} ({by})",
              flush=True)
        if not ok:
            _fail(f"flash_fwd disagrees with its plain version at {where}")
        numbers = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": by, "library_ms": lib_ms}
        if (b, s, h, d, dt, causal) in ((2, 2048, 32, 128, torch.bfloat16, True),
                                        GPTJ_SHAPE[:3] + (256, torch.bfloat16, True)):
            _check_fwd_train_shape(q, k, v, o, lse, o_ref, kw, where)
            print(f"[kernel] flash_fwd at a train shape {where}: ms {ms:.4f}; SDPA forward "
                  f"{lib_ms:.4f} ms; ratio {ms / lib_ms:.2f}", flush=True)
        if (b, s, h, d, dt, causal) == (1, 1024, 32, 128, torch.bfloat16, True):
            report = {"name": "flash_fwd", "route": "cuda",
                      "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
                      "replaces": "ray_tpu/ops/flash_attention.py:64", "launches": None,
                      **numbers}
        if (b, s, h, h_kv, d, dt) == GPTJ_SHAPE + (torch.bfloat16,):
            d256 = {"shape": where, "launches": None, **numbers}
    report["at_d256"] = d256
    return report


def _check_fwd_train_shape(q, k, v, o, lse, o_ref, kw, where):
    """At the train shape in bf16: both planted faults in o are refused, a
    second launch repeats the first bit for bit, and one pass through
    flash_attention_with_lse (the autograd path) launches the kernel once and
    returns the same o and lse."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    tol = FWD_TOL["bfloat16"][0]
    planted = {f: entry_err(bad, o_ref) for f, bad in _planted_faults(o).items()}
    print(f"[kernel] flash_fwd {where}: planted faults in o read "
          + "; ".join(f"{f} {e:.3g}" for f, e in planted.items()) + f"; tol {tol:.3g}", flush=True)
    if min(planted.values()) <= tol:
        _fail(f"the forward check passes a planted fault at {where}: {planted}")
    o2, lse2 = fa.flash_fwd(q, k, v, **kw)
    before = _launch_counts()
    o3, lse3 = fa.flash_attention_with_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in _launch_counts().items()}
    same = {"second launch": torch.equal(o, o2) and torch.equal(lse, lse2),
            "flash_attention_with_lse": torch.equal(o, o3) and torch.equal(lse, lse3)}
    print(f"[kernel] flash_fwd {where}: o and lse equal the first launch's bit for bit: "
          + ", ".join(f"{n} {ok}" for n, ok in same.items()) + f"; launches {launched}",
          flush=True)
    if not all(same.values()):
        _fail(f"flash_fwd is not deterministic, or the autograd path differs, at {where}")
    if launched != {"flash_fwd": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}:
        _fail(f"flash_attention_with_lse launched {launched}, want one flash_fwd")


# GPT-J's attention at the gptj phase's train shape: (b, s, h, h_kv, d).
GPTJ_SHAPE = (1, 2048, 16, 16, 256)


def _check_bwd():
    """The backward kernels (flash_bwd_dq, flash_bwd_dkv) against their plain
    versions on the card; times at the train phase's shape and, under
    "at_d256", at GPT-J's."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    bf, f32 = torch.bfloat16, torch.float32
    # (b, s, h, h_kv, d, dtype, causal): the train phase's shape first (the
    # one reported) and again in fp32, then every head_dim in both dtypes,
    # causal or not, GQA and MQA, and lengths that are not a multiple of the
    # 64-row tile.
    # GPT-J's head_dim 256 in both dtypes, and b x h = 65600 on grid x.
    timed = {(2, 2048, 32, 32, 128, bf, True): "", GPTJ_SHAPE + (bf, True): "_d256"}
    cases = [(2, 2048, 32, 32, 128, bf, True), (2, 2048, 32, 32, 128, f32, True),
             (1, 1000, 8, 4, 128, bf, False), (1, 256, 4, 2, 128, f32, True),
             (1, 300, 8, 8, 64, bf, False), (1, 200, 8, 2, 64, f32, True),
             (1, 96, 4, 4, 32, bf, True), (1, 130, 2, 2, 32, f32, False),
             (1, 40, 4, 2, 16, bf, True), (2, 128, 4, 1, 16, f32, False),
             GPTJ_SHAPE + (bf, True), GPTJ_SHAPE + (f32, True), (4100, 40, 16, 4, 16, f32, True)]
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
                err = entry_err(g, w)
                errs[label] = (err, (g.float() - w.float()).abs().max().item())
                if not (math.isfinite(err) and err <= tol):
                    _fail(f"flash_bwd {label} disagrees with its plain version at {where}: "
                          f"{err:.3g} (tol {tol})")
                if s >= 1088 and h > 5:
                    for fault, bad in _planted_faults(g).items():
                        planted[f"{label} {fault}"] = entry_err(bad, w)
        print(f"[kernel] flash_bwd {where}: max |err| / (|ref| + rms(ref)) "
              + "; ".join(f"{lb} {e:.3g} (max abs {a:.3g})" for lb, (e, a) in errs.items())
              + f"; tol {tol}", flush=True)
        if planted:
            print(f"[kernel] flash_bwd {where}: planted faults read "
                  + "; ".join(f"{f} {e:.3g}" for f, e in planted.items()), flush=True)
            if min(planted.values()) <= tol:
                _fail(f"the backward check passes a planted fault at {where}: {planted}")
        if (b, s, h, h_kv, d, dt, causal) == GPTJ_SHAPE + (f32, True):
            # The FMA kernels at head_dim 256 (32-row tiles): times only.
            print(f"[kernel] flash_bwd {where}: " + "; ".join(
                f"{kern} ms {_time_ms(lambda fn=fn: fn(*args, **kw), iters=5):.4f} bound_ms "
                f"{flash_bound_ms(kern, b, s, h, h_kv, d, name, causal)[0]:.4f}"
                for kern, fn in (("dq", fa.flash_bwd_dq), ("dkv", fa.flash_bwd_dkv))), flush=True)
        suffix = timed.get((b, s, h, h_kv, d, dt, causal))
        if suffix is None:
            continue
        # The train phases' shapes: no atomics, so a second launch repeats
        # the first bit for bit; the autograd path reaches the same kernels.
        again = (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args, **kw))
        torch.cuda.synchronize()
        same = [torch.equal(x, y) for x, y in zip((*got["dq"], *got["dkv"]), again)]
        print(f"[kernel] flash_bwd {where}: a second launch equals the first bit for bit: "
              f"dq {same[0]}, dk {same[1]}, dv {same[2]}", flush=True)
        if not all(same):
            _fail(f"flash_bwd is not deterministic at {where}")
        del again
        _check_autograd_bwd(q, k, v, do, want, causal, scale, tol, where)
        if not suffix:
            _check_bwd_lse(q, k, v, o, lse, do, kw, tol, where)
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
            numbers = {"max_abs_err": max(errs[lb][1] for lb in labels), "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                       "library_ms": lib_ms}
            rows[kern + suffix] = (
                {"shape": where, "launches": None, **numbers} if suffix else
                {"name": f"flash_bwd_{kern}", "route": "cuda",
                 "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
                 "replaces": ("ray_tpu/ops/flash_attention.py:104" if kern == "dq"
                              else "ray_tpu/ops/flash_attention.py:133"),
                 "launches": None, **numbers})
        pair_ms = _time_ms(lambda: (fa.flash_bwd_dq(*args, **kw), fa.flash_bwd_dkv(*args, **kw)),
                           iters=10)
        print(f"[kernel] flash_bwd pair (dq + dkv) b={b} s={s} h={h} h_kv={h_kv} d={d} {name} "
              f"causal={causal}: ms {pair_ms:.4f}; SDPA backward {lib_ms:.4f} ms; ratio "
              f"{pair_ms / lib_ms:.2f}", flush=True)
    for kern in ("dq", "dkv"):
        rows[kern]["at_d256"] = rows.pop(kern + "_d256")
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
    errs = {label: entry_err(x.grad, w)
            for label, x, w in zip(("dq", "dk", "dv"), leaves, (*want["dq"], *want["dkv"]))}
    print(f"[kernel] flash_attention(...).backward {where}: max |err| / (|ref| + rms(ref)) "
          + "; ".join(f"{lb} {e:.3g}" for lb, e in errs.items())
          + f"; tol {tol}; launches {launched}", flush=True)
    if not all(math.isfinite(e) and e <= tol for e in errs.values()):
        _fail(f"the autograd backward disagrees with the plain versions at {where}: {errs}")
    if launched != {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}:
        _fail(f"the autograd backward launched {launched}, want one of each kernel")


def _merge_with_other_block(o, lse, o2, lse2):
    """Ring attention's merge of two blocks' normalised partials by their
    lse (ray_tpu_torch/parallel/ring_attention.py), in float32."""
    import torch

    lse_m = torch.logaddexp(lse, lse2)
    w1 = torch.exp(lse - lse_m).transpose(1, 2)[..., None]
    w2 = torch.exp(lse2 - lse_m).transpose(1, 2)[..., None]
    return o.float() * w1 + o2.float() * w2


def _check_bwd_lse(q, k, v, o, lse, do, kw, tol, where):
    """The lse variant of the backward, fed as ring attention feeds it: this
    block's (o, lse) merged by their lse with a second block's (the same
    queries over seeded keys before them), and
    the merge's backward from do gives this block's do (w1 * do) and a dlse
    != 0, so the kernels see delta = sum(do1 * o) - dlse.
    flash_bwd_dq and flash_bwd_dkv on those against their plain versions
    entry by entry, both planted faults refused; then one pass through
    flash_attention_with_lse and the same merge backward, one launch of
    each backward kernel."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    # the other block: the same queries over seeded keys and values before
    # them (non-causal), as the ring's blocks below the diagonal are
    gen = torch.Generator(device="cuda").manual_seed(9)
    k2, v2 = (torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype) for x in (k, v))
    o2, lse2 = fa.flash_fwd(q, k2, v2, causal=False, scale=kw["scale"])
    o_leaf, lse_leaf = o.detach().float().requires_grad_(), lse.detach().requires_grad_()
    _merge_with_other_block(o_leaf, lse_leaf, o2, lse2).backward(do.float())
    do1, dlse = o_leaf.grad.to(do.dtype), lse_leaf.grad
    delta1 = (do1.float() * o.float()).sum(-1).transpose(1, 2)
    args = (q, k, v, lse, do1, (delta1 - dlse).contiguous())
    got = (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args, **kw))
    torch.cuda.synchronize()
    want = (fa.reference_flash_bwd_dq(*args, **kw), *fa.reference_flash_bwd_dkv(*args, **kw))
    errs = {lb: entry_err(g, w) for lb, g, w in zip(("dq", "dk", "dv"), got, want)}
    planted = {f"{lb} {fault}": entry_err(bad, w) for lb, g, w in zip(("dq", "dk", "dv"), got, want)
               for fault, bad in _planted_faults(g).items()}
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    before = _launch_counts()
    _merge_with_other_block(*fa.flash_attention_with_lse(*leaves, **kw), o2, lse2).backward(
        do.float())
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in _launch_counts().items()}
    auto = {lb: entry_err(x.grad, w) for lb, x, w in zip(("dq", "dk", "dv"), leaves, want)}
    print(f"[kernel] flash_bwd with dlse != 0 from a ring merge (|dlse| mean "
          f"{dlse.abs().mean().item():.3g}, |delta| mean {delta1.abs().mean().item():.3g}) "
          f"{where}: max |err| / (|ref| + rms(ref)) "
          + "; ".join(f"{lb} {e:.3g}" for lb, e in errs.items())
          + "; through flash_attention_with_lse's backward " + "; ".join(
              f"{lb} {e:.3g}" for lb, e in auto.items()) + f"; tol {tol}; planted faults read "
          + "; ".join(f"{f} {e:.3g}" for f, e in planted.items()) + f"; launches {launched}",
          flush=True)
    if not all(math.isfinite(e) and e <= tol for e in (*errs.values(), *auto.values())):
        _fail(f"the lse variant of the backward disagrees with its plain versions at {where}")
    if min(planted.values()) <= tol:
        _fail(f"the lse-variant backward check passes a planted fault at {where}: {planted}")
    if launched != {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}:
        _fail(f"flash_attention_with_lse's backward launched {launched}, want one of each")


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


def phase_gptj():
    """gpt_j_6b(n_layers=2) at full width (16 heads of head_dim 256, gelu,
    parallel block), bf16, random weights from seed 0: a paged prefill and 7
    decode steps, then 3 AdamW steps under remat "hot" on 1 x 2048 tokens,
    all through the kernels at head_dim 256. Each kernel must launch where
    the path runs it, the tokens lie in the vocabulary and the loss is
    finite and falling. Returns the train run's launches."""
    import torch

    from ray_tpu_torch.models import transformer as tfm

    cfg = tfm.gpt_j_6b(n_layers=2, dtype=torch.bfloat16, remat_policy="hot")
    n_steps = 3
    init, step = tfm.build_train_step(cfg, tfm.adamw(1e-4), device="cuda")
    params, opt = init(torch.Generator(device="cuda").manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (300,),
                           generator=torch.Generator().manual_seed(10)).tolist()
    _zero_launch_counts()
    t0 = time.perf_counter()
    toks = _greedy(cfg, tfm.map_tree(lambda t: t.detach(), params), prompt, 8)
    serve_s = time.perf_counter() - t0
    serve_launches = _launch_counts()
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(11))
    _zero_launch_counts()
    losses, step_ms = [], []
    for _ in range(n_steps):
        t = time.perf_counter()
        losses.append(step(params, opt, tokens).item())
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = _launch_counts()
    print(f"[gptj] gpt_j_6b width, 2 layers ({tfm.param_count(params) / 1e9:.3f} B params), "
          f"head_dim {cfg.head_dim}, bf16: paged prefill of {len(prompt)} tokens + 7 decode "
          f"steps in {serve_s:.2f} s, tokens {toks}, launches {serve_launches}; {n_steps} steps "
          f"of adamw(1e-4), remat hot, 1 x 2048 tokens: losses {[round(x, 4) for x in losses]}, "
          f"step ms {[round(t, 1) for t in step_ms]}, launches {launches}", flush=True)
    del params, opt
    torch.cuda.empty_cache()
    if serve_launches != {"flash_fwd": cfg.n_layers, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}:
        _fail(f"gptj: the paged prefill launched {serve_launches}, want one flash_fwd a layer")
    if not all(0 <= t < cfg.vocab_size for t in toks):
        _fail(f"gptj: out-of-vocabulary tokens {toks}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        _fail(f"gptj: the loss is not finite and falling: {losses}")
    want = {n: cfg.n_layers * n_steps for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    if launches != want:
        _fail(f"gptj: train launches {launches}, want {want}")
    return launches


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


def _print_profile(prof, wall_s, phase, top=15):
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
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
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


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _drive(streams, prompts, n_new, deadline_s=600):
    """Runs every (label, open_stream) of `streams` on its prompt in its own
    thread, all at once; returns {label: (t_submit, [(t, token)])}. A
    stream that raises or outlives the deadline fails the phase."""
    import threading

    out, errors = {}, []

    def run(label, open_stream, prompt):
        t0 = time.perf_counter()
        toks = []
        try:
            for tok in open_stream(prompt, n_new):
                toks.append((time.perf_counter(), tok))
        except Exception as e:  # noqa: BLE001 - reported below, fails the phase
            errors.append((label, repr(e)))
        out[label] = (t0, toks)

    threads = [threading.Thread(target=run, args=(label, fn, p), daemon=True)
               for (label, fn), p in zip(streams, prompts)]
    for t in threads:
        t.start()
    end = time.monotonic() + deadline_s
    for t in threads:
        t.join(timeout=max(1.0, end - time.monotonic()))
    if errors or any(t.is_alive() for t in threads):
        _fail(f"requests failed or hung: {errors}")
    return out


def _latency(runs, labels):
    """(TTFT p50 ms, decode tokens/s) over the runs named by `labels`."""
    import statistics

    ttft = [(runs[lb][1][0][0] - runs[lb][0]) * 1e3 for lb in labels]
    first = min(runs[lb][1][0][0] for lb in labels)
    last = max(runs[lb][1][-1][0] for lb in labels)
    n_decode = sum(len(runs[lb][1]) - 1 for lb in labels)
    return statistics.median(ttft), n_decode / (last - first)


def phase_deploy():
    """Llama-2-7B at full width and depth in bf16 (random weights from seed
    0) deployed with llm_deployment on ray_tpu_torch.init(local_mode=True):
    8 requests through the streaming handle and 8 through LLMClient's feed,
    all at once. Their greedy tokens must equal InferenceEngine's driven
    directly over the same builder, seed and prompts, and flash_fwd must
    launch on the deployment's path. Then a handle close() mid-stream must
    free the request's pages within one decode step. Prints TTFT p50 and
    decode tokens/s for the handle, the feed and the direct engine."""
    import gc
    import random

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import (EngineConfig, InferenceEngine, LLMClient,
                                         llama2_7b_paged_lm, llm_deployment)

    gc.collect()  # the serve phase's model
    torch.cuda.empty_cache()
    smi = _smi()
    n_new, geometry = 32, dict(num_pages=512, page_tokens=16, max_slots=8, max_pages_per_seq=64)
    cfg = EngineConfig(page_tokens=16, pool_pages=512, max_new_tokens=n_new)
    rng = random.Random(1)
    lengths = (280, 700, 20, 310, 96, 450, 64, 296)
    prompts = [[rng.randrange(1, 32000) for _ in range(n)] for n in lengths * 2]
    labels = [f"handle {i}" for i in range(8)] + [f"feed {i}" for i in range(8)]

    t0 = time.perf_counter()
    lm = llama2_7b_paged_lm(seed=0, device="cuda", **geometry)
    eng = InferenceEngine(lm, cfg, name="chip-smoke-direct")
    try:
        list(eng.generate([1, 2, 3, 4], 2))  # warm-up
        direct = _drive([(lb, eng.generate) for lb in labels], prompts, n_new)
    finally:
        eng.close()
    del lm, eng
    gc.collect()
    torch.cuda.empty_cache()
    direct_s = time.perf_counter() - t0
    direct_ttft, direct_tps = _latency(direct, labels)

    rt.init(local_mode=True)
    try:
        t0 = time.perf_counter()
        app = llm_deployment(llama2_7b_paged_lm, name="llama2-7b", engine_config=cfg,
                             model_kwargs=dict(seed=0, device="cuda", **geometry))
        handle = serve.run(app, name="llama2-7b", http_port=None)
        stream = handle.options(stream=True)
        client = LLMClient("llama2-7b")
        stats = handle.options(method_name="engine_stats")
        try:
            list(stream.remote([1, 2, 3, 4], 2))  # warm-up
            list(client.generate([1, 2, 3, 4], 2))
            up_s = time.perf_counter() - t0
            _zero_launch_counts()
            runs = _drive([(lb, stream.remote if lb.startswith("handle") else client.generate)
                           for lb in labels], prompts, n_new)
            launches = _launch_counts()

            # A handle close() mid-stream frees the request's pages.
            gen = stream.remote(prompts[0], 400)
            got = [next(gen), next(gen)]
            gen.close()  # the cancel goes to the replica ahead of the stats call below
            before = stats.remote().result(timeout=60)
            deadline = time.monotonic() + 60
            while True:
                after = stats.remote().result(timeout=60)
                if after["running"] == 0 and after["kv"]["used_pages"] == 0:
                    break
                if time.monotonic() > deadline:
                    _fail(f"deploy: a closed stream kept its pages: {after}")
                time.sleep(0.002)
        finally:
            client.close()
    finally:
        serve.shutdown()
        rt.shutdown()
        gc.collect()
        torch.cuda.empty_cache()
    h_ttft, h_tps = _latency(runs, labels[:8])
    f_ttft, f_tps = _latency(runs, labels[8:])
    all_ttft, all_tps = _latency(runs, labels)
    mismatched = [lb for lb in labels if [t for _, t in runs[lb][1]] != [t for _, t in direct[lb][1]]]
    steps = after["decode_steps"] - before["decode_steps"]
    local_line = (f"in-process deployment TTFT p50 {all_ttft:.1f} ms, decode {all_tps:.1f} tok/s; "
                  f"direct engine TTFT p50 {direct_ttft:.1f} ms, decode {direct_tps:.1f} tok/s")
    print(f"[deploy] llama2_7b bf16 seed 0 via llm_deployment on init(local_mode=True), up in "
          f"{up_s:.1f} s; 16 requests at once, prompts {[len(p) for p in prompts]}, {n_new} new "
          f"tokens each; greedy tokens equal to InferenceEngine driven directly: "
          f"{16 - len(mismatched)}/16 (direct run {direct_s:.1f} s); flash_fwd launches "
          f"{launches['flash_fwd']}", flush=True)
    print(f"[deploy] {smi}: handle TTFT p50 {h_ttft:.1f} ms, decode {h_tps:.1f} tok/s; feed "
          f"TTFT p50 {f_ttft:.1f} ms, decode {f_tps:.1f} tok/s; all 16 through the deployment "
          f"TTFT p50 {all_ttft:.1f} ms, decode {all_tps:.1f} tok/s; direct engine, same 16 "
          f"requests: TTFT p50 {direct_ttft:.1f} ms, decode {direct_tps:.1f} tok/s", flush=True)
    print(f"[deploy] handle close() after 2 of 400 tokens ({got}): pages and slot freed "
          f"{steps} decode step(s) after close returned; tokens emitted over the engine's life "
          f"{after['tokens_emitted']}", flush=True)
    if mismatched:
        _fail(f"deploy: greedy tokens differ from the direct engine for {mismatched}")
    if launches["flash_fwd"] < 32 * 16:
        _fail(f"deploy: flash_fwd launched {launches['flash_fwd']} times, want >= 32 x 16")
    if steps > 1:
        _fail(f"deploy: a closed stream's pages freed {steps} decode steps after close")
    return {"deploy replica (cluster)": _deploy_on_cluster(
        prompts, labels, n_new, geometry, cfg, direct, local_line, smi)}


def _counted_llm_server():
    """serve.llm's replica class with one method more, `kernel_launches`:
    the flash kernels' launch counts of the replica's own process, zeroed
    when asked, beside its pid and CUDA_VISIBLE_DEVICES."""
    from ray_tpu_torch.serve.llm.deployment import LLMServer

    class CountedLLMServer(LLMServer):
        def kernel_launches(self, zero: bool = False):
            counts = _launch_counts()
            if zero:
                _zero_launch_counts()
            return {"launches": counts, "pid": os.getpid(),
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}

    return CountedLLMServer


def _deploy_on_cluster(prompts, labels, n_new, geometry, cfg, direct, local_line, smi):
    """The deploy phase's cluster part: the same llm_deployment, prompts and
    geometry with the replica an actor in a worker process of init() leased
    GPU 0 (ray_actor_options={"num_gpus": 1}). Its greedy tokens must equal
    the direct engine's for all 16 requests, flash_fwd must launch >= 32 x 16
    times and the backward kernels never, as counted in the replica's process
    (the replica class gains `kernel_launches` for that, and nothing else),
    and a closed stream must free its pages within one decode step. No
    process and no pool of the cluster may outlive its shutdown."""
    import gc
    import glob

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.runtime_base import current_runtime
    from ray_tpu_torch.serve.deployment import Application, Deployment
    from ray_tpu_torch.serve.llm import LLMClient, llama2_7b_paged_lm, llm_deployment

    t0 = time.perf_counter()
    rt.init()
    init_s = time.perf_counter() - t0
    session_dir = current_runtime()._cluster.session_dir
    ours = f"/dev/shm/rtpt_{os.path.basename(session_dir)}"
    try:
        t0 = time.perf_counter()
        base = llm_deployment(llama2_7b_paged_lm, name="llama2-7b-cluster", engine_config=cfg,
                              model_kwargs=dict(seed=0, device="cuda", **geometry),
                              ray_actor_options={"num_gpus": 1})
        app = Application(Deployment(_counted_llm_server(), base.deployment.name,
                                     base.deployment.config), base.init_args, base.init_kwargs)
        handle = serve.run(app, name="llama2-7b-cluster", http_port=None)
        stream = handle.options(stream=True)
        client = LLMClient("llama2-7b-cluster")
        stats = handle.options(method_name="engine_stats")
        counters = handle.options(method_name="kernel_launches")
        try:
            list(stream.remote([1, 2, 3, 4], 2))  # warm-up
            list(client.generate([1, 2, 3, 4], 2))
            up_s = time.perf_counter() - t0
            replica = counters.remote(True).result(timeout=60)
            runs = _drive([(lb, stream.remote if lb.startswith("handle") else client.generate)
                           for lb in labels], prompts, n_new)
            launches = counters.remote(False).result(timeout=60)["launches"]

            gen = stream.remote(prompts[0], 400)
            got = [next(gen), next(gen)]
            gen.close()
            before = stats.remote().result(timeout=60)
            deadline = time.monotonic() + 60
            while True:
                after = stats.remote().result(timeout=60)
                if after["running"] == 0 and after["kv"]["used_pages"] == 0:
                    break
                if time.monotonic() > deadline:
                    _fail(f"deploy: on the cluster a closed stream kept its pages: {after}")
                time.sleep(0.002)
        finally:
            client.close()
    finally:
        serve.shutdown()
        t0 = time.perf_counter()
        rt.shutdown()
        down_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    left = _cluster_processes(session_dir)
    pools = glob.glob(ours + "*")
    h_ttft, h_tps = _latency(runs, labels[:8])
    f_ttft, f_tps = _latency(runs, labels[8:])
    all_ttft, all_tps = _latency(runs, labels)
    mismatched = [lb for lb in labels if [t for _, t in runs[lb][1]] != [t for _, t in direct[lb][1]]]
    steps = after["decode_steps"] - before["decode_steps"]
    print(f"[deploy] cluster: init() {init_s:.2f} s; the 7B replica in worker pid "
          f"{replica['pid']} (driver {os.getpid()}), CUDA_VISIBLE_DEVICES="
          f"{replica['visible']!r}, up in {up_s:.1f} s; greedy tokens equal to the direct "
          f"engine's: {16 - len(mismatched)}/16; launches counted in the replica's process "
          f"{launches}", flush=True)
    print(f"[deploy] cluster {smi}: handle TTFT p50 {h_ttft:.1f} ms, decode {h_tps:.1f} "
          f"tok/s; feed TTFT p50 {f_ttft:.1f} ms, decode {f_tps:.1f} tok/s; all 16 TTFT p50 "
          f"{all_ttft:.1f} ms, decode {all_tps:.1f} tok/s; {local_line}", flush=True)
    print(f"[deploy] cluster: handle close() after 2 of 400 tokens ({got}): pages and slot "
          f"freed {steps} decode step(s) after close returned; shutdown {down_s:.2f} s, "
          f"processes left {left}, pools left {sorted(pools)}", flush=True)
    if replica["pid"] == os.getpid() or replica["visible"] != "0":
        _fail("deploy: the cluster replica is not a worker process that sees exactly device 0")
    if mismatched:
        _fail(f"deploy: on the cluster greedy tokens differ from the direct engine for "
              f"{mismatched}")
    if launches["flash_fwd"] < 32 * 16 or launches["flash_bwd_dq"] or launches["flash_bwd_dkv"]:
        _fail(f"deploy: the cluster replica launched {launches}, want flash_fwd >= 32 x 16 "
              f"and no backward kernel")
    if steps > 1:
        _fail(f"deploy: on the cluster a closed stream's pages freed {steps} decode steps "
              f"after close")
    if left or pools:
        _fail("deploy: processes or /dev/shm/rtpt_* pools outlived the cluster's shutdown")
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
    tokens, under remat "dots" and "hot". The first step's gradient of every
    leaf agrees within 1e-5 of that leaf's norm (readings at most 2.6e-6:
    fp32 sums in another order); Adam's updates hide a gradient off by a
    factor, so the losses alone do not show one. Losses agree within 5e-5
    relative at every step: Adam carries the gradients' rounding into the
    next steps. The flash forward runs twice per layer per step under "dots"
    (remat runs it again) and once under "hot" (its output is kept)."""
    import torch

    from ray_tpu_torch.models import transformer as tfm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rtol, grad_rtol, n_layers, n_steps = 5e-5, 1e-5, 2, 3
    tokens = torch.randint(0, 32000, (1, 256), generator=torch.Generator().manual_seed(3))
    for policy, fwd_per_layer in (("dots", 2), ("hot", 1)):
        losses, launches, grads = {}, {}, {}
        for impl in ("full", "naive"):
            cfg = tfm.llama2_7b(n_layers=n_layers, dtype=torch.float32, attn_impl=impl,
                                remat_policy=policy)
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
        print(f"[train-parity] llama2_7b width, 2 layers, fp32, b=1 s=256, adamw(1e-4), remat "
              f"{policy}: losses kernels {[round(x, 6) for x in losses['full']]} plain "
              f"{[round(x, 6) for x in losses['naive']]}; max rel diff {diff:.3g} (tol {rtol}); "
              f"launches kernels {launches['full']} plain {launches['naive']}", flush=True)
        print(f"[train-parity] remat {policy}: first-step gradient, |kernels - plain| / |plain| "
              "per leaf: " + ", ".join(f"{n} {e:.3g}" for n, e in grad_diff.items())
              + f" (tol {grad_rtol})", flush=True)
        if not all(math.isfinite(x) for x in losses["full"] + losses["naive"]) or diff > rtol:
            _fail(f"train-parity: the kernels' losses disagree with plain autograd ({policy})")
        if not all(e <= grad_rtol for e in grad_diff.values()):
            _fail(f"train-parity: the kernels' first-step gradients disagree with plain "
                  f"autograd ({policy})")
        want = {"flash_fwd": fwd_per_layer * n_layers * n_steps,
                "flash_bwd_dq": n_layers * n_steps, "flash_bwd_dkv": n_layers * n_steps}
        if launches["full"] != want or any(launches["naive"].values()):
            _fail(f"train-parity launches under {policy}: {launches}, want {want} through the "
                  "kernels")


# Flash forward launches per layer per step under each remat policy: "dots"
# runs it again in the backward, "attn" and "hot" keep its output.
TRAIN_POLICIES = {"hot": 1, "dots": 2, "attn": 1}


def _train_run(policy: str, profile: bool):
    """6 AdamW steps of llama2_7b(n_layers=8) in bf16 under remat `policy`,
    on one fixed batch of 2 x 2048 random tokens; returns each kernel's
    launches."""
    import gc
    import statistics

    import torch

    from ray_tpu_torch.models import transformer as tfm

    cfg = tfm.llama2_7b(n_layers=8, dtype=torch.bfloat16, remat_policy=policy)
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
          f"remat {policy}, random weights from seed 0 on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    losses, step_ms = [], []
    for _ in range(n_steps):
        t = time.perf_counter()
        losses.append(step(params, opt, tokens).item())  # .item() waits for the device
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # What the policy keeps: the bytes one more forward leaves allocated for
    # its backward (logits and loss included, the same under every policy),
    # and that backward's peak, both above params, AdamW state and tokens.
    opt.zero_grad(set_to_none=True)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss = tfm.next_token_loss(params, tokens, cfg)
    kept = torch.cuda.memory_allocated() - base
    loss.backward()
    del loss
    fwd_bwd_peak = torch.cuda.max_memory_allocated() - base
    opt.zero_grad(set_to_none=True)
    p50 = statistics.median(step_ms[1:])
    tok_s = b * s / (p50 / 1e3)
    mfu = tfm.flops_per_token(cfg, s) * tok_s / PEAK_FLOPS["bfloat16"]
    print(f"[train] remat {policy}: {n_steps} steps of adamw(1e-4) on {b} x {s} tokens: losses "
          f"{[round(x, 4) for x in losses]}; step ms {[round(t, 1) for t in step_ms]}, p50 over "
          f"steps 2-{n_steps} {p50:.1f}; {tok_s:.0f} tokens/s; MFU {100 * mfu:.2f}% (against "
          f"the H100 bf16 dense peak, 989 TFLOP/s); max_memory_allocated {peak / 2**30:.2f} GiB "
          f"({held / 2**30:.2f} GiB held before the phase); launches {launches}", flush=True)
    print(f"[train] remat {policy}: one more forward keeps {kept / 2**20:.1f} MiB for its "
          f"backward ({kept / 2**20 / cfg.n_layers:.1f} MiB per layer, logits included); that "
          f"backward peaks {fwd_bwd_peak / 2**30:.3f} GiB above params and AdamW state",
          flush=True)
    if profile:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        with prof:
            t = time.perf_counter()
            step(params, opt, tokens).item()
            wall = time.perf_counter() - t
        _print_profile(prof, wall, f"train {policy}")
    del params, opt
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses):
        _fail(f"train ({policy}): a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        _fail(f"train ({policy}): the loss did not fall: {losses}")
    want = {"flash_fwd": TRAIN_POLICIES[policy] * cfg.n_layers * n_steps,
            "flash_bwd_dq": cfg.n_layers * n_steps, "flash_bwd_dkv": cfg.n_layers * n_steps}
    if launches != want:
        _fail(f"train ({policy}): launches {launches}, want {want}")
    return launches


def phase_train(profile: bool = False):
    """The train run under remat "hot" (the JAX package's training default),
    then "dots" and "attn"; returns the "hot" run's launches."""
    runs = {policy: _train_run(policy, profile and policy == "hot") for policy in TRAIN_POLICIES}
    return runs["hot"]


@contextlib.contextmanager
def _deterministic():
    """torch.use_deterministic_algorithms(True) inside, restored after; the
    embedding's backward then sums without atomics. cuBLAS asks for
    CUBLAS_WORKSPACE_CONFIG, which this process uses on one stream only."""
    import torch

    was, env = torch.are_deterministic_algorithms_enabled(), os.environ.get(
        "CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


def _tree_equal(a, b) -> bool:
    """Whether two trees have the same key paths and every leaf the same
    dtype, shape and bytes (so -0.0 differs from 0.0)."""
    import torch

    from ray_tpu_torch.models.convert import flatten

    def raw(t):
        return t.detach().reshape(-1).view(torch.uint8)

    (pa, la), (pb, lb) = flatten(a), flatten(b)
    return pa == pb and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(raw(x).to(y.device), raw(y))
        for x, y in zip(la, lb))


def phase_zero():
    """ZeRO-1 over a NCCL group of one rank in this process, against the
    plain step from the same params: llama2_7b(n_layers=2), bf16, remat
    "hot", b=1, s=2048, 3 steps, deterministic algorithms. Losses and
    params must be bitwise equal: the update is elementwise and a
    reduce-scatter over one rank is the identity."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.train import backend, zero

    cfg = tfm.llama2_7b(n_layers=2, dtype=torch.bfloat16, remat_policy="hot")
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(5))
    t0 = time.perf_counter()
    info = backend.setup_torch_distributed(0, 1, backend.coordinator_address(
        backend.TorchBackendConfig()))
    print(f"[zero] process group {dist.get_backend()} {info} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    try:
        with _deterministic():
            runs = {}
            for name, kw in (("plain", {}), ("zero", {"zero_axis": "data"})):
                init, step = tfm.build_train_step(cfg, tfm.adamw(1e-4), device="cuda", **kw)
                params, opt = init(torch.Generator(device="cuda").manual_seed(4))
                losses, step_ms = [], []
                for _ in range(3):
                    t = time.perf_counter()
                    losses.append(step(params, opt, tokens).item())
                    step_ms.append((time.perf_counter() - t) * 1e3)
                runs[name] = (losses, params, zero.per_device_bytes(opt), step_ms)
                del opt
        (pl, pp, pb, pms), (zl, zp, zb, zms) = runs["plain"], runs["zero"]
        same = pl == zl and _tree_equal(pp, zp)
        print(f"[zero] llama2_7b width, 2 layers, bf16, remat hot, b=1 s=2048, 3 steps of "
              f"adamw(1e-4), {dist.get_backend()} world 1: losses plain {pl} zero {zl}; losses "
              "and params "
              f"bitwise equal {same}; optimizer state per device {pb / 2**30:.3f} GiB plain, "
              f"{zb / 2**30:.3f} GiB zero; step ms plain {[round(t, 1) for t in pms]}, zero "
              f"{[round(t, 1) for t in zms]}",
              flush=True)
        del runs, pp, zp
        torch.cuda.empty_cache()
        if not same:
            _fail("zero: the ZeRO step at world 1 differs from the plain step")
        if zb < pb:
            _fail(f"zero: {zb} optimizer bytes at world 1, below the plain {pb}")
    finally:
        dist.destroy_process_group()


def _greedy(cfg, params, prompt, n_new):
    """PagedLM prefill + decode on one sequence: n_new greedy tokens."""
    from ray_tpu_torch.serve.llm import PagedLM

    T = 16
    pages = list(range(1, 1 + -(-(len(prompt) + n_new) // T)))
    lm = PagedLM(cfg, params, device="cuda", num_pages=len(pages) + 1, page_tokens=T,
                 max_slots=1, max_pages_per_seq=len(pages))
    out = [lm.prefill(prompt, pages, 0)]
    while len(out) < n_new:
        out.append(lm.decode([out[-1]], [len(prompt) + len(out) - 1], [pages])[0])
    return out


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def phase_checkpoint():
    """Save, reshard, resume and HF round trip on llama2_7b(n_layers=2),
    bf16, remat "hot", b=1, s=2048, under deterministic algorithms: 3 steps,
    save_state (elastic format) at world 1, reshard to world 4 on disk,
    restore into fresh params and a fresh optimizer (bitwise equal to what
    was saved), 3 more steps: losses and params bitwise equal to an
    uninterrupted 6-step run. Then export_hf_checkpoint ->
    load_hf_checkpoint, bitwise, and PagedLM's 8 greedy tokens from the
    reloaded weights equal those from the originals."""
    import shutil
    import tempfile

    import torch

    from ray_tpu_torch.models import convert
    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.train import elastic_checkpoint as ec
    from ray_tpu_torch.train import hf_checkpoint as hf

    cfg = tfm.llama2_7b(n_layers=2, dtype=torch.bfloat16, remat_policy="hot")
    init, step = tfm.build_train_step(cfg, tfm.adamw(1e-4), device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(6))
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    timings = {}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        timings[name] = time.perf_counter() - t
        return out

    try:
        with _deterministic():
            params, opt = init(torch.Generator(device="cuda").manual_seed(7))
            straight = [step(params, opt, tokens).item() for _ in range(6)]
            want = params
            del opt
            params, opt = init(torch.Generator(device="cuda").manual_seed(7))
            resumed = [step(params, opt, tokens).item() for _ in range(3)]
            saved = (params, convert.opt_state_to_torch(opt, params))
            w1, w4 = f"{tmp}/world1", f"{tmp}/world4"
            timed("save", ec.save_state, w1, *saved, step=3, world_size=1, rank=0)
            written = _dir_bytes(w1)
            for kind in ("params", "opt"):
                timed(f"reshard {kind}", ec.reshard, w1, w4, 4, kind=kind)
            shutil.rmtree(w1)
            state = timed("load", ec.load_state, w4)
            del params, opt
            params, opt = init(torch.Generator(device="cuda").manual_seed(8))
            with torch.no_grad():
                for t, src in zip(convert.flatten(params)[1],
                                  convert.flatten(state["params"])[1]):
                    t.copy_(src)
            convert.opt_state_from_numpy(state["opt_state"], opt, params)
            restored = (_tree_equal(saved[0], params)
                        and _tree_equal(saved[1], convert.opt_state_to_torch(opt, params))
                        and state["step"] == 3 and state["saved_world_size"] == 4)
            del saved, state
            resumed += [step(params, opt, tokens).item() for _ in range(3)]
            del opt
        same = resumed == straight and _tree_equal(want, params)
        print(f"[checkpoint] llama2_7b width, 2 layers, bf16, remat hot, b=1 s=2048, "
              f"deterministic: losses straight {straight} resumed {resumed}; restored state "
              f"bitwise equal to the saved {restored}; after 6 steps losses and params bitwise "
              f"equal {same}; elastic checkpoint {written / 2**30:.3f} GiB at world 1, "
              + ", ".join(f"{k} {v:.1f} s" for k, v in timings.items()), flush=True)
        if not restored:
            _fail("checkpoint: the restored state differs from the saved one")
        if not same:
            _fail("checkpoint: the resumed run differs from the uninterrupted one")
        del want
        path = f"{tmp}/model.safetensors"
        timed("hf export", hf.export_hf_checkpoint, params, cfg, path)
        loaded = timed("hf load", hf.load_hf_checkpoint, path, cfg, device="cuda")
        hf_same = _tree_equal(params, loaded)
        prompt = torch.randint(0, cfg.vocab_size, (21,),
                               generator=torch.Generator().manual_seed(9)).tolist()
        params = tfm.map_tree(lambda t: t.detach(), params)
        got, gold = _greedy(cfg, loaded, prompt, 8), _greedy(cfg, params, prompt, 8)
        print(f"[checkpoint] HF safetensors {os.path.getsize(path) / 2**30:.3f} GiB: export "
              f"{timings['hf export']:.1f} s, load onto the card {timings['hf load']:.1f} s; "
              f"reloaded weights bitwise equal {hf_same}; greedy tokens reloaded {got} "
              f"original {gold}", flush=True)
        if not hf_same or got != gold:
            _fail("checkpoint: the HF round trip changed the weights or the greedy tokens")
        del params, loaded
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# The fit and tune phases train the zero phase's configuration through
# TorchTrainer and Tuner: llama2_7b(n_layers=2), bf16, remat "hot", b=1,
# s=2048, adamw, seed 0, under deterministic algorithms.
FIT_SEQ = 2048
FIT_STEPS, FIT_CKPT_AT, FIT_FAIL_AFTER = 8, 3, 5
TUNE_STEPS, TUNE_LRS = 4, (1e-4, 3e-4)
# With --profile, step 6 of the plain runs and of run B's resumed attempt is
# traced; it is left out of every step p50.
FIT_PROFILE_AT = 6


def _traced(enabled: bool):
    import torch

    if not enabled:
        return contextlib.nullcontext()
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])


def _in_thread(fn, *args):
    """fn(*args) in a plain threading.Thread (no runtime); its result."""
    import threading

    out = {}

    def run():
        try:
            out["value"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out["error"] = e

    t = threading.Thread(target=run, name="plain-step")
    t.start()
    t.join(timeout=300)
    if "error" in out:
        raise out["error"]
    if "value" not in out:
        _fail("a plain run in its own thread did not finish in 300 s")
    return out["value"]


def _fit_cfg():
    import torch

    from ray_tpu_torch.models import transformer as tfm

    return tfm.llama2_7b(n_layers=2, dtype=torch.bfloat16, remat_policy="hot")


def _fit_batch(step: int, vocab: int):
    """Step i's batch: 1 x 2048 tokens from a generator seeded with i, so a
    resume at the wrong step shows in its losses."""
    import torch

    return torch.randint(0, vocab, (1, FIT_SEQ), generator=torch.Generator().manual_seed(step))


def _params_sha256(params) -> str:
    """SHA-256 of every param's bytes in convert.flatten's order."""
    import hashlib

    import torch

    from ray_tpu_torch.models.convert import flatten

    h = hashlib.sha256()
    for t in flatten(params)[1]:
        h.update(t.detach().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _direct_run(lr: float, n_steps: int, profile_at=None, label: str = ""):
    """The same model, seed and batches through build_train_step driven
    directly: (losses, step ms, params_sha256). Step `profile_at` is traced
    and its device time printed under `label`."""
    import torch

    from ray_tpu_torch.models import transformer as tfm

    cfg = _fit_cfg()
    init, step = tfm.build_train_step(cfg, tfm.adamw(lr), device="cuda")
    params, opt = init(torch.Generator(device="cuda").manual_seed(0))
    losses, step_ms = [], []
    for i in range(n_steps):
        tokens = _fit_batch(i, cfg.vocab_size)
        with _traced(i == profile_at) as prof:
            t = time.perf_counter()
            losses.append(step(params, opt, tokens).item())  # .item() waits for the device
            step_ms.append((time.perf_counter() - t) * 1e3)
        if i == profile_at:
            _print_profile(prof, step_ms[-1] / 1e3, label, top=5)
    sha = _params_sha256(params)
    del params, opt
    torch.cuda.empty_cache()
    return losses, step_ms, sha


def _make_loop(log: list):
    """The training loop of the fit and tune phases, as a user writes it for
    TorchTrainer: the model and AdamW state built on the mesh's device from
    seed 0; with a checkpoint from train.get_checkpoint(), params and AdamW
    state restored from it and the steps resumed after its step; one report
    per step with the loss and tokens_per_s (MFU from configure_telemetry);
    an elastic checkpoint of params and AdamW state reported at
    config["ckpt_at"]; a raise after reporting config["fail_after"] in an
    attempt that did not restore; step config["profile_at"] traced.
    Appends its events to `log`."""

    def loop(config):
        import gc
        import shutil
        import tempfile

        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.models import convert
        from ray_tpu_torch.models import transformer as tfm
        from ray_tpu_torch.train import elastic_checkpoint as ec

        run, lr = config["run"], config["lr"]
        device = train.get_mesh().devices.flat[0]
        gc.collect()
        log.append({"run": run, "lr": lr, "event": "start",
                    "allocated": torch.cuda.memory_allocated(device)})
        cfg = _fit_cfg()
        train.configure_telemetry(flops_per_token=tfm.flops_per_token(cfg, FIT_SEQ))
        init, step = tfm.build_train_step(cfg, tfm.adamw(lr), device=device)
        params, opt = init(torch.Generator(device=device).manual_seed(0))
        start, ck = 0, train.get_checkpoint()
        if ck is not None:
            t = time.perf_counter()
            state = ec.load_state(ck.path)
            with torch.no_grad():
                for p, src in zip(convert.flatten(params)[1],
                                  convert.flatten(state["params"])[1]):
                    p.copy_(src)
            convert.opt_state_from_numpy(state["opt_state"], opt, params)
            torch.cuda.synchronize(device)
            log.append({"run": run, "lr": lr, "event": "restore",
                        "s": time.perf_counter() - t})
            start = state["step"] + 1
            del state
        sources = {}  # step -> directory of a reported checkpoint
        for i in range(start, config["steps"]):
            tokens = _fit_batch(i, cfg.vocab_size)
            with _traced(i == config.get("profile_at")) as prof:
                t = time.perf_counter()
                with train.phase("compute"):
                    loss = step(params, opt, tokens).item()  # .item() waits for the device
                dt = time.perf_counter() - t
            if i == config.get("profile_at"):
                _print_profile(prof, dt, f"fit trainer step {i} (run {run})", top=5)
            metrics = {"step": i, "loss": loss, "lr": lr, "tokens_per_s": FIT_SEQ / dt}
            if i == config["steps"] - 1:
                metrics["params_sha256"] = _params_sha256(params)
            ckpt = None
            if i == config.get("ckpt_at"):
                d = tempfile.mkdtemp(prefix="ckpt-", dir=config["scratch"])
                t = time.perf_counter()
                opt_state = convert.opt_state_to_torch(opt, params)  # host copies
                t_state = time.perf_counter()
                ec.save_state(d, params, opt_state, step=i, world_size=1, rank=0)
                del opt_state
                log.append({"run": run, "lr": lr, "event": "save",
                            "s": time.perf_counter() - t, "state_s": t_state - t})
                sources[i], ckpt = d, train.Checkpoint(d)
            entry = {"run": run, "lr": lr, "event": "report", "step": i, "loss": loss,
                     "compute_ms": FIT_SEQ / metrics["tokens_per_s"] * 1e3,
                     "t": time.perf_counter(), "metrics": metrics}
            log.append(entry)
            train.report(metrics, checkpoint=ckpt)
            entry["report_ms"] = (time.perf_counter() - entry["t"]) * 1e3
            # report() returns once its payload is queued, and the trainer
            # copies a checkpoint after taking it off the size-1 queue: only
            # the report two steps later proves that copy done.
            for s in [s for s in sources if s <= i - 2]:
                shutil.rmtree(sources.pop(s))
            if ck is None and i == config.get("fail_after"):
                raise RuntimeError(f"injected failure after step {i}")

    return loop


def _intervals_ms(log, run, lr=None):
    """{step: ms from the previous step's report to this one's}."""
    t = {e["step"]: e["t"] for e in log
         if e["event"] == "report" and e["run"] == run and (lr is None or e["lr"] == lr)}
    return {i: (t[i] - t[i - 1]) * 1e3 for i in sorted(t) if i - 1 in t}


def phase_fit(profile: bool = False):
    """TorchTrainer.fit on the card, ScalingConfig(num_workers=1,
    resources_per_worker={"GPU": 1}), keep-1 checkpoints. Run A: 8 steps
    uninterrupted, an elastic checkpoint (params and AdamW state) reported at
    step 3. Run B: the same loop with max_failures=1; its first attempt
    raises after reporting step 5, its second restores step 3's checkpoint
    through train.get_checkpoint() and runs steps 4-7. Exact gates: B
    succeeds; both end at step 7; A's losses and params equal
    build_train_step driven directly, and B's losses of steps 4-7 and final
    params equal A's, bit for bit; one checkpoint directory in each trial
    dir; B's goodput has restart_rework and A's none; the reported MFU is
    flops_per_token x tokens_per_s / 989e12; each kernel launches 16 times
    in A and 20 in B. Prints the trainer's step p50 (report to report, over
    A's clean steps) against the plain step's, driven from the main thread
    before the runtime starts and while it is up, and from a plain thread
    with no runtime; checkpoint save, persist and restore seconds, goodput,
    and memory after B's failed attempt and after its fit. With `profile`,
    step 6 of B's resumed attempt and of each plain run is traced. Returns
    each run's launches and the trainer's step p50."""
    import gc
    import shutil
    import statistics
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig, RunConfig,
                                     ScalingConfig, TorchTrainer)

    gc.collect()
    torch.cuda.empty_cache()
    smi = _smi()
    cfg = _fit_cfg()
    fpt = tfm.flops_per_token(cfg, FIT_SEQ)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-fit-")
    log, results, launches, memory = [], {}, {}, {}
    loop = _make_loop(log)
    at = FIT_PROFILE_AT if profile else None
    with _deterministic():
        # The plain step three ways: from the main thread, from a plain
        # thread (no runtime), and from the main thread with the runtime up.
        plain = {"main": _direct_run(1e-4, FIT_STEPS, at, "fit plain step, main thread"),
                 "thread": _in_thread(_direct_run, 1e-4, FIT_STEPS, at,
                                      "fit plain step, own thread, no runtime")}
        rt.init(local_mode=True)
        try:
            for run, extra, failures in (
                    ("A", {}, 0),
                    ("B", {"fail_after": FIT_FAIL_AFTER, "profile_at": at}, 1)):
                scratch = os.path.join(tmp, f"{run}-sources")
                os.makedirs(scratch)
                trainer = TorchTrainer(
                    loop,
                    train_loop_config={"run": run, "lr": 1e-4, "steps": FIT_STEPS,
                                       "ckpt_at": FIT_CKPT_AT, "scratch": scratch, **extra},
                    scaling_config=ScalingConfig(num_workers=1, resources_per_worker={"GPU": 1}),
                    run_config=RunConfig(name=f"fit_{run}", storage_path=tmp,
                                         failure_config=FailureConfig(max_failures=failures),
                                         checkpoint_config=CheckpointConfig(num_to_keep=1)))
                gc.collect()
                memory[f"{run} before"] = torch.cuda.memory_allocated()
                _zero_launch_counts()
                t0 = time.perf_counter()
                results[run] = trainer.fit()
                wall = time.perf_counter() - t0
                launches[run] = _launch_counts()
                gc.collect()
                memory[f"{run} after fit"] = torch.cuda.memory_allocated()
                print(f"[fit] run {run}: fit {wall:.1f} s, error {results[run].error!r}, "
                      f"launches {launches[run]}", flush=True)
            plain["main, runtime up"] = _direct_run(
                1e-4, FIT_STEPS, at, "fit plain step, main thread, runtime up")
        finally:
            rt.shutdown()
    try:
        a, b = results["A"], results["B"]
        steps = {run: {e["step"]: e["metrics"] for e in log
                       if e["event"] == "report" and e["run"] == run} for run in "AB"}
        b_starts = [e["allocated"] for e in log if e["event"] == "start" and e["run"] == "B"]
        ckpt_dirs = {run: sorted(d for d in os.listdir(results[run].path)
                                 if d.startswith("checkpoint_")) for run in "AB"}
        a_losses = [steps["A"][i]["loss"] for i in range(FIT_STEPS)]
        b_second = max(k for k, e in enumerate(log) if e["event"] == "start" and e["run"] == "B")
        b_last = {e["step"]: e["loss"] for e in log[b_second:]
                  if e["event"] == "report" and e["run"] == "B"}  # B's second attempt
        steps_log = {e["step"]: e for e in log if e["event"] == "report" and e["run"] == "A"}
        saves = [e["s"] for e in log if e["event"] == "save"]
        save_state_s = [e["state_s"] for e in log if e["event"] == "save"]
        restores = [e["s"] for e in log if e["event"] == "restore"]
        gaps = _intervals_ms(log, "A")
        # Clean intervals: not the checkpoint's step (the save), not the one
        # whose report() waits out the trainer's copy of it (the second
        # report after it: the first fills the size-1 queue while the copy
        # runs), not the last (params_sha256).
        timed = [i for i in range(1, FIT_STEPS - 1) if i not in (FIT_CKPT_AT, FIT_CKPT_AT + 3)]
        trainer_p50 = statistics.median(gaps[i] for i in timed)
        # The step alone (the loop's timer around it), over the steps the
        # plain p50s take.
        steps_timed = [i for i in range(1, FIT_STEPS) if i != at]
        compute_p50 = statistics.median(steps_log[i]["compute_ms"] for i in steps_timed)
        plain_p50 = {k: statistics.median(v[1][i] for i in steps_timed) for k, v in plain.items()}
        last = a.metrics
        want_mfu = fpt * last["tokens_per_s"] / PEAK_FLOPS["bfloat16"]
        print(f"[fit] {smi}: llama2_7b width, 2 layers, bf16, remat hot, b=1 s={FIT_SEQ}, "
              f"adamw(1e-4), deterministic, TorchTrainer on init(local_mode=True): losses A "
              f"{a_losses}; plain {plain['main'][0]}; B's second attempt {b_last}", flush=True)
        print(f"[fit] {smi}: trainer step ms report to report (A), as step: interval / "
              "compute / report() call "
              + ", ".join(f"{i}: {gaps[i]:.1f} / {steps_log[i]['compute_ms']:.1f} / "
                          f"{steps_log[i]['report_ms']:.2f}" for i in sorted(gaps))
              + "; plain step ms " + "; ".join(f"{k} {[round(t, 1) for t in v[1]]}"
                                                for k, v in plain.items()), flush=True)
        base = plain_p50["main"]
        print(f"[fit] {smi}: trainer step p50 over clean intervals {timed} {trainer_p50:.2f} ms, "
              f"the step alone p50 over steps {steps_timed} {compute_p50:.2f} ms; plain step p50 "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in plain_p50.items())
              + f"; against the main thread's: trainer ratio {trainer_p50 / base:.4f}, its step "
              f"alone {compute_p50 / base:.4f}, "
              + ", ".join(f"{k} {v / base:.4f}" for k, v in plain_p50.items() if k != "main"),
              flush=True)
        print(f"[fit] {smi}: elastic checkpoint save s {[round(s, 2) for s in saves]} (of "
              f"which AdamW state to the host {[round(s, 2) for s in save_state_s]}), "
              f"persist (copy) s A {a.metrics['goodput_seconds']['checkpoint']} B "
              f"{b.metrics['goodput_seconds']['checkpoint']}, restore s "
              f"{[round(s, 2) for s in restores]}; goodput A {a.metrics['goodput']:.4f} "
              f"{a.metrics['goodput_seconds']}, B {b.metrics['goodput']:.4f} "
              f"{b.metrics['goodput_seconds']}; MFU reported {last['mfu']:.6f} at "
              f"{last['tokens_per_s']:.0f} tokens/s, expected {want_mfu:.6f}", flush=True)
        print(f"[fit] {smi}: memory_allocated GiB before B {memory['B before'] / 2**30:.3f}, "
              f"after B's failed attempt {b_starts[-1] / 2**30:.3f}, after B's fit "
              f"{memory['B after fit'] / 2**30:.3f} (A: before {memory['A before'] / 2**30:.3f}, "
              f"after {memory['A after fit'] / 2**30:.3f}); checkpoint dirs {ckpt_dirs}",
              flush=True)
        if b.error is not None or a.error is not None:
            _fail(f"fit: errors A {a.error!r} B {b.error!r}")
        if a.metrics["step"] != FIT_STEPS - 1 or b.metrics["step"] != FIT_STEPS - 1:
            _fail(f"fit: last steps A {a.metrics['step']} B {b.metrics['step']}")
        want_losses, _, want_sha = plain["main"]
        if a_losses != want_losses or steps["A"][FIT_STEPS - 1]["params_sha256"] != want_sha:
            _fail("fit: the trainer's run differs from build_train_step driven directly")
        if any(v[0] != want_losses or v[2] != want_sha for v in plain.values()):
            _fail("fit: the direct runs differ")
        if (sorted(b_last) != list(range(FIT_CKPT_AT + 1, FIT_STEPS))
                or any(b_last[i] != a_losses[i] for i in b_last)):
            _fail("fit: the resumed attempt's losses differ from the uninterrupted run's")
        if b.metrics["params_sha256"] != a.metrics["params_sha256"]:
            _fail("fit: the resumed run's params differ from the uninterrupted run's")
        if len(restores) != 1 or len(saves) != 2:
            _fail(f"fit: {len(saves)} saves and {len(restores)} restores, want 2 and 1")
        if any(len(d) != 1 for d in ckpt_dirs.values()):
            _fail(f"fit: keep-1 left {ckpt_dirs}")
        if (a.metrics["goodput_seconds"]["restart_rework"] != 0
                or not b.metrics["goodput_seconds"]["restart_rework"] > 0):
            _fail("fit: restart_rework is not 0 in A and positive in B")
        if abs(last["mfu"] - want_mfu) > 1e-9 * want_mfu:
            _fail(f"fit: MFU {last['mfu']} against {want_mfu} at the H100's 989e12")
        # The failed attempt's error stays on the Result; its tensors must
        # not (params, grads and AdamW state: 5.0 GiB).
        if max(b_starts[-1], memory["B after fit"]) - memory["B before"] > 256 * 2**20:
            _fail("fit: the failed attempt's tensors stayed allocated")
        for run, n_steps in (("A", FIT_STEPS),
                             ("B", FIT_FAIL_AFTER + 1 + FIT_STEPS - FIT_CKPT_AT - 1)):
            want = {k: cfg.n_layers * n_steps for k in launches[run]}
            if launches[run] != want:
                _fail(f"fit: run {run} launched {launches[run]}, want {want}")
        return {"fit_uninterrupted": launches["A"], "fit_resumed": launches["B"]}, trainer_p50
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_tune(fit_step_ms: float):
    """Tuner over the fit phase's TorchTrainer: grid lr in {1e-4, 3e-4},
    TuneConfig(metric="loss", mode="min", max_concurrent_trials=2), so both
    trials train on the card at once from two threads, 4 steps each, the
    same model and batches, deterministic algorithms. Each trial's losses
    and final params must equal build_train_step driven directly with its
    lr, bit for bit; get_best_result() must name the trial whose last loss
    is lower; each kernel launches 16 times. Prints each trial's step p50
    and their combined tokens/s against the lone trainer's."""
    import gc
    import shutil
    import statistics
    import tempfile
    import threading

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    gc.collect()
    torch.cuda.empty_cache()
    smi = _smi()
    cfg = _fit_cfg()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-tune-")
    log = []
    rt.init(local_mode=True)
    try:
        with _deterministic():
            direct = {lr: _direct_run(lr, TUNE_STEPS) for lr in TUNE_LRS}
            # Control: the same two runs at once from two plain threads, no
            # runtime and no Tune, for what sharing the card costs by itself.
            both = {}
            threads = [threading.Thread(target=lambda lr=lr: both.update(
                {lr: _direct_run(lr, TUNE_STEPS)})) for lr in TUNE_LRS]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            trainer = TorchTrainer(
                _make_loop(log),
                train_loop_config={"run": "tune", "steps": TUNE_STEPS, "scratch": tmp},
                scaling_config=ScalingConfig(num_workers=1, resources_per_worker={"GPU": 1}),
                run_config=RunConfig(storage_path=os.path.join(tmp, "inner")))
            _zero_launch_counts()
            t0 = time.perf_counter()
            grid = tune.Tuner(
                trainer,
                param_space={"lr": tune.grid_search(list(TUNE_LRS))},
                tune_config=tune.TuneConfig(metric="loss", mode="min", max_concurrent_trials=2),
                run_config=RunConfig(name="tune", storage_path=tmp),
            ).fit()
            wall = time.perf_counter() - t0
            launches = _launch_counts()
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    trial = {lr: {e["step"]: e["metrics"] for e in log
                  if e["event"] == "report" and e["lr"] == lr} for lr in TUNE_LRS}
    # Steps 1..TUNE_STEPS-2: the last interval carries params_sha256.
    p50 = {lr: statistics.median(ms for i, ms in _intervals_ms(log, "tune", lr).items()
                                 if i < TUNE_STEPS - 1) for lr in TUNE_LRS}
    combined = sum(FIT_SEQ / (ms / 1e3) for ms in p50.values())
    lone = FIT_SEQ / (fit_step_ms / 1e3)
    best = grid.get_best_result()
    want_best = min(TUNE_LRS, key=lambda lr: direct[lr][0][-1])
    print(f"[tune] {smi}: Tuner over TorchTrainer, lr {list(TUNE_LRS)}, 2 trials at once, "
          f"{TUNE_STEPS} steps each, in {wall:.1f} s: losses "
          + "; ".join(f"lr {lr} trial {[trial[lr][i]['loss'] for i in sorted(trial[lr])]} "
                      f"direct {direct[lr][0]}" for lr in TUNE_LRS)
          + f"; best {best.metrics.get('lr')} (want {want_best}); errors {grid.errors}; "
          f"launches {launches}", flush=True)
    print(f"[tune] {smi}: per-trial step p50 (report to report, steps 1-{TUNE_STEPS - 2}) "
          + ", ".join(f"lr {lr} {p50[lr]:.2f} ms ({p50[lr] / fit_step_ms:.3f}x the lone "
                      "trainer's)" for lr in TUNE_LRS)
          + f"; combined {combined:.0f} tokens/s against the lone trainer's {lone:.0f} "
          f"({combined / lone:.3f}x)", flush=True)
    print(f"[tune] {smi}: control, the two direct runs at once from two threads: step ms "
          + "; ".join(f"lr {lr} {[round(t, 1) for t in both[lr][1]]} (p50 steps 1-"
                      f"{TUNE_STEPS - 1} {statistics.median(both[lr][1][1:]):.2f}), losses "
                      f"equal to the sequential run's {both[lr][0] == direct[lr][0]}"
                      for lr in TUNE_LRS if lr in both)
          + f"; the sequential runs' step p50 "
          + ", ".join(f"{statistics.median(direct[lr][1][1:]):.2f}" for lr in TUNE_LRS),
          flush=True)
    if grid.errors or len(grid) != len(TUNE_LRS):
        _fail(f"tune: {len(grid)} results, errors {grid.errors}")
    for lr in TUNE_LRS:
        got = [trial[lr][i]["loss"] for i in sorted(trial[lr])]
        if got != direct[lr][0] or trial[lr][TUNE_STEPS - 1]["params_sha256"] != direct[lr][2]:
            _fail(f"tune: the lr {lr} trial differs from build_train_step driven directly")
    if best.metrics.get("lr") != want_best:
        _fail(f"tune: get_best_result() named lr {best.metrics.get('lr')}, want {want_best}")
    want = {k: cfg.n_layers * TUNE_STEPS * len(TUNE_LRS) for k in launches}
    if launches != want:
        _fail(f"tune: launches {launches}, want {want}")
    return {"tune": launches}


# The parallel phase: a NCCL world of one rank in this process (a), then
# PARALLEL_WORLD processes sharing the card over gloo (b).
PARALLEL_WORLD = 4
PARALLEL_TIMEOUT_S = 900
# (b)'s attention at Llama-2-7B's width: (b, global s, heads, head_dim).
PAR_ATTN_SHAPE = (1, 8192, 32, 128)
PAR_SEQ = 2048
PAR_MICROBATCHES = 4
# (b)'s attention against one flash_attention call over the whole sequence,
# per entry, to the whole result's rms. Ulysses runs that call's kernel on
# each head group: 2**-6, the kernel phase's. The ring rounds each block's
# o and each block's dq/dk/dv to bf16 before it sums them, where the whole
# call rounds once, so the two differ by more than one kernel and its plain
# version do (up to 0.0186 on an H100, PERF.md): the ring is held to 2**-5.
# A wrong block, mask or lse merge is off by O(1), and both planted faults
# must still be refused.
PAR_TOL = {"ring": 2 ** -5, "ulysses": 2 ** -6}


def _grad_diffs(got, full):
    """({leaf: |g - g_full| / |g_full|}, every leaf bitwise equal) of two
    {leaf: gradient} dicts."""
    import torch

    diffs, bitwise = {}, True
    for name, g in got.items():
        ref = full[name].to(g.device)
        diffs[name] = ((g - ref).norm() / ref.norm()).item()
        bitwise = bitwise and torch.equal(g, ref)
    return diffs, bitwise


def _check_loss_grads(label, loss, loss_full, got, full, launches, log):
    """Logs and gates a loss and its gradients against the reference's at
    the train-parity phase's tolerances: loss 5e-5 relative, each leaf 1e-5
    of its gradient's norm."""
    rtol, grad_rtol = 5e-5, 1e-5
    diffs, bitwise = _grad_diffs(got, full)
    diff, worst = abs(loss - loss_full) / abs(loss_full), max(diffs.values())
    bitwise = bitwise and loss == loss_full
    log(f"{label}: loss {loss:.6f} vs {loss_full:.6f} (rel diff {diff:.3g}, tol {rtol}); worst "
        f"leaf gradient |g - g_ref| / |g_ref| {worst:.3g} ({max(diffs, key=diffs.get)}; tol "
        f"{grad_rtol}); bitwise {bitwise}; launches {launches}")
    if not (math.isfinite(loss) and diff <= rtol and worst <= grad_rtol):
        _fail(f"parallel: {label} disagrees with its reference: loss {diff:.3g}, gradients "
              f"{diffs}")


def _seq_parallel_losses(params, tokens, base, mesh, log):
    """next_token_loss with attn_impl "ring" and "ulysses" on `mesh` against
    "full" without one, from the same params: {impl: launches}; fails past
    _check_loss_grads's tolerances."""
    import torch

    from ray_tpu_torch.models import transformer as tfm

    loss_full = tfm.next_token_loss(params, tokens, base)
    loss_full.backward()
    full = {name: t.grad for name, t in _named_leaves(params)}
    for t in tfm.tree_leaves(params):
        t.grad = None
    out = {}
    for impl in ("ring", "ulysses"):
        _zero_launch_counts()
        loss = tfm.next_token_loss(params, tokens, base.replace(attn_impl=impl), mesh)
        loss.backward()
        torch.cuda.synchronize()
        out[impl] = _launch_counts()
        _check_loss_grads(f"{impl} vs full", loss.item(), loss_full.item(),
                          {name: t.grad for name, t in _named_leaves(params)}, full, out[impl],
                          log)
        for t in tfm.tree_leaves(params):
            t.grad = None
    return out


def _parallel_nccl():
    """(a): llama2_7b(n_layers=2), bf16, remat "hot", b=1, s=2048 on a
    DeviceMesh with seq=1 over a NCCL group of one rank."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.parallel import build_device_mesh
    from ray_tpu_torch.train import backend

    backend.setup_torch_distributed(0, 1, backend.coordinator_address(
        backend.TorchBackendConfig()))
    try:
        mesh = build_device_mesh(axis_sizes={"seq": 1})
        base = tfm.llama2_7b(n_layers=2, dtype=torch.bfloat16, remat_policy="hot")
        tokens = torch.randint(0, base.vocab_size, (1, 2048), device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(5))
        params = tfm.init_params(base, torch.Generator(device="cuda").manual_seed(4))
        for t in tfm.tree_leaves(params):
            t.requires_grad_(True)
        _seq_parallel_losses(params, tokens, base, mesh, lambda msg: print(
            f"[parallel] (a) {dist.get_backend()} world 1, seq=1, llama2_7b width, 2 layers, bf16, "
            f"remat hot, b=1 s=2048: {msg}", flush=True))
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        secs, dropped = _moe_world1(build_device_mesh(axis_sizes={"expert": 1}))
        print(f"[parallel] (a) {dist.get_backend()} world 1, moe_apply at Switch-Base's width "
              f"({MOE_CFG}), {MOE_TOKENS} tokens fp32, forward + backward: bitwise equal to "
              f"mesh=None; {dropped} tokens dropped; {secs:.3f} s; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    finally:
        dist.destroy_process_group()


def _par_attention(rank, n, mesh):
    """(b) at Llama-2-7B's attention width: ring_attention and
    ulysses_attention on this rank's shard of a causal bf16 sequence, the
    output and dq/dk/dv for a fixed dO against one flash_attention call over
    the whole sequence, entry by entry; each call's launches, then a second
    call's seconds."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import ring_attention, ulysses_attention

    b, s, h, d = PAR_ATTN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(21)
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    mine = slice(rank * s // n, (rank + 1) * s // n)
    ref = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    fa.flash_attention(*ref, causal=True).backward(do)
    o_ref = fa.flash_attention(*(x.detach() for x in ref), causal=True)
    whole = {"o": o_ref, **{f"d{n_}": x.grad for n_, x in zip("qkv", ref)}}
    # each rank holds its part of the whole call's result, to the whole's rms
    want = {key: (t[:, mine], t.float().pow(2).mean().sqrt()) for key, t in whole.items()}
    out = {}
    for impl, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        secs = []
        for call in range(2):
            leaves = [x[:, mine].contiguous().requires_grad_() for x in (q, k, v)]
            dist.barrier()
            torch.cuda.synchronize()
            _zero_launch_counts()
            t0 = time.perf_counter()
            o = fn(*leaves, mesh, causal=True)
            o.backward(do[:, mine].contiguous())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if call == 0:
                launches = _launch_counts()
                got = {"o": o, **{f"d{n_}": x.grad for n_, x in zip("qkv", leaves)}}
                errs = {key: entry_err(got[key], *want[key]) for key in want}
                planted = {f"{key} {fault}": entry_err(bad, *want[key])
                           for key in ("o", "dk") for fault, bad in
                           _planted_faults(got[key]).items()}
        out[impl] = {"launches": launches, "errs": errs, "planted": planted, "s": secs}
    return out


def _par_model(rank, n, mesh_seq, mesh_stage):
    """(b) at model level, fp32 with TF32 off: llama2_7b(n_layers=2), b=1,
    s=2048, ring and Ulysses over seq=n against "full" on this rank; then
    next_token_loss_pipelined over stage=n on llama2_7b(n_layers=n) with
    PAR_MICROBATCHES microbatches against next_token_loss."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import transformer as tfm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lines = []
    base = tfm.llama2_7b(n_layers=2, dtype=torch.float32, remat_policy="hot")
    tokens = torch.randint(0, base.vocab_size, (1, PAR_SEQ),
                           generator=torch.Generator().manual_seed(3)).cuda()
    params = tfm.init_params(base, torch.Generator(device="cuda").manual_seed(2))
    for t in tfm.tree_leaves(params):
        t.requires_grad_(True)
    t0 = time.perf_counter()
    seq = _seq_parallel_losses(params, tokens, base, mesh_seq, lines.append)
    seq_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()

    cfg = tfm.llama2_7b(n_layers=n, dtype=torch.float32, remat_policy="hot")
    tokens = torch.randint(0, cfg.vocab_size, (PAR_MICROBATCHES, PAR_SEQ),
                           generator=torch.Generator().manual_seed(6)).cuda()
    params = tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(7))
    for t in tfm.tree_leaves(params):
        t.requires_grad_(True)
    _zero_launch_counts()
    t0 = time.perf_counter()
    loss = tfm.next_token_loss_pipelined(params, tokens, cfg, mesh_stage,
                                         num_microbatches=PAR_MICROBATCHES)
    loss.backward()
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    launches = _launch_counts()
    # the pipeline's gradients wait on the host while the reference runs,
    # one rank at a time (four at once would not fit the card)
    piped = {name: t.grad.cpu() for name, t in _named_leaves(params)}
    for t in tfm.tree_leaves(params):
        t.grad = None
    for turn in range(n):
        if turn == rank:
            loss_full = tfm.next_token_loss(params, tokens, cfg)
            loss_full.backward()
            torch.cuda.synchronize()
        dist.barrier()
    _check_loss_grads(f"pipeline over stage={n}, {PAR_MICROBATCHES} microbatches, vs "
                      "next_token_loss", loss.item(), loss_full.item(), piped,
                      {name: t.grad for name, t in _named_leaves(params)}, launches, lines.append)
    del params, piped
    torch.cuda.empty_cache()
    return {**seq, "pipeline": launches}, lines, {"seq_s": seq_s, "pipeline_s": pipe_s}


# (c): tensor parallelism at Llama-2-7B's width, 2 layers, on these meshes
# of the 4 ranks, and TP x SP on TP_SP_MESH.
TP_MESHES = {"tensor=4": {"tensor": 4}, "fsdp=2 x tensor=2": {"fsdp": 2, "tensor": 2}}
TP_SP_MESH = {"seq": 2, "tensor": 2}
TP_BATCH = (2, 2048)
TP_STEPS = 3
TP_LR = 1e-4
# (d): the Switch MoE layer at Switch-Base's expert width (Fedus et al. 2021,
# Table 9: d_model 768, d_ff 3072, 128 experts, capacity factor 1.25) on
# MOE_TOKENS tokens, fp32, experts over "expert" on the 4 ranks.
MOE_CFG = {"d_model": 768, "d_ff": 3072, "n_experts": 128, "capacity_factor": 1.25}
MOE_TOKENS = 8192
# JAX's TestMoE tolerances (rtol, atol), per entry: |got - want| <= atol +
# rtol |want|, for y and x's gradient (_moe_check).
MOE_TOL = (2e-4, 2e-5)


def _tp_cfg(dtype):
    import torch  # noqa: F401

    from ray_tpu_torch.models import transformer as tfm

    return tfm.llama2_7b(n_layers=2, dtype=dtype, remat_policy="hot")


def _tp_tokens(vocab: int):
    import torch

    return torch.randint(0, vocab, TP_BATCH, generator=torch.Generator().manual_seed(41)).cuda()


def _shard_diffs(got, want):
    """{leaf: |g - w| / |w|} of two {leaf: tensor} dicts."""
    return {name: ((g - want[name]).norm() / want[name].norm()).item() for name, g in got.items()}


def _check_shards(label, loss, loss_ref, got, want, launches, log, t):
    """Gates a loss and this rank's gradient shard of every leaf against the
    unsplit model's (loss 5e-5 relative, each leaf 1e-5 of its shard's
    norm, as _check_loss_grads), and refuses two planted faults: every
    shard t times too large (the row-parallel sum with psum's transpose
    upstream) and every shard moved by one entry."""
    import torch

    rtol, grad_rtol = 5e-5, 1e-5
    diffs = _shard_diffs(got, want)
    diff, worst = abs(loss - loss_ref) / abs(loss_ref), max(diffs.values())
    planted = {
        f"x{t}": max(_shard_diffs({k: g * t for k, g in got.items()}, want).values()),
        "moved": max(_shard_diffs({k: torch.roll(g.flatten(), 1).view_as(g)
                                   for k, g in got.items()}, want).values()),
    }
    log(f"{label}: loss {loss:.6f} vs {loss_ref:.6f} (rel diff {diff:.3g}, tol {rtol}); worst "
        f"leaf gradient shard |g - g_ref| / |g_ref| {worst:.3g} ({max(diffs, key=diffs.get)}; "
        f"tol {grad_rtol}); planted faults read {planted}; launches {launches}")
    if not (math.isfinite(loss) and diff <= rtol and worst <= grad_rtol):
        _fail(f"parallel: {label} disagrees with the unsplit model: loss {diff:.3g}, "
              f"gradients {diffs}")
    if min(planted.values()) <= grad_rtol:
        _fail(f"parallel: the {label} gradient check passes a planted fault: {planted}")


def _tp_reference(rank, n, cfg, tokens):
    """The unsplit model's TP_STEPS AdamW steps, one rank at a time (four at
    once would not fit the card beside the rest): (losses, {leaf: first
    step's gradient, on the host})."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import transformer as tfm

    for turn in range(n):
        if turn == rank:
            init, step = tfm.build_train_step(cfg, tfm.adamw(TP_LR), device="cuda")
            params, opt = init(torch.Generator(device="cuda").manual_seed(40))
            losses = [step(params, opt, tokens).item()]
            grads = {name: t.grad.cpu() for name, t in _named_leaves(params)}
            losses += [step(params, opt, tokens).item() for _ in range(TP_STEPS - 1)]
            del params, opt
            torch.cuda.empty_cache()
        dist.barrier()
    return losses, grads


def _tp_shards(params, mesh, full):
    """({leaf: this rank's gradient shard}, {leaf: the same shard of `full`})."""
    from ray_tpu_torch.parallel.sharding import local_shard, shard_slices, spec_of

    got, want = {}, {}
    for name, t in _named_leaves(params):
        got[name] = local_shard(t.grad)
        want[name] = full[name][shard_slices(tuple(t.shape), spec_of(t), mesh)].to(
            got[name].device)
    return got, want


def _par_tensor(rank, n, meshes, mesh_sp):
    """(c): llama2_7b(n_layers=2) at full width, fp32 with TF32 off, remat
    "hot", b x s = TP_BATCH. The unsplit model's 3 AdamW steps (one rank at a
    time); on each TP mesh, build_train_step on params from shard_tree:
    the first step's loss and this rank's gradient shard of every leaf
    against the unsplit model's, then the 3 steps' losses; on TP_SP_MESH,
    next_token_loss with ring and Ulysses against the same. Then in bf16 one
    forward and backward per TP mesh, with each kernel's launches. Returns
    ({path: launches}, log lines, seconds)."""
    import torch

    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.parallel import shard_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    lines, secs, launches = [], {}, {}
    cfg = _tp_cfg(torch.float32)
    tokens = _tp_tokens(cfg.vocab_size)
    ref_losses, ref_grads = _tp_reference(rank, n, cfg, tokens)
    for label, mesh in meshes.items():
        t_size = dict(zip(mesh.mesh_dim_names, mesh.shape))["tensor"]
        init, step = tfm.build_train_step(cfg, tfm.adamw(TP_LR), device="cuda", mesh=mesh)
        params, opt = init(torch.Generator(device="cuda").manual_seed(40))
        _zero_launch_counts()
        t0 = time.perf_counter()
        losses = [step(params, opt, tokens).item()]
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launched = _launch_counts()
        got, want = _tp_shards(params, mesh, ref_grads)
        _check_shards(f"fp32 {label}, first step", losses[0], ref_losses[0], got, want, launched,
                      lines.append, t_size)
        del got, want
        t0 = time.perf_counter()
        losses += [step(params, opt, tokens).item() for _ in range(TP_STEPS - 1)]
        torch.cuda.synchronize()
        secs[f"{label} first step"] = first_s
        secs[f"{label} next {TP_STEPS - 1} steps"] = time.perf_counter() - t0
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        lines.append(f"fp32 {label}: {TP_STEPS} AdamW steps' losses {losses} vs the unsplit "
                     f"model's {ref_losses} (rel diff {max(rel):.3g}, tol 5e-05)")
        if max(rel) > 5e-5:
            _fail(f"parallel: {label}'s AdamW trajectory {losses} departs from {ref_losses}")
        del params, opt
        torch.cuda.empty_cache()
    for impl in ("ring", "ulysses"):
        label = f"tensor=2 x seq=2 {impl}"
        params = shard_tree(tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(40)),
                            mesh_sp)
        for t in tfm.tree_leaves(params):
            t.requires_grad_(True)
        _zero_launch_counts()
        t0 = time.perf_counter()
        loss = tfm.next_token_loss(params, tokens, cfg.replace(attn_impl=impl), mesh_sp)
        loss.backward()
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        launches[label] = _launch_counts()
        got, want = _tp_shards(params, mesh_sp, ref_grads)
        _check_shards(f"fp32 {label}", loss.item(), ref_losses[0], got, want, launches[label],
                      lines.append, 2)
        del params, got, want, loss
        torch.cuda.empty_cache()
    del ref_grads
    bf16 = _tp_cfg(torch.bfloat16)
    for label, mesh in meshes.items():
        params = shard_tree(tfm.init_params(bf16, torch.Generator(device="cuda").manual_seed(40)),
                            mesh)
        for t in tfm.tree_leaves(params):
            t.requires_grad_(True)
        _zero_launch_counts()
        t0 = time.perf_counter()
        loss = tfm.next_token_loss(params, tokens, bf16, mesh)
        loss.backward()
        torch.cuda.synchronize()
        secs[f"bf16 {label}"] = time.perf_counter() - t0
        launches[label] = _launch_counts()
        lines.append(f"bf16 {label}, forward + backward: loss {loss.item():.6f}, launches "
                     f"{launches[label]}")
        if not math.isfinite(loss.item()):
            _fail(f"parallel: bf16 {label} loss {loss.item()}")
        del params, loss
        torch.cuda.empty_cache()
    return launches, lines, secs


def _moe_check(label, got, want, log):
    """Gates {name: result} against the unsplit layer's: y and x's gradient
    per entry at JAX's TestMoE tolerances (|got - want| <= atol + rtol
    |want|), the aux loss to 1e-6, and each param's gradient shard to 1e-5
    of its norm, as _check_shards holds the model's (a sum over 8192 tokens
    taken in four parts, where an entry that cancels to ~0 carries the fp32
    rounding of its terms). Each reading is scaled so that <= 1 passes. Two
    planted faults must be refused: every result twice too large, and every
    result moved by one entry."""
    import torch

    rtol, atol = MOE_TOL

    def readings(results):
        out = {}
        for k, g in results.items():
            if k == "aux":
                out[k] = abs(g - want[k]) / 1e-6
            elif k.startswith("dw") or k == "drouter":
                out[k] = ((g - want[k]).norm() / want[k].norm()).item() / 1e-5
            else:
                out[k] = ((g - want[k]).abs() / (atol + rtol * want[k].abs())).max().item()
        return out

    errs = readings(got)
    planted = {"x2": max(readings({k: g * 2 for k, g in got.items()}).values()),
               "moved": max(readings({k: torch.roll(g.flatten(), 1).view_as(g) if k != "aux"
                                      else g for k, g in got.items()}).values())}
    log(f"{label}: y and dx per entry |got - ref| / ({atol} + {rtol} |ref|), aux |got - ref| / "
        "1e-6, each param gradient shard |g - g_ref| / |g_ref| / 1e-5 (<= 1 passes): "
        + "; ".join(f"{k} {e:.3g}" for k, e in errs.items()) + f"; planted faults read {planted}")
    if not all(math.isfinite(e) and e <= 1 for e in errs.values()):
        _fail(f"parallel: {label} disagrees with the unsplit layer: {errs}")
    if min(planted.values()) <= 1:
        _fail(f"parallel: the {label} check passes a planted fault: {planted}")


def _moe_inputs(cfg):
    """Switch-Base's params, MOE_TOKENS tokens and the loss weights w, fp32,
    on the card from seeds."""
    import torch

    from ray_tpu_torch.models import moe

    gen = torch.Generator(device="cuda").manual_seed(31)
    x, w = (torch.randn((MOE_TOKENS, cfg.d_model), generator=gen, device="cuda")
            for _ in range(2))
    return moe.init_moe_params(cfg, torch.Generator(device="cuda").manual_seed(30)), x, w


def _moe_dropped(params, x, cfg) -> int:
    """Tokens past their expert's capacity, counted from the routing."""
    import torch

    idx = torch.argmax(x @ params["router"], dim=-1)
    cap = max(1, int(cfg.capacity_factor * x.shape[0] / cfg.n_experts))
    return int((torch.bincount(idx, minlength=cfg.n_experts) - cap).clamp_min(0).sum())


def _par_moe(rank, n, mesh):
    """(d): moe_apply at Switch-Base's width with the experts over
    "expert"=n (each rank 1/n of the tokens and of the experts) against the
    unsplit layer, run by each rank in turn: this rank's rows of y and of
    x's gradient, the aux loss, and its shard of each param's gradient, for
    sum(y * w) + aux. Returns (log lines, seconds, dropped tokens)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import moe
    from ray_tpu_torch.parallel import TRANSFORMER_RULES, shard_tree
    from ray_tpu_torch.parallel.sharding import local_shard, shard_slices, spec_of

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = moe.MoEConfig(**MOE_CFG)
    full, x, w = _moe_inputs(cfg)
    rows = slice(rank * MOE_TOKENS // n, (rank + 1) * MOE_TOKENS // n)
    params = shard_tree({"moe": full}, mesh, moe.EXPERT_RULES + TRANSFORMER_RULES)["moe"]
    want = {}
    for turn in range(n):
        if turn == rank:
            p = {k: v.clone().requires_grad_() for k, v in full.items()}
            xr = x.clone().requires_grad_()
            y, aux = moe.moe_apply(p, xr, cfg)
            ((y * w).sum() + aux).backward()
            want = {"y": y[rows].detach(), "aux": aux.item(), "dx": xr.grad[rows]}
            for k, t in params.items():
                want[f"d{k}"] = p[k].grad[shard_slices(tuple(t.shape), spec_of(t), mesh)]
            del p, xr, y
            torch.cuda.empty_cache()
        dist.barrier()
    for t in params.values():
        t.requires_grad_(True)
    xl = x[rows].clone().requires_grad_()
    secs = []
    for call in range(2):
        for t in (xl, *params.values()):
            t.grad = None
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = moe.moe_apply(params, xl, cfg, mesh=mesh)
        ((y * w[rows]).sum() + aux).backward()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    got = {"y": y.detach(), "aux": aux.item(), "dx": xl.grad,
           **{f"d{k}": local_shard(t.grad) for k, t in params.items()}}
    lines = []
    _moe_check(f"expert={n}, {MOE_TOKENS} tokens ({MOE_TOKENS // n} per rank), "
               f"{cfg.n_experts // n} of {cfg.n_experts} experts per rank", got, want, lines.append)
    return lines, secs, _moe_dropped(full, x, cfg)


def _moe_world1(mesh):
    """(a)'s MoE part: moe_apply forward and backward at Switch-Base's width
    over a mesh of one rank against mesh=None, bitwise; (seconds, dropped
    tokens)."""
    import torch

    from ray_tpu_torch.models import moe

    cfg = moe.MoEConfig(**MOE_CFG)
    full, x, w = _moe_inputs(cfg)
    out, secs = [], []
    for m in (None, mesh):
        p = {k: v.clone().requires_grad_() for k, v in full.items()}
        xr = x.clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = moe.moe_apply(p, xr, cfg, mesh=m)
        ((y * w).sum() + aux).backward()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        out.append([y, aux, xr.grad, *(p[k].grad for k in ("router", "w_up", "w_down"))])
    if not all(torch.equal(a, b) for a, b in zip(*out)) or not torch.isfinite(out[1][0]).all():
        _fail("parallel: moe_apply over a one-rank mesh differs from moe_apply without one")
    return secs[1], _moe_dropped(full, x, cfg)


def _parallel_rank(rank: int, world: int, url: str, out_path: str) -> None:
    """One rank of (b): joins the gloo group, runs _par_attention and
    _par_model, and writes its results as JSON to out_path."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import build_device_mesh
    from ray_tpu_torch.train import backend

    torch.cuda.set_device(0)
    backend.setup_torch_distributed(rank, world, url, backend="gloo", init_timeout_s=300)
    try:
        t0 = time.perf_counter()
        # every rank builds every mesh (and its groups) in one order, first
        mesh_seq = build_device_mesh(axis_sizes={"seq": world})
        mesh_stage = build_device_mesh(axis_sizes={"stage": world})
        tp_meshes = {label: build_device_mesh(axis_sizes=axes) for label, axes in TP_MESHES.items()}
        mesh_sp = build_device_mesh(axis_sizes=TP_SP_MESH)
        mesh_expert = build_device_mesh(axis_sizes={"expert": world})
        attention = _par_attention(rank, world, mesh_seq)
        torch.cuda.empty_cache()
        launches, lines, secs = _par_model(rank, world, mesh_seq, mesh_stage)
        peak_b = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        tp_launches, tp_lines, tp_secs = _par_tensor(rank, world, tp_meshes, mesh_sp)
        peak_c = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        t2 = time.perf_counter()
        moe_lines, moe_secs, dropped = _par_moe(rank, world, mesh_expert)
        result = {"attention": attention, "launches": {**launches, **tp_launches},
                  "lines": lines, "tp_lines": tp_lines, "moe_lines": moe_lines,
                  "secs": {**secs, "rank_s": time.perf_counter() - t0},
                  "tp_secs": {**tp_secs, "part_s": t2 - t1},
                  "moe": {"s": moe_secs, "part_s": time.perf_counter() - t2,
                          "dropped": dropped},
                  "peak_gib": {"b": peak_b, "c": peak_c,
                               "d": torch.cuda.max_memory_allocated() / 2**30}}
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(result, f)


def _run_ranks(world: int, tmp: str):
    """Starts `world` processes of this script as ranks of (b), waits for all
    of them (any failure or the deadline stops every one) and returns their
    results."""
    url = f"file://{tmp}/rendezvous"
    logs = [open(f"{tmp}/rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank",
                               str(r), str(world), url, f"{tmp}/rank{r}.json"],
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + PARALLEL_TIMEOUT_S
    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
            elif time.monotonic() > deadline:
                failed = f"no result within {PARALLEL_TIMEOUT_S} s"
            else:
                time.sleep(0.5)
        if failed is None and any(p.returncode != 0 for p in procs):
            failed = "a rank exited non-zero"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    if failed:
        for r in range(world):
            with open(f"{tmp}/rank{r}.log") as f:
                print(f"[parallel] rank {r} log (end):\n{f.read()[-3000:]}", flush=True)
        _fail(f"parallel: {failed}")
    results = []
    for r in range(world):
        with open(f"{tmp}/rank{r}.json") as f:
            results.append(json.load(f))
    return results


def _sum_launches(counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def phase_parallel():
    """(a) ring and Ulysses at seq=1, and the MoE, over a NCCL world of one
    rank; (b) PARALLEL_WORLD ranks sharing the card over gloo (collectives
    staged through host memory): ring and Ulysses attention at Llama-2-7B's
    width against one flash_attention call, then ring and Ulysses in the
    model and the GPipe pipeline against the unsplit model; (c) tensor
    parallelism and TP x SP (_par_tensor); (d) the MoE over expert=4
    (_par_moe). Returns the model paths' launches, summed over the ranks."""
    import tempfile

    t0 = time.perf_counter()
    _parallel_nccl()
    print(f"[parallel] (a) {time.perf_counter() - t0:.1f} s", flush=True)
    n = PARALLEL_WORLD
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        results = _run_ranks(n, tmp)
    phase_s = time.perf_counter() - t0
    b, s, h, d = PAR_ATTN_SHAPE
    blocks = {"ring": n * (n + 1) // 2, "ulysses": n}
    for impl, per_call in blocks.items():
        tol = PAR_TOL[impl]
        launches = _sum_launches([r["attention"][impl]["launches"] for r in results])
        errs = {key: max(r["attention"][impl]["errs"][key] for r in results)
                for key in results[0]["attention"][impl]["errs"]}
        # each rank plants the faults in its part: the whole tensor's reading
        # is the largest over the ranks
        planted = {key: max(r["attention"][impl]["planted"][key] for r in results)
                   for key in results[0]["attention"][impl]["planted"]}
        secs = [r["attention"][impl]["s"] for r in results]
        print(f"[parallel] (b) {impl}_attention, {n} ranks over gloo, b={b} s={s} (per rank "
              f"{s // n}) h={h} d={d} bf16 causal, vs one flash_attention over the whole "
              "sequence: max |err| / (|ref| + rms(ref)) over ranks "
              + "; ".join(f"{k} {e:.3g}" for k, e in errs.items()) + f" (tol {tol}); planted "
              "faults read " + "; ".join(f"{k} {e:.3g}" for k, e in planted.items())
              + "; launches "
              f"across ranks {launches} (want {per_call} of each); seconds per rank, first and "
              f"second call, forward + backward {secs}", flush=True)
        if not all(math.isfinite(e) and e <= tol for e in errs.values()):
            _fail(f"parallel: {impl}_attention disagrees with flash_attention: {errs}")
        if min(planted.values()) <= tol:
            _fail(f"parallel: the {impl}_attention check passes a planted fault: {planted}")
        if launches != {k: per_call for k in launches}:
            _fail(f"parallel: {impl}_attention launched {launches}, want {per_call} of each")
    for r, res in enumerate(results):
        for line in res["lines"]:
            print(f"[parallel] (b) rank {r}, fp32 model: {line}", flush=True)
    for r, res in enumerate(results):
        for line in res["tp_lines"]:
            print(f"[parallel] (c) rank {r}, llama2_7b(n_layers=2) b x s {TP_BATCH}, remat hot: "
                  f"{line}", flush=True)
    for r, res in enumerate(results):
        for line in res["moe_lines"]:
            print(f"[parallel] (d) rank {r}, moe_apply {MOE_CFG} fp32: {line}", flush=True)
    paths = ("ring", "ulysses", "pipeline", *TP_MESHES, "tensor=2 x seq=2 ring",
             "tensor=2 x seq=2 ulysses")
    by_path = {path: _sum_launches([r["launches"][path] for r in results]) for path in paths}
    layers = 2
    # ring at seq=2: 1 + 2 blocks per seq group, one group per tensor rank
    sp_ring = layers * 3 * TP_SP_MESH["tensor"]
    want = {"ring": {k: layers * blocks["ring"] for k in by_path["ring"]},
            "ulysses": {k: layers * blocks["ulysses"] for k in by_path["ulysses"]},
            # one layer per stage; remat recomputes each microbatch's forward
            "pipeline": {"flash_fwd": 2 * n * PAR_MICROBATCHES,
                         "flash_bwd_dq": n * PAR_MICROBATCHES,
                         "flash_bwd_dkv": n * PAR_MICROBATCHES},
            # "hot" keeps the flash output: one launch of each per layer per rank
            **{label: {k: layers * n for k in by_path[label]} for label in TP_MESHES},
            "tensor=2 x seq=2 ring": {k: sp_ring for k in by_path["ring"]},
            "tensor=2 x seq=2 ulysses": {k: layers * n for k in by_path["ring"]}}
    print(f"[parallel] (b)-(c) model paths' launches across ranks {by_path}", flush=True)
    if by_path != want:
        _fail(f"parallel: model launches {by_path}, want {want}")
    print(f"[parallel] (d) tokens dropped by the capacity: {results[0]['moe']['dropped']} of "
          f"{MOE_TOKENS}; seconds per rank, first and second call, forward + backward "
          f"{[[round(x, 3) for x in r['moe']['s']] for r in results]}", flush=True)
    print(f"[parallel] (b)-(d) {n} processes sharing one {_smi()} over gloo (not multi-GPU "
          f"speed): peak memory per rank GiB "
          f"{[{k: round(v, 3) for k, v in r['peak_gib'].items()} for r in results]}; seconds "
          f"per rank (b) {[{k: round(v, 1) for k, v in r['secs'].items()} for r in results]}, "
          f"(c) {[{k: round(v, 1) for k, v in r['tp_secs'].items()} for r in results]}, "
          f"(d) {[round(r['moe']['part_s'], 1) for r in results]}; phase {phase_s:.1f} s",
          flush=True)
    return by_path


# ------------------------------------------------------------------ cluster

CLUSTER_TENSOR = (4096, 11008)  # Llama-2-7B's w_up
CLUSTER_SERVE_SHAPE = (1, 1024, 32, 128)  # b, s, heads, head_dim: the serve phase's
CLUSTER_STEPS = 4
CLUSTER_DATA_STEPS = 3
CLUSTER_HOST_CALLS = 1000
CLUSTER_TIMEOUT_S = 300


def _cluster_gpu_task():
    """What a num_gpus=1 task sees from inside its worker process, and
    whether torch calls its fork bad (a fork after CUDA was initialised in
    the parent)."""
    import torch

    return (os.environ.get("CUDA_VISIBLE_DEVICES"), torch.cuda.device_count(),
            torch.cuda.get_device_name(0), os.getpid(), os.getppid(),
            torch.cuda._is_in_bad_fork())


def _compute_app_pids():
    """The pids nvidia-smi lists as the card's compute processes (in a
    container whose pid namespace nvidia-smi cannot see into, not ours)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return [int(p) for p in out.split()]


def _nvidia_fds(pid: int) -> int:
    """How many of a process's open files are NVIDIA device nodes: a CUDA
    context holds /dev/nvidiactl, /dev/nvidia<N> and /dev/nvidia-uvm open."""
    n = 0
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            n += os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia")
        except OSError:
            pass
    return n


class _Barrier:
    """Releases its callers once `n` have arrived (max_concurrency >= n)."""

    def __init__(self, n: int):
        import threading

        self.n, self.count, self.cv = n, 0, threading.Condition()

    def arrive(self) -> bool:
        with self.cv:
            self.count += 1
            self.cv.notify_all()
            return self.cv.wait_for(lambda: self.count >= self.n, timeout=120)


def _cluster_half_gpu_task(barrier):
    """A num_gpus=0.5 task: meets the other one at the barrier, so both hold
    their share at once; returns the device ids it sees."""
    import ray_tpu_torch as rt

    met = rt.get(barrier.arrive.remote(), timeout=150)
    return os.environ.get("CUDA_VISIBLE_DEVICES"), met, os.getpid()


def _cluster_echo(x):
    """Returns the tensor it was given, with where it arrived."""
    return x, str(x.device), str(x.dtype)


def _cluster_noop():
    return None


def _cluster_node_echo(x):
    """Part (d)'s GPU task: the tensor it was given, where it arrived, and
    the node and pid it ran in."""
    import ray_tpu_torch as rt

    return x, str(x.device), rt.get_runtime_context().get_node_id(), os.getpid()


def _cluster_tcp(smi):
    """Part (d): a head that other hosts can join, on tcp://127.0.0.1:0 with
    an auth token, and a worker node joined through start_worker_node with
    only that address (its own session dir and pool; the GPU is on it, none
    on the head). This process is a remote client (init(address=)): the
    86 MiB bf16 tensor goes through its put, a num_gpus=1 task on the joined
    node and its get, bitwise; a connection without the token is refused.
    No process and no pool of either node may outlive the shutdown."""
    import glob
    import secrets

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.cluster_runtime import Cluster, start_worker_node
    from ray_tpu_torch.core.rpc import RpcClient

    os.environ["RAY_TPU_AUTH_TOKEN"] = secrets.token_hex(16)
    joined = head = None
    try:
        t0 = time.perf_counter()
        head = Cluster(num_gpus=0, head_port=0)
        head_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        joined = start_worker_node(head.gcs_tcp_address)
        join_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rt.init(address=head.gcs_tcp_address)
        attach_s = time.perf_counter() - t0
        try:
            gen = torch.Generator(device="cuda").manual_seed(0)
            w_up = torch.randn(CLUSTER_TENSOR, generator=gen, device="cuda").to(torch.bfloat16)
            task = rt.remote(num_gpus=1)(_cluster_node_echo)
            rounds, same = [], True
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = rt.put(w_up)
                put_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                back_ref = task.remote(ref)
                back, where, node, pid = rt.get(back_ref, timeout=CLUSTER_TIMEOUT_S)
                torch.cuda.synchronize()
                trip_s = time.perf_counter() - t0
                same = same and where == "cuda:0" and node == joined["node_id"] and torch.equal(
                    back.view(torch.int16), w_up.view(torch.int16))
                rounds.append(f"put {put_s:.3f} s, through the task on node {node[:8]} (pid "
                              f"{pid}, arrived on {where}) and get {trip_s:.3f} s")
                del ref, back_ref, back
            token = os.environ["RAY_TPU_AUTH_TOKEN"]
            os.environ["RAY_TPU_AUTH_TOKEN"] = "not-the-token"
            try:
                RpcClient(head.gcs_tcp_address, connect_timeout=5.0).call("ping", timeout=5.0)
                refused = False
            except (ConnectionError, OSError):
                refused = True
            finally:
                os.environ["RAY_TPU_AUTH_TOKEN"] = token
        finally:
            rt.shutdown()
    finally:
        t0 = time.perf_counter()
        if joined is not None:
            joined["shutdown"]()
        if head is not None:
            head.shutdown()
        down_s = time.perf_counter() - t0
        os.environ.pop("RAY_TPU_AUTH_TOKEN", None)
    left = [p for d in (head.session_dir, joined["session_dir"]) for p in _cluster_processes(d)]
    pools = [p for d in (head.session_dir, joined["session_dir"])
             for p in glob.glob(f"/dev/shm/rtpt_{os.path.basename(d)}*")]
    print(f"[cluster] (d) {smi}: a head on {head.gcs_tcp_address} with a token in "
          f"{head_s:.2f} s, a worker node joined over TCP in {join_s:.2f} s, this process "
          f"attached as a remote client in {attach_s:.2f} s; bf16 {CLUSTER_TENSOR} first / "
          f"second: {' / '.join(rounds)}; bitwise on the joined node's GPU and back {same}; "
          f"a connection without the token refused {refused}; shutdown {down_s:.2f} s, "
          f"processes left {left}, pools left {sorted(pools)}", flush=True)
    if not same:
        _fail("cluster: over TCP the tensor did not come back bitwise from the joined node")
    if not refused:
        _fail("cluster: the head's TCP port served a connection without the token")
    if left or pools:
        _fail("cluster: processes or pools of the TCP cluster outlived its shutdown")


class _FlashActor:
    """An actor in a worker process that runs flash_attention at the serve
    shape and holds K1 against its plain version."""

    def ping(self):
        return None

    def check(self, shape):
        import torch

        from ray_tpu_torch.ops import flash_attention as fa

        b, s, h, d = shape
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        _zero_launch_counts()
        o = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        launches = _launch_counts()
        o_ref, _ = fa.reference_flash_fwd(q, k, v, causal=True, scale=d ** -0.5)
        return {"err": entry_err(o, o_ref), "max_abs": (o.float() - o_ref.float()).abs().max().item(),
                "launches": launches, "pid": os.getpid(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


def _cluster_loop(config):
    """Part (b)'s loop: the fit phase's model and batches, deterministic, on
    this worker's current CUDA device; one report per step, then a last one
    with the losses, report times, params_sha256 and kernel launches."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import transformer as tfm

    torch.use_deterministic_algorithms(True)
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = _fit_cfg()
    init, step = tfm.build_train_step(cfg, tfm.adamw(config["lr"]), device=device)
    params, opt = init(torch.Generator(device=device).manual_seed(0))
    _zero_launch_counts()
    losses, times = [], []
    for i in range(config["steps"]):
        loss = step(params, opt, _fit_batch(i, cfg.vocab_size)).item()
        losses.append(loss)
        times.append(time.perf_counter())
        train.report({"step": i, "loss": loss})
    train.report({"step": config["steps"], "losses": losses, "report_t": times,
                  "launches": _launch_counts(), "params_sha256": _params_sha256(params),
                  "pid": os.getpid(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                  "backend": (torch.distributed.get_backend()
                              if torch.distributed.is_initialized() else None)})


def _cluster_data_cfg():
    import torch

    from ray_tpu_torch.models import transformer as tfm

    return tfm.llama2_7b(n_layers=2, dtype=torch.float32, remat_policy="hot")


def _cluster_data_batch(step: int, vocab: int):
    """Step i's global batch of part (c): 2 rows, seeded 2i and 2i + 1."""
    import torch

    return torch.cat([_fit_batch(2 * step + r, vocab) for r in range(2)])


def _host_leaves(params):
    """Every leaf's local tensor (the whole leaf under a data-only mesh),
    copied to the host, in convert.flatten's order."""
    from ray_tpu_torch.models.convert import flatten
    from ray_tpu_torch.parallel.sharding import local_shard

    return [local_shard(t).detach().cpu() for t in flatten(params)[1]]


def _leaf_rel_diffs(got, want):
    """||got - want|| / ||want|| for each leaf."""
    return [((g.double() - w.double()).norm() / w.double().norm().clamp_min(1e-30)).item()
            for g, w in zip(got, want)]


def _cluster_data_loop(config):
    """Part (c)'s loop, one rank of a gloo world sharing the card: fp32 with
    TF32 off, deterministic; 3 AdamW steps of the plain data-parallel step on
    the global batch, then 3 of ZeRO-1 over "data" on this rank's row from
    the same init. Rank 0 saves the plain run's final params to
    config["out"]. Reports losses, launches, peak memory, and how far the
    ZeRO run's params are from the plain run's."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import transformer as tfm

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = train.get_mesh()
    rank = train.get_context().get_world_rank()
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = _cluster_data_cfg()
    out = {"rank": rank, "pid": os.getpid(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "backend": torch.distributed.get_backend(), "mesh": str(mesh)}
    leaves = {}
    for mode in ("plain", "zero"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        kw = {"zero_axis": "data"} if mode == "zero" else {}
        init, step = tfm.build_train_step(cfg, tfm.adamw(config["lr"]), device=device,
                                          mesh=mesh, **kw)
        params, opt = init(torch.Generator(device=device).manual_seed(0))
        _zero_launch_counts()
        losses = []
        t0 = time.perf_counter()
        for i in range(config["steps"]):
            batch = _cluster_data_batch(i, cfg.vocab_size)
            losses.append(step(params, opt, batch[rank:rank + 1] if mode == "zero" else batch)
                          .item())
        out[mode] = {"losses": losses, "launches": _launch_counts(),
                     "s": time.perf_counter() - t0,
                     "peak_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30}
        leaves[mode] = _host_leaves(params)
        del params, opt, init, step
    if rank == 0:
        torch.save(leaves["plain"], config["out"])
    diffs = _leaf_rel_diffs(leaves["zero"], leaves["plain"])
    worst = max(range(len(diffs)), key=diffs.__getitem__)
    out["zero_bitwise"] = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                              for a, b in zip(leaves["zero"], leaves["plain"]))
    out["zero_worst"] = (worst, diffs[worst])
    train.report(out)


def _cluster_reference_data(n_steps: int = CLUSTER_DATA_STEPS, make_cfg=None):
    """Part (c)'s reference: one fp32 process (this one) on the same global
    batches, `n_steps` AdamW steps of `make_cfg()` (part (c)'s config unless
    given): losses, final params on the host and their key paths."""
    import torch

    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.models.convert import flatten

    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = (make_cfg or _cluster_data_cfg)()
        init, step = tfm.build_train_step(cfg, tfm.adamw(1e-4), device="cuda")
        params, opt = init(torch.Generator(device="cuda").manual_seed(0))
        losses = [step(params, opt, _cluster_data_batch(i, cfg.vocab_size)).item()
                  for i in range(n_steps)]
        leaves = _host_leaves(params)
        paths = flatten(params)[0]
        del params, opt
        torch.cuda.empty_cache()
        return losses, leaves, paths
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def _report_p50(metrics) -> float:
    import statistics

    t = metrics["report_t"]
    return statistics.median((t[i] - t[i - 1]) * 1e3 for i in range(1, len(t)))


def _cluster_processes(session_dir):
    """pids of the processes of one cluster: its GCS, raylets and workers,
    each of which names a socket in the session dir on its command line."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if "ray_tpu_torch.core." in cmd and session_dir in cmd:
            out.append(int(pid))
    return out


def phase_cluster():
    """The cluster runtime on the card (init() with no arguments: a GCS, a
    raylet and worker processes). (a) the GPU manager's resources, a
    num_gpus=1 task's CUDA_VISIBLE_DEVICES and device name, two num_gpus=0.5
    tasks held at once by a barrier actor on one device id, a bf16 CUDA
    tensor of Llama-2-7B's w_up shape through put, a GPU task and get
    (bitwise), flash_attention at the serve shape in an actor's process
    against its plain version, and host rates of no-op tasks and actor
    calls; (b) TorchTrainer with one worker process over NCCL, the fit
    phase's model, 4 steps, bitwise equal to the in-process TorchTrainer and
    to build_train_step driven directly, K1/K2/K3 8 / 8 / 8 in the worker;
    (c) two worker processes sharing the card over gloo, MeshSpec(data=2),
    fp32, 3 AdamW steps against one fp32 process, then ZeRO-1 over "data"
    against the plain two-rank run. Every process of the cluster and every
    /dev/shm/rtpt_* file must be gone after its shutdown. Returns the
    launches of each path."""
    import glob
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.train import (RunConfig, ScalingConfig, TorchBackendConfig,
                                     TorchTrainer)
    from ray_tpu_torch.core.runtime_base import current_runtime
    from ray_tpu_torch.parallel.mesh import MeshSpec

    phase_t0 = time.perf_counter()
    smi = _smi()
    name = torch.cuda.get_device_name(0)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-cluster-")
    launches = {}
    try:
        # References, in this process: build_train_step driven directly and
        # the in-process TorchTrainer (part b), and one fp32 process (part c).
        cfg = {"lr": 1e-4, "steps": CLUSTER_STEPS}
        with _deterministic():
            direct_losses, direct_ms, direct_sha = _direct_run(1e-4, CLUSTER_STEPS)
            rt.init(local_mode=True)
            try:
                local = TorchTrainer(
                    _cluster_loop, train_loop_config=cfg,
                    scaling_config=ScalingConfig(num_workers=1, resources_per_worker={"GPU": 1}),
                    run_config=RunConfig(name="cluster_local", storage_path=tmp)).fit()
            finally:
                rt.shutdown()
            ref_losses, ref_leaves, _ = _cluster_reference_data()
        if local.error is not None:
            _fail(f"cluster: the in-process trainer failed: {local.error!r}")
        torch.cuda.empty_cache()

        # Workers inherit the driver's environment: cuBLAS's workspace
        # setting makes their deterministic algorithms usable.
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        t0 = time.perf_counter()
        rt.init()
        boot_s = time.perf_counter() - t0
        runtime = current_runtime()
        session_dir = runtime._cluster.session_dir
        # This cluster's pools and its driver's lock file.
        ours = f"/dev/shm/rtpt_{os.path.basename(session_dir)}"
        try:
            res = rt.cluster_resources()
            # The raylet boots its zygote (an interpreter that imports the
            # worker stack and torch) beside init(): the first launch forks
            # a parked child once it is up.
            deadline = time.monotonic() + CLUSTER_TIMEOUT_S
            while not ((pool := runtime._raylet.call("debug_state")["pool"])["zygote_alive"]
                       and pool["preforked"] >= 1):
                if time.monotonic() > deadline:
                    _fail(f"cluster: the zygote never parked a child: {pool}")
                time.sleep(0.01)
            ready_s = time.perf_counter() - t0
            zygote = pool["zygote_pid"]
            print(f"[cluster] {smi}: init() {boot_s:.2f} s, the zygote up with "
                  f"{pool['preforked']} children parked {ready_s:.2f} s after init() began; "
                  f"cluster_resources {res}", flush=True)
            if res.get("GPU") != 1.0:
                _fail(f"cluster: cluster_resources()['GPU'] is {res.get('GPU')}, want 1.0")

            # (a) device leases
            gpu_task = rt.remote(num_gpus=1)(_cluster_gpu_task)
            t0 = time.perf_counter()
            visible, count, dev_name, pid, ppid, bad_fork = rt.get(gpu_task.remote(),
                                                                    timeout=CLUSTER_TIMEOUT_S)
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            rt.get(gpu_task.remote(), timeout=CLUSTER_TIMEOUT_S)
            again_s = time.perf_counter() - t0
            pool = runtime._raylet.call("debug_state")["pool"]
            zstats = runtime._raylet.call("zygote_stats")
            apps = _compute_app_pids()
            fds = {"zygote": _nvidia_fds(zygote), "task's worker": _nvidia_fds(pid)}
            print(f"[cluster] (a) num_gpus=1 task in pid {pid}, forked by the zygote (pid "
                  f"{zygote}, the task's parent {ppid}; driver {os.getpid()}): "
                  f"CUDA_VISIBLE_DEVICES={visible!r}, {count} device(s), {dev_name}, bad fork "
                  f"{bad_fork}; {first_s:.3f} s on a parked child (its CUDA context; PR 10 "
                  f"took 5.59 s to Popen one), {again_s * 1e3:.1f} ms again; pool hits "
                  f"{pool['hits']}, misses {pool['misses']}; the card's compute processes "
                  f"{apps}, the zygote among them {zygote in apps}, CUDA initialised in the "
                  f"zygote {zstats.get('cuda_initialized')}, open /dev/nvidia* files {fds}",
                  flush=True)
            if visible != "0" or count != 1 or dev_name != name or pid == os.getpid():
                _fail("cluster: the num_gpus=1 task does not see exactly device 0")
            if ppid != zygote or bad_fork or pool["hits"]["prefork"] < 1:
                _fail("cluster: the num_gpus=1 task's worker is not a zygote child in a good fork")
            if zygote in apps or zstats.get("cuda_initialized") is not False \
                    or fds["zygote"] or not fds["task's worker"]:
                _fail("cluster: the zygote holds a CUDA context (or the check cannot see one)")
            barrier = rt.remote(max_concurrency=2)(_Barrier).remote(2)
            half = rt.remote(num_gpus=0.5)(_cluster_half_gpu_task)
            t0 = time.perf_counter()
            halves = rt.get([half.remote(barrier), half.remote(barrier)],
                            timeout=CLUSTER_TIMEOUT_S)
            print(f"[cluster] (a) two num_gpus=0.5 tasks held together by a barrier actor: "
                  f"{halves} in {time.perf_counter() - t0:.2f} s", flush=True)
            if [h[:2] for h in halves] != [("0", True), ("0", True)] \
                    or halves[0][2] == halves[1][2]:
                _fail("cluster: the two half-GPU tasks did not share device 0 at once")
            rt.kill(barrier)

            # (a) a bf16 CUDA tensor through the object store, twice: the
            # first put touches fresh pool pages, the first GPU task that
            # gets a tensor imports torch in its worker.
            gen = torch.Generator(device="cuda").manual_seed(0)
            w_up = torch.randn(CLUSTER_TENSOR, generator=gen, device="cuda").to(torch.bfloat16)
            nbytes = w_up.numel() * w_up.element_size()
            echo = rt.remote(num_gpus=1)(_cluster_echo)
            same, rounds = True, []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = rt.put(w_up)
                put_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                got = rt.get(ref)
                torch.cuda.synchronize()
                get_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                back, where, dtype = rt.get(echo.remote(ref), timeout=CLUSTER_TIMEOUT_S)
                torch.cuda.synchronize()
                trip_s = time.perf_counter() - t0
                same = same and back.device.type == "cuda" and where == "cuda:0" and all(
                    torch.equal(x.view(torch.int16), w_up.view(torch.int16)) for x in (got, back))
                rounds.append(f"put {put_s:.4f} s ({nbytes / put_s / 1e9:.2f} GB/s), get "
                              f"{get_s:.4f} s ({nbytes / get_s / 1e9:.2f} GB/s), into a GPU task "
                              f"(arrived on {where}, {dtype}) and back {trip_s:.4f} s")
                del ref, got, back
            print(f"[cluster] (a) bf16 {CLUSTER_TENSOR} ({nbytes / 2**20:.1f} MiB) on the card, "
                  f"first / second: {' / '.join(rounds)}; bitwise equal on the card {same}",
                  flush=True)
            if not same:
                _fail("cluster: the bf16 CUDA tensor did not come back bitwise equal on the card")
            del w_up

            # (a) K1 in an actor's process
            actor = rt.remote(num_gpus=1)(_FlashActor).remote()
            chk = rt.get(actor.check.remote(CLUSTER_SERVE_SHAPE), timeout=CLUSTER_TIMEOUT_S)
            tol = FWD_TOL["bfloat16"][0]
            print(f"[cluster] (a) flash_attention in an actor (pid {chk['pid']}, "
                  f"CUDA_VISIBLE_DEVICES={chk['visible']!r}) at b, s, h, d "
                  f"{CLUSTER_SERVE_SHAPE} bf16 causal: max |err| / (|ref| + rms(ref)) "
                  f"{chk['err']:.3g} (max abs {chk['max_abs']:.3g}; tol {tol:.3g}), launches "
                  f"{chk['launches']}", flush=True)
            want = {"flash_fwd": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
            if not (math.isfinite(chk["err"]) and chk["err"] <= tol) or chk["launches"] != want:
                _fail("cluster: flash_attention in the actor's process failed its check")
            launches["cluster actor"] = chk["launches"]
            rt.kill(actor)

            # (a) host rates
            noop = rt.remote(_cluster_noop)
            rt.get([noop.remote() for _ in range(10)], timeout=CLUSTER_TIMEOUT_S)
            t0 = time.perf_counter()
            rt.get([noop.remote() for _ in range(CLUSTER_HOST_CALLS)], timeout=CLUSTER_TIMEOUT_S)
            task_rate = CLUSTER_HOST_CALLS / (time.perf_counter() - t0)
            pinger = rt.remote(_FlashActor).remote()
            rt.get(pinger.ping.remote(), timeout=CLUSTER_TIMEOUT_S)
            t0 = time.perf_counter()
            rt.get([pinger.ping.remote() for _ in range(CLUSTER_HOST_CALLS)],
                   timeout=CLUSTER_TIMEOUT_S)
            actor_rate = CLUSTER_HOST_CALLS / (time.perf_counter() - t0)
            t0 = time.perf_counter()
            for _ in range(200):
                rt.get(pinger.ping.remote(), timeout=CLUSTER_TIMEOUT_S)
            call_ms = (time.perf_counter() - t0) / 200 * 1e3
            rt.kill(pinger)
            print(f"[cluster] (a) host, {os.cpu_count()} cores: {CLUSTER_HOST_CALLS} no-op tasks "
                  f"at {task_rate:.0f}/s, {CLUSTER_HOST_CALLS} calls to one actor at "
                  f"{actor_rate:.0f}/s, one call and its get in turn {call_ms:.3f} ms",
                  flush=True)

            # (b) TorchTrainer, one worker process over NCCL
            t0 = time.perf_counter()
            nccl = TorchTrainer(
                _cluster_loop, train_loop_config=cfg,
                scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                             backend=TorchBackendConfig(backend="nccl")),
                run_config=RunConfig(name="cluster_nccl", storage_path=tmp)).fit()
            fit_s = time.perf_counter() - t0
            if nccl.error is not None:
                _fail(f"cluster: the NCCL trainer failed: {nccl.error!r}")
            m, lm = nccl.metrics, local.metrics
            print(f"[cluster] (b) {smi}: TorchTrainer, 1 worker process (pid {m['pid']}, "
                  f"CUDA_VISIBLE_DEVICES={m['visible']!r}, {m['backend']}), llama2_7b width, 2 "
                  f"layers, bf16, remat hot, b=1 s={FIT_SEQ}, deterministic: fit {fit_s:.1f} s; "
                  f"losses {m['losses']}, in-process trainer {lm['losses']}, direct "
                  f"{direct_losses}; params_sha256 equal {m['params_sha256'] == direct_sha} / "
                  f"{lm['params_sha256'] == direct_sha}; step p50 report to report "
                  f"{_report_p50(m):.2f} ms (in-process trainer {_report_p50(lm):.2f} ms, direct "
                  f"step p50 {sorted(direct_ms[1:])[len(direct_ms[1:]) // 2]:.2f} ms); launches "
                  f"in the worker {m['launches']}", flush=True)
            if m["backend"] != "nccl" or m["pid"] == os.getpid():
                _fail("cluster: the trainer's worker is not a process on NCCL")
            if not (m["losses"] == lm["losses"] == direct_losses
                    and m["params_sha256"] == lm["params_sha256"] == direct_sha):
                _fail("cluster: the NCCL worker's run is not bitwise the in-process one's")
            want = {k: 2 * CLUSTER_STEPS for k in m["launches"]}
            if m["launches"] != want:
                _fail(f"cluster: the worker launched {m['launches']}, want {want}")
            launches["cluster trainer nccl"] = m["launches"]

            # (c) two worker processes sharing the card over gloo
            out = os.path.join(tmp, "rank0_params.pt")
            t0 = time.perf_counter()
            gloo = TorchTrainer(
                _cluster_data_loop,
                train_loop_config={"lr": 1e-4, "steps": CLUSTER_DATA_STEPS, "out": out},
                scaling_config=ScalingConfig(num_workers=2, use_gpu=True,
                                             resources_per_worker={"GPU": 0.5},
                                             mesh=MeshSpec(data=2),
                                             backend=TorchBackendConfig(backend="gloo")),
                run_config=RunConfig(name="cluster_gloo", storage_path=tmp)).fit()
            fit_s = time.perf_counter() - t0
            if gloo.error is not None:
                _fail(f"cluster: the gloo trainer failed: {gloo.error!r}")
            g = gloo.metrics
            got = torch.load(out)
            diffs = _leaf_rel_diffs(got, ref_leaves)
            first = abs(g["plain"]["losses"][0] - ref_losses[0]) / abs(ref_losses[0])
            traj = max(abs(a - b) / abs(b) for a, b in zip(g["plain"]["losses"], ref_losses))
            zl = max(abs(a - b) / abs(b) for a, b in zip(g["zero"]["losses"],
                                                         g["plain"]["losses"]))
            print(f"[cluster] (c) {smi}: 2 worker processes sharing the card over "
                  f"{g['backend']} (not multi-GPU speed), each CUDA_VISIBLE_DEVICES="
                  f"{g['visible']!r}, MeshSpec(data=2), llama2_7b width, 2 layers, fp32, TF32 "
                  f"off, global batch 2 x {FIT_SEQ}, {CLUSTER_DATA_STEPS} AdamW steps: fit "
                  f"{fit_s:.1f} s; losses {g['plain']['losses']} vs one process {ref_losses}: "
                  f"first rel {first:.3g} (tol 1e-6), trajectory rel {traj:.3g} (tol 1e-5); "
                  f"final params, worst leaf ||d|| / ||ref|| {max(diffs):.3g} (tol 1e-5)",
                  flush=True)
            print(f"[cluster] (c) ZeRO-1 over data, each rank its row: losses "
                  f"{g['zero']['losses']} (rel to the plain run {zl:.3g}); params bitwise equal "
                  f"to the plain run's {g['zero_bitwise']} (worst leaf {g['zero_worst']}); "
                  f"rank 0 peak memory GiB plain {g['plain']['peak_gib']:.3f} ZeRO "
                  f"{g['zero']['peak_gib']:.3f}; seconds plain {g['plain']['s']:.1f} ZeRO "
                  f"{g['zero']['s']:.1f}; launches rank 0 plain {g['plain']['launches']} ZeRO "
                  f"{g['zero']['launches']}", flush=True)
            if not (first <= 1e-6 and traj <= 1e-5 and max(diffs) <= 1e-5):
                _fail("cluster: the two-rank gloo run is not within its tolerance of one process")
            if not (g["zero_bitwise"] or g["zero_worst"][1] <= 1e-6):
                _fail(f"cluster: ZeRO-1 differs from the plain run: {g['zero_worst']}")
            for mode in ("plain", "zero"):
                want = {k: 2 * CLUSTER_DATA_STEPS for k in g[mode]["launches"]}
                if g[mode]["launches"] != want:
                    _fail(f"cluster: rank 0's {mode} run launched {g[mode]['launches']}, "
                          f"want {want}")
                launches[f"cluster gloo data=2 {mode} (rank 0)"] = g[mode]["launches"]
        finally:
            t0 = time.perf_counter()
            rt.shutdown()
            down_s = time.perf_counter() - t0
        left = _cluster_processes(session_dir)
        pools = glob.glob(ours + "*")
        print(f"[cluster] shutdown {down_s:.2f} s; processes left {left}, pools left "
              f"{sorted(pools)}", flush=True)
        if left or pools:
            _fail("cluster: processes or /dev/shm/rtpt_* pools outlived shutdown")
        _cluster_tcp(smi)
        print(f"[cluster] phase {time.perf_counter() - phase_t0:.1f} s", flush=True)
        return launches
    finally:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        shutil.rmtree(tmp, ignore_errors=True)


# The elastic phase: node drain and preemption on the cluster runtime.
ELASTIC_STEPS = 8  # (a): steps of the preempted and restored run
ELASTIC_EVERY = 2  # (a): a checkpoint every 2 steps, and one more on a drain
ELASTIC_DEADLINE_S = 20.0  # (a): notice to the node's death; a final checkpoint fits
# (b): world 2 for 2 steps, 1 for 2, then 2 again, a checkpoint after each
# step but the last. fp32 data parallelism drifts from one process by its sums'
# order, ~1.5e-6 of a leaf's norm per AdamW step (PR 12's 10-step run read
# 1.51e-5): 5 steps keep it inside part (c)'s 1e-5.
ELASTIC_DATA_STEPS = 5
ELASTIC_DATA_DEADLINE_S = 30.0
ELASTIC_WAIT_S = 3.0  # (b): capacity_wait_s, then the gang downsizes
ELASTIC_SERVE_DEADLINE_S = 60.0  # (c)
ELASTIC_TIMEOUT_S = 300


def _worker_device():
    """A worker's card: its current CUDA device (the one its lease shows)."""
    import torch

    return torch.device("cuda", torch.cuda.current_device())


def _local_tree(params, opt):
    """The params' tree with each leaf replaced by the tensor the step's
    optimizer updates (a DTensor's local shard, the whole leaf under a
    data-only mesh; a plain leaf itself), which build_train_step hands the
    optimizer in the tree's own key order."""
    storage = iter([p for g in opt.param_groups for p in g["params"]])

    def rebuild(tree):
        return {k: rebuild(v) for k, v in tree.items()} if isinstance(tree, dict) \
            else next(storage)

    return rebuild(params)


def _restore_state(path, local, opt):
    """Loads an elastic checkpoint's params and AdamW state into `local`
    (the step's own tensors) and `opt`; returns (its step, its meta)."""
    import torch

    from ray_tpu_torch.models import convert
    from ray_tpu_torch.train import elastic_checkpoint as ec

    state = ec.load_state(path)
    with torch.no_grad():
        for p, src in zip(convert.flatten(local)[1], convert.flatten(state["params"])[1]):
            p.copy_(src)
    convert.opt_state_from_numpy(state["opt_state"], opt, local)
    return state["step"], state["meta"]


def _save_state(scratch, local, opt, step, record):
    """An elastic checkpoint of params and AdamW state, the run's record in
    its meta, in a new directory under `scratch`."""
    import tempfile

    from ray_tpu_torch.models import convert
    from ray_tpu_torch.train import elastic_checkpoint as ec

    d = tempfile.mkdtemp(prefix="elastic-", dir=scratch)
    ec.save_state(d, local, convert.opt_state_to_torch(opt, local), step=step,
                  meta={"record": record})
    return d


def _drop_copied(sources, step):
    """Deletes the loop's own checkpoint directories that the trainer has
    copied: report() returns once its payload is queued and the trainer
    copies a checkpoint after taking it off the size-1 queue, so only the
    report two steps later proves that copy done."""
    import shutil

    for s in [s for s in sources if s <= step - 2]:
        shutil.rmtree(sources.pop(s))


def _elastic_loop(config):
    """Part (a)'s loop, as a user writes it for preemptible capacity: the
    fit phase's model and batches, deterministic, on this worker's card; an
    elastic checkpoint every ELASTIC_EVERY steps, and when
    train.drain_requested() one more and a return; restored from
    train.get_checkpoint(). The checkpoint's meta carries the run's record
    (each step's loss; each attempt's pid, node, launches, restore seconds
    and wall times), and the last report all of it with params_sha256."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.models import transformer as tfm

    torch.use_deterministic_algorithms(True)
    device = _worker_device()
    cfg = _fit_cfg()
    init, step = tfm.build_train_step(cfg, tfm.adamw(config["lr"]), device=device)
    params, opt = init(torch.Generator(device=device).manual_seed(0))
    attempt = {"pid": os.getpid(), "node": rt.get_runtime_context().get_node_id(),
               "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}
    record, start, ck = {"losses": [], "attempts": []}, 0, train.get_checkpoint()
    if ck is not None:
        t = time.perf_counter()
        last, meta = _restore_state(ck.path, params, opt)  # pageable copies: synchronous
        attempt["restore_s"] = time.perf_counter() - t
        attempt["restored_wall"] = time.time()
        record, start = meta["record"], last + 1
    record["attempts"].append(attempt)
    _zero_launch_counts()
    sources = {}
    for i in range(start, config["steps"]):
        loss = step(params, opt, _fit_batch(i, cfg.vocab_size)).item()
        attempt.setdefault("first_step_wall", time.time())
        record["losses"].append([i, loss])
        attempt["launches"] = _launch_counts()
        drain = train.drain_requested()
        ckpt = None
        if drain or (i % ELASTIC_EVERY == ELASTIC_EVERY - 1 and i < config["steps"] - 1):
            t = time.perf_counter()
            sources[i] = _save_state(config["scratch"], params, opt, i, record)
            attempt.setdefault("save_s", []).append(time.perf_counter() - t)
            ckpt = train.Checkpoint(sources[i])
        metrics = {"step": i, "loss": loss}
        if i == config["steps"] - 1:
            metrics.update(record=record, params_sha256=_params_sha256(params))
        train.report(metrics, checkpoint=ckpt)
        _drop_copied(sources, i)
        if drain:
            return  # the final checkpoint is reported: a clean drain


def _elastic_data_cfg():
    """Part (b)'s model: the cluster phase's fp32 config at Llama-2-7B's
    width, depth cut to 1 layer for the phase's time (5.6 GiB of state)."""
    import torch

    from ray_tpu_torch.models import transformer as tfm

    return tfm.llama2_7b(n_layers=1, dtype=torch.float32, remat_policy="hot")


def _elastic_data_loop(config):
    """Part (b)'s loop, one rank of a gloo world on the card (world 2, then
    1, then 2): the cluster phase's fp32 data-parallel step on the global
    batch, deterministic, TF32 off. Rank 0 checkpoints after every step but
    the last and saves its final params to config["out"]. Before each step
    the ranks agree on drain_requested() (a rank that stopped alone would
    hang its peers' next gradient sum) and on a drain return: the last
    checkpoint is the final one. Every rank's last report carries the record
    (each step's loss and world; each attempt's world, pid and launches)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import transformer as tfm

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    device = _worker_device()
    cfg = _elastic_data_cfg()
    init, step = tfm.build_train_step(cfg, tfm.adamw(config["lr"]), device=device,
                                      mesh=train.get_mesh())
    params, opt = init(torch.Generator(device=device).manual_seed(0))
    local = _local_tree(params, opt)
    record, start, ck = {"losses": [], "attempts": []}, 0, train.get_checkpoint()
    if ck is not None:
        last, meta = _restore_state(ck.path, local, opt)
        record, start = meta["record"], last + 1
    attempt = {"world": world, "pid": os.getpid(), "backend": dist.get_backend()}
    record["attempts"].append(attempt)
    _zero_launch_counts()
    sources = {}
    for i in range(start, config["steps"]):
        flag = torch.tensor([float(train.drain_requested())])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if flag.item():
            return  # the checkpoint of step i - 1 is the final one
        loss = step(params, opt, _cluster_data_batch(i, cfg.vocab_size)).item()
        record["losses"].append([i, loss, world])
        attempt["launches"] = _launch_counts()
        ckpt = None
        if rank == 0 and i < config["steps"] - 1:
            sources[i] = _save_state(config["scratch"], local, opt, i, record)
            ckpt = train.Checkpoint(sources[i])
        metrics = {"step": i, "loss": loss, "world": world}
        if i == config["steps"] - 1:
            if rank == 0:
                torch.save(_host_leaves(params), config["out"])
            metrics["record"] = record
        train.report(metrics, checkpoint=ckpt)
        _drop_copied(sources, i)


def _elastic_flash_request(i):
    """Part (c)'s deployment: request `i` runs flash_attention at the serve
    shape in the replica's process on the kernel phase's inputs (seed 0)
    and holds it against its plain version; returns the error, that
    process's pid and its K1 launches so far."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    b, s, h, d = CLUSTER_SERVE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    o = fa.flash_attention(q, k, v, causal=True)
    o_ref, _ = fa.reference_flash_fwd(q, k, v, causal=True, scale=d ** -0.5)
    return {"i": i, "err": entry_err(o, o_ref), "pid": os.getpid(),
            "launches": _launch_counts(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


def _first_event(kind, since_us):
    """Wall seconds of the first `kind` event of this process's flight ring
    at or after `since_us`, or None."""
    from ray_tpu_torch.observability.flight_recorder import RECORDER

    ts = [t for t, k, _ in RECORDER.snapshot() if k == kind and t >= since_us]
    return min(ts) / 1e6 if ts else None


def _dt(later, earlier) -> float:
    """later - earlier in seconds; nan where either never happened."""
    return float("nan") if later is None or earlier is None else later - earlier


def _count(metric, **tags) -> float:
    return metric.labels(**tags).read()


def _wait_until(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            _fail(f"elastic: {what} did not happen in {timeout_s:.0f} s")
        time.sleep(0.05)


def _checkpoints(trial_dir) -> int:
    """How many checkpoints the trainer has persisted into `trial_dir` (it
    numbers them across attempts; keep-K deletes the older ones)."""
    try:
        return max((int(d.split("_")[1]) + 1 for d in os.listdir(trial_dir)
                    if d.startswith("checkpoint_")), default=0)
    except OSError:
        return 0


def _in_background(fn, *args):
    """fn(*args) in a daemon thread; the thread, and a box holding its
    value or its error."""
    import threading

    box = {}

    def run():
        try:
            box["value"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def _joined(t, box, what):
    t.join(ELASTIC_TIMEOUT_S)
    if t.is_alive():
        _fail(f"elastic: {what} did not end in {ELASTIC_TIMEOUT_S} s")
    if "error" in box:
        raise box["error"]
    return box.get("value")


def _elastic_preempt(cluster, smi, tmp, direct):
    """Part (a): a one-worker NCCL trainer on an added node, preempted after
    its second checkpoint and restored on a replacement node."""
    from ray_tpu_torch.core.cluster_runtime import _node_processes, _running
    from ray_tpu_torch.core.runtime_base import current_runtime
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig, RunConfig,
                                     ScalingConfig, TorchBackendConfig, TorchTrainer)

    direct_losses, direct_sha = direct
    gcs = current_runtime()._gcs
    first = cluster.add_node(num_gpus=1, resources={"train_slot": 1.0})
    trial_dir = os.path.join(tmp, "elastic_preempt")
    times = {}

    def orchestrate():
        _wait_until(lambda: _checkpoints(trial_dir) >= 2 or "end" in times,
                    ELASTIC_TIMEOUT_S, "(a)'s second checkpoint")
        if "end" in times:
            return
        times["notice"] = time.time()
        gcs.call("report_preemption", first, ELASTIC_DEADLINE_S, "spot preemption (smoke)")
        time.sleep(ELASTIC_DEADLINE_S)
        procs = _node_processes(cluster.session_dir, first)
        cluster.remove_node(first)
        times["removed"] = time.time()
        times["left"] = [p for p in procs if _running(p)]
        times["replacement"] = cluster.add_node(num_gpus=1, resources={"train_slot": 1.0})

    t, box = _in_background(orchestrate)
    since = time.time_ns() // 1000
    fit_t0 = time.perf_counter()
    result = TorchTrainer(
        _elastic_loop,
        train_loop_config={"lr": 1e-4, "steps": ELASTIC_STEPS, "scratch": tmp},
        scaling_config=ScalingConfig(num_workers=1, backend=TorchBackendConfig(),
                                     resources_per_worker={"GPU": 1, "train_slot": 1}),
        run_config=RunConfig(name="elastic_preempt", storage_path=tmp,
                             failure_config=FailureConfig(max_failures=0),
                             checkpoint_config=CheckpointConfig(num_to_keep=1))).fit()
    fit_s = time.perf_counter() - fit_t0
    times["end"] = True
    _joined(t, box, "(a)'s preemption")
    if result.error is not None:
        _fail(f"elastic: (a) spent its failure budget: {result.error!r}")
    m = result.metrics
    record = m["record"]
    steps = [s for s, _ in record["losses"]]
    losses = [x for _, x in record["losses"]]
    old, new = record["attempts"][0], record["attempts"][-1]
    drain_t = _first_event("train.drain", since)
    restore_t = _first_event("train.restore", since)
    notice = times.get("notice")
    gp = m["goodput_seconds"]
    print(f"[elastic] (a) {smi}: TorchTrainer, 1 NCCL worker process on an added node, "
          f"llama2_7b width, 2 layers, bf16, remat hot, b=1 s={FIT_SEQ}, deterministic, "
          f"max_failures=0, a checkpoint every {ELASTIC_EVERY} steps: fit {fit_s:.1f} s; "
          f"attempts {len(record['attempts'])} (pids {old['pid']} -> {new['pid']}, nodes "
          f"{old['node']} -> {new['node']}, replacement {times.get('replacement')}); steps "
          f"{steps}; losses equal to the direct run {losses == direct_losses}, params_sha256 "
          f"equal {m['params_sha256'] == direct_sha}; goodput {m['goodput']:.3f}, seconds "
          f"{ {k: round(v, 2) for k, v in gp.items()} }", flush=True)
    print(f"[elastic] (a) {smi}: notice -> drain seen {_dt(drain_t, notice):.2f} s, -> final "
          f"checkpoint landed and the gang stopped {_dt(restore_t, notice):.2f} s, -> node "
          f"removed {_dt(times.get('removed'), notice):.2f} s (deadline "
          f"{ELASTIC_DEADLINE_S:.0f} s), -> restore done "
          f"{_dt(new.get('restored_wall'), notice):.2f} s (load "
          f"{new.get('restore_s', float('nan')):.2f} s), -> first fresh step "
          f"{_dt(new.get('first_step_wall'), notice):.2f} s; checkpoint saves "
          f"{[round(x, 2) for a in record['attempts'] for x in a.get('save_s', [])]} s; the "
          f"removed node's processes left {times.get('left')}; launches old "
          f"{old['launches']} new {new['launches']}", flush=True)
    if len(record["attempts"]) != 2 or old["pid"] == new["pid"] \
            or new["node"] != times.get("replacement"):
        _fail("elastic: (a) was not restored once, in a new process on the replacement node")
    if steps != list(range(ELASTIC_STEPS)):
        _fail(f"elastic: (a) steps {steps}, want each of 0..{ELASTIC_STEPS - 1} once")
    if losses != direct_losses or m["params_sha256"] != direct_sha:
        _fail("elastic: (a)'s losses or params are not bitwise the uninterrupted run's")
    if gp["drain_wait"] <= 0 or times.get("left"):
        _fail("elastic: (a) no drain-wait time, or the removed node's processes outlived it")
    for a in (old, new):
        if not all(a["launches"].values()):
            _fail(f"elastic: (a) an attempt did not launch every kernel: {a['launches']}")
    cluster.remove_node(times["replacement"])
    return {"elastic (a) preempted worker": old["launches"],
            "elastic (a) restored worker": new["launches"]}


def _elastic_resize(cluster, smi, tmp, ref):
    """Part (b): two gloo ranks on two added nodes, elastic; one node is
    preempted after the first checkpoint with no replacement inside
    capacity_wait_s (world 1), and a node comes back once the first step at
    world 1 is checkpointed (world 2 again at the next checkpoint)."""
    import torch

    from ray_tpu_torch.core.runtime_base import current_runtime
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig, RunConfig,
                                     ScalingConfig, TorchBackendConfig, TorchTrainer)
    from ray_tpu_torch.utils import internal_metrics as imet

    ref_losses, ref_leaves, ref_paths = ref
    gcs = current_runtime()._gcs
    slot = {"elastic_slot": 1.0}
    nodes = [cluster.add_node(num_gpus=1, resources=slot) for _ in range(2)]
    trial_dir = os.path.join(tmp, "elastic_resize")
    down0 = _count(imet.TRAIN_ELASTIC_RESIZES, direction="downsize")
    grow0 = _count(imet.TRAIN_ELASTIC_RESIZES, direction="growback")
    times = {}

    out = os.path.join(tmp, "elastic_rank0_params.pt")
    trainer = TorchTrainer(
        _elastic_data_loop,
        train_loop_config={"lr": 1e-4, "steps": ELASTIC_DATA_STEPS, "scratch": tmp,
                           "out": out},
        scaling_config=ScalingConfig(num_workers=2, mesh=MeshSpec(data=-1),
                                     backend=TorchBackendConfig(backend="gloo"),
                                     resources_per_worker={"GPU": 0.5, **slot},
                                     elastic=True, min_workers=1,
                                     capacity_wait_s=ELASTIC_WAIT_S),
        run_config=RunConfig(name="elastic_resize", storage_path=tmp,
                             failure_config=FailureConfig(max_failures=0),
                             checkpoint_config=CheckpointConfig(num_to_keep=1)))
    def kept(index):
        """True once checkpoint `index` is registered (keep-1 deletes the one
        before it then, just before the trainer checks for a grow-back)."""
        try:
            names = set(os.listdir(trial_dir))
        except OSError:
            names = set()
        return (f"checkpoint_{index:06d}" in names
                and f"checkpoint_{index - 1:06d}" not in names) or "end" in times

    def orchestrate():
        _wait_until(lambda: _checkpoints(trial_dir) >= 1 or "end" in times,
                    ELASTIC_TIMEOUT_S, "(b)'s first checkpoint")
        if "end" in times:
            return
        times["notice"] = time.time()
        gcs.call("report_preemption", nodes[0], ELASTIC_DATA_DEADLINE_S,
                 "spot preemption (smoke)")
        # No replacement: the wait runs out and the gang downsizes. Once the
        # first step at world 1 is checkpointed a node comes back, and the
        # gang grows back at the next checkpoint, two steps at world 1 on.
        _wait_until(lambda: _count(imet.TRAIN_ELASTIC_RESIZES, direction="downsize") > down0
                    or "end" in times, ELASTIC_TIMEOUT_S, "(b)'s downsize")
        first = _checkpoints(trial_dir)  # the number of the first at world 1
        _wait_until(lambda: kept(first), ELASTIC_TIMEOUT_S,
                    "(b)'s first checkpoint at world 1")
        if "end" in times:
            return
        times["added"] = time.time()
        nodes.append(cluster.add_node(num_gpus=1, resources=slot))
        _wait_until(lambda: time.time() >= times["notice"] + ELASTIC_DATA_DEADLINE_S,
                    ELASTIC_TIMEOUT_S, "(b)'s deadline")
        cluster.remove_node(nodes[0])

    t, box = _in_background(orchestrate)
    since = time.time_ns() // 1000
    fit_t0 = time.perf_counter()
    result = trainer.fit()
    fit_s = time.perf_counter() - fit_t0
    times["end"] = True
    _joined(t, box, "(b)'s preemption")
    if result.error is not None:
        _fail(f"elastic: (b) failed: {result.error!r}")
    m = result.metrics
    record = m["record"]
    steps = [s for s, _, _ in record["losses"]]
    losses = [x for _, x, _ in record["losses"]]
    worlds = [w for _, _, w in record["losses"]]
    got = torch.load(out)
    diffs = _leaf_rel_diffs(got, ref_leaves)
    first = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])
    traj = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    downs = _count(imet.TRAIN_ELASTIC_RESIZES, direction="downsize") - down0
    grows = _count(imet.TRAIN_ELASTIC_RESIZES, direction="growback") - grow0
    notice = times.get("notice")
    grow_t = _first_event("train.elastic_growback", since)
    down_t = _first_event("train.elastic_downsize", since)
    drain_t = _first_event("train.drain", since)
    gp = m["goodput_seconds"]
    worst = max(range(len(diffs)), key=diffs.__getitem__)
    print(f"[elastic] (b) {smi}: 2 gloo ranks sharing the card on 2 added nodes, elastic "
          f"(min_workers 1, capacity_wait_s {ELASTIC_WAIT_S:.0f}), llama2_7b width, 1 layer, "
          f"fp32, TF32 off, MeshSpec(data=-1), global batch 2 x {FIT_SEQ}: fit {fit_s:.1f} s; "
          f"worlds by step {worlds}; attempts "
          f"{[(a['world'], a['pid']) for a in record['attempts']]}; resizes downsize {downs} "
          f"growback {grows}; goodput {m['goodput']:.3f}, seconds "
          f"{ {k: round(v, 2) for k, v in gp.items()} }", flush=True)
    print(f"[elastic] (b) {smi}: losses {losses} vs one process {ref_losses}: first rel "
          f"{first:.3g} (tol 1e-6), trajectory rel {traj:.3g} (tol 1e-5); final params, worst "
          f"leaf ||d|| / ||ref|| {diffs[worst]:.3g} ({'/'.join(ref_paths[worst])}; tol 1e-5); "
          f"notice -> drain seen "
          f"{_dt(drain_t, notice):.2f} s, -> downsize {_dt(down_t, notice):.2f} s, downsize -> "
          f"node added {_dt(times.get('added'), down_t):.2f} s, downsize -> growback "
          f"{_dt(grow_t, down_t):.2f} s; launches by attempt "
          f"{[(a['world'], a['launches']) for a in record['attempts']]}", flush=True)
    first_one, last_one = worlds.index(1) if 1 in worlds else -1, \
        len(worlds) - 1 - worlds[::-1].index(1) if 1 in worlds else -1
    if steps != list(range(ELASTIC_DATA_STEPS)) or worlds[0] != 2 or worlds[-1] != 2 \
            or first_one < 0 or set(worlds[first_one:last_one + 1]) != {1}:
        _fail(f"elastic: (b) steps {steps} at worlds {worlds}, want each step once, 2..1..2")
    if (downs, grows) != (1, 1) or gp["degraded"] <= 0:
        _fail("elastic: (b) did not downsize and grow back once each with degraded time")
    if not (first <= 1e-6 and traj <= 1e-5 and max(diffs) <= 1e-5):
        _fail("elastic: (b) is not within its tolerance of one process")
    launches = {}
    for i, a in enumerate(record["attempts"]):
        if not all(a["launches"].values()):
            _fail(f"elastic: (b) an attempt at world {a['world']} did not launch every "
                  f"kernel: {a['launches']}")
        launches[f"elastic (b) attempt {i + 1} world {a['world']} (rank 0)"] = a["launches"]
    for nid in nodes[1:]:
        cluster.remove_node(nid)
    return launches


def _elastic_serve(cluster, smi):
    """Part (c): a num_gpus=0.5 deployment whose replica runs K1 on every
    request; its node gets a notice with a 60 s deadline while a client
    calls all along."""
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.runtime_base import current_runtime
    from ray_tpu_torch.serve.controller import get_or_create_controller
    from ray_tpu_torch.utils.node_events import actor_locations

    gcs = current_runtime()._gcs
    slots = [cluster.add_node(num_gpus=1, resources={"serve_slot": 1.0}) for _ in range(2)]
    app = serve.deployment(num_replicas=1, ray_actor_options={
        "num_gpus": 0.5, "resources": {"serve_slot": 1.0}})(_elastic_flash_request)
    t0 = time.perf_counter()
    handle = serve.run(app.bind(), name="elastic_flash", http_port=None)
    first = handle.remote(0).result(timeout=ELASTIC_TIMEOUT_S)
    up_s = time.perf_counter() - t0
    controller = get_or_create_controller()

    def replica_ids():
        _, replicas = rt.get(controller.get_replicas.remote("elastic_flash"), timeout=60)
        return [r._actor_id.hex() for r in replicas]

    before = replica_ids()
    victim = actor_locations(gcs)[before[0]]
    stop, answers, failures = threading.Event(), [], []

    def client():
        i = 1
        while not stop.is_set():
            try:
                r = handle.remote(i).result(timeout=60)
                answers.append((time.time(), r))
            except Exception as e:  # noqa: BLE001 - counted, and a gate
                failures.append(repr(e))
            i += 1

    caller = threading.Thread(target=client, daemon=True)
    caller.start()
    time.sleep(1.0)
    notice = time.time()
    gcs.call("report_preemption", victim, ELASTIC_SERVE_DEADLINE_S, "spot preemption (smoke)")
    _wait_until(lambda: any(r["pid"] != first["pid"] for _, r in list(answers)),
                ELASTIC_TIMEOUT_S, "(c)'s replacement serving")
    served = min(ts for ts, r in list(answers) if r["pid"] != first["pid"])
    time.sleep(1.0)
    stop.set()
    caller.join(120)
    after = replica_ids()
    where = actor_locations(gcs).get(after[0]) if after else None
    by_pid = {}
    for _, r in answers:
        by_pid[r["pid"]] = r
    tol = FWD_TOL["bfloat16"][0]
    worst = max(r["err"] for _, r in answers)
    serve.shutdown()
    print(f"[elastic] (c) {smi}: a num_gpus=0.5 deployment running flash_attention at "
          f"{CLUSTER_SERVE_SHAPE} bf16 causal per request: up {up_s:.2f} s; {len(answers)} "
          f"requests during the drain, failed {len(failures)}; notice -> new replica serving "
          f"{served - notice:.2f} s; replicas {before} -> {after}, node {victim} -> {where}; "
          f"worst per-entry error {worst:.3g} (tol {tol:.3g}); K1 launches by replica process "
          f"{ {pid: r['launches']['flash_fwd'] for pid, r in by_pid.items()} }", flush=True)
    if failures:
        _fail(f"elastic: (c) requests failed during the replica swap: {failures[:3]}")
    if after == before or where in (None, victim) or len(by_pid) != 2:
        _fail("elastic: (c) the replica was not replaced by a new actor on another node")
    if not (math.isfinite(worst) and worst <= tol):
        _fail("elastic: (c) flash_attention in a replica failed its check")
    out = {}
    for n, (pid, r) in enumerate(sorted(by_pid.items(), key=lambda kv: kv[0] != first["pid"])):
        if r["launches"]["flash_fwd"] < 1:
            _fail(f"elastic: (c) the replica in pid {pid} launched no K1")
        out[f"elastic (c) {'old' if n == 0 else 'new'} replica"] = r["launches"]
    for nid in slots:
        if nid != victim:
            cluster.remove_node(nid)
    return out


def phase_elastic():
    """Node drain and preemption on the cluster runtime (init(): a head
    leasing GPU 0, nodes added and removed with Cluster.add_node /
    remove_node, a notice through the GCS's report_preemption): (a) a
    one-worker NCCL TorchTrainer with max_failures=0 preempted after its
    second checkpoint and restored on a replacement node, bitwise equal to
    build_train_step driven directly; (b) an elastic two-rank gloo trainer
    (fp32, 1 layer) downsized to one rank when no capacity comes back within
    capacity_wait_s and grown back to two at a checkpoint once a node is
    added, within part (c) of the cluster phase's tolerance of one process;
    (c) a Serve replica on a draining node replaced on another node while a
    client calls all along. K1-K3 in every new process; no process or pool
    left. Returns the launches of each path."""
    import glob
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.runtime_base import current_runtime

    phase_t0 = time.perf_counter()
    smi = _smi()
    # Checkpoints go to memory: the card machine caps what a run writes to
    # its disk (45 GiB, freed blocks included), and this phase's 3.7 and
    # 8 GiB states, each saved by a worker and copied by the trainer, would
    # write ~80 GiB there.
    tmp = tempfile.mkdtemp(prefix="chip-smoke-elastic-",
                           dir="/dev/shm" if os.path.isdir("/dev/shm") else None)
    try:
        with _deterministic():
            direct_losses, _, direct_sha = _direct_run(1e-4, ELASTIC_STEPS)
            ref = _cluster_reference_data(ELASTIC_DATA_STEPS, _elastic_data_cfg)
        torch.cuda.empty_cache()
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        rt.init()
        runtime = current_runtime()
        cluster = runtime._cluster
        session_dir = cluster.session_dir
        ours = f"/dev/shm/rtpt_{os.path.basename(session_dir)}"
        launches = {}
        try:
            t0 = time.perf_counter()
            launches.update(_elastic_preempt(cluster, smi, tmp, (direct_losses, direct_sha)))
            a_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            launches.update(_elastic_resize(cluster, smi, tmp, ref))
            b_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            launches.update(_elastic_serve(cluster, smi))
            c_s = time.perf_counter() - t0
        finally:
            rt.shutdown()
        left = _cluster_processes(session_dir)
        pools = glob.glob(ours + "*")
        print(f"[elastic] parts (a) {a_s:.1f} s, (b) {b_s:.1f} s, (c) {c_s:.1f} s; processes "
              f"left {left}, pools left {sorted(pools)}; phase "
              f"{time.perf_counter() - phase_t0:.1f} s", flush=True)
        if left or pools:
            _fail("elastic: processes or /dev/shm/rtpt_* pools outlived shutdown")
        return launches
    finally:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import argparse

    import ray_tpu_torch  # noqa: F401  (fails at once outside a checkout)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parallel-rank", nargs=4, metavar=("RANK", "WORLD", "INIT_URL", "OUT"),
                    help="run one rank of the parallel phase's gloo world (the phase starts "
                         "these processes itself)")
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve phase, one more train step, and one step each of "
                         "the fit phase's trainer and plain runs with torch.profiler, and print "
                         "device time by kernel")
    args = ap.parse_args()
    if args.parallel_rank:
        rank, world, url, out = args.parallel_rank
        _parallel_rank(int(rank), int(world), url, out)
        return 0

    name = phase_device()
    phase_build()
    fwd_row, dq_row, dkv_row = phase_kernel()
    phase_paged()
    for row, n in zip((fwd_row, dq_row, dkv_row), phase_gptj().values()):
        row["at_d256"]["launches"] = n
    fwd_row["launches"] = phase_serve(profile=args.profile)
    by_path = phase_deploy()
    phase_train_parity()
    train_launches = phase_train(profile=args.profile)
    phase_zero()
    phase_checkpoint()
    fit_launches, fit_step_ms = phase_fit(profile=args.profile)
    by_path.update(fit_launches)
    by_path.update(phase_tune(fit_step_ms))
    by_path.update(phase_parallel())
    by_path.update(phase_cluster())
    by_path.update(phase_elastic())
    dq_row["launches"] = train_launches["flash_bwd_dq"]
    dkv_row["launches"] = train_launches["flash_bwd_dkv"]
    for row in (fwd_row, dq_row, dkv_row):
        row["launches_by_path"] = {path: n[row["name"]] for path, n in by_path.items()}
    print(json.dumps({"kernels": [fwd_row, dq_row, dkv_row]}), flush=True)
    import torch

    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
