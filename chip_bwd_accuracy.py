"""How close the bfloat16 flash kernels come to exact arithmetic, on one
NVIDIA GPU:

    python3 chip_bwd_accuracy.py

At the train phase's shape (b=2, s=2048, h=h_kv=32, d=128, causal), for three
input seeds, it reads each entry's error |got - want| / (|want| + rms(want))
(chip_smoke.py's `entry_err`):

Forward: o and lse
  - of the plain version (reference_flash_fwd: fp32 arithmetic, P rounded to
    bf16 per 64-key block where the Pallas kernel rounds it) against the same
    blockwise function in float64, the floor any kernel meets;
  - of the tensor-core kernel as built (64-row q tile, 4 warps, two blocks
    per SM), of two 128-row variants (8 warps; registers for two blocks per
    SM, or for one) and of a build whose scores sum as one chain, against
    both; with each build's registers and spills, and its time at the serve
    shape (b=1, s=1024) and the train shape.
Backward: dq, dk and dv
  - of the plain version (fp32 arithmetic, bf16 roundings where the Pallas
    kernels cast) against the same function in float64;
  - of the kernels as built, whose scores S and dP sum the head dim as two
    chains of mma.sync and add the chains in fp32, against both;
  - of the same kernels with each score summed as one chain;
  - the lse variant (as ring attention feeds it): delta less a dlse drawn at
    random at |delta|'s scale, the plain version and the kernels as built
    against float64, to tell rounding from a fault (chip_smoke.py's kernel
    phase reads dk 0.016 against 2**-6 on such a dlse, PERF.md).
It prints the largest error and how many entries exceed 2**-8 and 2**-7, and
each build's kernel times. Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import shutil
import subprocess
import sys

ONE_CHAIN = ("mma_bf16.cuh", "constexpr int CHAIN = (KD + 1) / 2 < 4 ? (KD + 1) / 2 : 4;",
             "constexpr int CHAIN = KD;")
# The forward's q tile and the blocks per SM its registers must allow.
FWD_BQ = "constexpr int FWD_BQ = 64;"
FWD_MIN_BLOCKS = "return D > 128 ? 1 : 2;"
FWD_BUILDS = {
    "BQ=64, 4 warps, 2 blocks/SM (as built)": [],
    "BQ=128, 8 warps, 2 blocks/SM": [("flash_fwd.cu", FWD_BQ, FWD_BQ.replace("64", "128"))],
    "BQ=128, 8 warps, 1 block/SM": [("flash_fwd.cu", FWD_BQ, FWD_BQ.replace("64", "128")),
                                    ("flash_fwd.cu", FWD_MIN_BLOCKS,
                                     "return 1;")],
    "BQ=64, one chain": [ONE_CHAIN],
}


def err_map(got, want):
    g, w = got.double(), want.double()
    return (g - w).abs() / (w.abs() + w.pow(2).mean().sqrt())


def describe(e) -> str:
    return (f"max {e.max().item():.4g} n>2^-8 {(e > 2 ** -8).sum().item()} "
            f"n>2^-7 {(e > 2 ** -7).sum().item()}")


def variant(build_dir, edits):
    """A copy of the kernel sources in `build_dir` with each (file, old, new)
    text edit made once; None when a marker is gone from the sources."""
    from ray_tpu_torch.ops import _build

    build_dir.mkdir(parents=True, exist_ok=True)
    for src in _build.CSRC.iterdir():
        shutil.copy(src, build_dir)
    for name, old, new in edits:
        path = build_dir / name
        text = path.read_text()
        if text.count(old) != 1:
            print(f"FAIL: {name} no longer has `{old}`")
            return None
        path.write_text(text.replace(old, new))
    return build_dir


def reference64_fwd(q, k, v, *, causal, scale, block_k=64):
    """The forward in float64 over 64-key blocks, with the unnormalised P of
    each block rounded to bf16 where the Pallas kernel rounds it (q, k and v
    carry h heads): (o, lse), o unrounded."""
    import torch

    qd, kd, vd = (x.double().transpose(1, 2) for x in (q, k, v))
    b, h, s, d = qd.shape
    m = torch.full((b, h, s), -1e30, dtype=torch.float64, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, s, d), dtype=torch.float64, device=q.device)
    pos = torch.arange(s, device=q.device)
    for k0 in range(0, s, block_k):
        k1 = min(k0 + block_k, s)
        r0 = k0 if causal else 0
        sc = qd[:, :, r0:] @ kd[:, :, k0:k1].transpose(-1, -2) * scale
        if causal:
            sc = sc.masked_fill(pos[r0:, None] < pos[None, k0:k1], -1e30)
        m_new = torch.maximum(m[..., r0:], sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m[..., r0:] - m_new)
        l[..., r0:] = l[..., r0:] * alpha + p.sum(-1)
        acc[..., r0:, :] = (acc[..., r0:, :] * alpha[..., None]
                            + p.to(torch.bfloat16).double() @ vd[:, :, k0:k1])
        m[..., r0:] = m_new
    l = l.clamp_min(1e-30)
    return (acc / l[..., None]).transpose(1, 2), m + torch.log(l)


def forward_section(scratch) -> bool:
    """The forward's readings and times for each build in FWD_BUILDS."""
    import torch

    from chip_smoke import _time_ms, ptxas_kernels
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa

    builds = {}
    for i, (label, edits) in enumerate(FWD_BUILDS.items()):
        builds[label] = variant(scratch / f"fwd_{i}", edits)
        if builds[label] is None:
            return False
    b, s, h, d = 2, 2048, 32, 128
    kw = dict(causal=True, scale=d ** -0.5)
    gen = torch.Generator(device="cuda").manual_seed(0)
    serve = [torch.randn((1, 1024, h, d), generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(3)]
    original = _build.CSRC
    try:
        for label, csrc in builds.items():  # build each variant, print its ptxas report
            _build.CSRC = csrc
            _build._libs.pop("flash_fwd", None)
            _build.ptxas_reports.pop("flash_fwd", None)
            _build.load("flash_fwd")
            print(f"[fwd build] {label}: " + (" | ".join(
                f"{k} {regs} regs {spill} B spilled"
                for k, regs, spill in ptxas_kernels(_build.ptxas_reports.get("flash_fwd", ""))
                if "mma" in k) or "cached"), flush=True)
        for seed in (1, 2, 3):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(3))
            o_plain, lse_plain = fa.reference_flash_fwd(q, k, v, **kw)
            o_exact, lse_exact = reference64_fwd(q, k, v, **kw)
            print(f"[fwd seed {seed}] plain vs float64: o {describe(err_map(o_plain, o_exact))}; "
                  f"lse max |err| {(lse_plain.double() - lse_exact).abs().max().item():.3g}",
                  flush=True)
            for label, csrc in builds.items():
                _build.CSRC = csrc
                _build._libs.pop("flash_fwd", None)
                o, lse = fa.flash_fwd(q, k, v, **kw)
                torch.cuda.synchronize()
                ms = _time_ms(lambda: fa.flash_fwd(q, k, v, **kw), iters=10)
                ms_serve = _time_ms(lambda: fa.flash_fwd(*serve, **kw), iters=10)
                print(f"[fwd seed {seed}] {label}: o vs plain max "
                      f"{err_map(o, o_plain).max().item():.4g}, vs float64 "
                      f"{describe(err_map(o, o_exact))}; lse max |err| vs plain "
                      f"{(lse - lse_plain).abs().max().item():.3g}, vs float64 "
                      f"{(lse.double() - lse_exact).abs().max().item():.3g}; ms train shape "
                      f"{ms:.4f}, serve shape {ms_serve:.4f}", flush=True)
            del o_plain, o_exact
            torch.cuda.empty_cache()
    finally:
        _build.CSRC = original
        _build._libs.pop("flash_fwd", None)
    return True


def reference64(q, k, v, lse, do, delta, *, causal, scale):
    """The backward in float64, with P and dS rounded to bf16 where the
    Pallas kernels cast them (q, k, v and do carry h heads)."""
    import torch

    b, s, h, d = q.shape
    out = [torch.empty(q.shape, dtype=torch.float64, device=q.device) for _ in range(3)]
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    for bi in range(b):
        for h0 in range(0, h, 4):  # four heads at a time: [4, s, s] float64 each
            hs = slice(h0, h0 + 4)
            qq, kk, vv, oo = (x[bi, :, hs].double().transpose(0, 1) for x in (q, k, v, do))
            sc = qq @ kk.transpose(1, 2) * scale
            if causal:
                sc = sc.masked_fill(~keep, -1e30)
            p = torch.exp(sc - lse[bi, hs, :, None].double())
            ds = p * (oo @ vv.transpose(1, 2) - delta[bi, hs, :, None].double()) * scale
            ds, p = ds.to(torch.bfloat16).double(), p.to(torch.bfloat16).double()
            for o, val in zip(out, (ds @ kk, ds.transpose(1, 2) @ qq, p.transpose(1, 2) @ oo)):
                o[bi, :, hs] = val.transpose(0, 1)
    return out


def main() -> int:
    import torch

    from ray_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this script needs a CUDA device")
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    scratch = _build.BUILD_DIR / "csrc_variants"
    try:
        if not forward_section(scratch):
            return 1
        # The one-chain build: the same sources with scores_16x32's split removed.
        one_chain = variant(scratch / "one_chain", [ONE_CHAIN])
        if one_chain is None:
            return 1
        return backward_section({"two chains (as built)": _build.CSRC, "one chain": one_chain})
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def backward_section(builds) -> int:
    """The backward's readings and times for each build."""
    import torch

    from chip_smoke import _time_ms
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa

    b, s, h, d, causal = 2, 2048, 32, 128, True
    scale = d ** -0.5
    kw = dict(causal=causal, scale=scale)
    try:
        for seed in (1, 2, 3):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                           .to(torch.bfloat16) for _ in range(4))
            o, lse = fa.flash_fwd(q, k, v, **kw)
            delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
            args = (q, k, v, lse, do, delta)
            plain = fa.reference_flash_bwd(q, k, v, o, lse, do, delta, **kw)
            exact = reference64(*args, **kw)
            print(f"[seed {seed}] plain vs float64: " + "; ".join(
                f"{n} {describe(err_map(w, x))}" for n, w, x in zip(("dq", "dk", "dv"), plain,
                                                                    exact)), flush=True)
            variant = lse_variant_inputs(q, k, v, lse, do, delta, kw, seed)
            for label, csrc in builds.items():
                _build.CSRC = csrc
                _build._libs.pop("flash_bwd", None)
                lse_variant(variant, args, kw, seed, label)
                got = (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args, **kw))
                torch.cuda.synchronize()
                ms = [_time_ms(lambda: fn(*args, **kw), iters=10)
                      for fn in (fa.flash_bwd_dq, fa.flash_bwd_dkv)]
                print(f"[seed {seed}] {label}: " + "; ".join(
                    f"{n} vs plain max {err_map(g, w).max().item():.4g}, vs float64 "
                    f"{describe(err_map(g, x))}"
                    for n, g, w, x in zip(("dq", "dk", "dv"), got, plain, exact))
                    + f"; ms dq {ms[0]:.4f} dkv {ms[1]:.4f}", flush=True)
            del plain, exact, variant
            torch.cuda.empty_cache()
    finally:
        _build.CSRC = builds["two chains (as built)"]
        _build._libs.pop("flash_bwd", None)
    return 0


def lse_variant_inputs(q, k, v, lse, do, delta, kw, seed):
    """The lse variant's inputs, as ring attention feeds them: delta - dlse,
    dlse drawn at random at |delta|'s scale (mean |dlse| = 0.8 mean |delta|,
    as chip_smoke.py's first lse check drew it); with the plain version's
    dq/dk/dv on them and the float64 backward's."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(100 + seed)
    dlse = torch.randn(delta.shape, generator=gen, device="cuda") * delta.abs().mean()
    args = (q, k, v, lse, do, (delta - dlse).contiguous())
    plain = (fa.reference_flash_bwd_dq(*args, **kw), *fa.reference_flash_bwd_dkv(*args, **kw))
    return {"args": args, "plain": plain, "exact": reference64(*args, **kw),
            "dlse": dlse.abs().mean().item(), "delta": delta.abs().mean().item()}


def lse_variant(inputs, plain_args, kw, seed, label):
    """The backward kernels of the current build on the lse variant's
    inputs, against their plain versions and float64; the plain version
    against float64 beside them; and, for scale, what a kernel that dropped
    dlse would read (the kernels on `plain_args`, delta without dlse)."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    args = inputs["args"]
    got = (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args, **kw))
    dropped = (fa.flash_bwd_dq(*plain_args, **kw), *fa.flash_bwd_dkv(*plain_args, **kw))
    torch.cuda.synchronize()
    print(f"[seed {seed}] {label}, lse variant, dlse dropped: " + "; ".join(
        f"{n} vs float64 max {err_map(g, x).max().item():.4g}"
        for n, g, x in zip(("dq", "dk", "dv"), dropped, inputs["exact"])), flush=True)
    print(f"[seed {seed}] {label}, lse variant, random dlse (|dlse| mean {inputs['dlse']:.3g}, "
          f"|delta| mean {inputs['delta']:.3g}): " + "; ".join(
              f"{n} kernel vs plain max {err_map(g, w).max().item():.4g}, kernel vs float64 "
              f"{describe(err_map(g, x))}, plain vs float64 {describe(err_map(w, x))}"
              for n, g, w, x in zip(("dq", "dk", "dv"), got, inputs["plain"], inputs["exact"])),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
