"""How close the bfloat16 flash backward kernels come to exact arithmetic, on
one NVIDIA GPU:

    python3 chip_bwd_accuracy.py

At the train phase's shape (b=2, s=2048, h=h_kv=32, d=128, causal), for three
input seeds, it reads each entry's error |got - want| / (|want| + rms(want))
(chip_smoke.py's backward measure) of dq, dk and dv
  - of the plain version (fp32 arithmetic, bf16 roundings where the Pallas
    kernels cast) against the same function in float64, the floor any
    kernel meets;
  - of the kernels as built, whose scores S and dP sum the head dim as two
    chains of mma.sync and add the chains in fp32, against both;
  - of the same kernels with each score summed as one chain.
It prints the largest error and how many entries exceed 2**-8 and 2**-7, and
each build's kernel times. Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import shutil
import subprocess
import sys

ONE_CHAIN = ("constexpr int HALF = (KD + 1) / 2;", "constexpr int HALF = KD;")


def err_map(got, want):
    g, w = got.double(), want.double()
    return (g - w).abs() / (w.abs() + w.pow(2).mean().sqrt())


def describe(e) -> str:
    return (f"max {e.max().item():.4g} n>2^-8 {(e > 2 ** -8).sum().item()} "
            f"n>2^-7 {(e > 2 ** -7).sum().item()}")


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
    from ray_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this script needs a CUDA device")
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import _time_ms

    # The one-chain build: the same sources with scores_16x32's split removed.
    one_chain = _build.BUILD_DIR / "csrc_one_chain"
    one_chain.mkdir(parents=True, exist_ok=True)
    for src in _build.CSRC.iterdir():
        shutil.copy(src, one_chain)
    cu = one_chain / "flash_bwd.cu"
    text = cu.read_text()
    if text.count(ONE_CHAIN[0]) != 1:
        print(f"FAIL: flash_bwd.cu no longer has `{ONE_CHAIN[0]}`")
        return 1
    cu.write_text(text.replace(*ONE_CHAIN))
    builds = {"two chains (as built)": _build.CSRC, "one chain": one_chain}

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
            for label, csrc in builds.items():
                _build.CSRC = csrc
                _build._libs.pop("flash_bwd", None)
                got = (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args, **kw))
                torch.cuda.synchronize()
                ms = [_time_ms(lambda: fn(*args, **kw), iters=10)
                      for fn in (fa.flash_bwd_dq, fa.flash_bwd_dkv)]
                print(f"[seed {seed}] {label}: " + "; ".join(
                    f"{n} vs plain max {err_map(g, w).max().item():.4g}, vs float64 "
                    f"{describe(err_map(g, x))}"
                    for n, g, w, x in zip(("dq", "dk", "dv"), got, plain, exact))
                    + f"; ms dq {ms[0]:.4f} dkv {ms[1]:.4f}", flush=True)
            del plain, exact
            torch.cuda.empty_cache()
    finally:
        _build.CSRC = builds["two chains (as built)"]
        _build._libs.pop("flash_bwd", None)
        shutil.rmtree(one_chain, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
