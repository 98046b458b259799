"""Profiling hooks: device traces, named spans and device-memory snapshots
(the port of ray_tpu/utils/profiling.py, over torch.profiler).

Where the JAX package captures an XLA trace with jax.profiler, the port
records a torch.profiler trace: host ops and, on a machine with a card,
every CUDA kernel the wrapped block launches (the flash kernels by their
names), written as a Chrome trace that Perfetto and chrome://tracing open.
Task-level wall spans come from `ray_tpu_torch.utils.state.timeline()`.

    from ray_tpu_torch.utils.profiling import device_trace, span
    with device_trace("/tmp/trace"):      # CPU ops + CUDA kernels
        train_step(...)
    with span("preprocess"):              # wall-clock span -> one line
        ...

Without CUDA only CPU activities are recorded: no CUDA activity is ever
asked of the profiler on a machine without a card. torch is imported inside
the calls, never at import.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

TRACE_FILE = "trace.json"


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """Records a torch.profiler trace of the block (CPU ops, and CUDA kernels
    when there is a card) and writes it to `<logdir>/trace.json`."""
    import torch
    from torch.profiler import profile

    os.makedirs(logdir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """A named wall-clock span, also a `record_function` range on the
    profiler's trace when one is recording; prints its milliseconds."""
    import torch

    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    # console-output: user-invoked timing utility
    print(f"[span] {name}: {dt * 1e3:.2f} ms", flush=True)


def save_device_memory_profile(path: str) -> None:
    """Writes the CUDA caching allocator's snapshot to `path` (pickle; open
    it at pytorch.org/memory_viz). Memory-history recording is switched on
    at the first call, so the snapshot holds the segments and blocks live
    now and the allocations made after that call."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("save_device_memory_profile needs a CUDA device")
    torch.cuda.memory._record_memory_history(max_entries=100_000)
    torch.cuda.memory._dump_snapshot(path)
