"""Statistical sampling profiler for the runtime's daemons (the port of
ray_tpu/utils/sampling_profiler.py).

cProfile only observes the thread that enables it, which is useless for the
raylet and the GCS, whose work happens on RPC server threads. This sampler
walks ``sys._current_frames()`` on an interval and aggregates truncated
stacks, as external samplers (py-spy) do, but in process and with no
dependency. Enable it per daemon with RAY_TPU_SAMPLING_PROFILE=<dir> (the
GCS, raylet and worker entry points call `maybe_start_from_env`): each
process writes <dir>/<name>-<pid>.txt, hottest stacks first, and a
structured ``profile_*.json`` twin that observability/perfetto.py's
`collect_profiles` merges into the Perfetto timeline. On demand: the
raylet's `profile` RPC samples that raylet for N seconds (`run_for`);
`python -m ray_tpu_torch.scripts debug profile` asks every raylet at once. (reference: ray._private.profiling and the dashboard's flame-graph
endpoint.) Standard library only.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import sys
import threading
import time as _time
from typing import Optional

_DEPTH = 5


def profile_dir() -> str:
    """Where structured profile dumps land: RAY_TPU_SAMPLING_PROFILE when
    set, else <trace_dir>/profile — parallel to the flight dir so one
    `ray-tpu trace` sweep finds spans, flight rings, AND profiles."""
    d = os.environ.get("RAY_TPU_SAMPLING_PROFILE")
    if d:
        return d
    from .. import tracing

    return os.path.join(tracing.trace_dir(), "profile")


class SamplingProfiler:
    def __init__(self, interval_s: float = 0.002, depth: int = _DEPTH):
        self.interval_s = interval_s
        self.depth = depth
        self.counts: collections.Counter = collections.Counter()
        self.samples = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._path: Optional[str] = None

    def start(self) -> "SamplingProfiler":
        self._thread = threading.Thread(target=self._loop, daemon=True, name="sampler")
        self._thread.start()
        return self

    def _loop(self) -> None:
        me = threading.get_ident()
        last_dump = 0.0
        while not self._stop.wait(self.interval_s):
            self.samples += 1
            for tid, frame in list(sys._current_frames().items()):
                if tid == me:
                    continue
                stack = []
                f = frame
                for _ in range(self.depth):
                    if f is None:
                        break
                    code = f.f_code
                    stack.append(
                        f"{os.path.basename(code.co_filename)}:{code.co_firstlineno}:{code.co_name}"
                    )
                    f = f.f_back
                self.counts[" < ".join(stack)] += 1
            # Periodic dump: daemons are SIGTERMed on cluster teardown, so
            # an atexit-only dump races process kill.
            if self._path and _time.monotonic() - last_dump > 2.0:
                last_dump = _time.monotonic()
                try:
                    self.dump(self._path)
                except OSError:
                    pass

    def stop(self) -> None:
        self._stop.set()

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(f"# samples={self.samples} interval={self.interval_s}s\n")
            for stack, n in self.counts.most_common(100):
                f.write(f"{n}\t{stack}\n")

    def dump_json(self, path: Optional[str] = None, name: str = "proc") -> str:
        """Structured dump for the Perfetto merge: aggregated hottest
        stacks with counts. Tmp+rename so a killed daemon never leaves a
        truncated file for the merger."""
        if path is None:
            d = profile_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"profile_{name}-{os.getpid()}_{_time.time_ns() // 1000}.json"
            )
        payload = {
            "pid": os.getpid(),
            "name": name,
            "interval_s": self.interval_s,
            "samples": self.samples,
            "dump_us": _time.time_ns() // 1000,
            "stacks": [[n, stack] for stack, n in self.counts.most_common(100)],
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path


def run_for(seconds: float, name: str = "proc") -> dict:
    """Blocking on-demand profile (the raylet `profile` RPC body): sample
    this process for `seconds`, dump text + JSON, return their paths."""
    seconds = min(max(float(seconds), 0.2), 60.0)
    prof = SamplingProfiler()
    prof.start()
    _time.sleep(seconds)
    prof.stop()
    json_path = prof.dump_json(name=name)
    txt_path = json_path[: -len(".json")] + ".txt"
    try:
        prof.dump(txt_path)
    except OSError:
        txt_path = None
    return {"path": json_path, "text": txt_path, "samples": prof.samples}


def maybe_start_from_env(name: str) -> Optional[SamplingProfiler]:
    """Starts a sampler when RAY_TPU_SAMPLING_PROFILE is set to a directory;
    dumps to <dir>/<name>-<pid>.txt (+ a structured .json twin for the
    trace merge) at process exit."""
    out_dir = os.environ.get("RAY_TPU_SAMPLING_PROFILE")
    if not out_dir:
        return None
    os.makedirs(out_dir, exist_ok=True)
    prof = SamplingProfiler()
    path = os.path.join(out_dir, f"{name}-{os.getpid()}.txt")
    prof._path = path
    prof.start()

    def _final_dump():
        prof.stop()
        prof.dump(path)
        try:
            prof.dump_json(
                path=os.path.join(
                    out_dir, f"profile_{name}-{os.getpid()}.json"
                ),
                name=name,
            )
        except OSError:
            pass

    atexit.register(_final_dump)
    return prof
