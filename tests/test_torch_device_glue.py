"""The port's device glue against the JAX package's: the per-node
ReporterAgent (ray_tpu_torch/utils/internal_metrics.py), the RPC server's
per-method hook and the GCS's `raytpu_gcs_rpc_*` accounting
(core/{rpc,gcs}.py), and the profiling hooks (utils/profiling.py over
torch.profiler, where the JAX package's use jax.profiler).

Exact: the methods the RPC hook observes for the same calls, and the GCS
hook's counter and histogram calls for the same methods. The same outcome:
a reporter round sets the node and process gauges in both; the port's
device gauge reads `torch.cuda.memory_allocated` of each device only where
CUDA is initialised (a stand-in cuda module here; the card's own reading is
chip_smoke.py's `operate` phase and the `cuda` case below), never creates a
CUDA context, and a daemon's reporter imports no torch; a trace of a named
span lands under its logdir in both.
"""

import importlib
import os
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKGS = ("ray_tpu", "ray_tpu_torch")
_SEEN = {}


def _agree(case, pkg, seen):
    _SEEN.setdefault(case, {})[pkg] = seen
    if pkg == "ray_tpu_torch" and "ray_tpu" in _SEEN[case]:
        assert seen == _SEEN[case]["ray_tpu"], (case, seen, _SEEN[case]["ray_tpu"])


class _Recorder:
    def __init__(self, calls, name):
        self.calls, self.name = calls, name

    def set(self, value, **tags):
        self.calls.append((self.name, "set", value, tuple(sorted(tags.items()))))

    def inc(self, value=1.0, **tags):
        self.calls.append((self.name, "inc", value, tuple(sorted(tags.items()))))

    def observe(self, value, **tags):
        self.calls.append((self.name, "observe", value, tuple(sorted(tags.items()))))


_REPORTER_GAUGES = ("NODE_CPU_PERCENT", "NODE_MEM_USED", "PROC_RSS", "PROC_FD_COUNT",
                    "DEVICE_MEM_USED")


@pytest.mark.parametrize("pkg", PKGS)
def test_reporter_round_sets_node_and_process_gauges(pkg, monkeypatch):
    imet = importlib.import_module(f"{pkg}.utils.internal_metrics")
    calls = []
    for g in _REPORTER_GAUGES:
        monkeypatch.setattr(imet, g, _Recorder(calls, g))
    agent = imet.ReporterAgent(interval_s=0.05)
    agent.collect_once()
    time.sleep(0.05)
    agent.collect_once()  # the CPU share needs two /proc/stat reads
    names = sorted({c[0] for c in calls})
    assert all(c[2] > 0 for c in calls if c[0] != "NODE_CPU_PERCENT")
    assert names == ["NODE_CPU_PERCENT", "NODE_MEM_USED", "PROC_FD_COUNT", "PROC_RSS"]
    _agree("reporter", pkg, names)


def test_port_device_gauge_reads_memory_allocated_only_when_cuda_is_live(monkeypatch):
    import torch

    from ray_tpu_torch.utils import internal_metrics as imet

    calls = []
    monkeypatch.setattr(imet, "DEVICE_MEM_USED", _Recorder(calls, "dev"))
    asked = []
    fake = types.SimpleNamespace(
        is_initialized=lambda: live[0], device_count=lambda: 2,
        memory_allocated=lambda i: asked.append(i) or 1000.0 * (i + 1))
    live = [False]
    monkeypatch.setattr(torch, "cuda", fake)
    imet.ReporterAgent().collect_once()
    assert calls == [] and asked == []  # no context made, nothing read
    live[0] = True
    imet.ReporterAgent().collect_once()
    assert calls == [("dev", "set", 1000.0, (("device", "0"),)),
                     ("dev", "set", 2000.0, (("device", "1"),))]


def test_port_reporter_in_a_daemon_imports_no_torch():
    code = ("import sys\n"
            "from ray_tpu_torch.utils import internal_metrics as imet\n"
            "a = imet.ReporterAgent(); a.collect_once(); a.collect_once()\n"
            "assert 'torch' not in sys.modules\n"
            "assert imet.PROC_RSS.labels().read() > 0\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def _rpc_service(observed):
    class Service:
        def echo(self, x):
            return x

        def add(self, a, b=0):
            return a + b

        def boom(self):
            raise ValueError("boom")

        def tell(self, x):
            observed.append(("told", x))

        def _observe_rpc(self, method, latency_ms):
            assert latency_ms >= 0.0
            observed.append(method)

    return Service()


@pytest.mark.parametrize("pkg", PKGS)
def test_rpc_server_observes_each_method(pkg, tmp_path):
    rpc = importlib.import_module(f"{pkg}.core.rpc")
    observed = []
    path = str(tmp_path / f"{pkg}.sock")
    server = rpc.RpcServer(path, _rpc_service(observed))
    cli = rpc.RpcClient(path)
    try:
        assert cli.call("echo", 7) == 7
        assert cli.call("add", 2, b=3) == 5
        with pytest.raises(ValueError):
            cli.call("boom")
        cli.notify("tell", 1)
        deadline = time.monotonic() + 10
        while "tell" not in observed and time.monotonic() < deadline:
            time.sleep(0.01)
        assert cli.call("echo", "last") == "last"
    finally:
        cli.close()
        server.shutdown()
    assert observed == ["echo", "add", "boom", ("told", 1), "tell", "echo"]
    _agree("rpc_hook", pkg, observed)


@pytest.mark.parametrize("pkg", PKGS)
def test_gcs_rpc_accounting(pkg, monkeypatch):
    gcs = importlib.import_module(f"{pkg}.core.gcs")
    calls = []
    monkeypatch.setattr(gcs.imet, "GCS_RPC_TOTAL", _Recorder(calls, "total"))
    monkeypatch.setattr(gcs.imet, "GCS_RPC_LATENCY", _Recorder(calls, "latency"))
    for method, ms in (("ping", 0.5), ("pubsub_poll", 900.0), ("kv_put", 1.25),
                       ("pubsub_poll2", 5000.0), ("heartbeat", 0.75)):
        gcs.GcsService._observe_rpc(object(), method, ms)
    _agree("gcs_rpc", pkg, calls)
    assert ("latency", "observe", 900.0, (("method", "pubsub_poll"),)) not in calls


@pytest.mark.parametrize("pkg", PKGS)
def test_device_trace_holds_the_named_span(pkg, tmp_path, capsys):
    prof = importlib.import_module(f"{pkg}.utils.profiling")
    if pkg == "ray_tpu":
        import jax.numpy as jnp

        def work():
            (jnp.ones((64, 64)) @ jnp.ones((64, 64))).block_until_ready()
    else:
        import torch

        def work():
            torch.ones(64, 64) @ torch.ones(64, 64)
    with prof.device_trace(str(tmp_path)):
        with prof.span("glue_span"):
            work()
    files = [os.path.join(r, f) for r, _, fs in os.walk(tmp_path) for f in fs]
    holds = [f for f in files if b"glue_span" in open(f, "rb").read()]
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[span]")]
    seen = [len(holds) >= 1, [ln.split(":")[0] for ln in line]]
    assert seen == [True, ["[span] glue_span"]]
    _agree("trace", pkg, seen)


def test_port_memory_profile_needs_a_card(tmp_path):
    import torch

    from ray_tpu_torch.utils import profiling

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.save_device_memory_profile(str(tmp_path / "snap.pickle"))


@pytest.mark.cuda
def test_port_device_glue_on_the_card(tmp_path):
    """On a card: the device gauge equals torch.cuda.memory_allocated(0), a
    trace names the flash forward kernel, and the memory snapshot is
    written."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.utils import internal_metrics as imet
    from ray_tpu_torch.utils import profiling

    q = torch.randn(1, 256, 4, 128, device="cuda", dtype=torch.bfloat16)
    with profiling.device_trace(str(tmp_path)):
        flash_attention(q, q, q, causal=True)
    imet.ReporterAgent().collect_once()
    assert imet.DEVICE_MEM_USED.labels(device="0").read() == torch.cuda.memory_allocated(0)
    assert b"flash_fwd" in (tmp_path / profiling.TRACE_FILE).read_bytes()
    profiling.save_device_memory_profile(str(tmp_path / "snap.pickle"))
    assert (tmp_path / "snap.pickle").stat().st_size > 0


def test_reporter_thread_starts_and_stops():
    from ray_tpu_torch.utils import internal_metrics as imet

    agent = imet.ReporterAgent(interval_s=0.05)
    agent.start()
    try:
        assert any(t.name == "reporter-agent" for t in threading.enumerate())
        deadline = time.monotonic() + 5
        while imet.PROC_FD_COUNT.labels().read() <= 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert imet.PROC_FD_COUNT.labels().read() > 0
    finally:
        agent.stop()
