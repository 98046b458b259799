"""A cluster that spans hosts, over TCP, on the port against the JAX package:
tests/test_tcp_cluster.py's six cases, each run on both packages (the head
announces its TCP address, a joined node registers and runs tasks, objects
cross nodes over TCP, the auth token gates connections, `parse_address`
rejects a portless tcp address, and a remote-client driver), and streaming
returns through a remote client (tests/torch_stream_cases.py) against a
driver inside the cluster.

Simulated on one machine through loopback: the head serves its GCS on a
TCP port, and a worker "host" joins with `start_worker_node` given only that
tcp:// address (a session dir of its own, nothing shared), the path a
separate machine takes. One such cluster of each package serves the file.

The port refuses to serve TCP without RAY_TPU_AUTH_TOKEN, where the JAX
package only warns (the control plane speaks pickle: an open port runs code
for whoever reaches it), so this file sets a token for both clusters, and
one more case checks the refusal.
"""

import os
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest

import ray_tpu as jrt
import ray_tpu_torch as trt
from ray_tpu_torch.core import serialization
import torch_modes

serialization.register_pickle_by_value(sys.modules[__name__])

PKGS = ("jax", "torch")
TOKEN = "tcp-cluster-test-token"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_PKG = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}


@pytest.fixture(scope="module")
def tcp_clusters():
    from ray_tpu.core import runtime_base as jbase
    from ray_tpu.core.cluster_runtime import start_worker_node as jax_join
    from ray_tpu_torch.core import runtime_base as tbase
    from ray_tpu_torch.core.cluster_runtime import Cluster as TorchCluster
    from ray_tpu_torch.core.cluster_runtime import start_worker_node as torch_join

    saved = os.environ.get("RAY_TPU_AUTH_TOKEN")
    os.environ["RAY_TPU_AUTH_TOKEN"] = TOKEN
    jrt.shutdown()
    trt.shutdown()
    out, stops = {}, []
    # What the boots start (two heads, two joined nodes, their workers) is
    # found as this process's new descendants if a boot or teardown stalls.
    before = torch_modes.descendants()
    try:
        with torch_modes.fixture_time_limit(torch_modes.BOOT_LIMIT_S,
                                            lambda: torch_modes.kill_started_since(before)):
            jc = torch_modes.boot_jax_cluster(num_cpus=1, head_port=0)
            stops.append(jc.shutdown)
            jbase.set_runtime(jc.runtime())
            stops.append(jrt.shutdown)
            jj = torch_modes.jax_boot(jax_join, jc.gcs_tcp_address, num_cpus=2,
                                      resources={"joined": 1.0})
            stops.append(lambda: jj["proc"].poll() is None and jj["proc"].kill())
            out["jax"] = types.SimpleNamespace(rt=jrt, cluster=jc, joined=jj, name="jax")
            tc = torch_modes.boot_cluster(TorchCluster, num_cpus=1, num_gpus=0, head_port=0)
            stops.append(tc.shutdown)
            tbase.set_runtime(tc.runtime())
            stops.append(trt.shutdown)
            tj = torch_join(tc.gcs_tcp_address, num_cpus=2, num_gpus=0,
                            resources={"joined": 1.0})
            stops.append(tj["shutdown"])
            out["torch"] = types.SimpleNamespace(rt=trt, cluster=tc, joined=tj, name="torch")
        yield out
    finally:
        with torch_modes.fixture_time_limit(torch_modes.TEARDOWN_LIMIT_S,
                                            lambda: torch_modes.kill_started_since(before)):
            for stop in reversed(stops):
                stop()
        if saved is None:
            os.environ.pop("RAY_TPU_AUTH_TOKEN", None)
        else:
            os.environ["RAY_TPU_AUTH_TOKEN"] = saved


@pytest.fixture(params=PKGS)
def c(request, tcp_clusters):
    return tcp_clusters[request.param]


def test_head_announces_tcp_address(c):
    assert c.cluster.gcs_tcp_address.startswith("tcp://")


def test_joined_node_registers_and_runs_tasks(c):
    rt, joined = c.rt, c.joined
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if any(n["NodeID"] == joined["node_id"] and n["Alive"] for n in rt.nodes()):
            break
        time.sleep(0.2)
    nodes = {n["NodeID"]: n for n in rt.nodes()}
    assert joined["node_id"] in nodes and nodes[joined["node_id"]]["Alive"]
    assert nodes[joined["node_id"]]["sock"].startswith("tcp://")  # not a UDS path

    @rt.remote(resources={"joined": 1.0})
    def where():
        return rt.get_runtime_context().get_node_id()

    assert rt.get(where.remote(), timeout=60) == joined["node_id"]


def test_cross_node_object_transfer_over_tcp(c):
    rt = c.rt

    @rt.remote(resources={"joined": 1.0})
    def produce():
        import numpy as np

        return np.arange(1 << 20, dtype=np.float64)

    @rt.remote(resources={"joined": 1.0})
    def consume(a):
        return float(a.sum())

    arr = rt.get(produce.remote(), timeout=60)  # the head pulls it from the joined node
    np.testing.assert_array_equal(arr, np.arange(1 << 20, dtype=np.float64))
    data = rt.put(np.ones(1 << 18, dtype=np.float32))  # and ships one there
    assert rt.get(consume.remote(data), timeout=60) == float(1 << 18)


@pytest.mark.parametrize("name", PKGS)
def test_tcp_auth_token_gates_connections(name, monkeypatch):
    """With RAY_TPU_AUTH_TOKEN set, a peer without the token is dropped and
    one with it is served."""
    pkg = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}[name]
    rpc = __import__(f"{pkg}.core.rpc", fromlist=["RpcServer"])
    monkeypatch.setenv("RAY_TPU_AUTH_TOKEN", "s3cret")

    class Svc:
        def ping(self):
            return "pong"

    server = rpc.RpcServer("tcp://127.0.0.1:0", Svc())
    try:
        cli = rpc.RpcClient(server.address)
        assert cli.call("ping", timeout=10) == "pong"
        cli.close()
        monkeypatch.setenv("RAY_TPU_AUTH_TOKEN", "wrong")
        bad = rpc.RpcClient(server.address)
        with pytest.raises((ConnectionError, OSError)):
            bad.call("ping", timeout=5)
        bad.close()
    finally:
        server.shutdown()


def test_port_refuses_tcp_without_a_token(monkeypatch):
    from ray_tpu_torch.core.cluster_runtime import Cluster, start_worker_node
    from ray_tpu_torch.core.rpc import RpcServer

    monkeypatch.delenv("RAY_TPU_AUTH_TOKEN", raising=False)
    with pytest.raises(ValueError, match="RAY_TPU_AUTH_TOKEN"):
        RpcServer("tcp://127.0.0.1:0", object())
    with pytest.raises(ValueError, match="RAY_TPU_AUTH_TOKEN"):
        Cluster(num_cpus=1, num_gpus=0, head_port=0)  # before it starts anything
    with pytest.raises(ValueError, match="RAY_TPU_AUTH_TOKEN"):
        start_worker_node("tcp://127.0.0.1:1")


@pytest.mark.parametrize("name", PKGS)
def test_parse_address_rejects_portless_tcp(name):
    pkg = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}[name]
    parse_address = __import__(f"{pkg}.core.rpc", fromlist=["parse_address"]).parse_address
    with pytest.raises(ValueError, match="tcp://host:port"):
        parse_address("tcp://10.0.0.1")
    assert parse_address("tcp://10.0.0.1:6379") == ("tcp", ("10.0.0.1", 6379))
    assert parse_address("/tmp/x.sock") == ("uds", "/tmp/x.sock")


def test_remote_client_driver(c):
    """A driver in another process that has only the head's tcp:// address
    (no session dir, no pool of its own) gets the whole API through a
    gateway raylet."""
    pkg = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}[c.name]
    script = textwrap.dedent(f"""
        import numpy as np
        import {pkg} as rt

        rt.init(address={c.cluster.gcs_tcp_address!r})

        @rt.remote
        def square(x):
            return x * x

        assert rt.get([square.remote(i) for i in range(5)], timeout=60) == [0, 1, 4, 9, 16]
        ref = rt.put(np.arange(1 << 16, dtype=np.float32))

        @rt.remote
        def total(a):
            return float(a.sum())

        assert rt.get(total.remote(ref), timeout=60) == float(np.arange(1 << 16,
                                                                      dtype=np.float32).sum())

        @rt.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def bump(self):
                self.n += 1
                return self.n

        k = Counter.remote()
        assert rt.get([k.bump.remote() for _ in range(3)], timeout=60) == [1, 2, 3]
        assert rt.cluster_resources().get("CPU", 0) >= 3
        rt.shutdown()
        print("CLIENT_OK")
        """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert "CLIENT_OK" in out.stdout, (out.stdout, out.stderr[-2000:])


def test_remote_client_streams(tcp_clusters, request):
    """Streaming returns through a remote client. The reference is the JAX
    driver inside its cluster, with the streams on its own node: the items
    in order, the end of the stream, the error at the index it was raised,
    and a cancel ending an endless stream. The port's remote client gives
    exactly that with the streams on the joined node, and so does the port's
    driver inside its cluster.

    Two faults of the JAX package the port does not copy: its remote client
    blocks on the first item (its stream_next looks for the item in a local
    pool the client does not have), and its in-cluster driver blocks on the
    second item made on another node (a wait for "item or header" returns
    at once once the header is local, before the item's pull starts). The
    JAX client is held to the first, with a short bound."""
    import json

    import torch_stream_cases

    with torch_modes.case_time_limit(request, 300):
        head = jrt.NodeAffinitySchedulingStrategy(jrt.get_runtime_context().get_node_id(),
                                                  soft=False)
        reference = torch_stream_cases.observe(jrt, bound_s=30,
                                               options={"scheduling_strategy": head})
        assert reference["task"] == [0, 10, 20, 30, 40, "end"], reference
        assert reference["actor"] == [100, 101, 102, "end"], reference
        assert reference["error"][0] == 1 and "boom" in reference["error"][1], reference
        assert reference["error"][2] == "end", reference
        assert reference["cancel"][0] == 0 and reference["cancel"][2], reference
        reference = json.loads(json.dumps(reference))
        inside = torch_stream_cases.observe(trt, bound_s=30)
        assert json.loads(json.dumps(inside)) == reference

        remote = {}
        for name, bound, first in (("jax", 5, True), ("torch", 30, False)):
            script = textwrap.dedent(f"""
                import json, sys
                sys.path.insert(0, {os.path.join(ROOT, "tests")!r})
                import {ROOT_PKG[name]} as rt
                import torch_stream_cases

                rt.init(address={tcp_clusters[name].cluster.gcs_tcp_address!r})
                seen = torch_stream_cases.observe(rt, bound_s={bound}, only_first={first})
                print("OBSERVED=" + json.dumps(seen), flush=True)
                """)
            out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                                 timeout=180, cwd=ROOT)
            line = [ln for ln in out.stdout.splitlines() if ln.startswith("OBSERVED=")]
            assert line, (out.stdout[-2000:], out.stderr[-3000:])
            remote[name] = json.loads(line[0][len("OBSERVED="):])
        assert remote["jax"] == {"task": ["blocked"]}
        assert remote["torch"] == reference
