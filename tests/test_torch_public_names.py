"""Public names of the JAX package that the port lacked, each held to the JAX
one: `Result.best_checkpoints`, `ResultGrid.get_dataframe`, the exceptions
`ActorUnavailableError` and `RuntimeEnvSetupError`, `node_labels` of the node
providers, `all_accelerator_managers` / `detect_accelerators` and the
AcceleratorManager type and extra-resource probes, `ZeroSharder.opt_specs`,
`serialization.pack_into`, and the re-exports of the `models`, `ops` and
`observability` packages.
"""

import importlib
import json
import os
import subprocess
import sys
import textwrap
import time
import types

import jax
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

ROOT = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}
PKGS = ("jax", "torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mod(name, m):
    return importlib.import_module(f"{ROOT[name]}.{m}")


# ------------------------------------------------------------ train, tune
@pytest.mark.parametrize("with_checkpoint", [True, False], ids=["checkpoint", "none"])
def test_best_checkpoints_matches_jax(with_checkpoint):
    seen = {}
    for name in PKGS:
        train = _mod(name, "train")
        ckpt = train.Checkpoint.from_dict({"step": 3}) if with_checkpoint else None
        result = train.Result(metrics={"loss": 1.0}, checkpoint=ckpt, path="/x")
        seen[name] = [c.to_dict() for c in result.best_checkpoints]
    assert seen["jax"] == seen["torch"] == ([{"step": 3}] if with_checkpoint else [])


def _grid(name):
    tune, train = _mod(name, "tune.tuner"), _mod(name, "train")
    results = [train.Result(metrics={"loss": float(i), "trial": i}, checkpoint=None,
                            path=f"/t{i}") for i in range(3)]
    return tune.ResultGrid(results, "loss", "min")


def test_get_dataframe_matches_jax():
    frames = {name: _grid(name).get_dataframe() for name in PKGS}
    assert list(frames["torch"].columns) == list(frames["jax"].columns)
    assert frames["torch"].to_dict("records") == frames["jax"].to_dict("records")


@pytest.mark.parametrize("name", PKGS)
def test_get_dataframe_needs_pandas(name, monkeypatch):
    grid = _grid(name)
    monkeypatch.setitem(sys.modules, "pandas", None)  # as where pandas is absent
    with pytest.raises(ImportError):
        grid.get_dataframe()


# -------------------------------------------------------------- exceptions
@pytest.mark.parametrize("cls", ["ActorUnavailableError", "RuntimeEnvSetupError"])
def test_exception_classes_keep_their_bases(cls):
    mros = {name: [c.__name__ for c in getattr(_mod(name, "exceptions"), cls).__mro__]
            for name in PKGS}
    assert mros["torch"] == mros["jax"]
    exc = _mod("torch", "exceptions")
    assert issubclass(getattr(exc, cls), exc.RayTpuError)


# ------------------------------------------------------------ node labels
class _FakeCluster:
    """Stands in for a Cluster: add_node hands out node ids."""

    def __init__(self):
        self.added = []

    def add_node(self, **kw):
        self.added.append(kw)
        return f"node{len(self.added)}"

    def remove_node(self, nid):
        pass


@pytest.mark.parametrize("hosts", [1, 2])
def test_node_labels_match_jax(hosts):
    seen = {}
    for name in PKGS:
        np_mod = _mod(name, "accelerators.node_provider")
        assert np_mod.NodeProvider().node_labels("anything") == {}
        provider = np_mod.LocalNodeProvider(_FakeCluster())
        cloud_id = provider.request(types.SimpleNamespace(
            instance_id="i", shape={"cpus": 1, "slice_hosts": hosts}))
        deadline = time.monotonic() + 10
        while provider.poll()[cloud_id] == "pending" and time.monotonic() < deadline:
            time.sleep(0.01)
        assert provider.poll()[cloud_id] == "running"
        seen[name] = (provider.node_labels(cloud_id), provider.node_labels("unknown"))
    assert seen["torch"] == seen["jax"]
    labels = seen["torch"][0]
    assert labels["ray_tpu_cloud_id"] == "local-1"
    assert ("slice_name" in labels) == (hosts > 1)


# ------------------------------------------------------------ accelerators
def test_accelerator_manager_probes_default_like_jax():
    for name in PKGS:
        mgr = _mod(name, "accelerators.accelerator").AcceleratorManager()
        assert mgr.get_current_node_accelerator_type() is None, name
        assert mgr.get_current_node_additional_resources() == {}, name


_SMI = textwrap.dedent("""\
    Attached GPUs                             : 2
    GPU 00000000:18:00.0
        Product Name                          : NVIDIA H100 80GB HBM3
""")


def test_detect_accelerators_reports_the_gpu_manager(monkeypatch):
    acc = importlib.import_module("ray_tpu_torch.accelerators")
    monkeypatch.setattr(acc, "_registry", {})
    fake = acc.GpuAcceleratorManager(env={}, device_count=lambda: 2, smi=lambda: _SMI)
    acc.register_accelerator_manager(fake)
    managers = {m.get_resource_name(): m for m in acc.all_accelerator_managers()}
    assert set(managers) == {"CPU", "GPU"} and managers["GPU"] is fake
    assert acc.detect_accelerators() == {"GPU": 2.0}
    assert fake.get_current_node_accelerator_type() == "NVIDIA H100 80GB HBM3"
    assert fake.get_current_node_additional_resources() == {}

    acc.register_accelerator_manager(
        acc.GpuAcceleratorManager(env={}, device_count=lambda: 0, smi=lambda: ""),
        override=True)
    assert acc.detect_accelerators() == {}
    assert acc.get_accelerator_manager("GPU").get_current_node_accelerator_type() is None


def test_detect_accelerators_skips_a_family_that_cannot_probe(monkeypatch):
    """As the JAX function does: a manager whose probe raises counts none."""
    for name in PKGS:
        acc = importlib.import_module(f"{ROOT[name]}.accelerators")
        base = _mod(name, "accelerators.accelerator").AcceleratorManager

        class Broken(base):
            def get_resource_name(self):
                return "BROKEN"

            def get_current_node_num_accelerators(self):
                raise RuntimeError("no driver")

        monkeypatch.setattr(acc, "_registry", {})
        acc.register_accelerator_manager(Broken())
        assert "BROKEN" not in acc.detect_accelerators(), name
        assert "BROKEN" in {m.get_resource_name() for m in acc.all_accelerator_managers()}


# ------------------------------------------------------------------- ZeRO
_OPT_SPECS_RANK = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    from ray_tpu_torch.train.zero import ZeroSharder
    rank, url = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=url, rank=rank, world_size=2)
    try:
        params = {"w": torch.zeros(13, 7), "b": torch.zeros(5), "s": torch.tensor(2.0)}
        sharder = ZeroSharder(params)
        shards = [torch.nn.Parameter(t) for t in sharder.shard(params).values()]
        specs = sharder.opt_specs(torch.optim.AdamW(shards))
        flat = {"count": specs["count"]}
        for m in ("mu", "nu"):
            flat.update({f"{m}/{k}": v for k, v in specs[m].items()})
        print("@@" + json.dumps({k: [repr(p) for p in v] for k, v in flat.items()}))
    finally:
        dist.destroy_process_group()
""")


def test_opt_specs_match_jax(tmp_path):
    params = {"w": np.zeros((13, 7), np.float32), "b": np.zeros((5,), np.float32),
              "s": np.float32(2.0)}
    jzero = importlib.import_module("ray_tpu.train.zero")
    mesh = Mesh(np.array(jax.devices("cpu")[:2]), ("data",))
    tx = optax.adamw(1e-2)
    sharder = jzero.ZeroSharder(params, mesh, axis="data")
    jspecs = sharder.opt_specs(jzero.init_opt_state(tx, params, mesh, axis="data"))
    # JAX's tree is (ScaleByAdamState(count, mu, nu), EmptyState, EmptyState).
    jflat = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        keys = [getattr(k, "name", getattr(k, "key", None)) for k in path[1:]]
        jflat["/".join(str(k) for k in keys)] = tuple(spec)

    script = tmp_path / "rank.py"
    script.write_text(_OPT_SPECS_RANK)
    url = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, *filter(None, [os.environ.get("PYTHONPATH")])]))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), url], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    port = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        port.append(json.loads(next(ln for ln in out.splitlines() if ln.startswith("@@"))[2:]))
    assert port[0] == port[1]
    as_jax = {"Replicate()": (), "Shard(dim=0)": ("data",)}
    assert {k: tuple(x for p in v for x in as_jax[p]) for k, v in port[0].items()} == jflat
    assert jflat["count"] == () and jflat["mu/0"] == ("data",)


# ----------------------------------------------------------- serialization
def test_pack_into_matches_jax_framing():
    value = {"a": np.arange(1 << 14, dtype=np.float32), "b": [1, "two", 3.0]}
    frames = {}
    for name in PKGS:
        ser = _mod(name, "core.serialization")
        packed = ser.pack(value)
        dst = memoryview(bytearray(len(packed) + 64))
        n = ser.pack_into(value, dst)
        assert n == len(packed) and bytes(dst[:n]) == packed, name
        back = ser.unpack(dst[:n])
        assert back["b"] == value["b"] and np.array_equal(back["a"], value["a"]), name
        frames[name] = packed
    # The same framing: buffer count, then the out-of-band buffer, byte for
    # byte (only the pickle stream differs between the two packages).
    for packed in frames.values():
        assert int.from_bytes(packed[:4], "little") == 1
        assert packed.endswith(value["a"].tobytes())


def test_pack_into_refuses_a_short_buffer():
    for name in PKGS:
        ser = _mod(name, "core.serialization")
        with pytest.raises((ValueError, IndexError)):
            ser.pack_into(np.arange(1 << 14, dtype=np.float32), memoryview(bytearray(16)))


# ------------------------------------------------------- package re-exports
@pytest.mark.parametrize("package", ["models", "ops", "observability"])
def test_package_reexports_match_jax(package):
    names = {name: _mod(name, package).__all__ for name in PKGS}
    # ops.flash_attention stays the port's module (its launch counters are
    # read through it); the JAX package's function is flash_attention_fn.
    extra = {"ops": ["flash_attention_fn"]}.get(package, [])
    assert names["torch"] == names["jax"] + extra
    mod = _mod("torch", package)
    for attr in names["torch"]:
        assert getattr(mod, attr) is not None, attr


def test_reexported_models_are_the_port_modules():
    models = importlib.import_module("ray_tpu_torch.models")
    tfm = importlib.import_module("ray_tpu_torch.models.transformer")
    assert models.llama2_7b is tfm.llama2_7b and models.forward is tfm.forward
    jcfg, tcfg = importlib.import_module("ray_tpu.models").tiny(), models.tiny()
    assert (tcfg.d_model, tcfg.n_layers, tcfg.n_heads, tcfg.vocab_size) == (
        jcfg.d_model, jcfg.n_layers, jcfg.n_heads, jcfg.vocab_size)
    import torch

    ops = importlib.import_module("ray_tpu_torch.ops")
    module = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    assert ops.flash_attention is module and hasattr(module, "flash_fwd")  # launch counters
    flash = ops.flash_attention_fn
    assert flash is module.flash_attention
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 64, 2, 64, generator=g) for _ in range(3))
    assert torch.equal(flash(q, k, v, causal=True), module.flash_attention(q, k, v, causal=True))
