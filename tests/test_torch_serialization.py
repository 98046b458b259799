"""The port's serializer (ray_tpu_torch/core/serialization.py) against the JAX
package's (ray_tpu/core/serialization.py, cloudpickle): the same functions,
classes and numpy payloads through both. The port's by-value blobs are
unpickled in a fresh interpreter that imports only the port (no test module,
no jax), which is the real test of by-value; the JAX package's round trip
runs in this process, as its worker would unpickle by reference there.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_tpu.core import serialization as jser
from ray_tpu_torch.core import serialization as tser

tser.register_pickle_by_value(sys.modules[__name__])
ROOT = Path(__file__).resolve().parent.parent

OFFSET = 100


def fact(n):
    return 1 if n <= 1 else n * fact(n - 1)


def is_even(n):
    return True if n == 0 else is_odd(n - 1)


def is_odd(n):
    return False if n == 0 else is_even(n - 1)


_FRESH = """
import pickle, sys
from ray_tpu_torch.core import serialization
fn, args = serialization.unpack(open(sys.argv[1], "rb").read())
try:
    out = ("ok", fn(*args))
except Exception as e:
    out = ("raised", type(e).__name__, str(e))
bad = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "ray_tpu", "cloudpickle"}
             | {m for m in sys.modules if m.startswith("test_")})
sys.stdout.buffer.write(pickle.dumps((out, bad)))
"""


def _in_fresh_process(tmp_path, fn, *args):
    """fn(*args) in a new interpreter that unpacks the port's blob."""
    path = tmp_path / "blob.bin"
    path.write_bytes(tser.pack((fn, args)))
    proc = subprocess.run([sys.executable, "-c", _FRESH, str(path)], cwd=ROOT,
                          capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()[-3000:]
    import pickle

    out, bad = pickle.loads(proc.stdout)
    assert bad == [], f"the fresh process loaded {bad}"
    return out


def _in_jax(fn, *args):
    g, a = jser.unpack(jser.pack((fn, args)))
    try:
        return ("ok", g(*a))
    except Exception as e:
        return ("raised", type(e).__name__, str(e))


def _make_adder(n):
    def add(x):
        return x + n + OFFSET

    return add


def _make_counter_pair():
    def helper(x):
        return x * 3

    def uses_helper(x):
        return helper(x) + 1

    return uses_helper


def _make_recursive_closure():
    def count_down(n):
        return 0 if n == 0 else 1 + count_down(n - 1)

    return count_down


def _local_class_probe(v):
    class Base:
        scale = 2

        def __init__(self, v):
            self.v = v

        def get(self):
            return self.v * self.scale

        @classmethod
        def make(cls, v):
            return cls(v)

        @staticmethod
        def seven():
            return 7

        @property
        def doubled(self):
            return self.v * 2

    class Child(Base):
        def get(self):
            return super().get() + 1

    c = Child.make(v)
    return (c.get(), c.seven(), c.doubled, type(c).__name__, type(c).__mro__[1].__name__)


def _local_dataclass_probe(x):
    @dataclasses.dataclass
    class Point:
        x: int
        tags: list = dataclasses.field(default_factory=list)
        z: float = 1.5

        def norm1(self):
            return abs(self.x) + self.z

    @dataclasses.dataclass(frozen=True)
    class Frozen:
        a: int

    p = Point(x)
    p.tags.append("t")
    try:
        Frozen(1).a = 2
        frozen = False
    except dataclasses.FrozenInstanceError:
        frozen = True
    return (repr(p), p == Point(x, ["t"]), p.norm1(), dataclasses.asdict(p), frozen,
            [f.name for f in dataclasses.fields(Point)], Point(0).tags is not Point(0).tags)


def _local_error_probe(msg):
    class QuotaError(ValueError):
        pass

    raise QuotaError(msg)


CASES = {
    "closure": (lambda: _make_adder(5), (10,)),
    "lambda": (lambda: (lambda x, y=2: x * y + OFFSET), (7,)),
    "nested_defs": (lambda: _make_counter_pair(), (4,)),
    "recursive": (lambda: fact, (6,)),
    "mutual_recursion": (lambda: is_even, (11,)),
    "recursive_closure": (lambda: _make_recursive_closure(), (25,)),
    "test_local_classes": (lambda: _local_class_probe, (3,)),
    "test_local_dataclasses": (lambda: _local_dataclass_probe, (-4,)),
    "test_local_exception": (lambda: _local_error_probe, ("over quota",)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_by_value_in_a_fresh_process_matches_cloudpickle(case, tmp_path):
    make, args = CASES[case]
    want = _in_jax(make(), *args)
    got = _in_fresh_process(tmp_path, make(), *args)
    assert got == want


def test_importable_functions_travel_by_reference():
    """A function the other side can import is pickled by name (no code)."""
    import os.path

    meta, buffers = tser.serialize(os.path.join)
    assert b"posixpath" in meta and b"join" in meta and len(meta) < 100
    assert tser.unpack(tser.pack(os.path.join)) is os.path.join


def test_cpu_tensor_is_out_of_band_and_zero_copy():
    t = torch.arange(1 << 16, dtype=torch.float32)
    meta, buffers = tser.serialize(t)
    assert len(buffers) == 1 and buffers[0].nbytes == t.numel() * 4 and len(meta) < 1024
    framed = bytearray(tser.pack(t))
    out = tser.unpack(memoryview(framed))
    assert torch.equal(out, t)
    # The tensor aliases the framed buffer: no copy on the way out.
    off = len(framed) - t.numel() * 4
    framed[off:off + 4] = np.float32(-1.0).tobytes()
    assert out[0].item() == -1.0


def test_bf16_tensor_travels_as_int16_and_keeps_its_bits():
    g = torch.Generator().manual_seed(0)
    t = torch.randn((256, 300), generator=g).to(torch.bfloat16)
    meta, buffers = tser.serialize(t)
    assert len(buffers) == 1 and buffers[0].nbytes == t.numel() * 2
    out = tser.unpack(memoryview(bytearray(tser.pack(t))))
    assert out.dtype == torch.bfloat16 and out.shape == t.shape
    assert torch.equal(out.view(torch.int16), t.view(torch.int16))


def test_tensor_attributes_survive():
    w = torch.nn.Parameter(torch.ones(3, 4))
    x = torch.arange(12.0).reshape(3, 4).t()  # not contiguous
    out_w, out_x = tser.unpack(tser.pack((w, x)))
    assert isinstance(out_w, torch.nn.Parameter) and out_w.requires_grad
    assert torch.equal(out_x, x) and out_x.is_contiguous()


def test_cuda_tensor_get_without_a_device_raises():
    """A CUDA tensor put by another process is moved onto this process's
    current CUDA device at get; a process without one raises, it does not
    hand back a CPU tensor."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a process without a CUDA device")
    arr = np.arange(4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tser._rebuild_tensor(arr, "float32", True, False, False)


@pytest.mark.parametrize("packer", ["jax", "torch"])
def test_numpy_payload_packed_by_either_package_unpacks_equal(packer):
    rng = np.random.default_rng(0)
    payload = {"big": rng.standard_normal((300, 200)).astype(np.float32),
               "small": np.arange(10, dtype=np.int64), "meta": ("x", 3, [1.5, None])}
    blob = (jser if packer == "jax" else tser).pack(payload)
    a, b = jser.unpack(blob), tser.unpack(memoryview(blob))
    for got in (a, b):
        np.testing.assert_array_equal(got["big"], payload["big"])
        np.testing.assert_array_equal(got["small"], payload["small"])
        assert got["meta"] == payload["meta"]
    # The large array went out of band in both framings.
    assert int.from_bytes(blob[:4], "little") == 1
