"""Object serialization with zero-copy buffer support (the port of
ray_tpu/core/serialization.py).

Re-designs the reference's serialization entry point
(reference: python/ray/_private/serialization.py) around the pickle-5
out-of-band buffer protocol: large contiguous buffers (numpy arrays, bytes,
tensors) are split out of the pickle stream so they can be placed in (and
later mapped zero-copy out of) the shared-memory object store.

The JAX package dumps with cloudpickle. The port has no cloudpickle, so it
carries its own by-value reducer (`_Pickler.reducer_override`):

- importable functions and classes pickle by reference, as plain pickle does;
- everything else (closures, lambdas, nested defs, functions and classes of
  `__main__` or of a module passed to `register_pickle_by_value`) travels by
  value: a function's code through `marshal`, with the globals its code names
  (recursively through nested code objects), its closure cells, defaults,
  kwdefaults and `__dict__`; a class with its name, bases and attributes
  (a dataclass is rebuilt by `dataclasses.dataclass` from its fields).
  Recursion and mutual references resolve through pickle's memo, since a
  skeleton is memoized before its state is pickled;
- modules travel by name.

A `torch.Tensor` travels out of band as a numpy view of its bytes (bf16 as an
int16 view; torch's own tensor pickling, an in-band zip, is not used). A CUDA
tensor is copied to the host at put and moved onto the getter's current CUDA
device at get, the counterpart of the JAX package's "fetched to host at put,
`jax.device_put` on get"; a get in a process without a CUDA device raises.
torch is never imported here: a tensor can only exist where torch is loaded.
"""

from __future__ import annotations

import builtins
import dataclasses
import importlib
import io
import marshal
import pickle
import sys
import types
from typing import Any, List, Set, Tuple

# Header layout for a serialized object:
#   [u32 n_buffers][u64 len_meta][meta bytes][u64 len_b0][b0]...
_PROTOCOL = 5

# Buffers smaller than this are kept inline in the pickle stream; splitting
# tiny buffers out costs more than it saves.
_OOB_THRESHOLD = 1 << 16

_BY_VALUE_MODULES: Set[str] = set()


def register_pickle_by_value(module: types.ModuleType) -> None:
    """Functions and classes of `module` pickle by value from now on (for a
    module that the receiving process cannot import, such as a test file)."""
    _BY_VALUE_MODULES.add(module.__name__)


def _by_value(obj) -> bool:
    """True when `obj` (a function or class) cannot be found again by its
    module and qualified name in another process."""
    mod = getattr(obj, "__module__", None)
    if mod is None or mod == "__main__" or mod in _BY_VALUE_MODULES:
        return True
    if mod.split(".")[0] in _BY_VALUE_MODULES:
        return True
    found = sys.modules.get(mod)
    if found is None:
        return True
    for part in obj.__qualname__.split("."):
        found = getattr(found, part, None)
        if found is None:
            return True
    return found is not obj


# ------------------------------------------------------------------ functions


def _code_names(code: types.CodeType, out: Set[str]) -> Set[str]:
    out.update(code.co_names)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            _code_names(c, out)
    return out


class _EmptyCell:
    """Stands for a closure cell that has no value yet."""


_EMPTY = _EmptyCell()


def _make_function(code_bytes: bytes, base_globals: dict, name: str, ncells: int):
    base_globals.setdefault("__builtins__", builtins)
    closure = tuple(types.CellType() for _ in range(ncells)) if ncells else None
    return types.FunctionType(marshal.loads(code_bytes), base_globals, name, None, closure)


def _set_function_state(fn, state) -> None:
    names, defaults, kwdefaults, cells, fdict, doc, qualname, module = state
    fn.__globals__.update(names)
    fn.__defaults__ = defaults
    fn.__kwdefaults__ = kwdefaults
    fn.__dict__.update(fdict)
    fn.__doc__ = doc
    fn.__qualname__ = qualname
    fn.__module__ = module
    if cells:
        for cell, value in zip(fn.__closure__, cells):
            if value is not _EMPTY:
                cell.cell_contents = value


def _import_module(name: str):
    return importlib.import_module(name)


# -------------------------------------------------------------------- classes


def _make_class(meta, name: str, bases: tuple, base_ns: dict):
    return types.new_class(name, bases, {"metaclass": meta}, lambda ns: ns.update(base_ns))


def _set_class_state(cls, state) -> None:
    attrs, dc = state
    for k, v in attrs.items():
        setattr(cls, k, v)
    if dc is not None:
        fields, params = dc
        for fname, kw in fields:
            setattr(cls, fname, dataclasses.field(**kw))
        dataclasses.dataclass(cls, **params)


_DATACLASS_PARAMS = ("init", "repr", "eq", "order", "unsafe_hash", "frozen")


def _dataclass_spec(cls):
    """(fields, params) to rebuild a dataclass with `dataclasses.dataclass`."""
    fields = []
    for f in cls.__dict__["__dataclass_fields__"].values():
        if f._field_type is not dataclasses._FIELD:  # ClassVar / InitVar
            continue
        kw = {"init": f.init, "repr": f.repr, "hash": f.hash, "compare": f.compare,
              "kw_only": f.kw_only, "metadata": dict(f.metadata)}
        if f.default is not dataclasses.MISSING:
            kw["default"] = f.default
        if f.default_factory is not dataclasses.MISSING:
            kw["default_factory"] = f.default_factory
        fields.append((f.name, kw))
    p = cls.__dict__["__dataclass_params__"]
    return fields, {k: getattr(p, k) for k in _DATACLASS_PARAMS}


def _class_attrs(cls, skip: Set[str]) -> dict:
    slots = cls.__dict__.get("__slots__", ())
    slots = (slots,) if isinstance(slots, str) else tuple(slots)
    attrs = {}
    for k, v in cls.__dict__.items():
        if k in ("__dict__", "__weakref__", "__module__", "__qualname__", "__doc__") or k in skip:
            continue
        if k in slots:
            continue  # member descriptors: recreated from __slots__ in the namespace
        attrs[k] = v
    return attrs


def _class_reduce(cls):
    dc = None
    skip: Set[str] = set()
    if "__dataclass_fields__" in cls.__dict__:
        dc = _dataclass_spec(cls)
        skip = {"__dataclass_fields__", "__dataclass_params__", "__match_args__",
                "__hash__"} | {name for name, _ in dc[0]}
        # Methods that dataclasses generated (exec'd from source text) are
        # made again by dataclasses.dataclass on the other side.
        skip |= {k for k, v in cls.__dict__.items()
                 if isinstance(v, types.FunctionType) and v.__code__.co_filename == "<string>"}
    base_ns = {"__module__": cls.__module__, "__qualname__": cls.__qualname__,
               "__doc__": cls.__doc__}
    if "__slots__" in cls.__dict__:
        base_ns["__slots__"] = cls.__dict__["__slots__"]
    return (_make_class, (type(cls), cls.__name__, cls.__bases__, base_ns),
            (_class_attrs(cls, skip), dc), None, None, _set_class_state)


# -------------------------------------------------------------------- tensors

# torch dtypes numpy has no type for travel as a same-width integer view.
_INT_VIEW = {"bfloat16": "int16", "float8_e4m3fn": "uint8", "float8_e5m2": "uint8",
             "float8_e4m3fnuz": "uint8", "float8_e5m2fnuz": "uint8"}


def _tensor_reduce(t):
    import torch

    was_cuda = t.device.type == "cuda"
    requires_grad = bool(t.requires_grad)
    host = t.detach()
    if was_cuda:
        host = host.cpu()
    host = host.contiguous()
    dname = str(t.dtype).split(".")[-1]
    view = _INT_VIEW.get(dname)
    arr = (host.view(getattr(torch, view)) if view else host).numpy()
    return (_rebuild_tensor, (arr, dname, was_cuda, requires_grad,
                              isinstance(t, torch.nn.Parameter)))


def _rebuild_tensor(arr, dname: str, was_cuda: bool, requires_grad: bool, parameter: bool):
    import warnings

    import torch

    with warnings.catch_warnings():
        # A read-only array maps the store's sealed (immutable) object: the
        # tensor aliases it zero-copy, as the JAX package's numpy gets do.
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    if dname in _INT_VIEW:
        t = t.view(getattr(torch, dname))
    if was_cuda:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA tensor was put into the object store, and this process has no "
                "CUDA device to get it onto"
            )
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    if requires_grad:
        t.requires_grad_(True)
    if parameter:
        t = torch.nn.Parameter(t, requires_grad=requires_grad)
    return t


def _is_plain_tensor(obj) -> bool:
    torch = sys.modules.get("torch")
    if torch is None or not isinstance(obj, torch.Tensor):
        return False
    return type(obj) in (torch.Tensor, torch.nn.Parameter) and obj.layout == torch.strided


# -------------------------------------------------------------------- pickler


class _Pickler(pickle.Pickler):
    def __init__(self, file, buffer_callback=None):
        super().__init__(file, protocol=_PROTOCOL, buffer_callback=buffer_callback)
        # id(fn.__globals__) -> the shared base dict that every function of
        # one module gets on the other side (one pickled object, memoized).
        self._globals_ref = {}

    def _function_reduce(self, fn):
        code = fn.__code__
        g = fn.__globals__
        base = self._globals_ref.get(id(g))
        if base is None:
            base = self._globals_ref[id(g)] = {"__name__": g.get("__name__", fn.__module__)}
        names = {k: g[k] for k in _code_names(code, set()) if k in g}
        cells = None
        if fn.__closure__:
            cells = []
            for c in fn.__closure__:
                try:
                    cells.append(c.cell_contents)
                except ValueError:
                    cells.append(_EMPTY)
            cells = tuple(cells)
        state = (names, fn.__defaults__, fn.__kwdefaults__, cells, dict(fn.__dict__),
                 fn.__doc__, fn.__qualname__, fn.__module__)
        return (_make_function, (marshal.dumps(code), base, fn.__name__,
                                 len(code.co_freevars)), state, None, None, _set_function_state)

    def reducer_override(self, obj):
        t = type(obj)
        if t is types.FunctionType:
            if _by_value(obj):
                return self._function_reduce(obj)
            return NotImplemented
        if t is types.ModuleType:
            return (_import_module, (obj.__name__,))
        if isinstance(obj, type):
            if obj.__module__ != "builtins" and _by_value(obj):
                return _class_reduce(obj)
            return NotImplemented
        if t is classmethod or t is staticmethod:
            return (t, (obj.__func__,))
        if t is property:
            return (property, (obj.fget, obj.fset, obj.fdel, obj.__doc__))
        if t is _EmptyCell:
            return (_empty_cell, ())
        if _is_plain_tensor(obj):
            return _tensor_reduce(obj)
        return NotImplemented


def _empty_cell():
    return _EMPTY



def dumps(value: Any, buffer_callback=None) -> bytes:
    """One pickle stream of `value` through the port's reducer."""
    out = io.BytesIO()
    _Pickler(out, buffer_callback=buffer_callback).dump(value)
    return out.getvalue()


def loads(data, buffers=None) -> Any:
    return pickle.loads(data, buffers=buffers)


def serialize(value: Any) -> Tuple[bytes, List[memoryview]]:
    """Returns (meta, buffers). meta is the pickle stream; buffers are
    out-of-band zero-copy views into the original object's memory."""
    buffers: List[memoryview] = []

    def buffer_callback(buf: pickle.PickleBuffer) -> bool:
        view = buf.raw()
        if view.nbytes < _OOB_THRESHOLD:
            return True  # serialize in-band
        buffers.append(view)
        return False

    return dumps(value, buffer_callback), buffers


def deserialize(meta: bytes, buffers: List[memoryview]) -> Any:
    return pickle.loads(meta, buffers=[pickle.PickleBuffer(b) for b in buffers])


def pack(value: Any) -> bytes:
    """Single-buffer framing used when writing to the shm store or a socket."""
    meta, buffers = serialize(value)
    out = io.BytesIO()
    out.write(len(buffers).to_bytes(4, "little"))
    out.write(len(meta).to_bytes(8, "little"))
    out.write(meta)
    for b in buffers:
        out.write(b.nbytes.to_bytes(8, "little"))
        out.write(b)
    return out.getvalue()


def pack_into(value: Any, dst: memoryview) -> int:
    """Packs directly into a pre-sized writable buffer; returns bytes written."""
    data = pack(value)
    n = len(data)
    dst[:n] = data
    return n


def packed_size(meta: bytes, buffers: List[memoryview]) -> int:
    return 4 + 8 + len(meta) + sum(8 + b.nbytes for b in buffers)


def unpack_info(data) -> Tuple[Any, int]:
    """Inverse of pack; returns (value, n_out_of_band_buffers). Accepts bytes
    or a memoryview (zero-copy: out-of-band buffers are sub-views of `data`,
    so arrays and tensors alias, and keep alive, the source buffer)."""
    view = memoryview(data)
    n_buffers = int.from_bytes(view[:4], "little")
    len_meta = int.from_bytes(view[4:12], "little")
    off = 12
    meta = bytes(view[off : off + len_meta])
    off += len_meta
    buffers = []
    for _ in range(n_buffers):
        blen = int.from_bytes(view[off : off + 8], "little")
        off += 8
        buffers.append(view[off : off + blen])
        off += blen
    return deserialize(meta, buffers), n_buffers


def unpack(data) -> Any:
    return unpack_info(data)[0]
