"""HF-format (safetensors) checkpoints in and out of the port's param tree,
the counterpart of ray_tpu/train/hf_checkpoint.py.

The safetensors container is parsed here (8-byte little-endian JSON header
length, JSON tensor index, raw row-major buffer) over an mmap, and each
tensor is a read-only torch view of the mapped bytes (bfloat16 included,
with no ml_dtypes). `load_hf_checkpoint` assembles the stacked
[n_layers, ...] params one stacked tensor at a time, copying each layer's
tensor straight into its slot on the device, so the host never holds the
model. `export_hf_checkpoint` writes the tree back out under HF names, with
the same header as the JAX package's writer.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import warnings
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..models import transformer as tfm

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


class SafetensorsFile:
    """Zero-copy reader over one .safetensors file. Close it only once the
    views it handed out are gone."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (hdr_len,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(hdr_len))
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self._base = 8 + hdr_len
        header.pop("__metadata__", None)
        self._index: Dict[str, dict] = header

    def keys(self) -> List[str]:
        return list(self._index)

    def get(self, name: str) -> torch.Tensor:
        """A read-only CPU view into the mapped file (no copy): copy it
        before writing to it."""
        meta = self._index[name]
        dt = _DTYPES[meta["dtype"]]
        start, end = meta["data_offsets"]
        count = (end - start) // torch.empty((), dtype=dt).element_size()
        if count == 0:
            return torch.empty(meta["shape"], dtype=dt)
        with warnings.catch_warnings():  # the mapping is read-only, and so is the view
            warnings.filterwarnings("ignore", message="The given buffer is not writable")
            t = torch.frombuffer(self._mm, dtype=dt, count=count, offset=self._base + start)
        return t.reshape(meta["shape"])

    def close(self) -> None:
        self._mm.close()


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Minimal writer: row-major, offsets in key order, the JAX package's
    header byte for byte."""
    index: Dict[str, Any] = {}
    off = 0
    blobs: List[bytes] = []
    for name, t in tensors.items():
        t = t.detach().to("cpu").contiguous()
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        index[name] = {
            "dtype": _DTYPE_NAMES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [off, off + len(blob)],
        }
        off += len(blob)
        blobs.append(blob)
    hdr = json.dumps(index).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        for b in blobs:
            f.write(b)


def open_checkpoint(path: str) -> Dict[str, SafetensorsFile]:
    """`name -> file` map for a checkpoint dir (with the multi-shard
    model.safetensors.index.json layout, or one model.safetensors) or a
    single .safetensors file."""
    if os.path.isfile(path):
        f = SafetensorsFile(path)
        return {k: f for k in f.keys()}
    index_path = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as fh:
            weight_map = json.load(fh)["weight_map"]
        files: Dict[str, SafetensorsFile] = {}
        out = {}
        for name, fname in weight_map.items():
            if fname not in files:
                files[fname] = SafetensorsFile(os.path.join(path, fname))
            out[name] = files[fname]
        return out
    single = os.path.join(path, "model.safetensors")
    if os.path.exists(single):
        f = SafetensorsFile(single)
        return {k: f for k in f.keys()}
    raise FileNotFoundError(f"no safetensors checkpoint under {path}")


# ----------------------------------------------------------------- name maps
# Each entry: the port's tree path -> (per_layer, hf_name_fn, transpose).
# HF Linear weights are [out, in]; the model computes x @ W with W [in, out],
# so every projection is transposed. Embeddings stay [v, d].

Entry = Tuple[bool, Callable[[int], str], bool]


def llama_name_map() -> Dict[str, Entry]:
    layer = "model.layers.{}."
    return {
        "embed.embedding": (False, lambda _: "model.embed_tokens.weight", False),
        "blocks.attn_norm.scale": (True, (layer + "input_layernorm.weight").format, False),
        "blocks.attn.wq": (True, (layer + "self_attn.q_proj.weight").format, True),
        "blocks.attn.wk": (True, (layer + "self_attn.k_proj.weight").format, True),
        "blocks.attn.wv": (True, (layer + "self_attn.v_proj.weight").format, True),
        "blocks.attn.wo": (True, (layer + "self_attn.o_proj.weight").format, True),
        "blocks.mlp_norm.scale": (True, (layer + "post_attention_layernorm.weight").format,
                                  False),
        "blocks.mlp.w_gate": (True, (layer + "mlp.gate_proj.weight").format, True),
        "blocks.mlp.w_up": (True, (layer + "mlp.up_proj.weight").format, True),
        "blocks.mlp.w_down": (True, (layer + "mlp.down_proj.weight").format, True),
        "final_norm.scale": (False, lambda _: "model.norm.weight", False),
        "lm_head": (False, lambda _: "lm_head.weight", True),
    }


def gptj_name_map() -> Dict[str, Entry]:
    """GPT-J-6B (parallel block, gelu MLP). GPT-J's biases
    (fc_in/fc_out/out_proj/lm_head/ln_1.bias) have no slot in this bias-free
    model and are dropped; ln_1's weight is attn_norm (the block's one
    pre-norm); mlp_norm, unused under parallel_block, loads as ones."""
    layer = "transformer.h.{}."
    return {
        "embed.embedding": (False, lambda _: "transformer.wte.weight", False),
        "blocks.attn_norm.scale": (True, (layer + "ln_1.weight").format, False),
        "blocks.attn.wq": (True, (layer + "attn.q_proj.weight").format, True),
        "blocks.attn.wk": (True, (layer + "attn.k_proj.weight").format, True),
        "blocks.attn.wv": (True, (layer + "attn.v_proj.weight").format, True),
        "blocks.attn.wo": (True, (layer + "attn.out_proj.weight").format, True),
        "blocks.mlp.w_up": (True, (layer + "mlp.fc_in.weight").format, True),
        "blocks.mlp.w_down": (True, (layer + "mlp.fc_out.weight").format, True),
        "final_norm.scale": (False, lambda _: "transformer.ln_f.weight", False),
        "lm_head": (False, lambda _: "lm_head.weight", True),
    }


NAME_MAPS = {"llama": llama_name_map, "gptj": gptj_name_map}


def _entries(cfg, family: str):
    """The name map's entries this config has a param for."""
    for dotted, entry in NAME_MAPS[family]().items():
        if dotted == "lm_head" and cfg.tie_embeddings:
            continue
        if dotted == "blocks.mlp.w_gate" and cfg.mlp_act != "swiglu":
            continue
        yield dotted, entry


def _tree_get(tree, dotted: str):
    for p in dotted.split("."):
        tree = tree[p]
    return tree


def load_hf_checkpoint(path: str, cfg, *, family: str = "llama", device=None, dtype=None):
    """The port's param tree (param_spec's order) from an HF checkpoint, on
    `device` (CUDA unless the caller passes "cpu") in `dtype` (default
    cfg.dtype). Each stacked [n_layers, ...] tensor is allocated on the
    device and filled one layer at a time from the mapped file. A param
    under parallel_block that the checkpoint has no tensor for (GPT-J's
    mlp_norm) is ones, as init_params makes it; any other missing tensor
    raises KeyError naming it."""
    from .._device import resolve_device

    dev = resolve_device(device)
    dt = dtype if dtype is not None else cfg.dtype
    files = open_checkpoint(path)
    loaded: Dict[str, torch.Tensor] = {}
    missing: List[str] = []
    for dotted, (per_layer, hf_name, transpose) in _entries(cfg, family):
        names = [hf_name(i) for i in range(cfg.n_layers)] if per_layer else [hf_name(0)]
        absent = [n for n in names if n not in files]
        if absent:
            missing.append(f"{dotted} ({absent[0]})")
            continue
        views = (files[n].get(n) for n in names)
        views = (v.T if transpose else v for v in views)
        if not per_layer:
            loaded[dotted] = next(views).to(device=dev, dtype=dt, copy=True).contiguous()
            continue
        first = files[names[0]].get(names[0])
        shape = first.shape[::-1] if transpose else first.shape
        stacked = torch.empty((cfg.n_layers, *shape), dtype=dt, device=dev)
        for i, v in enumerate(views):
            stacked[i].copy_(v)
        loaded[dotted] = stacked
    if missing:
        raise KeyError(f"checkpoint at {path} is missing tensors for: " + ", ".join(missing))
    if cfg.parallel_block and "blocks.mlp_norm.scale" not in loaded:
        loaded["blocks.mlp_norm.scale"] = torch.ones((cfg.n_layers, cfg.d_model), dtype=dt,
                                                     device=dev)

    def build(spec, prefix=""):
        if isinstance(spec, dict):
            return {k: build(v, f"{prefix}{k}.") for k, v in spec.items()}
        return loaded[prefix[:-1]]

    return build(tfm.param_spec(cfg))


def export_hf_checkpoint(params, cfg, path: str, *, family: str = "llama") -> None:
    """The port's tree -> HF-named safetensors (one file), the inverse of
    load_hf_checkpoint; GPT-J's mlp_norm (unused under parallel_block) is
    not written."""
    out: Dict[str, torch.Tensor] = {}
    for dotted, (per_layer, hf_name, transpose) in _entries(cfg, family):
        if dotted == "blocks.mlp_norm.scale" and cfg.parallel_block:
            continue
        t = _tree_get(params, dotted).detach().cpu()
        for i in range(cfg.n_layers if per_layer else 1):
            x = t[i] if per_layer else t
            out[hf_name(i)] = (x.T if transpose else x).contiguous()
    write_safetensors(path, out)
