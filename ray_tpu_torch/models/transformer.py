"""Decoder-only transformer (Llama-2 family): the counterpart of
ray_tpu/models/transformer.py.

Params are a plain nested dict of tensors with the JAX package's tree, key
paths and layouts: layers are stacked on a leading n_layers axis, and
weights are [d_in, d_out]. Attention takes [b, s, h, d]; the paged KV pool is
[n_layers, pages, page_tokens, kv_heads, head_dim].

Where JAX scans over the stacked layers (and returns the updated pool as a
scan output), the port runs a Python loop over layers and writes the KV pool
in place.

Mixed precision follows the JAX package: norms and RoPE compute in fp32 and
cast back; projections cast q/k/v to cfg.dtype; logits are fp32. A bf16
product goes to cuBLAS, which accumulates in fp32 and rounds its output to
bf16 once, where XLA kept the fp32 sum (preferred_element_type) for the next
elementwise op; in float32 the two are the same computation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.flash_attention import attention_reference, flash_attention

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "full"  # "full" (flash kernel) | "naive"
    tie_embeddings: bool = False
    # GPT-J switches: "gelu" MLP has no gate projection; parallel_block sums
    # attention and MLP computed from one pre-norm into the residual.
    mlp_act: str = "swiglu"  # "swiglu" | "gelu"
    parallel_block: bool = False
    # RoPE over the first rotary_dim dims of each head (None: all of them).
    rotary_dim: Optional[int] = None
    norm_type: str = "rms"  # "rms" | "layer"
    rope_style: str = "half"  # "half" (llama rotate-half) | "interleaved" (GPT-J)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)


def llama2_7b(**overrides) -> TransformerConfig:
    return TransformerConfig().replace(**overrides)


def llama2_13b(**overrides) -> TransformerConfig:
    return TransformerConfig(
        d_model=5120, n_layers=40, n_heads=40, n_kv_heads=40, d_ff=13824
    ).replace(**overrides)


def gpt_j_6b(**overrides) -> TransformerConfig:
    """GPT-J-6B: gelu MLP (no gate), parallel attention+MLP block, RoPE on
    64 of 256 head dims in interleaved pairs, LayerNorm. Biases are not
    modeled."""
    return TransformerConfig(
        vocab_size=50400, d_model=4096, n_layers=28, n_heads=16, n_kv_heads=16,
        d_ff=16384, rope_theta=10000.0, mlp_act="gelu", parallel_block=True,
        rotary_dim=64, norm_type="layer", rope_style="interleaved",
    ).replace(**overrides)


def tiny(**overrides) -> TransformerConfig:
    """Test-sized config."""
    return TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128,
    ).replace(**overrides)


# ------------------------------------------------------------------ params


def param_spec(cfg: TransformerConfig) -> Params:
    """The param tree's leaves as (shape, fan_in); fan_in None marks a norm
    scale initialised to ones."""
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    L, d, f, v = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    mlp = {"w_up": ((L, d, f), d), "w_down": ((L, f, d), f)}
    if cfg.mlp_act == "swiglu":
        mlp = {"w_gate": ((L, d, f), d), **mlp}
    spec = {
        "embed": {"embedding": ((v, d), d)},
        "blocks": {
            "attn_norm": {"scale": ((L, d), None)},
            "attn": {
                "wq": ((L, d, nh * hd), d),
                "wk": ((L, d, nkv * hd), d),
                "wv": ((L, d, nkv * hd), d),
                "wo": ((L, nh * hd, d), nh * hd),
            },
            "mlp_norm": {"scale": ((L, d), None)},
            "mlp": mlp,
        },
        "final_norm": {"scale": ((d,), None)},
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((d, v), d)
    return spec


def init_params(cfg: TransformerConfig, generator: torch.Generator, device=None) -> Params:
    """Stacked-layer param tree: normal / sqrt(fan_in) weights in cfg.dtype,
    norm scales of ones. The generator lives on `device` (cuda unless the
    caller passes "cpu")."""
    from .._device import resolve_device

    dev = resolve_device(device)

    def make(leaf):
        shape, fan_in = leaf
        if fan_in is None:
            return torch.ones(shape, dtype=cfg.dtype, device=dev)
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return w.div_(math.sqrt(fan_in)).to(cfg.dtype)

    return map_tree(make, param_spec(cfg))


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer_params(params: Params, i: int) -> Params:
    return map_tree(lambda t: t[i], params["blocks"])


# ------------------------------------------------------------------ layers


def rms_norm(x, scale, eps):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x, scale, eps):
    """Mean-centering LayerNorm, scale only (GPT-J's ln, bias unmodeled)."""
    xf = x.float()
    xf = xf - xf.mean(dim=-1, keepdim=True)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _norm(x, scale, cfg: TransformerConfig):
    if cfg.norm_type == "layer":
        return layer_norm(x, scale, cfg.norm_eps)
    return rms_norm(x, scale, cfg.norm_eps)


def rope_tables(cfg: TransformerConfig, seq_len: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    half = (cfg.rotary_dim or cfg.head_dim) // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    freqs = torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32, device=device), exps)
    angles = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)  # [seq, rotary_dim/2]


def _rotate(x, c, s, interleave: bool):
    """x [..., rd] fp32; c/s broadcast against x[..., rd/2]."""
    if interleave:  # GPT-J: pairs are (even, odd) dims
        x1, x2 = x[..., ::2], x[..., 1::2]
        return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(x.shape)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _rope(x, c, s, cfg: Optional[TransformerConfig]):
    rd = cfg.rotary_dim if cfg is not None else None
    interleave = cfg is not None and cfg.rope_style == "interleaved"
    xf = x.float()
    if rd is not None and rd < x.shape[-1]:
        out = torch.cat([_rotate(xf[..., :rd], c, s, interleave), xf[..., rd:]], dim=-1)
    else:
        out = _rotate(xf, c, s, interleave)
    return out.to(x.dtype)


def apply_rope(x, cos, sin, cfg: Optional[TransformerConfig] = None):
    """x [b, s, h, d], cos/sin [s, rd/2]. Llama rotates the whole head
    (rotate-half); GPT-J the first rotary_dim dims in interleaved pairs."""
    return _rope(x, cos[None, :, None, :], sin[None, :, None, :], cfg)


def _apply_rope_rows(x, cos, sin, cfg: TransformerConfig):
    """RoPE for one position per batch row: x [B, h, d], cos/sin [B, rd/2]."""
    return _rope(x, cos[:, None, :].float(), sin[:, None, :].float(), cfg)


def _qkv(h, ap, cfg: TransformerConfig):
    b, s, _ = h.shape
    hd = cfg.head_dim
    q = torch.matmul(h, ap["wq"]).reshape(b, s, cfg.n_heads, hd).to(cfg.dtype)
    k = torch.matmul(h, ap["wk"]).reshape(b, s, cfg.n_kv_heads, hd).to(cfg.dtype)
    v = torch.matmul(h, ap["wv"]).reshape(b, s, cfg.n_kv_heads, hd).to(cfg.dtype)
    return q, k, v


def _mlp(h, mp, cfg: TransformerConfig):
    up = torch.matmul(h, mp["w_up"]).float()
    if cfg.mlp_act == "swiglu":
        gate = torch.matmul(h, mp["w_gate"]).float()
        act = (F.silu(gate) * up).to(cfg.dtype)
    else:
        # jax.nn.gelu defaults to the tanh approximation.
        act = F.gelu(up, approximate="tanh").to(cfg.dtype)
    return torch.matmul(act, mp["w_down"]).to(cfg.dtype)


def _attention(q, k, v, cfg: TransformerConfig):
    if cfg.attn_impl == "full":
        return flash_attention(q, k, v, causal=True)
    if cfg.attn_impl != "naive":
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not ported (ring/ulysses wait for the "
            "parallel layer)"
        )
    rep = cfg.n_heads // cfg.n_kv_heads
    if rep > 1:  # jnp.repeat(k, rep, axis=2)
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return attention_reference(q, k, v, causal=True)


def _attn_out(o, ap, cfg: TransformerConfig):
    b, s = o.shape[:2]
    return torch.matmul(o.reshape(b, s, cfg.n_heads * cfg.head_dim), ap["wo"]).to(cfg.dtype)


def _residual(x, h, attn_out, lp, cfg: TransformerConfig):
    """Parallel block (GPT-J): the MLP reads the same pre-norm h as
    attention; sequential (llama): re-norm after adding attention."""
    if cfg.parallel_block:
        return x + attn_out + _mlp(h, lp["mlp"], cfg)
    x = x + attn_out
    return x + _mlp(_norm(x, lp["mlp_norm"]["scale"], cfg), lp["mlp"], cfg)


def _layer(x, lp, cfg: TransformerConfig, cos, sin):
    h = _norm(x, lp["attn_norm"]["scale"], cfg)
    q, k, v = _qkv(h, lp["attn"], cfg)
    q = apply_rope(q, cos, sin, cfg)
    k = apply_rope(k, cos, sin, cfg)
    o = _attention(q, k, v, cfg)
    return _residual(x, h, _attn_out(o, lp["attn"], cfg), lp, cfg)


def _head(params: Params) -> torch.Tensor:
    head = params.get("lm_head")
    return params["embed"]["embedding"].T if head is None else head


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """tokens [batch, seq] -> final-norm hidden states [batch, seq, d]."""
    s = tokens.shape[1]
    emb = params["embed"]["embedding"]
    cos, sin = rope_tables(cfg, s, emb.device)
    x = emb[tokens.long()]
    for i in range(cfg.n_layers):
        x = _layer(x, _layer_params(params, i), cfg, cos, sin)
    return _norm(x, params["final_norm"]["scale"], cfg)


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """tokens [batch, seq] int -> logits [batch, seq, vocab] float32."""
    x = forward_hidden(params, tokens, cfg)
    return torch.matmul(x, _head(params)).float()


# ------------------------------------------------------------ paged decode
#
# The KV cache is a pool of fixed-size pages shared by every sequence.
# Prefill writes a sequence's k/v into the pages its block table names;
# decode gathers them back, attends over them and appends the new position.
# Page 0 is a trash page: masked writes (inactive slots, positions past a
# sequence's length, shared prefix pages owned by the radix cache) go there,
# with duplicate indices, so their order is undefined. Trash contents are
# never read: the attention mask stops at each sequence's length.

TRASH_PAGE = 0


def init_kv_pages(cfg: TransformerConfig, num_pages: int, page_tokens: int, device=None):
    """The paged KV pool: k/v of shape
    [n_layers, num_pages, page_tokens, n_kv_heads, head_dim]."""
    from .._device import resolve_device

    dev = resolve_device(device)
    shape = (cfg.n_layers, num_pages, page_tokens, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
    }


def forward_prefill(
    params: Params,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    kv_pages: Dict[str, torch.Tensor],
    block_table: torch.Tensor,
    length: int,
    write_from: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill ONE sequence and write its k/v into the paged pool in place.

    tokens [1, S] (padded to a bucket), block_table [P] page indices,
    length: true prompt length (<= S), write_from: first position to write
    (positions below it sit in shared prefix pages already written).
    Returns (last-position logits [1, vocab] fp32, kv_pages).
    """
    S = tokens.shape[1]
    T = kv_pages["k"].shape[2]
    dev = tokens.device
    cos, sin = rope_tables(cfg, S, dev)
    x = params["embed"]["embedding"][tokens.long()]

    pos = torch.arange(S, device=dev)
    writable = (pos >= write_from) & (pos < length)
    # Indices clamp like jnp's gather: a block table shorter than S/T
    # repeats its last page.
    page_idx = (pos // T).clamp_max(block_table.shape[0] - 1)
    dest_page = torch.where(writable, block_table.long()[page_idx], TRASH_PAGE)
    dest_slot = pos % T

    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        h = _norm(x, lp["attn_norm"]["scale"], cfg)
        q, k, v = _qkv(h, lp["attn"], cfg)
        q = apply_rope(q, cos, sin, cfg)
        k = apply_rope(k, cos, sin, cfg)
        kv_pages["k"][i][dest_page, dest_slot] = k[0]
        kv_pages["v"][i][dest_page, dest_slot] = v[0]
        o = _attention(q, k, v, cfg)
        x = _residual(x, h, _attn_out(o, lp["attn"], cfg), lp, cfg)
    x = _norm(x, params["final_norm"]["scale"], cfg)
    h_last = x[0, min(max(int(length) - 1, 0), S - 1)][None, :]
    return torch.matmul(h_last, _head(params)).float(), kv_pages


def forward_decode(
    params: Params,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cfg: TransformerConfig,
    kv_pages: Dict[str, torch.Tensor],
    block_tables: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step for the whole slot batch, paged attention.

    tokens [B] (last emitted token per slot), positions [B] (index the new
    token occupies; -1 marks an inactive slot), block_tables [B, P].
    Appends each active slot's k/v at `positions` in place, attends over
    [0, pos] and returns (logits [B, vocab] fp32, kv_pages). Inactive slots
    write to the trash page and give logits the scheduler ignores.
    """
    B = tokens.shape[0]
    T = kv_pages["k"].shape[2]
    P = block_tables.shape[1]
    dev = tokens.device
    active = positions >= 0
    # Clamped like jnp.take: positions past the table read its last entry.
    pos = positions.long().clamp(0, P * T - 1)
    block_tables = block_tables.long()

    cos_t, sin_t = rope_tables(cfg, P * T, dev)
    cos, sin = cos_t[pos], sin_t[pos]  # [B, rd/2]
    x = params["embed"]["embedding"][tokens.long()][:, None, :]  # [B, 1, d]
    rows = torch.arange(B, device=dev)
    dest_page = torch.where(active, block_tables[rows, pos // T], TRASH_PAGE)
    dest_slot = pos % T
    rep = cfg.n_heads // cfg.n_kv_heads
    kv_mask = torch.arange(P * T, device=dev)[None, :] <= pos[:, None]  # [B, P*T]

    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        kp, vp = kv_pages["k"][i], kv_pages["v"][i]
        h = _norm(x, lp["attn_norm"]["scale"], cfg)
        q, k, v = _qkv(h, lp["attn"], cfg)
        q = _apply_rope_rows(q[:, 0], cos, sin, cfg)  # [B, nh, hd]
        k = _apply_rope_rows(k[:, 0], cos, sin, cfg)  # [B, nkv, hd]
        kp[dest_page, dest_slot] = k
        vp[dest_page, dest_slot] = v[:, 0]
        # Gather after the append so the new position attends to itself.
        kb = kp[block_tables].reshape(B, P * T, cfg.n_kv_heads, cfg.head_dim)
        vb = vp[block_tables].reshape(B, P * T, cfg.n_kv_heads, cfg.head_dim)
        if rep > 1:
            kb = kb.repeat_interleave(rep, dim=2)
            vb = vb.repeat_interleave(rep, dim=2)
        scores = torch.einsum("bhd,bshd->bhs", q.float(), kb.float()) / math.sqrt(cfg.head_dim)
        scores = scores.masked_fill(~kv_mask[:, None, :], float("-inf"))
        attn = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhs,bshd->bhd", attn, vb.float())
        o = o.reshape(B, 1, cfg.n_heads, cfg.head_dim).to(cfg.dtype)
        x = _residual(x, h, _attn_out(o, lp["attn"], cfg), lp, cfg)
    x = _norm(x, params["final_norm"]["scale"], cfg)
    return torch.matmul(x[:, 0], _head(params)).float(), kv_pages
