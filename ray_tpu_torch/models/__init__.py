"""Models of the PyTorch port: the transformer (Llama-2, GPT-J and tiny
geometries), the Switch MoE layer and the MLP, with the names the JAX
package's `ray_tpu.models` exports. Importing this package imports torch;
the cluster's daemons never import it."""

from . import mlp, moe, transformer
from .moe import EXPERT_RULES, MoEConfig, init_moe_params, moe_apply
from .transformer import (
    TransformerConfig,
    flops_per_token,
    forward,
    gpt_j_6b,
    init_params,
    llama2_7b,
    llama2_13b,
    next_token_loss,
    param_count,
    tiny,
)

__all__ = [
    "mlp", "moe", "transformer", "EXPERT_RULES", "MoEConfig", "init_moe_params", "moe_apply",
    "TransformerConfig", "flops_per_token", "forward", "gpt_j_6b", "init_params", "llama2_7b",
    "llama2_13b", "next_token_loss", "param_count", "tiny",
]
