"""The parallel layer of the port over torch.distributed (the counterpart of
ray_tpu/parallel): meshes and the GPU slice topology, sharding rules as
DTensor placements, collectives, the vocab-parallel cross-entropy, ring and
Ulysses sequence parallelism, the GPipe pipeline.

Where JAX runs one SPMD program over global arrays (shard_map, GSPMD), each
rank of the port runs its own program on its shard; see each module."""

from .collectives import (all_gather, all_to_all, axis_index, axis_size, pbroadcast, pmax,
                          pmean, psum, reduce_scatter, ring_permute)
from .cross_entropy import vocab_parallel_nll
from .mesh import (AXIS_ORDER, GpuTopology, Mesh, MeshSpec, PartitionSpec, build_device_mesh,
                   build_mesh, data_parallel_rank, default_devices, host_local_device_count,
                   mesh_shape, named_sharding, placements, single_device_mesh)
from .pipeline import (pipeline_apply, shard_stage_params, split_stacked_layers,
                       stack_stage_params)
from .ring_attention import attention_reference, batch_seq_spec, ring_attention
from .sharding import (BATCH_SEQ_SPEC, BATCH_SPEC, TRANSFORMER_RULES, batch_sharding,
                       replicate_tree, replicated, shard_batch, shard_tree, spec_for_path,
                       tree_shardings)
from .ulysses import ulysses_attention

__all__ = [
    "AXIS_ORDER", "GpuTopology", "Mesh", "MeshSpec", "PartitionSpec", "build_device_mesh",
    "build_mesh", "data_parallel_rank", "default_devices", "host_local_device_count", "mesh_shape",
    "named_sharding", "placements", "single_device_mesh", "BATCH_SEQ_SPEC", "BATCH_SPEC",
    "TRANSFORMER_RULES", "batch_sharding", "replicate_tree", "replicated", "shard_batch",
    "shard_tree", "spec_for_path", "tree_shardings", "all_gather", "all_to_all", "axis_index",
    "axis_size", "pbroadcast", "pmax", "pmean", "psum", "reduce_scatter", "ring_permute",
    "attention_reference", "batch_seq_spec", "ring_attention", "ulysses_attention",
    "pipeline_apply", "shard_stage_params", "split_stacked_layers", "stack_stage_params",
    "vocab_parallel_nll",
]
