"""Runtime flag system: env-overridable tunables with typed defaults (the
port of ray_tpu/utils/config.py).

Re-design of the reference's RAY_CONFIG table (reference:
src/ray/common/ray_config.h:60, the macro table in ray_config_def.h,
overridable via RAY_<name> env vars). Every timing and size constant of the
cluster runtime is declared once here with a default, and a variable
`RAY_TPU_<NAME>` in the environment of the process that reads it overrides
it at import, coerced to the default's type (a bool reads "1", "true",
"yes" and "on" as true). The daemons inherit the driver's environment, so a
variable exported before `init()` or `Cluster()` reaches the whole cluster.
`all_flags()` reports the effective values; `CONFIG` holds them as
attributes, under the JAX package's names and defaults.

The port's modules read the upper-case module constants below, each bound
to its declared value (a test may monkeypatch one). `idle_workers_per_env`
is declared and read by nothing, as in the JAX package. This module never
imports torch.
"""

from __future__ import annotations

import os
from typing import Dict, Union

_REGISTRY: Dict[str, Union[float, int, str, bool]] = {}


def _declare(name: str, default):
    """RAY_TPU_<NAME> from the environment, coerced to the default's type;
    registers the flag so `all_flags()` reports its effective value."""
    raw = os.environ.get(f"RAY_TPU_{name.upper()}")
    value = default
    if raw is not None:
        kind = type(default)
        value = raw.lower() in ("1", "true", "yes", "on") if kind is bool else kind(raw)
    _REGISTRY[name] = value
    return value


def all_flags() -> Dict[str, Union[float, int, str, bool]]:
    """Effective flag values, after the environment's overrides."""
    return dict(_REGISTRY)


class RayTpuConfig:
    """The flag table, resolved once at import like the reference's
    process-lifetime RayConfig."""

    # --- health / liveness (reference: raylet_heartbeat_period_ms,
    # health_check_timeout_ms)
    heartbeat_interval_s: float = _declare("heartbeat_interval_s", 1.0)  # raylet -> GCS
    # The GCS declares a node dead after this silence.
    heartbeat_timeout_s: float = _declare("heartbeat_timeout_s", 5.0)
    worker_monitor_interval_s: float = _declare("worker_monitor_interval_s", 0.2)

    # --- worker pool
    # A worker's long poll before an empty round trip.
    worker_poll_timeout_s: float = _declare("worker_poll_timeout_s", 30.0)
    idle_workers_per_env: int = _declare("idle_workers_per_env", 2)
    # Workers fork from a pre-warmed zygote daemon; 0 spawns every worker
    # with Popen.
    worker_zygote: bool = _declare("worker_zygote", True)
    # The warm pool sized by demand; 0 keeps only the boot prestart.
    worker_pool: bool = _declare("worker_pool", True)
    worker_pool_max: int = _declare("worker_pool_max", 64)  # cap on the idle pool's target
    # Launch rate x this = the idle pool's demand.
    worker_pool_horizon_s: float = _declare("worker_pool_horizon_s", 0.5)
    # The zygote's parked pre-forks when idle, and the cap on their target.
    worker_pool_prefork: int = _declare("worker_pool_prefork", 2)
    worker_pool_prefork_max: int = _declare("worker_pool_prefork_max", 16)
    worker_pool_interval_s: float = _declare("worker_pool_interval_s", 0.25)  # the pool loop

    # --- object store
    object_store_memory: int = _declare("object_store_memory", 256 << 20)  # a node's pool
    # Chunk size of node-to-node object transfer (reference:
    # object_manager_default_chunk_size).
    transfer_chunk_bytes: int = _declare("transfer_chunk_bytes", 8 << 20)
    # Admission control on the object plane: concurrent inbound pulls per
    # node, and concurrent outbound chunk streams a node serves.
    max_concurrent_pulls: int = _declare("max_concurrent_pulls", 4)
    max_concurrent_serves: int = _declare("max_concurrent_serves", 4)
    # Pool-usage fraction above which the raylet's monitor loop spills
    # sealed primaries to disk ahead of allocation failures.
    spill_threshold: float = _declare("spill_threshold", 0.8)

    # --- scheduling
    # How long a raylet retries cluster placement before failing a task no
    # node can currently satisfy.
    placement_retry_timeout_s: float = _declare("placement_retry_timeout_s", 10.0)
    # Long-poll window of object waits; between windows the owner runs its
    # failure-recovery check, so this bounds retry latency.
    object_wait_poll_s: float = _declare("object_wait_poll_s", 2.0)

    # --- data plane
    # Streaming executor generation: "v2" (operator actor pools with
    # pressure-driven autoscaling and per-operator byte budgets) or "v1"
    # (one global budget). Dataset.iter_block_refs reads
    # RAY_TPU_DATA_EXECUTOR again at each call, so one process can run both.
    data_executor: str = _declare("data_executor", "v2")
    # Per-operator queued-bytes budget (v2): an operator whose input queue
    # holds more backpressures its upstream instead of accumulating blocks.
    data_op_budget_bytes: int = _declare("data_op_budget_bytes", 64 << 20)
    # Operator pools: the cap on any pool, how long "backlogged and
    # downstream starved" must last before a scale-up, and how long a
    # surplus actor idles before a scale-down.
    data_pool_max: int = _declare("data_pool_max", 8)
    data_pool_up_s: float = _declare("data_pool_up_s", 0.2)
    data_pool_idle_s: float = _declare("data_pool_idle_s", 2.0)

    # --- GCS
    # Period of the GCS's whole-state snapshot; between two snapshots every
    # mutation is in the write-ahead log.
    gcs_snapshot_interval_s: float = _declare("gcs_snapshot_interval_s", 1.0)
    # The hot tables' shard count (core/gcs_shards.py: nodes, actors and
    # objects split into key-hashed partitions, one lock and one log
    # segment each); 1 is the single-lock layout.
    gcs_shards: int = _declare("gcs_shards", 8)


CONFIG = RayTpuConfig()

HEARTBEAT_INTERVAL_S = CONFIG.heartbeat_interval_s
HEARTBEAT_TIMEOUT_S = CONFIG.heartbeat_timeout_s
WORKER_MONITOR_INTERVAL_S = CONFIG.worker_monitor_interval_s
WORKER_POLL_TIMEOUT_S = CONFIG.worker_poll_timeout_s
IDLE_WORKERS_PER_ENV = CONFIG.idle_workers_per_env
WORKER_ZYGOTE = CONFIG.worker_zygote
WORKER_POOL = CONFIG.worker_pool
WORKER_POOL_MAX = CONFIG.worker_pool_max
WORKER_POOL_HORIZON_S = CONFIG.worker_pool_horizon_s
WORKER_POOL_PREFORK = CONFIG.worker_pool_prefork
WORKER_POOL_PREFORK_MAX = CONFIG.worker_pool_prefork_max
WORKER_POOL_INTERVAL_S = CONFIG.worker_pool_interval_s
OBJECT_STORE_MEMORY = CONFIG.object_store_memory
TRANSFER_CHUNK_BYTES = CONFIG.transfer_chunk_bytes
MAX_CONCURRENT_PULLS = CONFIG.max_concurrent_pulls
MAX_CONCURRENT_SERVES = CONFIG.max_concurrent_serves
SPILL_THRESHOLD = CONFIG.spill_threshold
PLACEMENT_RETRY_TIMEOUT_S = CONFIG.placement_retry_timeout_s
OBJECT_WAIT_POLL_S = CONFIG.object_wait_poll_s
DATA_EXECUTOR = CONFIG.data_executor
DATA_OP_BUDGET_BYTES = CONFIG.data_op_budget_bytes
DATA_POOL_MAX = CONFIG.data_pool_max
DATA_POOL_UP_S = CONFIG.data_pool_up_s
DATA_POOL_IDLE_S = CONFIG.data_pool_idle_s
GCS_SNAPSHOT_INTERVAL_S = CONFIG.gcs_snapshot_interval_s
GCS_SHARDS = CONFIG.gcs_shards
