"""The timing and size constants of the port's cluster runtime (the part of
ray_tpu/utils/config.py that its modules read). As in the JAX copy, a
constant declared through `_declare` is overridden by RAY_TPU_<NAME> in the
environment of the process that reads it, at import: the daemons inherit the
driver's environment, so a variable exported before `init()` or `Cluster()`
reaches the whole cluster. Those are the ones a caller sets (the partition
and GCS-restart drills shorten the heartbeat and push the snapshot out); the
rest stay constants until a caller needs another value.
"""

import os


def _declare(name: str, default):
    """RAY_TPU_<NAME> from the environment, coerced to the default's type;
    the default when it is unset."""
    raw = os.environ.get(f"RAY_TPU_{name}")
    return default if raw is None else type(default)(raw)


# --- health / liveness (reference: raylet_heartbeat_period_ms,
# health_check_timeout_ms)
HEARTBEAT_INTERVAL_S = _declare("HEARTBEAT_INTERVAL_S", 1.0)  # raylet -> GCS heartbeat period
# The GCS declares a node dead after this silence.
HEARTBEAT_TIMEOUT_S = _declare("HEARTBEAT_TIMEOUT_S", 5.0)
WORKER_MONITOR_INTERVAL_S = 0.2  # the raylet's worker-death poll period

# --- worker pool
WORKER_POLL_TIMEOUT_S = 30.0  # a worker's long poll before an empty round trip
WORKER_POOL_MAX = 64  # cap on the idle pool's demand-sized target
WORKER_POOL_HORIZON_S = 0.5  # launch rate x this = the idle pool's demand
WORKER_POOL_PREFORK = 2  # the zygote's parked pre-forks when idle
WORKER_POOL_PREFORK_MAX = 16  # cap on the parked pool's target
WORKER_POOL_INTERVAL_S = 0.25  # the pool loop's period

# --- object store
OBJECT_STORE_MEMORY = 256 << 20  # a node's shared-memory pool
# Chunk size of node-to-node object transfer (reference:
# object_manager_default_chunk_size).
TRANSFER_CHUNK_BYTES = 8 << 20
# Admission control on the object plane: concurrent inbound pulls per node,
# and concurrent outbound chunk streams a node serves.
MAX_CONCURRENT_PULLS = 4
MAX_CONCURRENT_SERVES = 4
# Pool-usage fraction above which the raylet's monitor loop spills sealed
# primaries to disk ahead of allocation failures.
SPILL_THRESHOLD = 0.8

# --- scheduling
# How long a raylet retries cluster placement before failing a task no node
# can currently satisfy.
PLACEMENT_RETRY_TIMEOUT_S = 10.0
# Long-poll window of object waits; between windows the owner runs its
# failure-recovery check, so this bounds retry latency.
OBJECT_WAIT_POLL_S = 2.0

# --- GCS persistence
# Period of the GCS's whole-state snapshot; between two snapshots every
# mutation is in the write-ahead log.
GCS_SNAPSHOT_INTERVAL_S = _declare("GCS_SNAPSHOT_INTERVAL_S", 1.0)

# --- data plane
# Streaming executor generation: "v2" (operator actor pools with
# pressure-driven autoscaling and per-operator byte budgets) or "v1" (one
# global budget). Dataset.iter_block_refs reads RAY_TPU_DATA_EXECUTOR again at
# each call, so one process can run both.
DATA_EXECUTOR = _declare("DATA_EXECUTOR", "v2")
# Per-operator queued-bytes budget (v2): an operator whose input queue holds
# more backpressures its upstream instead of accumulating blocks.
DATA_OP_BUDGET_BYTES = _declare("DATA_OP_BUDGET_BYTES", 64 << 20)
# Operator pools: the cap on any pool, how long "backlogged and downstream
# starved" must last before a scale-up, and how long a surplus actor idles
# before a scale-down.
DATA_POOL_MAX = 8
DATA_POOL_UP_S = 0.2
DATA_POOL_IDLE_S = 2.0
