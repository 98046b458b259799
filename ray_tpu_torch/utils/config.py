"""The timing and size constants of the port's cluster runtime (the part of
ray_tpu/utils/config.py that its modules read). The JAX copy makes each one
overridable through a RAY_TPU_<NAME> variable; here each is a constant, and a
knob comes back when a second caller needs another value.
"""

# --- health / liveness (reference: raylet_heartbeat_period_ms,
# health_check_timeout_ms)
HEARTBEAT_INTERVAL_S = 1.0  # raylet -> GCS heartbeat period
HEARTBEAT_TIMEOUT_S = 5.0  # the GCS declares a node dead after this silence
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
