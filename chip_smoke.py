"""Runs the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases, each printing its own line, any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel from ray_tpu_torch/ops/csrc/ and prints
     each kernel's registers and spills as ptxas reports them;
  3. kernel: each kernel (flash forward, and the backward's dq and dk/dv)
     against its plain PyTorch version on the card, bf16 outputs entry by
     entry, with its time, the plain version's, one PyTorch library call's
     and the bound; at the train shape in bf16 each check must refuse two
     planted faults, each kernel must repeat bit for bit, and one pass
     through flash_attention_with_lse (forward) and
     flash_attention(...).backward must give the same results; the same at
     GPT-J's shape (b=1, s=2048, 16 heads of 256, causal) in bf16 and fp32,
     and in fp32 with batch x heads = 65600; at the train shape the backward
     kernels also take the lse variant (a dlse != 0 from merging the block
     with a seeded second one by their lse, as ring attention does),
     directly and through flash_attention_with_lse's backward, planted
     faults refused;
  4. paged: PagedLM prefill+decode against the port's full forward, Llama-2-7B
     width, 2 layers, float32: greedy tokens must be equal;
  5. gptj: gpt_j_6b(n_layers=2) at full width (head_dim 256), bf16: a paged
     prefill and decode, then 3 AdamW steps under remat "hot"; all three
     kernels must launch at head_dim 256 and the loss fall;
  6. serve: InferenceEngine over PagedLM at full Llama-2-7B width in bf16
     (random weights from a seed) answers 8 requests; the flash kernel's
     launch count on that path is checked;
  7. deploy: the same model at full width and depth as a Serve deployment
     (llm_deployment on init(local_mode=True)): 8 requests through the
     streaming handle and 8 through LLMClient's feed at once must give the
     greedy tokens of InferenceEngine driven directly, and a handle close()
     must free its request's pages within one decode step; TTFT and
     decode tokens/s of handle, feed and direct engine; then the same on
     init() with the replica an actor in a worker process leased GPU 0
     (num_gpus=1): the same gates, flash_fwd's launches (>= 32 x 16, the
     backward kernels 0) read in the replica's process, its pid,
     CUDA_VISIBLE_DEVICES and start-up time, no process or pool left;
  8. train-parity: 3 AdamW steps at Llama-2-7B width, 2 layers, float32,
     through the kernels and through plain autograd from the same params,
     under remat "dots" and "hot": the first step's gradients and every
     step's loss must agree, and the flash forward runs 2 (dots) or 1 (hot)
     times per layer per step;
  9. train: 6 AdamW steps of Llama-2-7B at full width, 8 layers, bf16, on a
     2 x 2048-token batch, under remat "hot", "dots" and "attn": a finite,
     falling loss, step time, tokens/s, MFU, peak memory, and each kernel's
     launch count on that path;
  10. zero: ZeRO-1 (train/zero.py) over a NCCL group of one rank against the
     plain step, 2 layers, bf16: losses and params bitwise equal after 3
     steps; each optimizer state's bytes;
  11. checkpoint (llama2_7b width, 1 layer): 3 steps, an elastic checkpoint at
     world 1 resharded to 4 on disk, restored into a fresh run, 3 more steps:
     bitwise equal to 6 uninterrupted steps; then an HF safetensors export and
     reload, bitwise, with the same greedy tokens from PagedLM;
  12. fit: the zero phase's configuration trained through TorchTrainer.fit
     on init(local_mode=True), 8 steps with an elastic checkpoint reported
     at step 3, uninterrupted (A) and with a failure after step 5 and a
     restart from that checkpoint (B): the resumed run equals the
     uninterrupted one and build_train_step driven directly, bit for bit;
     keep-1 checkpoints, goodput, MFU and each kernel's launches; the
     trainer's step p50 against the plain step's, driven from the main
     thread and, as a control, from a plain thread with no runtime
     (--profile traces one step of each);
  13. tune: Tuner over that TorchTrainer, two lrs trained at once on the
     card: each trial bitwise equal to a direct run, the best trial named,
     each kernel's launches;
  14. parallel: (a) next_token_loss with attn_impl "ring" and "ulysses" on a
     DeviceMesh with seq=1 over a NCCL group of one rank against "full"
     (llama2_7b(n_layers=2), bf16, "hot", b=1, s=2048): loss and every
     leaf's gradient, bitwise or not; and moe_apply at Switch-Base's width
     over that world against no mesh, bitwise; (b) 4 processes of this script
     sharing the card over gloo (collectives staged through host memory;
     their times are not multi-GPU speed): ring_attention and
     ulysses_attention at Llama-2-7B's attention width (32 heads of 128,
     bf16, causal, global s=8192) against one flash_attention call, output
     and dq/dk/dv, with each call's launches across ranks; then in fp32 the
     model's ring and Ulysses over seq=4 and next_token_loss_pipelined over
     stage=4 (4 layers, 4 microbatches) against the unsplit model: loss,
     every leaf's gradient and launches; (c) tensor parallelism at
     llama2_7b(n_layers=2)'s full width on params from shard_tree, tensor=4
     and fsdp=2 x tensor=2: in fp32 the first step's loss and every rank's
     gradient shard of every leaf against the unsplit model, then 2 AdamW
     steps' losses; TP x SP (tensor=2 x seq=2, ring and Ulysses); in bf16
     one forward and backward with each kernel's launches; (d) the Switch
     MoE at Switch-Base's expert width (768 / 3072, 128 experts, capacity
     factor 1.25, 8192 tokens) over expert=4 against the unsplit layer:
     y, x's gradient, the aux loss and every param's gradient shard, with
     the tokens dropped; peak memory per rank;
  15. cluster: the cluster runtime (init() with no arguments: a GCS, a
     raylet, its zygote and worker processes forked from it): (a)
     cluster_resources()["GPU"] from the GPU manager; the time until the
     zygote parks a child; a num_gpus=1 task on a parked child sees
     CUDA_VISIBLE_DEVICES="0" and the card, is the zygote's child and not in
     a bad fork, and its latency; the zygote is no compute process of the
     card and never initialised CUDA; two num_gpus=0.5 tasks held at once by a barrier actor share
     device 0; a bf16 4096 x 11008 CUDA tensor through put, get and a GPU
     task and back, bitwise, twice (GB/s); flash_attention at the serve
     shape in an actor's process against its plain version; no-op tasks and
     calls to one actor per second; the runtime's eleven instruments
     (RUNTIME_INSTRUMENTS) by node, the head, which ran the tasks, reporting
     its scheduler's and worker pool's; (b) TorchTrainer with one worker process
     over NCCL, the fit phase's model, 4 steps: losses and params_sha256
     bitwise equal to the in-process trainer's and build_train_step's,
     launches 8 / 8 / 8 in the worker, step p50 beside the in-process
     trainer's; (c) two worker processes sharing the card over gloo,
     MeshSpec(data=2), fp32, 1 layer: 2 AdamW steps against one process (first loss
     1e-6, trajectory 1e-5, every leaf 1e-5 of its norm), then ZeRO-1 over
     "data" against the plain two-rank run; no process and no
     /dev/shm/rtpt_* pool left after shutdown; (d) a head on
     tcp://127.0.0.1:0 with an auth token and a worker node joined by
     start_worker_node, this process a remote client (init(address=)): the
     bf16 tensor through its put, a num_gpus=1 task on the joined node and
     its get, bitwise; a connection without the token refused; (d1) a
     num_gpus=1 actor on the joined node reads 32 serve-shape bf16 (q, k, v)
     records, staged from CUDA tensors here, first through the channel's TCP
     stream (a spec whose ring path this process cannot see), then through
     its ring: each runs K1 on its card, a sample held within 2^-6 per entry
     of the plain version, the records equal on both transports (MB/s of
     each); (d2) a num_returns="streaming" num_gpus=1 task on the joined node
     yields K1's output for 8 serve-shape inputs, iterated by this remote
     client, each item bitwise equal to the same task's non-streaming return
     (first item's latency, seconds per item); every cluster in the smoke
     boots its GCS with 8 hot-table shards;
  16. elastic: node drain and preemption on a fresh init() whose head leases
     GPU 0, nodes added (Cluster.add_node(num_gpus=1)) and removed, notices
     through the GCS's report_preemption: (a) TorchTrainer with one NCCL
     worker on an added node, the fit phase's model, an elastic checkpoint
     every 2 steps and one more on train.drain_requested(),
     max_failures=0: preempted after its second checkpoint (removed at a
     20 s deadline, a replacement node added), restored in a new process
     on the replacement; losses and params_sha256 bitwise equal to
     build_train_step driven directly, every step once, drain-wait time,
     no process of the removed node left, K1-K3 in both processes; notice
     to drain seen, checkpoint landed, restore done and first fresh step;
     (b) two gloo ranks on two added nodes, elastic (min_workers=1,
     capacity_wait_s=3), fp32 as cluster part (c) (1 layer), 5 steps with
     a checkpoint after each but the last: one node preempted after the
     first with no replacement (world 1, the whole global batch), a node
     added once the first step at world 1 is checkpointed (world 2 again at
     the next checkpoint, two steps at world 1 on):
     worlds 2..1..2, each step once, one downsize and one growback,
     degraded time, losses and final params within part (c)'s tolerance of
     one process, K1-K3 at every world; (c) a num_gpus=0.5 deployment running flash_attention at
     the serve shape per request, its node given a 60 s notice while a
     client calls all along: a new replica on another node, no failed
     request, K1 in both replicas' processes; nothing left after shutdown.
  17. objects: the object plane and what rides it, on a fresh init() with a
     2 GiB pool per node; one layer = Llama-2-7B's seven block matrices as a
     dict of bf16 CUDA tensors (404.8 MB): (a) 6 layers (1.13x the pool) put
     and read back onto the card bitwise through spill to disk, num_spilled
     in the GCS's stats, a num_gpus=1 task on a spilled layer (sha256), the
     spill dir empty and the pool's bytes back once the refs drop; (b) 3
     nodes added (num_gpus=1), a layer broadcast to them (returns 3, 4
     locations), an actor pinned to each gets it onto its card bitwise with
     no bytes pulled, a layer not broadcast as the control; (c) three GPU
     actors in a collective group: an fp32 allreduce of w_up's size within
     1e-6 of a float64 sum, reduce_scatter equal to its shard, broadcast and
     allgather bitwise, bf16 back as float32, no GCS key after the destroy;
     (d) combine.bind(a.attend.bind(x), b.attend.bind(x)) compiled and run 4
     times (two actors' wq/wk/wv projections and K1, causal, summed by a GPU
     task) within 2^-6 per entry of the driver's plain sum, K1 4 times in
     each actor's process, and MultiOutputNode once; (e) a GPU task with
     runtime_env env_vars and a working_dir: its variable, CUDA_VISIBLE_DEVICES
     "0", the helper module, K1 against its plain version, one Popen; a
     plain GPU task after it forked, without the variable; an unknown field
     refused; nothing left after shutdown.
  18. ops: the operator surface on a fresh init() whose head leases GPU 0:
     (a) a utils.Queue fed by a producer task with 16 (seed, request index)
     items; (b) a utils.ActorPool of two num_gpus=0.5 actors maps them, each
     building q/k/v from the seed at Llama-2-7B's serve shape and running K1
     (causal), held within 2^-6 per entry of its plain version in the
     actor's process, K1 launched once per call there; (c) each call records
     a utils.metrics Counter and Histogram (K1 ms by CUDA events) and
     publishes one message: the driver's state.user_metrics() shows the
     counter at 16 and the histogram's counts summing to 16 within two
     flush intervals, its subscription gets the 16 messages in each
     publisher's order, state.internal_metrics() holds raytpu_* records
     reported by a raylet and a worker process, state.list_tasks() shows
     the 16 calls FINISHED on the GPU node and state.timeline() one X span
     each; the flush lag, publish -> poll and each state call's ms; (d)
     nothing left after shutdown.
  19. membership: epoch fencing, partitions and GCS restart on a fresh init()
     whose head leases GPU 0, with a 0.25 s heartbeat, a 1.5 s timeout and
     the GCS's snapshot pushed out to an hour, and two nodes added with
     num_gpus=1: (a) a named num_gpus=0.5 actor running K1 at Llama-2-7B's
     serve shape (q/k/v from a (seed, index) pair, held within 2^-6 per
     entry of its plain version in its process) on an added node, a client
     calling it all along, chaos.partition([[node], ["gcs"]]): the seconds
     to the node declared dead, to the actor's record ALIVE on the other
     GPU node, and after heal() to the zombie's fenced rejoin at the next
     epoch and its worker gone from /proc and nvidia-smi's compute apps (it
     held /dev/nvidia* files before); the successor's fixed-seed K1 output
     bitwise equal to the zombie's; the rejoined node's GPU id free again;
     the exactly-once audit (no acknowledged call lost, none applied twice,
     none from nowhere), one ALIVE record, raytpu_nodes_fenced_total >= 1
     and raytpu_actor_restarts_total >= 1;
     (b) the GCS killed and restarted with only its write-ahead log: the
     old handle's next K1 call, get_actor by name, a KV value, every node
     Alive again, and a new num_gpus=0.5 task seeing CUDA_VISIBLE_DEVICES
     "0" and running K1 (seconds from the kill to its result, and its
     parts), its 8 shards' log segments replayed; (c) nothing left after
     shutdown.
  20. observe: logs, dumps, spans and post-mortems on a fresh init() whose head
     leases GPU 0, with tracing on and a 3 s collective op timeout: (a) once
     the zygote has imported its device stack, a named num_gpus=0.5 actor's
     first K1 call at the serve shape (against its plain
     version), split by its own clock into its CUDA context, q/k/v, the kernel
     library's load, the wrapper's first launch, the registered op's first
     dispatch through flash_attention and a second call; the line it prints
     reaches the driver's _log_recent with its `(observe_k1 pid=... node=...)`
     prefix (seconds from its print), tail_logs by its actor id returns the
     capture record and its structured record, and tracing.collect() holds the
     worker's execution span parented to the driver's span with the submit
     span's flow id; (b) a num_gpus=0.5 task with max_retries=0 on a worker
     forked from the zygote runs K1, writes a marker to stderr and SIGKILLs
     itself: WorkerCrashedError with the marker, a post-mortem in the flight
     dir with exit code -9, the task and the marker (seconds from the kill),
     a worker_crash record; (c) two num_gpus=0.5 actors in a collective group
     allreduce K1's CUDA output, then rank 1 sleeps past the op timeout: rank
     0's CollectiveTimeoutError opens one coll.timeout incident, whose harvest
     SIGUSR2s both actors and stages a bundle with their rings, a trace.json
     holding the trigger's marker and a report naming rank 1 missing (seconds
     from the trigger to the manifest); (d) nothing left after shutdown.
  21. graphs: compiled graphs, the SLO watchdog and the sampling profiler on a
     fresh init() whose head leases GPU 0, the GCS's one watchdog rule
     cgraph_execute_p99 (p99 of raytpu_cgraph_execute_latency_ms > 1000 ms,
     for_s 0.5, a 5 s window): (a) two num_gpus=0.5 actors each run K1
     (causal) at Llama-2-7B's serve shape on q/k/v from (their seed, the
     iteration), an allreduce edge sums their outputs and a MultiOutputNode
     returns both members' digests of the sum: 16 iterations compiled with
     max_inflight=2, each bitwise equal to the same graph run over the
     object plane (compile(), the sum at the driver), K1 within 2^-6 per
     entry of its plain version and launched 16 times in each actor's
     process; the compiled and the eager iteration's p50 and p99; the
     raylet's profile RPC (1 s) during the run, its JSON merged into a
     Perfetto trace; (b) actor 1 sleeps 1.5 s in 3 iterations: the rule's
     slo_alert firing on node_events (seconds from the first slow
     iteration), state.active_alerts() naming it, a watchdog.alert incident
     whose bundle's metrics.json holds the latency series (seconds from
     firing to the manifest), the alert cleared after the stall, and
     state.metrics_history of the executions counter as a rate; (c) an
     ElasticGraph (min_actors=1) over both loses actor 1 to rt.kill and
     re-forms at the survivor, whose next result is its K1 output within
     2^-6 per entry of the plain version (seconds from the kill); (d)
     nothing left after shutdown.
  22. data: Data and the rest of Serve on a fresh init() whose head leases
     GPU 0, the references in this process first, then a wait for the
     zygote's device stack: (a) from_numpy of 6 rows of 2048 token ids (seed 7)
     and a row id,
     map_batches through an autoscaling actor pool (concurrency (1, 2)), fed to
     TorchTrainer(datasets=, dataset_config="channel") with one GPU worker
     process training the fit phase's model (llama2_7b width, 2 layers, bf16,
     remat "hot") from train.get_dataset_shard("train").iter_device_batches(1):
     losses and params_sha256 bitwise equal to the same rows through
     build_train_step driven directly in this process, the rows seen exactly
     the dataset's in order, K1-K3 12 / 12 / 12 in the worker's process (two
     layers, six steps); rows/s into the trainer, data_wait per step against the
     step p50 and the direct loop's; (b) llm_deployment of PagedLM at
     Llama-2-7B width (2 layers, seed 0) behind serve.run(http_port=0), the
     replica a GPU worker process: 4 prompts as JSON bodies, the chunked
     framing read off the socket (one token per chunk), greedy tokens equal
     to InferenceEngine's driven directly here and to the handle's, K1 in the
     replica's process; TTFT p50 over HTTP, through the handle and of the
     engine; (c) a featurized range(512) through streaming_split(1)
     .to_channel() into a FeatureTable replica: 17 lookups over HTTP equal to
     the dataset's rows, an unknown key null, the ingest lag (a row made ->
     the first lookup that sees it); (d) nothing left after shutdown. The gRPC
     proxy is not driven here (the card's machine has no grpcio).
  23. operate: the operator surface and the device glue: (a) through
     `python -m ray_tpu_torch.scripts` with HOME at a temp dir, `up` of a JSON
     config (the local provider; a head with no GPU and one worker of 2 CPUs and
     1 GPU, RAY_RUNNING through its cloud-id label), `status` (2 nodes, GPU 1),
     `submit --wait` of an entrypoint that attaches with init(address="auto")
     and runs a num_gpus=1 task: K1 at the serve shape against its plain version
     within 2^-6 per entry, launched once, on a worker forked after that node's
     zygote imported its device stack; the job SUCCEEDED, its line in `submit`'s
     output and in `logs`; this process attached by session dir reads the
     dashboard's /api/jobs, /api/nodes (the worker's label), /metrics
     (raytpu_gcs_rpc_total and the reporter's node gauges), /api/metrics_history
     and /api/alerts; `down`: no process of the session, no keeper, no pool;
     (b) autoscaler_v2's InstanceManager over a LocalNodeProvider (shape 2 CPUs,
     1 GPU) on init(num_gpus=0) with a 0.25 s heartbeat and a 1.5 s timeout:
     the GPU node's raylet killed, the instance terminated and replaced, a K1
     task on the replacement (seconds from the kill to each); (c) in this
     process, which holds a CUDA context: the
     reporter's raytpu_device_mem_used_bytes{device="0"} equal to
     torch.cuda.memory_allocated(0), one K1 call under profiling.device_trace
     whose trace names the flash_fwd kernel, and save_device_memory_profile's
     snapshot. (b) and (c) run after (a)'s `status`, while the GPU node's
     zygote imports its device stack.
  24. rl: the RL stack (ray_tpu_torch.rl), which runs no flash kernel (its
     launches 0): (a) from the same params and seeded batches at the tuned
     examples' widths, 5 updates of the learner on CUDA against the same on
     the CPU, TF32 off, for ppo_loss, impala_loss with V-trace, dqn_loss and
     SAC's update (256, 256) with the same noise: losses within 1e-5
     (relative) and every leaf within 1e-5 of its norm, one update's
     CUDA-event and host ms; (b) on a fresh init() whose head leases GPU 0,
     the ppo_cartpole tuned example (2 env-runner actors x 8 envs on the
     CPU, rollout 64) with its learner on cuda:0 in this process, for 60 s or
     until its 475 target: each iteration's sample, learn and weight-sync
     seconds, env steps/s and mean return, the learner's params on CUDA,
     finite losses, the best mean of 5 iterations RL_PPO_MARGIN above the
     first iteration's, the runners' raytpu_rl_env_steps_total equal to the
     steps sampled; (c) on that cluster DQN on CartPole (64, 64) and SAC on
     Pendulum (256, 256), learners on CUDA: finite losses, the target
     network equal to the learner after every 128 updates and still in
     between, SAC's targets exactly (1 - tau) t + tau q after an update,
     each update's ms; nothing left after shutdown.
  25. shards: the sharded GCS as a control plane for 1000 nodes: a GCS
     daemon (python -m ray_tpu_torch.core.gcs, its snapshot pushed out to an
     hour) behind its RpcServer on a UDS, 1000 thin stub raylets multiplexed
     over 32 client threads: (a) a registration storm through register_nodes
     in batches of 125 at 8 shards; (b) the same storm one register_node at
     a time on a fresh GCS at 1 shard; (c) 3 heartbeat rounds through the
     delta codec against (a)'s GCS; (d) a kill -9 of that GCS and a restart
     from its 8 log segments alone, every node back at its epoch:
     registrations/s of (a) and (b), the heartbeat RTT p50 and p99,
     raytpu_gcs_shard_lock_wait_ms's count and p99, the restart's seconds
     (host figures; the phase asserts correctness, no speed).
  26. gang: SLICE_GANG on three labelled 2-host GPU slices: a co-failed gang
     resumed on another slice bitwise, then a pending gang placed on a slice
     the autoscaler provisions, K1 in its bundle 0 (phase_gang's docstring).
  27. soak: the seeded membership soak (chaos/soak.py) with its trainer arm
     on a cluster of its own for 25 s: the exactly-once audit, no wedged
     get, one ALIVE counter, and an elastic one-worker CPU TorchTrainer whose
     history equals the fault-free golden run; no kernel launched.
Phases 1-5 run alone, in this order. Then a second process of this script
(`--lane`) runs ops, membership, observe, graphs, data, elastic, rl, operate
and shards, in that order (data once the main process's parallel phase has
ended), while the main process runs parallel, serve, deploy, train-parity,
train, zero, checkpoint, fit, tune, cluster, objects, gang and soak; the second process's
lines are printed when it ends, and its failure fails the smoke.
Then a line of the card's peak memory in use and the host's lowest
MemAvailable while each phase of the main process ran, a line of each
phase's wall seconds and the whole smoke's, one JSON line
with every kernel's numbers (the backward kernels'
launches from the "hot" train run; each kernel's numbers at head_dim 256,
with the gptj phase's launches, under "at_d256"; its launches in the fit,
tune, parallel, cluster and elastic phases' model paths (ring, ulysses,
pipeline, the TP meshes and TP x SP; the deploy phase's cluster replica; the
cluster's actor, NCCL trainer worker and gloo ranks, the TCP part's stream
reader actor and streaming task; the preempted and
restored workers, each elastic world, the old and new Serve replicas; the
objects phase's two DAG actors and its runtime-env task; the ops phase's
pool actors; the membership phase's zombie and successor actors, its
restart actor and task; the observe phase's logging actor, crashed task and
collective actors; the graphs phase's compiled actors; the data phase's
trainer worker and HTTP replica; the operate phase's job task, replacement
task and traced call; the rl and soak phases, 0) under
"launches_by_path"), and the
device line last.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Published dense peaks of one H100 SXM (NVIDIA data sheet): tensor-core bf16
# and plain fp32 FLOP/s, and HBM bytes/s.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def _bound_ms(flops, nbytes, dtype_name):
    """The larger of FLOPs over the peak for their type and bytes over HBM
    bandwidth, and which of the two it is."""
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_bound_ms(kernel, b, s, h, h_kv, d, dtype_name, causal):
    """Least time for one flash kernel on the unmasked (q, k) pairs, each
    input read once and each output written once:
      fwd: QK^T, PV; reads q, k, v, writes o and lse (fp32);
      dq:  QK^T, dO.V^T, dS.K; reads q, do, k, v, lse, delta, writes dq;
      dkv: QK^T, dO.V^T, P^T.dO, dS^T.Q; reads q, do, k, v, lse, delta,
           writes dk and dv."""
    pairs = s * (s + 1) // 2 if causal else s * s
    es = 2 if dtype_name == "bfloat16" else 4
    q_size, kv_size, row = b * s * h * d, b * s * h_kv * d, b * h * s
    products, nbytes = {
        "fwd": (2, es * (2 * q_size + 2 * kv_size) + 4 * row),
        "dq": (3, es * (3 * q_size + 2 * kv_size) + 8 * row),
        "dkv": (4, es * (2 * q_size + 4 * kv_size) + 8 * row),
    }[kernel]
    return _bound_ms(products * 2 * b * h * pairs * d, nbytes, dtype_name)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: chip_smoke needs a CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} device {name}", flush=True)
    print(smi.splitlines()[0], flush=True)
    return name


def ptxas_kernels(report: str):
    """[(kernel, registers, spill bytes)] from nvcc's -Xptxas -v report, each
    kernel named from its mangled name as `name<type, head_dim>` where the
    name carries template arguments."""
    rows, name, spill = [], None, 0
    for ln in report.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", ln):
            name, spill = m.group(1), 0
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", ln)) and name:
            # a length-prefixed identifier, then I<type>?Li<head_dim>E
            if t := re.search(r"\d(flash_[A-Za-z_]+?)I(13__nv_bfloat16|f)?Li(\d+)E", name):
                dtype = {"13__nv_bfloat16": "bf16, ", "f": "f32, "}.get(t.group(2), "")
                name = f"{t.group(1)}<{dtype}{t.group(3)}>"
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


def phase_build():
    from ray_tpu_torch.ops import _build

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    _build.build(names)
    dt = time.perf_counter() - t0
    for n in names:
        _build.load(n)
        kernels = ptxas_kernels(_build.ptxas_reports.get(n, ""))
        print(f"[build] {n}.cu ptxas: " + (" | ".join(
            f"{k} {regs} regs {spill} B spilled" for k, regs, spill in kernels) or "cached"),
            flush=True)
    print(f"[build] kernels {names} built in {dt:.1f} s", flush=True)


# Per-entry checks: each entry of a kernel's output is held to
# tol x (|ref| + rms(ref)), ref the plain version's result. That is relative
# where an entry is large, with a floor at the tensor's typical magnitude
# where it is near 0: a causal row's dq shrinks as its row grows, and row 0's
# is 0 up to rounding. bf16: 2**-6 (four bf16 ulps). Backward: at the train
# shape the tensor-core kernels read at most 0.0113 over three seeds (the
# outputs round to bf16, and a P or dS near a rounding boundary rounds one
# ulp apart; the plain version itself reads up to 0.0112 against a float64
# one), one 64-row tile of one head scaled by 0.9 reads 0.06-0.08. fp32: 1e-4,
# where the readings are at most 6e-6 (sums in another order). The bf16
# forward's o is held the same way to 2**-6, its lse (fp32, the log of a sum
# of unrounded P) to 1e-3 absolute; the fp32 forward keeps max |err| 1e-4 for
# both.
BWD_TOL = {"float32": 1e-4, "bfloat16": 2 ** -6}
FWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2 ** -6, 1e-3)}  # (o, lse)


def entry_err(got, want, rms=None) -> float:
    """max over entries of |got - want| / (|want| + rms(want)); `rms` given
    where `want` is a part of a larger reference (the whole one's rms)."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean().sqrt() if rms is None else rms
    return ((g - w).abs() / (w.abs() + rms)).max().item()


def _planted_faults(t):
    """Wrong versions of a [b, s, h, d] kernel output that the check must
    refuse: every row past the first 64-row tile halved, and one 64-row tile
    of one head scaled by 0.9."""
    halved, tile = t.clone(), t.clone()
    halved[:, 64:] *= 0.5
    tile[:, 1024:1088, 5] *= 0.9
    return {"x0.5 past row 64": halved, "x0.9 on rows 1024-1087 of head 5": tile}


def _check_fwd():
    """The flash forward kernel against reference_flash_fwd (the plain
    version, rounding P where the Pallas kernel does) on the card; at the
    train shape in bf16 also planted faults, determinism and the autograd
    path."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    # (b, s, h, h_kv, d, dtype, causal); s=1024 is the serve phase's largest
    # prefill bucket, the shape reported in the JSON line; b=2, s=2048 is the
    # train phase's; h=16, d=256 GPT-J's (the gptj phase's train shape), in
    # both dtypes; b x h = 65600 puts more blocks on grid x than y could hold.
    cases = [(1, s, 32, 32, 128, torch.bfloat16, True) for s in (16, 128, 512, 1024, 2048)]
    cases += [(2, 2048, 32, 32, 128, torch.bfloat16, True),
              (2, 256, 8, 2, 128, torch.bfloat16, True), (1, 300, 8, 8, 64, torch.float32, False),
              (1, 40, 4, 2, 16, torch.float32, True),
              GPTJ_SHAPE + (torch.bfloat16, True), GPTJ_SHAPE + (torch.float32, True),
              (4100, 40, 16, 4, 16, torch.float32, True)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = None
    for b, s, h, h_kv, d, dt, causal in cases:
        q = torch.randn((b, s, h, d), generator=gen, device="cuda", dtype=torch.float32).to(dt)
        k = torch.randn((b, s, h_kv, d), generator=gen, device="cuda", dtype=torch.float32).to(dt)
        v = torch.randn((b, s, h_kv, d), generator=gen, device="cuda", dtype=torch.float32).to(dt)
        kw = dict(causal=causal, scale=d ** -0.5)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.reference_flash_fwd(q, k, v, **kw)
        name = str(dt).replace("torch.", "")
        where = f"b={b} s={s} h={h} h_kv={h_kv} d={d} {name} causal={causal}"
        max_abs = (o.float() - o_ref.float()).abs().max().item()
        bf16 = dt == torch.bfloat16
        err_o = entry_err(o, o_ref) if bf16 else max_abs
        err_l = (lse - lse_ref).abs().max().item()
        tol_o, tol_l = FWD_TOL[name]
        ok = math.isfinite(err_o) and err_o <= tol_o and err_l <= tol_l
        ms = _time_ms(lambda: fa.flash_fwd(q, k, v, **kw))
        plain_ms = _time_ms(lambda: fa.reference_flash_fwd(q, k, v, **kw), iters=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=kw["scale"], enable_gqa=h != h_kv))
        bound, by = flash_bound_ms("fwd", b, s, h, h_kv, d, name, causal)
        measure = "max |err| / (|ref| + rms(ref))" if bf16 else "max |err|"
        print(f"[kernel] flash_fwd {where}: o {measure} {err_o:.3g} (max abs {max_abs:.3g}; "
              f"tol {tol_o:.3g}) lse max |err| {err_l:.3g} (tol {tol_l}); ms {ms:.4f} "
              f"plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms {bound:.4f} ({by})",
              flush=True)
        if not ok:
            _fail(f"flash_fwd disagrees with its plain version at {where}")
        numbers = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": by, "library_ms": lib_ms}
        if (b, s, h, d, dt, causal) in ((2, 2048, 32, 128, torch.bfloat16, True),
                                        GPTJ_SHAPE[:3] + (256, torch.bfloat16, True)):
            _check_fwd_train_shape(q, k, v, o, lse, o_ref, kw, where)
            print(f"[kernel] flash_fwd at a train shape {where}: ms {ms:.4f}; SDPA forward "
                  f"{lib_ms:.4f} ms; ratio {ms / lib_ms:.2f}", flush=True)
        if (b, s, h, d, dt, causal) == (1, 1024, 32, 128, torch.bfloat16, True):
            report = {"name": "flash_fwd", "route": "cuda",
                      "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
                      "replaces": "ray_tpu/ops/flash_attention.py:64", "launches": None,
                      **numbers}
        if (b, s, h, h_kv, d, dt) == GPTJ_SHAPE + (torch.bfloat16,):
            d256 = {"shape": where, "launches": None, **numbers}
    report["at_d256"] = d256
    return report


def _check_fwd_train_shape(q, k, v, o, lse, o_ref, kw, where):
    """At the train shape in bf16: both planted faults in o are refused, a
    second launch repeats the first bit for bit, and one pass through
    flash_attention_with_lse (the autograd path) launches the kernel once and
    returns the same o and lse."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    tol = FWD_TOL["bfloat16"][0]
    planted = {f: entry_err(bad, o_ref) for f, bad in _planted_faults(o).items()}
    print(f"[kernel] flash_fwd {where}: planted faults in o read "
          + "; ".join(f"{f} {e:.3g}" for f, e in planted.items()) + f"; tol {tol:.3g}", flush=True)
    if min(planted.values()) <= tol:
        _fail(f"the forward check passes a planted fault at {where}: {planted}")
    o2, lse2 = fa.flash_fwd(q, k, v, **kw)
    before = _launch_counts()
    o3, lse3 = fa.flash_attention_with_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in _launch_counts().items()}
    same = {"second launch": torch.equal(o, o2) and torch.equal(lse, lse2),
            "flash_attention_with_lse": torch.equal(o, o3) and torch.equal(lse, lse3)}
    print(f"[kernel] flash_fwd {where}: o and lse equal the first launch's bit for bit: "
          + ", ".join(f"{n} {ok}" for n, ok in same.items()) + f"; launches {launched}",
          flush=True)
    if not all(same.values()):
        _fail(f"flash_fwd is not deterministic, or the autograd path differs, at {where}")
    if launched != {"flash_fwd": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}:
        _fail(f"flash_attention_with_lse launched {launched}, want one flash_fwd")


# GPT-J's attention at the gptj phase's train shape: (b, s, h, h_kv, d).
GPTJ_SHAPE = (1, 2048, 16, 16, 256)


def _check_bwd():
    """The backward kernels (flash_bwd_dq, flash_bwd_dkv) against their plain
    versions on the card; times at the train phase's shape and, under
    "at_d256", at GPT-J's."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    bf, f32 = torch.bfloat16, torch.float32
    # (b, s, h, h_kv, d, dtype, causal): the train phase's shape first (the
    # one reported) and again in fp32, then every head_dim in both dtypes,
    # causal or not, GQA and MQA, and lengths that are not a multiple of the
    # 64-row tile.
    # GPT-J's head_dim 256 in both dtypes, and b x h = 65600 on grid x.
    timed = {(2, 2048, 32, 32, 128, bf, True): "", GPTJ_SHAPE + (bf, True): "_d256"}
    cases = [(2, 2048, 32, 32, 128, bf, True), (2, 2048, 32, 32, 128, f32, True),
             (1, 1000, 8, 4, 128, bf, False), (1, 256, 4, 2, 128, f32, True),
             (1, 300, 8, 8, 64, bf, False), (1, 200, 8, 2, 64, f32, True),
             (1, 96, 4, 4, 32, bf, True), (1, 130, 2, 2, 32, f32, False),
             (1, 40, 4, 2, 16, bf, True), (2, 128, 4, 1, 16, f32, False),
             GPTJ_SHAPE + (bf, True), GPTJ_SHAPE + (f32, True), (4100, 40, 16, 4, 16, f32, True)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for b, s, h, h_kv, d, dt, causal in cases:
        q, k, v, do = (torch.randn((b, s, hh, d), generator=gen, device="cuda").to(dt)
                       for hh in (h, h_kv, h_kv, h))
        scale = d ** -0.5
        o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=scale)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, lse, do, delta)
        kw = dict(causal=causal, scale=scale)
        got = {"dq": (fa.flash_bwd_dq(*args, **kw),), "dkv": fa.flash_bwd_dkv(*args, **kw)}
        torch.cuda.synchronize()
        want = {"dq": (fa.reference_flash_bwd_dq(*args, **kw),),
                "dkv": fa.reference_flash_bwd_dkv(*args, **kw)}
        name = str(dt).replace("torch.", "")
        tol = BWD_TOL[name]
        where = f"b={b} s={s} h={h} h_kv={h_kv} d={d} {name} causal={causal}"
        errs, planted = {}, {}
        for kern in ("dq", "dkv"):
            for label, g, w in zip(("dq",) if kern == "dq" else ("dk", "dv"), got[kern],
                                   want[kern]):
                err = entry_err(g, w)
                errs[label] = (err, (g.float() - w.float()).abs().max().item())
                if not (math.isfinite(err) and err <= tol):
                    _fail(f"flash_bwd {label} disagrees with its plain version at {where}: "
                          f"{err:.3g} (tol {tol})")
                if s >= 1088 and h > 5:
                    for fault, bad in _planted_faults(g).items():
                        planted[f"{label} {fault}"] = entry_err(bad, w)
        print(f"[kernel] flash_bwd {where}: max |err| / (|ref| + rms(ref)) "
              + "; ".join(f"{lb} {e:.3g} (max abs {a:.3g})" for lb, (e, a) in errs.items())
              + f"; tol {tol}", flush=True)
        if planted:
            print(f"[kernel] flash_bwd {where}: planted faults read "
                  + "; ".join(f"{f} {e:.3g}" for f, e in planted.items()), flush=True)
            if min(planted.values()) <= tol:
                _fail(f"the backward check passes a planted fault at {where}: {planted}")
        if (b, s, h, h_kv, d, dt, causal) == GPTJ_SHAPE + (f32, True):
            # The FMA kernels at head_dim 256 (32-row tiles): times only.
            print(f"[kernel] flash_bwd {where}: " + "; ".join(
                f"{kern} ms {_time_ms(lambda fn=fn: fn(*args, **kw), iters=5):.4f} bound_ms "
                f"{flash_bound_ms(kern, b, s, h, h_kv, d, name, causal)[0]:.4f}"
                for kern, fn in (("dq", fa.flash_bwd_dq), ("dkv", fa.flash_bwd_dkv))), flush=True)
        suffix = timed.get((b, s, h, h_kv, d, dt, causal))
        if suffix is None:
            continue
        # The train phases' shapes: no atomics, so a second launch repeats
        # the first bit for bit; the autograd path reaches the same kernels.
        again = (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args, **kw))
        torch.cuda.synchronize()
        same = [torch.equal(x, y) for x, y in zip((*got["dq"], *got["dkv"]), again)]
        print(f"[kernel] flash_bwd {where}: a second launch equals the first bit for bit: "
              f"dq {same[0]}, dk {same[1]}, dv {same[2]}", flush=True)
        if not all(same):
            _fail(f"flash_bwd is not deterministic at {where}")
        del again
        _check_autograd_bwd(q, k, v, do, want, causal, scale, tol, where)
        if not suffix:
            _check_bwd_lse(q, k, v, o, lse, do, kw, tol, where)
        # Times. SDPA's backward (its fwd+bwd less its fwd) computes dq, dk
        # and dv together: one number for both rows, and for the pair.
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, scale=scale,
                                                  enable_gqa=h != h_kv)

        lib_ms = (_time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot), iters=10)
                  - _time_ms(sdpa, iters=10))
        for kern, fn, plain in (("dq", fa.flash_bwd_dq, fa.reference_flash_bwd_dq),
                                ("dkv", fa.flash_bwd_dkv, fa.reference_flash_bwd_dkv)):
            ms = _time_ms(lambda: fn(*args, **kw), iters=10)
            plain_ms = _time_ms(lambda: plain(*args, **kw), iters=3, warmup=1)
            bound, by = flash_bound_ms(kern, b, s, h, h_kv, d, name, causal)
            labels = ("dq",) if kern == "dq" else ("dk", "dv")
            print(f"[kernel] flash_bwd_{kern} b={b} s={s} h={h} h_kv={h_kv} d={d} {name} "
                  f"causal={causal}: ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
                  f"(SDPA backward: dq, dk and dv together) bound_ms {bound:.4f} ({by})",
                  flush=True)
            numbers = {"max_abs_err": max(errs[lb][1] for lb in labels), "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                       "library_ms": lib_ms}
            rows[kern + suffix] = (
                {"shape": where, "launches": None, **numbers} if suffix else
                {"name": f"flash_bwd_{kern}", "route": "cuda",
                 "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
                 "replaces": ("ray_tpu/ops/flash_attention.py:104" if kern == "dq"
                              else "ray_tpu/ops/flash_attention.py:133"),
                 "launches": None, **numbers})
        pair_ms = _time_ms(lambda: (fa.flash_bwd_dq(*args, **kw), fa.flash_bwd_dkv(*args, **kw)),
                           iters=10)
        print(f"[kernel] flash_bwd pair (dq + dkv) b={b} s={s} h={h} h_kv={h_kv} d={d} {name} "
              f"causal={causal}: ms {pair_ms:.4f}; SDPA backward {lib_ms:.4f} ms; ratio "
              f"{pair_ms / lib_ms:.2f}", flush=True)
    for kern in ("dq", "dkv"):
        rows[kern]["at_d256"] = rows.pop(kern + "_d256")
    return rows


def _check_autograd_bwd(q, k, v, do, want, causal, scale, tol, where):
    """One pass through flash_attention(...).backward(do): q, k and v's .grad
    against the plain versions' gradients `want`, entry by entry, and one
    launch of each backward kernel."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    before = _launch_counts()
    fa.flash_attention(*leaves, causal=causal, scale=scale).backward(do)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in _launch_counts().items()}
    errs = {label: entry_err(x.grad, w)
            for label, x, w in zip(("dq", "dk", "dv"), leaves, (*want["dq"], *want["dkv"]))}
    print(f"[kernel] flash_attention(...).backward {where}: max |err| / (|ref| + rms(ref)) "
          + "; ".join(f"{lb} {e:.3g}" for lb, e in errs.items())
          + f"; tol {tol}; launches {launched}", flush=True)
    if not all(math.isfinite(e) and e <= tol for e in errs.values()):
        _fail(f"the autograd backward disagrees with the plain versions at {where}: {errs}")
    if launched != {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}:
        _fail(f"the autograd backward launched {launched}, want one of each kernel")


def _merge_with_other_block(o, lse, o2, lse2):
    """Ring attention's merge of two blocks' normalised partials by their
    lse (ray_tpu_torch/parallel/ring_attention.py), in float32."""
    import torch

    lse_m = torch.logaddexp(lse, lse2)
    w1 = torch.exp(lse - lse_m).transpose(1, 2)[..., None]
    w2 = torch.exp(lse2 - lse_m).transpose(1, 2)[..., None]
    return o.float() * w1 + o2.float() * w2


def _check_bwd_lse(q, k, v, o, lse, do, kw, tol, where):
    """The lse variant of the backward, fed as ring attention feeds it: this
    block's (o, lse) merged by their lse with a second block's (the same
    queries over seeded keys before them), and
    the merge's backward from do gives this block's do (w1 * do) and a dlse
    != 0, so the kernels see delta = sum(do1 * o) - dlse.
    flash_bwd_dq and flash_bwd_dkv on those against their plain versions
    entry by entry, both planted faults refused; then one pass through
    flash_attention_with_lse and the same merge backward, one launch of
    each backward kernel."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    # the other block: the same queries over seeded keys and values before
    # them (non-causal), as the ring's blocks below the diagonal are
    gen = torch.Generator(device="cuda").manual_seed(9)
    k2, v2 = (torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype) for x in (k, v))
    o2, lse2 = fa.flash_fwd(q, k2, v2, causal=False, scale=kw["scale"])
    o_leaf, lse_leaf = o.detach().float().requires_grad_(), lse.detach().requires_grad_()
    _merge_with_other_block(o_leaf, lse_leaf, o2, lse2).backward(do.float())
    do1, dlse = o_leaf.grad.to(do.dtype), lse_leaf.grad
    delta1 = (do1.float() * o.float()).sum(-1).transpose(1, 2)
    args = (q, k, v, lse, do1, (delta1 - dlse).contiguous())
    got = (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args, **kw))
    torch.cuda.synchronize()
    want = (fa.reference_flash_bwd_dq(*args, **kw), *fa.reference_flash_bwd_dkv(*args, **kw))
    errs = {lb: entry_err(g, w) for lb, g, w in zip(("dq", "dk", "dv"), got, want)}
    planted = {f"{lb} {fault}": entry_err(bad, w) for lb, g, w in zip(("dq", "dk", "dv"), got, want)
               for fault, bad in _planted_faults(g).items()}
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    before = _launch_counts()
    _merge_with_other_block(*fa.flash_attention_with_lse(*leaves, **kw), o2, lse2).backward(
        do.float())
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in _launch_counts().items()}
    auto = {lb: entry_err(x.grad, w) for lb, x, w in zip(("dq", "dk", "dv"), leaves, want)}
    print(f"[kernel] flash_bwd with dlse != 0 from a ring merge (|dlse| mean "
          f"{dlse.abs().mean().item():.3g}, |delta| mean {delta1.abs().mean().item():.3g}) "
          f"{where}: max |err| / (|ref| + rms(ref)) "
          + "; ".join(f"{lb} {e:.3g}" for lb, e in errs.items())
          + "; through flash_attention_with_lse's backward " + "; ".join(
              f"{lb} {e:.3g}" for lb, e in auto.items()) + f"; tol {tol}; planted faults read "
          + "; ".join(f"{f} {e:.3g}" for f, e in planted.items()) + f"; launches {launched}",
          flush=True)
    if not all(math.isfinite(e) and e <= tol for e in (*errs.values(), *auto.values())):
        _fail(f"the lse variant of the backward disagrees with its plain versions at {where}")
    if min(planted.values()) <= tol:
        _fail(f"the lse-variant backward check passes a planted fault at {where}: {planted}")
    if launched != {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}:
        _fail(f"flash_attention_with_lse's backward launched {launched}, want one of each")


def phase_kernel():
    """Every kernel against its plain version on the card; returns the JSON
    rows of flash_fwd (serve shape), flash_bwd_dq and flash_bwd_dkv (train
    shape), launches still to fill in."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fwd_row = _check_fwd()
    bwd_rows = _check_bwd()
    torch.cuda.empty_cache()
    return fwd_row, bwd_rows["dq"], bwd_rows["dkv"]


def phase_paged():
    """PagedLM prefill+decode against the port's full forward at Llama-2-7B
    width, 2 layers, float32: one prompt crossing a page boundary, the
    other decode slot idle. Greedy tokens must be equal."""
    import torch

    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.serve.llm import PagedKVAllocator, PagedLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tfm.llama2_7b(n_layers=2, dtype=torch.float32)
    T, n_new = 16, 8
    lm = PagedLM(cfg, seed=1, device="cuda", num_pages=16, page_tokens=T, max_slots=2,
                 max_pages_per_seq=4)
    alloc = PagedKVAllocator(16, T)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (20,), generator=gen).tolist()
    sp = alloc.allocate(prompt)
    got = [lm.prefill(prompt, sp.pages, sp.cached_tokens)]
    while len(got) < n_new:
        pos = len(prompt) + len(got) - 1
        if pos >= sp.num_pages * T:
            alloc.extend(sp)
        got.append(lm.decode([got[-1], 0], [pos, -1], [sp.pages, []])[0])
    seq, gold = list(prompt), []
    with torch.inference_mode():
        for _ in range(n_new):
            logits = tfm.forward(lm.params, torch.tensor([seq], device="cuda"), cfg)
            gold.append(int(torch.argmax(logits[0, -1])))
            seq.append(gold[-1])
    print(f"[paged] llama2_7b width, 2 layers, fp32, prompt 20 tokens over pages of {T}: "
          f"paged {got} gold {gold}", flush=True)
    if got != gold:
        _fail("paged prefill/decode disagrees with the full forward")
    del lm
    torch.cuda.empty_cache()


def phase_gptj():
    """gpt_j_6b(n_layers=2) at full width (16 heads of head_dim 256, gelu,
    parallel block), bf16, random weights from seed 0: a paged prefill and 7
    decode steps, then 3 AdamW steps under remat "hot" on 1 x 2048 tokens,
    all through the kernels at head_dim 256. Each kernel must launch where
    the path runs it, the tokens lie in the vocabulary and the loss is
    finite and falling. Returns the train run's launches."""
    import torch

    from ray_tpu_torch.models import transformer as tfm

    cfg = tfm.gpt_j_6b(n_layers=2, dtype=torch.bfloat16, remat_policy="hot")
    n_steps = 3
    init, step = tfm.build_train_step(cfg, tfm.adamw(1e-4), device="cuda")
    params, opt = init(torch.Generator(device="cuda").manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (300,),
                           generator=torch.Generator().manual_seed(10)).tolist()
    _zero_launch_counts()
    t0 = time.perf_counter()
    toks = _greedy(cfg, tfm.map_tree(lambda t: t.detach(), params), prompt, 8)
    serve_s = time.perf_counter() - t0
    serve_launches = _launch_counts()
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(11))
    _zero_launch_counts()
    losses, step_ms = [], []
    for _ in range(n_steps):
        t = time.perf_counter()
        losses.append(step(params, opt, tokens).item())
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = _launch_counts()
    print(f"[gptj] gpt_j_6b width, 2 layers ({tfm.param_count(params) / 1e9:.3f} B params), "
          f"head_dim {cfg.head_dim}, bf16: paged prefill of {len(prompt)} tokens + 7 decode "
          f"steps in {serve_s:.2f} s, tokens {toks}, launches {serve_launches}; {n_steps} steps "
          f"of adamw(1e-4), remat hot, 1 x 2048 tokens: losses {[round(x, 4) for x in losses]}, "
          f"step ms {[round(t, 1) for t in step_ms]}, launches {launches}", flush=True)
    del params, opt
    torch.cuda.empty_cache()
    if serve_launches != {"flash_fwd": cfg.n_layers, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}:
        _fail(f"gptj: the paged prefill launched {serve_launches}, want one flash_fwd a layer")
    if not all(0 <= t < cfg.vocab_size for t in toks):
        _fail(f"gptj: out-of-vocabulary tokens {toks}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        _fail(f"gptj: the loss is not finite and falling: {losses}")
    want = {n: cfg.n_layers * n_steps for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    if launches != want:
        _fail(f"gptj: train launches {launches}, want {want}")
    return launches


def _timed(fn, log):
    """fn, appending each call's host milliseconds to `log` (each PagedLM
    step ends in a device-to-host copy of its tokens, so that waits for the
    device)."""
    def wrapper(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        log.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapper


# CUPTI's overhead records (host-side waits such as a full launch queue),
# which the profiler lists beside kernels: they are not device work.
_CUPTI_OVERHEAD = {"Unknown", "Buffer Flush", "Instrumentation", "Resource",
                   "Runtime Triggered Module Loading", "Lazy Function Loading",
                   "Command Buffer Full", "Activity Buffer Request", "UVM Activity Init"}


def _print_profile(prof, wall_s, phase, top=15):
    """Device time by kernel over a phase's traced window, and the device's
    busy share of that window (one stream, so kernel times do not overlap).
    Only kernels count: the profiler also credits each CPU op of the tracing
    thread, and each user annotation such as Optimizer.step, with the
    kernels it launched."""
    import torch

    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in _CUPTI_OVERHEAD
            and not e.is_user_annotation and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"[profile {phase}] device busy {busy_us / 1e3:.1f} ms of {wall_s * 1e3:.1f} ms wall "
          f"({100 * busy_us / 1e3 / (wall_s * 1e3):.1f}%)", flush=True)
    groups = {"flash kernels": ("flash_",), "cuBLAS": ("nvjet", "gemm", "gemv", "cutlass")}
    sums = dict.fromkeys([*groups, "other"], 0.0)
    for e in rows:
        group = next((g for g, marks in groups.items() if any(m in e.key for m in marks)), "other")
        sums[group] += e.self_device_time_total / 1e3
    print(f"[profile {phase}] by kind: " + ", ".join(f"{g} {ms:.1f} ms" for g, ms in sums.items()),
          flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[profile {phase}] {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d} x  {e.key[:90]}",
              flush=True)


def phase_serve(profile: bool = False):
    """InferenceEngine over PagedLM at full Llama-2-7B width in bf16 answers
    8 requests; returns the flash kernel's launch count on that path."""
    import contextlib
    import random
    import statistics
    import threading

    import torch

    from ray_tpu_torch.models.transformer import llama2_7b
    from ray_tpu_torch.serve.llm import EngineConfig, InferenceEngine, PagedLM

    t0 = time.perf_counter()
    lm = PagedLM(llama2_7b(dtype=torch.bfloat16), seed=0, device="cuda", num_pages=256,
                 page_tokens=16, max_slots=8, max_pages_per_seq=64)
    torch.cuda.synchronize()
    print(f"[serve] llama2_7b bf16 random weights from seed 0 on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    n_new = 32
    prefill_ms, decode_ms = [], []
    lm.prefill = _timed(lm.prefill, prefill_ms)
    lm.decode = _timed(lm.decode, decode_ms)
    eng = InferenceEngine(lm, EngineConfig(page_tokens=16, pool_pages=256, max_new_tokens=n_new),
                          name="chip-smoke")
    try:
        list(eng.generate([1, 2, 3, 4], 2))  # warm-up: cuBLAS handles, first launches
        rng = random.Random(0)

        def toks(n):
            return [rng.randrange(1, 32000) for _ in range(n)]

        prefix = toks(256)
        prompts = [prefix + toks(24)] + [toks(n) for n in (700, 20, 310, 96, 450, 64)]
        prompts.append(prefix + toks(40))  # submitted once the first has committed its pages
        events = [[] for _ in prompts]
        done = [threading.Event() for _ in prompts]

        def sink_for(i):
            def sink(ev, val):
                events[i].append((time.perf_counter(), ev, val))
                if ev != "tok":
                    done[i].set()
            return sink

        torch.cuda.reset_peak_memory_stats()
        del prefill_ms[:], decode_ms[:]
        prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                   torch.profiler.ProfilerActivity.CUDA])
                if profile else contextlib.nullcontext())
        with prof:
            t_window = time.perf_counter()
            _zero_launch_counts()
            t_submit = {}
            for i in range(7):
                t_submit[i] = time.perf_counter()
                eng.submit(prompts[i], n_new, sink=sink_for(i))
            deadline = time.monotonic() + 300
            while not any(ev == "tok" for _, ev, _ in events[0]):
                if time.monotonic() > deadline or done[0].is_set():
                    _fail(f"first request produced no token: {events[0]}")
                time.sleep(0.005)
            t_submit[7] = time.perf_counter()
            eng.submit(prompts[7], n_new, sink=sink_for(7))
            for i, d in enumerate(done):
                if not d.wait(timeout=max(1.0, deadline - time.monotonic())):
                    _fail(f"request {i} did not finish")
            launches = _launch_counts()["flash_fwd"]
            torch.cuda.synchronize()
            t_window = time.perf_counter() - t_window
        stats = eng.stats()
    finally:
        eng.close()
    if profile:
        _print_profile(prof, t_window, "serve")
    ttft, first_tok, last_tok, n_decode = [], [], [], 0
    for i, evs in enumerate(events):
        out = [v for _, ev, v in evs if ev == "tok"]
        end = [(ev, v) for _, ev, v in evs if ev != "tok"]
        if end != [("done", "stop")] or len(out) != n_new:
            _fail(f"request {i} ended {end} after {len(out)} tokens")
        if not all(0 <= t < lm.vocab for t in out):
            _fail(f"request {i} produced out-of-vocabulary tokens")
        tok_times = [t for t, ev, _ in evs if ev == "tok"]
        ttft.append((tok_times[0] - t_submit[i]) * 1e3)
        first_tok.append(tok_times[0])
        last_tok.append(tok_times[-1])
        n_decode += len(out) - 1
    ttft.sort()
    p50 = (ttft[3] + ttft[4]) / 2
    decode_tps = n_decode / (max(last_tok) - min(first_tok))
    hits = stats["kv"]["prefix_hits"]
    n_prefills = len(prompts)
    print(f"[serve] 8 requests, prompts {[len(p) for p in prompts]}, {n_new} new tokens each: "
          f"TTFT p50 {p50:.1f} ms (min {ttft[0]:.1f}, max {ttft[-1]:.1f}); decode {decode_tps:.1f} "
          f"tok/s over {stats['decode_steps']} steps; prefix hits {hits} pages; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"flash_fwd launches {launches}", flush=True)
    print(f"[serve] prefill ms per call {[round(t, 1) for t in prefill_ms]} (buckets s="
          f"{[lm._bucket_pages(-(-len(p) // 16)) * 16 for p in prompts]}); decode step ms "
          f"p50 {statistics.median(decode_ms):.1f} (min {min(decode_ms):.1f}, max "
          f"{max(decode_ms):.1f}, {len(decode_ms)} steps)", flush=True)
    if hits < 256 // 16:
        _fail(f"shared 256-token prefix missed the radix cache ({hits} page hits)")
    if launches < lm.cfg.n_layers * n_prefills:
        _fail(f"flash_fwd launched {launches} times, want >= {lm.cfg.n_layers} x {n_prefills}")
    return launches


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _drive(streams, prompts, n_new, deadline_s=600):
    """Runs every (label, open_stream) of `streams` on its prompt in its own
    thread, all at once; returns {label: (t_submit, [(t, token)])}. A
    stream that raises or outlives the deadline fails the phase."""
    import threading

    out, errors = {}, []

    def run(label, open_stream, prompt):
        t0 = time.perf_counter()
        toks = []
        try:
            for tok in open_stream(prompt, n_new):
                toks.append((time.perf_counter(), tok))
        except Exception as e:  # noqa: BLE001 - reported below, fails the phase
            errors.append((label, repr(e)))
        out[label] = (t0, toks)

    threads = [threading.Thread(target=run, args=(label, fn, p), daemon=True)
               for (label, fn), p in zip(streams, prompts)]
    for t in threads:
        t.start()
    end = time.monotonic() + deadline_s
    for t in threads:
        t.join(timeout=max(1.0, end - time.monotonic()))
    if errors or any(t.is_alive() for t in threads):
        _fail(f"requests failed or hung: {errors}")
    return out


def _latency(runs, labels):
    """(TTFT p50 ms, decode tokens/s) over the runs named by `labels`."""
    import statistics

    ttft = [(runs[lb][1][0][0] - runs[lb][0]) * 1e3 for lb in labels]
    first = min(runs[lb][1][0][0] for lb in labels)
    last = max(runs[lb][1][-1][0] for lb in labels)
    n_decode = sum(len(runs[lb][1]) - 1 for lb in labels)
    return statistics.median(ttft), n_decode / (last - first)


def phase_deploy():
    """Llama-2-7B at full width and depth in bf16 (random weights from seed
    0) deployed with llm_deployment on ray_tpu_torch.init(local_mode=True):
    8 requests through the streaming handle and 8 through LLMClient's feed,
    all at once. Their greedy tokens must equal InferenceEngine's driven
    directly over the same builder, seed and prompts, and flash_fwd must
    launch on the deployment's path. Then a handle close() mid-stream must
    free the request's pages within one decode step. Prints TTFT p50 and
    decode tokens/s for the handle, the feed and the direct engine."""
    import gc
    import random

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import (EngineConfig, InferenceEngine, LLMClient,
                                         llama2_7b_paged_lm, llm_deployment)

    gc.collect()  # the serve phase's model
    torch.cuda.empty_cache()
    smi = _smi()
    n_new, geometry = 32, dict(num_pages=512, page_tokens=16, max_slots=8, max_pages_per_seq=64)
    cfg = EngineConfig(page_tokens=16, pool_pages=512, max_new_tokens=n_new)
    rng = random.Random(1)
    lengths = (280, 700, 20, 310, 96, 450, 64, 296)
    prompts = [[rng.randrange(1, 32000) for _ in range(n)] for n in lengths * 2]
    labels = [f"handle {i}" for i in range(8)] + [f"feed {i}" for i in range(8)]

    t0 = time.perf_counter()
    lm = llama2_7b_paged_lm(seed=0, device="cuda", **geometry)
    eng = InferenceEngine(lm, cfg, name="chip-smoke-direct")
    try:
        list(eng.generate([1, 2, 3, 4], 2))  # warm-up
        direct = _drive([(lb, eng.generate) for lb in labels], prompts, n_new)
    finally:
        eng.close()
    del lm, eng
    gc.collect()
    torch.cuda.empty_cache()
    direct_s = time.perf_counter() - t0
    direct_ttft, direct_tps = _latency(direct, labels)

    rt.init(local_mode=True)
    try:
        t0 = time.perf_counter()
        app = llm_deployment(llama2_7b_paged_lm, name="llama2-7b", engine_config=cfg,
                             model_kwargs=dict(seed=0, device="cuda", **geometry))
        handle = serve.run(app, name="llama2-7b", http_port=None)
        stream = handle.options(stream=True)
        client = LLMClient("llama2-7b")
        stats = handle.options(method_name="engine_stats")
        try:
            list(stream.remote([1, 2, 3, 4], 2))  # warm-up
            list(client.generate([1, 2, 3, 4], 2))
            up_s = time.perf_counter() - t0
            _zero_launch_counts()
            runs = _drive([(lb, stream.remote if lb.startswith("handle") else client.generate)
                           for lb in labels], prompts, n_new)
            launches = _launch_counts()

            # A handle close() mid-stream frees the request's pages.
            gen = stream.remote(prompts[0], 400)
            got = [next(gen), next(gen)]
            gen.close()  # the cancel goes to the replica ahead of the stats call below
            before = stats.remote().result(timeout=60)
            deadline = time.monotonic() + 60
            while True:
                after = stats.remote().result(timeout=60)
                if after["running"] == 0 and after["kv"]["used_pages"] == 0:
                    break
                if time.monotonic() > deadline:
                    _fail(f"deploy: a closed stream kept its pages: {after}")
                time.sleep(0.002)
        finally:
            client.close()
    finally:
        serve.shutdown()
        rt.shutdown()
        gc.collect()
        torch.cuda.empty_cache()
    h_ttft, h_tps = _latency(runs, labels[:8])
    f_ttft, f_tps = _latency(runs, labels[8:])
    all_ttft, all_tps = _latency(runs, labels)
    mismatched = [lb for lb in labels if [t for _, t in runs[lb][1]] != [t for _, t in direct[lb][1]]]
    steps = after["decode_steps"] - before["decode_steps"]
    local_line = (f"in-process deployment TTFT p50 {all_ttft:.1f} ms, decode {all_tps:.1f} tok/s; "
                  f"direct engine TTFT p50 {direct_ttft:.1f} ms, decode {direct_tps:.1f} tok/s")
    print(f"[deploy] llama2_7b bf16 seed 0 via llm_deployment on init(local_mode=True), up in "
          f"{up_s:.1f} s; 16 requests at once, prompts {[len(p) for p in prompts]}, {n_new} new "
          f"tokens each; greedy tokens equal to InferenceEngine driven directly: "
          f"{16 - len(mismatched)}/16 (direct run {direct_s:.1f} s); flash_fwd launches "
          f"{launches['flash_fwd']}", flush=True)
    print(f"[deploy] {smi}: handle TTFT p50 {h_ttft:.1f} ms, decode {h_tps:.1f} tok/s; feed "
          f"TTFT p50 {f_ttft:.1f} ms, decode {f_tps:.1f} tok/s; all 16 through the deployment "
          f"TTFT p50 {all_ttft:.1f} ms, decode {all_tps:.1f} tok/s; direct engine, same 16 "
          f"requests: TTFT p50 {direct_ttft:.1f} ms, decode {direct_tps:.1f} tok/s", flush=True)
    print(f"[deploy] handle close() after 2 of 400 tokens ({got}): pages and slot freed "
          f"{steps} decode step(s) after close returned; tokens emitted over the engine's life "
          f"{after['tokens_emitted']}", flush=True)
    if mismatched:
        _fail(f"deploy: greedy tokens differ from the direct engine for {mismatched}")
    if launches["flash_fwd"] < 32 * 16:
        _fail(f"deploy: flash_fwd launched {launches['flash_fwd']} times, want >= 32 x 16")
    if steps > 1:
        _fail(f"deploy: a closed stream's pages freed {steps} decode steps after close")
    return {"deploy replica (cluster)": _deploy_on_cluster(
        prompts, labels, n_new, geometry, cfg, direct, local_line, smi)}


def _counted_llm_server():
    """serve.llm's replica class with one method more, `kernel_launches`:
    the flash kernels' launch counts of the replica's own process, zeroed
    when asked, beside its pid and CUDA_VISIBLE_DEVICES."""
    from ray_tpu_torch.serve.llm.deployment import LLMServer

    class CountedLLMServer(LLMServer):
        def kernel_launches(self, zero: bool = False):
            counts = _launch_counts()
            if zero:
                _zero_launch_counts()
            return {"launches": counts, "pid": os.getpid(),
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}

    return CountedLLMServer


def _deploy_on_cluster(prompts, labels, n_new, geometry, cfg, direct, local_line, smi):
    """The deploy phase's cluster part: the same llm_deployment, prompts and
    geometry with the replica an actor in a worker process of init() leased
    GPU 0 (ray_actor_options={"num_gpus": 1}). Its greedy tokens must equal
    the direct engine's for all 16 requests, flash_fwd must launch >= 32 x 16
    times and the backward kernels never, as counted in the replica's process
    (the replica class gains `kernel_launches` for that, and nothing else),
    and a closed stream must free its pages within one decode step. No
    process and no pool of the cluster may outlive its shutdown."""
    import gc
    import glob

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.runtime_base import current_runtime
    from ray_tpu_torch.serve.deployment import Application, Deployment
    from ray_tpu_torch.serve.llm import LLMClient, llama2_7b_paged_lm, llm_deployment

    t0 = time.perf_counter()
    rt.init()
    init_s = time.perf_counter() - t0
    session_dir = current_runtime()._cluster.session_dir
    ours = f"/dev/shm/rtpt_{os.path.basename(session_dir)}"
    try:
        t0 = time.perf_counter()
        base = llm_deployment(llama2_7b_paged_lm, name="llama2-7b-cluster", engine_config=cfg,
                              model_kwargs=dict(seed=0, device="cuda", **geometry),
                              ray_actor_options={"num_gpus": 1})
        app = Application(Deployment(_counted_llm_server(), base.deployment.name,
                                     base.deployment.config), base.init_args, base.init_kwargs)
        handle = serve.run(app, name="llama2-7b-cluster", http_port=None)
        stream = handle.options(stream=True)
        client = LLMClient("llama2-7b-cluster")
        stats = handle.options(method_name="engine_stats")
        counters = handle.options(method_name="kernel_launches")
        try:
            list(stream.remote([1, 2, 3, 4], 2))  # warm-up
            list(client.generate([1, 2, 3, 4], 2))
            up_s = time.perf_counter() - t0
            replica = counters.remote(True).result(timeout=60)
            runs = _drive([(lb, stream.remote if lb.startswith("handle") else client.generate)
                           for lb in labels], prompts, n_new)
            launches = counters.remote(False).result(timeout=60)["launches"]

            gen = stream.remote(prompts[0], 400)
            got = [next(gen), next(gen)]
            gen.close()
            before = stats.remote().result(timeout=60)
            deadline = time.monotonic() + 60
            while True:
                after = stats.remote().result(timeout=60)
                if after["running"] == 0 and after["kv"]["used_pages"] == 0:
                    break
                if time.monotonic() > deadline:
                    _fail(f"deploy: on the cluster a closed stream kept its pages: {after}")
                time.sleep(0.002)
        finally:
            client.close()
    finally:
        serve.shutdown()
        t0 = time.perf_counter()
        rt.shutdown()
        down_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    left = _cluster_processes(session_dir)
    pools = glob.glob(ours + "*")
    h_ttft, h_tps = _latency(runs, labels[:8])
    f_ttft, f_tps = _latency(runs, labels[8:])
    all_ttft, all_tps = _latency(runs, labels)
    mismatched = [lb for lb in labels if [t for _, t in runs[lb][1]] != [t for _, t in direct[lb][1]]]
    steps = after["decode_steps"] - before["decode_steps"]
    print(f"[deploy] cluster: init() {init_s:.2f} s; the 7B replica in worker pid "
          f"{replica['pid']} (driver {os.getpid()}), CUDA_VISIBLE_DEVICES="
          f"{replica['visible']!r}, up in {up_s:.1f} s; greedy tokens equal to the direct "
          f"engine's: {16 - len(mismatched)}/16; launches counted in the replica's process "
          f"{launches}", flush=True)
    print(f"[deploy] cluster {smi}: handle TTFT p50 {h_ttft:.1f} ms, decode {h_tps:.1f} "
          f"tok/s; feed TTFT p50 {f_ttft:.1f} ms, decode {f_tps:.1f} tok/s; all 16 TTFT p50 "
          f"{all_ttft:.1f} ms, decode {all_tps:.1f} tok/s; {local_line}", flush=True)
    print(f"[deploy] cluster: handle close() after 2 of 400 tokens ({got}): pages and slot "
          f"freed {steps} decode step(s) after close returned; shutdown {down_s:.2f} s, "
          f"processes left {left}, pools left {sorted(pools)}", flush=True)
    if replica["pid"] == os.getpid() or replica["visible"] != "0":
        _fail("deploy: the cluster replica is not a worker process that sees exactly device 0")
    if mismatched:
        _fail(f"deploy: on the cluster greedy tokens differ from the direct engine for "
              f"{mismatched}")
    if launches["flash_fwd"] < 32 * 16 or launches["flash_bwd_dq"] or launches["flash_bwd_dkv"]:
        _fail(f"deploy: the cluster replica launched {launches}, want flash_fwd >= 32 x 16 "
              f"and no backward kernel")
    if steps > 1:
        _fail(f"deploy: on the cluster a closed stream's pages freed {steps} decode steps "
              f"after close")
    if left or pools:
        _fail("deploy: processes or /dev/shm/rtpt_* pools outlived the cluster's shutdown")
    return launches


def _launch_counts():
    from ray_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.flash_fwd.launches, "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def _zero_launch_counts():
    from ray_tpu_torch.ops import flash_attention as fa

    fa.flash_fwd.launches = fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0


def _named_leaves(tree, prefix=""):
    """[(path, tensor)] of a param tree, e.g. ("blocks/attn/wq", t)."""
    if isinstance(tree, dict):
        return [leaf for key, sub in tree.items()
                for leaf in _named_leaves(sub, f"{prefix}{key}/")]
    return [(prefix.rstrip("/"), tree)]


def phase_train_parity():
    """3 AdamW steps at Llama-2-7B width, 2 layers, float32 with TF32 off,
    b=1, s=256, through the kernels (attn_impl="full") and through plain
    autograd over attention_reference ("naive"), from the same params and
    tokens, under remat "dots" and "hot". The first step's gradient of every
    leaf agrees within 1e-5 of that leaf's norm (readings at most 2.6e-6:
    fp32 sums in another order); Adam's updates hide a gradient off by a
    factor, so the losses alone do not show one. Losses agree within 5e-5
    relative at every step: Adam carries the gradients' rounding into the
    next steps. The flash forward runs twice per layer per step under "dots"
    (remat runs it again) and once under "hot" (its output is kept)."""
    import torch

    from ray_tpu_torch.models import transformer as tfm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rtol, grad_rtol, n_layers, n_steps = 5e-5, 1e-5, 2, 3
    tokens = torch.randint(0, 32000, (1, 256), generator=torch.Generator().manual_seed(3))
    for policy, fwd_per_layer in (("dots", 2), ("hot", 1)):
        losses, launches, grads = {}, {}, {}
        for impl in ("full", "naive"):
            cfg = tfm.llama2_7b(n_layers=n_layers, dtype=torch.float32, attn_impl=impl,
                                remat_policy=policy)
            init, step = tfm.build_train_step(cfg, tfm.adamw(1e-4), device="cuda")
            params, opt = init(torch.Generator(device="cuda").manual_seed(2))
            _zero_launch_counts()
            losses[impl] = [step(params, opt, tokens).item()]
            # step leaves each leaf's gradient in .grad until the next step
            grads[impl] = {name: t.grad.clone() for name, t in _named_leaves(params)}
            losses[impl] += [step(params, opt, tokens).item() for _ in range(n_steps - 1)]
            launches[impl] = _launch_counts()
            del params, opt
            torch.cuda.empty_cache()
        grad_diff = {name: ((g - grads["naive"][name]).norm() / grads["naive"][name].norm()).item()
                     for name, g in grads["full"].items()}
        del grads
        torch.cuda.empty_cache()
        diff = max(abs(a - b) / abs(b) for a, b in zip(losses["full"], losses["naive"]))
        print(f"[train-parity] llama2_7b width, 2 layers, fp32, b=1 s=256, adamw(1e-4), remat "
              f"{policy}: losses kernels {[round(x, 6) for x in losses['full']]} plain "
              f"{[round(x, 6) for x in losses['naive']]}; max rel diff {diff:.3g} (tol {rtol}); "
              f"launches kernels {launches['full']} plain {launches['naive']}", flush=True)
        print(f"[train-parity] remat {policy}: first-step gradient, |kernels - plain| / |plain| "
              "per leaf: " + ", ".join(f"{n} {e:.3g}" for n, e in grad_diff.items())
              + f" (tol {grad_rtol})", flush=True)
        if not all(math.isfinite(x) for x in losses["full"] + losses["naive"]) or diff > rtol:
            _fail(f"train-parity: the kernels' losses disagree with plain autograd ({policy})")
        if not all(e <= grad_rtol for e in grad_diff.values()):
            _fail(f"train-parity: the kernels' first-step gradients disagree with plain "
                  f"autograd ({policy})")
        want = {"flash_fwd": fwd_per_layer * n_layers * n_steps,
                "flash_bwd_dq": n_layers * n_steps, "flash_bwd_dkv": n_layers * n_steps}
        if launches["full"] != want or any(launches["naive"].values()):
            _fail(f"train-parity launches under {policy}: {launches}, want {want} through the "
                  "kernels")


# Flash forward launches per layer per step under each remat policy: "dots"
# runs it again in the backward, "attn" and "hot" keep its output.
TRAIN_POLICIES = {"hot": 1, "dots": 2, "attn": 1}


def _train_run(policy: str, profile: bool):
    """6 AdamW steps of llama2_7b(n_layers=8) in bf16 under remat `policy`,
    on one fixed batch of 2 x 2048 random tokens; returns each kernel's
    launches."""
    import gc
    import statistics

    import torch

    from ray_tpu_torch.models import transformer as tfm

    cfg = tfm.llama2_7b(n_layers=8, dtype=torch.bfloat16, remat_policy=policy)
    b, s, n_steps = 2, 2048, 6
    init, step = tfm.build_train_step(cfg, tfm.adamw(1e-4), device="cuda")
    gc.collect()  # what earlier phases left in reference cycles
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params, opt = init(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    n_params = tfm.param_count(params)
    print(f"[train] llama2_7b width, {cfg.n_layers} layers ({n_params / 1e9:.3f} B params), bf16, "
          f"remat {policy}, random weights from seed 0 on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    losses, step_ms = [], []
    for _ in range(n_steps):
        t = time.perf_counter()
        losses.append(step(params, opt, tokens).item())  # .item() waits for the device
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # What the policy keeps: the bytes one more forward leaves allocated for
    # its backward (logits and loss included, the same under every policy),
    # and that backward's peak, both above params, AdamW state and tokens.
    opt.zero_grad(set_to_none=True)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss = tfm.next_token_loss(params, tokens, cfg)
    kept = torch.cuda.memory_allocated() - base
    loss.backward()
    del loss
    fwd_bwd_peak = torch.cuda.max_memory_allocated() - base
    opt.zero_grad(set_to_none=True)
    p50 = statistics.median(step_ms[1:])
    tok_s = b * s / (p50 / 1e3)
    mfu = tfm.flops_per_token(cfg, s) * tok_s / PEAK_FLOPS["bfloat16"]
    print(f"[train] remat {policy}: {n_steps} steps of adamw(1e-4) on {b} x {s} tokens: losses "
          f"{[round(x, 4) for x in losses]}; step ms {[round(t, 1) for t in step_ms]}, p50 over "
          f"steps 2-{n_steps} {p50:.1f}; {tok_s:.0f} tokens/s; MFU {100 * mfu:.2f}% (against "
          f"the H100 bf16 dense peak, 989 TFLOP/s); max_memory_allocated {peak / 2**30:.2f} GiB "
          f"({held / 2**30:.2f} GiB held before the phase); launches {launches}", flush=True)
    print(f"[train] remat {policy}: one more forward keeps {kept / 2**20:.1f} MiB for its "
          f"backward ({kept / 2**20 / cfg.n_layers:.1f} MiB per layer, logits included); that "
          f"backward peaks {fwd_bwd_peak / 2**30:.3f} GiB above params and AdamW state",
          flush=True)
    if profile:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        with prof:
            t = time.perf_counter()
            step(params, opt, tokens).item()
            wall = time.perf_counter() - t
        _print_profile(prof, wall, f"train {policy}")
    del params, opt
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses):
        _fail(f"train ({policy}): a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        _fail(f"train ({policy}): the loss did not fall: {losses}")
    want = {"flash_fwd": TRAIN_POLICIES[policy] * cfg.n_layers * n_steps,
            "flash_bwd_dq": cfg.n_layers * n_steps, "flash_bwd_dkv": cfg.n_layers * n_steps}
    if launches != want:
        _fail(f"train ({policy}): launches {launches}, want {want}")
    return launches


def phase_train(profile: bool = False):
    """The train run under remat "hot" (the JAX package's training default),
    then "dots" and "attn"; returns the "hot" run's launches."""
    runs = {policy: _train_run(policy, profile and policy == "hot") for policy in TRAIN_POLICIES}
    return runs["hot"]


@contextlib.contextmanager
def _deterministic():
    """torch.use_deterministic_algorithms(True) inside, restored after; the
    embedding's backward then sums without atomics. cuBLAS asks for
    CUBLAS_WORKSPACE_CONFIG, which this process uses on one stream only."""
    import torch

    was, env = torch.are_deterministic_algorithms_enabled(), os.environ.get(
        "CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


def _tree_equal(a, b) -> bool:
    """Whether two trees have the same key paths and every leaf the same
    dtype, shape and bytes (so -0.0 differs from 0.0)."""
    import torch

    from ray_tpu_torch.models.convert import flatten

    def raw(t):
        return t.detach().reshape(-1).view(torch.uint8)

    (pa, la), (pb, lb) = flatten(a), flatten(b)
    return pa == pb and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(raw(x).to(y.device), raw(y))
        for x, y in zip(la, lb))


def phase_zero():
    """ZeRO-1 over a NCCL group of one rank in this process, against the
    plain step from the same params: llama2_7b(n_layers=2), bf16, remat
    "hot", b=1, s=2048, 3 steps, deterministic algorithms. Losses and
    params must be bitwise equal: the update is elementwise and a
    reduce-scatter over one rank is the identity."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.train import backend, zero

    cfg = tfm.llama2_7b(n_layers=2, dtype=torch.bfloat16, remat_policy="hot")
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(5))
    t0 = time.perf_counter()
    info = backend.setup_torch_distributed(0, 1, backend.coordinator_address(
        backend.TorchBackendConfig()))
    print(f"[zero] process group {dist.get_backend()} {info} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    try:
        with _deterministic():
            runs = {}
            for name, kw in (("plain", {}), ("zero", {"zero_axis": "data"})):
                init, step = tfm.build_train_step(cfg, tfm.adamw(1e-4), device="cuda", **kw)
                params, opt = init(torch.Generator(device="cuda").manual_seed(4))
                losses, step_ms = [], []
                for _ in range(3):
                    t = time.perf_counter()
                    losses.append(step(params, opt, tokens).item())
                    step_ms.append((time.perf_counter() - t) * 1e3)
                runs[name] = (losses, params, zero.per_device_bytes(opt), step_ms)
                del opt
        (pl, pp, pb, pms), (zl, zp, zb, zms) = runs["plain"], runs["zero"]
        same = pl == zl and _tree_equal(pp, zp)
        print(f"[zero] llama2_7b width, 2 layers, bf16, remat hot, b=1 s=2048, 3 steps of "
              f"adamw(1e-4), {dist.get_backend()} world 1: losses plain {pl} zero {zl}; losses "
              "and params "
              f"bitwise equal {same}; optimizer state per device {pb / 2**30:.3f} GiB plain, "
              f"{zb / 2**30:.3f} GiB zero; step ms plain {[round(t, 1) for t in pms]}, zero "
              f"{[round(t, 1) for t in zms]}",
              flush=True)
        del runs, pp, zp
        torch.cuda.empty_cache()
        if not same:
            _fail("zero: the ZeRO step at world 1 differs from the plain step")
        if zb < pb:
            _fail(f"zero: {zb} optimizer bytes at world 1, below the plain {pb}")
    finally:
        dist.destroy_process_group()


def _greedy(cfg, params, prompt, n_new):
    """PagedLM prefill + decode on one sequence: n_new greedy tokens."""
    from ray_tpu_torch.serve.llm import PagedLM

    T = 16
    pages = list(range(1, 1 + -(-(len(prompt) + n_new) // T)))
    lm = PagedLM(cfg, params, device="cuda", num_pages=len(pages) + 1, page_tokens=T,
                 max_slots=1, max_pages_per_seq=len(pages))
    out = [lm.prefill(prompt, pages, 0)]
    while len(out) < n_new:
        out.append(lm.decode([out[-1]], [len(prompt) + len(out) - 1], [pages])[0])
    return out


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def phase_checkpoint():
    """Save, reshard, resume and HF round trip on llama2_7b(n_layers=1) (2
    before the observe phase came: the smoke's time), bf16, remat "hot",
    b=1, s=2048, under deterministic algorithms: 3 steps,
    save_state (elastic format) at world 1, reshard to world 4 on disk,
    restore into fresh params and a fresh optimizer (bitwise equal to what
    was saved), 3 more steps: losses and params bitwise equal to an
    uninterrupted 6-step run. Then export_hf_checkpoint ->
    load_hf_checkpoint, bitwise, and PagedLM's 8 greedy tokens from the
    reloaded weights equal those from the originals."""
    import shutil
    import tempfile

    import torch

    from ray_tpu_torch.models import convert
    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.train import elastic_checkpoint as ec
    from ray_tpu_torch.train import hf_checkpoint as hf

    cfg = tfm.llama2_7b(n_layers=1, dtype=torch.bfloat16, remat_policy="hot")
    init, step = tfm.build_train_step(cfg, tfm.adamw(1e-4), device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(6))
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    timings = {}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        timings[name] = time.perf_counter() - t
        return out

    try:
        with _deterministic():
            params, opt = init(torch.Generator(device="cuda").manual_seed(7))
            straight = [step(params, opt, tokens).item() for _ in range(6)]
            want = params
            del opt
            params, opt = init(torch.Generator(device="cuda").manual_seed(7))
            resumed = [step(params, opt, tokens).item() for _ in range(3)]
            saved = (params, convert.opt_state_to_torch(opt, params))
            w1, w4 = f"{tmp}/world1", f"{tmp}/world4"
            timed("save", ec.save_state, w1, *saved, step=3, world_size=1, rank=0)
            written = _dir_bytes(w1)
            for kind in ("params", "opt"):
                timed(f"reshard {kind}", ec.reshard, w1, w4, 4, kind=kind)
            shutil.rmtree(w1)
            state = timed("load", ec.load_state, w4)
            del params, opt
            params, opt = init(torch.Generator(device="cuda").manual_seed(8))
            with torch.no_grad():
                for t, src in zip(convert.flatten(params)[1],
                                  convert.flatten(state["params"])[1]):
                    t.copy_(src)
            convert.opt_state_from_numpy(state["opt_state"], opt, params)
            restored = (_tree_equal(saved[0], params)
                        and _tree_equal(saved[1], convert.opt_state_to_torch(opt, params))
                        and state["step"] == 3 and state["saved_world_size"] == 4)
            del saved, state
            resumed += [step(params, opt, tokens).item() for _ in range(3)]
            del opt
        same = resumed == straight and _tree_equal(want, params)
        print(f"[checkpoint] llama2_7b width, {cfg.n_layers} layer(s), bf16, remat hot, "
              f"b=1 s=2048, "
              f"deterministic: losses straight {straight} resumed {resumed}; restored state "
              f"bitwise equal to the saved {restored}; after 6 steps losses and params bitwise "
              f"equal {same}; elastic checkpoint {written / 2**30:.3f} GiB at world 1, "
              + ", ".join(f"{k} {v:.1f} s" for k, v in timings.items()), flush=True)
        if not restored:
            _fail("checkpoint: the restored state differs from the saved one")
        if not same:
            _fail("checkpoint: the resumed run differs from the uninterrupted one")
        del want
        path = f"{tmp}/model.safetensors"
        timed("hf export", hf.export_hf_checkpoint, params, cfg, path)
        loaded = timed("hf load", hf.load_hf_checkpoint, path, cfg, device="cuda")
        hf_same = _tree_equal(params, loaded)
        prompt = torch.randint(0, cfg.vocab_size, (21,),
                               generator=torch.Generator().manual_seed(9)).tolist()
        params = tfm.map_tree(lambda t: t.detach(), params)
        got, gold = _greedy(cfg, loaded, prompt, 8), _greedy(cfg, params, prompt, 8)
        print(f"[checkpoint] HF safetensors {os.path.getsize(path) / 2**30:.3f} GiB: export "
              f"{timings['hf export']:.1f} s, load onto the card {timings['hf load']:.1f} s; "
              f"reloaded weights bitwise equal {hf_same}; greedy tokens reloaded {got} "
              f"original {gold}", flush=True)
        if not hf_same or got != gold:
            _fail("checkpoint: the HF round trip changed the weights or the greedy tokens")
        del params, loaded
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# The fit and tune phases train the zero phase's configuration through
# TorchTrainer and Tuner: llama2_7b(n_layers=2), bf16, remat "hot", b=1,
# s=2048, adamw, seed 0, under deterministic algorithms.
FIT_SEQ = 2048
FIT_STEPS, FIT_CKPT_AT, FIT_FAIL_AFTER = 8, 3, 5
TUNE_STEPS, TUNE_LRS = 4, (1e-4, 3e-4)
# With --profile, step 6 of the plain runs and of run B's resumed attempt is
# traced; it is left out of every step p50.
FIT_PROFILE_AT = 6


def _traced(enabled: bool):
    import torch

    if not enabled:
        return contextlib.nullcontext()
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])


def _in_thread(fn, *args):
    """fn(*args) in a plain threading.Thread (no runtime); its result."""
    import threading

    out = {}

    def run():
        try:
            out["value"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out["error"] = e

    t = threading.Thread(target=run, name="plain-step")
    t.start()
    t.join(timeout=300)
    if "error" in out:
        raise out["error"]
    if "value" not in out:
        _fail("a plain run in its own thread did not finish in 300 s")
    return out["value"]


def _fit_cfg():
    import torch

    from ray_tpu_torch.models import transformer as tfm

    return tfm.llama2_7b(n_layers=2, dtype=torch.bfloat16, remat_policy="hot")


def _fit_batch(step: int, vocab: int):
    """Step i's batch: 1 x 2048 tokens from a generator seeded with i, so a
    resume at the wrong step shows in its losses."""
    import torch

    return torch.randint(0, vocab, (1, FIT_SEQ), generator=torch.Generator().manual_seed(step))


def _params_sha256(params) -> str:
    """SHA-256 of every param's bytes in convert.flatten's order."""
    import hashlib

    import torch

    from ray_tpu_torch.models.convert import flatten

    h = hashlib.sha256()
    for t in flatten(params)[1]:
        h.update(t.detach().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _direct_run(lr: float, n_steps: int, profile_at=None, label: str = ""):
    """The same model, seed and batches through build_train_step driven
    directly: (losses, step ms, params_sha256). Step `profile_at` is traced
    and its device time printed under `label`."""
    import torch

    from ray_tpu_torch.models import transformer as tfm

    cfg = _fit_cfg()
    init, step = tfm.build_train_step(cfg, tfm.adamw(lr), device="cuda")
    params, opt = init(torch.Generator(device="cuda").manual_seed(0))
    losses, step_ms = [], []
    for i in range(n_steps):
        tokens = _fit_batch(i, cfg.vocab_size)
        with _traced(i == profile_at) as prof:
            t = time.perf_counter()
            losses.append(step(params, opt, tokens).item())  # .item() waits for the device
            step_ms.append((time.perf_counter() - t) * 1e3)
        if i == profile_at:
            _print_profile(prof, step_ms[-1] / 1e3, label, top=5)
    sha = _params_sha256(params)
    del params, opt
    torch.cuda.empty_cache()
    return losses, step_ms, sha


def _make_loop(log: list):
    """The training loop of the fit and tune phases, as a user writes it for
    TorchTrainer: the model and AdamW state built on the mesh's device from
    seed 0; with a checkpoint from train.get_checkpoint(), params and AdamW
    state restored from it and the steps resumed after its step; one report
    per step with the loss and tokens_per_s (MFU from configure_telemetry);
    an elastic checkpoint of params and AdamW state reported at
    config["ckpt_at"]; a raise after reporting config["fail_after"] in an
    attempt that did not restore; step config["profile_at"] traced.
    Appends its events to `log`."""

    def loop(config):
        import gc
        import shutil
        import tempfile

        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.models import convert
        from ray_tpu_torch.models import transformer as tfm
        from ray_tpu_torch.train import elastic_checkpoint as ec

        run, lr = config["run"], config["lr"]
        device = train.get_mesh().devices.flat[0]
        gc.collect()
        log.append({"run": run, "lr": lr, "event": "start",
                    "allocated": torch.cuda.memory_allocated(device)})
        cfg = _fit_cfg()
        train.configure_telemetry(flops_per_token=tfm.flops_per_token(cfg, FIT_SEQ))
        init, step = tfm.build_train_step(cfg, tfm.adamw(lr), device=device)
        params, opt = init(torch.Generator(device=device).manual_seed(0))
        start, ck = 0, train.get_checkpoint()
        if ck is not None:
            t = time.perf_counter()
            state = ec.load_state(ck.path)
            with torch.no_grad():
                for p, src in zip(convert.flatten(params)[1],
                                  convert.flatten(state["params"])[1]):
                    p.copy_(src)
            convert.opt_state_from_numpy(state["opt_state"], opt, params)
            torch.cuda.synchronize(device)
            log.append({"run": run, "lr": lr, "event": "restore",
                        "s": time.perf_counter() - t})
            start = state["step"] + 1
            del state
        sources = {}  # step -> directory of a reported checkpoint
        for i in range(start, config["steps"]):
            tokens = _fit_batch(i, cfg.vocab_size)
            with _traced(i == config.get("profile_at")) as prof:
                t = time.perf_counter()
                with train.phase("compute"):
                    loss = step(params, opt, tokens).item()  # .item() waits for the device
                dt = time.perf_counter() - t
            if i == config.get("profile_at"):
                _print_profile(prof, dt, f"fit trainer step {i} (run {run})", top=5)
            metrics = {"step": i, "loss": loss, "lr": lr, "tokens_per_s": FIT_SEQ / dt}
            if i == config["steps"] - 1:
                metrics["params_sha256"] = _params_sha256(params)
            ckpt = None
            if i == config.get("ckpt_at"):
                d = tempfile.mkdtemp(prefix="ckpt-", dir=config["scratch"])
                t = time.perf_counter()
                opt_state = convert.opt_state_to_torch(opt, params)  # host copies
                t_state = time.perf_counter()
                ec.save_state(d, params, opt_state, step=i, world_size=1, rank=0)
                del opt_state
                log.append({"run": run, "lr": lr, "event": "save",
                            "s": time.perf_counter() - t, "state_s": t_state - t})
                sources[i], ckpt = d, train.Checkpoint(d)
            entry = {"run": run, "lr": lr, "event": "report", "step": i, "loss": loss,
                     "compute_ms": FIT_SEQ / metrics["tokens_per_s"] * 1e3,
                     "t": time.perf_counter(), "metrics": metrics}
            log.append(entry)
            train.report(metrics, checkpoint=ckpt)
            entry["report_ms"] = (time.perf_counter() - entry["t"]) * 1e3
            # report() returns once its payload is queued, and the trainer
            # copies a checkpoint after taking it off the size-1 queue: only
            # the report two steps later proves that copy done.
            for s in [s for s in sources if s <= i - 2]:
                shutil.rmtree(sources.pop(s))
            if ck is None and i == config.get("fail_after"):
                raise RuntimeError(f"injected failure after step {i}")

    return loop


def _intervals_ms(log, run, lr=None):
    """{step: ms from the previous step's report to this one's}."""
    t = {e["step"]: e["t"] for e in log
         if e["event"] == "report" and e["run"] == run and (lr is None or e["lr"] == lr)}
    return {i: (t[i] - t[i - 1]) * 1e3 for i in sorted(t) if i - 1 in t}


def phase_fit(profile: bool = False):
    """TorchTrainer.fit on the card, ScalingConfig(num_workers=1,
    resources_per_worker={"GPU": 1}), keep-1 checkpoints. Run A: 8 steps
    uninterrupted, an elastic checkpoint (params and AdamW state) reported at
    step 3. Run B: the same loop with max_failures=1; its first attempt
    raises after reporting step 5, its second restores step 3's checkpoint
    through train.get_checkpoint() and runs steps 4-7. Exact gates: B
    succeeds; both end at step 7; A's losses and params equal
    build_train_step driven directly, and B's losses of steps 4-7 and final
    params equal A's, bit for bit; one checkpoint directory in each trial
    dir; B's goodput has restart_rework and A's none; the reported MFU is
    flops_per_token x tokens_per_s / 989e12; each kernel launches 16 times
    in A and 20 in B. Prints the trainer's step p50 (report to report, over
    A's clean steps) against the plain step's, driven from the main thread
    before the runtime starts and while it is up, and from a plain thread
    with no runtime; checkpoint save, persist and restore seconds, goodput,
    and memory after B's failed attempt and after its fit. With `profile`,
    step 6 of B's resumed attempt and of each plain run is traced. Returns
    each run's launches and the trainer's step p50."""
    import gc
    import shutil
    import statistics
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig, RunConfig,
                                     ScalingConfig, TorchTrainer)

    gc.collect()
    torch.cuda.empty_cache()
    smi = _smi()
    cfg = _fit_cfg()
    fpt = tfm.flops_per_token(cfg, FIT_SEQ)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-fit-")
    log, results, launches, memory = [], {}, {}, {}
    loop = _make_loop(log)
    at = FIT_PROFILE_AT if profile else None
    with _deterministic():
        # The plain step three ways: from the main thread, from a plain
        # thread (no runtime), and from the main thread with the runtime up.
        plain = {"main": _direct_run(1e-4, FIT_STEPS, at, "fit plain step, main thread"),
                 "thread": _in_thread(_direct_run, 1e-4, FIT_STEPS, at,
                                      "fit plain step, own thread, no runtime")}
        rt.init(local_mode=True)
        try:
            for run, extra, failures in (
                    ("A", {}, 0),
                    ("B", {"fail_after": FIT_FAIL_AFTER, "profile_at": at}, 1)):
                scratch = os.path.join(tmp, f"{run}-sources")
                os.makedirs(scratch)
                trainer = TorchTrainer(
                    loop,
                    train_loop_config={"run": run, "lr": 1e-4, "steps": FIT_STEPS,
                                       "ckpt_at": FIT_CKPT_AT, "scratch": scratch, **extra},
                    scaling_config=ScalingConfig(num_workers=1, resources_per_worker={"GPU": 1}),
                    run_config=RunConfig(name=f"fit_{run}", storage_path=tmp,
                                         failure_config=FailureConfig(max_failures=failures),
                                         checkpoint_config=CheckpointConfig(num_to_keep=1)))
                gc.collect()
                memory[f"{run} before"] = torch.cuda.memory_allocated()
                _zero_launch_counts()
                t0 = time.perf_counter()
                results[run] = trainer.fit()
                wall = time.perf_counter() - t0
                launches[run] = _launch_counts()
                gc.collect()
                memory[f"{run} after fit"] = torch.cuda.memory_allocated()
                print(f"[fit] run {run}: fit {wall:.1f} s, error {results[run].error!r}, "
                      f"launches {launches[run]}", flush=True)
            plain["main, runtime up"] = _direct_run(
                1e-4, FIT_STEPS, at, "fit plain step, main thread, runtime up")
        finally:
            rt.shutdown()
    try:
        a, b = results["A"], results["B"]
        steps = {run: {e["step"]: e["metrics"] for e in log
                       if e["event"] == "report" and e["run"] == run} for run in "AB"}
        b_starts = [e["allocated"] for e in log if e["event"] == "start" and e["run"] == "B"]
        ckpt_dirs = {run: sorted(d for d in os.listdir(results[run].path)
                                 if d.startswith("checkpoint_")) for run in "AB"}
        a_losses = [steps["A"][i]["loss"] for i in range(FIT_STEPS)]
        b_second = max(k for k, e in enumerate(log) if e["event"] == "start" and e["run"] == "B")
        b_last = {e["step"]: e["loss"] for e in log[b_second:]
                  if e["event"] == "report" and e["run"] == "B"}  # B's second attempt
        steps_log = {e["step"]: e for e in log if e["event"] == "report" and e["run"] == "A"}
        saves = [e["s"] for e in log if e["event"] == "save"]
        save_state_s = [e["state_s"] for e in log if e["event"] == "save"]
        restores = [e["s"] for e in log if e["event"] == "restore"]
        gaps = _intervals_ms(log, "A")
        # Clean intervals: not the checkpoint's step (the save), not the one
        # whose report() waits out the trainer's copy of it (the second
        # report after it: the first fills the size-1 queue while the copy
        # runs), not the last (params_sha256).
        timed = [i for i in range(1, FIT_STEPS - 1) if i not in (FIT_CKPT_AT, FIT_CKPT_AT + 3)]
        trainer_p50 = statistics.median(gaps[i] for i in timed)
        # The step alone (the loop's timer around it), over the steps the
        # plain p50s take.
        steps_timed = [i for i in range(1, FIT_STEPS) if i != at]
        compute_p50 = statistics.median(steps_log[i]["compute_ms"] for i in steps_timed)
        plain_p50 = {k: statistics.median(v[1][i] for i in steps_timed) for k, v in plain.items()}
        last = a.metrics
        want_mfu = fpt * last["tokens_per_s"] / PEAK_FLOPS["bfloat16"]
        print(f"[fit] {smi}: llama2_7b width, 2 layers, bf16, remat hot, b=1 s={FIT_SEQ}, "
              f"adamw(1e-4), deterministic, TorchTrainer on init(local_mode=True): losses A "
              f"{a_losses}; plain {plain['main'][0]}; B's second attempt {b_last}", flush=True)
        print(f"[fit] {smi}: trainer step ms report to report (A), as step: interval / "
              "compute / report() call "
              + ", ".join(f"{i}: {gaps[i]:.1f} / {steps_log[i]['compute_ms']:.1f} / "
                          f"{steps_log[i]['report_ms']:.2f}" for i in sorted(gaps))
              + "; plain step ms " + "; ".join(f"{k} {[round(t, 1) for t in v[1]]}"
                                                for k, v in plain.items()), flush=True)
        base = plain_p50["main"]
        print(f"[fit] {smi}: trainer step p50 over clean intervals {timed} {trainer_p50:.2f} ms, "
              f"the step alone p50 over steps {steps_timed} {compute_p50:.2f} ms; plain step p50 "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in plain_p50.items())
              + f"; against the main thread's: trainer ratio {trainer_p50 / base:.4f}, its step "
              f"alone {compute_p50 / base:.4f}, "
              + ", ".join(f"{k} {v / base:.4f}" for k, v in plain_p50.items() if k != "main"),
              flush=True)
        print(f"[fit] {smi}: elastic checkpoint save s {[round(s, 2) for s in saves]} (of "
              f"which AdamW state to the host {[round(s, 2) for s in save_state_s]}), "
              f"persist (copy) s A {a.metrics['goodput_seconds']['checkpoint']} B "
              f"{b.metrics['goodput_seconds']['checkpoint']}, restore s "
              f"{[round(s, 2) for s in restores]}; goodput A {a.metrics['goodput']:.4f} "
              f"{a.metrics['goodput_seconds']}, B {b.metrics['goodput']:.4f} "
              f"{b.metrics['goodput_seconds']}; MFU reported {last['mfu']:.6f} at "
              f"{last['tokens_per_s']:.0f} tokens/s, expected {want_mfu:.6f}", flush=True)
        print(f"[fit] {smi}: memory_allocated GiB before B {memory['B before'] / 2**30:.3f}, "
              f"after B's failed attempt {b_starts[-1] / 2**30:.3f}, after B's fit "
              f"{memory['B after fit'] / 2**30:.3f} (A: before {memory['A before'] / 2**30:.3f}, "
              f"after {memory['A after fit'] / 2**30:.3f}); checkpoint dirs {ckpt_dirs}",
              flush=True)
        if b.error is not None or a.error is not None:
            _fail(f"fit: errors A {a.error!r} B {b.error!r}")
        if a.metrics["step"] != FIT_STEPS - 1 or b.metrics["step"] != FIT_STEPS - 1:
            _fail(f"fit: last steps A {a.metrics['step']} B {b.metrics['step']}")
        want_losses, _, want_sha = plain["main"]
        if a_losses != want_losses or steps["A"][FIT_STEPS - 1]["params_sha256"] != want_sha:
            _fail("fit: the trainer's run differs from build_train_step driven directly")
        if any(v[0] != want_losses or v[2] != want_sha for v in plain.values()):
            _fail("fit: the direct runs differ")
        if (sorted(b_last) != list(range(FIT_CKPT_AT + 1, FIT_STEPS))
                or any(b_last[i] != a_losses[i] for i in b_last)):
            _fail("fit: the resumed attempt's losses differ from the uninterrupted run's")
        if b.metrics["params_sha256"] != a.metrics["params_sha256"]:
            _fail("fit: the resumed run's params differ from the uninterrupted run's")
        if len(restores) != 1 or len(saves) != 2:
            _fail(f"fit: {len(saves)} saves and {len(restores)} restores, want 2 and 1")
        if any(len(d) != 1 for d in ckpt_dirs.values()):
            _fail(f"fit: keep-1 left {ckpt_dirs}")
        if (a.metrics["goodput_seconds"]["restart_rework"] != 0
                or not b.metrics["goodput_seconds"]["restart_rework"] > 0):
            _fail("fit: restart_rework is not 0 in A and positive in B")
        if abs(last["mfu"] - want_mfu) > 1e-9 * want_mfu:
            _fail(f"fit: MFU {last['mfu']} against {want_mfu} at the H100's 989e12")
        # The failed attempt's error stays on the Result; its tensors must
        # not (params, grads and AdamW state: 5.0 GiB).
        if max(b_starts[-1], memory["B after fit"]) - memory["B before"] > 256 * 2**20:
            _fail("fit: the failed attempt's tensors stayed allocated")
        for run, n_steps in (("A", FIT_STEPS),
                             ("B", FIT_FAIL_AFTER + 1 + FIT_STEPS - FIT_CKPT_AT - 1)):
            want = {k: cfg.n_layers * n_steps for k in launches[run]}
            if launches[run] != want:
                _fail(f"fit: run {run} launched {launches[run]}, want {want}")
        return {"fit_uninterrupted": launches["A"], "fit_resumed": launches["B"]}, trainer_p50
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_tune(fit_step_ms: float):
    """Tuner over the fit phase's TorchTrainer: grid lr in {1e-4, 3e-4},
    TuneConfig(metric="loss", mode="min", max_concurrent_trials=2), so both
    trials train on the card at once from two threads, 4 steps each, the
    same model and batches, deterministic algorithms. Each trial's losses
    and final params must equal build_train_step driven directly with its
    lr, bit for bit; get_best_result() must name the trial whose last loss
    is lower; each kernel launches 16 times. Prints each trial's step p50
    and their combined tokens/s against the lone trainer's."""
    import gc
    import shutil
    import statistics
    import tempfile
    import threading

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    gc.collect()
    torch.cuda.empty_cache()
    smi = _smi()
    cfg = _fit_cfg()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-tune-")
    log = []
    rt.init(local_mode=True)
    try:
        with _deterministic():
            direct = {lr: _direct_run(lr, TUNE_STEPS) for lr in TUNE_LRS}
            # Control: the same two runs at once from two plain threads, no
            # runtime and no Tune, for what sharing the card costs by itself.
            both = {}
            threads = [threading.Thread(target=lambda lr=lr: both.update(
                {lr: _direct_run(lr, TUNE_STEPS)})) for lr in TUNE_LRS]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            trainer = TorchTrainer(
                _make_loop(log),
                train_loop_config={"run": "tune", "steps": TUNE_STEPS, "scratch": tmp},
                scaling_config=ScalingConfig(num_workers=1, resources_per_worker={"GPU": 1}),
                run_config=RunConfig(storage_path=os.path.join(tmp, "inner")))
            _zero_launch_counts()
            t0 = time.perf_counter()
            grid = tune.Tuner(
                trainer,
                param_space={"lr": tune.grid_search(list(TUNE_LRS))},
                tune_config=tune.TuneConfig(metric="loss", mode="min", max_concurrent_trials=2),
                run_config=RunConfig(name="tune", storage_path=tmp),
            ).fit()
            wall = time.perf_counter() - t0
            launches = _launch_counts()
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    trial = {lr: {e["step"]: e["metrics"] for e in log
                  if e["event"] == "report" and e["lr"] == lr} for lr in TUNE_LRS}
    # Steps 1..TUNE_STEPS-2: the last interval carries params_sha256.
    p50 = {lr: statistics.median(ms for i, ms in _intervals_ms(log, "tune", lr).items()
                                 if i < TUNE_STEPS - 1) for lr in TUNE_LRS}
    combined = sum(FIT_SEQ / (ms / 1e3) for ms in p50.values())
    lone = FIT_SEQ / (fit_step_ms / 1e3)
    best = grid.get_best_result()
    want_best = min(TUNE_LRS, key=lambda lr: direct[lr][0][-1])
    print(f"[tune] {smi}: Tuner over TorchTrainer, lr {list(TUNE_LRS)}, 2 trials at once, "
          f"{TUNE_STEPS} steps each, in {wall:.1f} s: losses "
          + "; ".join(f"lr {lr} trial {[trial[lr][i]['loss'] for i in sorted(trial[lr])]} "
                      f"direct {direct[lr][0]}" for lr in TUNE_LRS)
          + f"; best {best.metrics.get('lr')} (want {want_best}); errors {grid.errors}; "
          f"launches {launches}", flush=True)
    print(f"[tune] {smi}: per-trial step p50 (report to report, steps 1-{TUNE_STEPS - 2}) "
          + ", ".join(f"lr {lr} {p50[lr]:.2f} ms ({p50[lr] / fit_step_ms:.3f}x the lone "
                      "trainer's)" for lr in TUNE_LRS)
          + f"; combined {combined:.0f} tokens/s against the lone trainer's {lone:.0f} "
          f"({combined / lone:.3f}x)", flush=True)
    print(f"[tune] {smi}: control, the two direct runs at once from two threads: step ms "
          + "; ".join(f"lr {lr} {[round(t, 1) for t in both[lr][1]]} (p50 steps 1-"
                      f"{TUNE_STEPS - 1} {statistics.median(both[lr][1][1:]):.2f}), losses "
                      f"equal to the sequential run's {both[lr][0] == direct[lr][0]}"
                      for lr in TUNE_LRS if lr in both)
          + f"; the sequential runs' step p50 "
          + ", ".join(f"{statistics.median(direct[lr][1][1:]):.2f}" for lr in TUNE_LRS),
          flush=True)
    if grid.errors or len(grid) != len(TUNE_LRS):
        _fail(f"tune: {len(grid)} results, errors {grid.errors}")
    for lr in TUNE_LRS:
        got = [trial[lr][i]["loss"] for i in sorted(trial[lr])]
        if got != direct[lr][0] or trial[lr][TUNE_STEPS - 1]["params_sha256"] != direct[lr][2]:
            _fail(f"tune: the lr {lr} trial differs from build_train_step driven directly")
    if best.metrics.get("lr") != want_best:
        _fail(f"tune: get_best_result() named lr {best.metrics.get('lr')}, want {want_best}")
    want = {k: cfg.n_layers * TUNE_STEPS * len(TUNE_LRS) for k in launches}
    if launches != want:
        _fail(f"tune: launches {launches}, want {want}")
    return {"tune": launches}


# The parallel phase: a NCCL world of one rank in this process (a), then
# PARALLEL_WORLD processes sharing the card over gloo (b).
PARALLEL_WORLD = 4
PARALLEL_TIMEOUT_S = 900
# Where ray_tpu_torch is imported from when not this checkout (--package-root).
_PACKAGE_ROOT = None
# (b)'s attention at Llama-2-7B's width: (b, global s, heads, head_dim).
PAR_ATTN_SHAPE = (1, 8192, 32, 128)
PAR_SEQ = 2048
PAR_MICROBATCHES = 4
# (b)'s attention against one flash_attention call over the whole sequence,
# per entry, to the whole result's rms. Ulysses runs that call's kernel on
# each head group: 2**-6, the kernel phase's. The ring rounds each block's
# o and each block's dq/dk/dv to bf16 before it sums them, where the whole
# call rounds once, so the two differ by more than one kernel and its plain
# version do (up to 0.0186 on an H100, PERF.md): the ring is held to 2**-5.
# A wrong block, mask or lse merge is off by O(1), and both planted faults
# must still be refused.
PAR_TOL = {"ring": 2 ** -5, "ulysses": 2 ** -6}


def _grad_diffs(got, full):
    """({leaf: |g - g_full| / |g_full|}, every leaf bitwise equal) of two
    {leaf: gradient} dicts."""
    import torch

    diffs, bitwise = {}, True
    for name, g in got.items():
        ref = full[name].to(g.device)
        diffs[name] = ((g - ref).norm() / ref.norm()).item()
        bitwise = bitwise and torch.equal(g, ref)
    return diffs, bitwise


def _check_loss_grads(label, loss, loss_full, got, full, launches, log):
    """Logs and gates a loss and its gradients against the reference's at
    the train-parity phase's tolerances: loss 5e-5 relative, each leaf 1e-5
    of its gradient's norm."""
    rtol, grad_rtol = 5e-5, 1e-5
    diffs, bitwise = _grad_diffs(got, full)
    diff, worst = abs(loss - loss_full) / abs(loss_full), max(diffs.values())
    bitwise = bitwise and loss == loss_full
    log(f"{label}: loss {loss:.6f} vs {loss_full:.6f} (rel diff {diff:.3g}, tol {rtol}); worst "
        f"leaf gradient |g - g_ref| / |g_ref| {worst:.3g} ({max(diffs, key=diffs.get)}; tol "
        f"{grad_rtol}); bitwise {bitwise}; launches {launches}")
    if not (math.isfinite(loss) and diff <= rtol and worst <= grad_rtol):
        _fail(f"parallel: {label} disagrees with its reference: loss {diff:.3g}, gradients "
              f"{diffs}")


def _seq_parallel_losses(params, tokens, base, mesh, log):
    """next_token_loss with attn_impl "ring" and "ulysses" on `mesh` against
    "full" without one, from the same params: {impl: launches}; fails past
    _check_loss_grads's tolerances."""
    import torch

    from ray_tpu_torch.models import transformer as tfm

    loss_full = tfm.next_token_loss(params, tokens, base)
    loss_full.backward()
    full = {name: t.grad for name, t in _named_leaves(params)}
    for t in tfm.tree_leaves(params):
        t.grad = None
    out = {}
    for impl in ("ring", "ulysses"):
        _zero_launch_counts()
        loss = tfm.next_token_loss(params, tokens, base.replace(attn_impl=impl), mesh)
        loss.backward()
        torch.cuda.synchronize()
        out[impl] = _launch_counts()
        _check_loss_grads(f"{impl} vs full", loss.item(), loss_full.item(),
                          {name: t.grad for name, t in _named_leaves(params)}, full, out[impl],
                          log)
        for t in tfm.tree_leaves(params):
            t.grad = None
    return out


def _parallel_nccl():
    """(a): llama2_7b(n_layers=2), bf16, remat "hot", b=1, s=2048 on a
    DeviceMesh with seq=1 over a NCCL group of one rank."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.parallel import build_device_mesh
    from ray_tpu_torch.train import backend

    backend.setup_torch_distributed(0, 1, backend.coordinator_address(
        backend.TorchBackendConfig()))
    try:
        mesh = build_device_mesh(axis_sizes={"seq": 1})
        base = tfm.llama2_7b(n_layers=2, dtype=torch.bfloat16, remat_policy="hot")
        tokens = torch.randint(0, base.vocab_size, (1, 2048), device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(5))
        params = tfm.init_params(base, torch.Generator(device="cuda").manual_seed(4))
        for t in tfm.tree_leaves(params):
            t.requires_grad_(True)
        _seq_parallel_losses(params, tokens, base, mesh, lambda msg: print(
            f"[parallel] (a) {dist.get_backend()} world 1, seq=1, llama2_7b width, 2 layers, bf16, "
            f"remat hot, b=1 s=2048: {msg}", flush=True))
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        secs, dropped = _moe_world1(build_device_mesh(axis_sizes={"expert": 1}))
        print(f"[parallel] (a) {dist.get_backend()} world 1, moe_apply at Switch-Base's width "
              f"({MOE_CFG}), {MOE_TOKENS} tokens fp32, forward + backward: bitwise equal to "
              f"mesh=None; {dropped} tokens dropped; {secs:.3f} s; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    finally:
        dist.destroy_process_group()


def _par_attention(rank, n, mesh):
    """(b) at Llama-2-7B's attention width: ring_attention and
    ulysses_attention on this rank's shard of a causal bf16 sequence, the
    output and dq/dk/dv for a fixed dO against one flash_attention call over
    the whole sequence, entry by entry; each call's launches, then a second
    call's seconds."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import ring_attention, ulysses_attention

    b, s, h, d = PAR_ATTN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(21)
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    mine = slice(rank * s // n, (rank + 1) * s // n)
    ref = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    fa.flash_attention(*ref, causal=True).backward(do)
    o_ref = fa.flash_attention(*(x.detach() for x in ref), causal=True)
    whole = {"o": o_ref, **{f"d{n_}": x.grad for n_, x in zip("qkv", ref)}}
    # each rank holds its part of the whole call's result, to the whole's rms
    want = {key: (t[:, mine], t.float().pow(2).mean().sqrt()) for key, t in whole.items()}
    out = {}
    for impl, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        secs = []
        for call in range(2):
            leaves = [x[:, mine].contiguous().requires_grad_() for x in (q, k, v)]
            dist.barrier()
            torch.cuda.synchronize()
            _zero_launch_counts()
            t0 = time.perf_counter()
            o = fn(*leaves, mesh, causal=True)
            o.backward(do[:, mine].contiguous())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if call == 0:
                launches = _launch_counts()
                got = {"o": o, **{f"d{n_}": x.grad for n_, x in zip("qkv", leaves)}}
                errs = {key: entry_err(got[key], *want[key]) for key in want}
                planted = {f"{key} {fault}": entry_err(bad, *want[key])
                           for key in ("o", "dk") for fault, bad in
                           _planted_faults(got[key]).items()}
        out[impl] = {"launches": launches, "errs": errs, "planted": planted, "s": secs}
    return out


def _par_model(rank, n, mesh_seq, mesh_stage):
    """(b) at model level, fp32 with TF32 off: llama2_7b(n_layers=2), b=1,
    s=2048, ring and Ulysses over seq=n against "full" on this rank; then
    next_token_loss_pipelined over stage=n on llama2_7b(n_layers=n) with
    PAR_MICROBATCHES microbatches against next_token_loss."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import transformer as tfm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lines = []
    base = tfm.llama2_7b(n_layers=2, dtype=torch.float32, remat_policy="hot")
    tokens = torch.randint(0, base.vocab_size, (1, PAR_SEQ),
                           generator=torch.Generator().manual_seed(3)).cuda()
    params = tfm.init_params(base, torch.Generator(device="cuda").manual_seed(2))
    for t in tfm.tree_leaves(params):
        t.requires_grad_(True)
    t0 = time.perf_counter()
    seq = _seq_parallel_losses(params, tokens, base, mesh_seq, lines.append)
    seq_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()

    cfg = tfm.llama2_7b(n_layers=n, dtype=torch.float32, remat_policy="hot")
    tokens = torch.randint(0, cfg.vocab_size, (PAR_MICROBATCHES, PAR_SEQ),
                           generator=torch.Generator().manual_seed(6)).cuda()
    params = tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(7))
    for t in tfm.tree_leaves(params):
        t.requires_grad_(True)
    _zero_launch_counts()
    t0 = time.perf_counter()
    loss = tfm.next_token_loss_pipelined(params, tokens, cfg, mesh_stage,
                                         num_microbatches=PAR_MICROBATCHES)
    loss.backward()
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    launches = _launch_counts()
    # the pipeline's gradients wait on the host while the reference runs,
    # one rank at a time (four at once would not fit the card)
    piped = {name: t.grad.cpu() for name, t in _named_leaves(params)}
    for t in tfm.tree_leaves(params):
        t.grad = None
    for turn in range(n):
        if turn == rank:
            loss_full = tfm.next_token_loss(params, tokens, cfg)
            loss_full.backward()
            torch.cuda.synchronize()
        dist.barrier()
    _check_loss_grads(f"pipeline over stage={n}, {PAR_MICROBATCHES} microbatches, vs "
                      "next_token_loss", loss.item(), loss_full.item(), piped,
                      {name: t.grad for name, t in _named_leaves(params)}, launches, lines.append)
    del params, piped
    torch.cuda.empty_cache()
    return {**seq, "pipeline": launches}, lines, {"seq_s": seq_s, "pipeline_s": pipe_s}


# (c): tensor parallelism at Llama-2-7B's width, 2 layers, on these meshes
# of the 4 ranks, and TP x SP on TP_SP_MESH.
TP_MESHES = {"tensor=4": {"tensor": 4}, "fsdp=2 x tensor=2": {"fsdp": 2, "tensor": 2}}
TP_SP_MESH = {"seq": 2, "tensor": 2}
TP_BATCH = (2, 2048)
# 2 AdamW steps (3 before the ops phase came: the smoke's time; the first step
# holds every gradient shard, the second the update that used them).
TP_STEPS = 2
TP_LR = 1e-4
# (d): the Switch MoE layer at Switch-Base's expert width (Fedus et al. 2021,
# Table 9: d_model 768, d_ff 3072, 128 experts, capacity factor 1.25) on
# MOE_TOKENS tokens, fp32, experts over "expert" on the 4 ranks.
MOE_CFG = {"d_model": 768, "d_ff": 3072, "n_experts": 128, "capacity_factor": 1.25}
MOE_TOKENS = 8192
# JAX's TestMoE tolerances (rtol, atol), per entry: |got - want| <= atol +
# rtol |want|, for y and x's gradient (_moe_check).
MOE_TOL = (2e-4, 2e-5)


def _tp_cfg(dtype):
    import torch  # noqa: F401

    from ray_tpu_torch.models import transformer as tfm

    return tfm.llama2_7b(n_layers=2, dtype=dtype, remat_policy="hot")


def _tp_tokens(vocab: int):
    import torch

    return torch.randint(0, vocab, TP_BATCH, generator=torch.Generator().manual_seed(41)).cuda()


def _shard_diffs(got, want):
    """{leaf: |g - w| / |w|} of two {leaf: tensor} dicts."""
    return {name: ((g - want[name]).norm() / want[name].norm()).item() for name, g in got.items()}


def _check_shards(label, loss, loss_ref, got, want, launches, log, t):
    """Gates a loss and this rank's gradient shard of every leaf against the
    unsplit model's (loss 5e-5 relative, each leaf 1e-5 of its shard's
    norm, as _check_loss_grads), and refuses two planted faults: every
    shard t times too large (the row-parallel sum with psum's transpose
    upstream) and every shard moved by one entry."""
    import torch

    rtol, grad_rtol = 5e-5, 1e-5
    diffs = _shard_diffs(got, want)
    diff, worst = abs(loss - loss_ref) / abs(loss_ref), max(diffs.values())
    planted = {
        f"x{t}": max(_shard_diffs({k: g * t for k, g in got.items()}, want).values()),
        "moved": max(_shard_diffs({k: torch.roll(g.flatten(), 1).view_as(g)
                                   for k, g in got.items()}, want).values()),
    }
    log(f"{label}: loss {loss:.6f} vs {loss_ref:.6f} (rel diff {diff:.3g}, tol {rtol}); worst "
        f"leaf gradient shard |g - g_ref| / |g_ref| {worst:.3g} ({max(diffs, key=diffs.get)}; "
        f"tol {grad_rtol}); every leaf's "
        + ", ".join(f"{k} {v:.3g}" for k, v in sorted(diffs.items()))
        + f"; planted faults read {planted}; launches {launches}")
    if not (math.isfinite(loss) and diff <= rtol and worst <= grad_rtol):
        _fail(f"parallel: {label} disagrees with the unsplit model: loss {diff:.3g}, "
              f"gradients {diffs}")
    if min(planted.values()) <= grad_rtol:
        _fail(f"parallel: the {label} gradient check passes a planted fault: {planted}")


def _tp_reference(rank, n, cfg, tokens):
    """The unsplit model's TP_STEPS AdamW steps, one rank at a time (four at
    once would not fit the card beside the rest): (losses, {leaf: first
    step's gradient, on the host})."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import transformer as tfm

    for turn in range(n):
        if turn == rank:
            init, step = tfm.build_train_step(cfg, tfm.adamw(TP_LR), device="cuda")
            params, opt = init(torch.Generator(device="cuda").manual_seed(40))
            losses = [step(params, opt, tokens).item()]
            grads = {name: t.grad.cpu() for name, t in _named_leaves(params)}
            losses += [step(params, opt, tokens).item() for _ in range(TP_STEPS - 1)]
            del params, opt
            torch.cuda.empty_cache()
        dist.barrier()
    return losses, grads


def _tp_shards(params, mesh, full):
    """({leaf: this rank's gradient shard}, {leaf: the same shard of `full`})."""
    from ray_tpu_torch.parallel.sharding import local_shard, shard_slices, spec_of

    got, want = {}, {}
    for name, t in _named_leaves(params):
        got[name] = local_shard(t.grad)
        want[name] = full[name][shard_slices(tuple(t.shape), spec_of(t), mesh)].to(
            got[name].device)
    return got, want


def _par_tensor(rank, n, meshes, mesh_sp):
    """(c): llama2_7b(n_layers=2) at full width, fp32 with TF32 off, remat
    "hot", b x s = TP_BATCH. The unsplit model's TP_STEPS AdamW steps (one
    rank at a time); on each TP mesh, build_train_step on params from
    shard_tree: the first step's loss and this rank's gradient shard of every
    leaf against the unsplit model's, then the TP_STEPS steps' losses; on TP_SP_MESH,
    next_token_loss with ring and Ulysses against the same. Then in bf16 one
    forward and backward per TP mesh, with each kernel's launches. The
    embedding and the untied head keep their "tensor" split (vocab 32000
    over 4 and 2), and the loss is the vocab-parallel one. Returns
    ({path: launches}, log lines, seconds, {fp32 mesh: this rank's peak
    GiB over its TP_STEPS steps}."""
    import torch

    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.parallel import shard_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    lines, secs, launches, peaks = [], {}, {}, {}
    cfg = _tp_cfg(torch.float32)
    tokens = _tp_tokens(cfg.vocab_size)
    ref_losses, ref_grads = _tp_reference(rank, n, cfg, tokens)
    for label, mesh in meshes.items():
        t_size = dict(zip(mesh.mesh_dim_names, mesh.shape))["tensor"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        init, step = tfm.build_train_step(cfg, tfm.adamw(TP_LR), device="cuda", mesh=mesh)
        params, opt = init(torch.Generator(device="cuda").manual_seed(40))
        _zero_launch_counts()
        t0 = time.perf_counter()
        losses = [step(params, opt, tokens).item()]
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launched = _launch_counts()
        got, want = _tp_shards(params, mesh, ref_grads)
        _check_shards(f"fp32 {label}, first step", losses[0], ref_losses[0], got, want, launched,
                      lines.append, t_size)
        del got, want
        t0 = time.perf_counter()
        losses += [step(params, opt, tokens).item() for _ in range(TP_STEPS - 1)]
        torch.cuda.synchronize()
        peaks[label] = torch.cuda.max_memory_allocated() / 2**30
        secs[f"{label} first step"] = first_s
        secs[f"{label} next {TP_STEPS - 1} steps"] = time.perf_counter() - t0
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        lines.append(f"fp32 {label}: {TP_STEPS} AdamW steps' losses {losses} vs the unsplit "
                     f"model's {ref_losses} (rel diff {max(rel):.3g}, tol 5e-05)")
        if max(rel) > 5e-5:
            _fail(f"parallel: {label}'s AdamW trajectory {losses} departs from {ref_losses}")
        del params, opt
        torch.cuda.empty_cache()
    for impl in ("ring", "ulysses"):
        label = f"tensor=2 x seq=2 {impl}"
        params = shard_tree(tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(40)),
                            mesh_sp)
        for t in tfm.tree_leaves(params):
            t.requires_grad_(True)
        _zero_launch_counts()
        t0 = time.perf_counter()
        loss = tfm.next_token_loss(params, tokens, cfg.replace(attn_impl=impl), mesh_sp)
        loss.backward()
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        launches[label] = _launch_counts()
        got, want = _tp_shards(params, mesh_sp, ref_grads)
        _check_shards(f"fp32 {label}", loss.item(), ref_losses[0], got, want, launches[label],
                      lines.append, 2)
        del params, got, want, loss
        torch.cuda.empty_cache()
    del ref_grads
    bf16 = _tp_cfg(torch.bfloat16)
    for label, mesh in meshes.items():
        params = shard_tree(tfm.init_params(bf16, torch.Generator(device="cuda").manual_seed(40)),
                            mesh)
        for t in tfm.tree_leaves(params):
            t.requires_grad_(True)
        _zero_launch_counts()
        t0 = time.perf_counter()
        loss = tfm.next_token_loss(params, tokens, bf16, mesh)
        loss.backward()
        torch.cuda.synchronize()
        secs[f"bf16 {label}"] = time.perf_counter() - t0
        launches[label] = _launch_counts()
        lines.append(f"bf16 {label}, forward + backward: loss {loss.item():.6f}, launches "
                     f"{launches[label]}")
        if not math.isfinite(loss.item()):
            _fail(f"parallel: bf16 {label} loss {loss.item()}")
        del params, loss
        torch.cuda.empty_cache()
    return launches, lines, secs, peaks


def _moe_check(label, got, want, log):
    """Gates {name: result} against the unsplit layer's: y and x's gradient
    per entry at JAX's TestMoE tolerances (|got - want| <= atol + rtol
    |want|), the aux loss to 1e-6, and each param's gradient shard to 1e-5
    of its norm, as _check_shards holds the model's (a sum over 8192 tokens
    taken in four parts, where an entry that cancels to ~0 carries the fp32
    rounding of its terms). Each reading is scaled so that <= 1 passes. Two
    planted faults must be refused: every result twice too large, and every
    result moved by one entry."""
    import torch

    rtol, atol = MOE_TOL

    def readings(results):
        out = {}
        for k, g in results.items():
            if k == "aux":
                out[k] = abs(g - want[k]) / 1e-6
            elif k.startswith("dw") or k == "drouter":
                out[k] = ((g - want[k]).norm() / want[k].norm()).item() / 1e-5
            else:
                out[k] = ((g - want[k]).abs() / (atol + rtol * want[k].abs())).max().item()
        return out

    errs = readings(got)
    planted = {"x2": max(readings({k: g * 2 for k, g in got.items()}).values()),
               "moved": max(readings({k: torch.roll(g.flatten(), 1).view_as(g) if k != "aux"
                                      else g for k, g in got.items()}).values())}
    log(f"{label}: y and dx per entry |got - ref| / ({atol} + {rtol} |ref|), aux |got - ref| / "
        "1e-6, each param gradient shard |g - g_ref| / |g_ref| / 1e-5 (<= 1 passes): "
        + "; ".join(f"{k} {e:.3g}" for k, e in errs.items()) + f"; planted faults read {planted}")
    if not all(math.isfinite(e) and e <= 1 for e in errs.values()):
        _fail(f"parallel: {label} disagrees with the unsplit layer: {errs}")
    if min(planted.values()) <= 1:
        _fail(f"parallel: the {label} check passes a planted fault: {planted}")


def _moe_inputs(cfg):
    """Switch-Base's params, MOE_TOKENS tokens and the loss weights w, fp32,
    on the card from seeds."""
    import torch

    from ray_tpu_torch.models import moe

    gen = torch.Generator(device="cuda").manual_seed(31)
    x, w = (torch.randn((MOE_TOKENS, cfg.d_model), generator=gen, device="cuda")
            for _ in range(2))
    return moe.init_moe_params(cfg, torch.Generator(device="cuda").manual_seed(30)), x, w


def _moe_dropped(params, x, cfg) -> int:
    """Tokens past their expert's capacity, counted from the routing."""
    import torch

    idx = torch.argmax(x @ params["router"], dim=-1)
    cap = max(1, int(cfg.capacity_factor * x.shape[0] / cfg.n_experts))
    return int((torch.bincount(idx, minlength=cfg.n_experts) - cap).clamp_min(0).sum())


def _par_moe(rank, n, mesh):
    """(d): moe_apply at Switch-Base's width with the experts over
    "expert"=n (each rank 1/n of the tokens and of the experts) against the
    unsplit layer, run by each rank in turn: this rank's rows of y and of
    x's gradient, the aux loss, and its shard of each param's gradient, for
    sum(y * w) + aux. Returns (log lines, seconds, dropped tokens)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import moe
    from ray_tpu_torch.parallel import TRANSFORMER_RULES, shard_tree
    from ray_tpu_torch.parallel.sharding import local_shard, shard_slices, spec_of

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = moe.MoEConfig(**MOE_CFG)
    full, x, w = _moe_inputs(cfg)
    rows = slice(rank * MOE_TOKENS // n, (rank + 1) * MOE_TOKENS // n)
    params = shard_tree({"moe": full}, mesh, moe.EXPERT_RULES + TRANSFORMER_RULES)["moe"]
    want = {}
    for turn in range(n):
        if turn == rank:
            p = {k: v.clone().requires_grad_() for k, v in full.items()}
            xr = x.clone().requires_grad_()
            y, aux = moe.moe_apply(p, xr, cfg)
            ((y * w).sum() + aux).backward()
            want = {"y": y[rows].detach(), "aux": aux.item(), "dx": xr.grad[rows]}
            for k, t in params.items():
                want[f"d{k}"] = p[k].grad[shard_slices(tuple(t.shape), spec_of(t), mesh)]
            del p, xr, y
            torch.cuda.empty_cache()
        dist.barrier()
    for t in params.values():
        t.requires_grad_(True)
    xl = x[rows].clone().requires_grad_()
    secs = []
    for call in range(2):
        for t in (xl, *params.values()):
            t.grad = None
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = moe.moe_apply(params, xl, cfg, mesh=mesh)
        ((y * w[rows]).sum() + aux).backward()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    got = {"y": y.detach(), "aux": aux.item(), "dx": xl.grad,
           **{f"d{k}": local_shard(t.grad) for k, t in params.items()}}
    lines = []
    _moe_check(f"expert={n}, {MOE_TOKENS} tokens ({MOE_TOKENS // n} per rank), "
               f"{cfg.n_experts // n} of {cfg.n_experts} experts per rank", got, want, lines.append)
    return lines, secs, _moe_dropped(full, x, cfg)


def _moe_world1(mesh):
    """(a)'s MoE part: moe_apply forward and backward at Switch-Base's width
    over a mesh of one rank against mesh=None, bitwise; (seconds, dropped
    tokens)."""
    import torch

    from ray_tpu_torch.models import moe

    cfg = moe.MoEConfig(**MOE_CFG)
    full, x, w = _moe_inputs(cfg)
    out, secs = [], []
    for m in (None, mesh):
        p = {k: v.clone().requires_grad_() for k, v in full.items()}
        xr = x.clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = moe.moe_apply(p, xr, cfg, mesh=m)
        ((y * w).sum() + aux).backward()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        out.append([y, aux, xr.grad, *(p[k].grad for k in ("router", "w_up", "w_down"))])
    if not all(torch.equal(a, b) for a, b in zip(*out)) or not torch.isfinite(out[1][0]).all():
        _fail("parallel: moe_apply over a one-rank mesh differs from moe_apply without one")
    return secs[1], _moe_dropped(full, x, cfg)


def _parallel_rank(rank: int, world: int, url: str, out_path: str, tp_only: bool) -> None:
    """One rank of (b): joins the gloo group, runs _par_attention,
    _par_model, _par_tensor and _par_moe (only _par_tensor with `tp_only`),
    and writes its results as JSON to out_path."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import build_device_mesh
    from ray_tpu_torch.train import backend

    torch.cuda.set_device(0)
    backend.setup_torch_distributed(rank, world, url, backend="gloo", init_timeout_s=300)
    try:
        t0 = time.perf_counter()
        # every rank builds every mesh (and its groups) in one order, first
        mesh_seq = build_device_mesh(axis_sizes={"seq": world})
        mesh_stage = build_device_mesh(axis_sizes={"stage": world})
        tp_meshes = {label: build_device_mesh(axis_sizes=axes) for label, axes in TP_MESHES.items()}
        mesh_sp = build_device_mesh(axis_sizes=TP_SP_MESH)
        mesh_expert = build_device_mesh(axis_sizes={"expert": world})
        if tp_only:
            attention, launches, lines, secs, peak_b = {}, {}, [], {}, 0.0
        else:
            attention = _par_attention(rank, world, mesh_seq)
            torch.cuda.empty_cache()
            launches, lines, secs = _par_model(rank, world, mesh_seq, mesh_stage)
            peak_b = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        tp_launches, tp_lines, tp_secs, tp_peaks = _par_tensor(rank, world, tp_meshes, mesh_sp)
        peak_c = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        t2 = time.perf_counter()
        moe_lines, moe_secs, dropped = ([], [], 0) if tp_only else \
            _par_moe(rank, world, mesh_expert)
        result = {"attention": attention, "launches": {**launches, **tp_launches},
                  "lines": lines, "tp_lines": tp_lines, "moe_lines": moe_lines,
                  "secs": {**secs, "rank_s": time.perf_counter() - t0},
                  "tp_secs": {**tp_secs, "part_s": t2 - t1},
                  "moe": {"s": moe_secs, "part_s": time.perf_counter() - t2,
                          "dropped": dropped},
                  "tp_peak_gib": tp_peaks,
                  "peak_gib": {"b": peak_b, "c": peak_c,
                               "d": torch.cuda.max_memory_allocated() / 2**30}}
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(result, f)


def _run_ranks(world: int, tmp: str, tp_only: bool = False):
    """Starts `world` processes of this script as ranks of (b) (of (c) alone
    with `tp_only`), on the package this process imported, waits for all of
    them (any failure or the deadline stops every one) and returns their
    results."""
    url = f"file://{tmp}/rendezvous"
    extra = (["--tp-only"] if tp_only else []) + \
        (["--package-root", _PACKAGE_ROOT] if _PACKAGE_ROOT else [])
    logs = [open(f"{tmp}/rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank",
                               str(r), str(world), url, f"{tmp}/rank{r}.json", *extra],
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + PARALLEL_TIMEOUT_S
    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
            elif time.monotonic() > deadline:
                failed = f"no result within {PARALLEL_TIMEOUT_S} s"
            else:
                time.sleep(0.5)
        if failed is None and any(p.returncode != 0 for p in procs):
            failed = "a rank exited non-zero"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    if failed:
        for r in range(world):
            with open(f"{tmp}/rank{r}.log") as f:
                print(f"[parallel] rank {r} log (end):\n{f.read()[-3000:]}", flush=True)
        _fail(f"parallel: {failed}")
    results = []
    for r in range(world):
        with open(f"{tmp}/rank{r}.json") as f:
            results.append(json.load(f))
    return results


def _sum_launches(counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def phase_parallel():
    """(a) ring and Ulysses at seq=1, and the MoE, over a NCCL world of one
    rank; (b) PARALLEL_WORLD ranks sharing the card over gloo (collectives
    staged through host memory): ring and Ulysses attention at Llama-2-7B's
    width against one flash_attention call, then ring and Ulysses in the
    model and the GPipe pipeline against the unsplit model; (c) tensor
    parallelism and TP x SP (_par_tensor); (d) the MoE over expert=4
    (_par_moe). Returns the model paths' launches, summed over the ranks."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    _parallel_nccl()
    # The ranks and the smoke's second process share the card with this one.
    torch.cuda.empty_cache()
    print(f"[parallel] (a) {time.perf_counter() - t0:.1f} s; this process keeps "
          f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved while the ranks run",
          flush=True)
    n = PARALLEL_WORLD
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        results = _run_ranks(n, tmp)
    phase_s = time.perf_counter() - t0
    b, s, h, d = PAR_ATTN_SHAPE
    blocks = {"ring": n * (n + 1) // 2, "ulysses": n}
    for impl, per_call in blocks.items():
        tol = PAR_TOL[impl]
        launches = _sum_launches([r["attention"][impl]["launches"] for r in results])
        errs = {key: max(r["attention"][impl]["errs"][key] for r in results)
                for key in results[0]["attention"][impl]["errs"]}
        # each rank plants the faults in its part: the whole tensor's reading
        # is the largest over the ranks
        planted = {key: max(r["attention"][impl]["planted"][key] for r in results)
                   for key in results[0]["attention"][impl]["planted"]}
        secs = [r["attention"][impl]["s"] for r in results]
        print(f"[parallel] (b) {impl}_attention, {n} ranks over gloo, b={b} s={s} (per rank "
              f"{s // n}) h={h} d={d} bf16 causal, vs one flash_attention over the whole "
              "sequence: max |err| / (|ref| + rms(ref)) over ranks "
              + "; ".join(f"{k} {e:.3g}" for k, e in errs.items()) + f" (tol {tol}); planted "
              "faults read " + "; ".join(f"{k} {e:.3g}" for k, e in planted.items())
              + "; launches "
              f"across ranks {launches} (want {per_call} of each); seconds per rank, first and "
              f"second call, forward + backward {secs}", flush=True)
        if not all(math.isfinite(e) and e <= tol for e in errs.values()):
            _fail(f"parallel: {impl}_attention disagrees with flash_attention: {errs}")
        if min(planted.values()) <= tol:
            _fail(f"parallel: the {impl}_attention check passes a planted fault: {planted}")
        if launches != {k: per_call for k in launches}:
            _fail(f"parallel: {impl}_attention launched {launches}, want {per_call} of each")
    for r, res in enumerate(results):
        for line in res["lines"]:
            print(f"[parallel] (b) rank {r}, fp32 model: {line}", flush=True)
    for r, res in enumerate(results):
        for line in res["tp_lines"]:
            print(f"[parallel] (c) rank {r}, llama2_7b(n_layers=2) b x s {TP_BATCH}, remat hot: "
                  f"{line}", flush=True)
    for r, res in enumerate(results):
        for line in res["moe_lines"]:
            print(f"[parallel] (d) rank {r}, moe_apply {MOE_CFG} fp32: {line}", flush=True)
    paths = ("ring", "ulysses", "pipeline", *TP_MESHES, "tensor=2 x seq=2 ring",
             "tensor=2 x seq=2 ulysses")
    by_path = {path: _sum_launches([r["launches"][path] for r in results]) for path in paths}
    layers = 2
    # ring at seq=2: 1 + 2 blocks per seq group, one group per tensor rank
    sp_ring = layers * 3 * TP_SP_MESH["tensor"]
    want = {"ring": {k: layers * blocks["ring"] for k in by_path["ring"]},
            "ulysses": {k: layers * blocks["ulysses"] for k in by_path["ulysses"]},
            # one layer per stage; remat recomputes each microbatch's forward
            "pipeline": {"flash_fwd": 2 * n * PAR_MICROBATCHES,
                         "flash_bwd_dq": n * PAR_MICROBATCHES,
                         "flash_bwd_dkv": n * PAR_MICROBATCHES},
            # "hot" keeps the flash output: one launch of each per layer per rank
            **{label: {k: layers * n for k in by_path[label]} for label in TP_MESHES},
            "tensor=2 x seq=2 ring": {k: sp_ring for k in by_path["ring"]},
            "tensor=2 x seq=2 ulysses": {k: layers * n for k in by_path["ring"]}}
    print(f"[parallel] (b)-(c) model paths' launches across ranks {by_path}", flush=True)
    print(f"[parallel] (c) fp32 TP peak memory per rank GiB (torch.cuda.max_memory_allocated, "
          f"each mesh's {TP_STEPS} steps; the embedding, the head and the logits split over "
          f"'tensor'): " + "; ".join(
              f"{label} {[round(r['tp_peak_gib'][label], 3) for r in results]}"
              for label in TP_MESHES), flush=True)
    if by_path != want:
        _fail(f"parallel: model launches {by_path}, want {want}")
    print(f"[parallel] (d) tokens dropped by the capacity: {results[0]['moe']['dropped']} of "
          f"{MOE_TOKENS}; seconds per rank, first and second call, forward + backward "
          f"{[[round(x, 3) for x in r['moe']['s']] for r in results]}", flush=True)
    print(f"[parallel] (b)-(d) {n} processes sharing one {_smi()} over gloo (not multi-GPU "
          f"speed): peak memory per rank GiB "
          f"{[{k: round(v, 3) for k, v in r['peak_gib'].items()} for r in results]}; seconds "
          f"per rank (b) {[{k: round(v, 1) for k, v in r['secs'].items()} for r in results]}, "
          f"(c) {[{k: round(v, 1) for k, v in r['tp_secs'].items()} for r in results]}, "
          f"(d) {[round(r['moe']['part_s'], 1) for r in results]}; phase {phase_s:.1f} s",
          flush=True)
    return by_path


def phase_tp_memory():
    """Part (c) of the parallel phase alone (--tp-memory): PARALLEL_WORLD gloo
    ranks sharing the card run _par_tensor, gates included, on the package
    this process imported (--package-root names another commit's), and
    each rank's peak memory per fp32 TP mesh is printed. Compare two
    versions within one call to the card: its power limit can differ
    between calls."""
    import tempfile

    import ray_tpu_torch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        results = _run_ranks(PARALLEL_WORLD, tmp, tp_only=True)
    where = os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
    for r, res in enumerate(results):
        for line in res["tp_lines"]:
            print(f"[tp_memory] (c) rank {r}: {line}", flush=True)
    print(f"[tp_memory] {_smi()}, ray_tpu_torch from {where}: fp32 TP peak memory per rank "
          f"GiB (torch.cuda.max_memory_allocated, each mesh's {TP_STEPS} steps): " + "; ".join(
              f"{label} {[round(r['tp_peak_gib'][label], 3) for r in results]}"
              for label in TP_MESHES)
          + f"; (c) seconds per rank {[round(r['tp_secs']['part_s'], 1) for r in results]}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------------------------------ cluster

CLUSTER_TENSOR = (4096, 11008)  # Llama-2-7B's w_up
CLUSTER_SERVE_SHAPE = (1, 1024, 32, 128)  # b, s, heads, head_dim: the serve phase's
CLUSTER_STEPS = 4
# 2 steps (3 before the ops phase came: the smoke's time; the trajectory
# and ZeRO-1's bitwise check still span an update).
CLUSTER_DATA_STEPS = 2
# Parts (c) of the cluster phase and (b) of the elastic phase: Llama-2-7B's
# width in fp32 at depth 1 (cut from 2 in PR 13 for the smoke's time: the
# fp32 gloo steps, their reference and ZeRO were the cluster phase's most).
CLUSTER_DATA_LAYERS = 1
CLUSTER_HOST_CALLS = 1000
CLUSTER_TIMEOUT_S = 300


def _cluster_gpu_task():
    """What a num_gpus=1 task sees from inside its worker process, and
    whether torch calls its fork bad (a fork after CUDA was initialised in
    the parent)."""
    import torch

    return (os.environ.get("CUDA_VISIBLE_DEVICES"), torch.cuda.device_count(),
            torch.cuda.get_device_name(0), os.getpid(), os.getppid(),
            torch.cuda._is_in_bad_fork())


def _compute_app_pids():
    """The pids nvidia-smi lists as the card's compute processes (in a
    container whose pid namespace nvidia-smi cannot see into, not ours)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return [int(p) for p in out.split()]


def _nvidia_fds(pid: int) -> int:
    """How many of a process's open files are NVIDIA device nodes: a CUDA
    context holds /dev/nvidiactl, /dev/nvidia<N> and /dev/nvidia-uvm open."""
    n = 0
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            n += os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia")
        except OSError:
            pass
    return n


class _Barrier:
    """Releases its callers once `n` have arrived (max_concurrency >= n)."""

    def __init__(self, n: int):
        import threading

        self.n, self.count, self.cv = n, 0, threading.Condition()

    def arrive(self) -> bool:
        with self.cv:
            self.count += 1
            self.cv.notify_all()
            return self.cv.wait_for(lambda: self.count >= self.n, timeout=120)


def _cluster_half_gpu_task(barrier):
    """A num_gpus=0.5 task: meets the other one at the barrier, so both hold
    their share at once; returns the device ids it sees."""
    import ray_tpu_torch as rt

    met = rt.get(barrier.arrive.remote(), timeout=150)
    return os.environ.get("CUDA_VISIBLE_DEVICES"), met, os.getpid()


def _cluster_echo(x):
    """Returns the tensor it was given, with where it arrived."""
    return x, str(x.device), str(x.dtype)


def _cluster_noop():
    return None


def _cluster_node_echo(x):
    """Part (d)'s GPU task: the tensor it was given, where it arrived, and
    the node and pid it ran in."""
    import ray_tpu_torch as rt

    return x, str(x.device), rt.get_runtime_context().get_node_id(), os.getpid()


CLUSTER_STREAM_RECORDS = 32  # (d1): serve-shape (q, k, v) records per transport
CLUSTER_STREAM_SAMPLE = (0, 15, 31)  # (d1): records whose K1 output is held against plain
CLUSTER_STREAM_CAPACITY = 128 << 20  # (d1): the ring; a 24 MiB record fits in half
CLUSTER_STREAM_ITEMS = 8  # (d2): K1 outputs a streaming task yields


def _cluster_serve_qkv(seed: int, index: int):
    """Serve-shape bf16 q, k, v on the card from a (seed, index) pair."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed * 1000 + index)
    return tuple(torch.randn(CLUSTER_SERVE_SHAPE, generator=gen, device="cuda")
                 .to(torch.bfloat16) for _ in range(3))


def _qkv_digest(qkv) -> int:
    """A sum over the bit patterns of q, k and v, on the card."""
    import torch

    return sum(int(t.view(torch.int16).sum(dtype=torch.int64)) for t in qkv)


class _StreamReaderActor:
    """(d1): hosts channel readers on its node and runs K1 on each record."""

    def warm(self):
        """One K1 call before the measured runs: the kernel library's load and
        the first dispatch stay out of the transports' time."""
        import torch

        from ray_tpu_torch.ops import flash_attention as fa

        fa.flash_attention(*_cluster_serve_qkv(0, 0), causal=True)
        torch.cuda.synchronize()

    def open(self, capacity):
        import tempfile

        from ray_tpu_torch.core.channel import ChannelReader

        self.reader = ChannelReader(tempfile.mkdtemp(prefix="chip-smoke-chan-"),
                                    capacity=capacity)
        return self.reader.spec()

    def consume(self, n, sample):
        import torch

        from ray_tpu_torch.ops import flash_attention as fa

        _zero_launch_counts()
        worst, digests, devices = 0.0, [], set()
        for i in range(n):
            rec = self.reader.read(timeout=CLUSTER_TIMEOUT_S)
            q, k, v = rec["qkv"]
            devices.add(str(q.device))
            o = fa.flash_attention(q, k, v, causal=True)
            if rec["i"] in sample:
                o_ref, _ = fa.reference_flash_fwd(q, k, v, causal=True,
                                                  scale=q.shape[-1] ** -0.5)
                worst = max(worst, entry_err(o, o_ref))
            digests.append((rec["i"], _qkv_digest((q, k, v))))
        torch.cuda.synchronize()
        self.reader.close()
        return {"launches": _launch_counts(), "worst": worst, "digests": digests,
                "devices": sorted(devices), "pid": os.getpid()}


def _cluster_stream_gen(n: int, seed: int):
    """(d2): K1's output for n serve-shape inputs, one item each, with the
    K1 launches of this process so far."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    _zero_launch_counts()
    for i in range(n):
        o = fa.flash_attention(*_cluster_serve_qkv(seed, i), causal=True)
        torch.cuda.synchronize()
        yield o, _launch_counts()["flash_fwd"]


def _cluster_stream_all(n: int, seed: int):
    """(d2)'s non-streaming twin: the same outputs in one return."""
    return [o for o, _ in _cluster_stream_gen(n, seed)]


def _cluster_channel(rt, joined_id, smi):
    """(d1): the channel's TCP stream, then its ring, into a K1 actor on the
    joined node; returns the actor's K1 launches over both."""
    import torch

    from ray_tpu_torch.core.channel import ChannelSpec, ChannelWriter

    records = [_cluster_serve_qkv(7, i) for i in range(CLUSTER_STREAM_RECORDS)]
    want = [(i, _qkv_digest(r)) for i, r in enumerate(records)]
    nbytes = sum(t.numel() * t.element_size() for r in records for t in r)
    actor = rt.remote(num_gpus=1)(_StreamReaderActor).remote()
    rows, launches, ok = [], {}, True
    try:
        rt.get(actor.warm.remote(), timeout=CLUSTER_TIMEOUT_S)
        for transport in ("stream", "ring"):
            spec = rt.get(actor.open.remote(CLUSTER_STREAM_CAPACITY), timeout=CLUSTER_TIMEOUT_S)
            if transport == "stream":  # a writer on another host: the ring is not here
                spec = ChannelSpec(spec.name, spec.ring_path + ".on-another-host",
                                   spec.uds_path, spec.tcp_addr, spec.capacity)
            done = actor.consume.remote(CLUSTER_STREAM_RECORDS, CLUSTER_STREAM_SAMPLE)
            writer = ChannelWriter(spec)
            took = "stream" if writer._stream is not None else "ring"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i, qkv in enumerate(records):
                writer.write({"i": i, "qkv": qkv}, timeout=CLUSTER_TIMEOUT_S)
            write_s = time.perf_counter() - t0
            res = rt.get(done, timeout=CLUSTER_TIMEOUT_S)
            total_s = time.perf_counter() - t0
            writer.close()
            for name, n in res["launches"].items():
                launches[name] = launches.get(name, 0) + n
            same = res["digests"] == want
            ok = ok and (took == transport and same and res["devices"] == ["cuda:0"]
                         and res["launches"]["flash_fwd"] == CLUSTER_STREAM_RECORDS
                         and res["worst"] <= FWD_TOL["bfloat16"][0])
            rows.append(f"{transport} (taken: {took}) {nbytes / total_s / 1e6:.1f} MB/s "
                        f"({total_s:.3f} s to the last K1, writes {write_s:.3f} s), records equal "
                        f"{same}, on {res['devices']} in pid {res['pid']}, K1 "
                        f"{res['launches']['flash_fwd']} launches, sampled worst "
                        f"{res['worst']:.6f}")
    finally:
        rt.kill(actor)
    print(f"[cluster] (d1) {smi}: {CLUSTER_STREAM_RECORDS} records of bf16 (q, k, v) "
          f"{CLUSTER_SERVE_SHAPE} ({nbytes / 2 ** 20:.0f} MiB) staged from CUDA tensors here "
          f"into a num_gpus=1 actor on the joined node: {'; '.join(rows)}", flush=True)
    if not ok:
        _fail("cluster: (d1) the channel's records or K1 on the joined node were wrong, or "
              "the writer did not take the transport it was given")
    return launches


def _cluster_client_stream(rt, smi):
    """(d2): a streaming GPU task on the joined node, iterated by this remote
    client; returns its K1 launches."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    n, seed = CLUSTER_STREAM_ITEMS, 11
    gen = rt.remote(num_gpus=1, num_returns="streaming")(_cluster_stream_gen)
    t0 = time.perf_counter()
    it = iter(gen.remote(n, seed))
    items, counts = [], []
    for ref in it:
        o, count = rt.get(ref, timeout=CLUSTER_TIMEOUT_S)
        items.append(o)
        counts.append(count)
        if len(items) == 1:
            first_s = time.perf_counter() - t0
    all_s = time.perf_counter() - t0
    whole = rt.get(rt.remote(num_gpus=1)(_cluster_stream_all).remote(n, seed),
                   timeout=CLUSTER_TIMEOUT_S)
    same = len(items) == len(whole) == n and all(
        torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(items, whole))
    q, k, v = _cluster_serve_qkv(seed, 0)
    o_ref, _ = fa.reference_flash_fwd(q, k, v, causal=True, scale=q.shape[-1] ** -0.5)
    err = entry_err(items[0], o_ref)
    print(f"[cluster] (d2) {smi}: a num_returns='streaming' num_gpus=1 task on the joined node "
          f"yielded {len(items)} K1 outputs {CLUSTER_SERVE_SHAPE} to this remote client: first "
          f"item {first_s:.3f} s after the call, then {(all_s - first_s) / max(1, n - 1):.3f} s "
          f"per item; each bitwise equal to the non-streaming return {same}; item 0 on "
          f"{items[0].device} within {err:.6f} per entry of the plain version here; the task's "
          f"K1 launches {counts}", flush=True)
    if not same or counts != list(range(1, n + 1)) or not err <= FWD_TOL["bfloat16"][0]:
        _fail("cluster: (d2) the remote client's stream differs from the task's return, or K1 "
              "missed on the joined node")
    return {"flash_fwd": counts[-1], "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def _cluster_tcp(smi):
    """Part (d): a head that other hosts can join, on tcp://127.0.0.1:0 with
    an auth token, and a worker node joined through start_worker_node with
    only that address (its own session dir and pool; the GPU is on it, none
    on the head). This process is a remote client (init(address=)): the
    86 MiB bf16 tensor goes through its put, a num_gpus=1 task on the joined
    node and its get, bitwise; a connection without the token is refused.
    No process and no pool of either node may outlive the shutdown."""
    import glob
    import secrets

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.cluster_runtime import Cluster, start_worker_node
    from ray_tpu_torch.core.rpc import RpcClient

    os.environ["RAY_TPU_AUTH_TOKEN"] = secrets.token_hex(16)
    joined = head = None
    try:
        t0 = time.perf_counter()
        head = Cluster(num_gpus=0, head_port=0)
        head_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        joined = start_worker_node(head.gcs_tcp_address)
        join_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rt.init(address=head.gcs_tcp_address)
        attach_s = time.perf_counter() - t0
        try:
            gen = torch.Generator(device="cuda").manual_seed(0)
            w_up = torch.randn(CLUSTER_TENSOR, generator=gen, device="cuda").to(torch.bfloat16)
            task = rt.remote(num_gpus=1)(_cluster_node_echo)
            rounds, same = [], True
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = rt.put(w_up)
                put_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                back_ref = task.remote(ref)
                back, where, node, pid = rt.get(back_ref, timeout=CLUSTER_TIMEOUT_S)
                torch.cuda.synchronize()
                trip_s = time.perf_counter() - t0
                same = same and where == "cuda:0" and node == joined["node_id"] and torch.equal(
                    back.view(torch.int16), w_up.view(torch.int16))
                rounds.append(f"put {put_s:.3f} s, through the task on node {node[:8]} (pid "
                              f"{pid}, arrived on {where}) and get {trip_s:.3f} s")
                del ref, back_ref, back
            token = os.environ["RAY_TPU_AUTH_TOKEN"]
            os.environ["RAY_TPU_AUTH_TOKEN"] = "not-the-token"
            try:
                RpcClient(head.gcs_tcp_address, connect_timeout=5.0).call("ping", timeout=5.0)
                refused = False
            except (ConnectionError, OSError):
                refused = True
            finally:
                os.environ["RAY_TPU_AUTH_TOKEN"] = token
            del w_up
            launches = {"cluster tcp stream reader actor (d1)":
                        _cluster_channel(rt, joined["node_id"], smi),
                        "cluster tcp client stream task (d2)": _cluster_client_stream(rt, smi)}
        finally:
            rt.shutdown()
    finally:
        t0 = time.perf_counter()
        if joined is not None:
            joined["shutdown"]()
        if head is not None:
            head.shutdown()
        down_s = time.perf_counter() - t0
        os.environ.pop("RAY_TPU_AUTH_TOKEN", None)
    left = [p for d in (head.session_dir, joined["session_dir"]) for p in _cluster_processes(d)]
    pools = [p for d in (head.session_dir, joined["session_dir"])
             for p in glob.glob(f"/dev/shm/rtpt_{os.path.basename(d)}*")]
    print(f"[cluster] (d) {smi}: a head on {head.gcs_tcp_address} with a token in "
          f"{head_s:.2f} s, a worker node joined over TCP in {join_s:.2f} s, this process "
          f"attached as a remote client in {attach_s:.2f} s; bf16 {CLUSTER_TENSOR} first / "
          f"second: {' / '.join(rounds)}; bitwise on the joined node's GPU and back {same}; "
          f"a connection without the token refused {refused}; shutdown {down_s:.2f} s, "
          f"processes left {left}, pools left {sorted(pools)}", flush=True)
    if not same:
        _fail("cluster: over TCP the tensor did not come back bitwise from the joined node")
    if not refused:
        _fail("cluster: the head's TCP port served a connection without the token")
    if left or pools:
        _fail("cluster: processes or pools of the TCP cluster outlived its shutdown")
    return launches


class _FlashActor:
    """An actor in a worker process that runs flash_attention at the serve
    shape and holds K1 against its plain version."""

    def ping(self):
        return None

    def check(self, shape):
        import torch

        from ray_tpu_torch.ops import flash_attention as fa

        b, s, h, d = shape
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        _zero_launch_counts()
        o = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        launches = _launch_counts()
        o_ref, _ = fa.reference_flash_fwd(q, k, v, causal=True, scale=d ** -0.5)
        return {"err": entry_err(o, o_ref), "max_abs": (o.float() - o_ref.float()).abs().max().item(),
                "launches": launches, "pid": os.getpid(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


def _cluster_loop(config):
    """Part (b)'s loop: the fit phase's model and batches, deterministic, on
    this worker's current CUDA device; one report per step, then a last one
    with the losses, report times, params_sha256 and kernel launches."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import transformer as tfm

    torch.use_deterministic_algorithms(True)
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = _fit_cfg()
    init, step = tfm.build_train_step(cfg, tfm.adamw(config["lr"]), device=device)
    params, opt = init(torch.Generator(device=device).manual_seed(0))
    _zero_launch_counts()
    losses, times = [], []
    for i in range(config["steps"]):
        loss = step(params, opt, _fit_batch(i, cfg.vocab_size)).item()
        losses.append(loss)
        times.append(time.perf_counter())
        train.report({"step": i, "loss": loss})
    train.report({"step": config["steps"], "losses": losses, "report_t": times,
                  "launches": _launch_counts(), "params_sha256": _params_sha256(params),
                  "pid": os.getpid(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                  "backend": (torch.distributed.get_backend()
                              if torch.distributed.is_initialized() else None)})


def _cluster_data_cfg():
    import torch

    from ray_tpu_torch.models import transformer as tfm

    return tfm.llama2_7b(n_layers=CLUSTER_DATA_LAYERS, dtype=torch.float32,
                         remat_policy="hot")


def _cluster_data_batch(step: int, vocab: int):
    """Step i's global batch of part (c): 2 rows, seeded 2i and 2i + 1."""
    import torch

    return torch.cat([_fit_batch(2 * step + r, vocab) for r in range(2)])


def _host_leaves(params):
    """Every leaf's local tensor (the whole leaf under a data-only mesh),
    copied to the host, in convert.flatten's order."""
    from ray_tpu_torch.models.convert import flatten
    from ray_tpu_torch.parallel.sharding import local_shard

    return [local_shard(t).detach().cpu() for t in flatten(params)[1]]


def _leaf_rel_diffs(got, want):
    """||got - want|| / ||want|| for each leaf."""
    return [((g.double() - w.double()).norm() / w.double().norm().clamp_min(1e-30)).item()
            for g, w in zip(got, want)]


def _cluster_data_loop(config):
    """Part (c)'s loop, one rank of a gloo world sharing the card: fp32 with
    TF32 off, deterministic; CLUSTER_DATA_STEPS AdamW steps of the plain
    data-parallel step on the global batch, then as many of ZeRO-1 over
    "data" on this rank's row from
    the same init. Rank 0 saves the plain run's final params to
    config["out"]. Reports losses, launches, peak memory, and how far the
    ZeRO run's params are from the plain run's."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import transformer as tfm

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = train.get_mesh()
    rank = train.get_context().get_world_rank()
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = _cluster_data_cfg()
    out = {"rank": rank, "pid": os.getpid(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "backend": torch.distributed.get_backend(), "mesh": str(mesh)}
    leaves = {}
    for mode in ("plain", "zero"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        kw = {"zero_axis": "data"} if mode == "zero" else {}
        init, step = tfm.build_train_step(cfg, tfm.adamw(config["lr"]), device=device,
                                          mesh=mesh, **kw)
        params, opt = init(torch.Generator(device=device).manual_seed(0))
        _zero_launch_counts()
        losses = []
        t0 = time.perf_counter()
        for i in range(config["steps"]):
            batch = _cluster_data_batch(i, cfg.vocab_size)
            losses.append(step(params, opt, batch[rank:rank + 1] if mode == "zero" else batch)
                          .item())
        out[mode] = {"losses": losses, "launches": _launch_counts(),
                     "s": time.perf_counter() - t0,
                     "peak_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30}
        leaves[mode] = _host_leaves(params)
        del params, opt, init, step
    if rank == 0:
        torch.save(leaves["plain"], config["out"])
    diffs = _leaf_rel_diffs(leaves["zero"], leaves["plain"])
    worst = max(range(len(diffs)), key=diffs.__getitem__)
    out["zero_bitwise"] = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                              for a, b in zip(leaves["zero"], leaves["plain"]))
    out["zero_worst"] = (worst, diffs[worst])
    train.report(out)


def _cluster_reference_data(n_steps: int = CLUSTER_DATA_STEPS):
    """Part (c)'s reference: one fp32 process (this one) on the same global
    batches, `n_steps` AdamW steps of part (c)'s config: losses, final params
    on the host and their key paths."""
    import torch

    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.models.convert import flatten

    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = _cluster_data_cfg()
        init, step = tfm.build_train_step(cfg, tfm.adamw(1e-4), device="cuda")
        params, opt = init(torch.Generator(device="cuda").manual_seed(0))
        losses = [step(params, opt, _cluster_data_batch(i, cfg.vocab_size)).item()
                  for i in range(n_steps)]
        leaves = _host_leaves(params)
        paths = flatten(params)[0]
        del params, opt
        torch.cuda.empty_cache()
        return losses, leaves, paths
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def _report_p50(metrics) -> float:
    import statistics

    t = metrics["report_t"]
    return statistics.median((t[i] - t[i - 1]) * 1e3 for i in range(1, len(t)))


# The runtime's instruments that the raylet, the GCS, the store and the log GC
# record (utils/internal_metrics.py); `status` and `top` read some of them.
RUNTIME_INSTRUMENTS = (
    "raytpu_sched_queue_depth", "raytpu_sched_dispatch_latency_ms", "raytpu_worker_pool_idle",
    "raytpu_worker_pool_busy", "raytpu_worker_pool_leased", "raytpu_raylet_gcs_sync_total",
    "raytpu_raylet_gcs_sync_batch", "raytpu_tasks_retried_total", "raytpu_actor_restarts_total",
    "raytpu_store_puts_total", "raytpu_logs_evicted_total")
# The scheduler's and worker pool's: every node that ran a task reports these.
NODE_INSTRUMENTS = RUNTIME_INSTRUMENTS[:5]


def _instruments_by_node(records):
    """{node id: {instrument: value}} of RUNTIME_INSTRUMENTS, a histogram as
    "n=<count> sum=<sum>", "-" where the node reported none; series of one
    node and name add up."""
    out = {}
    for m in records:
        if m["name"] not in RUNTIME_INSTRUMENTS:
            continue
        node = out.setdefault(m["tags"].get("node_id", "?"), {})
        if m.get("kind") == "histogram":
            n, total = node.get(m["name"], (0, 0.0))
            node[m["name"]] = (n + sum(m.get("counts") or []), total + float(m["value"] or 0.0))
        else:
            node[m["name"]] = node.get(m["name"], 0.0) + float(m["value"] or 0.0)
    return {nid: {k: ("-" if k not in vals else f"n={vals[k][0]} sum={vals[k][1]:.3f}"
                      if isinstance(vals[k], tuple) else vals[k]) for k in RUNTIME_INSTRUMENTS}
            for nid, vals in out.items()}


def _cluster_processes(session_dir):
    """pids of the processes of one cluster: its GCS, raylets and workers,
    each of which names a socket in the session dir on its command line."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if "ray_tpu_torch.core." in cmd and session_dir in cmd:
            out.append(int(pid))
    return out


def phase_cluster():
    """The cluster runtime on the card (init() with no arguments: a GCS, a
    raylet and worker processes). (a) the GPU manager's resources, a
    num_gpus=1 task's CUDA_VISIBLE_DEVICES and device name, two num_gpus=0.5
    tasks held at once by a barrier actor on one device id, a bf16 CUDA
    tensor of Llama-2-7B's w_up shape through put, a GPU task and get
    (bitwise), flash_attention at the serve shape in an actor's process
    against its plain version, and host rates of no-op tasks and actor
    calls; (b) TorchTrainer with one worker process over NCCL, the fit
    phase's model, 4 steps, bitwise equal to the in-process TorchTrainer and
    to build_train_step driven directly, K1/K2/K3 8 / 8 / 8 in the worker;
    (c) two worker processes sharing the card over gloo, MeshSpec(data=2),
    fp32, 2 AdamW steps against one fp32 process, then ZeRO-1 over "data"
    against the plain two-rank run. Every process of the cluster and every
    /dev/shm/rtpt_* file must be gone after its shutdown. Returns the
    launches of each path."""
    import glob
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.train import (RunConfig, ScalingConfig, TorchBackendConfig,
                                     TorchTrainer)
    from ray_tpu_torch.core.runtime_base import current_runtime
    from ray_tpu_torch.parallel.mesh import MeshSpec

    phase_t0 = time.perf_counter()
    smi = _smi()
    name = torch.cuda.get_device_name(0)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-cluster-")
    launches = {}
    try:
        # References, in this process: build_train_step driven directly and
        # the in-process TorchTrainer (part b), and one fp32 process (part c).
        cfg = {"lr": 1e-4, "steps": CLUSTER_STEPS}
        with _deterministic():
            direct_losses, direct_ms, direct_sha = _direct_run(1e-4, CLUSTER_STEPS)
            rt.init(local_mode=True)
            try:
                local = TorchTrainer(
                    _cluster_loop, train_loop_config=cfg,
                    scaling_config=ScalingConfig(num_workers=1, resources_per_worker={"GPU": 1}),
                    run_config=RunConfig(name="cluster_local", storage_path=tmp)).fit()
            finally:
                rt.shutdown()
            ref_losses, ref_leaves, _ = _cluster_reference_data()
        if local.error is not None:
            _fail(f"cluster: the in-process trainer failed: {local.error!r}")
        torch.cuda.empty_cache()

        # Workers inherit the driver's environment: cuBLAS's workspace
        # setting makes their deterministic algorithms usable.
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        t0 = time.perf_counter()
        rt.init()
        boot_s = time.perf_counter() - t0
        runtime = current_runtime()
        session_dir = runtime._cluster.session_dir
        # This cluster's pools and its driver's lock file.
        ours = f"/dev/shm/rtpt_{os.path.basename(session_dir)}"
        try:
            res = rt.cluster_resources()
            # The raylet boots its zygote (an interpreter that imports the
            # worker stack and torch) beside init(): the first launch forks
            # a parked child once it is up.
            deadline = time.monotonic() + CLUSTER_TIMEOUT_S
            while not ((pool := runtime._raylet.call("debug_state")["pool"])["zygote_alive"]
                       and pool["preforked"] >= 1):
                if time.monotonic() > deadline:
                    _fail(f"cluster: the zygote never parked a child: {pool}")
                time.sleep(0.01)
            ready_s = time.perf_counter() - t0
            zygote = pool["zygote_pid"]
            print(f"[cluster] {smi}: init() {boot_s:.2f} s, the zygote up with "
                  f"{pool['preforked']} children parked {ready_s:.2f} s after init() began; "
                  f"cluster_resources {res}", flush=True)
            if res.get("GPU") != 1.0:
                _fail(f"cluster: cluster_resources()['GPU'] is {res.get('GPU')}, want 1.0")

            # (a) device leases
            gpu_task = rt.remote(num_gpus=1)(_cluster_gpu_task)
            t0 = time.perf_counter()
            visible, count, dev_name, pid, ppid, bad_fork = rt.get(gpu_task.remote(),
                                                                    timeout=CLUSTER_TIMEOUT_S)
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            rt.get(gpu_task.remote(), timeout=CLUSTER_TIMEOUT_S)
            again_s = time.perf_counter() - t0
            pool = runtime._raylet.call("debug_state")["pool"]
            zstats = runtime._raylet.call("zygote_stats")
            apps = _compute_app_pids()
            fds = {"zygote": _nvidia_fds(zygote), "task's worker": _nvidia_fds(pid)}
            print(f"[cluster] (a) num_gpus=1 task in pid {pid}, forked by the zygote (pid "
                  f"{zygote}, the task's parent {ppid}; driver {os.getpid()}): "
                  f"CUDA_VISIBLE_DEVICES={visible!r}, {count} device(s), {dev_name}, bad fork "
                  f"{bad_fork}; {first_s:.3f} s on a parked child (its CUDA context; PR 10 "
                  f"took 5.59 s to Popen one), {again_s * 1e3:.1f} ms again; pool hits "
                  f"{pool['hits']}, misses {pool['misses']}; the card's compute processes "
                  f"{apps}, the zygote among them {zygote in apps}, CUDA initialised in the "
                  f"zygote {zstats.get('cuda_initialized')}, open /dev/nvidia* files {fds}",
                  flush=True)
            if visible != "0" or count != 1 or dev_name != name or pid == os.getpid():
                _fail("cluster: the num_gpus=1 task does not see exactly device 0")
            if ppid != zygote or bad_fork or pool["hits"]["prefork"] < 1:
                _fail("cluster: the num_gpus=1 task's worker is not a zygote child in a good fork")
            if zygote in apps or zstats.get("cuda_initialized") is not False \
                    or fds["zygote"] or not fds["task's worker"]:
                _fail("cluster: the zygote holds a CUDA context (or the check cannot see one)")
            barrier = rt.remote(max_concurrency=2)(_Barrier).remote(2)
            half = rt.remote(num_gpus=0.5)(_cluster_half_gpu_task)
            t0 = time.perf_counter()
            halves = rt.get([half.remote(barrier), half.remote(barrier)],
                            timeout=CLUSTER_TIMEOUT_S)
            print(f"[cluster] (a) two num_gpus=0.5 tasks held together by a barrier actor: "
                  f"{halves} in {time.perf_counter() - t0:.2f} s", flush=True)
            if [h[:2] for h in halves] != [("0", True), ("0", True)] \
                    or halves[0][2] == halves[1][2]:
                _fail("cluster: the two half-GPU tasks did not share device 0 at once")
            rt.kill(barrier)

            # (a) a bf16 CUDA tensor through the object store, twice: the
            # first put touches fresh pool pages, the first GPU task that
            # gets a tensor imports torch in its worker.
            gen = torch.Generator(device="cuda").manual_seed(0)
            w_up = torch.randn(CLUSTER_TENSOR, generator=gen, device="cuda").to(torch.bfloat16)
            nbytes = w_up.numel() * w_up.element_size()
            echo = rt.remote(num_gpus=1)(_cluster_echo)
            same, rounds = True, []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = rt.put(w_up)
                put_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                got = rt.get(ref)
                torch.cuda.synchronize()
                get_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                back, where, dtype = rt.get(echo.remote(ref), timeout=CLUSTER_TIMEOUT_S)
                torch.cuda.synchronize()
                trip_s = time.perf_counter() - t0
                same = same and back.device.type == "cuda" and where == "cuda:0" and all(
                    torch.equal(x.view(torch.int16), w_up.view(torch.int16)) for x in (got, back))
                rounds.append(f"put {put_s:.4f} s ({nbytes / put_s / 1e9:.2f} GB/s), get "
                              f"{get_s:.4f} s ({nbytes / get_s / 1e9:.2f} GB/s), into a GPU task "
                              f"(arrived on {where}, {dtype}) and back {trip_s:.4f} s")
                del ref, got, back
            print(f"[cluster] (a) bf16 {CLUSTER_TENSOR} ({nbytes / 2**20:.1f} MiB) on the card, "
                  f"first / second: {' / '.join(rounds)}; bitwise equal on the card {same}",
                  flush=True)
            if not same:
                _fail("cluster: the bf16 CUDA tensor did not come back bitwise equal on the card")
            del w_up

            # (a) K1 in an actor's process
            actor = rt.remote(num_gpus=1)(_FlashActor).remote()
            chk = rt.get(actor.check.remote(CLUSTER_SERVE_SHAPE), timeout=CLUSTER_TIMEOUT_S)
            tol = FWD_TOL["bfloat16"][0]
            print(f"[cluster] (a) flash_attention in an actor (pid {chk['pid']}, "
                  f"CUDA_VISIBLE_DEVICES={chk['visible']!r}) at b, s, h, d "
                  f"{CLUSTER_SERVE_SHAPE} bf16 causal: max |err| / (|ref| + rms(ref)) "
                  f"{chk['err']:.3g} (max abs {chk['max_abs']:.3g}; tol {tol:.3g}), launches "
                  f"{chk['launches']}", flush=True)
            want = {"flash_fwd": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
            if not (math.isfinite(chk["err"]) and chk["err"] <= tol) or chk["launches"] != want:
                _fail("cluster: flash_attention in the actor's process failed its check")
            launches["cluster actor"] = chk["launches"]
            rt.kill(actor)

            # (a) host rates
            noop = rt.remote(_cluster_noop)
            rt.get([noop.remote() for _ in range(10)], timeout=CLUSTER_TIMEOUT_S)
            t0 = time.perf_counter()
            rt.get([noop.remote() for _ in range(CLUSTER_HOST_CALLS)], timeout=CLUSTER_TIMEOUT_S)
            task_rate = CLUSTER_HOST_CALLS / (time.perf_counter() - t0)
            pinger = rt.remote(_FlashActor).remote()
            rt.get(pinger.ping.remote(), timeout=CLUSTER_TIMEOUT_S)
            t0 = time.perf_counter()
            rt.get([pinger.ping.remote() for _ in range(CLUSTER_HOST_CALLS)],
                   timeout=CLUSTER_TIMEOUT_S)
            actor_rate = CLUSTER_HOST_CALLS / (time.perf_counter() - t0)
            t0 = time.perf_counter()
            for _ in range(200):
                rt.get(pinger.ping.remote(), timeout=CLUSTER_TIMEOUT_S)
            call_ms = (time.perf_counter() - t0) / 200 * 1e3
            rt.kill(pinger)
            print(f"[cluster] (a) host, {os.cpu_count()} cores: {CLUSTER_HOST_CALLS} no-op tasks "
                  f"at {task_rate:.0f}/s, {CLUSTER_HOST_CALLS} calls to one actor at "
                  f"{actor_rate:.0f}/s, one call and its get in turn {call_ms:.3f} ms",
                  flush=True)

            # (a) the runtime's instruments, flushed once a second; another
            # commit's package (--package-root) may record none, so it is
            # read once and not gated
            from ray_tpu_torch.utils import state

            head = runtime._cluster.head_node_id
            t0 = time.perf_counter()
            deadline = time.monotonic() + 15
            while True:
                by_node = _instruments_by_node(state.internal_metrics())
                mine = by_node.get(head, {})
                missing = [k for k in NODE_INSTRUMENTS if mine.get(k, "-") == "-"]
                if not missing or _PACKAGE_ROOT or time.monotonic() > deadline:
                    break
                time.sleep(0.25)
            print(f"[cluster] (a) runtime instruments by node after the K1 tasks and the host "
                  f"rates (the head {head[:12]}; read in {time.perf_counter() - t0:.2f} s): "
                  f"{ {nid[:12]: vals for nid, vals in sorted(by_node.items())} }", flush=True)
            if missing and not _PACKAGE_ROOT:
                _fail(f"cluster: the head node, which ran the tasks, reports no {missing}")

            # (b) TorchTrainer, one worker process over NCCL
            t0 = time.perf_counter()
            nccl = TorchTrainer(
                _cluster_loop, train_loop_config=cfg,
                scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                             backend=TorchBackendConfig(backend="nccl")),
                run_config=RunConfig(name="cluster_nccl", storage_path=tmp)).fit()
            fit_s = time.perf_counter() - t0
            if nccl.error is not None:
                _fail(f"cluster: the NCCL trainer failed: {nccl.error!r}")
            m, lm = nccl.metrics, local.metrics
            print(f"[cluster] (b) {smi}: TorchTrainer, 1 worker process (pid {m['pid']}, "
                  f"CUDA_VISIBLE_DEVICES={m['visible']!r}, {m['backend']}), llama2_7b width, 2 "
                  f"layers, bf16, remat hot, b=1 s={FIT_SEQ}, deterministic: fit {fit_s:.1f} s; "
                  f"losses {m['losses']}, in-process trainer {lm['losses']}, direct "
                  f"{direct_losses}; params_sha256 equal {m['params_sha256'] == direct_sha} / "
                  f"{lm['params_sha256'] == direct_sha}; step p50 report to report "
                  f"{_report_p50(m):.2f} ms (in-process trainer {_report_p50(lm):.2f} ms, direct "
                  f"step p50 {sorted(direct_ms[1:])[len(direct_ms[1:]) // 2]:.2f} ms); launches "
                  f"in the worker {m['launches']}", flush=True)
            if m["backend"] != "nccl" or m["pid"] == os.getpid():
                _fail("cluster: the trainer's worker is not a process on NCCL")
            if not (m["losses"] == lm["losses"] == direct_losses
                    and m["params_sha256"] == lm["params_sha256"] == direct_sha):
                _fail("cluster: the NCCL worker's run is not bitwise the in-process one's")
            want = {k: 2 * CLUSTER_STEPS for k in m["launches"]}
            if m["launches"] != want:
                _fail(f"cluster: the worker launched {m['launches']}, want {want}")
            launches["cluster trainer nccl"] = m["launches"]

            # (c) two worker processes sharing the card over gloo
            out = os.path.join(tmp, "rank0_params.pt")
            t0 = time.perf_counter()
            gloo = TorchTrainer(
                _cluster_data_loop,
                train_loop_config={"lr": 1e-4, "steps": CLUSTER_DATA_STEPS, "out": out},
                scaling_config=ScalingConfig(num_workers=2, use_gpu=True,
                                             resources_per_worker={"GPU": 0.5},
                                             mesh=MeshSpec(data=2),
                                             backend=TorchBackendConfig(backend="gloo")),
                run_config=RunConfig(name="cluster_gloo", storage_path=tmp)).fit()
            fit_s = time.perf_counter() - t0
            if gloo.error is not None:
                _fail(f"cluster: the gloo trainer failed: {gloo.error!r}")
            g = gloo.metrics
            got = torch.load(out)
            diffs = _leaf_rel_diffs(got, ref_leaves)
            first = abs(g["plain"]["losses"][0] - ref_losses[0]) / abs(ref_losses[0])
            traj = max(abs(a - b) / abs(b) for a, b in zip(g["plain"]["losses"], ref_losses))
            zl = max(abs(a - b) / abs(b) for a, b in zip(g["zero"]["losses"],
                                                         g["plain"]["losses"]))
            print(f"[cluster] (c) {smi}: 2 worker processes sharing the card over "
                  f"{g['backend']} (not multi-GPU speed), each CUDA_VISIBLE_DEVICES="
                  f"{g['visible']!r}, MeshSpec(data=2), llama2_7b width, "
                  f"{CLUSTER_DATA_LAYERS} layer(s), fp32, TF32 "
                  f"off, global batch 2 x {FIT_SEQ}, {CLUSTER_DATA_STEPS} AdamW steps: fit "
                  f"{fit_s:.1f} s; losses {g['plain']['losses']} vs one process {ref_losses}: "
                  f"first rel {first:.3g} (tol 1e-6), trajectory rel {traj:.3g} (tol 1e-5); "
                  f"final params, worst leaf ||d|| / ||ref|| {max(diffs):.3g} (tol 1e-5)",
                  flush=True)
            print(f"[cluster] (c) ZeRO-1 over data, each rank its row: losses "
                  f"{g['zero']['losses']} (rel to the plain run {zl:.3g}); params bitwise equal "
                  f"to the plain run's {g['zero_bitwise']} (worst leaf {g['zero_worst']}); "
                  f"rank 0 peak memory GiB plain {g['plain']['peak_gib']:.3f} ZeRO "
                  f"{g['zero']['peak_gib']:.3f}; seconds plain {g['plain']['s']:.1f} ZeRO "
                  f"{g['zero']['s']:.1f}; launches rank 0 plain {g['plain']['launches']} ZeRO "
                  f"{g['zero']['launches']}", flush=True)
            if not (first <= 1e-6 and traj <= 1e-5 and max(diffs) <= 1e-5):
                _fail("cluster: the two-rank gloo run is not within its tolerance of one process")
            if not (g["zero_bitwise"] or g["zero_worst"][1] <= 1e-6):
                _fail(f"cluster: ZeRO-1 differs from the plain run: {g['zero_worst']}")
            for mode in ("plain", "zero"):
                want = {k: CLUSTER_DATA_LAYERS * CLUSTER_DATA_STEPS for k in g[mode]["launches"]}
                if g[mode]["launches"] != want:
                    _fail(f"cluster: rank 0's {mode} run launched {g[mode]['launches']}, "
                          f"want {want}")
                launches[f"cluster gloo data=2 {mode} (rank 0)"] = g[mode]["launches"]
        finally:
            t0 = time.perf_counter()
            rt.shutdown()
            down_s = time.perf_counter() - t0
        left = _cluster_processes(session_dir)
        pools = glob.glob(ours + "*")
        print(f"[cluster] shutdown {down_s:.2f} s; processes left {left}, pools left "
              f"{sorted(pools)}", flush=True)
        if left or pools:
            _fail("cluster: processes or /dev/shm/rtpt_* pools outlived shutdown")
        launches.update(_cluster_tcp(smi))
        print(f"[cluster] phase {time.perf_counter() - phase_t0:.1f} s", flush=True)
        return launches
    finally:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        shutil.rmtree(tmp, ignore_errors=True)


# The elastic phase: node drain and preemption on the cluster runtime.
ELASTIC_STEPS = 8  # (a): steps of the preempted and restored run
ELASTIC_EVERY = 2  # (a): a checkpoint every 2 steps, and one more on a drain
ELASTIC_DEADLINE_S = 20.0  # (a): notice to the node's death; a final checkpoint fits
# (b): world 2 for 2 steps, 1 for 2, then 2 again, a checkpoint after each
# step but the last. fp32 data parallelism drifts from one process by its sums'
# order, ~1.5e-6 of a leaf's norm per AdamW step (PR 12's 10-step run read
# 1.51e-5): 5 steps keep it inside part (c)'s 1e-5.
ELASTIC_DATA_STEPS = 5
ELASTIC_DATA_DEADLINE_S = 30.0
ELASTIC_WAIT_S = 3.0  # (b): capacity_wait_s, then the gang downsizes
ELASTIC_SERVE_DEADLINE_S = 60.0  # (c)
ELASTIC_TIMEOUT_S = 300


def _worker_device():
    """A worker's card: its current CUDA device (the one its lease shows)."""
    import torch

    return torch.device("cuda", torch.cuda.current_device())


def _local_tree(params, opt):
    """The params' tree with each leaf replaced by the tensor the step's
    optimizer updates (a DTensor's local shard, the whole leaf under a
    data-only mesh; a plain leaf itself), which build_train_step hands the
    optimizer in the tree's own key order."""
    storage = iter([p for g in opt.param_groups for p in g["params"]])

    def rebuild(tree):
        return {k: rebuild(v) for k, v in tree.items()} if isinstance(tree, dict) \
            else next(storage)

    return rebuild(params)


def _restore_state(path, local, opt):
    """Loads an elastic checkpoint's params and AdamW state into `local`
    (the step's own tensors) and `opt`; returns (its step, its meta)."""
    import torch

    from ray_tpu_torch.models import convert
    from ray_tpu_torch.train import elastic_checkpoint as ec

    state = ec.load_state(path)
    with torch.no_grad():
        for p, src in zip(convert.flatten(local)[1], convert.flatten(state["params"])[1]):
            p.copy_(src)
    convert.opt_state_from_numpy(state["opt_state"], opt, local)
    return state["step"], state["meta"]


def _save_state(scratch, local, opt, step, record):
    """An elastic checkpoint of params and AdamW state, the run's record in
    its meta, in a new directory under `scratch`."""
    import tempfile

    from ray_tpu_torch.models import convert
    from ray_tpu_torch.train import elastic_checkpoint as ec

    d = tempfile.mkdtemp(prefix="elastic-", dir=scratch)
    ec.save_state(d, local, convert.opt_state_to_torch(opt, local), step=step,
                  meta={"record": record})
    return d


def _drop_copied(sources, step):
    """Deletes the loop's own checkpoint directories that the trainer has
    copied: report() returns once its payload is queued and the trainer
    copies a checkpoint after taking it off the size-1 queue, so only the
    report two steps later proves that copy done."""
    import shutil

    for s in [s for s in sources if s <= step - 2]:
        shutil.rmtree(sources.pop(s))


def _elastic_loop(config):
    """Part (a)'s loop, as a user writes it for preemptible capacity: the
    fit phase's model and batches, deterministic, on this worker's card; an
    elastic checkpoint every ELASTIC_EVERY steps, and when
    train.drain_requested() one more and a return; restored from
    train.get_checkpoint(). The checkpoint's meta carries the run's record
    (each step's loss; each attempt's pid, node, launches, restore seconds
    and wall times), and the last report all of it with params_sha256."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.models import transformer as tfm

    torch.use_deterministic_algorithms(True)
    device = _worker_device()
    cfg = _fit_cfg()
    init, step = tfm.build_train_step(cfg, tfm.adamw(config["lr"]), device=device)
    params, opt = init(torch.Generator(device=device).manual_seed(0))
    attempt = {"pid": os.getpid(), "node": rt.get_runtime_context().get_node_id(),
               "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}
    record, start, ck = {"losses": [], "attempts": []}, 0, train.get_checkpoint()
    if ck is not None:
        t = time.perf_counter()
        last, meta = _restore_state(ck.path, params, opt)  # pageable copies: synchronous
        attempt["restore_s"] = time.perf_counter() - t
        attempt["restored_wall"] = time.time()
        record, start = meta["record"], last + 1
    record["attempts"].append(attempt)
    _zero_launch_counts()
    sources = {}
    for i in range(start, config["steps"]):
        loss = step(params, opt, _fit_batch(i, cfg.vocab_size)).item()
        attempt.setdefault("first_step_wall", time.time())
        record["losses"].append([i, loss])
        attempt["launches"] = _launch_counts()
        drain = train.drain_requested()
        ckpt = None
        if drain or (i % ELASTIC_EVERY == ELASTIC_EVERY - 1 and i < config["steps"] - 1):
            t = time.perf_counter()
            sources[i] = _save_state(config["scratch"], params, opt, i, record)
            attempt.setdefault("save_s", []).append(time.perf_counter() - t)
            ckpt = train.Checkpoint(sources[i])
        metrics = {"step": i, "loss": loss}
        if i == config["steps"] - 1:
            metrics.update(record=record, params_sha256=_params_sha256(params))
        train.report(metrics, checkpoint=ckpt)
        _drop_copied(sources, i)
        if drain:
            return  # the final checkpoint is reported: a clean drain


def _elastic_data_loop(config):
    """Part (b)'s loop, one rank of a gloo world on the card (world 2, then
    1, then 2): the cluster phase's fp32 data-parallel step on the global
    batch, deterministic, TF32 off. Rank 0 checkpoints after every step but
    the last and saves its final params to config["out"]. Before each step
    the ranks agree on drain_requested() (a rank that stopped alone would
    hang its peers' next gradient sum) and on a drain return: the last
    checkpoint is the final one. Every rank's last report carries the record
    (each step's loss and world; each attempt's world, pid and launches)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import transformer as tfm

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    device = _worker_device()
    cfg = _cluster_data_cfg()
    init, step = tfm.build_train_step(cfg, tfm.adamw(config["lr"]), device=device,
                                      mesh=train.get_mesh())
    params, opt = init(torch.Generator(device=device).manual_seed(0))
    local = _local_tree(params, opt)
    record, start, ck = {"losses": [], "attempts": []}, 0, train.get_checkpoint()
    if ck is not None:
        last, meta = _restore_state(ck.path, local, opt)
        record, start = meta["record"], last + 1
    attempt = {"world": world, "pid": os.getpid(), "backend": dist.get_backend()}
    record["attempts"].append(attempt)
    _zero_launch_counts()
    sources = {}
    for i in range(start, config["steps"]):
        flag = torch.tensor([float(train.drain_requested())])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if flag.item():
            return  # the checkpoint of step i - 1 is the final one
        loss = step(params, opt, _cluster_data_batch(i, cfg.vocab_size)).item()
        record["losses"].append([i, loss, world])
        attempt["launches"] = _launch_counts()
        ckpt = None
        if rank == 0 and i < config["steps"] - 1:
            sources[i] = _save_state(config["scratch"], local, opt, i, record)
            ckpt = train.Checkpoint(sources[i])
        metrics = {"step": i, "loss": loss, "world": world}
        if i == config["steps"] - 1:
            if rank == 0:
                torch.save(_host_leaves(params), config["out"])
            metrics["record"] = record
        train.report(metrics, checkpoint=ckpt)
        _drop_copied(sources, i)


def _elastic_flash_request(i):
    """Part (c)'s deployment: request `i` runs flash_attention at the serve
    shape in the replica's process on the kernel phase's inputs (seed 0)
    and holds it against its plain version; returns the error, that
    process's pid and its K1 launches so far."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    b, s, h, d = CLUSTER_SERVE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    o = fa.flash_attention(q, k, v, causal=True)
    o_ref, _ = fa.reference_flash_fwd(q, k, v, causal=True, scale=d ** -0.5)
    return {"i": i, "err": entry_err(o, o_ref), "pid": os.getpid(),
            "launches": _launch_counts(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


def _first_event(kind, since_us):
    """Wall seconds of the first `kind` event of this process's flight ring
    at or after `since_us`, or None."""
    from ray_tpu_torch.observability.flight_recorder import RECORDER

    ts = [t for t, k, _ in RECORDER.snapshot() if k == kind and t >= since_us]
    return min(ts) / 1e6 if ts else None


def _dt(later, earlier) -> float:
    """later - earlier in seconds; nan where either never happened."""
    return float("nan") if later is None or earlier is None else later - earlier


def _count(metric, **tags) -> float:
    return metric.labels(**tags).read()


def _wait_until(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            _fail(f"elastic: {what} did not happen in {timeout_s:.0f} s")
        time.sleep(0.05)


def _checkpoints(trial_dir) -> int:
    """How many checkpoints the trainer has persisted into `trial_dir` (it
    numbers them across attempts; keep-K deletes the older ones)."""
    try:
        return max((int(d.split("_")[1]) + 1 for d in os.listdir(trial_dir)
                    if d.startswith("checkpoint_")), default=0)
    except OSError:
        return 0


def _in_background(fn, *args):
    """fn(*args) in a daemon thread; the thread, and a box holding its
    value or its error."""
    import threading

    box = {}

    def run():
        try:
            box["value"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def _joined(t, box, what):
    t.join(ELASTIC_TIMEOUT_S)
    if t.is_alive():
        _fail(f"elastic: {what} did not end in {ELASTIC_TIMEOUT_S} s")
    if "error" in box:
        raise box["error"]
    return box.get("value")


def _elastic_preempt(cluster, smi, tmp, direct):
    """Part (a): a one-worker NCCL trainer on an added node, preempted after
    its second checkpoint and restored on a replacement node."""
    from ray_tpu_torch.core.cluster_runtime import _node_processes, _running
    from ray_tpu_torch.core.runtime_base import current_runtime
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig, RunConfig,
                                     ScalingConfig, TorchBackendConfig, TorchTrainer)

    direct_losses, direct_sha = direct
    gcs = current_runtime()._gcs
    first = cluster.add_node(num_gpus=1, resources={"train_slot": 1.0})
    trial_dir = os.path.join(tmp, "elastic_preempt")
    times = {}

    def orchestrate():
        _wait_until(lambda: _checkpoints(trial_dir) >= 2 or "end" in times,
                    ELASTIC_TIMEOUT_S, "(a)'s second checkpoint")
        if "end" in times:
            return
        times["notice"] = time.time()
        gcs.call("report_preemption", first, ELASTIC_DEADLINE_S, "spot preemption (smoke)")
        time.sleep(ELASTIC_DEADLINE_S)
        procs = _node_processes(cluster.session_dir, first)
        cluster.remove_node(first)
        times["removed"] = time.time()
        times["left"] = [p for p in procs if _running(p)]
        times["replacement"] = cluster.add_node(num_gpus=1, resources={"train_slot": 1.0})

    t, box = _in_background(orchestrate)
    since = time.time_ns() // 1000
    fit_t0 = time.perf_counter()
    result = TorchTrainer(
        _elastic_loop,
        train_loop_config={"lr": 1e-4, "steps": ELASTIC_STEPS, "scratch": tmp},
        scaling_config=ScalingConfig(num_workers=1, backend=TorchBackendConfig(),
                                     resources_per_worker={"GPU": 1, "train_slot": 1}),
        run_config=RunConfig(name="elastic_preempt", storage_path=tmp,
                             failure_config=FailureConfig(max_failures=0),
                             checkpoint_config=CheckpointConfig(num_to_keep=1))).fit()
    fit_s = time.perf_counter() - fit_t0
    times["end"] = True
    _joined(t, box, "(a)'s preemption")
    if result.error is not None:
        _fail(f"elastic: (a) spent its failure budget: {result.error!r}")
    m = result.metrics
    record = m["record"]
    steps = [s for s, _ in record["losses"]]
    losses = [x for _, x in record["losses"]]
    old, new = record["attempts"][0], record["attempts"][-1]
    drain_t = _first_event("train.drain", since)
    restore_t = _first_event("train.restore", since)
    notice = times.get("notice")
    gp = m["goodput_seconds"]
    print(f"[elastic] (a) {smi}: TorchTrainer, 1 NCCL worker process on an added node, "
          f"llama2_7b width, 2 layers, bf16, remat hot, b=1 s={FIT_SEQ}, deterministic, "
          f"max_failures=0, a checkpoint every {ELASTIC_EVERY} steps: fit {fit_s:.1f} s; "
          f"attempts {len(record['attempts'])} (pids {old['pid']} -> {new['pid']}, nodes "
          f"{old['node']} -> {new['node']}, replacement {times.get('replacement')}); steps "
          f"{steps}; losses equal to the direct run {losses == direct_losses}, params_sha256 "
          f"equal {m['params_sha256'] == direct_sha}; goodput {m['goodput']:.3f}, seconds "
          f"{ {k: round(v, 2) for k, v in gp.items()} }", flush=True)
    print(f"[elastic] (a) {smi}: notice -> drain seen {_dt(drain_t, notice):.2f} s, -> final "
          f"checkpoint landed and the gang stopped {_dt(restore_t, notice):.2f} s, -> node "
          f"removed {_dt(times.get('removed'), notice):.2f} s (deadline "
          f"{ELASTIC_DEADLINE_S:.0f} s), -> restore done "
          f"{_dt(new.get('restored_wall'), notice):.2f} s (load "
          f"{new.get('restore_s', float('nan')):.2f} s), -> first fresh step "
          f"{_dt(new.get('first_step_wall'), notice):.2f} s; checkpoint saves "
          f"{[round(x, 2) for a in record['attempts'] for x in a.get('save_s', [])]} s; the "
          f"removed node's processes left {times.get('left')}; launches old "
          f"{old['launches']} new {new['launches']}", flush=True)
    if len(record["attempts"]) != 2 or old["pid"] == new["pid"] \
            or new["node"] != times.get("replacement"):
        _fail("elastic: (a) was not restored once, in a new process on the replacement node")
    if steps != list(range(ELASTIC_STEPS)):
        _fail(f"elastic: (a) steps {steps}, want each of 0..{ELASTIC_STEPS - 1} once")
    if losses != direct_losses or m["params_sha256"] != direct_sha:
        _fail("elastic: (a)'s losses or params are not bitwise the uninterrupted run's")
    if gp["drain_wait"] <= 0 or times.get("left"):
        _fail("elastic: (a) no drain-wait time, or the removed node's processes outlived it")
    for a in (old, new):
        if not all(a["launches"].values()):
            _fail(f"elastic: (a) an attempt did not launch every kernel: {a['launches']}")
    cluster.remove_node(times["replacement"])
    return {"elastic (a) preempted worker": old["launches"],
            "elastic (a) restored worker": new["launches"]}


def _elastic_resize(cluster, smi, tmp, ref):
    """Part (b): two gloo ranks on two added nodes, elastic; one node is
    preempted after the first checkpoint with no replacement inside
    capacity_wait_s (world 1), and a node comes back once the first step at
    world 1 is checkpointed (world 2 again at the next checkpoint)."""
    import torch

    from ray_tpu_torch.core.runtime_base import current_runtime
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig, RunConfig,
                                     ScalingConfig, TorchBackendConfig, TorchTrainer)
    from ray_tpu_torch.utils import internal_metrics as imet

    ref_losses, ref_leaves, ref_paths = ref
    gcs = current_runtime()._gcs
    slot = {"elastic_slot": 1.0}
    nodes = [cluster.add_node(num_gpus=1, resources=slot) for _ in range(2)]
    trial_dir = os.path.join(tmp, "elastic_resize")
    down0 = _count(imet.TRAIN_ELASTIC_RESIZES, direction="downsize")
    grow0 = _count(imet.TRAIN_ELASTIC_RESIZES, direction="growback")
    times = {}

    out = os.path.join(tmp, "elastic_rank0_params.pt")
    trainer = TorchTrainer(
        _elastic_data_loop,
        train_loop_config={"lr": 1e-4, "steps": ELASTIC_DATA_STEPS, "scratch": tmp,
                           "out": out},
        scaling_config=ScalingConfig(num_workers=2, mesh=MeshSpec(data=-1),
                                     backend=TorchBackendConfig(backend="gloo"),
                                     resources_per_worker={"GPU": 0.5, **slot},
                                     elastic=True, min_workers=1,
                                     capacity_wait_s=ELASTIC_WAIT_S),
        run_config=RunConfig(name="elastic_resize", storage_path=tmp,
                             failure_config=FailureConfig(max_failures=0),
                             checkpoint_config=CheckpointConfig(num_to_keep=1)))
    def kept(index):
        """True once checkpoint `index` is registered (keep-1 deletes the one
        before it then, just before the trainer checks for a grow-back)."""
        try:
            names = set(os.listdir(trial_dir))
        except OSError:
            names = set()
        return (f"checkpoint_{index:06d}" in names
                and f"checkpoint_{index - 1:06d}" not in names) or "end" in times

    def orchestrate():
        _wait_until(lambda: _checkpoints(trial_dir) >= 1 or "end" in times,
                    ELASTIC_TIMEOUT_S, "(b)'s first checkpoint")
        if "end" in times:
            return
        times["notice"] = time.time()
        gcs.call("report_preemption", nodes[0], ELASTIC_DATA_DEADLINE_S,
                 "spot preemption (smoke)")
        # No replacement: the wait runs out and the gang downsizes. Once the
        # first step at world 1 is checkpointed a node comes back, and the
        # gang grows back at the next checkpoint, two steps at world 1 on.
        _wait_until(lambda: _count(imet.TRAIN_ELASTIC_RESIZES, direction="downsize") > down0
                    or "end" in times, ELASTIC_TIMEOUT_S, "(b)'s downsize")
        first = _checkpoints(trial_dir)  # the number of the first at world 1
        _wait_until(lambda: kept(first), ELASTIC_TIMEOUT_S,
                    "(b)'s first checkpoint at world 1")
        if "end" in times:
            return
        times["added"] = time.time()
        nodes.append(cluster.add_node(num_gpus=1, resources=slot))
        _wait_until(lambda: time.time() >= times["notice"] + ELASTIC_DATA_DEADLINE_S,
                    ELASTIC_TIMEOUT_S, "(b)'s deadline")
        cluster.remove_node(nodes[0])

    t, box = _in_background(orchestrate)
    since = time.time_ns() // 1000
    fit_t0 = time.perf_counter()
    result = trainer.fit()
    fit_s = time.perf_counter() - fit_t0
    times["end"] = True
    _joined(t, box, "(b)'s preemption")
    if result.error is not None:
        _fail(f"elastic: (b) failed: {result.error!r}")
    m = result.metrics
    record = m["record"]
    steps = [s for s, _, _ in record["losses"]]
    losses = [x for _, x, _ in record["losses"]]
    worlds = [w for _, _, w in record["losses"]]
    got = torch.load(out)
    diffs = _leaf_rel_diffs(got, ref_leaves)
    first = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])
    traj = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    downs = _count(imet.TRAIN_ELASTIC_RESIZES, direction="downsize") - down0
    grows = _count(imet.TRAIN_ELASTIC_RESIZES, direction="growback") - grow0
    notice = times.get("notice")
    grow_t = _first_event("train.elastic_growback", since)
    down_t = _first_event("train.elastic_downsize", since)
    drain_t = _first_event("train.drain", since)
    gp = m["goodput_seconds"]
    worst = max(range(len(diffs)), key=diffs.__getitem__)
    print(f"[elastic] (b) {smi}: 2 gloo ranks sharing the card on 2 added nodes, elastic "
          f"(min_workers 1, capacity_wait_s {ELASTIC_WAIT_S:.0f}), llama2_7b width, 1 layer, "
          f"fp32, TF32 off, MeshSpec(data=-1), global batch 2 x {FIT_SEQ}: fit {fit_s:.1f} s; "
          f"worlds by step {worlds}; attempts "
          f"{[(a['world'], a['pid']) for a in record['attempts']]}; resizes downsize {downs} "
          f"growback {grows}; goodput {m['goodput']:.3f}, seconds "
          f"{ {k: round(v, 2) for k, v in gp.items()} }", flush=True)
    print(f"[elastic] (b) {smi}: losses {losses} vs one process {ref_losses}: first rel "
          f"{first:.3g} (tol 1e-6), trajectory rel {traj:.3g} (tol 1e-5); final params, worst "
          f"leaf ||d|| / ||ref|| {diffs[worst]:.3g} ({'/'.join(ref_paths[worst])}; tol 1e-5); "
          f"notice -> drain seen "
          f"{_dt(drain_t, notice):.2f} s, -> downsize {_dt(down_t, notice):.2f} s, downsize -> "
          f"node added {_dt(times.get('added'), down_t):.2f} s, downsize -> growback "
          f"{_dt(grow_t, down_t):.2f} s; launches by attempt "
          f"{[(a['world'], a['launches']) for a in record['attempts']]}", flush=True)
    first_one, last_one = worlds.index(1) if 1 in worlds else -1, \
        len(worlds) - 1 - worlds[::-1].index(1) if 1 in worlds else -1
    if steps != list(range(ELASTIC_DATA_STEPS)) or worlds[0] != 2 or worlds[-1] != 2 \
            or first_one < 0 or set(worlds[first_one:last_one + 1]) != {1}:
        _fail(f"elastic: (b) steps {steps} at worlds {worlds}, want each step once, 2..1..2")
    if (downs, grows) != (1, 1) or gp["degraded"] <= 0:
        _fail("elastic: (b) did not downsize and grow back once each with degraded time")
    if not (first <= 1e-6 and traj <= 1e-5 and max(diffs) <= 1e-5):
        _fail("elastic: (b) is not within its tolerance of one process")
    launches = {}
    for i, a in enumerate(record["attempts"]):
        if not all(a["launches"].values()):
            _fail(f"elastic: (b) an attempt at world {a['world']} did not launch every "
                  f"kernel: {a['launches']}")
        launches[f"elastic (b) attempt {i + 1} world {a['world']} (rank 0)"] = a["launches"]
    for nid in nodes[1:]:
        cluster.remove_node(nid)
    return launches


def _elastic_serve(cluster, smi):
    """Part (c): a num_gpus=0.5 deployment whose replica runs K1 on every
    request; its node gets a notice with a 60 s deadline while a client
    calls all along."""
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.runtime_base import current_runtime
    from ray_tpu_torch.serve.controller import get_or_create_controller
    from ray_tpu_torch.utils.node_events import actor_locations

    gcs = current_runtime()._gcs
    slots = [cluster.add_node(num_gpus=1, resources={"serve_slot": 1.0}) for _ in range(2)]
    app = serve.deployment(num_replicas=1, ray_actor_options={
        "num_gpus": 0.5, "resources": {"serve_slot": 1.0}})(_elastic_flash_request)
    t0 = time.perf_counter()
    handle = serve.run(app.bind(), name="elastic_flash", http_port=None)
    first = handle.remote(0).result(timeout=ELASTIC_TIMEOUT_S)
    up_s = time.perf_counter() - t0
    controller = get_or_create_controller()

    def replica_ids():
        _, replicas = rt.get(controller.get_replicas.remote("elastic_flash"), timeout=60)
        return [r._actor_id.hex() for r in replicas]

    before = replica_ids()
    victim = actor_locations(gcs)[before[0]]
    stop, answers, failures = threading.Event(), [], []

    def client():
        i = 1
        while not stop.is_set():
            try:
                r = handle.remote(i).result(timeout=60)
                answers.append((time.time(), r))
            except Exception as e:  # noqa: BLE001 - counted, and a gate
                failures.append(repr(e))
            i += 1

    caller = threading.Thread(target=client, daemon=True)
    caller.start()
    time.sleep(1.0)
    notice = time.time()
    gcs.call("report_preemption", victim, ELASTIC_SERVE_DEADLINE_S, "spot preemption (smoke)")
    _wait_until(lambda: any(r["pid"] != first["pid"] for _, r in list(answers)),
                ELASTIC_TIMEOUT_S, "(c)'s replacement serving")
    served = min(ts for ts, r in list(answers) if r["pid"] != first["pid"])
    time.sleep(1.0)
    stop.set()
    caller.join(120)
    after = replica_ids()
    where = actor_locations(gcs).get(after[0]) if after else None
    by_pid = {}
    for _, r in answers:
        by_pid[r["pid"]] = r
    tol = FWD_TOL["bfloat16"][0]
    worst = max(r["err"] for _, r in answers)
    serve.shutdown()
    print(f"[elastic] (c) {smi}: a num_gpus=0.5 deployment running flash_attention at "
          f"{CLUSTER_SERVE_SHAPE} bf16 causal per request: up {up_s:.2f} s; {len(answers)} "
          f"requests during the drain, failed {len(failures)}; notice -> new replica serving "
          f"{served - notice:.2f} s; replicas {before} -> {after}, node {victim} -> {where}; "
          f"worst per-entry error {worst:.3g} (tol {tol:.3g}); K1 launches by replica process "
          f"{ {pid: r['launches']['flash_fwd'] for pid, r in by_pid.items()} }", flush=True)
    if failures:
        _fail(f"elastic: (c) requests failed during the replica swap: {failures[:3]}")
    if after == before or where in (None, victim) or len(by_pid) != 2:
        _fail("elastic: (c) the replica was not replaced by a new actor on another node")
    if not (math.isfinite(worst) and worst <= tol):
        _fail("elastic: (c) flash_attention in a replica failed its check")
    out = {}
    for n, (pid, r) in enumerate(sorted(by_pid.items(), key=lambda kv: kv[0] != first["pid"])):
        if r["launches"]["flash_fwd"] < 1:
            _fail(f"elastic: (c) the replica in pid {pid} launched no K1")
        out[f"elastic (c) {'old' if n == 0 else 'new'} replica"] = r["launches"]
    for nid in slots:
        if nid != victim:
            cluster.remove_node(nid)
    return out


def phase_elastic():
    """Node drain and preemption on the cluster runtime (init(): a head
    leasing GPU 0, nodes added and removed with Cluster.add_node /
    remove_node, a notice through the GCS's report_preemption): (a) a
    one-worker NCCL TorchTrainer with max_failures=0 preempted after its
    second checkpoint and restored on a replacement node, bitwise equal to
    build_train_step driven directly; (b) an elastic two-rank gloo trainer
    (fp32, 1 layer) downsized to one rank when no capacity comes back within
    capacity_wait_s and grown back to two at a checkpoint once a node is
    added, within part (c) of the cluster phase's tolerance of one process;
    (c) a Serve replica on a draining node replaced on another node while a
    client calls all along. K1-K3 in every new process; no process or pool
    left. Returns the launches of each path."""
    import glob
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.runtime_base import current_runtime

    phase_t0 = time.perf_counter()
    smi = _smi()
    # Checkpoints go to memory: the card machine caps what a run writes to
    # its disk (45 GiB, freed blocks included), and this phase's 3.7 and
    # 8 GiB states, each saved by a worker and copied by the trainer, would
    # write ~80 GiB there.
    tmp = tempfile.mkdtemp(prefix="chip-smoke-elastic-",
                           dir="/dev/shm" if os.path.isdir("/dev/shm") else None)
    try:
        with _deterministic():
            direct_losses, _, direct_sha = _direct_run(1e-4, ELASTIC_STEPS)
            ref = _cluster_reference_data(ELASTIC_DATA_STEPS)
        torch.cuda.empty_cache()
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        rt.init()
        runtime = current_runtime()
        cluster = runtime._cluster
        session_dir = cluster.session_dir
        ours = f"/dev/shm/rtpt_{os.path.basename(session_dir)}"
        launches = {}
        try:
            t0 = time.perf_counter()
            launches.update(_elastic_preempt(cluster, smi, tmp, (direct_losses, direct_sha)))
            a_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            launches.update(_elastic_resize(cluster, smi, tmp, ref))
            b_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            launches.update(_elastic_serve(cluster, smi))
            c_s = time.perf_counter() - t0
        finally:
            rt.shutdown()
        left = _cluster_processes(session_dir)
        pools = glob.glob(ours + "*")
        print(f"[elastic] parts (a) {a_s:.1f} s, (b) {b_s:.1f} s, (c) {c_s:.1f} s; processes "
              f"left {left}, pools left {sorted(pools)}; phase "
              f"{time.perf_counter() - phase_t0:.1f} s", flush=True)
        if left or pools:
            _fail("elastic: processes or /dev/shm/rtpt_* pools outlived shutdown")
        return launches
    finally:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------- objects
OBJ_POOL = 2 << 30  # the phase's object store per node
# Layers put in (a): 2.43 GB, 1.13x the pool (16 before the ops phase came,
# 12 before the observe phase, 8 before the operate phase: the smoke's time;
# 6 still spill, past the raylet's 0.8 threshold).
OBJ_LAYERS = 6
# One Llama-2-7B block's seven weight matrices (Meta's published config:
# d_model 4096, d_ff 11008), bf16: 202.4 M params, 404.8 MB.
OBJ_LAYER_SHAPES = {"wq": (4096, 4096), "wk": (4096, 4096), "wv": (4096, 4096),
                    "wo": (4096, 4096), "w_gate": (4096, 11008), "w_up": (4096, 11008),
                    "w_down": (11008, 4096)}
OBJ_GRAD_SHAPE = (4096, 11008)  # (c): w_up's gradient, fp32, 180.4 MB
OBJ_DAG_RUNS = 4  # (d): executions of the compiled DAG, x from seeds 0-3
OBJ_K1_TOL = 2 ** -6  # K1's per-entry bound at the serve shape (the kernel phase's)
OBJ_TIMEOUT_S = 300


def _obj_layer(seed: int):
    """One Llama-2-7B layer's weights as a dict of bf16 CUDA tensors."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {k: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            for k, shape in OBJ_LAYER_SHAPES.items()}


def _tensor_sha(tree) -> str:
    """sha256 over a tensor's (or a dict of tensors', by key) raw bytes."""
    import hashlib

    import torch

    h = hashlib.sha256()
    items = sorted(tree.items()) if isinstance(tree, dict) else [("", tree)]
    for _, t in items:
        t = t.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def _layers_equal(a, b) -> bool:
    import torch

    return a.keys() == b.keys() and all(
        a[k].device == b[k].device and torch.equal(a[k].view(torch.int16), b[k].view(torch.int16))
        for k in a)


def _obj_spilled_sha(layer):
    """(a)'s GPU task: the spilled layer it was given, on its card."""
    import torch

    return _tensor_sha(layer), str(layer["wq"].device), torch.cuda.device_count()


class _ObjGetter:
    """(b)'s actor on an added node: gets a layer onto its card."""

    def node(self):
        import ray_tpu_torch as rt

        return rt.get_runtime_context().get_node_id()

    def get_layer(self, refs):
        import torch

        import ray_tpu_torch as rt

        t0 = time.perf_counter()
        layer = rt.get(refs[0], timeout=OBJ_TIMEOUT_S)
        torch.cuda.synchronize()
        return {"s": time.perf_counter() - t0, "sha": _tensor_sha(layer),
                "device": str(layer["wq"].device)}


class _ObjRank:
    """(c)'s group member: w_up's gradient size in fp32 from seed = rank."""

    def __init__(self, rank: int):
        self.rank = rank

    def run(self, group: str):
        import numpy as np
        import torch

        from ray_tpu_torch import collective

        gen = torch.Generator(device="cuda").manual_seed(self.rank)
        grad = torch.randn(OBJ_GRAD_SHAPE, generator=gen, device="cuda")
        small = torch.randn(1024, generator=gen, device="cuda")
        bf = torch.randn(4096, generator=gen, device="cuda").to(torch.bfloat16)
        collective.barrier(group_name=group)
        t0 = time.perf_counter()
        summed = collective.allreduce(grad, group_name=group)
        ar_s = time.perf_counter() - t0
        shard = collective.reduce_scatter(grad, group_name=group)
        want_shard = np.array_split(summed.reshape(-1), 3)[(self.rank + 1) % 3]
        bcast = collective.broadcast(grad, src_rank=0, group_name=group)
        gathered = collective.allgather(small, group_name=group)
        bf_gathered = collective.allgather(bf, group_name=group)
        return {"allreduce": summed, "allreduce_s": ar_s, "device": str(grad.device),
                "rs_equal": bool(np.array_equal(shard, want_shard)),
                "bcast_sha": _tensor_sha(torch.from_numpy(bcast)),
                "gathered": gathered, "bf_gathered": bf_gathered,
                "dtypes": [str(summed.dtype), str(bf_gathered[0].dtype)]}


class _ObjAttend:
    """(d)'s actor: Llama-2-7B's wq, wk, wv from its seed; attend(x)
    projects with torch.matmul and runs K1 (causal), holding each output
    against the plain version in this process."""

    def __init__(self, seed: int):
        import torch

        gen = torch.Generator(device="cuda").manual_seed(seed)
        self.w = [torch.randn((4096, 4096), generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(3)]
        self.worst = 0.0
        _zero_launch_counts()

    def attend(self, x):
        from ray_tpu_torch.ops import flash_attention as fa

        b, s, h, d = CLUSTER_SERVE_SHAPE
        q, k, v = (x.matmul(w).view(b, s, h, d) for w in self.w)
        o = fa.flash_attention(q, k, v, causal=True)
        o_ref, _ = fa.reference_flash_fwd(q, k, v, causal=True, scale=d ** -0.5)
        self.worst = max(self.worst, entry_err(o, o_ref))
        return o.reshape(b, s, h * d)

    def report(self):
        return {"launches": _launch_counts(), "worst": self.worst, "pid": os.getpid()}


def _obj_combine(o1, o2):
    """(d)'s GPU task: the sum of the two attention outputs."""
    return o1 + o2


def _obj_reference_attend(x, seed):
    """(d)'s plain version on the driver: the actor's projections and K1's
    plain PyTorch version."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    b, s, h, d = CLUSTER_SERVE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = [torch.randn((4096, 4096), generator=gen, device="cuda").to(torch.bfloat16)
         for _ in range(3)]
    q, k, v = (x.matmul(wi).view(b, s, h, d) for wi in w)
    o_ref, _ = fa.reference_flash_fwd(q, k, v, causal=True, scale=d ** -0.5)
    return o_ref.reshape(b, s, h * d)


def _obj_x(seed: int):
    import torch

    b, s, h, d = CLUSTER_SERVE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1000 + seed)
    return torch.randn((b, s, h * d), generator=gen, device="cuda").to(torch.bfloat16)


def _obj_env_task():
    """(e)'s GPU task: what its runtime env gave it, and K1 at the serve
    shape against its plain version in this process."""
    import rtpt_objects_helper  # from the working_dir package

    _zero_launch_counts()
    out = {"probe": os.environ.get("RTPT_PROBE"),
           "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "helper": rtpt_objects_helper.VALUE, "pid": os.getpid(), "cwd": os.getcwd()}
    out.update(_elastic_flash_request(0))
    return out


def _obj_plain_task():
    """(e)'s control: a plain GPU task after the env's."""
    return {"probe": os.environ.get("RTPT_PROBE"),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "pid": os.getpid(),
            "ppid": os.getppid()}


def _obj_stats(cluster, node_id):
    from ray_tpu_torch.core.rpc import RpcClient

    return RpcClient(cluster._sock_for(node_id)).call("debug_state")["objects"]


def _wait_until_obj(pred, what, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while True:
        got = pred()
        if got:
            return got
        if time.monotonic() > deadline:
            _fail(f"objects: {what} within {timeout_s:.0f} s")
        time.sleep(0.1)


def _objects_spill(rt, runtime, cluster, smi):
    """(a): OBJ_LAYERS layers through a 2 GiB pool and back, bitwise, with a GPU
    task on a spilled one; everything gone once the refs drop."""
    import torch

    head = cluster.head_node_id
    spill_dir = os.path.join(cluster.session_dir, f"spill_{head}")
    before = _obj_stats(cluster, head)
    kept = [_obj_layer(i) for i in range(OBJ_LAYERS)]
    nbytes = sum(t.numel() * t.element_size() for layer in kept for t in layer.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refs = [rt.put(layer) for layer in kept]
    put_s = time.perf_counter() - t0
    held = _obj_stats(cluster, head)
    num_spilled = _wait_until_obj(
        lambda: runtime._gcs.call("stats")["store"]["num_spilled"], "num_spilled > 0 in the "
        "GCS's node stats while the layers are held")
    t0 = time.perf_counter()
    for i, ref in enumerate(refs):
        got = rt.get(ref, timeout=OBJ_TIMEOUT_S)
        if not _layers_equal(got, kept[i]):
            _fail(f"objects (a): layer {i} did not come back onto the card bitwise")
        del got
    torch.cuda.synchronize()
    get_s = time.perf_counter() - t0
    on_disk = set(os.listdir(spill_dir))
    spilled = [i for i, ref in enumerate(refs) if ref.hex() in on_disk]
    if not spilled:
        _fail("objects (a): no layer is spilled after reading all back")
    j = spilled[0]
    task = rt.remote(num_gpus=1)(_obj_spilled_sha)
    sha, dev, count = rt.get(task.remote(refs[j]), timeout=OBJ_TIMEOUT_S)
    if sha != _tensor_sha(kept[j]) or not dev.startswith("cuda"):
        _fail(f"objects (a): the GPU task's spilled layer {j} differs ({dev})")
    after = _obj_stats(cluster, head)
    del refs, ref, kept, task
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    _wait_until_obj(lambda: not os.listdir(spill_dir), "the spill dir empties after the refs "
                    f"drop (left: {sorted(os.listdir(spill_dir))[:4]})")
    _wait_until_obj(lambda: _obj_stats(cluster, head)["bytes_in_use"] == before["bytes_in_use"],
                    f"the pool back to {before['bytes_in_use']} bytes "
                    f"({_obj_stats(cluster, head)['bytes_in_use']})")
    spill_bytes = after["spill_bytes"] - before["spill_bytes"]
    print(f"[objects] (a) {smi}: {OBJ_LAYERS} layers of {nbytes / OBJ_LAYERS / 1e6:.1f} MB "
          f"({nbytes / 1e9:.2f} GB, {nbytes / OBJ_POOL:.2f}x the pool): put {put_s:.2f} s "
          f"({nbytes / put_s / 1e9:.2f} GB/s), get back bitwise {get_s:.2f} s "
          f"({nbytes / get_s / 1e9:.2f} GB/s); num_spilled {num_spilled} in the GCS's stats "
          f"while held ({held['num_spilled']} on the head after the puts); spills "
          f"{after['spill_total'] - before['spill_total']:.0f}, restores "
          f"{after['restore_total'] - before['restore_total']:.0f}, {spill_bytes / 1e9:.2f} GB "
          f"written to disk; a GPU task on spilled layer {j} bitwise ({dev}); spill dir "
          f"empty and the pool back to {before['bytes_in_use']} bytes after the refs drop",
          flush=True)
    return nbytes / OBJ_LAYERS


def _objects_broadcast(rt, runtime, cluster, smi, nodes, layer_bytes):
    """(b): one layer broadcast to 3 added nodes; an actor on each gets it
    with no pull; a second layer not broadcast as the control."""
    from ray_tpu_torch import NodeAffinitySchedulingStrategy

    layer, control = _obj_layer(100), _obj_layer(101)
    sha, control_sha = _tensor_sha(layer), _tensor_sha(control)
    ref, control_ref = rt.put(layer), rt.put(control)
    getters = [rt.remote(num_gpus=0.25, scheduling_strategy=NodeAffinitySchedulingStrategy(
        nid, soft=False))(_ObjGetter).remote() for nid in nodes]
    where = rt.get([g.node.remote() for g in getters], timeout=OBJ_TIMEOUT_S)
    if where != nodes:
        _fail(f"objects (b): the getters run on {where}, not on {nodes}")
    t0 = time.perf_counter()
    n = rt.broadcast(ref, timeout=OBJ_TIMEOUT_S)
    bcast_s = time.perf_counter() - t0
    locs = runtime._gcs.call("get_object_locations", ref.hex())
    if n != 3 or len(locs) != 4:
        _fail(f"objects (b): broadcast returned {n}, the GCS lists {len(locs)} locations")
    bytes_in = {nid: _obj_stats(cluster, nid)["bytes_in"] for nid in nodes}
    got = rt.get([g.get_layer.remote([ref]) for g in getters], timeout=OBJ_TIMEOUT_S)
    pulled = {nid: _obj_stats(cluster, nid)["bytes_in"] - bytes_in[nid] for nid in nodes}
    if any(g["sha"] != sha or not g["device"].startswith("cuda") for g in got):
        _fail(f"objects (b): a broadcast layer differs on an added node's card: {got}")
    if any(pulled.values()):
        _fail(f"objects (b): a node pulled after the broadcast: {pulled}")
    t0 = time.perf_counter()
    got_c = rt.get([g.get_layer.remote([control_ref]) for g in getters], timeout=OBJ_TIMEOUT_S)
    control_s = time.perf_counter() - t0
    pulled_c = {nid: _obj_stats(cluster, nid)["bytes_in"] - bytes_in[nid] for nid in nodes}
    if any(g["sha"] != control_sha for g in got_c):
        _fail("objects (b): the control layer differs on an added node's card")
    got_s = ", ".join(f"{g['s']:.3f}" for g in got)
    control_each = ", ".join(f"{g['s']:.3f}" for g in got_c)
    print(f"[objects] (b) {smi}: broadcast of one layer ({layer_bytes / 1e6:.1f} MB) to 3 "
          f"added nodes {bcast_s:.2f} s, returned {n}, {len(locs)} locations; each node's "
          f"actor got it onto its card bitwise in {got_s} s with 0 bytes pulled; the control "
          f"layer (not broadcast): {control_each} s per actor, {control_s:.2f} s for all 3, "
          f"bytes pulled {sorted(pulled_c.values())}", flush=True)
    for g in getters:
        rt.kill(g)


def _objects_collective(rt, runtime, smi):
    """(c): three GPU actors in a ring group: allreduce against a float64
    sum, reduce_scatter, broadcast and allgather bitwise, the bf16 rule;
    destroyed with no GCS key left."""
    import numpy as np
    import torch

    from ray_tpu_torch import collective

    ranks = [rt.remote(num_gpus=0.25)(_ObjRank).remote(i) for i in range(3)]
    collective.create_collective_group(ranks, "objects")
    outs = rt.get([r.run.remote("objects") for r in ranks], timeout=OBJ_TIMEOUT_S)
    grads, smalls, bfs = [], [], []
    for i in range(3):
        gen = torch.Generator(device="cuda").manual_seed(i)
        grads.append(torch.randn(OBJ_GRAD_SHAPE, generator=gen, device="cuda"))
        smalls.append(torch.randn(1024, generator=gen, device="cuda").cpu().numpy())
        bfs.append(torch.randn(4096, generator=gen, device="cuda").to(torch.bfloat16))
    want = (grads[0].double() + grads[1].double() + grads[2].double()).cpu().numpy()
    scale = np.abs(want).max()
    errs = [float(np.abs(o["allreduce"].astype(np.float64) - want).max() / scale) for o in outs]
    if max(errs) > 1e-6:
        _fail(f"objects (c): allreduce off the float64 sum by {max(errs):.3g} of its max")
    sha0 = _tensor_sha(grads[0])
    for o in outs:
        if not o["rs_equal"] or o["bcast_sha"] != sha0 or not o["device"].startswith("cuda"):
            _fail(f"objects (c): reduce_scatter {o['rs_equal']}, broadcast sha "
                  f"{o['bcast_sha'] == sha0}, device {o['device']}")
        if not all(np.array_equal(g, s) for g, s in zip(o["gathered"], smalls)):
            _fail("objects (c): allgather is not bitwise")
        if o["dtypes"] != ["float32", "float32"] or not all(
                np.array_equal(g, b.float().cpu().numpy()) for g, b in zip(o["bf_gathered"], bfs)):
            _fail(f"objects (c): the bf16 rule broke (dtypes {o['dtypes']})")
    nbytes = grads[0].numel() * 4
    ar_s = max(o["allreduce_s"] for o in outs)
    collective.destroy_collective_group_on(ranks, "objects")
    left = runtime._gcs.call("kv_keys", "__collective__/")
    if left:
        _fail(f"objects (c): GCS keys left after the destroy: {left}")
    print(f"[objects] (c) {smi}: 3 GPU actors, fp32 {OBJ_GRAD_SHAPE[0]}x{OBJ_GRAD_SHAPE[1]} "
          f"({nbytes / 1e6:.1f} MB) per rank: allreduce {ar_s:.3f} s ({nbytes / ar_s / 1e9:.3f} "
          f"GB/s of the buffer), off the float64 sum by {max(errs):.3g} of its max; "
          "reduce_scatter = the allreduce's shard, broadcast and allgather bitwise, a bf16 "
          "tensor back as float32 bitwise; no __collective__/ key left", flush=True)
    for r in ranks:
        rt.kill(r)


def _objects_dag(rt, smi):
    """(d): combine(a.attend(x), b.attend(x)) compiled and executed 4 times,
    each against the plain version on the driver; MultiOutputNode once."""
    from ray_tpu_torch.dag import InputNode, MultiOutputNode

    a, b = (rt.remote(num_gpus=0.25)(_ObjAttend).remote(seed) for seed in (7, 8))
    combine = rt.remote(num_gpus=0.25)(_obj_combine)
    with InputNode() as inp:
        dag = combine.bind(a.attend.bind(inp), b.attend.bind(inp))
    compiled = dag.compile()
    worst, times = 0.0, []
    for i in range(OBJ_DAG_RUNS):
        x = _obj_x(i)
        t0 = time.perf_counter()
        got = rt.get(compiled.execute(x), timeout=OBJ_TIMEOUT_S)
        times.append(time.perf_counter() - t0)
        ref = _obj_reference_attend(x, 7) + _obj_reference_attend(x, 8)
        if not str(got.device).startswith("cuda"):
            _fail(f"objects (d): the DAG's result arrived on {got.device}")
        worst = max(worst, entry_err(got, ref))
    reports = rt.get([a.report.remote(), b.report.remote()], timeout=OBJ_TIMEOUT_S)
    launches = [r["launches"]["flash_fwd"] for r in reports]
    if worst > OBJ_K1_TOL or launches != [OBJ_DAG_RUNS] * 2:
        _fail(f"objects (d): per entry {worst:.4g} (bound {OBJ_K1_TOL}), K1 launches {launches} "
              f"(want {OBJ_DAG_RUNS} in each actor)")
    in_actor = max(r["worst"] for r in reports)
    if in_actor > OBJ_K1_TOL:
        _fail(f"objects (d): K1 in an actor off its plain version by {in_actor:.4g}")
    with InputNode() as inp:
        multi = MultiOutputNode([a.attend.bind(inp), b.attend.bind(inp)])
    x = _obj_x(0)
    o1, o2 = rt.get(multi.execute(x), timeout=OBJ_TIMEOUT_S)
    multi_err = max(entry_err(o1, _obj_reference_attend(x, 7)),
                    entry_err(o2, _obj_reference_attend(x, 8)))
    if multi_err > OBJ_K1_TOL:
        _fail(f"objects (d): MultiOutputNode per entry {multi_err:.4g}")
    reports = rt.get([a.report.remote(), b.report.remote()], timeout=OBJ_TIMEOUT_S)
    print(f"[objects] (d) {smi}: combine(a.attend(x), b.attend(x)) compiled, {OBJ_DAG_RUNS} "
          f"runs in {', '.join(f'{t:.3f}' for t in times)} s, per entry {worst:.4g} of the "
          f"driver's plain sum (bound {OBJ_K1_TOL}); K1 {launches} in the actors' processes "
          f"(pids {[r['pid'] for r in reports]}), each within {in_actor:.4g} of its plain "
          f"version there; MultiOutputNode per entry {multi_err:.4g}", flush=True)
    out = {f"objects DAG actor {n}": {"flash_fwd": r["launches"]["flash_fwd"],
                                       "flash_bwd_dq": r["launches"]["flash_bwd_dq"],
                                       "flash_bwd_dkv": r["launches"]["flash_bwd_dkv"]}
           for n, r in zip("ab", reports)}
    rt.kill(a)
    rt.kill(b)
    return out


def _objects_runtime_env(rt, cluster, smi, tmp):
    """(e): a GPU task with env_vars and a working_dir runs K1; it Popens,
    and a plain GPU task after it still forks and sees no RTPT_PROBE."""
    from ray_tpu_torch import NodeAffinitySchedulingStrategy
    from ray_tpu_torch.core.rpc import RpcClient

    wd = os.path.join(tmp, "wd")
    os.makedirs(wd)
    with open(os.path.join(wd, "rtpt_objects_helper.py"), "w") as f:
        f.write("VALUE = 'helper-ok'\n")
    head = cluster.head_node_id
    raylet = RpcClient(cluster._sock_for(head))
    pin = NodeAffinitySchedulingStrategy(head, soft=False)
    try:
        rt.remote(runtime_env={"no_such_plugin": 1})(_obj_plain_task).remote()
        _fail("objects (e): an unknown runtime_env field was accepted")
    except ValueError as e:
        if "no plugin" not in str(e):
            _fail(f"objects (e): the unknown field's error does not say so: {e}")
    pool0 = raylet.call("debug_state")["pool"]
    env_task = rt.remote(num_gpus=0.5, scheduling_strategy=pin, runtime_env={
        "env_vars": {"RTPT_PROBE": "on"}, "working_dir": wd})(_obj_env_task)
    t0 = time.perf_counter()
    out = rt.get(env_task.remote(), timeout=OBJ_TIMEOUT_S)
    env_s = time.perf_counter() - t0
    pool1 = raylet.call("debug_state")["pool"]
    plain = rt.remote(num_gpus=0.5, scheduling_strategy=pin)(_obj_plain_task)
    t0 = time.perf_counter()
    ctl = rt.get(plain.remote(), timeout=OBJ_TIMEOUT_S)
    plain_s = time.perf_counter() - t0
    pool2 = raylet.call("debug_state")["pool"]
    forks = lambda p: p["hits"]["prefork"] + p["misses"]["zygote"]  # noqa: E731
    popens = pool1["misses"]["popen"] - pool0["misses"]["popen"]
    if (out["probe"], out["visible"], out["helper"]) != ("on", "0", "helper-ok"):
        _fail(f"objects (e): the env task saw {out}")
    if out["err"] > OBJ_K1_TOL or out["launches"]["flash_fwd"] != 1:
        _fail(f"objects (e): K1 per entry {out['err']:.4g}, launches {out['launches']}")
    if popens != 1 or forks(pool1) != forks(pool0):
        _fail(f"objects (e): the env task's spawn was not one Popen: {pool0} -> {pool1}")
    # The plain task's worker came from the zygote: a fork now, or an idle
    # worker of the same key that an earlier part forked.
    if ctl["probe"] is not None or ctl["visible"] != "0" or \
            pool2["misses"]["popen"] != pool1["misses"]["popen"] or \
            ctl["ppid"] != pool2["zygote_pid"]:
        _fail(f"objects (e): the plain task after it: {ctl}, pool {pool1} -> {pool2}")
    how = "a fresh fork" if forks(pool2) > forks(pool1) else "an idle forked worker"
    print(f"[objects] (e) {smi}: a num_gpus=0.5 task with env_vars and a working_dir: "
          f"RTPT_PROBE={out['probe']}, CUDA_VISIBLE_DEVICES={out['visible']}, helper "
          f"{out['helper']!r}, K1 per entry {out['err']:.4g} of its plain version, launches "
          f"{out['launches']['flash_fwd']}, Popen'd (popen +{popens}), first result "
          f"{env_s:.2f} s; a plain GPU task after it in {how} of the zygote, no RTPT_PROBE, "
          f"first result {plain_s:.2f} s; an unknown field refused at submission", flush=True)
    return {"objects runtime-env task": dict(out["launches"])}


def phase_objects():
    """The object plane and what rides it on the cluster runtime (a fresh
    init() with a 2 GiB pool per node, GPU 0 on every node; Llama-2-7B
    layers as dicts of bf16 CUDA tensors from seeds): (a) 6 layers (1.13x
    the pool) put and read back bitwise through spill to disk, a GPU task
    on a spilled layer, nothing left once the refs drop; (b) broadcast of a
    layer to 3 added nodes, each node's actor gets it with no pull, a layer
    not broadcast as the control; (c) a collective group of three GPU
    actors on w_up's fp32 gradient; (d) a compiled bind() DAG of two
    actors running K1 and a combining GPU task, and MultiOutputNode; (e) a
    GPU task with a runtime env (env_vars, working_dir) running K1, Popen'd,
    and a plain task after it forked. No process or pool left. Returns the
    launches of each path."""
    import glob
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.runtime_base import current_runtime

    phase_t0 = time.perf_counter()
    smi = _smi()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-objects-")
    launches = {}
    try:
        rt.init(object_store_memory=OBJ_POOL)
        runtime = current_runtime()
        cluster = runtime._cluster
        session_dir = cluster.session_dir
        ours = f"/dev/shm/rtpt_{os.path.basename(session_dir)}"
        parts = {}
        try:
            if rt.cluster_resources().get("GPU") != 1.0:
                _fail(f"objects: cluster_resources {rt.cluster_resources()}")
            t0 = time.perf_counter()
            layer_bytes = _objects_spill(rt, runtime, cluster, smi)
            parts["a"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            nodes = [cluster.add_node(num_gpus=1) for _ in range(3)]
            _objects_broadcast(rt, runtime, cluster, smi, nodes, layer_bytes)
            parts["b"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            _objects_collective(rt, runtime, smi)
            parts["c"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            launches.update(_objects_dag(rt, smi))
            parts["d"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            launches.update(_objects_runtime_env(rt, cluster, smi, tmp))
            parts["e"] = time.perf_counter() - t0
        finally:
            rt.shutdown()
        torch.cuda.empty_cache()
        left = _cluster_processes(session_dir)
        pools = glob.glob(ours + "*")
        print(f"[objects] parts {', '.join(f'({k}) {v:.1f} s' for k, v in parts.items())}; "
              f"processes left {left}, pools left {sorted(pools)}; phase "
              f"{time.perf_counter() - phase_t0:.1f} s", flush=True)
        if left or pools:
            _fail("objects: processes or /dev/shm/rtpt_* pools outlived shutdown")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)



# ---------------------------------------------------------------------- ops
OPS_ITEMS = 16  # (a): work items, (seed, request index), one K1 call each
OPS_K1_TOL = 2 ** -6  # K1's per-entry bound at the serve shape (the kernel phase's)
OPS_CHANNEL = "ops_pool_calls"  # (c): one message per item, from the actor that ran it
# (c): the pool actors' K1 ms per call (CUDA events), the histogram's buckets.
OPS_MS_BOUNDARIES = [0.03, 0.04, 0.05, 0.06, 0.07, 0.08, 0.1, 0.15, 0.25, 0.5, 1.0, 10.0,
                     100.0, 1000.0]
OPS_TIMEOUT_S = 120


def _ops_producer(q, n):
    """(a)'s task: puts n work items, (seed, request index), on the queue."""
    for i in range(n):
        q.put((2000 + i, i))
    return n


def _ops_qkv(seed: int):
    import torch

    b, s, h, d = CLUSTER_SERVE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(3)]


class _OpsAttend:
    """(b)'s pool actor (num_gpus=0.5): builds q/k/v from an item's seed on
    its card, runs K1 (causal) timed by CUDA events, holds the output against
    the plain version in this process, records a Counter and a Histogram
    with utils/metrics and publishes one message per item."""

    def __init__(self):
        _zero_launch_counts()
        self.worst = 0.0
        self.calls = 0

    def ready(self):
        """This process's CUDA context made (no kernel launched): the pool's
        map then times the calls, not the actors' start."""
        import torch

        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        return os.getpid()

    def run(self, item):
        import torch

        import ray_tpu_torch as rt
        from ray_tpu_torch.ops import flash_attention as fa
        from ray_tpu_torch.utils import metrics, pubsub

        seed, index = item
        q, k, v = _ops_qkv(seed)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        o = fa.flash_attention(q, k, v, causal=True)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        d = q.shape[-1]
        o_ref, _ = fa.reference_flash_fwd(q, k, v, causal=True, scale=d ** -0.5)
        err = entry_err(o, o_ref)
        self.worst = max(self.worst, err)
        metrics.Counter("ops_pool_calls", "K1 calls of the ops phase's pool").inc()
        metrics.Histogram("ops_pool_k1_ms", "K1 ms per call (CUDA events)",
                          boundaries=OPS_MS_BOUNDARIES).observe(ms)
        recorded = time.time()
        pubsub.publish(OPS_CHANNEL, {"pid": os.getpid(), "seq": self.calls, "index": index,
                                     "published": time.time()})
        self.calls += 1
        return {"index": index, "err": err, "ms": ms, "pid": os.getpid(),
                "task_id": rt.get_runtime_context().get_task_id(), "recorded": recorded}

    def report(self):
        return {"launches": _launch_counts(), "worst": self.worst, "pid": os.getpid(),
                "calls": self.calls}


def _hist_p50(counts, boundaries):
    """The upper bound of the bucket that holds the median."""
    half, seen = sum(counts) / 2.0, 0
    for i, n in enumerate(counts):
        seen += n
        if seen >= half:
            return boundaries[i] if i < len(boundaries) else float("inf")
    return float("nan")


def _ops_pool(rt, runtime, smi):
    """(a)-(b): the queue fed by a producer task, the pool of two GPU actors
    mapping its items through K1. Returns what (c) checks."""
    import threading

    from ray_tpu_torch.utils import ActorPool, Queue, pubsub

    # The driver's subscriber polls while the pool runs: (message, receipt).
    sub, received = pubsub.subscribe(OPS_CHANNEL), []

    def collect():
        deadline = time.monotonic() + OPS_TIMEOUT_S
        while len(received) < OPS_ITEMS and time.monotonic() < deadline:
            received.extend((m, time.time()) for m in sub.poll(timeout=1.0))

    collector = threading.Thread(target=collect, daemon=True, name="ops-subscriber")
    collector.start()
    t0 = time.perf_counter()
    q = Queue()
    producer = rt.remote(_ops_producer).remote(q, OPS_ITEMS)
    actors = [rt.remote(num_gpus=0.5)(_OpsAttend).remote() for _ in range(2)]
    rt.get([a.ready.remote() for a in actors], timeout=OPS_TIMEOUT_S)
    pool = ActorPool(actors)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    items = (q.get(timeout=OPS_TIMEOUT_S) for _ in range(OPS_ITEMS))
    results = list(pool.map(lambda a, item: a.run.remote(item), items))
    map_s = time.perf_counter() - t0
    if rt.get(producer, timeout=OPS_TIMEOUT_S) != OPS_ITEMS or not q.empty():
        _fail("ops: the producer's items did not all pass through the queue")
    reports = rt.get([a.report.remote() for a in actors], timeout=OPS_TIMEOUT_S)
    if [r["index"] for r in results] != list(range(OPS_ITEMS)):
        _fail(f"ops: the map's results out of order: {[r['index'] for r in results]}")
    pids = sorted({r["pid"] for r in results})
    per_pid = {rep["pid"]: rep for rep in reports}
    if len(pids) != 2 or set(per_pid) != set(pids) or os.getpid() in pids:
        _fail(f"ops: the pool's calls ran in {pids}, its actors are {sorted(per_pid)}")
    for rep in reports:
        if rep["launches"]["flash_fwd"] != rep["calls"] or rep["calls"] == 0:
            _fail(f"ops: K1 launched {rep['launches']} in actor pid {rep['pid']} for "
                  f"{rep['calls']} calls")
        if not rep["worst"] <= OPS_K1_TOL:
            _fail(f"ops: K1 in actor pid {rep['pid']} off its plain version by "
                  f"{rep['worst']:.4g} per entry (tol {OPS_K1_TOL})")
    print(f"[ops] (a)-(b) {smi}: a Queue fed by a producer task with {OPS_ITEMS} items, an "
          f"ActorPool of 2 num_gpus=0.5 actors (pids {pids}) mapping them through K1 at "
          f"{CLUSTER_SERVE_SHAPE} bf16 causal: map {map_s:.3f} s ({OPS_ITEMS / map_s:.1f} "
          f"items/s; the queue, the producer and both actors up, their CUDA contexts made, in "
          f"{setup_s:.2f} s before it); K1 launches by "
          f"actor {({r['pid']: r['launches']['flash_fwd'] for r in reports})}, worst "
          f"per-entry error by actor {({r['pid']: round(r['worst'], 6) for r in reports})} "
          f"(tol {OPS_K1_TOL})", flush=True)
    return {"collector": collector, "received": received, "results": results,
            "reports": reports, "pids": pids, "map_s": map_s}


def _ops_operator_view(rt, runtime, smi, pool):
    """(c): what an operator reads from the driver: the pool's user metrics,
    its messages, the runtime's catalog, the task table and the timeline."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.utils import metrics, pubsub, state

    flush_s = metrics._FLUSH_INTERVAL_S  # each actor's flusher: the counter is due in two
    results = pool["results"]
    last_record = max(r["recorded"] for r in results)

    def counted():
        found = {m["name"]: m for m in state.user_metrics()}
        calls, hist = found.get("ops_pool_calls"), found.get("ops_pool_k1_ms")
        if calls and hist and calls["value"] == OPS_ITEMS and sum(hist["counts"]) == OPS_ITEMS:
            return calls, hist
        return None

    deadline = last_record + 2 * flush_s
    got = counted()
    while got is None and time.time() < deadline:
        time.sleep(0.01)
        got = counted()
    flush_lag = time.time() - last_record
    if got is None:
        found = {m["name"]: (m["value"], m.get("counts")) for m in state.user_metrics()}
        _fail(f"ops: user_metrics did not show the counter at {OPS_ITEMS} and the histogram's "
              f"counts summing to {OPS_ITEMS} within two flush intervals: {found}")
    calls, hist = got
    hist_p50 = _hist_p50(hist["counts"], hist["boundaries"])
    ms_p50 = sorted(r["ms"] for r in results)[OPS_ITEMS // 2]
    q, k, v = _ops_qkv(2000)
    driver_ms = _time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    del q, k, v
    torch.cuda.empty_cache()

    pool["collector"].join(30)
    msgs = [m for m, _ in pool["received"]]
    t_poll = sorted(t - m["published"] for m, t in pool["received"])
    by_pid = {}
    for m in msgs:
        by_pid.setdefault(m["pid"], []).append(m["seq"])
    if (len(msgs) != OPS_ITEMS or sorted(m["index"] for m in msgs) != list(range(OPS_ITEMS))
            or any(seqs != list(range(len(seqs))) for seqs in by_pid.values())):
        _fail(f"ops: the subscription got {len(msgs)} of {OPS_ITEMS} messages, per publisher "
              f"{by_pid}")
    # Publish -> poll latency of a lone message on an idle channel.
    lone = []
    for i in range(20):
        sub = pubsub.subscribe("ops_probe")
        t0 = time.perf_counter()
        pubsub.publish("ops_probe", i)
        if sub.poll(timeout=5.0) != [i]:
            _fail("ops: a probe message did not come back")
        lone.append((time.perf_counter() - t0) * 1e3)
    lone.sort()

    internal = state.internal_metrics()
    reporters = {r for m in internal if m["name"].startswith("raytpu_")
                 for r in m.get("reporters", [])}
    raylets = sorted(r for r in reporters if r.startswith("raylet_"))
    workers = sorted(r for r in reporters
                     if not r.startswith(("raylet_", "driver-", "gcs")))
    if not raylets or not workers:
        _fail(f"ops: internal_metrics' raytpu_* records come from {sorted(reporters)}: want a "
              f"raylet and a worker process")

    ids = {r["task_id"] for r in results}
    node = runtime.node_id()

    def finished():
        recs = [t for t in state.list_tasks(limit=100_000) if t["task_id"] in ids]
        return recs if len(recs) == OPS_ITEMS and all(
            t["state"] == "FINISHED" for t in recs) else None

    deadline = time.monotonic() + 30
    recs = finished()
    while recs is None and time.monotonic() < deadline:
        time.sleep(0.1)
        recs = finished()
    if recs is None:
        _fail("ops: list_tasks() does not show the pool's calls FINISHED within 30 s")
    if any(t["node"] != node for t in recs):
        _fail(f"ops: the pool's calls ran on {sorted({t['node'] for t in recs})}, the GPU "
              f"node is {node}")
    spans = [e for e in state.timeline() if e["args"]["task_id"] in ids]
    if len(spans) != OPS_ITEMS or any(e["ph"] != "X" for e in spans):
        _fail(f"ops: the timeline holds {len(spans)} spans of the pool's {OPS_ITEMS} calls")

    calls_ms = {}
    for name, fn in (("list_nodes", state.list_nodes), ("node_summary", state.node_summary),
                     ("list_actors", state.list_actors), ("list_tasks", state.list_tasks),
                     ("list_objects", state.list_objects), ("cluster_stats", state.cluster_stats),
                     ("user_metrics", state.user_metrics),
                     ("internal_metrics", state.internal_metrics),
                     ("cluster_errors", state.cluster_errors), ("timeline", state.timeline)):
        t0 = time.perf_counter()
        fn()
        calls_ms[name] = round((time.perf_counter() - t0) * 1e3, 3)
    print(f"[ops] (c) {smi}: user_metrics: ops_pool_calls {calls['value']:.0f}, "
          f"ops_pool_k1_ms counts summing to {sum(hist['counts'])}, {flush_lag:.3f} s after the "
          f"last record (flush interval {flush_s} s); K1 ms p50 from the histogram <= "
          f"{hist_p50} (bucket bound), from the actors' events {ms_p50:.4f}, this process's "
          f"CUDA-event timing {driver_ms:.4f}; the subscription got {len(msgs)} messages, in "
          f"each publisher's order ({ {p: len(v) for p, v in by_pid.items()} }), an actor's "
          f"publish -> the driver's poll p50 {t_poll[len(t_poll) // 2] * 1e3:.2f} ms while the "
          f"pool ran, the driver's own publish + poll p50 {lone[len(lone) // 2]:.3f} ms; "
          f"internal_metrics: "
          f"{sum(m['name'].startswith('raytpu_') for m in internal)} raytpu_* series from "
          f"raylets {raylets} and workers {workers}; list_tasks: {OPS_ITEMS} calls FINISHED "
          f"on node {node[:12]}; timeline: {len(spans)} X spans; state call ms at "
          f"{len(state.list_nodes())} node(s), {len(state.list_tasks(limit=100_000))} task "
          f"records: {calls_ms}", flush=True)


def phase_ops():
    """The operator surface of the cluster runtime around K1, on a fresh
    init() that leases GPU 0: (a) a Queue fed by a producer task with 16
    (seed, request index) items; (b) an ActorPool of two num_gpus=0.5
    actors mapping them through K1 at Llama-2-7B's serve shape, each
    holding its output against the plain version in its process; (c) a
    Counter and a Histogram per call through utils/metrics, one pubsub
    message per item, and from the driver: user_metrics within two flush
    intervals, all 16 messages in each publisher's order, raytpu_* records
    of a raylet and a worker, the calls FINISHED in list_tasks and as X
    spans in the timeline; (d) no process and no pool left after shutdown.
    Returns the launches of the pool's actors."""
    import glob

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.runtime_base import current_runtime

    phase_t0 = time.perf_counter()
    smi = _smi()
    parts = {}
    rt.init()
    runtime = current_runtime()
    session_dir = runtime._cluster.session_dir
    ours = f"/dev/shm/rtpt_{os.path.basename(session_dir)}"
    try:
        if rt.cluster_resources().get("GPU") != 1.0:
            _fail(f"ops: cluster_resources {rt.cluster_resources()}")
        t0 = time.perf_counter()
        pool = _ops_pool(rt, runtime, smi)
        parts["a-b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _ops_operator_view(rt, runtime, smi, pool)
        parts["c"] = time.perf_counter() - t0
    finally:
        t0 = time.perf_counter()
        rt.shutdown()
        parts["shutdown"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    left = _cluster_processes(session_dir)
    pools = glob.glob(ours + "*")
    print(f"[ops] (d) {smi}: parts {', '.join(f'({k}) {v:.1f} s' for k, v in parts.items())}; "
          f"processes left {left}, pools left {sorted(pools)}; phase "
          f"{time.perf_counter() - phase_t0:.1f} s", flush=True)
    if left or pools:
        _fail("ops: processes or /dev/shm/rtpt_* pools outlived shutdown")
    launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for rep in pool["reports"]:
        for k, n in rep["launches"].items():
            launches[k] += n
    return {"ops pool actors": launches}


# ------------------------------------------------------------- membership
MEM_TOL = 2 ** -6  # K1's per-entry bound at the serve shape (the kernel phase's)
MEM_FIXED_SEED = 3000  # (a): the K1 call held bitwise between the zombie and its successor
MEM_HB = {"RAY_TPU_HEARTBEAT_INTERVAL_S": "0.25", "RAY_TPU_HEARTBEAT_TIMEOUT_S": "1.5",
          # (b): no snapshot after the GCS's first: what a restart finds is in the log
          "RAY_TPU_GCS_SNAPSHOT_INTERVAL_S": "3600"}
MEM_TIMEOUT_S = 120


def _mem_qkv(seed: int, index: int):
    import torch

    b, s, h, d = CLUSTER_SERVE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed * 100_003 + index)
    return [torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(3)]


class _MemAttend:
    """The membership phase's GPU actor (num_gpus=0.5): each call builds
    q/k/v from a (seed, index) pair on its card, runs K1 (causal), holds it
    against the plain version in this process and, for (a)'s audit, records
    its op id in the GCS KV."""

    def __init__(self):
        _zero_launch_counts()
        self.worst = 0.0
        self.calls = 0

    def ready(self):
        import torch

        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        return os.getpid()

    def _k1(self, seed, index):
        from ray_tpu_torch.ops import flash_attention as fa

        q, k, v = _mem_qkv(seed, index)
        o = fa.flash_attention(q, k, v, causal=True)
        o_ref, _ = fa.reference_flash_fwd(q, k, v, causal=True, scale=q.shape[-1] ** -0.5)
        self.worst = max(self.worst, entry_err(o, o_ref))
        self.calls += 1
        return o

    def run(self, op_id, seed, index):
        import uuid

        from ray_tpu_torch.core.runtime_base import current_runtime

        self._k1(seed, index)
        current_runtime()._gcs.call(
            "kv_put", f"memctr/{op_id}/{os.getpid()}-{uuid.uuid4().hex[:6]}", b"1")
        return os.getpid()

    def fixed(self):
        """K1 on the fixed seed: the sha256 of its output's bytes."""
        return _tensor_sha(self._k1(MEM_FIXED_SEED, 0)), os.getpid()

    def report(self):
        return {"launches": _launch_counts(), "worst": self.worst, "pid": os.getpid(),
                "calls": self.calls}


def _mem_gpu_task(seed):
    """(b)'s task after the restart: the device ids it sees, K1 against its
    plain version, and its wall clock at its start, with q/k/v made (the
    CUDA context), after K1 and at its end."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    stamps = [time.time()]
    _zero_launch_counts()
    q, k, v = _mem_qkv(seed, 0)
    torch.cuda.synchronize()
    stamps.append(time.time())
    o = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    stamps.append(time.time())
    o_ref, _ = fa.reference_flash_fwd(q, k, v, causal=True, scale=q.shape[-1] ** -0.5)
    err = entry_err(o, o_ref)
    stamps.append(time.time())
    return os.environ.get("CUDA_VISIBLE_DEVICES"), err, _launch_counts(), os.getpid(), stamps


def _mem_wait(pred, what, t0, timeout_s=MEM_TIMEOUT_S):
    """Seconds from t0 until pred() holds; fails the phase past the timeout."""
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            _fail(f"membership: {what} did not happen in {timeout_s:.0f} s")
        time.sleep(0.02)
    return time.perf_counter() - t0


def _mem_partition(rt, runtime, cluster, smi):
    """(a): a node holding a named K1 actor cut off from the GCS while a
    client calls the actor; death, rescheduling, the fence on heal, the card
    freed, the exactly-once audit. Returns the launches of both instances."""
    import threading
    import uuid

    from ray_tpu_torch import chaos
    from ray_tpu_torch.utils import state

    gcs = runtime._gcs
    nodes = [cluster.add_node(num_cpus=2, num_gpus=1, resources={"mem": 1.0})
             for _ in range(2)]
    cls = rt.remote(max_restarts=-1, num_gpus=0.5, resources={"mem": 0.5})(_MemAttend)
    actor = cls.options(name="mem_k1").remote()
    zombie_pid = rt.get(actor.ready.remote(), timeout=MEM_TIMEOUT_S)
    zombie_sha, _ = rt.get(actor.fixed.remote(), timeout=MEM_TIMEOUT_S)

    def actor_node():
        for a in state.list_actors():
            if a.get("name") == "mem_k1" and a["state"] == "ALIVE":
                return a.get("node_id")
        return None

    def node(nid):
        return {n["NodeID"]: n for n in gcs.call("list_nodes")}[nid]

    victim = actor_node()
    if victim not in nodes:
        _fail(f"membership: the actor runs on {victim}, not on an added node {nodes}")
    stop, acked, errored = threading.Event(), set(), set()

    def client():
        i = 0
        while not stop.is_set():
            op = uuid.uuid4().hex[:12]
            i += 1
            try:
                rt.get(actor.run.remote(op, 4000, i), timeout=20)
                acked.add(op)
            except Exception:  # noqa: BLE001 - errored: the audit allows at most one apply
                errored.add(op)
                time.sleep(0.2)
            time.sleep(0.03)

    t = threading.Thread(target=client, daemon=True, name="membership-client")
    t.start()
    _mem_wait(lambda: len(acked) >= 5, "5 acknowledged calls", time.perf_counter())
    apps_before = _compute_app_pids()
    t0 = time.perf_counter()
    part = chaos.partition([[victim], ["gcs"]], heal_after=60.0, runtime=runtime)
    dead_s = _mem_wait(lambda: not node(victim)["Alive"], "the victim declared dead", t0)
    resched_s = _mem_wait(lambda: actor_node() not in (None, victim),
                          "the actor rescheduled off the victim", t0)
    successor_node = actor_node()
    # The zombie still serves the driver over its direct channel: its
    # launches are read before the fence kills it, and its open /dev/nvidia*
    # files show the CUDA context it holds.
    zombie_rep = rt.get(actor.report.remote(), timeout=MEM_TIMEOUT_S)
    zombie_fds = _nvidia_fds(zombie_pid)
    old_epoch = node(victim)["Epoch"]
    t_heal = time.perf_counter()
    part.heal()
    fenced_s = _mem_wait(lambda: node(victim)["Alive"] and node(victim)["Epoch"] == old_epoch + 1,
                         "the victim's fenced rejoin at the next epoch", t_heal)
    gone_s = _mem_wait(lambda: not os.path.exists(f"/proc/{zombie_pid}"),
                       "the zombie's worker gone from /proc", t_heal)
    freed_s = _mem_wait(lambda: zombie_pid not in _compute_app_pids(),
                        "the zombie's pid gone from nvidia-smi's compute apps", t_heal)
    apps_after = _compute_app_pids()
    stop.set()
    t.join(60)
    successor_sha, successor_pid = rt.get(actor.fixed.remote(), timeout=MEM_TIMEOUT_S)
    successor_rep = rt.get(actor.report.remote(), timeout=MEM_TIMEOUT_S)
    victim_state = runtime._raylet_for(node(victim)["sock"]).call("debug_state")
    alive = [a for a in state.list_actors() if a.get("name") == "mem_k1" and a["state"] == "ALIVE"]

    applied = {}
    for key in gcs.call("kv_keys", "memctr/"):
        op = key[len("memctr/"):].split("/", 1)[0]
        applied[op] = applied.get(op, 0) + 1
    lost = [op for op in acked if applied.get(op, 0) == 0]
    duped = [op for op, n in applied.items() if n > 1]
    phantom = [op for op in applied if op not in acked | errored]

    def fenced_total():
        return sum(m["value"] for m in state.internal_metrics()
                   if m["name"] == "raytpu_nodes_fenced_total")

    def restarts_total():
        return sum(m["value"] for m in state.internal_metrics()
                   if m["name"] == "raytpu_actor_restarts_total")

    deadline = time.monotonic() + 15
    while (fenced_total() < 1 or restarts_total() < 1) and time.monotonic() < deadline:
        time.sleep(0.1)
    fenced, restarts = fenced_total(), restarts_total()
    reps = {"zombie": zombie_rep, "successor": successor_rep}
    print(f"[membership] (a) {smi}: named actor (num_gpus=0.5) on node {victim[:12]}, pid "
          f"{zombie_pid}; partition([[victim], ['gcs']]) at 0 s: declared dead at "
          f"{dead_s:.3f} s, rescheduled onto {str(successor_node)[:12]} at {resched_s:.3f} s; "
          f"heal: the zombie fenced and back at epoch {old_epoch + 1} after {fenced_s:.3f} s, "
          f"its worker gone from /proc after {gone_s:.3f} s and from nvidia-smi's compute apps "
          f"after {freed_s:.3f} s (compute apps before the partition {apps_before}, after "
          f"{apps_after}; the zombie listed before: {zombie_pid in apps_before}; its open "
          f"/dev/nvidia* files before the heal {zombie_fds}); the victim's "
          f"GPU pool after the rejoin {victim_state['gpu_pool']}, available GPU "
          f"{victim_state['available'].get('GPU')}; fixed-seed K1 sha256 zombie "
          f"{zombie_sha[:16]} successor (pid {successor_pid}) {successor_sha[:16]}; audit: "
          f"{len(acked)} acked, {len(errored)} errored, lost {len(lost)}, doubled "
          f"{len(duped)}, phantom {len(phantom)}; ALIVE records {len(alive)}; "
          f"raytpu_nodes_fenced_total {fenced:.0f}, raytpu_actor_restarts_total {restarts:.0f}; "
          f"K1 launches by instance "
          f"{ {k: r['launches']['flash_fwd'] for k, r in reps.items()} }, worst per-entry "
          f"error {({k: round(r['worst'], 6) for k, r in reps.items()})} (tol {MEM_TOL})",
          flush=True)
    if successor_node not in nodes or successor_node == victim or successor_pid == zombie_pid:
        _fail(f"membership: the successor runs on {successor_node} in pid {successor_pid}")
    if successor_sha != zombie_sha:
        _fail("membership: the successor's fixed-seed K1 output differs from the zombie's")
    if not zombie_fds or zombie_pid in apps_after or os.path.exists(f"/proc/{zombie_pid}"):
        _fail("membership: the zombie held no CUDA context, or its worker outlived the fence")
    if victim_state["gpu_pool"] != {"0": 1.0} or victim_state["available"].get("GPU") != 1.0:
        _fail("membership: the rejoined node did not get its GPU back")
    if lost or duped or phantom or len(alive) != 1:
        _fail(f"membership: audit lost {lost[:5]} doubled {duped[:5]} phantom {phantom[:5]}, "
              f"{len(alive)} ALIVE records")
    if not fenced >= 1:
        _fail(f"membership: raytpu_nodes_fenced_total reads {fenced}")
    if not restarts >= 1:
        _fail(f"membership: raytpu_actor_restarts_total reads {restarts} after mem_k1's restart")
    for k, r in reps.items():
        if r["launches"]["flash_fwd"] != r["calls"] or r["calls"] == 0:
            _fail(f"membership: K1 launched {r['launches']} in the {k} for {r['calls']} calls")
        if not r["worst"] <= MEM_TOL:
            _fail(f"membership: K1 in the {k} off its plain version by {r['worst']:.4g}")
    return {f"membership {k} actor": r["launches"] for k, r in reps.items()}


def _mem_restart(rt, runtime, cluster, smi):
    """(b): a GCS restart with only its write-ahead log to go on: the old
    handle, get_actor by name, the KV, the node table and a new GPU task."""
    import glob

    gcs = runtime._gcs
    actor = rt.remote(num_gpus=0.5)(_MemAttend).options(name="mem_wal").remote()
    rt.get(actor.ready.remote(), timeout=MEM_TIMEOUT_S)
    rt.get(actor.run.remote("wal-0", 5000, 0), timeout=MEM_TIMEOUT_S)
    gcs.call("kv_put", "mem-wal-key", b"survives")
    alive_before = sorted(n["NodeID"] for n in gcs.call("list_nodes") if n["Alive"])
    logs = glob.glob(os.path.join(cluster.log_dir, "raylet_*.jsonl"))  # their records
    log_bytes = sum(os.path.getsize(p) for p in logs)
    # The GCS's hot tables are in shards, a log segment each: the restart
    # replays every one.
    segments = sorted(glob.glob(cluster.gcs_snapshot + ".wal.s*"))
    seg_bytes = sum(os.path.getsize(p) for p in segments)
    t0 = time.perf_counter()
    cluster.restart_gcs()
    restart_s = time.perf_counter() - t0
    rt.get(actor.run.remote("wal-1", 5000, 1), timeout=MEM_TIMEOUT_S)
    old_handle_s = time.perf_counter() - t0
    named = rt.get_actor("mem_wal")
    rt.get(named.run.remote("wal-2", 5000, 2), timeout=MEM_TIMEOUT_S)
    kv = gcs.call("kv_get", "mem-wal-key")
    alive_s = _mem_wait(lambda: sorted(n["NodeID"] for n in gcs.call("list_nodes")
                                       if n["Alive"]) == alive_before,
                        "every node Alive after the restart", t0)
    t_submit = time.time()
    visible, err, task_launches, task_pid, stamps = rt.get(
        rt.remote(num_gpus=0.5)(_mem_gpu_task).remote(6000), timeout=MEM_TIMEOUT_S)
    task_s = time.perf_counter() - t0
    task_parts = [stamps[0] - t_submit] + [b - a for a, b in zip(stamps, stamps[1:])]
    rep = rt.get(actor.report.remote(), timeout=MEM_TIMEOUT_S)
    epochs = {n["NodeID"][:12]: n["Epoch"] for n in gcs.call("list_nodes")}
    log_growth = sum(os.path.getsize(p) for p in logs) - log_bytes
    print(f"[membership] (b) {smi}: GCS with {cluster.gcs_shards} shards killed and restarted "
          f"in {restart_s:.3f} s (snapshot interval 3600 s: the log alone, {len(segments)} shard "
          f"segments of {seg_bytes} bytes and the control segment); the old handle's K1 call back {old_handle_s:.3f} s "
          f"after the kill, get_actor('mem_wal') called, KV value {kv!r}, every node "
          f"({len(alive_before)}) Alive after {alive_s:.3f} s (epochs {epochs}), a new "
          f"num_gpus=0.5 task (pid {task_pid}, CUDA_VISIBLE_DEVICES={visible!r}) ran K1 "
          f"{task_launches['flash_fwd']} time(s) within {err:.6f} per entry (tol {MEM_TOL}): "
          f"kill -> its result {task_s:.3f} s (submit -> the task's start {task_parts[0]:.3f} s, "
          f"its CUDA context and q/k/v {task_parts[1]:.3f} s, its first K1 call "
          f"{task_parts[2]:.3f} s, the plain version {task_parts[3]:.3f} s); the actor's K1 "
          f"launches "
          f"{rep['launches']['flash_fwd']}, worst {rep['worst']:.6f}; the raylets' logs grew "
          f"{log_growth} bytes over the restart", flush=True)
    if kv != b"survives":
        _fail("membership: the KV value did not survive the GCS restart")
    if cluster.gcs_shards != 8 or len(segments) != 8:
        _fail(f"membership: the GCS ran {cluster.gcs_shards} shards with {len(segments)} log "
              f"segments, want the default 8 and 8")
    if visible != "0" or task_launches["flash_fwd"] != 1 or not err <= MEM_TOL:
        _fail("membership: the new GPU task did not see device 0 or its K1 missed")
    if rep["launches"]["flash_fwd"] != rep["calls"] or not rep["worst"] <= MEM_TOL:
        _fail(f"membership: the restart actor's K1 {rep}")
    return {"membership restart actor": rep["launches"], "membership restart task": task_launches}


def phase_membership():
    """Partitions, epoch fencing and GCS restart on the cluster runtime, on a
    fresh init() whose head leases GPU 0, with a 0.25 s heartbeat, a 1.5 s
    timeout and the snapshot pushed out to an hour in the daemons'
    environment, and two nodes added with num_gpus=1: (a) a partitioned K1
    actor rescheduled, fenced and freed from the card with an exactly-once
    audit; (b) the GCS restarted from its log alone; (c) nothing left after
    shutdown. Returns the launches of each path."""
    import glob

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.runtime_base import current_runtime

    phase_t0 = time.perf_counter()
    smi = _smi()
    saved = {k: os.environ.get(k) for k in MEM_HB}
    os.environ.update(MEM_HB)
    parts, launches = {}, {}
    try:
        rt.init()
    finally:
        for k, v in saved.items():  # the daemons have read them
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    runtime = current_runtime()
    cluster = runtime._cluster
    session_dir = cluster.session_dir
    ours = f"/dev/shm/rtpt_{os.path.basename(session_dir)}"
    try:
        t0 = time.perf_counter()
        launches.update(_mem_partition(rt, runtime, cluster, smi))
        parts["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        launches.update(_mem_restart(rt, runtime, cluster, smi))
        parts["b"] = time.perf_counter() - t0
    finally:
        t0 = time.perf_counter()
        rt.shutdown()
        parts["shutdown"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    left = _cluster_processes(session_dir)
    pools = glob.glob(ours + "*")
    print(f"[membership] (c) {smi}: parts "
          f"{', '.join(f'({k}) {v:.1f} s' for k, v in parts.items())}; processes left {left}, "
          f"pools left {sorted(pools)}; phase {time.perf_counter() - phase_t0:.1f} s", flush=True)
    if left or pools:
        _fail("membership: processes or /dev/shm/rtpt_* pools outlived shutdown")
    return launches


# --------------------------------------------------------------- observe
OBS_TOL = 2 ** -6  # K1's per-entry bound at the serve shape (the kernel phase's)
OBS_ENV = {"RAY_TPU_TRACING": "1",
           # (c): rank 1's stall times rank 0's op out in 3 s, not the 300 s default
           "RAY_TPU_COLLECTIVE_TIMEOUT_S": "30", "RAY_TPU_COLLECTIVE_OP_TIMEOUT_S": "3"}
OBS_STALL_S = 5.0  # (c): rank 1's sleep, past the op timeout
OBS_TIMEOUT_S = 120


def _obs_qkv(seed: int):
    import torch

    b, s, h, d = CLUSTER_SERVE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(3)]


def _obs_k1(seed: int):
    """K1 (causal) on q/k/v from `seed` in this process, held against its
    plain version: (o, per-entry error)."""
    from ray_tpu_torch.ops import flash_attention as fa

    q, k, v = _obs_qkv(seed)
    o = fa.flash_attention(q, k, v, causal=True)
    o_ref, _ = fa.reference_flash_fwd(q, k, v, causal=True, scale=q.shape[-1] ** -0.5)
    return o, entry_err(o, o_ref)


class _ObsTalker:
    """(a)'s num_gpus=0.5 actor: its first call times its own first K1 call
    by its clock (the CUDA context, q/k/v, the kernel library's load, the
    first launch through the wrapper `flash_fwd`, the first dispatch of the
    registered op through flash_attention, a second call), prints a line
    with the output's checksum and its wall time, and logs one structured
    record."""

    def __init__(self):
        _zero_launch_counts()

    def first(self, seed):
        import torch

        from ray_tpu_torch.observability.logs import get_logger
        from ray_tpu_torch.ops import _build
        from ray_tpu_torch.ops import flash_attention as fa

        stamps = [time.perf_counter()]
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())  # the CUDA context
        q, k, v = _obs_qkv(seed)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())  # q/k/v
        _build.load("flash_fwd")
        stamps.append(time.perf_counter())  # the kernel library's load
        fa.flash_fwd(q, k, v, causal=True, scale=q.shape[-1] ** -0.5)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())  # the wrapper's first launch
        o = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())  # the op's first dispatch and launch
        fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())  # a second call
        o_ref, _ = fa.reference_flash_fwd(q, k, v, causal=True, scale=q.shape[-1] ** -0.5)
        err = entry_err(o, o_ref)
        checksum = float(o.float().sum())
        printed = time.time()
        print(f"observe-k1 checksum={checksum:.6f} printed={printed:.6f}", flush=True)
        get_logger("worker").info("observe-k1 structured checksum=%.6f", checksum)
        return {"pid": os.getpid(), "ppid": os.getppid(), "err": err, "checksum": checksum,
                "printed": printed, "parts": [b - a for a, b in zip(stamps, stamps[1:])],
                "launches": _launch_counts()}


def _obs_crash_task(marker, key):
    """(b): K1 against its plain version, what it saw recorded in the GCS
    KV, a marker line on stderr, then SIGKILL of its own worker."""
    import json as _json
    import signal as _signal

    from ray_tpu_torch.core.runtime_base import current_runtime

    _zero_launch_counts()
    _, err = _obs_k1(7001)
    killed = time.time()
    current_runtime()._gcs.call("kv_put", key, _json.dumps({
        "ppid": os.getppid(), "pid": os.getpid(), "err": err, "killed": killed,
        "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "launches": _launch_counts()}).encode())
    sys.stderr.write(marker + "\n")
    sys.stderr.flush()
    os.kill(os.getpid(), _signal.SIGKILL)


class _ObsMember:
    """(c)'s collective member (num_gpus=0.5): K1's output on its card into
    the group's allreduce; a stall past the op timeout on demand."""

    def __init__(self):
        _zero_launch_counts()
        self.err = None

    def pid(self):
        return os.getpid()

    def reduce(self, seed):
        from ray_tpu_torch import collective

        o, self.err = _obs_k1(seed)
        summed = collective.allreduce(o, group_name="observe")
        return {"o": o.float().cpu().numpy(), "sum": summed}

    def again(self, stall_s=0.0):
        import torch

        from ray_tpu_torch import collective
        from ray_tpu_torch.exceptions import CollectiveTimeoutError

        if stall_s:
            time.sleep(stall_s)  # rank 1 never joins this op
            return ("stalled",)
        t0 = time.time()
        try:
            collective.allreduce(torch.ones(4, device="cuda"), group_name="observe")
            return ("ok",)
        except CollectiveTimeoutError as e:
            return ("timeout", e.group, e.rank, list(e.missing), t0, time.time())

    def report(self):
        return {"launches": _launch_counts(), "err": self.err, "pid": os.getpid()}


def _obs_wait(pred, what, timeout_s=OBS_TIMEOUT_S, interval=0.01):
    deadline = time.monotonic() + timeout_s
    while True:
        got = pred()
        if got:
            return got
        if time.monotonic() > deadline:
            _fail(f"observe: {what} did not happen in {timeout_s:.0f} s")
        time.sleep(interval)


def _warm_zygote(runtime, what: str, timeout_s: float = 120.0) -> float:
    """Waits until this node's zygote has imported its device stack (the
    flash op's first dispatch, core/zygote.py), so that a GPU worker forked
    now skips it; returns the seconds waited."""
    t0 = time.perf_counter()
    while not (stats := runtime._raylet.call("zygote_stats")).get("device_stack"):
        if time.perf_counter() - t0 > timeout_s:
            _fail(f"{what}: the zygote did not import its device stack in {timeout_s} s: "
                  f"{stats}")
        time.sleep(0.05)
    return time.perf_counter() - t0


def _obs_logs(rt, runtime, smi):
    """(a): a named num_gpus=0.5 actor's first K1 call, its print at the
    driver, its records through tail_logs, its span linked to the driver's.
    Returns its launches."""
    from ray_tpu_torch import tracing
    from ray_tpu_torch.utils import state

    import threading

    # The driver's view of the actor's line, stamped as it lands.
    landed, done = {}, threading.Event()

    def watch():
        while not done.is_set() and "line" not in landed:
            line = next((ln for ln in list(runtime._log_recent)
                         if "observe-k1 checksum=" in ln), None)
            if line is not None:
                landed.update(line=line, at=time.time())
            time.sleep(0.002)

    watcher = threading.Thread(target=watch, daemon=True, name="observe-watch")
    watcher.start()
    actor = rt.remote(num_gpus=0.5)(_ObsTalker).options(name="observe_k1").remote()
    with tracing.span("observe.call") as driver_span:
        res = rt.get(actor.first.remote(1001), timeout=OBS_TIMEOUT_S)
    pid = res["pid"]
    _obs_wait(lambda: "line" in landed, "the actor's print at the driver")
    done.set()
    watcher.join(5)
    seen, arrived = landed["line"], landed["at"]
    actor_id = actor._actor_id.hex()
    recs = _obs_wait(lambda: (r := state.cluster_logs(actor_id=actor_id, grep="observe-k1"))
                     and {x["component"] for x in r} >= {"stdout", "worker"} and r,
                     "the actor's records in tail_logs")
    comps = sorted({r["component"] for r in recs})
    spans = tracing.collect()
    mine = [s for s in spans if s.get("trace_id") == driver_span["trace_id"]]
    submit = next((s for s in mine if s["name"].startswith("submit actor task first")), None)
    run = next((s for s in mine if s["name"].startswith("run actor task first")), None)
    parts = dict(zip(("cuda context", "q/k/v", "library load", "first launch (flash_fwd)",
                      "first dispatch (flash_attention)", "second call"), res["parts"]))
    rt.kill(actor)
    print(f"[observe] (a) {smi}: actor observe_k1 (num_gpus=0.5, pid {pid}) ran K1 at the "
          f"serve shape {CLUSTER_SERVE_SHAPE} within {res['err']:.6f} per entry (tol "
          f"{OBS_TOL}), {res['launches']['flash_fwd']} launches; its print reached the "
          f"driver's _log_recent {arrived - res['printed']:.3f} s after it was printed, as "
          f"{seen!r}; tail_logs by its actor id: components {comps}; spans: the driver's "
          f"{driver_span['name']!r} {driver_span['span_id']}, the worker's "
          f"{(run or {}).get('name')!r} (pid {(run or {}).get('pid')}) parent "
          f"{(run or {}).get('parent_id')} flow_in {((run or {}).get('attrs') or {}).get('flow_in')} "
          f"against the submit span's flow_out "
          f"{((submit or {}).get('attrs') or {}).get('flow_out')}", flush=True)
    zygote = runtime._raylet.call("zygote_stats").get("pid")
    print(f"[observe] (a) {smi}: the actor's first K1 call by its own clock: "
          f"{', '.join(f'{k} {v:.3f} s' for k, v in parts.items())}; the actor forked by the "
          f"zygote after its device stack: {res['ppid'] == zygote}", flush=True)
    if not res["err"] <= OBS_TOL or res["launches"]["flash_fwd"] != 3:
        _fail(f"observe: K1 in the actor {res['err']} {res['launches']}")
    if not seen.startswith(f"(observe_k1 pid={pid} node="):
        _fail(f"observe: the driver's line {seen!r} lacks the actor's prefix")
    if run is None or submit is None or run["parent_id"] != driver_span["span_id"] \
            or run["pid"] != pid or run["attrs"].get("flow_in") != submit["attrs"].get("flow_out"):
        _fail(f"observe: the worker's span is not linked to the driver's: {mine}")
    return res["launches"], arrived - res["printed"]


def _obs_crash(rt, runtime, smi):
    """(b): a num_gpus=0.5 task with max_retries=0 on a worker forked from the
    zygote runs K1, writes a marker to stderr and SIGKILLs itself: the
    driver's error, the post-mortem beside the flight dumps, the GCS's
    error table. Returns its launches and death -> post-mortem s."""
    import glob
    import json as _json
    import uuid

    from ray_tpu_torch.exceptions import WorkerCrashedError
    from ray_tpu_torch.observability import flight_recorder
    from ray_tpu_torch.utils import state

    zpid = _obs_wait(lambda: runtime._raylet.call("zygote_stats").get("pid"),
                     "the zygote", interval=0.1)
    marker, key = f"observe-last-words-{uuid.uuid4().hex[:8]}", "observe/crash"
    err = None
    try:
        rt.get(rt.remote(num_gpus=0.5, max_retries=0)(_obs_crash_task).remote(marker, key),
               timeout=OBS_TIMEOUT_S)
    except WorkerCrashedError as e:
        err = str(e)
    seen = _json.loads(runtime._gcs.call("kv_get", key) or b"{}")

    def postmortem():
        for path in glob.glob(os.path.join(flight_recorder.flight_dir(), "postmortem_*.json")):
            with open(path) as f:
                payload = _json.load(f)
            if any(marker in ln for ln in payload.get("tail", [])):
                return path, payload
        return None

    path, payload = _obs_wait(postmortem, "the post-mortem file")
    landed = os.stat(path).st_mtime - seen.get("killed", 0.0)
    crash = _obs_wait(lambda: [e for e in state.cluster_errors() if e.get("type") ==
                               "worker_crash" and marker in str(e.get("log_tail", ""))],
                      "the worker_crash record")
    status = os.path.join(runtime._cluster.log_dir, f"worker_{payload['worker_id']}.exit")
    print(f"[observe] (b) {smi}: task (num_gpus=0.5, max_retries=0, pid {seen.get('pid')}, "
          f"parent {seen.get('ppid')}, the zygote {zpid}, CUDA_VISIBLE_DEVICES="
          f"{seen.get('visible')!r}) ran K1 within {seen.get('err')} per entry, then SIGKILLed "
          f"itself: the driver's error {err!r:.160}; post-mortem {os.path.basename(path)} "
          f"{landed:.3f} s after the kill: exit_code {payload['exit_code']}, task "
          f"{payload['task']!r}, tail {payload['tail'][-2:]}; the zygote's status file "
          f"{os.path.exists(status)}; GCS error table: {crash[-1]['type']} "
          f"{crash[-1]['error']!r}", flush=True)
    if err is None or marker not in err:
        _fail(f"observe: the driver's get raised no WorkerCrashedError with the marker: {err!r}")
    if seen.get("ppid") != zpid or not os.path.exists(status):
        _fail(f"observe: the task's worker was not forked from the zygote ({seen}, {zpid})")
    if payload["exit_code"] != -9 or "_obs_crash_task" not in (payload["task"] or ""):
        _fail(f"observe: post-mortem {payload}")
    if seen.get("visible") != "0" or not seen.get("err", 1.0) <= OBS_TOL \
            or seen["launches"]["flash_fwd"] != 1:
        _fail(f"observe: the task's K1 {seen}")
    return seen["launches"], landed


def _obs_collective(rt, runtime, smi):
    """(c): two num_gpus=0.5 actors allreduce K1's CUDA output, then rank 1
    stalls past the op timeout: rank 0's CollectiveTimeoutError, one
    incident, its harvest and bundle, the merged trace, the report. Returns
    the two actors' launches and trigger -> staged s."""
    import json as _json

    import numpy as np

    from ray_tpu_torch import collective
    from ray_tpu_torch.observability import flight_recorder, postmortem
    from ray_tpu_torch.utils import state

    cls = rt.remote(num_gpus=0.5)(_ObsMember)
    members = [cls.remote(), cls.remote()]
    pids = rt.get([m.pid.remote() for m in members], timeout=OBS_TIMEOUT_S)
    born = time.monotonic()
    collective.create_collective_group(members, group_name="observe")
    outs = rt.get([m.reduce.remote(2001 + i) for i, m in enumerate(members)],
                  timeout=OBS_TIMEOUT_S)
    want = outs[0]["o"].astype(np.float64) + outs[1]["o"].astype(np.float64)
    ar_err = max(float(np.max(np.abs(o["sum"].reshape(want.shape) - want))) for o in outs)
    # The raylet signals no worker younger than 5 s: both rings must dump.
    time.sleep(max(0.0, 5.5 - (time.monotonic() - born)))
    stalled = members[1].again.remote(OBS_STALL_S)
    r0 = rt.get(members[0].again.remote(), timeout=OBS_TIMEOUT_S)
    if r0[0] != "timeout":
        _fail(f"observe: rank 0 got {r0} with rank 1 stalled")
    inc = _obs_wait(lambda: next((i for i in state.list_incidents()
                                  if i["trigger"] == "coll.timeout"
                                  and i["state"] in ("staged", "failed")), None),
                    "the coll.timeout incident staged")
    incidents = state.list_incidents()
    full = state.get_incident(inc["incident_id"])
    bundle = inc["bundle"] or ""
    staged_s = os.stat(os.path.join(bundle, postmortem.MANIFEST_NAME)).st_mtime \
        - full["triggers"][0]["ts"] if bundle else float("nan")
    manifest = postmortem.load_manifest(bundle)
    rings = {d["pid"] for d in flight_recorder.collect(os.path.join(bundle, "flight"))}
    with open(os.path.join(bundle, postmortem.TRACE_NAME)) as f:
        trace = _json.load(f)
    marker = any(e.get("name") == "trigger:coll.timeout" for e in trace["traceEvents"])
    report = postmortem.render_report(bundle)
    suspect = next((ln for ln in report.splitlines() if ln.startswith("- suspect:")), "")
    rt.get(stalled, timeout=OBS_TIMEOUT_S)
    reps = rt.get([m.report.remote() for m in members], timeout=OBS_TIMEOUT_S)
    print(f"[observe] (c) {smi}: two num_gpus=0.5 actors (pids {pids}) allreduced K1's "
          f"CUDA output (bf16, {CLUSTER_SERVE_SHAPE}) within {ar_err:.3g} of the float64 sum, "
          f"K1 within {max(r['err'] for r in reps):.6f} per entry; rank 1 slept "
          f"{OBS_STALL_S} s: rank 0 got {r0[:4]} after {r0[-1] - r0[-2]:.3f} s; incidents "
          f"{[(i['trigger'], i['state'], i['triggers']) for i in incidents]}; trigger -> "
          f"bundle staged {staged_s:.3f} s; the manifest's pids {sorted(manifest['pids'])}, "
          f"the rings in flight/ {sorted(rings)}; trace.json {len(trace['traceEvents'])} "
          f"events, the trigger marker {marker}; report {suspect!r}", flush=True)
    if ar_err > 1e-3 or any(not r["err"] <= OBS_TOL or r["launches"]["flash_fwd"] != 1
                            for r in reps):
        _fail(f"observe: the group's K1 or allreduce: {ar_err} {reps}")
    if r0[:4] != ("timeout", "observe", 0, [1]):
        _fail(f"observe: rank 0 got {r0}")
    if len(incidents) != 1 or inc["state"] != "staged" or full["triggers"][0]["kind"] \
            != "coll.timeout":
        _fail(f"observe: incidents {incidents}")
    if not {str(p) for p in pids} <= set(manifest["pids"]) or not set(pids) <= rings:
        _fail(f"observe: the bundle lacks an actor's ring: {manifest['pids']} {rings}")
    if not marker or "stalled rank" not in suspect or "'missing': [1]" not in suspect:
        _fail(f"observe: the trace's marker {marker}, the report's suspect {suspect!r}")
    launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for r in reps:
        for k, n in r["launches"].items():
            launches[k] += n
    return launches, staged_s


def phase_observe():
    """Logs, dumps, spans and post-mortems on the cluster runtime, on a fresh
    init() whose head leases GPU 0, with tracing on (RAY_TPU_TRACING,
    RAY_TPU_TRACE_DIR) and a 3 s collective op timeout in the daemons' and
    workers' environment: (a) a named num_gpus=0.5 actor's first K1 call,
    timed by its own clock, its print at the driver with its prefix, its
    capture and structured records through tail_logs, its execution span
    linked to the driver's; (b) a num_gpus=0.5 task on a forked worker runs
    K1 and SIGKILLs itself: WorkerCrashedError with its marker, a
    post-mortem with exit code -9, a worker_crash record; (c) two
    num_gpus=0.5 actors allreduce K1's output, then rank 1 stalls: rank 0's
    CollectiveTimeoutError opens one incident whose bundle holds both
    actors' rings, a trace with the trigger's marker and a report naming
    rank 1; (d) nothing left after shutdown. Returns the launches of each
    path."""
    import glob
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.runtime_base import current_runtime

    phase_t0 = time.perf_counter()
    smi = _smi()
    trace_dir = tempfile.mkdtemp(prefix="observe_traces_")
    env = dict(OBS_ENV, RAY_TPU_TRACE_DIR=trace_dir)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    parts, launches, timing = {}, {}, {}
    try:
        rt.init()
        runtime = current_runtime()
        session_dir = runtime._cluster.session_dir
        ours = f"/dev/shm/rtpt_{os.path.basename(session_dir)}"
        try:
            if rt.cluster_resources().get("GPU") != 1.0:
                _fail(f"observe: cluster_resources {rt.cluster_resources()}")
            parts["zygote"] = _warm_zygote(runtime, "observe")
            t0 = time.perf_counter()
            launches["observe logging actor"], timing["print -> driver"] = _obs_logs(
                rt, runtime, smi)
            parts["a"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            launches["observe crashed task"], timing["death -> post-mortem"] = _obs_crash(
                rt, runtime, smi)
            parts["b"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            launches["observe collective actors"], timing["trigger -> staged"] = \
                _obs_collective(rt, runtime, smi)
            parts["c"] = time.perf_counter() - t0
        finally:
            t0 = time.perf_counter()
            rt.shutdown()
            parts["shutdown"] = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        from ray_tpu_torch import tracing

        tracing.disable()
        shutil.rmtree(trace_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    left = _cluster_processes(session_dir)
    pools = glob.glob(ours + "*")
    print(f"[observe] (d) {smi}: {', '.join(f'{k} {v:.3f} s' for k, v in timing.items())}; "
          f"parts {', '.join(f'({k}) {v:.1f} s' for k, v in parts.items())}; processes left "
          f"{left}, pools left {sorted(pools)}; phase {time.perf_counter() - phase_t0:.1f} s",
          flush=True)
    if left or pools:
        _fail("observe: processes or /dev/shm/rtpt_* pools outlived shutdown")
    return launches


# ----------------------------------------------------------------- graphs
GRAPH_TOL = 2 ** -6  # K1's per-entry bound at the serve shape (the kernel phase's)
GRAPH_ITERS = 16
GRAPH_INFLIGHT = 2
GRAPH_SEEDS = (6001, 6002)  # the two actors' seeds; q/k/v from (seed, iteration)
# (b): the cgraph_execute_p99 rule's threshold, the shipped rule's. At 200 ms the
# rule fires on (a)'s own iterations: their execute -> get p99 is ~290 ms on an
# H100 (the 16.8 MB float32 ring allreduce), read as the 500 ms bucket's edge.
GRAPH_P99_MS = 1000.0
GRAPH_STALL_S = 1.5  # (b): actor 1's sleep in each stalled iteration
GRAPH_STALLS = 3
GRAPH_RULES = [{"name": "cgraph_execute_p99", "metric": "raytpu_cgraph_execute_latency_ms",
                "stat": "p99", "op": ">", "threshold": GRAPH_P99_MS, "window_s": 5.0,
                "for_s": 0.5, "description": "compiled-graph iterations are stalling"}]
GRAPH_TIMEOUT_S = 120
GRAPH_BUFFER = 64 << 20  # each edge's ring: a K1 output (8 MiB bf16) fits in half


def _graph_qkv(seed: int, index: int):
    import torch

    b, s, h, d = CLUSTER_SERVE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed * 1000 + index)
    return [torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(3)]


class _GraphMember:
    """A num_gpus=0.5 gang member holding Llama-2-7B attention at the serve
    shape: `attend` runs K1 (causal) on q/k/v from (its seed, the
    iteration), holds the output against the plain version in this process,
    and sleeps when the input asks this rank to stall; `digest` and `full`
    are the graph's last nodes after the allreduce edge (which hands them
    float32 numpy on the host)."""

    def __init__(self, rank, seed):
        self.rank, self.seed = rank, seed
        self.worst = 0.0
        _zero_launch_counts()

    def attend(self, x):
        import torch

        from ray_tpu_torch.ops import flash_attention as fa

        q, k, v = _graph_qkv(self.seed, x["i"])
        o = fa.flash_attention(q, k, v, causal=True)
        o_ref, _ = fa.reference_flash_fwd(q, k, v, causal=True, scale=q.shape[-1] ** -0.5)
        self.worst = max(self.worst, entry_err(o, o_ref))
        torch.cuda.synchronize()
        if x.get("stall_rank") == self.rank:
            time.sleep(x["stall_s"])
        return o

    def digest(self, summed):
        import hashlib

        import numpy as np

        arr = np.ascontiguousarray(summed)
        return {"sha": hashlib.sha256(arr.tobytes()).hexdigest(), "dtype": str(arr.dtype),
                "shape": list(arr.shape), "rank": self.rank}

    def full(self, summed):
        return summed

    def zero(self):
        _zero_launch_counts()
        return os.getpid()

    def report(self):
        return {"pid": os.getpid(), "worst": self.worst, "launches": _launch_counts()}


def _graph_digest(o_sum):
    import hashlib

    arr = o_sum.cpu().numpy()
    return {"sha": hashlib.sha256(arr.tobytes()).hexdigest(), "dtype": str(arr.dtype),
            "shape": list(arr.shape)}


def _pcts(xs):
    s = sorted(xs)
    return s[len(s) // 2], s[min(len(s) - 1, math.ceil(0.99 * len(s)) - 1)]


def _graph_events(runtime, out, stop):
    """Collects node_events as they land, stamped with the driver's clock."""
    cursor = 0
    while not stop.is_set():
        try:
            batch = runtime._gcs.call("pubsub_poll", "node_events", cursor, 0.5, timeout=10.0)
        except Exception:  # noqa: BLE001 - the GCS is going down with the phase
            return
        for seq, msg in batch:
            cursor = max(cursor, seq)
            out.append((time.time(), msg))


def _graph_compiled(rt, runtime, smi, members):
    """(a): the compiled graph, its eager twin, K1's launches, the profile RPC
    during the run. Returns the compiled graph (still wired), the latencies
    and the profile's merge."""
    import threading

    import torch

    from ray_tpu_torch import cgraph
    from ray_tpu_torch.dag import InputNode, MultiOutputNode
    from ray_tpu_torch.observability import perfetto

    with InputNode() as inp:
        outs = [m.attend.bind(inp) for m in members]
        eager = MultiOutputNode(outs).compile()
        reduced = cgraph.allreduce.bind(outs)
        dag = MultiOutputNode([m.digest.bind(r) for m, r in zip(members, reduced)])
    xs = [{"i": i} for i in range(GRAPH_ITERS)]
    eager_ms, want = [], []
    for x in xs:
        t0 = time.perf_counter()
        o = rt.get(eager.execute(x), timeout=GRAPH_TIMEOUT_S)
        want.append(_graph_digest(o[0].float() + o[1].float()))
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    graph = dag.experimental_compile(buffer_size_bytes=GRAPH_BUFFER, max_inflight=GRAPH_INFLIGHT)
    compile_s = time.perf_counter() - t0
    for i in range(2):  # the channels' and the collective ring's first use
        graph.execute({"i": -2 - i}).get(timeout=GRAPH_TIMEOUT_S)
    rt.get([m.zero.remote() for m in members], timeout=GRAPH_TIMEOUT_S)
    prof = {}
    profiler = threading.Thread(
        target=lambda: prof.update(runtime._raylet.call("profile", 1.0, timeout=60.0)),
        daemon=True, name="graphs-profile")
    profiler.start()
    lat_ms, got, pending = [], [], []
    t_run = time.perf_counter()
    for x in xs:
        pending.append((time.perf_counter(), graph.execute(x)))
        if len(pending) == GRAPH_INFLIGHT or x is xs[-1]:
            while pending:
                t_exec, ref = pending.pop(0)
                got.append(ref.get(timeout=GRAPH_TIMEOUT_S))
                lat_ms.append((time.perf_counter() - t_exec) * 1e3)
    run_s = time.perf_counter() - t_run
    reps = rt.get([m.report.remote() for m in members], timeout=GRAPH_TIMEOUT_S)
    profiler.join(60)
    profiles = [p for p in perfetto.collect_profiles(os.path.dirname(prof.get("path") or "."))
                if str(p.get("name", "")).startswith("raylet-")]
    trace = perfetto.build_trace(profiles=profiles)
    prof_events = [e for e in trace["traceEvents"] if e.get("cat") == "profile"]
    bitwise = [g[0]["sha"] == g[1]["sha"] == w["sha"] and g[0]["dtype"] == w["dtype"] ==
               "float32" for g, w in zip(got, want)]
    c50, c99 = _pcts(lat_ms)
    e50, e99 = _pcts(eager_ms)
    print(f"[graphs] (a) {smi}: two num_gpus=0.5 actors (pids {[r['pid'] for r in reps]}) ran K1 "
          f"at the serve shape {CLUSTER_SERVE_SHAPE} on q/k/v from (seed, iteration), an "
          f"allreduce edge summing their outputs, MultiOutputNode of both members' digests; "
          f"compiled (max_inflight={GRAPH_INFLIGHT}, compile {compile_s:.3f} s) "
          f"{GRAPH_ITERS} iterations in {run_s:.3f} s: execute -> get p50 {c50:.2f} ms, p99 "
          f"{c99:.2f} ms; the eager twin (object-plane compile(), the sum at the driver) p50 "
          f"{e50:.2f} ms, p99 {e99:.2f} ms; compiled == eager bitwise in "
          f"{sum(bitwise)}/{len(bitwise)}; K1 per entry {[round(r['worst'], 6) for r in reps]} "
          f"(tol {GRAPH_TOL}); K1 launches in each actor's process "
          f"{[r['launches']['flash_fwd'] for r in reps]}; the raylet's profile RPC (1 s, "
          f"{prof.get('samples')} samples) merged into the Perfetto trace as "
          f"{len(prof_events)} profile events", flush=True)
    if not all(bitwise):
        _fail(f"graphs: compiled results differ from the eager twin: {got[:2]} {want[:2]}")
    if any(not r["worst"] <= GRAPH_TOL for r in reps) or any(
            r["launches"]["flash_fwd"] != GRAPH_ITERS for r in reps):
        _fail(f"graphs: K1 in the actors {reps}")
    if not prof.get("samples") or not prof_events:
        _fail(f"graphs: the profile RPC {prof} merged {len(prof_events)} events")
    return graph, reps, {"compiled p50 ms": c50, "compiled p99 ms": c99, "eager p50 ms": e50,
                         "eager p99 ms": e99}


def _graph_watchdog(rt, runtime, smi, graph, events):
    """(b): actor 1 stalls a few iterations: the cgraph_execute_p99 rule
    fires on node_events and in active_alerts, a watchdog.alert incident is
    staged with the latency series in its metrics.json, the rule clears once
    the stall has left its window, and the executions counter's history
    reads as a rate. An alert that (a)'s own iterations raised (their p99
    read as a bucket's upper edge) is waited out first and reported."""
    import json as _json

    from ray_tpu_torch.observability import postmortem
    from ray_tpu_torch.utils import state

    def alerts(which, since=0.0):
        return [(t, m) for t, m in list(events) if isinstance(m, dict)
                and m.get("event") == "slo_alert" and m.get("rule") == "cgraph_execute_p99"
                and m.get("state") == which and m.get("ts", 0.0) >= since]

    # (a)'s last latencies reach the rule within a flush, a tick and for_s.
    t_wait = time.perf_counter()
    time.sleep(3.0)
    early = [m["value"] for _, m in alerts("firing")]
    _obs_wait(lambda: not state.active_alerts(), "(a)'s alert cleared", timeout_s=GRAPH_TIMEOUT_S,
              interval=0.2)
    early_wait = time.perf_counter() - t_wait
    stall_t0, breach = time.time(), None
    for i in range(GRAPH_STALLS):
        graph.execute({"i": 100 + i, "stall_rank": 1, "stall_s": GRAPH_STALL_S}).get(
            timeout=GRAPH_TIMEOUT_S)
        breach = breach or time.time()  # the first slow iteration's latency is observed
    firing = _obs_wait(lambda: alerts("firing", stall_t0), "the slo_alert firing",
                       timeout_s=GRAPH_TIMEOUT_S)[0][1]
    active = state.active_alerts()
    fired_at = firing["ts"]
    inc = _obs_wait(lambda: next((i for i in state.list_incidents()
                                  if i["trigger"] == "watchdog.alert"
                                  and i["opened_ts"] >= fired_at - 1.0
                                  and i["state"] in ("staged", "failed")), None),
                    "the watchdog.alert incident staged", timeout_s=GRAPH_TIMEOUT_S)
    bundle = inc["bundle"] or ""
    staged_s = (os.stat(os.path.join(bundle, postmortem.MANIFEST_NAME)).st_mtime - fired_at
                if bundle else float("nan"))
    window = []
    if bundle:
        with open(os.path.join(bundle, "metrics.json")) as f:
            window = [m for m in _json.load(f)
                      if m["name"] == "raytpu_cgraph_execute_latency_ms"]
    # Fast iterations go on while the stall leaves the rule's window; if
    # their own p99 reads above the threshold, the rule clears once they stop.
    t_clear, i = time.monotonic(), 200
    while not alerts("cleared", fired_at) and time.monotonic() - t_clear < 20.0:
        graph.execute({"i": i}).get(timeout=GRAPH_TIMEOUT_S)
        i += 1
    idle = not alerts("cleared", fired_at)
    cleared = _obs_wait(lambda: alerts("cleared", fired_at), "the slo_alert cleared",
                        timeout_s=GRAPH_TIMEOUT_S)[0][1]
    gtag = {"graph": graph._dag_id[:8]}
    rates = _obs_wait(lambda: [s for s in state.metrics_history(
        "raytpu_cgraph_executions_total", tags=gtag, as_rate=True) if len(s["samples"]) >= 2],
        "two rate samples of raytpu_cgraph_executions_total", timeout_s=30)
    print(f"[graphs] (b) {smi}: alerts raised by (a)'s own iterations {early} (waited "
          f"{early_wait:.3f} s for them to clear); actor 1 slept {GRAPH_STALL_S} s in "
          f"{GRAPH_STALLS} iterations under cgraph_execute_p99 > {GRAPH_P99_MS} ms (for_s 0.5, "
          f"window 5 s): breach -> firing {fired_at - breach:.3f} s (value {firing['value']}, "
          f"flight dump {bool(firing.get('flight_dump'))}); active_alerts "
          f"{[a['rule'] for a in active]}; firing -> bundle staged {staged_s:.3f} s "
          f"({inc['incident_id']}, {inc['state']}), its metrics.json latency series "
          f"{len(window)} with {sum(len(m['samples']) for m in window)} samples; cleared "
          f"{cleared['ts'] - fired_at:.3f} s after firing ({i - 200} fast iterations after the "
          f"stall{', then idle' if idle else ''}); executions as a rate: "
          f"{len(rates[0]['samples'])} samples, last {rates[0]['samples'][-1][1]:.2f}/s",
          flush=True)
    if not active or active[0]["rule"] != "cgraph_execute_p99" or not firing.get("flight_dump"):
        _fail(f"graphs: active_alerts {active}, the firing event {firing}")
    if inc["state"] != "staged" or not any(m["samples"] for m in window):
        _fail(f"graphs: the incident {inc} and its metrics window {window}")
    return {"breach -> firing s": fired_at - breach, "firing -> staged s": staged_s,
            "firing -> cleared s": cleared["ts"] - fired_at}


def _graph_elastic(rt, runtime, smi, members):
    """(c): an ElasticGraph over the two members (allreduce, each member's
    full sum back); one member killed; the gang re-forms at the survivor,
    whose next result must be its own K1 output within 2^-6 of the plain
    version on the driver's card."""
    import torch

    from ray_tpu_torch import cgraph
    from ray_tpu_torch.dag import InputNode, MultiOutputNode
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.utils import state

    def build(actors):
        with InputNode() as inp:
            reduced = cgraph.allreduce.bind([a.attend.bind(inp) for a in actors])
            return MultiOutputNode([a.full.bind(r) for a, r in zip(actors, reduced)])

    eg = cgraph.ElasticGraph(build, list(members), min_actors=1, rebuild_timeout=90.0,
                             buffer_size_bytes=GRAPH_BUFFER, max_inflight=GRAPH_INFLIGHT)
    try:
        both = eg.run({"i": 300}, timeout=60)
        rt.kill(members[1])
        t_kill = time.perf_counter()
        out = eg.run({"i": 301}, timeout=30)
        kill_s = time.perf_counter() - t_kill
        world = eg.world_size
    finally:
        eg.teardown()
    q, k, v = _graph_qkv(GRAPH_SEEDS[0], 301)
    o_ref, _ = fa.reference_flash_fwd(q, k, v, causal=True, scale=q.shape[-1] ** -0.5)
    err = entry_err(torch.from_numpy(out[0]).cuda(), o_ref) if len(out) == 1 else float("nan")
    dead = [a["state"] for a in state.list_actors()
            if a["actor_id"] == members[1]._actor_id.hex()]
    print(f"[graphs] (c) {smi}: ElasticGraph (min_actors=1) over both members: world 2 "
          f"result {len(both)} sums of shape {list(both[0].shape)}; member 1 killed "
          f"({dead}): kill -> first result at world {world} {kill_s:.3f} s, the survivor's "
          f"K1 within {err:.6f} per entry of the plain version on the driver's card", flush=True)
    if world != 1 or len(out) != 1 or not err <= GRAPH_TOL:
        _fail(f"graphs: the re-formed gang: world {world}, {len(out)} results, err {err}")
    return {"kill -> first result s": kill_s}


def phase_graphs():
    """Compiled graphs, SLO watchdogs and the sampling profiler on a fresh
    init() whose head leases GPU 0, with the cgraph_execute_p99 rule at
    GRAPH_P99_MS (for_s 0.5, a 5 s window) as the GCS's only watchdog rule:
    (a) two num_gpus=0.5 actors run K1 at the serve shape, an allreduce edge
    sums their outputs, a MultiOutputNode returns both members' results: 16
    iterations with max_inflight=2 bitwise equal to the eager twin, K1 within
    2^-6 per entry and launched 16 times in each actor's process, the
    raylet's profile RPC (1 s) merged into a Perfetto trace; (b) actor 1
    stalls: slo_alert firing then cleared on node_events, active_alerts, a
    watchdog.alert incident with the latency series in its metrics.json, the
    executions counter's history as a rate; (c) an ElasticGraph loses member
    1 and re-forms at the survivor, whose K1 is checked; (d) nothing left
    after shutdown. Returns the actors' launches."""
    import glob
    import json as _json
    import shutil
    import tempfile
    import threading

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.runtime_base import current_runtime

    phase_t0 = time.perf_counter()
    smi = _smi()
    trace_dir = tempfile.mkdtemp(prefix="graphs_traces_")
    env = {"RAY_TPU_WATCHDOG_RULES": _json.dumps(GRAPH_RULES), "RAY_TPU_TRACE_DIR": trace_dir}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    parts, timing, events, stop = {}, {}, [], threading.Event()
    try:
        rt.init()
        runtime = current_runtime()
        session_dir = runtime._cluster.session_dir
        ours = f"/dev/shm/rtpt_{os.path.basename(session_dir)}"
        watcher = threading.Thread(target=_graph_events, args=(runtime, events, stop),
                                   daemon=True, name="graphs-events")
        watcher.start()
        try:
            if rt.cluster_resources().get("GPU") != 1.0:
                _fail(f"graphs: cluster_resources {rt.cluster_resources()}")
            t0 = time.perf_counter()
            cls = rt.remote(num_gpus=0.5, max_restarts=0)(_GraphMember)
            members = [cls.remote(r, s) for r, s in enumerate(GRAPH_SEEDS)]
            # Each fresh actor's first K1 dispatch (~9 s), both at once.
            rt.get([m.attend.remote({"i": -1}) for m in members], timeout=GRAPH_TIMEOUT_S)
            parts["start"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            graph, reps, lat = _graph_compiled(rt, runtime, smi, members)
            timing.update(lat)
            parts["a"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            try:
                timing.update(_graph_watchdog(rt, runtime, smi, graph, events))
            finally:
                graph.teardown()
            parts["b"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            timing.update(_graph_elastic(rt, runtime, smi, members))
            parts["c"] = time.perf_counter() - t0
        finally:
            stop.set()
            t0 = time.perf_counter()
            rt.shutdown()
            parts["shutdown"] = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(trace_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    left = _cluster_processes(session_dir)
    pools = glob.glob(ours + "*")
    print(f"[graphs] (d) {smi}: {', '.join(f'{k} {v:.3f}' for k, v in timing.items())}; parts "
          f"{', '.join(f'({k}) {v:.1f} s' for k, v in parts.items())}; processes left {left}, "
          f"pools left {sorted(pools)}; phase {time.perf_counter() - phase_t0:.1f} s", flush=True)
    if left or pools:
        _fail("graphs: processes or /dev/shm/rtpt_* pools outlived shutdown")
    launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for rep in reps:
        for k, n in rep["launches"].items():
            launches[k] += n
    return {"graphs compiled actors": launches}


DATA_ROWS = 6  # (a): one 1 x FIT_SEQ row per step
DATA_BLOCKS = 3
DATA_LR = 1e-4
DATA_LM_LAYERS = 2  # (b): the replica's PagedLM at Llama-2-7B width
DATA_LM_GEOMETRY = dict(num_pages=256, page_tokens=16, max_slots=4, max_pages_per_seq=64)
DATA_PROMPTS = (280, 700, 20, 310)  # (b): the serve cell's first four prompt lengths
DATA_NEW = 16
DATA_FEATURES = 512  # (c): rows of the featurized dataset
DATA_LOOKUPS = 16
DATA_TIMEOUT_S = 120


def _data_source():
    """(a)'s source: DATA_ROWS rows of FIT_SEQ token ids from seed 7 and a
    row id column."""
    import numpy as np

    rng = np.random.default_rng(7)
    return {"tokens": rng.integers(0, 32000, (DATA_ROWS, FIT_SEQ), dtype=np.int32),
            "row": np.arange(DATA_ROWS, dtype=np.int64)}


class _DataCheck:
    """(a)'s map_batches stage, on an actor pool: the token ids checked
    against the vocab and passed on, with the pool actor's pid."""

    def __call__(self, batch):
        import numpy as np

        tokens = np.asarray(batch["tokens"])
        if tokens.min() < 0 or tokens.max() >= 32000:
            raise ValueError(f"token ids out of the vocab: {tokens.min()}..{tokens.max()}")
        return {"tokens": tokens, "row": batch["row"],
                "pid": np.full(len(batch["row"]), os.getpid(), dtype=np.int64)}


def _data_loop(config):
    """(a)'s training loop, as a user writes it for TorchTrainer(datasets=):
    the fit phase's model from seed 0, deterministic, one AdamW step per
    batch of train.get_dataset_shard("train").iter_device_batches(1); the
    last report holds the losses, the rows seen, the wait before each batch
    and each step's time, params_sha256 and the kernel launches."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import transformer as tfm

    torch.use_deterministic_algorithms(True)
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = _fit_cfg()
    init, step = tfm.build_train_step(cfg, tfm.adamw(config["lr"]), device=device)
    params, opt = init(torch.Generator(device=device).manual_seed(0))
    _zero_launch_counts()
    batches = iter(train.get_dataset_shard("train").iter_device_batches(batch_size=1))
    losses, rows, pool_pids, waits, step_s, dtype = [], [], set(), [], [], None
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        waits.append(time.perf_counter() - t0)
        if batch is None:
            break
        if batch["tokens"].device != device:
            raise RuntimeError(f"a batch landed on {batch['tokens'].device}, not {device}")
        rows.extend(batch["row"].tolist())
        pool_pids.update(batch["pid"].tolist())
        dtype = str(batch["tokens"].dtype)
        t0 = time.perf_counter()
        losses.append(step(params, opt, batch["tokens"]).item())
        step_s.append(time.perf_counter() - t0)
        train.report({"step": len(losses) - 1, "loss": losses[-1]})
    train.report({"losses": losses, "rows": rows, "pool_pids": sorted(pool_pids),
                  "waits": waits, "step_s": step_s, "wall_s": time.perf_counter() - t_start,
                  "launches": _launch_counts(), "params_sha256": _params_sha256(params),
                  "pid": os.getpid(), "dtype": dtype})


def _data_direct(tokens):
    """(a)'s reference in this process: the same model, seed and rows in
    dataset order through build_train_step driven directly, deterministic:
    (losses, step seconds, params_sha256)."""
    import torch

    from ray_tpu_torch.models import transformer as tfm

    with _deterministic():
        cfg = _fit_cfg()
        init, step = tfm.build_train_step(cfg, tfm.adamw(DATA_LR), device="cuda")
        params, opt = init(torch.Generator(device="cuda").manual_seed(0))
        losses, step_s = [], []
        for r in range(DATA_ROWS):
            batch = torch.from_numpy(tokens[r:r + 1].astype("int64")).cuda()
            t0 = time.perf_counter()
            losses.append(step(params, opt, batch).item())
            step_s.append(time.perf_counter() - t0)
        sha = _params_sha256(params)
        del params, opt
    torch.cuda.empty_cache()
    return losses, step_s, sha


def _data_lm(*, seed: int = 0, device=None, **geometry):
    """(b)'s builder for llm_deployment: PagedLM at Llama-2-7B width with
    DATA_LM_LAYERS layers, bf16, random weights from `seed`."""
    import torch

    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.serve.llm.model import PagedLM

    return PagedLM(tfm.llama2_7b(n_layers=DATA_LM_LAYERS, dtype=torch.bfloat16), seed=seed,
                   device=device, **geometry)


def _http_stream(port: int, app: str, payload, timeout_s: float = DATA_TIMEOUT_S):
    """POSTs `payload` as JSON to the proxy and reads the chunked framing off
    the socket itself: (status, t_submit, [(t, chunk bytes), ...]), one entry
    per chunk as it arrived."""
    import socket

    body = json.dumps(payload).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=timeout_s) as s:
        t0 = time.perf_counter()
        s.sendall(f"POST /{app} HTTP/1.1\r\nHost: smoke\r\nContent-Type: application/json\r\n"
                  f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode() + body)
        f = s.makefile("rb")
        status = int(f.readline().split()[1])
        chunked = False
        while True:
            line = f.readline().strip().lower()
            if not line:
                break
            chunked |= line == b"transfer-encoding: chunked"
        if not chunked:
            _fail(f"data: the proxy's answer to /{app} is not chunked (status {status})")
        chunks = []
        while True:
            size = int(f.readline().strip(), 16)
            if size == 0:
                return status, t0, chunks
            chunks.append((time.perf_counter(), f.read(size)))
            f.readline()


def _http_json(port: int, app: str, payload):
    """One unary request through the proxy: the decoded JSON answer."""
    status, _, chunks = _http_stream(port, app, payload)
    if status != 200:
        _fail(f"data: /{app} answered {status}: {b''.join(c for _, c in chunks)!r}")
    return json.loads(b"".join(c for _, c in chunks))


def _data_featurize(batch):
    """(c)'s feature transform: per id a scalar, a 2-vector and the host
    time the row was made."""
    import numpy as np

    ids = np.asarray(batch["id"])
    return {"id": ids, "feat": ids * 0.5, "vec": np.stack([np.sin(ids), np.cos(ids)], 1),
            "t_feat": np.full(len(ids), time.time())}


class _FeatureLookup:
    """(c)'s deployment: a FeatureTable over the ChannelFeed it is bound
    with; a request is one key, the answer its row (null when unknown)."""

    def __init__(self, feed):
        from ray_tpu_torch.serve import FeatureTable

        self.table = FeatureTable(feed, key="id", batch_size=128, continuous=False)

    def __call__(self, key):
        row = self.table.lookup(int(key))
        return None if row is None else {k: v.tolist() for k, v in row.items()}

    def stats(self):
        return {**self.table.stats(), "pid": os.getpid()}


def _data_trainer(rt, tmp, tokens, direct, smi):
    """(a): the pipeline into TorchTrainer on this cluster; returns the
    worker's launches."""
    import statistics

    from ray_tpu_torch import data
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    ds = data.from_numpy(tokens, parallelism=DATA_BLOCKS).map_batches(_DataCheck,
                                                                       concurrency=(1, 2))
    t0 = time.perf_counter()
    result = TorchTrainer(
        _data_loop, train_loop_config={"lr": DATA_LR},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name="data_channel", storage_path=tmp),
        datasets={"train": ds}, dataset_config="channel").fit()
    fit_s = time.perf_counter() - t0
    if result.error is not None:
        _fail(f"data: (a) the trainer failed: {result.error!r}")
    m = result.metrics
    d_losses, d_step_s, d_sha = direct
    step_p50 = statistics.median(m["step_s"][1:]) * 1e3
    direct_p50 = statistics.median(d_step_s[1:]) * 1e3
    wait_ms = [w * 1e3 for w in m["waits"]]
    print(f"[data] (a) {smi}: from_numpy({DATA_ROWS} x {FIT_SEQ} int32 tokens, {DATA_BLOCKS} "
          f"blocks) -> map_batches on an actor pool (concurrency (1, 2), pids {m['pool_pids']}) "
          f"-> TorchTrainer(dataset_config='channel'), 1 worker (pid {m['pid']}), llama2_7b width, "
          f"2 layers, bf16, remat hot, batches of 1 x {FIT_SEQ} as {m['dtype']}: fit {fit_s:.1f} s; "
          f"rows seen {m['rows']}; losses {m['losses']}, direct {d_losses}; params_sha256 equal "
          f"{m['params_sha256'] == d_sha}; launches in the worker {m['launches']}", flush=True)
    print(f"[data] (a) {smi}: {DATA_ROWS / m['wall_s']:.2f} rows/s into the trainer "
          f"({DATA_ROWS * FIT_SEQ / m['wall_s']:.0f} tokens/s); data_wait per step "
          f"{', '.join(f'{w:.2f}' for w in wait_ms)} ms (the last is the end of the stream; "
          f"phase_seconds data_wait {m.get('phase_seconds', {}).get('data_wait', 0) * 1e3:.2f} ms "
          f"in the last report) against a step p50 of {step_p50:.2f} ms (steps 2-{DATA_ROWS}; the direct "
          f"loop's {direct_p50:.2f} ms)", flush=True)
    if m["pid"] == os.getpid() or not m["pool_pids"] or os.getpid() in m["pool_pids"]:
        _fail("data: (a) the trainer's worker or the pool ran in the driver's process")
    if m["rows"] != list(range(DATA_ROWS)):
        _fail(f"data: (a) the worker saw rows {m['rows']}, not the dataset's {DATA_ROWS} in order")
    if m["losses"] != d_losses or m["params_sha256"] != d_sha:
        _fail("data: (a) the channel-fed trainer is not bitwise the direct loop on the same rows")
    want = {k: 2 * DATA_ROWS for k in m["launches"]}
    if m["launches"] != want:
        _fail(f"data: (a) the worker launched {m['launches']}, want {want}")
    if not m.get("phase_seconds", {}).get("data_wait", 0) > 0:
        _fail("data: (a) no data_wait phase in the trainer's report")
    return m["launches"]


def _data_http(rt, serve, engine_runs, smi):
    """(b): the LLM deployment behind the HTTP proxy, its replica a GPU
    worker process; returns the replica's launches and the proxy's port."""
    import statistics

    from ray_tpu_torch.serve.deployment import Application, Deployment
    from ray_tpu_torch.serve.llm import EngineConfig, llm_deployment

    prompts, engine_tokens, engine_ttft = engine_runs
    cfg = EngineConfig(page_tokens=DATA_LM_GEOMETRY["page_tokens"],
                       pool_pages=DATA_LM_GEOMETRY["num_pages"], max_new_tokens=DATA_NEW)
    t0 = time.perf_counter()
    base = llm_deployment(_data_lm, name="data-llm", engine_config=cfg,
                          model_kwargs=dict(seed=0, device="cuda", **DATA_LM_GEOMETRY),
                          ray_actor_options={"num_gpus": 1})
    app = Application(Deployment(_counted_llm_server(), base.deployment.name,
                                 base.deployment.config), base.init_args, base.init_kwargs)
    handle = serve.run(app, name="llm", http_port=0)
    from ray_tpu_torch.serve import handle as handle_mod

    port = handle_mod._proxy.port
    counters = handle.options(method_name="kernel_launches")
    _http_stream(port, "llm", [1, 2, 3, 4])  # warm-up
    up_s = time.perf_counter() - t0
    replica = counters.remote(True).result(timeout=DATA_TIMEOUT_S)
    http_tokens, http_ttft, per_chunk = [], [], True
    for p in prompts:
        status, t_sub, chunks = _http_stream(port, "llm", p)
        toks = [json.loads(c) for _, c in chunks]
        per_chunk &= status == 200 and all(isinstance(t, int) for t in toks)
        http_tokens.append(toks)
        http_ttft.append((chunks[0][0] - t_sub) * 1e3)
    launches = counters.remote(False).result(timeout=DATA_TIMEOUT_S)["launches"]
    stream = handle.options(stream=True)
    handle_tokens, handle_ttft = [], []
    for p in prompts:
        t_sub, toks = time.perf_counter(), []
        for tok in stream.remote(p):
            toks.append((time.perf_counter(), tok))
        handle_tokens.append([t for _, t in toks])
        handle_ttft.append((toks[0][0] - t_sub) * 1e3)
    print(f"[data] (b) {smi}: llm_deployment(PagedLM at llama2_7b width, {DATA_LM_LAYERS} layers, "
          f"bf16, seed 0) behind serve.run(http_port=0) on port {port}, the replica in worker "
          f"pid {replica['pid']} (CUDA_VISIBLE_DEVICES={replica['visible']!r}), up in "
          f"{up_s:.1f} s; {len(prompts)} prompts {[len(p) for p in prompts]}, {DATA_NEW} new "
          f"tokens each, read chunk by chunk: one token per chunk {per_chunk}; greedy tokens "
          f"equal to InferenceEngine's: HTTP "
          f"{sum(a == b for a, b in zip(http_tokens, engine_tokens))}/{len(prompts)}, handle "
          f"{sum(a == b for a, b in zip(handle_tokens, engine_tokens))}/{len(prompts)}; "
          f"launches in the replica's process over the HTTP requests {launches}", flush=True)
    print(f"[data] (b) {smi}: TTFT p50 over HTTP (first chunk) "
          f"{statistics.median(http_ttft):.1f} ms, through the handle "
          f"{statistics.median(handle_ttft):.1f} ms, InferenceEngine driven directly "
          f"{statistics.median(engine_ttft):.1f} ms (one request at a time)", flush=True)
    if replica["pid"] == os.getpid() or replica["visible"] != "0":
        _fail("data: (b) the replica is not a worker process that sees exactly device 0")
    if not per_chunk or http_tokens != engine_tokens or handle_tokens != engine_tokens:
        _fail(f"data: (b) tokens differ from the engine's: HTTP {http_tokens}, handle "
              f"{handle_tokens}, engine {engine_tokens}")
    if (launches["flash_fwd"] < DATA_LM_LAYERS * len(prompts) or launches["flash_bwd_dq"]
            or launches["flash_bwd_dkv"]):
        _fail(f"data: (b) the replica launched {launches}, want flash_fwd >= "
              f"{DATA_LM_LAYERS} x {len(prompts)} and no backward kernel")
    return launches, port


def _data_features(rt, serve, port, smi):
    """(c): a FeatureTable replica fed through a ChannelFeed, looked up over
    HTTP while it ingests."""
    import random
    import threading

    import numpy as np

    from ray_tpu_torch import data

    ds = data.range(DATA_FEATURES, parallelism=8).map_batches(_data_featurize)
    feed = ds.streaming_split(1).to_channel()[0]
    last = DATA_FEATURES - 1
    seen, stop = {}, threading.Event()

    def poll():
        """The last row's first sighting over HTTP, polled from before the
        deployment exists (404, then null, then the row)."""
        import urllib.error
        import urllib.request

        while not stop.is_set():
            req = urllib.request.Request(f"http://127.0.0.1:{port}/features",
                                         data=str(last).encode(),
                                         headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=DATA_TIMEOUT_S) as resp:
                    row = json.loads(resp.read())
            except urllib.error.HTTPError:
                row = None
            if row is not None:
                seen.update(t=time.time(), pc=time.perf_counter(), row=row)
                return
            time.sleep(0.002)

    poller = threading.Thread(target=poll, daemon=True, name="data-features-poll")
    poller.start()
    t0 = time.perf_counter()
    try:
        handle = serve.run(serve.deployment(_FeatureLookup).bind(feed), name="features",
                           http_port=0)
        poller.join(DATA_TIMEOUT_S)
    finally:
        stop.set()
    if "row" not in seen:
        _fail("data: (c) the last feature row never showed over HTTP")
    stats = handle.options(method_name="stats").remote().result(timeout=DATA_TIMEOUT_S)
    keys = sorted(random.Random(3).sample(range(DATA_FEATURES), DATA_LOOKUPS)) + [last]
    got = {k: _http_json(port, "features", k) for k in keys}
    missing = _http_json(port, "features", DATA_FEATURES + 7)
    want = {k: {"id": k, "feat": k * 0.5, "vec": [float(np.sin(k)), float(np.cos(k))]}
            for k in keys}
    exact = sum({c: v for c, v in got[k].items() if c != "t_feat"} == want[k] for k in keys)
    lag_s = seen["t"] - seen["row"]["t_feat"]
    print(f"[data] (c) {smi}: range({DATA_FEATURES}).map_batches(featurize) -> "
          f"streaming_split(1).to_channel() -> a FeatureTable replica (pid {stats['pid']}): "
          f"{stats['rows']} rows ingested in {stats['epochs_ingested']} epoch; {exact}/{len(keys)} "
          f"lookups over HTTP equal the dataset's rows, an unknown key -> {missing}; ingest lag "
          f"(row made -> first lookup that sees it) {lag_s * 1e3:.1f} ms; serve.run to that "
          f"lookup {seen['pc'] - t0:.2f} s", flush=True)
    if exact != len(keys) or missing is not None or stats["rows"] != DATA_FEATURES:
        _fail(f"data: (c) lookups {got} against {want}, unknown key {missing}, stats {stats}")


def phase_data():
    """Data and the rest of Serve on a fresh init() whose head leases GPU 0:
    (a) from_numpy tokens -> map_batches on an autoscaling actor pool ->
    TorchTrainer(datasets=, dataset_config="channel") with one GPU worker
    process training the fit phase's model: losses and params_sha256
    bitwise equal to the direct loop on the same rows, the rows exactly
    the dataset's, K1-K3 in the worker; (b) an LLM deployment (PagedLM at
    Llama-2-7B width, DATA_LM_LAYERS layers) behind serve.run(http_port=0),
    its replica a GPU worker: greedy tokens over HTTP, read chunk by chunk,
    equal to InferenceEngine's, K1 in the replica; (c) a FeatureTable
    replica fed through a ChannelFeed: lookups over HTTP exact, the ingest
    lag; nothing left after shutdown. Returns the launches of each path."""
    import gc
    import glob
    import random
    import statistics
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.runtime_base import current_runtime
    from ray_tpu_torch.serve.llm import EngineConfig, InferenceEngine

    phase_t0 = time.perf_counter()
    smi = _smi()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-data-")
    # Workers inherit the driver's environment: cuBLAS's workspace setting
    # makes the trainer worker's deterministic algorithms usable.
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    parts = {}
    t0 = time.perf_counter()
    rt.init()
    session_dir = current_runtime()._cluster.session_dir
    ours = f"/dev/shm/rtpt_{os.path.basename(session_dir)}"
    try:
        if rt.cluster_resources().get("GPU") != 1.0:
            _fail(f"data: cluster_resources {rt.cluster_resources()}")
        # The references first, in this process, while the zygote comes up.
        tokens = _data_source()
        direct = _data_direct(tokens["tokens"])
        rng = random.Random(1)
        prompts = [[rng.randrange(1, 32000) for _ in range(n)] for n in DATA_PROMPTS]
        eng = InferenceEngine(_data_lm(seed=0, device="cuda", **DATA_LM_GEOMETRY),
                              EngineConfig(page_tokens=DATA_LM_GEOMETRY["page_tokens"],
                                           pool_pages=DATA_LM_GEOMETRY["num_pages"],
                                           max_new_tokens=DATA_NEW), name="data-direct")
        try:
            list(eng.generate([1, 2, 3, 4], 2))  # warm-up
            engine_tokens, engine_ttft = [], []
            for p in prompts:
                t_sub, toks = time.perf_counter(), []
                for tok in eng.generate(p, DATA_NEW):
                    toks.append((time.perf_counter(), tok))
                engine_tokens.append([t for _, t in toks])
                engine_ttft.append((toks[0][0] - t_sub) * 1e3)
        finally:
            eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        parts["references"] = time.perf_counter() - t0
        parts["zygote"] = _warm_zygote(current_runtime(), "data")
        t0 = time.perf_counter()
        trainer_launches = _data_trainer(rt, tmp, tokens, direct, smi)
        parts["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        replica_launches, port = _data_http(rt, serve, (prompts, engine_tokens, engine_ttft),
                                            smi)
        parts["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _data_features(rt, serve, port, smi)
        parts["c"] = time.perf_counter() - t0
    finally:
        serve.shutdown()
        t0 = time.perf_counter()
        rt.shutdown()
        parts["shutdown"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    left = _cluster_processes(session_dir)
    pools = glob.glob(ours + "*")
    print(f"[data] (d) {smi}: parts {', '.join(f'({k}) {v:.1f} s' for k, v in parts.items())}; "
          f"processes left {left}, pools left {sorted(pools)}; phase "
          f"{time.perf_counter() - phase_t0:.1f} s", flush=True)
    if left or pools:
        _fail("data: processes or /dev/shm/rtpt_* pools outlived shutdown")
    return {"data trainer worker": trainer_launches, "data http replica": replica_launches}


OPERATE_TOL = 2 ** -6  # K1's per-entry bound at the serve shape (the kernel phase's)
OPERATE_TIMEOUT_S = 180
OPERATE_HB = {"RAY_TPU_HEARTBEAT_INTERVAL_S": "0.25", "RAY_TPU_HEARTBEAT_TIMEOUT_S": "1.5"}
# (a)'s job entrypoint, written to a file and run by the job supervisor: it
# attaches by address="auto" and runs one num_gpus=1 K1 task at the serve shape.
OPERATE_JOB = '''import json, os, time

t_script = time.perf_counter()
import ray_tpu_torch as rt  # noqa: E402 (torch loads in the task, not in this driver)

rt.init(address="auto")
init_s = time.perf_counter() - t_script


@rt.remote(num_gpus=1)
def k1(seed, shape):
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    fa.flash_fwd.launches = fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0
    t0 = time.perf_counter()
    o = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {"flash_fwd": fa.flash_fwd.launches, "flash_bwd_dq": fa.flash_bwd_dq.launches,
                "flash_bwd_dkv": fa.flash_bwd_dkv.launches}
    ref, _ = fa.reference_flash_fwd(q, k, v, causal=True, scale=q.shape[-1] ** -0.5)
    g, w = o.float(), ref.float()
    err = ((g - w).abs() / (w.abs() + w.pow(2).mean().sqrt())).max().item()
    return {"err": err, "launches": launches, "first_call_ms": ms, "pid": os.getpid(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}


t0 = time.perf_counter()
out = rt.get(k1.remote(SEED, SHAPE), timeout=300)
out["task_s"] = time.perf_counter() - t0
out["init_s"], out["script_s"] = init_s, time.perf_counter() - t_script
print("OPERATE_JOB " + json.dumps(out), flush=True)
rt.shutdown()
'''


def _operate_k1(seed: int):
    """(b)'s task on the replacement node: K1 at the serve shape against its
    plain version, its launches and the device ids it sees."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    _zero_launch_counts()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(CLUSTER_SERVE_SHAPE, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    o = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches = _launch_counts()
    ref, _ = fa.reference_flash_fwd(q, k, v, causal=True, scale=q.shape[-1] ** -0.5)
    return {"err": entry_err(o, ref), "launches": launches, "pid": os.getpid(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}


def _operate_cli(env, *args, timeout=OPERATE_TIMEOUT_S):
    """One `python -m ray_tpu_torch.scripts` command; a non-zero exit fails
    the phase with its output."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts", *args], cwd=root,
                         env=env, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        _fail(f"operate: `{' '.join(args[:2])}` exited {out.returncode}:\n"
              f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return out.stdout


def _operate_http(port: int, path: str, raw: bool = False):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        body = r.read()
    return body.decode() if raw else json.loads(body)


def _operate_cli_path(rt, tmp, smi, meanwhile):
    """(a): up, status, submit --wait, logs, the dashboard's routes, down;
    `meanwhile()` runs in this process after `status`, while the GPU node's
    zygote imports its device stack. Returns the job task's launches and
    what `meanwhile` returned."""
    import glob

    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard
    from ray_tpu_torch.utils import state

    env = dict(os.environ, HOME=tmp)
    env.pop("RAY_TPU_ADDRESS", None)
    config = os.path.join(tmp, "cluster.json")
    with open(config, "w") as f:
        json.dump({"cluster_name": "smoke-operate", "provider": {"type": "local"},
                   "head": {"num_cpus": 2, "num_gpus": 0},
                   "workers": {"count": 1, "cpus": 2, "gpus": 1}}, f)
    nums, session, down = {}, None, False
    t0 = time.perf_counter()
    up = _operate_cli(env, "up", config, "--timeout", "120")
    nums["up_cmd_s"] = time.perf_counter() - t0
    m = re.search(r"head \+ (\d+)/1 worker instances in ([\d.]+) s \(session dir: (\S+)\)", up)
    if not m or m.group(1) != "1":
        _fail(f"operate (a): `up` said {up!r}")
    nums["up_running_s"], session = float(m.group(2)), m.group(3)
    try:
        with open(os.path.join(session, "keeper.json")) as f:
            keeper = json.load(f)["pid"]
        status = _operate_cli(env, "status")
        if "nodes alive: 2" not in status or not re.search(r"^resources: .*GPU 1\b", status, re.M):
            _fail(f"operate (a): `status` said {status!r}")
        t0 = time.perf_counter()
        during = meanwhile()
        nums["meanwhile_s"] = time.perf_counter() - t0
        # This process attaches as a driver (init by session dir) for the
        # dashboard, and first waits for the GPU node's zygote to import the
        # flash op's device stack, so the job's task forks warm.
        rt.init(address=session)
        try:
            gpu = [n for n in state.list_nodes() if n["Alive"] and n["Resources"].get("GPU")]
            if len(gpu) != 1 or gpu[0]["Labels"].get("ray_tpu_cloud_id") != "local-1":
                _fail(f"operate (a): the GPU node's record {gpu}")
            nums["zygote_wait_s"] = _operate_warm_node(gpu[0]["sock"])
            job_file = os.path.join(tmp, "operate_job.py")
            with open(job_file, "w") as f:
                f.write(OPERATE_JOB.replace("SEED", "4242").replace(
                    "SHAPE", repr(tuple(CLUSTER_SERVE_SHAPE))))
            t0 = time.perf_counter()
            sub = _operate_cli(env, "submit", "--wait", "--timeout", "240", "--",
                               sys.executable, job_file, timeout=300)
            nums["submit_s"] = time.perf_counter() - t0
            job_id = re.search(r"submitted (\S+):", sub).group(1)
            line = next((ln for ln in sub.splitlines() if ln.startswith("OPERATE_JOB ")), None)
            if f"{job_id}: SUCCEEDED" not in sub or line is None:
                _fail(f"operate (a): `submit --wait` said {sub[-3000:]!r}")
            job = json.loads(line[len("OPERATE_JOB "):])
            logs = _operate_cli(env, "logs", job_id)
            if line not in logs.splitlines():
                _fail(f"operate (a): `logs {job_id}` lacks the job's line: {logs[-2000:]!r}")
            if (job["err"] > OPERATE_TOL or job["launches"]["flash_fwd"] != 1
                    or job["cuda_visible_devices"] != "0"):
                _fail(f"operate (a): the job's K1 task {job} (tol {OPERATE_TOL})")
            port = start_dashboard(port=0)
            try:
                jobs = _operate_http(port, "/api/jobs")
                nodes = _operate_http(port, "/api/nodes")
                metrics = _operate_http(port, "/metrics", raw=True)
                history = _operate_http(port, "/api/metrics_history?name=raytpu_gcs_rpc_total")
                alerts = _operate_http(port, "/api/alerts")
            finally:
                stop_dashboard()
            # The node's CPU share needs /proc/stat's totals to move between
            # two reads; where the machine's /proc/stat stands still it is
            # absent, and it is only reported here.
            want = ("raytpu_gcs_rpc_total{", "raytpu_node_mem_used_bytes{",
                    "raytpu_proc_rss_bytes{", "raytpu_proc_fd_count{")
            nums["cpu_gauge"] = "raytpu_node_cpu_percent{" in metrics
            labels = [n["Labels"] for n in nodes if n["Alive"] and n["Labels"]]
            if ([j["status"] for j in jobs if j["job_id"] == job_id] != ["SUCCEEDED"]
                    or len([n for n in nodes if n["Alive"]]) != 2
                    or len(labels) != 1 or labels[0].get("ray_tpu_cloud_id") != "local-1"
                    # the GPU node's slice: its host's NVLink domain (PR 22)
                    or not labels[0].get("slice_name")
                    or not all(w in metrics for w in want) or not history
                    or not isinstance(alerts, list)):
                _fail(f"operate (a): the dashboard read jobs {jobs}, nodes' labels {labels}, "
                      f"series {[w for w in want if w in metrics]}, history {len(history)} "
                      f"series, alerts {alerts}")
            nums["rpc_series"] = metrics.count("raytpu_gcs_rpc_total{")
        finally:
            rt.shutdown()
        t0 = time.perf_counter()
        _operate_cli(env, "down", config)
        down = True
        nums["down_s"] = time.perf_counter() - t0
    finally:
        if session is not None and not down:
            subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts", "down", config],
                           cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                           capture_output=True, timeout=OPERATE_TIMEOUT_S)
    left = _cluster_processes(session) + ([keeper] if _pid_alive(keeper) else [])
    pools = glob.glob(f"/dev/shm/rtpt_{os.path.basename(session)}*")
    if left or pools or os.path.exists(session):
        _fail(f"operate (a): after `down`, processes {left}, pools {pools}, session dir "
              f"{os.path.exists(session)}")
    print(f"[operate] (a) {smi}: `up` {nums['up_cmd_s']:.3f} s (head + 1 GPU node RAY_RUNNING "
          f"through its label {nums['up_running_s']:.3f} s); status 2 nodes, GPU 1; (b) and (c) "
          f"meanwhile {nums['meanwhile_s']:.1f} s, then the GPU node's zygote device stack "
          f"{nums['zygote_wait_s']:.3f} s more; `submit --wait` {nums['submit_s']:.3f} s -> SUCCEEDED (the entrypoint "
          f"{job['script_s']:.3f} s: attach {job['init_s']:.3f} s, the task {job['task_s']:.3f} "
          f"s), K1 "
          f"{job['err']:.4g} per entry (tol {OPERATE_TOL}), first call {job['first_call_ms']:.3f} "
          f"ms, launches {job['launches']} in pid {job['pid']}; the line in `logs`; dashboard "
          f"jobs/nodes/metrics ({nums['rpc_series']} raytpu_gcs_rpc_total series, the "
          f"reporter's memory, RSS and fd gauges, its CPU share "
          f"{'present' if nums['cpu_gauge'] else 'absent'})/history/alerts; `down` "
          f"{nums['down_s']:.3f} s, nothing left", flush=True)
    return job["launches"], during


def _operate_warm_node(sock: str) -> float:
    """Waits until the zygote of the node whose raylet serves `sock` has
    imported its device stack (as _warm_zygote does for the head); returns
    the seconds waited."""
    from ray_tpu_torch.core.rpc import RpcClient

    raylet = RpcClient(sock)
    try:
        t0 = time.perf_counter()
        while not raylet.call("zygote_stats").get("device_stack"):
            if time.perf_counter() - t0 > 120:
                _fail("operate (a): the GPU node's zygote never imported its device stack")
            time.sleep(0.05)
        return time.perf_counter() - t0
    finally:
        raylet.close()


def _pid_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            return f.read().rsplit(b")", 1)[1].split()[0] != b"Z"
    except (OSError, IndexError):
        return False


def _operate_replace(rt, smi):
    """(b): the v2 reconciler over a LocalNodeProvider on a head with no GPU
    brings a {"cpus": 2, "gpus": 1} node; its raylet is killed; the
    reconciler replaces the node and a K1 task runs on the replacement."""
    import glob

    from ray_tpu_torch.autoscaler_v2 import InstanceManager, LocalNodeProvider
    from ray_tpu_torch.core.runtime_base import current_runtime

    # A 0.25 s heartbeat and a 1.5 s timeout for this part's daemons, the
    # replacement raylet's included (each reads them at its start).
    saved = {k: os.environ.get(k) for k in OPERATE_HB}
    os.environ.update(OPERATE_HB)
    nums, session = {}, None
    try:
        rt.init(num_cpus=2, num_gpus=0)
        runtime = current_runtime()
        cluster, session = runtime._cluster, runtime._cluster.session_dir
        im = InstanceManager(LocalNodeProvider(cluster), gcs=runtime._gcs,
                             shape={"cpus": 2.0, "gpus": 1.0})
        im.set_target(1)
        t0 = time.perf_counter()
        if not im.wait_running(1, timeout=60.0):
            _fail(f"operate (b): the GPU node never reached RAY_RUNNING: {im.counts()}")
        nums["first_up_s"] = time.perf_counter() - t0
        (first,) = im.instances.values()
        cluster._procs[first.node_id].kill()  # the raylet alone: its node dies with it
        t_kill = time.perf_counter()
        dead = replaced = None
        while replaced is None:
            im.reconcile()
            if dead is None and first.status in ("TERMINATING", "TERMINATED"):
                dead = time.perf_counter() - t_kill
            running = [i for i in im.instances.values()
                       if i.status == "RAY_RUNNING" and i is not first]
            if running:
                replaced = time.perf_counter() - t_kill
                second = running[0]
            elif time.perf_counter() - t_kill > 90:
                _fail(f"operate (b): no replacement in 90 s: {im.counts()}")
            time.sleep(0.02)
        if rt.available_resources().get("GPU") != 1.0:
            _fail(f"operate (b): resources after the replacement {rt.available_resources()}")
        t0 = time.perf_counter()
        out = rt.get(rt.remote(num_gpus=1)(_operate_k1).remote(777), timeout=OPERATE_TIMEOUT_S)
        nums["k1_s"] = time.perf_counter() - t0
        node_of_task = {n["NodeID"] for n in rt.nodes() if n["Alive"] and n["Resources"].get("GPU")}
        if (out["err"] > OPERATE_TOL or out["launches"]["flash_fwd"] != 1
                or out["cuda_visible_devices"] != "0" or node_of_task != {second.node_id}):
            _fail(f"operate (b): the replacement's K1 task {out}, GPU nodes {node_of_task} "
                  f"(tol {OPERATE_TOL})")
        history = first.history + [first.status]
    finally:
        rt.shutdown()
        for k, v in saved.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    left = _cluster_processes(session)
    pools = glob.glob(f"/dev/shm/rtpt_{os.path.basename(session)}*")
    if left or pools:
        _fail(f"operate (b): processes {left} or pools {pools} outlived shutdown")
    print(f"[operate] (b) {smi}: GPU node RAY_RUNNING {nums['first_up_s']:.3f} s; raylet "
          f"killed -> instance terminated {dead:.3f} s -> replacement RAY_RUNNING "
          f"{replaced:.3f} s (history {history}); replacement -> first K1 result "
          f"{nums['k1_s']:.3f} s, {out['err']:.4g} per entry, launches {out['launches']} in "
          f"pid {out['pid']}; nothing left", flush=True)
    return out["launches"]


def _operate_glue(tmp, smi):
    """(c): in this process, which holds a CUDA context: the reporter's
    device gauge, a traced K1 call, the device memory snapshot."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.utils import internal_metrics as imet
    from ray_tpu_torch.utils import profiling

    gen = torch.Generator(device="cuda").manual_seed(99)
    q, k, v = (torch.randn(CLUSTER_SERVE_SHAPE, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    torch.cuda.synchronize()
    imet.ReporterAgent().collect_once()
    gauge, allocated = imet.DEVICE_MEM_USED.labels(device="0").read(), torch.cuda.memory_allocated(0)
    if gauge != allocated:
        _fail(f"operate (c): the device gauge {gauge} != memory_allocated(0) {allocated}")
    trace_dir = os.path.join(tmp, "trace")
    _zero_launch_counts()
    t0 = time.perf_counter()
    with profiling.device_trace(trace_dir):
        o = fa.flash_attention(q, k, v, causal=True)
    trace_s = time.perf_counter() - t0
    launches = _launch_counts()
    with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "flash_fwd" in e.get("name", "")]
    if not kernels or launches["flash_fwd"] != 1:
        _fail(f"operate (c): the trace names no flash_fwd kernel ({len(events)} events, "
              f"launches {launches})")
    ref, _ = fa.reference_flash_fwd(q, k, v, causal=True, scale=q.shape[-1] ** -0.5)
    err = entry_err(o, ref)
    snap = os.path.join(tmp, "device_memory.pickle")
    profiling.save_device_memory_profile(snap)
    size = os.path.getsize(snap)
    if err > OPERATE_TOL or size <= 0:
        _fail(f"operate (c): K1 {err:.4g} per entry, snapshot {size} bytes")
    print(f"[operate] (c) {smi}: raytpu_device_mem_used_bytes{{device=\"0\"}} {gauge:.0f} == "
          f"torch.cuda.memory_allocated(0); the trace ({trace_s:.3f} s) names "
          f"{kernels[0]['name'][:60]!r}, {kernels[0].get('dur')} us; K1 {err:.4g} per entry; "
          f"memory snapshot {size} bytes", flush=True)
    del q, k, v, o, ref
    torch.cuda.empty_cache()
    return launches


def phase_operate():
    """The operator surface and the device glue: (a) through the CLI with
    HOME at a temp dir: `up` a JSON config (the local provider; a head with
    no GPU and one worker of 2 CPUs and 1 GPU, which reaches RAY_RUNNING
    through its cloud-id label), `status` (2 nodes, GPU 1), `submit --wait`
    of an entrypoint that attaches with init(address="auto") and runs a
    num_gpus=1 K1 task at the serve shape against its plain version (the
    task forked warm: the phase waits for that node's zygote device stack),
    its line in `submit`'s output and in `logs`, the dashboard's /api/jobs,
    /api/nodes (the worker's label), /metrics (raytpu_gcs_rpc_total and the
    reporter's node gauges), /api/metrics_history and /api/alerts from this
    process attached by session dir, then `down`: no process of the session,
    no keeper, no pool; (b) and (c) run after `status`, while that zygote
    imports; (b) autoscaler_v2's InstanceManager over a
    LocalNodeProvider on init(num_gpus=0) brings a GPU node, its raylet is
    killed, the reconciler replaces it and a K1 task runs on the replacement
    (death -> replacement RAY_RUNNING -> first K1 result); (c) here, with a
    CUDA context: the reporter's device gauge equals
    torch.cuda.memory_allocated(0), one K1 call under profiling.device_trace
    leaves a trace naming the flash_fwd kernel, save_device_memory_profile
    writes a snapshot. Returns the launches of each path."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt

    phase_t0 = time.perf_counter()
    smi = _smi()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-operate-")
    part_s = {}

    def meanwhile():
        t0 = time.perf_counter()
        replaced = _operate_replace(rt, smi)
        part_s["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        traced = _operate_glue(tmp, smi)
        part_s["c"] = time.perf_counter() - t0
        return replaced, traced

    try:
        t0 = time.perf_counter()
        job_launches, (replace_launches, traced_launches) = _operate_cli_path(
            rt, tmp, smi, meanwhile)
        a_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[operate] {smi}: parts (a) {a_s:.1f} s with (b) {part_s['b']:.1f} s and (c) "
          f"{part_s['c']:.1f} s inside it; phase {time.perf_counter() - phase_t0:.1f} s",
          flush=True)
    return {"operate job task": job_launches, "operate replacement task": replace_launches,
            "operate traced call": traced_launches}


RL_TOL = 1e-5  # (a): losses (relative; absolute below 1) and each leaf (of its norm)
RL_UPDATES = 5  # (a): updates on the card and on the CPU from the same params
RL_PPO_BUDGET_S = 60.0  # (b): the PPO run's wall budget
RL_PPO_MAX_ITERS = 400
RL_PPO_WINDOW = 5  # (b): iterations in a windowed mean return
# (b): best windowed mean minus the first iteration's, at least. On one H100
# (700 W) the phase alone went from 14.5 to a best window of 467.4 in 109
# iterations (22 s); beside the main process the host runs fewer iterations
# in the budget, so the gate asks for under half of that rise.
RL_PPO_MARGIN = 200.0
RL_PPO_PRINT = 10  # (b): iterations per printed line
RL_DQN_ITERS = 6  # (c): 128 env steps each; learning from the third
RL_DQN_TARGET_EVERY = 128  # (c): updates between target syncs, two learning iterations
RL_SAC_ITERS = 4  # (c): 128 env steps each; learning from the third
RL_TIMEOUT_S = 30


def _rl_batch(kind, rng):
    """A seeded batch at the tuned examples' shapes: PPO's 256-row
    minibatch, IMPALA's 64 x 8 rollout, DQN's 128 rows, SAC's 256 (numpy)."""
    import numpy as np

    if kind == "impala":
        T, N = 64, 8
        dones = (rng.random((T, N)) < 0.05).astype(np.float32)
        mask = np.ones((T, N), np.float32)
        mask[1:][dones[:-1] > 0] = 0.0
        return {"obs": rng.normal(size=(T, N, 4)).astype(np.float32),
                "actions": rng.integers(0, 2, size=(T, N)),
                "logp": np.full((T, N), -0.69, np.float32)
                + 0.05 * rng.normal(size=(T, N)).astype(np.float32),
                "rewards": np.ones((T, N), np.float32), "dones": dones,
                "terminateds": dones, "mask": mask,
                "last_obs": rng.normal(size=(N, 4)).astype(np.float32)}
    if kind == "sac":
        B = 256
        return {"obs": rng.normal(size=(B, 3)).astype(np.float32),
                "actions": rng.uniform(-2, 2, size=(B, 1)).astype(np.float32),
                "rewards": -rng.uniform(0, 10, size=B).astype(np.float32),
                "next_obs": rng.normal(size=(B, 3)).astype(np.float32),
                "terminateds": np.zeros(B, np.float32)}
    B = 256 if kind == "ppo" else 128
    b = {"obs": rng.normal(size=(B, 4)).astype(np.float32), "actions": rng.integers(0, 2, B)}
    if kind == "ppo":
        b.update(logp=np.full(B, -0.69, np.float32) + 0.05 * rng.normal(size=B).astype(np.float32),
                 advantages=rng.normal(size=B).astype(np.float32),
                 returns=rng.normal(size=B).astype(np.float32) * 5,
                 mask=np.ones(B, np.float32))
    else:
        b["targets"] = rng.normal(size=B).astype(np.float32) * 3
    return b


def _rl_leaf_errs(got, want):
    """max |got - want| / ||want|| per leaf of two JAX-layout trees."""
    import numpy as np

    from ray_tpu_torch.models.convert import flatten

    (gp, gl), (wp, wl) = flatten(got), flatten(want)
    if gp != wp:
        _fail(f"rl: param trees differ in their paths {gp} / {wp}")
    return [float(np.max(np.abs(np.float64(g) - np.float64(w)))) / max(float(np.linalg.norm(w)),
                                                                        1e-30)
            for g, w in zip(gl, wl)]


def _rl_rel(got, want) -> float:
    return abs(got - want) / max(abs(want), 1.0)


def _rl_timed(fn):
    """(CUDA-event ms, host ms) of one call."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def _rl_parity(smi):
    """(a) RL_UPDATES updates of each learner on CUDA against the same on the
    CPU, from the same params and batches, TF32 off."""
    import functools

    import numpy as np
    import torch

    from ray_tpu_torch.models.convert import rl_params_to_numpy
    from ray_tpu_torch.rl import dqn, impala, module as rmod, ppo
    from ray_tpu_torch.rl.learner import TorchLearner
    from ray_tpu_torch.rl.sac import SACLearner, SquashedGaussianModule

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        disc = rmod.DiscretePolicyModule(rmod.DiscretePolicyConfig(obs_dim=4, n_actions=2,
                                                                   hidden=(64, 64)))
        qmod = dqn.QModule(rmod.DiscretePolicyConfig(obs_dim=4, n_actions=2, hidden=(64, 64)))
        cases = {
            "ppo_loss": (disc, functools.partial(ppo.ppo_loss, clip=0.2, vf_coeff=0.5,
                                                 ent_coeff=0.005), 3e-4, 0.5, "ppo"),
            "impala_loss+vtrace": (disc, functools.partial(
                impala.impala_loss, gamma=0.99, vf_coeff=0.5, ent_coeff=0.01), 5e-4, 1.0,
                "impala"),
            "dqn_loss": (qmod, dqn.dqn_loss, 1e-3, 10.0, "dqn"),
        }
        for i, (name, (module, loss, lr, clip, kind)) in enumerate(cases.items()):
            tree = rl_params_to_numpy(module.init_params(torch.Generator().manual_seed(i)))
            rng = np.random.default_rng(30 + i)
            batches = [_rl_batch(kind, rng) for _ in range(RL_UPDATES)]
            runs = {}
            for dev in ("cuda", "cpu"):
                learner = TorchLearner(module, loss, lr=lr, grad_clip=clip, device=dev)
                learner.set_weights(tree)
                runs[dev] = ([learner.update(b)["total_loss"] for b in batches], learner)
            loss_err = max(_rl_rel(g, w) for g, w in zip(runs["cuda"][0], runs["cpu"][0]))
            leaf_err = max(_rl_leaf_errs(runs["cuda"][1].get_weights(),
                                         runs["cpu"][1].get_weights()))
            ev_ms, host_ms = _rl_timed(lambda: runs["cuda"][1].update(batches[0]))
            print(f"[rl] (a) {smi}: {name}, {RL_UPDATES} updates on cuda vs cpu: losses "
                  f"{runs['cuda'][0][0]:.6f} .. {runs['cuda'][0][-1]:.6f}, max rel err "
                  f"{loss_err:.3e}, max leaf err {leaf_err:.3e} of its norm (tol {RL_TOL}); one "
                  f"update {ev_ms:.3f} ms by CUDA events, {host_ms:.3f} ms host", flush=True)
            if not loss_err <= RL_TOL or not leaf_err <= RL_TOL:
                _fail(f"rl: {name} on the card left the CPU's trajectory")

        module = SquashedGaussianModule(3, 1, hidden=(256, 256), low=-2.0, high=2.0)
        tree = rl_params_to_numpy(module.init_params(torch.Generator().manual_seed(7)))
        target = {"q1": tree["q1"], "q2": tree["q2"]}
        rng = np.random.default_rng(40)
        batches = [_rl_batch("sac", rng) for _ in range(RL_UPDATES)]
        noises = [{k: rng.normal(size=(256, 1)).astype(np.float32) for k in ("next", "pi")}
                  for _ in range(RL_UPDATES)]
        runs = {}
        for dev in ("cuda", "cpu"):
            learner = SACLearner(module, gamma=0.99, tau=0.005, actor_lr=3e-4, critic_lr=3e-4,
                                 alpha_lr=3e-4, target_entropy=-1.0, seed=0, device=dev)
            learner.load(tree, target)
            metrics = [learner.update(b, noise=n) for b, n in zip(batches, noises)]
            runs[dev] = ([{k: float(v) for k, v in m.items()} for m in metrics], learner)
        loss_err = max(_rl_rel(g[k], w[k]) for g, w in zip(runs["cuda"][0], runs["cpu"][0])
                       for k in ("q_loss", "pi_loss", "alpha_loss"))
        got, want = runs["cuda"][1].state(), runs["cpu"][1].state()
        leaf_err = max(_rl_leaf_errs(got["params"], want["params"])
                       + _rl_leaf_errs(got["target_q"], want["target_q"]))
        ev_ms, host_ms = _rl_timed(lambda: runs["cuda"][1].update(batches[0], noise=noises[0]))
        print(f"[rl] (a) {smi}: SAC's update (256, 256), {RL_UPDATES} updates with the same "
              f"noise on cuda vs cpu: q_loss {runs['cuda'][0][-1]['q_loss']:.6f}, max rel err of "
              f"q/pi/alpha losses {loss_err:.3e}, max leaf err {leaf_err:.3e} of its norm (tol "
              f"{RL_TOL}); one update {ev_ms:.3f} ms by CUDA events, {host_ms:.3f} ms host",
              flush=True)
        if not loss_err <= RL_TOL or not leaf_err <= RL_TOL:
            _fail("rl: SAC's update on the card left the CPU's trajectory")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _rl_env_steps(state) -> float:
    return sum(m["value"] for m in state.internal_metrics()
               if m["name"] == "raytpu_rl_env_steps_total")


def _rl_ppo(smi, state):
    """(b) the ppo_cartpole tuned example on this cluster, the learner on
    cuda:0 here, for RL_PPO_BUDGET_S (or until its 475 target)."""
    import numpy as np

    from ray_tpu_torch.rl.tuned_examples import REGRESSIONS

    spec = REGRESSIONS["ppo_cartpole"]
    t0 = time.perf_counter()
    algo = spec.build()
    build_s = time.perf_counter() - t0
    devices = {str(p.device) for p in algo.learner_group._learner.params.parameters()}
    if devices != {"cuda:0"}:
        _fail(f"rl: the PPO learner's params are on {devices}, not cuda:0")
    rows, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < RL_PPO_BUDGET_S and len(rows) < RL_PPO_MAX_ITERS:
        t_it = time.perf_counter()
        r = algo.train()
        r["wall_s"] = time.perf_counter() - t_it
        if not all(np.isfinite(r[k]) for k in ("total_loss", "policy_loss", "vf_loss")):
            _fail(f"rl: PPO iteration {r['iteration']} gave a loss that is not finite: {r}")
        rows.append(r)
        returns = [x["episode_return_mean"] for x in rows[-RL_PPO_WINDOW:]]
        if len(returns) == RL_PPO_WINDOW and np.nanmean(returns) >= spec.target_return:
            break
    run_s = time.perf_counter() - t0
    for i in range(0, len(rows), RL_PPO_PRINT):
        part = rows[i:i + RL_PPO_PRINT]

        def col(key, fmt):
            return " ".join(format(x[key], fmt) for x in part)

        print(f"[rl] (b) {smi}: iterations {i + 1}-{i + len(part)}: sample s {col('sample_s', '.3f')}"
              f"; learn s {col('learn_s', '.3f')}; sync s {col('sync_s', '.3f')}; env steps/s "
              + " ".join(f"{x['num_env_steps_sampled'] / x['wall_s']:.0f}" for x in part)
              + f"; episode_return_mean {col('episode_return_mean', '.1f')}", flush=True)
    # An iteration in which no episode ended has no mean return (NaN).
    returns = [x["episode_return_mean"] for x in rows if np.isfinite(x["episode_return_mean"])]
    if len(returns) < RL_PPO_WINDOW:
        _fail(f"rl: PPO ran {len(rows)} iterations, {len(returns)} with a mean return")
    first = returns[0]
    best = float(max(np.mean(returns[i:i + RL_PPO_WINDOW])
                     for i in range(len(returns) - RL_PPO_WINDOW + 1)))
    steps = sum(x["num_env_steps_sampled"] for x in rows)
    deadline = time.monotonic() + RL_TIMEOUT_S
    while (counted := _rl_env_steps(state)) != steps and time.monotonic() < deadline:
        time.sleep(0.25)
    print(f"[rl] (b) {smi}: ppo_cartpole (2 env-runner actors x 8 envs, rollout 64, the learner "
          f"on cuda:0): build {build_s:.1f} s, {len(rows)} iterations, {steps} env steps in "
          f"{run_s:.1f} s ({steps / run_s:.0f} steps/s); first iteration's mean return "
          f"{first:.1f}, best mean of {RL_PPO_WINDOW} iterations {best:.1f} (margin "
          f"{RL_PPO_MARGIN}); raytpu_rl_env_steps_total {counted:.0f}", flush=True)
    if not best >= first + RL_PPO_MARGIN:
        _fail(f"rl: PPO's best windowed mean return {best:.1f} does not clear the first "
              f"iteration's {first:.1f} by {RL_PPO_MARGIN}")
    if counted != steps:
        _fail(f"rl: the runners counted {counted} env steps, PPO sampled {steps}")


def _rl_dqn(smi):
    """(c) DQN at the dqn_cartpole example's widths: the target network
    equals the learner's weights after every RL_DQN_TARGET_EVERY updates and
    holds still in between."""
    import numpy as np

    from ray_tpu_torch.models.convert import rl_params_to_numpy
    from ray_tpu_torch.rl.dqn import DQNConfig
    from ray_tpu_torch.rl.learner import batch_to_device

    algo = DQNConfig(env="CartPole-v1", buffer_capacity=100_000, train_batch_size=128,
                     updates_per_iteration=64, target_update_freq=RL_DQN_TARGET_EVERY,
                     learning_starts=256, epsilon_decay_steps=20_000, lr=1e-3).build()
    target = rl_params_to_numpy(algo.target_params)["q"]
    syncs = 0
    for _ in range(RL_DQN_ITERS):
        r = algo.train()
        now = rl_params_to_numpy(algo.target_params)["q"]
        online = algo.learner_group.get_weights()["q"]
        if r["num_updates"] and not np.isfinite(r["td_error_mean"]):
            _fail(f"rl: DQN's TD error is not finite: {r}")
        synced = r["num_updates"] > 0 and r["num_updates"] % RL_DQN_TARGET_EVERY == 0
        want = online if synced else target
        if max(_rl_leaf_errs(now, want)) != 0.0:
            _fail(f"rl: DQN's target after {r['num_updates']} updates is not "
                  f"{'the learner' if synced else 'the previous target'}")
        if synced:
            syncs += 1
        elif r["num_updates"] and max(_rl_leaf_errs(now, online)) == 0.0:
            _fail("rl: DQN's target followed the learner between syncs")
        target = now
    batch = batch_to_device(algo.buffer.sample(128), algo.device)
    batch["targets"] = algo._compute_targets(algo.target_params, algo.target_params, batch)
    ms = _time_ms(lambda: algo.learner_group.update(batch), iters=20, warmup=3)
    print(f"[rl] (c) {smi}: DQN (64, 64) on cuda, {RL_DQN_ITERS} iterations, "
          f"{r['num_updates']} updates, {syncs} target syncs every {RL_DQN_TARGET_EVERY}, "
          f"td_error_mean {r['td_error_mean']:.4f}, epsilon {r['epsilon']:.3f}; one update "
          f"(128 rows) {ms:.3f} ms", flush=True)
    if syncs < 1:
        _fail("rl: DQN's target never synced")


def _rl_sac(smi):
    """(c) SAC at the sac_pendulum example's widths (256, 256): finite
    losses, and one update's targets exactly (1 - tau) t + tau q."""
    import numpy as np
    import torch

    from ray_tpu_torch.rl.sac import SACConfig

    algo = SACConfig(env="Pendulum-v1", learning_starts=256).build()
    for _ in range(RL_SAC_ITERS):
        r = algo.train()
    if not r["num_updates"] or not all(np.isfinite(r[k]) for k in ("q_loss", "pi_loss")):
        _fail(f"rl: SAC's losses are not finite or it did not learn: {r}")
    lrn = algo.learner
    before = [t.detach().clone() for t in lrn.target_q.parameters()]
    lrn.update(algo.buffer.sample(256))
    online = [*lrn.params.q1.parameters(), *lrn.params.q2.parameters()]
    tau = algo.config.tau
    with torch.no_grad():
        err = max(float(torch.max(torch.abs(t - ((1 - tau) * b + tau * o)))
                        / torch.linalg.vector_norm(t))
                  for t, b, o in zip(lrn.target_q.parameters(), before, online))
        moved = min(float(torch.max(torch.abs(t - b)))
                    for t, b in zip(lrn.target_q.parameters(), before))
    batch = algo.buffer.sample(256)
    ms = _time_ms(lambda: lrn.update(batch), iters=20, warmup=3)
    print(f"[rl] (c) {smi}: SAC (256, 256) on cuda, {RL_SAC_ITERS} iterations, "
          f"{r['num_updates']} updates, q_loss {r['q_loss']:.4f}, pi_loss {r['pi_loss']:.4f}, "
          f"alpha {r['alpha']:.4f}; the polyak target within {err:.2e} of its norm of "
          f"(1 - {tau}) t + {tau} q, each leaf moved (min max-step {moved:.2e}); one update "
          f"(256 rows) {ms:.3f} ms", flush=True)
    if not err <= 1e-6 or not moved > 0:
        _fail("rl: SAC's targets did not move as tau says")


def phase_rl():
    """RL on the card: (a) the learner's update on CUDA against the CPU from
    the same params and batches (PPO, IMPALA with V-trace, DQN, and SAC's
    update with the same noise), TF32 off: losses and every leaf within
    1e-5; (b) on a fresh init() whose head leases GPU 0, the ppo_cartpole
    tuned example (2 env-runner actors x 8 envs on the CPU, rollout 64) with
    its learner on cuda:0 in this process for RL_PPO_BUDGET_S: each
    iteration's sample / learn / sync seconds, env steps/s and mean return,
    the learner's params on CUDA, finite losses, the best windowed mean
    return RL_PPO_MARGIN above the first iteration's, the runners'
    raytpu_rl_env_steps_total equal to the steps sampled; (c) DQN on
    CartPole and SAC on Pendulum on that cluster, learners on CUDA: finite
    losses, the target network synced every target_update_freq updates and
    still between, SAC's polyak targets as tau says, update ms; nothing
    left after shutdown. RL runs no flash kernel: the path's launches are 0.
    Returns them."""
    import glob

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.runtime_base import current_runtime
    from ray_tpu_torch.utils import state

    phase_t0 = time.perf_counter()
    smi = _smi()
    parts = {}
    t0 = time.perf_counter()
    _rl_parity(smi)
    parts["a"] = time.perf_counter() - t0
    _zero_launch_counts()
    t0 = time.perf_counter()
    rt.init()
    session_dir = current_runtime()._cluster.session_dir
    ours = f"/dev/shm/rtpt_{os.path.basename(session_dir)}"
    try:
        if rt.cluster_resources().get("GPU") != 1.0:
            _fail(f"rl: cluster_resources {rt.cluster_resources()}")
        _rl_ppo(smi, state)
        parts["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _rl_dqn(smi)
        _rl_sac(smi)
        parts["c"] = time.perf_counter() - t0
    finally:
        t0 = time.perf_counter()
        rt.shutdown()
        parts["shutdown"] = time.perf_counter() - t0
    launches = _launch_counts()
    left = _cluster_processes(session_dir)
    pools = glob.glob(ours + "*")
    print(f"[rl] {smi}: parts {', '.join(f'({k}) {v:.1f} s' for k, v in parts.items())}; "
          f"launches {launches}; processes left {left}, pools left {sorted(pools)}; phase "
          f"{time.perf_counter() - phase_t0:.1f} s", flush=True)
    if left or pools:
        _fail("rl: processes or /dev/shm/rtpt_* pools outlived shutdown")
    if any(launches.values()):
        _fail(f"rl: the RL path launched flash kernels: {launches}")
    return {"rl": launches}



# ------------------------------------------------------------------ lanes
# The phases below run in a second process of this script beside the main
# one, which goes on with the rest once the kernels are timed (the kernel and
# gptj phases run alone). Each starts its own cluster and waits on processes
# starting, heartbeats and deadlines more than on the card: one after the
# other, the smoke's 23 phases took 1000-1360 s of its 1200 s limit on one
# H100 (PERF.md, section 5). The second process waits for the main one's
# parallel phase (4 ranks of ~14 GiB) to end before LANE_AFTER_PARALLEL, so
# that the two never hold more than the card's memory at once; its own
# earlier phases hold a few GiB.
# ---------------------------------------------------------------- shards
SHARDS_NODES = 1000  # stub raylets
SHARDS_THREADS = 32  # client threads they are multiplexed over
SHARDS_BATCH = 125  # (a): nodes per register_nodes call
SHARDS_HB_ROUNDS = 3
SHARDS_ENV = {"RAY_TPU_GCS_SNAPSHOT_INTERVAL_S": "3600",  # (d): the log alone
              # Stub raylets beat only in (c): no node may expire meanwhile.
              "RAY_TPU_HEARTBEAT_TIMEOUT_S": "3600"}
SHARDS_TIMEOUT_S = 120


def _shards_gcs(tmp: str, tag: str, shards: int):
    """A GCS daemon with `shards` shards on <tmp>/<tag>.sock, its snapshot
    and logs beside it; (process, client, snapshot path)."""
    from ray_tpu_torch.core.cluster_runtime import _spawn_daemon
    from ray_tpu_torch.core.rpc import RpcClient

    sock = os.path.join(tmp, f"{tag}.sock")
    snap = os.path.join(tmp, f"{tag}.snapshot")
    proc = _spawn_daemon(tmp, [sys.executable, "-m", "ray_tpu_torch.core.gcs", sock, snap], tag,
                         {**SHARDS_ENV, "RAY_TPU_GCS_SHARDS": str(shards)})
    return proc, RpcClient(sock, connect_timeout=SHARDS_TIMEOUT_S), snap


def _shards_storm(sock: str, jobs, fn):
    """Runs fn(client, job) for every job over SHARDS_THREADS threads, each
    with its own client; (results in job order, wall seconds)."""
    import concurrent.futures
    import threading

    from ray_tpu_torch.core.rpc import RpcClient

    local = threading.local()

    def run(job):
        cli = getattr(local, "cli", None)
        if cli is None:
            cli = local.cli = RpcClient(sock)
        return fn(cli, job)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(SHARDS_THREADS) as pool:
        out = list(pool.map(run, jobs))
    return out, time.perf_counter() - t0


def _hist_quantile(counts, boundaries, q: float) -> float:
    """The upper bound of the bucket that holds quantile q."""
    want, seen = q * sum(counts), 0
    for i, n in enumerate(counts):
        seen += n
        if n and seen >= want:
            return boundaries[i] if i < len(boundaries) else float("inf")
    return float("nan")


def phase_shards():
    """The sharded GCS under 1000 stub raylets (host figures; correctness
    asserted, no speed). Returns the launches of each path: none."""
    import shutil
    import signal
    import tempfile

    from ray_tpu_torch.core.heartbeat import HeartbeatCodec

    phase_t0 = time.perf_counter()
    smi = _smi()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-shards-")
    procs = []
    node_ids = [f"stub{i:04d}" + os.urandom(10).hex() for i in range(SHARDS_NODES)]
    specs = [{"node_id": nid, "sock": os.path.join(tmp, f"raylet_{nid}.sock"),
              "store": f"/dev/shm/stub_{nid}", "resources": {"CPU": 8.0, "GPU": 1.0},
              "labels": {"stub": "1"}} for nid in node_ids]
    try:
        # (a) register_nodes in batches of 125, 8 shards.
        proc, gcs8, snap8 = _shards_gcs(tmp, "gcs8", 8)
        procs.append(proc)
        batches = [specs[i:i + SHARDS_BATCH] for i in range(0, SHARDS_NODES, SHARDS_BATCH)]
        got, batch_s = _shards_storm(gcs8.path, batches,
                                     lambda cli, b: cli.call("register_nodes", b))
        epochs = {s["node_id"]: r["epoch"] for b, rs in zip(batches, got) for s, r in zip(b, rs)}
        # (b) one register_node at a time, a fresh GCS at 1 shard.
        proc1, gcs1, _ = _shards_gcs(tmp, "gcs1", 1)
        procs.append(proc1)
        single, single_s = _shards_storm(
            gcs1.path, specs, lambda cli, sp: cli.call(
                "register_node", sp["node_id"], sp["sock"], sp["store"], sp["resources"],
                sp["labels"]))
        one_ok = (all(r["ok"] and r["epoch"] == 1 for r in single)
                  and gcs1.call("node_summary")["alive"] == SHARDS_NODES)
        gcs1.call("stop")
        # (c) heartbeat rounds through the delta codec, against (a)'s GCS.
        codecs = {nid: HeartbeatCodec() for nid in node_ids}
        slices = [node_ids[i::SHARDS_THREADS] for i in range(SHARDS_THREADS)]

        def beat_round(cli, nids, rnd):
            rtts = []
            for nid in nids:
                avail, stats = codecs[nid].encode(
                    {"CPU": 8.0 - rnd, "GPU": 1.0},
                    {"bytes_in_use": 1 << 20, "num_workers": rnd, "wall_ts": time.time()})
                t0 = time.perf_counter()
                r = cli.call("heartbeat", nid, avail, stats, epochs[nid])
                rtts.append(time.perf_counter() - t0)
                if not r["ok"]:
                    raise RuntimeError(f"heartbeat of {nid} refused: {r}")
            return rtts

        rtts = []
        for rnd in range(SHARDS_HB_ROUNDS):
            out, _ = _shards_storm(gcs8.path, slices,
                                   lambda cli, nids, rnd=rnd: beat_round(cli, nids, rnd))
            rtts.extend(x for part in out for x in part)
        rtts.sort()
        hb_p50, hb_p99 = rtts[len(rtts) // 2] * 1e3, rtts[int(0.99 * len(rtts))] * 1e3
        summary = gcs8.call("node_summary")
        time.sleep(1.5)  # the daemon's own metrics flush once a second
        waits = [m for m in gcs8.call("internal_metrics")
                 if m["name"] == "raytpu_gcs_shard_lock_wait_ms"]
        bounds = waits[0]["boundaries"] if waits else []
        counts = [sum(c) for c in zip(*(m["counts"] for m in waits))] if waits else []
        wait_n, wait_p99 = sum(counts), _hist_quantile(counts, bounds, 0.99)
        shards_seen = sorted(int(m["tags"]["shard"]) for m in waits)
        # (d) kill -9 and a restart from the log segments alone.
        segments = sorted(f for f in os.listdir(tmp) if f.startswith("gcs8.snapshot.wal.s"))
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
        gcs8.close()
        t0 = time.perf_counter()
        proc2, gcs8b, _ = _shards_gcs(tmp, "gcs8", 8)
        procs.append(proc2)
        gcs8b.call("ping")
        restart_s = time.perf_counter() - t0
        back = {n["NodeID"]: n["Epoch"] for n in gcs8b.call("list_nodes")}
        after = gcs8b.call("node_summary")
        gcs8b.call("stop")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    regs_a, regs_b = SHARDS_NODES / batch_s, SHARDS_NODES / single_s
    print(f"[shards] {smi}: {SHARDS_NODES} stub raylets over {SHARDS_THREADS} client threads; "
          f"(a) register_nodes in batches of {SHARDS_BATCH} at 8 shards: {regs_a:.0f} "
          f"registrations/s ({batch_s:.3f} s), alive {summary['alive']}; (b) one register_node "
          f"at a time at 1 shard: {regs_b:.0f} registrations/s ({single_s:.3f} s), all at epoch "
          f"1 {one_ok}; (c) {SHARDS_HB_ROUNDS} heartbeat rounds through the delta codec: RTT p50 "
          f"{hb_p50:.3f} ms, p99 {hb_p99:.3f} ms over {len(rtts)} beats; "
          f"raytpu_gcs_shard_lock_wait_ms count {wait_n}, p99 <= {wait_p99} ms over shards "
          f"{shards_seen}; (d) kill -9 and a restart from {len(segments)} log segments alone: "
          f"{restart_s:.3f} s to its first answer, {len(back)} nodes back, every epoch equal "
          f"{back == epochs}, alive {after['alive']}; phase {time.perf_counter() - phase_t0:.1f} s "
          f"(host figures)", flush=True)
    if len(epochs) != SHARDS_NODES or set(epochs.values()) != {1} or summary["alive"] != SHARDS_NODES:
        _fail("shards: (a) not every node registered once through register_nodes")
    if not one_ok:
        _fail("shards: (b) not every node registered once at 1 shard")
    if len(segments) != 8 or back != epochs or after["alive"] != SHARDS_NODES:
        _fail("shards: (d) the restarted GCS did not replay every node's epoch from its 8 "
              "segments")
    if shards_seen != list(range(8)) or not wait_n:
        _fail(f"shards: raytpu_gcs_shard_lock_wait_ms was not reported for every shard "
              f"({shards_seen})")
    return {}


# ------------------------------------------------------------------- gang

# Three labelled 2-host GPU slices on the one card (each host leases device
# 0), and two 2-rank gloo TorchTrainers placed by SLICE_GANG at once, on
# Llama-2-7B's width in fp32 at depth 1 (_cluster_data_cfg, as the cluster
# phase's data=2 trainer and elastic (b)): one uninterrupted, one whose
# member's host is killed once its rank 0 has finished GANG_KILL_AT steps.
# Rank 0 checkpoints after step 0 only (two 5.6 GB checkpoints would be held
# per run otherwise); the trainer has persisted it by the end of step 2, so
# the resumed attempt always starts from it.
GANG_SLICES = ("gang-slice-a", "gang-slice-b", "gang-slice-c")
GANG_STEPS = 4
GANG_KILL_AT = 3
GANG_TIMEOUT_S = 300


def _gang_wait(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            _fail(f"gang: {what} did not happen in {timeout_s:.0f} s")
        time.sleep(0.05)


def _gang_loop(config):
    """One rank of the gang's gloo world on its slice host's card: the
    data-parallel step on the global batch, deterministic, TF32 off; rank 0
    checkpoints after step 0 (restored from train.get_checkpoint()), marks
    each finished step in config["scratch"] with its slice's name,
    and its last report carries the record: each step's loss, and each
    attempt's ranks' slices, pid, launches and the wall time of each of its
    steps, with params_sha256."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import transformer as tfm

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = train.get_context().get_world_rank(), train.get_context().get_world_size()
    device = _worker_device()
    cfg = _cluster_data_cfg()
    init, step = tfm.build_train_step(cfg, tfm.adamw(config["lr"]), device=device,
                                      mesh=train.get_mesh())
    params, opt = init(torch.Generator(device=device).manual_seed(0))
    local = _local_tree(params, opt)
    record, start, ck = {"losses": [], "attempts": []}, 0, train.get_checkpoint()
    if ck is not None:
        last, meta = _restore_state(ck.path, local, opt)
        record, start = meta["record"], last + 1
    slices = [None] * world
    dist.all_gather_object(slices, [os.environ.get("RAY_TPU_SLICE_NAME"),
                                    os.environ.get("RAY_TPU_SLICE_WORKER_ID")])
    attempt = {"slices": slices, "pid": os.getpid(), "step_t": []}
    record["attempts"].append(attempt)
    _zero_launch_counts()
    sources = {}
    for i in range(start, config["steps"]):
        loss = step(params, opt, _cluster_data_batch(i, cfg.vocab_size)).item()
        record["losses"].append([i, loss])
        attempt["step_t"].append([i, time.time()])
        attempt["launches"] = _launch_counts()
        ckpt = None
        if rank == 0 and i == 0:
            sources[i] = _save_state(config["scratch"], local, opt, i, record)
            ckpt = train.Checkpoint(sources[i])
        metrics = {"step": i, "loss": loss}
        if i == config["steps"] - 1:
            metrics["record"] = record
            metrics["params_sha256"] = _params_sha256(local)
        train.report(metrics, checkpoint=ckpt)
        if rank == 0:  # the step's marker names the gang's slice
            with open(os.path.join(config["scratch"], f"step_{i}"), "w") as f:
                f.write(os.environ.get("RAY_TPU_SLICE_NAME") or "")
        _drop_copied(sources, i)


def _gang_fit(tmp, name, max_failures):
    """The gang's TorchTrainer.fit() (its Result, seconds) with its own
    scratch dir for markers and checkpoints."""
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig, RunConfig,
                                     ScalingConfig, TorchBackendConfig, TorchTrainer)

    scratch = os.path.join(tmp, f"{name}_scratch")
    os.makedirs(scratch)
    trainer = TorchTrainer(
        _gang_loop, train_loop_config={"lr": 1e-4, "steps": GANG_STEPS, "scratch": scratch},
        scaling_config=ScalingConfig(num_workers=2, mesh=MeshSpec(data=-1),
                                     backend=TorchBackendConfig(backend="gloo"),
                                     resources_per_worker={"CPU": 1.0, "GPU": 1.0},
                                     placement_strategy="SLICE_GANG"),
        run_config=RunConfig(name=name, storage_path=tmp,
                             failure_config=FailureConfig(max_failures=max_failures),
                             checkpoint_config=CheckpointConfig(num_to_keep=1)))
    t0 = time.perf_counter()
    result = trainer.fit()
    if result.error is not None:
        _fail(f"gang: the {name} run failed: {result.error!r}")
    return result, time.perf_counter() - t0, scratch


def _gang_boot_seconds(cluster):
    """The slice detection's cost: one `nvidia-smi -q` read by
    detect_slice_spec, and add_node's seconds for a GPU node that detects
    its slice (the session's first: it reads the report), one that reads the
    first one's answer, and one given a slice label (no detection). The
    nodes are removed again: each is a one-host slice of its own."""
    import tempfile

    from ray_tpu_torch.accelerators.gpu import GpuAcceleratorManager

    out = {}
    t0 = time.perf_counter()
    GpuAcceleratorManager().detect_slice_spec(1)
    out["nvidia-smi -q read"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        GpuAcceleratorManager().detect_slice_spec(1, cache_dir=d)
        t0 = time.perf_counter()
        GpuAcceleratorManager().detect_slice_spec(1, cache_dir=d)
        out["cached read"] = time.perf_counter() - t0
    for what, labels in (("add_node detecting", None), ("add_node cached", None),
                         ("add_node labelled", {"slice_name": "gang-boot", "worker_index": 0})):
        t0 = time.perf_counter()
        nid = cluster.add_node(num_cpus=1, num_gpus=1, labels=labels)
        out[what] = time.perf_counter() - t0
        cluster.remove_node(nid)
    return out


def _gang_groups(runtime, hosts):
    """The CREATED SLICE_GANG groups: id -> (the slices of their hosts,
    their placements)."""
    return {gid: ({hosts.get(n) for n in pg["placements"]}, pg["placements"])
            for gid, pg in runtime.placement_group_table().items()
            if pg["strategy"] == "SLICE_GANG" and pg["state"] == "CREATED"}


def _gang_pg(runtime, state="CREATED"):
    """The one SLICE_GANG group in `state`, or None."""
    found = [pg for pg in runtime.placement_group_table().values()
             if pg["strategy"] == "SLICE_GANG" and pg["state"] == state]
    return found[0] if len(found) == 1 else None


def _gang_k1(seed: int):
    """The pending gang's task in bundle 0: K1 at the serve shape against
    its plain version, its launches, and the slice it sees."""
    out = _operate_k1(seed)
    out["slice"] = [os.environ.get("RAY_TPU_SLICE_NAME"),
                    os.environ.get("RAY_TPU_SLICE_WORKER_ID")]
    return out


def phase_gang():
    """SLICE_GANG on GPU slices (init() with a head leasing no GPU): first the
    slice detection's cost (_gang_boot_seconds); (a) three labelled 2-host
    slices on the card and two 2-rank gloo TorchTrainers placed by
    SLICE_GANG at once, one uninterrupted, one with max_failures=1 whose
    member's host is killed after GANG_KILL_AT steps: that gang co-fails
    and moves whole to another slice, and the resumed run's losses and
    params_sha256 must equal the uninterrupted run's bitwise; (b) with the
    slices gone, a pending gang gets a slice from Autoscaler(
    LocalGPUSliceProvider) and runs K1 in bundle 0 (<= 2^-6 per entry
    against its plain version). Seconds: kill -> gang CREATED on another
    slice -> first fresh step; pending -> slice up -> K1 result. Returns
    the launches of each path."""
    import glob
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import Autoscaler, LocalGPUSliceProvider
    from ray_tpu_torch.core.placement_group import (PlacementGroupSchedulingStrategy,
                                                    placement_group, remove_placement_group)
    from ray_tpu_torch.core.runtime_base import current_runtime

    phase_t0 = time.perf_counter()
    smi = _smi()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-gang-",
                           dir="/dev/shm" if os.path.isdir("/dev/shm") else None)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    rt.init(num_cpus=8, num_gpus=0)
    runtime = current_runtime()
    cluster = runtime._cluster
    session_dir = cluster.session_dir
    launches = {}
    try:
        boot_s = _gang_boot_seconds(cluster)
        print(f"[gang] {smi}: slice detection, seconds: "
              + ", ".join(f"{k} {v:.4f}" for k, v in boot_s.items()), flush=True)
        hosts = {cluster.add_node(num_cpus=2, num_gpus=1,
                                  labels={"slice_name": sl, "worker_index": w}): sl
                 for sl in GANG_SLICES for w in range(2)}
        # (a) an uninterrupted run and one with a member's host killed, at once
        times = {}

        def kill_member(scratch):
            marker = os.path.join(scratch, f"step_{GANG_KILL_AT - 1}")
            _gang_wait(lambda: os.path.exists(marker) or "end" in times, GANG_TIMEOUT_S,
                       "the gang's kill step")
            if "end" in times:
                return
            with open(marker) as f:
                first = f.read()
            groups = _gang_groups(runtime, hosts)
            mine = [g for g, (slices, _) in groups.items() if slices == {first}]
            if len(mine) != 1:
                _fail(f"gang: no one group holds slice {first!r}: {groups}")
            others = set(groups) - set(mine)  # the uninterrupted run's
            old = groups[mine[0]][1]
            times["kill"] = time.time()
            cluster.remove_node(old[1])

            def moved():
                return [pl for g, (slices, pl) in _gang_groups(runtime, hosts).items()
                        if g not in others and len(slices) == 1 and first not in slices]

            _gang_wait(lambda: moved(), GANG_TIMEOUT_S, "the gang's re-placement on a slice")
            times["created"] = time.time()
            times["moved"] = (first, old, moved()[0])

        t_plain, box_plain = _in_background(_gang_fit, tmp, "gang_uninterrupted", 0)
        t, box = _in_background(kill_member, os.path.join(tmp, "gang_cofail_scratch"))
        resumed, resumed_s, _ = _gang_fit(tmp, "gang_cofail", 1)
        times["end"] = True
        for th, bx, what in ((t, box, "the kill"), (t_plain, box_plain, "the uninterrupted run")):
            th.join(GANG_TIMEOUT_S)
            if th.is_alive():
                _fail(f"gang: {what} did not end within {GANG_TIMEOUT_S} s of the other run")
            if "error" in bx:
                raise bx["error"]
        plain, plain_s, _ = box_plain["value"]
        if "kill" not in times:
            _fail("gang: no member was killed")
        a, b = plain.metrics, resumed.metrics
        rec_a, rec_b = a["record"], b["record"]
        attempts = rec_b["attempts"]
        fresh = min((ts for i, ts in attempts[-1]["step_t"]), default=None)
        first, old, new = times["moved"]
        print(f"[gang] (a) {smi}: 2 gloo ranks on SLICE_GANG bundles of {{'CPU': 1, 'GPU': 1}} "
              f"over three 2-host slices sharing the card, two runs at once, llama2_7b width, "
              f"{_cluster_data_cfg().n_layers} layer(s), fp32, TF32 off, global batch 2 x {FIT_SEQ}, "
              f"{GANG_STEPS} steps: uninterrupted fit {plain_s:.1f} s on slices "
              f"{rec_a['attempts'][0]['slices']}; co-fail fit {resumed_s:.1f} s, attempts' "
              f"slices {[x['slices'] for x in attempts]}; host {old[1][:12]} of {first} killed "
              f"after step {GANG_KILL_AT - 1}: kill -> gang CREATED on another slice "
              f"{_dt(times.get('created'), times['kill']):.2f} s, kill -> first fresh step "
              f"{_dt(fresh, times['kill']):.2f} s; gang {[n[:12] for n in old]} -> "
              f"{[n[:12] for n in new]}", flush=True)
        print(f"[gang] (a) losses uninterrupted {[x for _, x in rec_a['losses']]}, resumed "
              f"{[x for _, x in rec_b['losses']]}; params_sha256 {a['params_sha256'][:16]} / "
              f"{b['params_sha256'][:16]}; launches by attempt (rank 0) "
              f"{[x.get('launches') for x in attempts]}; goodput {b['goodput']:.3f}", flush=True)
        second = {s for s, _ in attempts[-1]["slices"]}
        if len(attempts) != 2 or {s for s, _ in attempts[0]["slices"]} != {first} or \
                len(second) != 1 or first in second:
            _fail(f"gang: the gang did not move whole: attempts on {attempts}")
        if rec_b["losses"] != rec_a["losses"] or b["params_sha256"] != a["params_sha256"]:
            _fail("gang: the resumed run is not bitwise equal to the uninterrupted one")
        for i, x in enumerate([rec_a["attempts"][0], *attempts]):
            if not all((x.get("launches") or {"none": 0}).values()):
                _fail(f"gang: an attempt's rank 0 did not launch every kernel: {x}")
        launches["gang trainer uninterrupted (rank 0)"] = rec_a["attempts"][0]["launches"]
        for i, x in enumerate(attempts):
            launches[f"gang trainer co-fail attempt {i + 1} (rank 0)"] = x["launches"]
        # (b) the slices gone, a pending gang and the autoscaler
        for nid in hosts:
            if nid != old[1]:
                cluster.remove_node(nid)
        pg = placement_group([{"CPU": 1.0, "GPU": 1.0}] * 2, strategy="SLICE_GANG")
        t_pending = time.time()
        if pg.ready(timeout=1.0) or _gang_pg(runtime, "PENDING") is None:
            _fail("gang: a gang with no slice to take is not PENDING")
        scaler = Autoscaler(LocalGPUSliceProvider(cluster), max_nodes=8, upscale_delay_s=0.5,
                            interval_s=0.5)
        scaler.start()
        try:
            if not pg.ready(timeout=GANG_TIMEOUT_S):
                _fail("gang: the pending gang was never placed on a provisioned slice")
            t_up = time.time()
            task = rt.remote(num_cpus=1, num_gpus=1)(_gang_k1).options(
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=pg, placement_group_bundle_index=0))
            got = rt.get(task.remote(71), timeout=GANG_TIMEOUT_S)
            t_k1 = time.time()
            labels = {n["NodeID"]: n.get("Labels") or {} for n in runtime.nodes()}
            slice_of_0 = labels[pg.bundle_placements[0]].get("slice_name")
        finally:
            scaler.stop()
            remove_placement_group(pg)
        print(f"[gang] (b) {smi}: pending gang of 2 x {{'CPU': 1, 'GPU': 1}} -> slice "
              f"{slice_of_0} up and the gang placed {t_up - t_pending:.2f} s -> K1 result in "
              f"bundle 0 {t_k1 - t_pending:.2f} s (after placement {t_k1 - t_up:.2f} s); K1 "
              f"per-entry error {got['err']:.3g} (tol 2^-6), launches {got['launches']}, the "
              f"task's slice {got['slice']}, CUDA_VISIBLE_DEVICES "
              f"{got['cuda_visible_devices']!r}; upscales {scaler.num_upscales}", flush=True)
        if got["err"] > 2 ** -6 or got["launches"]["flash_fwd"] < 1:
            _fail(f"gang: K1 in the provisioned gang's bundle: {got}")
        if got["slice"] != [slice_of_0, "0"]:
            _fail(f"gang: bundle 0's task saw slice {got['slice']}, want [{slice_of_0}, 0]")
        launches["gang pending -> provisioned K1 task"] = got["launches"]
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    left = _cluster_processes(session_dir)
    pools = glob.glob(f"/dev/shm/rtpt_{os.path.basename(session_dir)}*")
    print(f"[gang] processes left {left}, pools left {sorted(pools)}; phase "
          f"{time.perf_counter() - phase_t0:.1f} s", flush=True)
    if left or pools:
        _fail("gang: processes or /dev/shm/rtpt_* pools outlived shutdown")
    return launches


# ------------------------------------------------------------------ soak
SOAK_SEED = 1030  # tests/test_torch_partition.py's campaign
SOAK_DURATION_S = 25.0
SOAK_NODES = 2
SOAK_HB = {"RAY_TPU_HEARTBEAT_INTERVAL_S": "0.25", "RAY_TPU_HEARTBEAT_TIMEOUT_S": "1.5",
           "RAY_TPU_CHAOS_SEED": str(SOAK_SEED)}


def phase_soak():
    """The seeded membership soak (ray_tpu_torch/chaos/soak.py) with its
    trainer arm, on a cluster of its own (a head and SOAK_NODES worker
    nodes, no GPU): partition, heal, kill and preempt events for
    SOAK_DURATION_S while a named counter, a task workload and an elastic
    TorchTrainer (one CPU worker: use_gpu=False, its loop a scalar
    recurrence) run; the counter's exactly-once audit, no wedged get, one
    ALIVE counter, and the trainer's history equal to the fault-free golden
    run. The path launches no kernel. Returns its launches (0)."""
    from ray_tpu_torch.chaos.soak import run_soak

    phase_t0 = time.perf_counter()
    smi = _smi()
    saved = {k: os.environ.get(k) for k in SOAK_HB}
    os.environ.update(SOAK_HB)
    _zero_launch_counts()
    try:
        result = run_soak(SOAK_SEED, SOAK_DURATION_S, nodes=SOAK_NODES, event_period_s=1.5,
                          use_trainer=True)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launches = _launch_counts()
    print(f"[soak] {smi}: seed {SOAK_SEED}, {SOAK_DURATION_S:.0f} s of events on "
          f"{SOAK_NODES} worker nodes: {result.summary()}; launches in this process "
          f"{launches}; phase {time.perf_counter() - phase_t0:.1f} s", flush=True)
    if not result.ok or result.trainer_ok is not True:
        _fail(f"soak: violations {result.violations}, trainer_ok {result.trainer_ok}")
    if any(launches.values()):
        _fail(f"soak: the soak's path launched flash kernels: {launches}")
    return {"soak": launches}


LANE_PHASES = ("ops", "membership", "observe", "graphs", "data", "elastic", "rl", "operate",
               "shards")
LANE_AFTER_PARALLEL = "data"
LANE_DEADLINE_S = 1080  # from the smoke's start; the driver stops it at 1200
LANE_POLL_S = 0.5


def _run_lane(tmp: str) -> int:
    """The second process: LANE_PHASES in order; their launches and seconds
    go to <tmp>/lane.json (any failure exits 1 first)."""
    import ctypes
    import signal

    # Ends with the main process, whichever way that ends (PR_SET_PDEATHSIG);
    # the clusters it starts end with it in turn.
    ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGTERM), 0, 0, 0)
    phases = {name: globals()[f"phase_{name}"] for name in LANE_PHASES}
    out = {"by_path": {}, "phase_s": {}, "waited_s": 0.0}
    for name, phase in phases.items():
        if name == LANE_AFTER_PARALLEL:
            t0 = time.perf_counter()
            while not os.path.exists(os.path.join(tmp, "parallel.done")):
                time.sleep(LANE_POLL_S)
            out["waited_s"] = round(time.perf_counter() - t0, 1)
            print(f"[lane] waited {out['waited_s']} s for the main process's parallel phase "
                  f"before {name}", flush=True)
        t0 = time.perf_counter()
        out["by_path"].update(phase())
        out["phase_s"][name] = round(time.perf_counter() - t0, 1)
    with open(os.path.join(tmp, "lane.json"), "w") as f:
        json.dump(out, f)
    return 0


class _Lane:
    """The second process (`--lane <tmp>`), its log in <tmp>/lane.log. In
    its own process group, so that stop() reaches it and what it started
    (the clusters' daemons also exit with their parent)."""

    def __init__(self, t_main: float):
        import tempfile

        self.t_main = t_main
        self.tmp = tempfile.mkdtemp(prefix="chip-smoke-lane-")
        self.log = open(os.path.join(self.tmp, "lane.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--lane", self.tmp],
            stdout=self.log, stderr=subprocess.STDOUT, start_new_session=True)
        self.printed = 0

    def parallel_done(self) -> None:
        open(os.path.join(self.tmp, "parallel.done"), "w").close()

    def _print_log(self) -> None:
        """Prints what the lane logged since the last call."""
        path = os.path.join(self.tmp, "lane.log")
        if not os.path.exists(path):
            return  # stopped before
        with open(path, errors="replace") as f:
            f.seek(self.printed)
            text = f.read()
            self.printed = f.tell()
        if text:
            print(text, end="" if text.endswith("\n") else "\n", flush=True)

    def join(self):
        """Waits for the lane to end; its log, then its (launches by path,
        seconds by phase, seconds waited for the parallel phase)."""
        while self.proc.poll() is None:
            if time.perf_counter() - self.t_main > LANE_DEADLINE_S:
                self.stop()
                _fail(f"lane: {LANE_PHASES} did not end within {LANE_DEADLINE_S} s of the "
                      f"smoke's start")
            time.sleep(LANE_POLL_S)
        self._print_log()
        if self.proc.returncode != 0:
            _fail(f"lane: the second process ({', '.join(LANE_PHASES)}) exited "
                  f"{self.proc.returncode}")
        with open(os.path.join(self.tmp, "lane.json")) as f:
            out = json.load(f)
        return out["by_path"], out["phase_s"], out["waited_s"]

    def stop(self) -> None:
        """Ends the lane's process group, if it still runs, prints what it
        logged and not yet printed, and removes its directory."""
        import shutil
        import signal

        if self.proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(self.proc.pid, signal.SIGTERM)
            try:
                self.proc.wait(15)
            except subprocess.TimeoutExpired:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(self.proc.pid, signal.SIGKILL)
                self.proc.wait()
        self.log.close()
        self._print_log()
        shutil.rmtree(self.tmp, ignore_errors=True)


class _MemorySampler:
    """Samples, every second, the card's memory in use by every process (one
    cudaMemGetInfo from this process) and the host's MemAvailable; keeps the
    peak and the low for each phase of the main process that is running."""

    def __init__(self):
        import threading

        self.phase, self.peaks, self.stop_ev = "", {}, threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True, name="smoke-memory")
        self.thread.start()

    @staticmethod
    def _host_available_gib() -> float:
        with open("/proc/meminfo") as f:
            for ln in f:
                if ln.startswith("MemAvailable:"):
                    return int(ln.split()[1]) / 2 ** 20
        return float("nan")

    def _run(self) -> None:
        import torch

        while not self.stop_ev.wait(1.0):
            free, total = torch.cuda.mem_get_info()
            used, host = (total - free) / 2 ** 30, self._host_available_gib()
            dev, low = self.peaks.get(self.phase, (0.0, float("inf")))
            self.peaks[self.phase] = (max(dev, used), min(low, host))

    def close(self) -> str:
        self.stop_ev.set()
        self.thread.join(5)
        return ", ".join(f"{p} {d:.1f} / {h:.1f}" for p, (d, h) in self.peaks.items())


def main() -> int:
    import argparse

    global _PACKAGE_ROOT
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parallel-rank", nargs=4, metavar=("RANK", "WORLD", "INIT_URL", "OUT"),
                    help="run one rank of the parallel phase's gloo world (the phase starts "
                         "these processes itself)")
    ap.add_argument("--tp-only", action="store_true",
                    help="with --parallel-rank: run only part (c)")
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve phase, one more train step, and one step each of "
                         "the fit phase's trainer and plain runs with torch.profiler, and print "
                         "device time by kernel")
    ap.add_argument("--lane", metavar="DIR",
                    help="run the phases of the second process, writing their results into "
                         "DIR (the smoke starts this process itself)")
    ap.add_argument("--tp-memory", action="store_true",
                    help="build the kernels and run only part (c) of the parallel phase (the "
                         "tensor-parallel meshes, gates included), printing each rank's peak "
                         "memory; no result line")
    ap.add_argument("--cluster-cost", action="store_true",
                    help="build the kernels and run only the cluster phase, printing its "
                         "seconds (with --package-root, of another commit's runtime); no "
                         "result line")
    ap.add_argument("--package-root", metavar="DIR",
                    help="import ray_tpu_torch from DIR (another commit's, unpacked by git "
                         "archive), here and in the parallel ranks")
    args = ap.parse_args()
    if args.package_root:
        _PACKAGE_ROOT = os.path.abspath(args.package_root)
        sys.path.insert(0, _PACKAGE_ROOT)
    import ray_tpu_torch  # noqa: F401  (fails at once outside a checkout)

    if args.lane:
        return _run_lane(args.lane)
    if args.parallel_rank:
        rank, world, url, out = args.parallel_rank
        _parallel_rank(int(rank), int(world), url, out, args.tp_only)
        return 0
    if args.tp_memory:
        phase_device()
        phase_build()
        phase_tp_memory()
        return 0
    if args.cluster_cost:
        phase_device()
        phase_build()
        t0 = time.perf_counter()
        phase_cluster()
        print(f"[cluster-cost] {_PACKAGE_ROOT or 'this checkout'}: cluster phase "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return 0

    t_main, phase_s, sampler = time.perf_counter(), {}, None

    def timed(phase, *a, **kw):
        """Runs one phase; keeps its wall seconds for the line before the JSON."""
        name = phase.__name__[len("phase_"):]
        if sampler is not None:
            sampler.phase = name
        t0 = time.perf_counter()
        out = phase(*a, **kw)
        phase_s[name] = round(time.perf_counter() - t0, 1)
        return out

    name = timed(phase_device)
    timed(phase_build)
    fwd_row, dq_row, dkv_row = timed(phase_kernel)
    timed(phase_paged)
    for row, n in zip((fwd_row, dq_row, dkv_row), timed(phase_gptj).values()):
        row["at_d256"]["launches"] = n
    # The kernels are timed: from here on a second process runs LANE_PHASES.
    lane, sampler = _Lane(t_main), _MemorySampler()
    try:
        by_path = timed(phase_parallel)
        lane.parallel_done()
        fwd_row["launches"] = timed(phase_serve, profile=args.profile)
        by_path.update(timed(phase_deploy))
        timed(phase_train_parity)
        train_launches = timed(phase_train, profile=args.profile)
        timed(phase_zero)
        timed(phase_checkpoint)
        fit_launches, fit_step_ms = timed(phase_fit, profile=args.profile)
        by_path.update(fit_launches)
        by_path.update(timed(phase_tune, fit_step_ms))
        for phase in (phase_cluster, phase_objects, phase_gang, phase_soak):
            by_path.update(timed(phase))
        sampler.phase = "waiting for the second process"
        lane_paths, lane_s, waited_s = lane.join()
        by_path.update(lane_paths)
    finally:
        lane.stop()
        memory = sampler.close()
    print(f"[smoke] the card's memory in use by every process, peak GiB / the host's "
          f"MemAvailable, low GiB, while each phase of the main process ran: {memory}",
          flush=True)
    print(f"[smoke] seconds by phase {phase_s}; in the second process beside them {lane_s}, "
          f"after {waited_s} s waiting for the parallel phase before {LANE_AFTER_PARALLEL}; "
          f"whole smoke {time.perf_counter() - t_main:.1f} s", flush=True)
    dq_row["launches"] = train_launches["flash_bwd_dq"]
    dkv_row["launches"] = train_launches["flash_bwd_dkv"]
    for row in (fwd_row, dq_row, dkv_row):
        row["launches_by_path"] = {path: n[row["name"]] for path, n in by_path.items()}
    print(json.dumps({"kernels": [fwd_row, dq_row, dkv_row]}), flush=True)
    import torch

    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
