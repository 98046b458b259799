"""The port's command line: `python -m ray_tpu_torch.scripts <command>` (or
the `ray-tpu-torch` console script), the port of ray_tpu/scripts.py.

Re-design of the reference's CLI (reference: python/ray/scripts/scripts.py:626
`ray start` / `ray stop` / `ray status` / `ray up`; job commands from
dashboard/modules/job/cli.py). A head's session dir is its address: `start`
and `up` record it in `~/.ray_tpu_torch/latest_session` (the JAX package's
CLI keeps `~/.ray_tpu/latest_session`, so neither attaches to the other's
head), and later commands, and `init(address="auto")`, find it there.

Commands: `start` (a head, or `--address tcp://h:p` to join one; `--num-gpus`,
`--labels`), `stop`, `status` (DRAINING and FENCED nodes, the recovery,
efficiency, LLM, data and alert lines), `up` / `down` (a JSON cluster config
with the local provider, brought to size by autoscaler_v2's reconciler),
`submit`, `jobs`, `logs`, `metrics`, `top`, `timeline`, `trace`, `debug dump`
/ `debug profile`, `postmortem` and `dashboard`.

The port's daemons exit with the process that started them (core/gcs.py
`exit_with_parent`), and a session's pools live while that process holds the
session's lock (core/cluster_runtime.py). So `start` and `up` do not detach
daemons as the JAX CLI does: they start a keeper, `python -m
ray_tpu_torch.scripts _keep <spec>`, in a session of its own, which builds
the Cluster (for `up`, also the LocalNodeProvider and the InstanceManager,
which keeps reconciling), writes `<session>/keeper.json` and a ready file,
and holds the cluster until SIGTERM; `stop` and `down` send it, and the
keeper shuts the cluster down (workers, raylets, GCS, pools, session dir).

`start` without `--num-gpus` counts the CUDA devices as `Cluster` does (that
imports torch in the keeper); `--num-gpus 0` asks for a CPU-only head.
Cluster configs are JSON, or YAML where `yaml` imports. This module never
imports torch.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time


def _pointer() -> str:
    from .core.cluster_runtime import session_pointer_path

    return session_pointer_path()


def _cluster_state_dir() -> str:
    return os.path.expanduser("~/.ray_tpu_torch/clusters")


def _record_session(session_dir: str) -> None:
    path = _pointer()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(session_dir)


def _resolve_address(args) -> str:
    if getattr(args, "address", None):
        return args.address
    try:
        with open(_pointer()) as f:
            return f.read().strip()
    except OSError:
        raise SystemExit("no running cluster found; pass --address or run "
                         "`python -m ray_tpu_torch.scripts start`")


# ------------------------------------------------------------------ keeper
def _keep(spec_json: str) -> None:
    """The keeper process: builds what `spec` asks for, reports ready, holds
    it until SIGTERM, then shuts it down."""
    from .core.cluster_runtime import Cluster, start_worker_node

    spec = json.loads(spec_json)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    mode = spec["mode"]
    ready = {"pid": os.getpid()}
    closers = []
    try:
        if mode == "join":
            info = start_worker_node(spec["address"], node_ip=spec.get("node_ip"),
                                     num_cpus=spec.get("num_cpus"), num_gpus=spec.get("num_gpus"),
                                     resources=spec.get("resources"),
                                     object_store_memory=spec.get("object_store_memory"),
                                     labels=spec.get("labels"))
            closers.append(info["shutdown"])
            ready.update(session_dir=info["session_dir"], node_id=info["node_id"])
        else:
            cluster = Cluster(num_cpus=spec.get("num_cpus"), num_gpus=spec.get("num_gpus"),
                              resources=spec.get("resources"),
                              object_store_memory=spec.get("object_store_memory"),
                              head_port=spec.get("port"), node_ip=spec.get("node_ip") or "127.0.0.1",
                              labels=spec.get("labels"))
            closers.append(cluster.shutdown)
            ready.update(session_dir=cluster.session_dir, node_id=cluster.head_node_id,
                         gcs_tcp_address=cluster.gcs_tcp_address)
            if mode == "up":
                ready.update(_keep_up(spec, cluster, stop, closers))
        with open(os.path.join(ready["session_dir"], "keeper.json"), "w") as f:
            json.dump({"pid": os.getpid(), "log": spec.get("log")}, f)
        _record_session(ready["session_dir"])
    except BaseException as e:  # noqa: BLE001 - told to the waiting CLI, then shut down
        ready["error"] = repr(e)
        stop.set()
    tmp = spec["ready"] + ".tmp"
    with open(tmp, "w") as f:
        json.dump(ready, f)
    os.replace(tmp, spec["ready"])
    try:
        while not stop.wait(0.5):
            pass
    finally:
        for close in reversed(closers):
            try:
                close()
            except Exception as e:  # noqa: BLE001 - the rest still shut down
                print(f"shutdown step failed: {e!r}", file=sys.stderr, flush=True)


def _keep_up(spec, cluster, stop, closers) -> dict:
    """`up` in the keeper: the reconciler brings the workers to the
    configured count, then keeps reconciling (a dead node is replaced)."""
    from .accelerators import LocalNodeProvider
    from .autoscaler_v2 import InstanceManager
    from .core.rpc import RpcClient

    provider = LocalNodeProvider(cluster)
    gcs = RpcClient(cluster.gcs_sock)
    im = InstanceManager(provider, gcs=gcs, shape=spec["shape"])
    im.set_target(int(spec["count"]))
    t0 = time.monotonic()
    ok = im.wait_running(int(spec["count"]), timeout=float(spec["timeout"]))
    up_s = time.monotonic() - t0

    def reconcile():
        while not stop.wait(1.0):
            try:
                im.reconcile()
            except Exception as e:  # noqa: BLE001 - the next round tries again
                print(f"reconcile round failed: {e!r}", file=sys.stderr, flush=True)

    t = threading.Thread(target=reconcile, daemon=True, name="reconcile")
    t.start()
    closers.append(lambda: (stop.set(), t.join(timeout=5), gcs.close()))
    return {"ok": ok, "running": im.counts().get("RAY_RUNNING", 0), "up_s": up_s,
            "cloud_ids": [i.cloud_id for i in im.instances.values() if i.cloud_id]}


def _start_keeper(spec: dict, timeout: float) -> dict:
    """Starts a keeper in its own session and waits for its ready file."""
    fd, log = tempfile.mkstemp(prefix="rtpt_keeper_", suffix=".log")
    os.close(fd)
    ready_path = log[:-len(".log")] + ".ready"
    spec = dict(spec, ready=ready_path, log=log)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    with open(log, "ab", buffering=0) as out:
        proc = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch.scripts", "_keep",
                                 json.dumps(spec)], stdin=subprocess.DEVNULL, stdout=out,
                                stderr=out, env=env, start_new_session=True)
    deadline = time.monotonic() + timeout
    while not os.path.exists(ready_path):
        if proc.poll() is not None or time.monotonic() > deadline:
            if proc.poll() is None:
                proc.kill()
            with open(log) as f:
                tail = f.read()[-4000:]
            raise SystemExit(f"the cluster keeper did not come up (exit {proc.poll()}):\n{tail}")
        time.sleep(0.1)
    with open(ready_path) as f:
        ready = json.load(f)
    os.unlink(ready_path)
    if "error" in ready:
        raise SystemExit(f"the cluster keeper failed: {ready['error']}")
    return ready


def cmd_start(args) -> None:
    resources = json.loads(args.resources) if args.resources else None
    labels = json.loads(args.labels) if args.labels else None
    spec = {"num_cpus": args.num_cpus, "num_gpus": args.num_gpus, "resources": resources,
            "object_store_memory": args.object_store_memory, "labels": labels,
            "node_ip": args.node_ip_address}
    if args.address:
        # A worker node (reference: `ray start --address=head:port`).
        ready = _start_keeper(dict(spec, mode="join", address=args.address), timeout=120.0)
        print(f"joined cluster at {args.address}; node {ready['node_id']} "
              f"(session dir: {ready['session_dir']})")
        return
    node_ip = args.node_ip_address
    if node_ip is None and args.port is not None:
        # Other hosts must reach a TCP head: this machine's routable address
        # (a UDP "connect" sends nothing), not loopback.
        import socket

        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            probe.connect(("10.255.255.255", 1))
            node_ip = probe.getsockname()[0]
        except OSError:
            node_ip = "127.0.0.1"
        finally:
            probe.close()
    ready = _start_keeper(dict(spec, mode="head", port=args.port, node_ip=node_ip),
                          timeout=120.0)
    print(f"started cluster; session dir: {ready['session_dir']}")
    print(f"connect with: ray_tpu_torch.init(address={ready['session_dir']!r})")
    if ready.get("gcs_tcp_address"):
        print("other hosts join with: python -m ray_tpu_torch.scripts start "
              f"--address {ready['gcs_tcp_address']}")


def _alive(pid: int) -> bool:
    from .core.cluster_runtime import _running

    return _running(pid)


def _stop_session(session: str, timeout: float = 60.0) -> bool:
    """SIGTERMs the session's keeper and waits for it (it shuts the cluster
    down); SIGKILL after `timeout` (its daemons exit with it), then the
    session's pools and dir go. True if a keeper was found."""
    from .core.cluster_runtime import sweep_orphaned_pools

    try:
        with open(os.path.join(session, "keeper.json")) as f:
            keeper = json.load(f)
    except (OSError, ValueError):
        keeper = None
    if keeper is not None:
        pid = int(keeper["pid"])
        try:
            os.kill(pid, signal.SIGTERM)
        except OSError:
            pass
        deadline = time.monotonic() + timeout
        while _alive(pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        if _alive(pid):
            os.kill(pid, signal.SIGKILL)
            deadline = time.monotonic() + 10.0
            while _alive(pid) and time.monotonic() < deadline:
                time.sleep(0.1)
        if keeper.get("log"):
            try:
                os.unlink(keeper["log"])
            except OSError:
                pass
    import shutil

    shutil.rmtree(session, ignore_errors=True)
    sweep_orphaned_pools()
    try:
        with open(_pointer()) as f:
            recorded = f.read().strip()
        if recorded == session:
            os.unlink(_pointer())
    except OSError:
        pass
    return keeper is not None


def cmd_stop(args) -> None:
    session = _resolve_address(args)
    found = _stop_session(session)
    print(f"stopped the cluster of {session}" if found
          else f"no keeper in {session}; removed what was left")


def _connect(args):
    from . import api

    api.init(address=_resolve_address(args), ignore_reinit_error=True)


_STATUS_AUTO_SUMMARY = 64  # per-node rows above this need an explicit ask


def cmd_status(args) -> None:
    _connect(args)
    from .utils import state

    stats = state.cluster_stats()
    print(f"nodes alive: {stats['nodes_alive']}")
    # At scale the per-node dump is the enemy: one summary RPC, and an
    # optional bounded sample of the rows.
    summary = state.node_summary()
    res = summary["resources"]
    print("resources: " + " ".join(f"{k} {v:g}" for k, v in sorted(res.items())))
    limit = args.limit
    if args.summary or (limit is None and summary["total"] > _STATUS_AUTO_SUMMARY):
        print(f"nodes: {summary['total']} total "
              + " ".join(f"{k}={v}" for k, v in sorted(summary["by_state"].items())))
        print(f"  resources: {summary['resources']}")
        print(f"  available: {summary['available']}")
        if not args.summary:
            print(f"  (per-node rows suppressed at >{_STATUS_AUTO_SUMMARY} nodes; "
                  "use --limit N for a sample)")
        _status_tail(stats, state)
        return
    for n in state.list_nodes(limit):
        mark = "up" if n["Alive"] else "DOWN"
        if n["Alive"] and n.get("Draining"):
            mark = "DRAINING"  # a preemption notice: the node is departing
        elif not n["Alive"] and n.get("Fenced"):
            # Declared dead, then heard from again (a healed partition): its
            # RPCs are refused until it registers afresh.
            mark = "FENCED"
        labels = n.get("Labels") or {}
        label_info, rest = "", dict(labels)
        if labels.get("slice_name"):
            # Where each host sits in its slice (its NVLink domain, detected
            # or a provider's labels); the node's other labels follow.
            label_info = f" slice={rest.pop('slice_name')}[{rest.pop('worker_index', 0)}]"
            if rest.get("gpu_generation"):
                label_info += f" gpu={rest.pop('gpu_generation')}"
        if rest:
            label_info += " labels=" + ",".join(f"{k}={v}" for k, v in sorted(rest.items()))
        epoch_info = f" epoch={n['Epoch']}" if n.get("Epoch") is not None else ""
        pool_info = ""
        if args.verbose:
            p = (n.get("Stats") or {}).get("pool") or {}
            if p:
                hits, misses = p.get("hits") or {}, p.get("misses") or {}
                pool_info = (f" pool={p.get('ready', 0)}/{p.get('target', 0)}"
                             f" hits={sum(hits.values())} misses={sum(misses.values())}")
        print(f"  [{mark}] {n['NodeID'][:12]}{epoch_info} resources={n['Resources']} "
              f"available={n['Available']} workers={(n.get('Stats') or {}).get('num_workers', 0)}"
              f"{pool_info}{label_info}")
    _status_tail(stats, state)


def _sum_named(records, names):
    out = {label: 0.0 for label in names.values()}
    for m in records:
        label = names.get(m.get("name"))
        if label:
            out[label] += float(m.get("value") or 0.0)
    return out


def _status_tail(stats, state) -> None:
    """The node-independent half of `status`: tasks, store, the recovery,
    efficiency, LLM and data lines, alerts and recent errors."""
    print(f"tasks: {stats['tasks']}")
    print(f"actors: {stats['actors']}")
    s = stats["store"]
    print(f"object store: {s['num_objects']} objects, "
          f"{s['bytes_in_use'] / (1 << 20):.1f} MiB in use, {s['num_spilled']} spilled")
    try:
        records = state.internal_metrics()
    except Exception:  # noqa: BLE001 - the lines below are then left out
        records = []
    recovery = _sum_named(records, {
        "raytpu_actor_restarts_total": "actor_restarts",
        "raytpu_tasks_retried_total": "tasks_retried",
        "raytpu_nodes_drained_total": "nodes_drained",
        "raytpu_checkpoints_restored_total": "checkpoints_restored",
        "raytpu_chaos_injections_total": "chaos_injections",
    })
    print("recovery: " + " ".join(f"{k}={int(v)}" for k, v in recovery.items()))
    # Efficiency: entries whose reporters all went keep a 0.0 value; skip them.
    eff = {}
    for m in records:
        if m.get("kind") == "gauge" and not m.get("gauges"):
            continue
        name, val = m.get("name"), float(m.get("value") or 0.0)
        if name == "raytpu_train_goodput":
            eff["goodput"] = min(eff.get("goodput", 1.0), val)
        elif name == "raytpu_train_mfu":
            eff.setdefault("mfu", []).append(val)
        elif name == "raytpu_train_tokens_per_s":
            eff["tokens_per_s"] = eff.get("tokens_per_s", 0.0) + val
    parts = []
    if "goodput" in eff:
        parts.append(f"goodput={eff['goodput']:.3f}")
    if eff.get("mfu"):
        parts.append(f"mfu={sum(eff['mfu']) / len(eff['mfu']):.3f}")
    if "tokens_per_s" in eff:
        parts.append(f"tokens/s={eff['tokens_per_s']:g}")
    if parts:
        print("efficiency: " + " ".join(parts))
    llm = _sum_named(records, {
        "raytpu_serve_tokens_per_s": "tok_s", "raytpu_kv_pages_used": "used",
        "raytpu_kv_pages_total": "total", "raytpu_prefix_cache_hits_total": "hits",
        "raytpu_prefix_cache_misses_total": "miss",
        "raytpu_serve_requests_shed_total": "shed"})
    if llm["total"] > 0:
        lookups = llm["hits"] + llm["miss"]
        hit_pct = (llm["hits"] / lookups * 100.0) if lookups else 0.0
        print(f"llm serve: tokens/s={llm['tok_s']:g} "
              f"kv_pages={int(llm['used'])}/{int(llm['total'])} "
              f"prefix_hits={hit_pct:.0f}% shed={int(llm['shed'])}")
    dp = _sum_named(records, {
        "raytpu_data_op_pool_size": "pool", "raytpu_data_op_queued_bytes": "queued",
        "raytpu_data_backpressure_total": "bp", "raytpu_data_op_tasks_total": "tasks"})
    if any(dp.values()):
        print(f"data plane: pool_actors={int(dp['pool'])} queued={int(dp['queued'])}B "
              f"backpressure_edges={int(dp['bp'])} tasks={int(dp['tasks'])}")
    try:
        alerts = state.active_alerts()
    except Exception:  # noqa: BLE001 - an unreachable watchdog reads as none
        alerts = []
    for a in alerts:
        print(f"ALERT {a['rule']}: {a['metric']} {a.get('stat', 'value')}="
              f"{a['value']:g} {a['op']} {a['threshold']:g}"
              + (f" - {a['description']}" if a.get("description") else ""))
    if not alerts:
        print("alerts: none")
    try:
        errors = state.cluster_errors(50)
    except Exception:  # noqa: BLE001 - the error table is optional here
        errors = []
    if errors:
        print(f"errors: {len(errors)} recent (newest last)")
        for e in errors[-3:]:
            who = str(e.get("actor_id") or e.get("task") or e.get("worker_id") or "?")
            print(f"  [{e.get('type', 'error')}] node={str(e.get('node_id') or '?')[:8]} "
                  f"{who[:40]}: {str(e.get('error', ''))[:120]}")


# -------------------------------------------------------------- up / down
def _load_cluster_config(path: str) -> dict:
    """A cluster config (reference: the `ray up` cluster YAML, collapsed to
    what the local launcher needs): JSON, or YAML where `yaml` imports."""
    with open(path) as f:
        text = f.read()
    try:
        cfg = json.loads(text)
    except ValueError:
        try:
            import yaml
        except ImportError:
            raise SystemExit(f"{path}: not JSON, and no yaml module to read it as YAML")
        cfg = yaml.safe_load(text)
    if not isinstance(cfg, dict):
        raise SystemExit(f"{path}: a cluster config must be a mapping")
    cfg.setdefault("cluster_name", "ray-tpu-torch")
    provider = cfg.setdefault("provider", {})
    ptype = provider.setdefault("type", "local")
    if ptype != "local":
        raise SystemExit(f"{path}: provider.type must be 'local' (the JAX package's "
                         f"gce_tpu provider is not ported), got {ptype!r}")
    cfg.setdefault("head", {})
    cfg.setdefault("workers", {}).setdefault("count", 1)
    return cfg


def _cluster_state_path(name: str) -> str:
    return os.path.join(_cluster_state_dir(), f"{name}.json")


def _worker_shape(cfg: dict) -> dict:
    w = cfg["workers"]
    shape = {"cpus": float(w.get("cpus", 2.0)), "gpus": float(w.get("gpus", 0.0)),
             "slice_hosts": int(w.get("slice_hosts", 1))}
    if w.get("resources"):
        shape["resources"] = dict(w["resources"])
    return shape


def cmd_up(args) -> None:
    """`up cluster.json`: a head on this machine and `workers.count` worker
    instances from the local provider, brought up by autoscaler_v2's
    reconciler (reference: `ray up` driving the v2 instance manager)."""
    cfg = _load_cluster_config(args.config)
    name = cfg["cluster_name"]
    count = int(cfg["workers"]["count"])
    os.makedirs(_cluster_state_dir(), exist_ok=True)
    state_path = _cluster_state_path(name)
    if os.path.exists(state_path) and not args.force:
        raise SystemExit(f"cluster {name!r} already has recorded state ({state_path}); "
                         "run `down` first or pass --force")
    head = cfg["head"]
    spec = {"mode": "up", "num_cpus": head.get("num_cpus"), "num_gpus": head.get("num_gpus"),
            "port": head.get("port"), "labels": head.get("labels"),
            "shape": _worker_shape(cfg), "count": count, "timeout": args.timeout}
    ready = _start_keeper(spec, timeout=args.timeout + 120.0)
    with open(state_path, "w") as f:
        json.dump({"type": "local", "cluster_name": name, "session_dir": ready["session_dir"],
                   "cloud_ids": ready.get("cloud_ids", [])}, f)
    print(f"cluster {name!r} up: head + {ready['running']}/{count} worker instances in "
          f"{ready['up_s']:.3f} s (session dir: {ready['session_dir']})")
    print(f"connect with: ray_tpu_torch.init(address={ready['session_dir']!r})")
    if not ready["ok"]:
        raise SystemExit(1)


def cmd_down(args) -> None:
    """`down cluster.json`: stops what `up` recorded."""
    cfg = _load_cluster_config(args.config)
    name = cfg["cluster_name"]
    state_path = _cluster_state_path(name)
    try:
        with open(state_path) as f:
            recorded = json.load(f)
    except OSError:
        raise SystemExit(f"no recorded state for cluster {name!r} ({state_path})")
    _stop_session(recorded["session_dir"])
    try:
        os.unlink(state_path)
    except OSError:
        pass
    print(f"cluster {name!r} down")


# ------------------------------------------------------------------- jobs
def cmd_submit(args) -> None:
    import shlex

    from .jobs import JobSubmissionClient

    if args.address and args.address.startswith(("http://", "https://")):
        # Over the dashboard's REST job API: no attach.
        client = JobSubmissionClient(args.address)
    else:
        _connect(args)
        client = JobSubmissionClient()
    parts = list(args.entrypoint)
    if parts and parts[0] == "--":  # argparse.REMAINDER keeps the separator
        parts = parts[1:]
    entrypoint = " ".join(shlex.quote(p) for p in parts)
    job_id = client.submit_job(entrypoint=entrypoint)
    print(f"submitted {job_id}: {entrypoint}", flush=True)
    if args.wait:
        status = client.wait_until_finished(job_id, timeout=args.timeout)
        print(f"{job_id}: {status}")
        sys.stdout.write(client.get_job_logs(job_id))
        if status != "SUCCEEDED":
            raise SystemExit(1)


def cmd_jobs(args) -> None:
    _connect(args)
    from .jobs import JobSubmissionClient

    for rec in JobSubmissionClient().list_jobs():
        print(f"{rec['job_id']}  {rec['status']:<10} {rec['entrypoint']}")


def cmd_logs(args) -> None:
    """The cluster's structured log records (the raylets' `tail_logs`,
    merged); with a job id, that job's output."""
    _connect(args)
    if args.job_id:
        from .jobs import JobSubmissionClient

        sys.stdout.write(JobSubmissionClient().get_job_logs(args.job_id))
        return
    from .observability import logs as obslogs
    from .utils import state

    actor = args.actor
    if actor:
        # An actor's name is taken as well as an id prefix.
        for a in state.list_actors(100_000):
            if a.get("name") == actor:
                actor = a["actor_id"]
                break
    filters = {"component": args.component, "level": args.level, "task_id": args.task,
               "actor_id": actor, "grep": args.grep}
    filters = {k: v for k, v in filters.items() if v}
    since = None
    # --follow polls again with a 5 s overlap and drops repeats, so a node
    # whose tail_logs lags the others loses nothing.
    seen: dict = {}
    overlap_s = 5.0
    try:
        while True:
            recs = state.cluster_logs(node=args.node,
                                      tail=args.tail if since is None else None,
                                      since_ts=(since - overlap_s) if since is not None else None,
                                      **filters)
            for r in recs:
                key = (r.get("ts"), r.get("pid"), r.get("node_id"), r.get("msg"))
                if key in seen:
                    continue
                seen[key] = r.get("ts") or 0.0
                print(obslogs.format_record(r))
            if not args.follow:
                return
            if recs:
                since = max(since or 0.0, max(float(r.get("ts") or 0.0) for r in recs))
            elif since is None:
                since = time.time()
            cutoff = since - 2 * overlap_s
            for key in [k for k, ts in seen.items() if ts < cutoff]:
                del seen[key]
            time.sleep(1.0)
    except KeyboardInterrupt:
        return


# ---------------------------------------------------------------- metrics
def format_metrics_table(sections) -> str:
    """Aggregated metric records as one aligned table with a header;
    `sections` is [(source, records), ...]."""
    rows = [("SOURCE", "NAME", "KIND", "TAGS", "VALUE")]
    for source, records in sections:
        for m in sorted(records, key=lambda r: (r.get("name", ""), str(r.get("tags")))):
            tags = m.get("tags") or {}
            tag_str = ",".join(f"{k}={v}" for k, v in sorted(tags.items()))
            val = m.get("value", 0.0)
            if m.get("kind") == "histogram":
                val = f"sum={val:g} count={sum(m.get('counts') or [])}"
            else:
                val = f"{val:g}"
            rows.append((source, m.get("name", "?"), m.get("kind", "?"), tag_str, val))
    widths = [max(len(r[i]) for r in rows) for i in range(4)]
    return "\n".join("  ".join(col.ljust(w) for col, w in zip(r[:4], widths)) + "  " + r[4]
                     for r in rows)


def _filter_records(records, pattern):
    if not pattern:
        return records
    return [r for r in records if pattern in (r.get("name") or "")]


def _metric_key(m) -> tuple:
    return (m.get("name"), tuple(sorted((m.get("tags") or {}).items())))


def _cumulative_value(m) -> float:
    if m.get("kind") == "histogram":
        return float(sum(m.get("counts") or []))
    return float(m.get("value") or 0.0)


def format_watch_table(cur, prev, dt: float) -> str:
    """One tick of `metrics --watch`: each series' value and, for counters
    and histograms, its rate per second since the previous tick (`prev`
    maps _metric_key -> cumulative value; "-" where there is none yet)."""
    rows = [("NAME", "KIND", "TAGS", "VALUE", "RATE/S")]
    for m in sorted(cur, key=lambda r: (r.get("name", ""), str(r.get("tags")))):
        tags = m.get("tags") or {}
        tag_str = ",".join(f"{k}={v}" for k, v in sorted(tags.items()))
        kind = m.get("kind", "?")
        value = _cumulative_value(m)
        if kind == "gauge":
            rate = ""
        else:
            before = prev.get(_metric_key(m))
            rate = f"{(value - before) / dt:+.6g}" if before is not None and dt > 0 else "-"
        rows.append((m.get("name", "?"), kind, tag_str, f"{value:g}", rate))
    widths = [max(len(r[i]) for r in rows) for i in range(4)]
    return "\n".join("  ".join(col.ljust(w) for col, w in zip(r[:4], widths)) + "  " + r[4]
                     for r in rows)


def cmd_metrics(args) -> None:
    _connect(args)
    from .utils import state

    if not args.watch:
        internal = _filter_records(state.internal_metrics(), args.filter)
        user = _filter_records(state.user_metrics(), args.filter)
        print(format_metrics_table([("internal", internal), ("user", user)]))
        print(f"\n{len(internal)} internal + {len(user)} user metric series")
        return
    prev: dict = {}
    prev_ts = None
    n = 0
    while True:
        records = _filter_records(state.internal_metrics() + state.user_metrics(), args.filter)
        now = time.monotonic()
        dt = (now - prev_ts) if prev_ts is not None else 0.0
        if n and sys.stdout.isatty():
            print("\x1b[2J\x1b[H", end="")
        print(format_watch_table(records, prev, dt))
        print(f"\n[{time.strftime('%H:%M:%S')}] {len(records)} series; ctrl-c to stop")
        prev = {_metric_key(m): _cumulative_value(m) for m in records}
        prev_ts = now
        n += 1
        if args.iterations and n >= args.iterations:
            return
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return


# (label, metric, mode, scale, unit, cross-series aggregation)
TOP_SIGNALS = [
    ("tasks/s", "raytpu_sched_dispatch_latency_ms", "rate", 1.0, "/s", "sum"),
    ("gcs rpc/s", "raytpu_gcs_rpc_total", "rate", 1.0, "/s", "sum"),
    ("pubsub backlog", "raytpu_gcs_pubsub_backlog", "value", 1.0, "", "sum"),
    ("cgraph MB/s", "raytpu_cgraph_channel_bytes_total", "rate", 1e-6, "MB/s", "sum"),
    ("device HBM MiB", "raytpu_device_mem_used_bytes", "value", 1.0 / (1 << 20), "MiB", "sum"),
    ("node cpu %", "raytpu_node_cpu_percent", "value", 1.0, "%", "mean"),
    ("heartbeat lag s", "raytpu_node_heartbeat_lag_s", "value", 1.0, "s", "max"),
    ("actor restarts", "raytpu_actor_restarts_total", "value", 1.0, "", "sum"),
    ("nodes drained", "raytpu_nodes_drained_total", "value", 1.0, "", "sum"),
    ("train goodput", "raytpu_train_goodput", "value", 1.0, "", "mean"),
    ("serve req/s", "raytpu_serve_requests_total", "rate", 1.0, "/s", "sum"),
    ("serve tok/s", "raytpu_serve_tokens_per_s", "value", 1.0, "/s", "sum"),
    ("kv pages used", "raytpu_kv_pages_used", "value", 1.0, "", "sum"),
    ("serve shed", "raytpu_serve_requests_shed_total", "value", 1.0, "", "sum"),
]

_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values, width: int = 32) -> str:
    """A Unicode block sparkline of the last `width` values, scaled to the
    window's own range (anchored at zero for non-negative series)."""
    vals = list(values)[-width:]
    if not vals:
        return ""
    if max(vals) == min(vals):
        return ("▄" if vals[0] else _SPARK_BLOCKS[0]) * len(vals)
    lo = min(min(vals), 0.0)
    span = max(vals) - lo
    return "".join(_SPARK_BLOCKS[min(7, int((v - lo) / span * 8))] for v in vals)


def render_top(fetch, alerts, window_s: float = 120.0, width: int = 32) -> str:
    """One `top` frame: the active alerts, then each key signal's current
    value and sparkline over the window. `fetch(metric, as_rate)` returns
    history series."""
    from .observability.history import merge_series

    lines = [f"ALERT {a['rule']}: {a['metric']}={a['value']:g} {a['op']} {a['threshold']:g}"
             for a in alerts] or ["alerts: none"]
    bucket_s = max(1.0, window_s / width)
    for label, metric, mode, scale, unit, agg in TOP_SIGNALS:
        try:
            series = fetch(metric, mode == "rate")
        except Exception:  # noqa: BLE001 - one signal's failure shows as no data
            series = []
        merged = merge_series(series, bucket_s=bucket_s, agg=agg)
        if not merged:
            lines.append(f"{label:<18} {'-':>12}       (no data)")
            continue
        values = [v * scale for _, v in merged]
        lines.append(f"{label:<18} {values[-1]:>12.6g}{unit:<5} {sparkline(values, width)}")
    return "\n".join(lines)


def cmd_top(args) -> None:
    """Live rates and sparklines of the key signals, from the GCS's metrics
    history."""
    _connect(args)
    from .utils import state

    n = 0
    while True:
        try:
            alerts = state.active_alerts()
        except Exception:  # noqa: BLE001 - shown as none
            alerts = []
        frame = render_top(lambda metric, as_rate: state.metrics_history(
            metric, None, args.window, as_rate), alerts, window_s=args.window)
        if n and sys.stdout.isatty():
            print("\x1b[2J\x1b[H", end="")
        print(frame)
        print(f"\n[{time.strftime('%H:%M:%S')}] window={args.window:g}s; ctrl-c to stop")
        n += 1
        if args.iterations and n >= args.iterations:
            return
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return


# --------------------------------------------------------- traces, debug
def cmd_timeline(args) -> None:
    _connect(args)
    from .utils import state

    events = state.timeline(args.out)
    n_spans = sum(1 for e in events if str(e.get("cat", "")).startswith("span"))
    extra = f" (+{n_spans} trace spans)" if n_spans else ""
    print(f"wrote {len(events)} task spans{extra} to {args.out} (open in Perfetto)")


def cmd_trace(args) -> None:
    """The whole Perfetto merge: every process's spans, flight dumps,
    profiles, the task table, metric counters and log records."""
    _connect(args)
    from .observability import perfetto
    from .utils import state

    try:
        metrics = state.internal_metrics()
    except Exception:  # noqa: BLE001 - the trace goes without counter tracks
        metrics = []
    try:
        log_records = state.cluster_logs(tail=20_000)
    except Exception:  # noqa: BLE001 - the trace goes without log instants
        log_records = []
    result = perfetto.export(path=args.out, task_events=state.task_timeline_events(),
                             metrics=metrics, log_records=log_records)
    s = result["summary"]
    print(f"wrote {s['events']} events to {args.out} ({s['spans']} spans, "
          f"{s['flows']} flow arrows, {s['flight_dumps']} flight dumps, "
          f"{s.get('profiles', 0)} profiles, {s.get('log_records', 0)} log records, "
          f"{s['task_events']} task rows)")


def _fan_out(nodes, call):
    """call(node) on every node at once (bounded), [(node, result or
    exception)]."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(64, max(1, len(nodes)))) as pool:
        futs = [(n, pool.submit(call, n)) for n in nodes]
        out = []
        for n, fut in futs:
            try:
                out.append((n, fut.result()))
            except Exception as e:  # noqa: BLE001 - reported per node by the caller
                out.append((n, e))
        return out


def cmd_debug(args) -> None:
    """`debug dump`: an incident harvest of every flight ring (raw per-node
    dumps when the harvest is off); `debug profile --seconds N`: every
    raylet samples its stacks for N seconds at once (the raylet's
    `profile` RPC) and leaves a dump that `trace` merges."""
    if args.action not in ("dump", "profile"):
        raise SystemExit(f"unknown debug action {args.action!r} (expected: dump | profile)")
    _connect(args)
    from .core.rpc import RpcClient
    from .utils import state

    alive = [n for n in state.list_nodes() if n.get("Alive")]
    if args.action == "profile":
        from .utils.sampling_profiler import profile_dir

        results = _fan_out(alive, lambda n: RpcClient(n["sock"], connect_timeout=5.0).call(
            "profile", args.seconds, timeout=args.seconds + 30.0))
        paths = []
        for n, res in results:
            if isinstance(res, Exception):
                print(f"warning: node {n['NodeID'][:12]} profile failed: {res}", file=sys.stderr)
            elif res.get("path"):
                paths.append(res["path"])
                print(f"node {n['NodeID'][:12]}: {res['samples']} samples -> {res['path']}")
        print(f"wrote {len(paths)} profiles under {profile_dir()}")
        return
    from .observability import flight_recorder

    flight_recorder.dump(reason="debug dump (cli)")
    try:
        harvest = state._gcs().call("debug_harvest", timeout=45.0)
    except Exception as e:  # noqa: BLE001 - the raw dumps below instead
        harvest = {"ok": False, "reason": repr(e)}
    if harvest.get("ok") and harvest.get("bundle"):
        print(f"incident {harvest['incident']} staged "
              f"({len(harvest.get('triggers', []))} trigger(s))")
        print(f"bundle: {harvest['bundle']}")
        print(f"inspect with: python -m ray_tpu_torch.scripts postmortem {harvest['incident']}")
        return
    print(f"warning: incident harvest unavailable ({harvest.get('reason', 'unknown')}); "
          "falling back to raw dumps", file=sys.stderr)
    dumped, signaled = [], 0
    for n, res in _fan_out(alive, lambda n: RpcClient(n["sock"], connect_timeout=5.0).call(
            "flight_dump", timeout=10.0)):
        if isinstance(res, Exception):
            print(f"warning: node {n['NodeID'][:12]} dump failed: {res}", file=sys.stderr)
            continue
        if res.get("path"):
            dumped.append(res["path"])
        signaled += res.get("workers_signaled", 0)
    print(f"wrote {len(dumped)} flight-recorder dumps (+{signaled} workers signaled) "
          f"under {flight_recorder.flight_dir()}")


def cmd_postmortem(args) -> None:
    """The markdown report of a staged incident bundle, or the list of
    bundles; works on bundles left on disk, with no cluster up."""
    from .observability import postmortem

    roots = []
    try:
        addr = _resolve_address(args)
        if addr and not addr.startswith("tcp://") and os.path.isdir(addr):
            roots.append(postmortem.incidents_dir(addr))
    except SystemExit:
        pass
    default_root = postmortem.incidents_dir(None)
    if default_root not in roots:
        roots.append(default_root)
    if not args.incident:
        rows = [b for root in roots for b in postmortem.list_bundles(root)]
        if not rows:
            print(f"no incident bundles under {' or '.join(roots)}")
            return
        for b in rows:
            print(f"{b['incident_id']}  trigger={b['trigger']}  triggers={b['triggers']}  "
                  f"nodes={b['nodes']}  {b['bundle']}")
        return
    bundle = postmortem.find_bundle(args.incident, roots)
    if bundle is None:
        raise SystemExit(f"no unique incident matches {args.incident!r} under "
                         f"{' or '.join(roots)}")
    report = postmortem.render_report(bundle, last_n=args.last)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report)
        print(f"wrote {args.out}")
    else:
        print(report)


def cmd_dashboard(args) -> None:
    _connect(args)
    from .dashboard import start_dashboard

    port = start_dashboard(port=args.port)
    print(f"dashboard at http://127.0.0.1:{port}/ (ctrl-c to stop)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["_keep"]:
        _keep(argv[1])
        return
    ap = argparse.ArgumentParser(prog="ray-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("start", help="start a cluster head (or join one with --address)")
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-gpus", type=float, default=None,
                   help="GPUs of this node (default: the CUDA devices torch counts)")
    p.add_argument("--resources", default=None, help="JSON dict of custom resources")
    p.add_argument("--object-store-memory", type=int, default=None)
    p.add_argument("--port", type=int, default=None,
                   help="also serve the GCS on tcp://<node-ip>:<port> (0: any free port)")
    p.add_argument("--node-ip-address", default=None)
    p.add_argument("--address", default=None,
                   help="join a running cluster: its head's tcp://host:port GCS endpoint")
    p.add_argument("--labels", default=None, help="JSON dict of node labels")
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("up", help="bring a cluster to its configured size from a config")
    p.add_argument("config", help="cluster config (JSON, or YAML where yaml imports)")
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--force", action="store_true", help="ignore recorded state")
    p.set_defaults(fn=cmd_up)

    p = sub.add_parser("down", help="stop a cluster started with `up`")
    p.add_argument("config", help="the config given to `up`")
    p.set_defaults(fn=cmd_down)

    p = sub.add_parser("stop", help="stop the cluster")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_stop)

    p = sub.add_parser("status", help="nodes, tasks, store, alerts")
    p.add_argument("--verbose", action="store_true", help="each node's warm pool")
    p.add_argument("--summary", action="store_true",
                   help=f"the rollup only (on by itself above {_STATUS_AUTO_SUMMARY} nodes)")
    p.add_argument("--limit", type=int, default=None, help="at most N node rows")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("submit", help="submit a job entrypoint command")
    p.add_argument("--address", default=None)
    p.add_argument("--wait", action="store_true", help="block until the job ends")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("entrypoint", nargs=argparse.REMAINDER)
    p.set_defaults(fn=cmd_submit)

    p = sub.add_parser("jobs", help="list submitted jobs")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_jobs)

    p = sub.add_parser("logs", help="query cluster logs; with a job id, its output")
    p.add_argument("--address", default=None)
    p.add_argument("job_id", nargs="?", default=None)
    p.add_argument("--node", default=None, help="node id prefix")
    p.add_argument("--actor", default=None, help="actor id prefix or actor name")
    p.add_argument("--task", default=None, help="task id prefix")
    p.add_argument("--component", default=None, help="e.g. raylet, worker, stdout, stderr")
    p.add_argument("--level", default=None, help="minimum level (DEBUG/INFO/WARNING/ERROR)")
    p.add_argument("--grep", default=None, help="substring of the message")
    p.add_argument("--follow", "-f", action="store_true", help="keep polling")
    p.add_argument("--tail", type=int, default=100, help="the newest N records")
    p.set_defaults(fn=cmd_logs)

    p = sub.add_parser("metrics", help="internal and user metrics as a table")
    p.add_argument("--address", default=None)
    p.add_argument("--filter", default=None, help="only names containing this")
    p.add_argument("--watch", action="store_true", help="rates per tick")
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--iterations", type=int, default=0, help="stop --watch after N ticks")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("top", help="live signals: rates and sparklines from the history")
    p.add_argument("--address", default=None)
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--window", type=float, default=120.0)
    p.add_argument("--iterations", type=int, default=0, help="stop after N frames")
    p.set_defaults(fn=cmd_top)

    p = sub.add_parser("dashboard", help="serve the cluster dashboard")
    p.add_argument("--address", default=None)
    p.add_argument("--port", type=int, default=8265, help="0: any free port")
    p.set_defaults(fn=cmd_dashboard)

    p = sub.add_parser("timeline", help="a chrome trace of the task table")
    p.add_argument("--address", default=None)
    p.add_argument("--out", default="ray_tpu_torch_timeline.json")
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser("trace", help="the whole Perfetto trace")
    p.add_argument("--address", default=None)
    p.add_argument("--out", default="trace.json")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("debug", help="`debug dump` (flight rings) or `debug profile`")
    p.add_argument("action", help="dump | profile")
    p.add_argument("--address", default=None)
    p.add_argument("--seconds", type=float, default=5.0, help="profile length per node")
    p.set_defaults(fn=cmd_debug)

    p = sub.add_parser("postmortem", help="render an incident report (none: list them)")
    p.add_argument("incident", nargs="?", default=None)
    p.add_argument("--address", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--last", type=int, default=20, help="flight events per process")
    p.set_defaults(fn=cmd_postmortem)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
