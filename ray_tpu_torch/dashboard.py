"""Dashboard: an HTTP view of the cluster's state (the port of
ray_tpu/dashboard.py).

Re-design of the reference's dashboard (reference:
python/ray/dashboard/dashboard.py and its node, actor and job modules, an
aiohttp app with a React frontend). Here a stdlib threaded HTTP server in
the calling process serves the state API as JSON: `/api/{nodes,actors,
tasks,objects,placement_groups,stats,metrics,internal_metrics,alerts,
errors,jobs}`, the Prometheus text at `/metrics` (`prometheus_text`), the
metrics history at `/api/metrics_history?name=&window_s=&rate=1&tag.<k>=`,
the cluster's structured logs at `/api/logs?node=&actor=&task=&component=&
level=&grep=&tail=`, the REST job API (`POST /api/jobs`, `GET
/api/jobs/<id>`, `/api/jobs/<id>/logs`, `POST /api/jobs/<id>/stop`), and a
self-contained HTML overview at `/`.

    from ray_tpu_torch.dashboard import start_dashboard
    port = start_dashboard(port=0)   # 0: any free port; returns the bound one
    # or: python -m ray_tpu_torch.scripts dashboard --port 0

It needs an initialised runtime on a cluster (`init()` or
`init(address=...)`). This module never imports torch.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, Optional

_PAGE = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title>
<style>
body { font-family: monospace; margin: 2em; }
table { border-collapse: collapse; margin-bottom: 2em; }
td, th { border: 1px solid #999; padding: 4px 8px; text-align: left; }
h2 { margin-bottom: 0.3em; }
</style></head>
<body>
<h1>ray_tpu_torch cluster</h1>
<div id="content">loading...</div>
<script>
// User-controlled strings (names, entrypoints) must never reach innerHTML raw.
const esc = s => String(s).replace(/[&<>"']/g,
  c => ({"&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;"}[c]));
async function refresh() {
  const [stats, nodes, actors, jobs] = await Promise.all(
    ["stats", "nodes", "actors", "jobs"].map(p => fetch("/api/" + p).then(r => r.json())));
  let html = "<h2>Stats</h2><pre>" + esc(JSON.stringify(stats, null, 2)) + "</pre>";
  html += "<h2>Nodes</h2><table><tr><th>id</th><th>alive</th><th>resources</th><th>available</th></tr>";
  for (const n of nodes) html += `<tr><td>${esc(n.NodeID.slice(0,12))}</td><td>${n.Alive}</td>` +
    `<td>${esc(JSON.stringify(n.Resources))}</td><td>${esc(JSON.stringify(n.Available))}</td></tr>`;
  html += "</table><h2>Actors</h2><table><tr><th>id</th><th>state</th><th>name</th><th>restarts</th></tr>";
  for (const a of actors) html += `<tr><td>${esc(a.actor_id.slice(0,12))}</td><td>${esc(a.state)}</td>` +
    `<td>${esc(a.name || "")}</td><td>${a.num_restarts}</td></tr>`;
  html += "</table><h2>Jobs</h2><table><tr><th>id</th><th>status</th><th>entrypoint</th></tr>";
  for (const j of jobs) html += `<tr><td>${esc(j.job_id)}</td><td>${esc(j.status)}</td><td>${esc(j.entrypoint)}</td></tr>`;
  html += "</table>";
  document.getElementById("content").innerHTML = html;
}
refresh(); setInterval(refresh, 2000);
</script>
</body></html>
"""


def _prom_name(name: str) -> str:
    import re

    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _prom_tags(tags: Dict[str, Any]) -> str:
    if not tags:
        return ""
    def esc(v: Any) -> str:
        # Prometheus label escaping: backslash, double-quote, newline.
        return (
            str(v)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n")
        )

    inner = ",".join(
        f'{_prom_name(str(k))}="{esc(v)}"' for k, v in sorted(tags.items())
    )
    return "{" + inner + "}"


def prometheus_text(
    stats: dict,
    user_metrics: list,
    internal_metrics: Optional[list] = None,
    help_texts: Optional[Dict[str, str]] = None,
) -> str:
    """Prometheus text exposition of runtime + internal + user metrics
    (reference: _private/metrics_agent.py:483 — the OpenCensus->Prometheus
    exporter every node agent runs; here one cluster-level scrape target).

    Exposition-format correctness the parser round-trip test pins down:
    label values escape `\\`, `"`, and newlines; `# TYPE`/`# HELP` appear
    exactly ONCE per metric family even when a name has many tag sets or
    appears in both the internal and user tables; histogram series carry
    the `_bucket`/`_sum`/`_count` suffixes with a closing `+Inf` bucket."""
    families: "Dict[str, dict]" = {}
    order: list = []

    def _family(name: str, mtype: str, help_text: str = ""):
        pname = _prom_name(name)
        fam = families.get(pname)
        if fam is None:
            fam = {"type": mtype, "help": help_text, "lines": []}
            families[pname] = fam
            order.append(pname)
        elif fam["type"] != mtype:
            return None, None  # kind collision: first declaration wins
        if help_text and not fam["help"]:
            fam["help"] = help_text
        return pname, fam

    def emit(name, mtype, samples, help_text=""):
        pname, fam = _family(name, mtype, help_text)
        if fam is None:
            return
        for tags, val in samples:
            fam["lines"].append(f"{pname}{_prom_tags(tags)} {val}")

    def emit_histogram(name, entries, help_text=""):
        pname, fam = _family(name, "histogram", help_text)
        if fam is None:
            return
        for e in entries:
            tags = e.get("tags") or {}
            bounds = e.get("boundaries") or []
            counts = e.get("counts") or []
            cum = 0
            for b, c in zip(bounds, counts):
                cum += c
                fam["lines"].append(
                    f"{pname}_bucket{_prom_tags({**tags, 'le': b})} {cum}"
                )
            total = sum(counts)
            fam["lines"].append(
                f"{pname}_bucket{_prom_tags({**tags, 'le': '+Inf'})} {total}"
            )
            fam["lines"].append(f"{pname}_sum{_prom_tags(tags)} {e.get('value', 0.0)}")
            fam["lines"].append(f"{pname}_count{_prom_tags(tags)} {total}")

    emit("ray_tpu_nodes_alive", "gauge", [({}, stats.get("nodes_alive", 0))],
         "Alive raylet count")
    emit("ray_tpu_tasks", "gauge",
         [({"state": s}, c) for s, c in (stats.get("tasks") or {}).items()],
         "Task-table entries by state")
    emit("ray_tpu_actors", "gauge",
         [({"state": s}, c) for s, c in (stats.get("actors") or {}).items()],
         "Actors by state")
    store = stats.get("store") or {}
    emit("ray_tpu_object_store_bytes_in_use", "gauge",
         [({}, store.get("bytes_in_use", 0))])
    emit("ray_tpu_object_store_objects", "gauge",
         [({}, store.get("num_objects", 0))])
    emit("ray_tpu_objects_spilled", "gauge", [({}, store.get("num_spilled", 0))])
    emit("ray_tpu_placement_groups", "gauge",
         [({}, stats.get("placement_groups", 0))])

    helps = dict(help_texts or {})
    by_name: Dict[str, list] = {}
    for m in list(internal_metrics or []) + list(user_metrics or []):
        by_name.setdefault(m["name"], []).append(m)
    for name, entries in sorted(by_name.items()):
        kind = entries[0].get("kind")
        # Kind collision inside one family (e.g. a user metric reusing an
        # internal name with a different kind): first declaration wins,
        # mismatched samples are dropped rather than mislabeled.
        entries = [e for e in entries if e.get("kind") == kind]
        help_text = helps.get(name, "")
        if kind == "counter":
            emit(name, "counter",
                 [(e.get("tags") or {}, e.get("value", 0.0)) for e in entries],
                 help_text)
        elif kind == "gauge":
            emit(name, "gauge",
                 [(e.get("tags") or {}, e.get("value", 0.0)) for e in entries],
                 help_text)
        elif kind == "histogram":
            emit_histogram(name, entries, help_text)

    lines = []
    for pname in order:
        fam = families[pname]
        if fam["help"]:
            # HELP text is a raw escape context: backslash and newline only.
            help_esc = fam["help"].replace("\\", "\\\\").replace("\n", "\\n")
            lines.append(f"# HELP {pname} {help_esc}")
        lines.append(f"# TYPE {pname} {fam['type']}")
        lines.extend(fam["lines"])
    return "\n".join(lines) + "\n"


class _Dashboard:
    def __init__(self, host: str = "127.0.0.1", port: int = 8265):
        import http.server
        import socketserver

        from .core import runtime_base

        rt = runtime_base.current_runtime()
        gcs = rt._gcs

        def collect(path: str) -> Any:
            if path == "nodes":
                return gcs.call("list_nodes")
            if path == "actors":
                return gcs.call("list_actors", 1000)
            if path == "tasks":
                return gcs.call("list_tasks", 1000)
            if path == "objects":
                return gcs.call("list_objects", 1000)
            if path == "placement_groups":
                return gcs.call("placement_group_table")
            if path == "stats":
                return gcs.call("stats")
            if path == "metrics":
                return gcs.call("user_metrics")
            if path == "internal_metrics":
                return gcs.call("internal_metrics")
            if path == "alerts":
                return gcs.call("active_alerts")
            if path == "errors":
                return gcs.call("cluster_errors", 100)
            if path == "jobs":
                from .jobs import list_job_records

                return list_job_records(gcs)
            raise KeyError(path)

        job_client_box: Dict[str, Any] = {}

        def job_client():
            # Lazy: the dashboard may outlive/predate job use entirely.
            cli = job_client_box.get("cli")
            if cli is None:
                from .jobs import JobSubmissionClient

                cli = JobSubmissionClient()
                job_client_box["cli"] = cli
            return cli

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._reply(200, _PAGE.encode(), "text/html; charset=utf-8")
                    return
                if self.path == "/metrics":
                    # Prometheus text exposition (reference:
                    # metrics_agent.py:483 Prometheus exporter).
                    try:
                        from .utils import internal_metrics as _imet

                        text = prometheus_text(
                            gcs.call("stats"),
                            gcs.call("user_metrics"),
                            gcs.call("internal_metrics"),
                            _imet.help_texts(),
                        )
                        self._reply(
                            200, text.encode(), "text/plain; version=0.0.4"
                        )
                    except Exception as e:  # noqa: BLE001
                        self._reply(500, json.dumps({"error": repr(e)}).encode())
                    return
                if self.path.startswith("/api/metrics_history"):
                    # Time-series query route: ?name=...&window_s=...&
                    # rate=1&tag.<key>=<value> (tag.* are subset filters).
                    from urllib.parse import parse_qs, urlparse

                    try:
                        q = parse_qs(urlparse(self.path).query)
                        name = (q.get("name") or [None])[0]
                        raw_window = (q.get("window_s") or [None])[0]
                        window_s = float(raw_window) if raw_window else None
                        as_rate = (q.get("rate") or ["0"])[0] in ("1", "true")
                        tags = {
                            k[len("tag."):]: v[0]
                            for k, v in q.items()
                            if k.startswith("tag.")
                        }
                        series = gcs.call(
                            "metrics_history", name, tags or None, window_s, as_rate
                        )
                        self._reply(200, json.dumps(series, default=str).encode())
                    except Exception as e:  # noqa: BLE001
                        self._reply(500, json.dumps({"error": repr(e)}).encode())
                    return
                if self.path.startswith("/api/logs"):
                    # Structured log query (reference: the dashboard's
                    # /api/v0/logs state route): ?node=&actor=&task=&
                    # component=&level=&grep=&tail=N — fans tail_logs out
                    # to every raylet via observability.logs.
                    from urllib.parse import parse_qs, urlparse

                    try:
                        from .observability import logs as obslogs

                        q = parse_qs(urlparse(self.path).query)

                        def one(key):
                            return (q.get(key) or [None])[0]

                        filters = {
                            "component": one("component"),
                            "level": one("level"),
                            "task_id": one("task"),
                            "actor_id": one("actor"),
                            "worker_id": one("worker"),
                            "grep": one("grep"),
                        }
                        filters = {k: v for k, v in filters.items() if v}
                        records = obslogs.query_cluster(
                            gcs,
                            node=one("node"),
                            tail=int(one("tail") or 1000),
                            **filters,
                        )
                        self._reply(200, json.dumps(records, default=str).encode())
                    except Exception as e:  # noqa: BLE001
                        self._reply(500, json.dumps({"error": repr(e)}).encode())
                    return
                if self.path.startswith("/api/jobs/"):
                    # REST job API (reference: dashboard/modules/job/job_head.py)
                    rest = self.path[len("/api/jobs/"):]
                    try:
                        if rest.endswith("/logs"):
                            logs = job_client().get_job_logs(rest[: -len("/logs")])
                            self._reply(200, json.dumps({"logs": logs}).encode())
                        else:
                            self._reply(
                                200,
                                json.dumps(
                                    job_client().get_job_info(rest), default=str
                                ).encode(),
                            )
                    except KeyError:
                        self._reply(404, b'{"error": "no such job"}')
                    except Exception as e:  # noqa: BLE001
                        self._reply(500, json.dumps({"error": repr(e)}).encode())
                    return
                if self.path.startswith("/api/"):
                    try:
                        body = json.dumps(collect(self.path[len("/api/"):]), default=str).encode()
                        self._reply(200, body)
                    except KeyError:
                        self._reply(404, b'{"error": "unknown endpoint"}')
                    except Exception as e:  # noqa: BLE001
                        self._reply(500, json.dumps({"error": repr(e)}).encode())
                    return
                self._reply(404, b"not found", "text/plain")

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b"{}"
                try:
                    payload = json.loads(raw or b"{}")
                except Exception:
                    self._reply(400, b'{"error": "bad json"}')
                    return
                try:
                    if self.path == "/api/jobs":
                        job_id = job_client().submit_job(
                            entrypoint=payload["entrypoint"],
                            runtime_env=payload.get("runtime_env"),
                            job_id=payload.get("job_id"),
                        )
                        self._reply(200, json.dumps({"job_id": job_id}).encode())
                        return
                    if self.path.startswith("/api/jobs/") and self.path.endswith("/stop"):
                        jid = self.path[len("/api/jobs/"):-len("/stop")]
                        ok = job_client().stop_job(jid)
                        self._reply(200, json.dumps({"stopped": ok}).encode())
                        return
                except KeyError as e:
                    self._reply(400, json.dumps({"error": f"missing {e}"}).encode())
                    return
                except Exception as e:  # noqa: BLE001
                    self._reply(500, json.dumps({"error": repr(e)}).encode())
                    return
                self._reply(404, b'{"error": "unknown endpoint"}')

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True).start()

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()


_dashboard: Optional[_Dashboard] = None


def start_dashboard(port: int = 8265, host: str = "127.0.0.1") -> int:
    """Starts (or returns) the dashboard; returns the bound port."""
    global _dashboard
    if _dashboard is None:
        _dashboard = _Dashboard(host=host, port=port)
    return _dashboard.port


def stop_dashboard() -> None:
    global _dashboard
    if _dashboard is not None:
        _dashboard.shutdown()
        _dashboard = None
