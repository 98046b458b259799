"""Anomaly trigger bus + incident bundles + post-mortem reports (the port
of ray_tpu/observability/postmortem.py).

1. **Trigger bus (client half).** Anomaly sites (node death and fencing in
   the GCS, a chaos injection, a collective's terminal timeout) call
   `publish_trigger("<kind>", detail)`. Disarmed cost is one global load +
   None check; armed, the call forwards to the GCS `report_trigger` RPC (or
   the in-process GcsService), best-effort and per-kind debounced so a
   trigger storm costs one RPC per kind per window. The GCS side
   (core/gcs.py `_trigger`) coalesces further: triggers inside the window
   join the open incident's chain instead of opening a new harvest.

2. **Incident bundles.** The GCS harvest calls `flight_dump` on every
   raylet (each SIGUSR2s its workers so their rings land too), tails the
   structured logs, and stages everything with a manifest under
   `<session_dir>/incidents/<incident_id>/` (`stage_bundle`).

3. **Clock-skew-corrected merge.** Each heartbeat carries the raylet's
   wall-clock send time; the GCS records `offset ~ gcs_now - send_time` per
   node and the manifest maps every harvested pid to its node's offset.
   `merge_trace` shifts per-pid flight and span timestamps onto the GCS
   clock before handing them to perfetto.build_trace, and adds trigger
   markers: one causally ordered timeline even when node clocks disagree.

4. **Reports.** `render_report` turns a bundle into a markdown incident
   report: trigger chain, suspect channel/rank/node, the last N flight
   events per involved process, and the goodput/MFU impact window
   (`python -m ray_tpu_torch.scripts postmortem [incident]`).

Env knobs:
- RAY_TPU_POSTMORTEM=0          disable the bus entirely (GCS side)
- RAY_TPU_TRIGGER_DEBOUNCE_S    client per-kind republish window (default 1.0)
- RAY_TPU_INCIDENT_WINDOW_S     GCS coalesce window (default 10.0)
- RAY_TPU_HARVEST_DELAY_S       settle delay before the harvest fan-out
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .flight_recorder import record as _flight_record

# Catalog of anomaly trigger kinds, closed: the JAX package's for the sites
# the port has.
TRIGGERS = {
    "watchdog.alert": "SLO watchdog rule transitioned to firing",
    "node.dead": "heartbeat-timeout node death declared by the GCS",
    "node.fenced": "dead-marked incarnation resumed RPCs and was fenced",
    "cgraph.timeout": "compiled-graph execute()/get() timed out on a channel",
    "cgraph.crash": "compiled-graph exec loop died on an actor",
    "chaos.inject": "chaos controller armed a fault at an injection point",
    "coll.timeout": "collective op/rendezvous timeout naming a stalled rank",
    "job.failed": "submitted job entrypoint exited nonzero",
    "debug.manual": "operator-requested harvest (GcsService.debug_harvest)",
}

MANIFEST_NAME = "manifest.json"
TRACE_NAME = "trace.json"
REPORT_NAME = "report.md"

_lock = threading.Lock()
_publisher: Optional[Callable[[str, Any, Optional[str]], Any]] = None
_last_sent: Dict[str, float] = {}


_debounce_cache: Optional[float] = None


def _debounce_s() -> float:
    """Debounce window, cached after the first read: this sits on the
    armed trigger-storm path. Invalidated by arm()/disarm(), so the env
    knob is re-read whenever the bus is (re)armed."""
    global _debounce_cache
    val = _debounce_cache
    if val is None:
        raw = os.environ.get("RAY_TPU_TRIGGER_DEBOUNCE_S")
        try:
            val = float(raw) if raw is not None else 1.0
        except ValueError:
            val = 1.0
        _debounce_cache = val
    return val


# ------------------------------------------------------- trigger bus (client)
def arm(publisher: Callable[[str, Any, Optional[str]], Any]) -> None:
    """Arms this process's trigger bus. `publisher(kind, detail, source)`
    delivers one trigger — the GCS arms its in-process `_trigger`,
    everything else arms a GCS-RPC forwarder via `arm_client`."""
    global _publisher, _debounce_cache
    with _lock:
        _publisher = publisher
        _last_sent.clear()
        _debounce_cache = None


def arm_client(gcs_client: Any) -> Callable[[str, Any, Optional[str]], Any]:
    """Arms with a forwarder over an existing GCS RpcClient (driver,
    raylet, and worker processes — anything holding a control-plane
    handle). Returns the forwarder, so its owner disarms only its own arm
    (`disarm(forwarder)`): a process that swaps runtimes keeps the newer
    one's."""

    def _forward(kind: str, detail: Any, source: Optional[str]) -> Any:
        # Bounded: trigger sites sit on hot paths (chaos injection in
        # task exec, collective timeouts) and the GCS may be the thing
        # that died — an unbounded call would wedge the publisher on a
        # half-closed socket instead of dropping the trigger.
        return gcs_client.call("report_trigger", kind, detail, source, timeout=2.0)

    arm(_forward)
    return _forward


def disarm(publisher: Optional[Callable] = None) -> None:
    """Disarms the bus; with `publisher` given, only if it is still the
    armed one (a stopped in-process GCS must not disarm a newer arm)."""
    global _publisher, _debounce_cache
    with _lock:
        # `==`, not `is`: bound methods (GcsService._trigger) are fresh
        # objects per attribute access but compare equal by (func, self).
        if publisher is None or _publisher == publisher:
            _publisher = None
            _last_sent.clear()
            _debounce_cache = None


def armed() -> bool:
    return _publisher is not None


def publish_trigger(
    kind: str, detail: Any = None, source: Optional[str] = None
) -> Any:
    """One anomaly trigger. Disarmed: a global load + None check and out.
    Armed: per-kind debounced —
    the window is set BEFORE the forward, so a trigger raised while
    delivering a trigger (e.g. a chaos net fault on the publish RPC
    itself) short-circuits instead of recursing — then forwarded
    best-effort; a dead/partitioned GCS must never turn an anomaly
    report into a second failure."""
    pub = _publisher
    if pub is None:
        return None
    now = time.monotonic()
    last = _last_sent.get(kind)
    if last is not None and now - last < _debounce_s():
        return None
    _last_sent[kind] = now
    _flight_record("trigger.publish", (kind, source))
    try:
        return pub(kind, detail, source)
    except Exception:  # noqa: BLE001 - trigger delivery is best-effort; the anomaly path must not fail twice
        return None


def safe_detail(detail: Any, limit: int = 400) -> Any:
    """A JSON-safe, bounded rendering of a trigger detail (details ride
    RPCs, pubsub events, and the manifest — an exception object or a
    10 MB payload must not)."""
    if detail is None or isinstance(detail, (bool, int, float)):
        return detail
    if isinstance(detail, str):
        return detail[:limit]
    if isinstance(detail, dict):
        return {str(k)[:80]: safe_detail(v, limit) for k, v in list(detail.items())[:20]}
    if isinstance(detail, (list, tuple)):
        return [safe_detail(v, limit) for v in list(detail)[:20]]
    return repr(detail)[:limit]


# ----------------------------------------------------------- bundle staging
def incidents_dir(session_dir: Optional[str] = None) -> str:
    """Where incident bundles live: under the session dir when known,
    else beside the flight/span dirs so an in-process GCS (unit tests)
    still stages somewhere `list_bundles` can find."""
    if session_dir:
        return os.path.join(session_dir, "incidents")
    from .. import tracing

    return os.path.join(tracing.trace_dir(), "incidents")


def stage_bundle(
    bundle_dir: str,
    manifest: Dict[str, Any],
    flight_src: Optional[str] = None,
    trace_src: Optional[str] = None,
    log_records: Optional[List[dict]] = None,
    metrics: Optional[List[dict]] = None,
    max_age_s: float = 3600.0,
) -> str:
    """Stages one incident bundle: copies flight dumps and span JSONL
    (recent files only — a long session's stale dumps are another
    incident's story), writes log tails and the frozen metrics window,
    and lands the manifest LAST so a manifest's presence marks the
    bundle complete. Returns the bundle dir."""
    from . import flight_recorder
    from .. import tracing

    flight_dst = os.path.join(bundle_dir, "flight")
    spans_dst = os.path.join(bundle_dir, "spans")
    os.makedirs(flight_dst, exist_ok=True)
    os.makedirs(spans_dst, exist_ok=True)
    now = time.time()
    for src, dst, prefix, suffix in (
        (flight_src or flight_recorder.flight_dir(), flight_dst, "flight_", ".json"),
        (trace_src or tracing.trace_dir(), spans_dst, "spans_", ".jsonl"),
    ):
        try:
            names = sorted(os.listdir(src))
        except OSError:
            continue
        for fname in names:
            if not (fname.startswith(prefix) and fname.endswith(suffix)):
                continue
            path = os.path.join(src, fname)
            try:
                if now - os.path.getmtime(path) > max_age_s:
                    continue
                shutil.copy2(path, os.path.join(dst, fname))
            except OSError:
                continue  # racing a writer/GC; the bundle keeps the rest
    if log_records:
        with open(os.path.join(bundle_dir, "logs.jsonl"), "w") as f:
            for rec in log_records:
                f.write(json.dumps(rec, default=repr) + "\n")
    if metrics is not None:
        with open(os.path.join(bundle_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, default=repr)
    tmp = os.path.join(bundle_dir, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, default=repr, indent=2)
    os.replace(tmp, os.path.join(bundle_dir, MANIFEST_NAME))
    return bundle_dir


def load_manifest(bundle_dir: str) -> Dict[str, Any]:
    with open(os.path.join(bundle_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    if not isinstance(manifest, dict):
        raise ValueError(f"malformed incident manifest in {bundle_dir!r}")
    return manifest


def list_bundles(root: str) -> List[Dict[str, Any]]:
    """Incident summaries under one incidents dir, oldest first. Only
    directories with a complete manifest count — a harvest in flight is
    not yet an incident anyone can read."""
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return out
    for name in names:
        bundle = os.path.join(root, name)
        try:
            manifest = load_manifest(bundle)
        except (OSError, ValueError):
            continue
        triggers = manifest.get("triggers") or []
        out.append(
            {
                "incident_id": manifest.get("incident_id", name),
                "bundle": bundle,
                "opened_ts": manifest.get("opened_ts"),
                "trigger": (triggers[0].get("kind") if triggers else None),
                "triggers": len(triggers),
                "nodes": len(manifest.get("nodes") or {}),
            }
        )
    return out


def find_bundle(token: str, roots: List[str]) -> Optional[str]:
    """Resolves an `<incident>` token: a bundle dir path, an exact
    incident id, or an unambiguous id prefix under any of `roots`."""
    if os.path.isfile(os.path.join(token, MANIFEST_NAME)):
        return token
    matches: List[str] = []
    for root in roots:
        try:
            names = sorted(os.listdir(root))
        except OSError:
            continue
        for name in names:
            if name == token:
                return os.path.join(root, name)
            if name.startswith(token):
                matches.append(os.path.join(root, name))
    return matches[0] if len(matches) == 1 else None


# ---------------------------------------------------- clock-skew-corrected merge
def _pid_offsets(manifest: Dict[str, Any]) -> Dict[int, int]:
    """pid -> offset_us from the manifest (adding the offset moves a
    pid's local timestamps onto the GCS clock)."""
    out: Dict[int, int] = {}
    for pid, info in (manifest.get("pids") or {}).items():
        try:
            out[int(pid)] = int((info or {}).get("offset_us") or 0)
        except (TypeError, ValueError):
            continue
    return out


def _shift_dump(dump: dict, offset_us: int) -> dict:
    shifted = dict(dump)
    if isinstance(shifted.get("dump_us"), (int, float)):
        shifted["dump_us"] = int(shifted["dump_us"]) + offset_us
    events = []
    for ev in shifted.get("events", ()):
        # JSON round-trips the ring tuples as [ts_us, kind, detail] lists.
        if isinstance(ev, (list, tuple)) and len(ev) >= 2 and isinstance(ev[0], (int, float)):
            events.append([int(ev[0]) + offset_us] + list(ev[1:]))
        else:
            events.append(ev)
    shifted["events"] = events
    return shifted


def _shift_span(span: dict, offset_us: int) -> dict:
    shifted = dict(span)
    for key in ("start_us", "end_us"):
        if isinstance(shifted.get(key), (int, float)):
            shifted[key] = int(shifted[key]) + offset_us
    return shifted


def trigger_marker_events(triggers: List[dict]) -> List[dict]:
    """Global instant markers for the trigger chain (GCS-clock
    timestamps — the merge's reference frame, no shift needed)."""
    events: List[dict] = []
    for trig in triggers:
        ts_us = trig.get("ts_us")
        if not isinstance(ts_us, (int, float)):
            continue
        events.append(
            {
                "name": f"trigger:{trig.get('kind', '?')}",
                "cat": "trigger",
                "ph": "i",
                "s": "g",
                "ts": int(ts_us),
                "pid": "incident",
                "tid": "triggers",
                "args": {
                    "detail": trig.get("detail"),
                    "source": trig.get("source"),
                },
            }
        )
    return events


def merge_trace(
    bundle_dir: str, out_path: Optional[str] = None
) -> Dict[str, Any]:
    """The bundle's single causally-ordered Perfetto trace: per-pid
    flight/span timestamps are shifted by their node's sampled clock
    offset onto the GCS clock, then interleaved with the trigger
    markers and staged log tails through perfetto.build_trace. Writes
    `<bundle>/trace.json` (or `out_path`) and returns the trace dict."""
    from . import flight_recorder, perfetto
    from .. import tracing

    manifest = load_manifest(bundle_dir)
    offsets = _pid_offsets(manifest)
    dumps = [
        _shift_dump(d, offsets.get(int(d.get("pid") or 0), 0))
        for d in flight_recorder.collect(os.path.join(bundle_dir, "flight"))
    ]
    spans = [
        _shift_span(s, offsets.get(int(s.get("pid") or 0), 0))
        for s in tracing.collect(os.path.join(bundle_dir, "spans"))
    ]
    log_records: List[dict] = []
    try:
        with open(os.path.join(bundle_dir, "logs.jsonl"), errors="replace") as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    log_records.append(rec)
    except OSError:
        pass
    trace = perfetto.build_trace(
        spans=spans,
        dumps=dumps,
        task_events=trigger_marker_events(manifest.get("triggers") or []),
        log_records=log_records,
    )
    path = out_path or os.path.join(bundle_dir, TRACE_NAME)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(trace, f, default=repr)
    os.replace(tmp, path)
    return trace


# ------------------------------------------------------------ suspect + report
_SUSPECT_PREFIXES = ("coll.", "chan.", "net.", "cgraph.")


def infer_suspect(
    manifest: Dict[str, Any], dumps: List[dict]
) -> Dict[str, Any]:
    """Best-effort suspect naming: typed trigger details first (a
    collective timeout NAMES the stalled rank; a node death names the
    node), else the newest blocked-looking flight event (`coll.*` /
    `chan.*_wait` / `net.drop`) across the harvested rings."""
    for trig in manifest.get("triggers") or []:
        kind = trig.get("kind")
        detail = trig.get("detail")
        if kind == "coll.timeout":
            return {
                "kind": "stalled rank",
                "what": f"collective timeout — {detail!r}",
            }
        if kind == "cgraph.timeout":
            return {
                "kind": "blocked channel",
                "what": f"cgraph execute timeout — {detail!r}",
            }
        if kind in ("node.dead", "node.fenced"):
            return {"kind": "node", "what": f"{kind} — {detail!r}"}
    best: Optional[Tuple[int, str, Any, Any]] = None
    for dump in dumps:
        for ev in dump.get("events", ()):
            if not (isinstance(ev, (list, tuple)) and len(ev) >= 2):
                continue
            ts, kind = ev[0], str(ev[1])
            interesting = kind.startswith(_SUSPECT_PREFIXES) and (
                "wait" in kind or "timeout" in kind or "drop" in kind
            )
            if interesting and isinstance(ts, (int, float)):
                if best is None or ts > best[0]:
                    detail = ev[2] if len(ev) > 2 else None
                    best = (int(ts), kind, detail, dump.get("pid"))
    if best is not None:
        return {
            "kind": "blocked channel/peer",
            "what": f"{best[1]} {best[2]!r} (pid {best[3]})",
        }
    first = (manifest.get("triggers") or [{}])[0]
    return {"kind": "unknown", "what": f"first trigger: {first.get('kind')!r}"}


def _fmt_ts(ts: Optional[float]) -> str:
    if not isinstance(ts, (int, float)):
        return "?"
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts)) + f".{int(ts % 1 * 1e3):03d}"


def _goodput_section(manifest: Dict[str, Any]) -> List[str]:
    lines: List[str] = []
    gp = manifest.get("goodput") or {}
    frac = gp.get("goodput")
    if isinstance(frac, (int, float)):
        lines.append(f"- goodput at harvest: **{frac:.1%}**")
        secs = gp.get("seconds") or {}
        busy = {k: v for k, v in secs.items() if isinstance(v, (int, float)) and v > 0}
        if busy:
            lines.append(
                "- time breakdown: "
                + ", ".join(f"{k} {v:.1f}s" for k, v in sorted(busy.items()))
            )
    mfu = gp.get("mfu")
    if isinstance(mfu, (int, float)):
        lines.append(f"- MFU at harvest: **{mfu:.1%}**")
    window = manifest.get("impact_window_s")
    if isinstance(window, (int, float)):
        lines.append(
            f"- impact window: {window:.0f}s of metrics history frozen in "
            "`metrics.json`"
        )
    if not lines:
        lines.append("- no goodput/MFU series were live at harvest time")
    return lines


def render_report(bundle_dir: str, last_n: int = 20) -> str:
    """The markdown incident report for one staged bundle: trigger
    chain, suspect, last-N flight events per involved process (skew
    corrected), goodput/MFU impact, artifact paths."""
    from . import flight_recorder

    manifest = load_manifest(bundle_dir)
    offsets = _pid_offsets(manifest)
    dumps = [
        _shift_dump(d, offsets.get(int(d.get("pid") or 0), 0))
        for d in flight_recorder.collect(os.path.join(bundle_dir, "flight"))
    ]
    triggers = manifest.get("triggers") or []
    pid_nodes = {
        int(pid): (info or {}).get("node")
        for pid, info in (manifest.get("pids") or {}).items()
        if str(pid).lstrip("-").isdigit()
    }
    suspect = infer_suspect(manifest, dumps)

    lines = [
        f"# Incident {manifest.get('incident_id', os.path.basename(bundle_dir))}",
        "",
        f"- opened: {_fmt_ts(manifest.get('opened_ts'))}",
        f"- triggers: {len(triggers)} "
        f"(coalesced into one incident by the GCS bus)",
        f"- involved nodes: {', '.join(sorted(manifest.get('nodes') or {})) or '?'}",
        f"- suspect: **{suspect['kind']}** — {suspect['what']}",
        "",
        "## Trigger chain",
        "",
        "| time | kind | source | detail |",
        "|---|---|---|---|",
    ]
    for trig in triggers[:50]:
        detail = str(safe_detail(trig.get("detail"), 120)).replace("|", "\\|")
        lines.append(
            f"| {_fmt_ts(trig.get('ts'))} | {trig.get('kind', '?')} "
            f"| {trig.get('source') or '-'} | {detail} |"
        )
    if len(triggers) > 50:
        lines.append(f"| ... | +{len(triggers) - 50} more | | |")

    lines += ["", "## Goodput / MFU impact", ""]
    lines += _goodput_section(manifest)

    lines += ["", f"## Flight recorder (last {last_n} events per process)"]
    for dump in sorted(dumps, key=lambda d: d.get("pid") or 0):
        pid = dump.get("pid")
        node = pid_nodes.get(int(pid or 0))
        where = f" on node {str(node)[:12]}" if node else ""
        lines += [
            "",
            f"### pid {pid}{where} — {dump.get('reason') or 'harvest'}",
            "",
            "```",
        ]
        events = [
            ev
            for ev in dump.get("events", ())
            if isinstance(ev, (list, tuple)) and len(ev) >= 2
        ]
        for ev in events[-last_n:]:
            ts = ev[0] / 1e6 if isinstance(ev[0], (int, float)) else None
            detail = ev[2] if len(ev) > 2 else None
            lines.append(f"{_fmt_ts(ts)}  {ev[1]:<24} {detail!r}")
        lines.append("```")

    lines += [
        "",
        "## Artifacts",
        "",
        f"- bundle: `{bundle_dir}`",
        f"- merged clock-skew-corrected trace: `{os.path.join(bundle_dir, TRACE_NAME)}` "
        "(open in ui.perfetto.dev or chrome://tracing)",
        f"- frozen metrics window: `{os.path.join(bundle_dir, 'metrics.json')}`",
        f"- structured log tails: `{os.path.join(bundle_dir, 'logs.jsonl')}`",
        "",
    ]
    return "\n".join(lines)
