"""Job submission: run an entrypoint command against a live cluster (the
port of ray_tpu/jobs.py).

Re-design of the reference's job stack (reference:
python/ray/dashboard/modules/job/job_manager.py:59 JobManager.submit_job,
job_supervisor.py, a supervisor actor per job driving the entrypoint
subprocess; python/ray/dashboard/modules/job/sdk.py JobSubmissionClient).
The job table lives in the GCS KV (under `job:`, so it rides the GCS's
snapshot and log); a job's output goes to `<session>/logs/job_<id>.log`.
The entrypoint runs with RAY_TPU_ADDRESS set to the session dir (so
`ray_tpu_torch.init()` or `init(address="auto")` attaches to this cluster),
RAY_TPU_JOB_ID, and PYTHONPATH leading with the directory that holds this
package. It inherits the supervisor worker's environment, which sees no
GPU: the job's GPU work runs in its tasks and actors.

Stopping differs from the JAX package's on purpose. There `stop()`
terminates the process and writes STOPPED while `run()`, woken by the
process's exit, writes FAILED for -15 and fires `job.failed`: the last
writer wins (ray_tpu/jobs.py:73-93). Here `stop()` records the stop under a
lock before it terminates anything, `run()` alone writes the final status
and maps a stopped process's exit to STOPPED without a trigger, and a stop
that lands before the process started keeps it from starting.
"""

from __future__ import annotations

import json
import os
import subprocess
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from . import api
from .core import runtime_base

_JOB_PREFIX = "job:"
TERMINAL = ("SUCCEEDED", "FAILED", "STOPPED")


def list_job_records(gcs) -> List[Dict[str, Any]]:
    """Every job record in the GCS's table, oldest first (the client's and
    the dashboard's view)."""
    out = []
    for k in gcs.call("kv_keys", _JOB_PREFIX):
        raw = gcs.call("kv_get", k)
        if raw:
            out.append(json.loads(raw))
    return sorted(out, key=lambda r: r.get("ts", 0))


def _session_dir(rt) -> str:
    """The session dir of the node this driver is attached to (its raylet's
    socket lives there)."""
    return os.path.dirname(rt._raylet.path)


class _JobSupervisor:
    """The actor that owns one job's entrypoint process (reference:
    job_supervisor.py)."""

    def __init__(self, job_id: str, entrypoint: str, session_dir: str, env: Dict[str, str]):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.session_dir = session_dir
        self.env = env
        self.proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()
        self._stopping = False
        self._done = False  # the final status is decided (under _lock)
        self._finished = threading.Event()  # ... and written

    def run(self) -> Dict[str, Any]:
        """Runs the entrypoint to its end; returns the final status."""
        log_path = os.path.join(self.session_dir, "logs", f"job_{self.job_id}.log")
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        env = dict(os.environ)
        env.update(self.env)
        env["RAY_TPU_ADDRESS"] = self.session_dir
        env["RAY_TPU_JOB_ID"] = self.job_id
        # The entrypoint must find the package when it runs from a checkout.
        import ray_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        self._set_status("RUNNING", pid=None)
        rc: Optional[int] = None
        try:
            with open(log_path, "ab", buffering=0) as log:
                with self._lock:
                    if not self._stopping:
                        self.proc = subprocess.Popen(self.entrypoint, shell=True, stdout=log,
                                                     stderr=log, env=env)
                if self.proc is not None:
                    self._set_status("RUNNING", pid=self.proc.pid)
                    rc = self.proc.wait()
        finally:
            with self._lock:
                stopped, self._done = self._stopping, True
            status = "STOPPED" if stopped else ("SUCCEEDED" if rc == 0 else "FAILED")
            self._set_status(status, returncode=rc)
            self._finished.set()
        if status == "FAILED":
            from .observability.postmortem import publish_trigger

            publish_trigger("job.failed", {"job_id": self.job_id, "returncode": rc},
                            source="jobs")
        return {"job_id": self.job_id, "status": status, "returncode": rc}

    def stop(self, timeout: float = 10.0) -> bool:
        """Stops the job unless it already ended; returns once run() wrote
        STOPPED (or after `timeout`). False when there was nothing to stop."""
        with self._lock:
            if self._done:
                return False
            self._stopping = True
            proc = self.proc
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
        self._finished.wait(timeout)
        return True

    def _set_status(self, status: str, **extra) -> None:
        rt = runtime_base.current_runtime()
        rec = {"job_id": self.job_id, "entrypoint": self.entrypoint, "status": status,
               "ts": time.time()}
        rec.update(extra)
        rt._gcs.call("kv_put", _JOB_PREFIX + self.job_id, json.dumps(rec).encode())


class JobSubmissionClient:
    """(reference: dashboard/modules/job/sdk.py JobSubmissionClient).

    Two transports, picked by the address: in the cluster (no address, a
    session dir, "auto" or tcp://), supervisor actors driven through the
    runtime; http(s)://, the dashboard's REST job API, for a caller outside
    the cluster (`JobSubmissionClient("http://head:8265")`)."""

    def __new__(cls, address: Optional[str] = None):
        if cls is JobSubmissionClient and isinstance(address, str) and address.startswith(
                ("http://", "https://")):
            return object.__new__(HttpJobSubmissionClient)
        return object.__new__(cls)

    def __init__(self, address: Optional[str] = None):
        if address and not runtime_base.is_initialized():
            api.init(address=address)
        self._rt = runtime_base.current_runtime()
        self._supervisors: Dict[str, Any] = {}
        self._result_refs: Dict[str, Any] = {}

    def submit_job(self, *, entrypoint: str, runtime_env: Optional[dict] = None,
                   job_id: Optional[str] = None) -> str:
        job_id = job_id or f"raytpu-job-{uuid.uuid4().hex[:8]}"
        env_vars = dict((runtime_env or {}).get("env_vars") or {})
        rec = {"job_id": job_id, "entrypoint": entrypoint, "status": "PENDING",
               "ts": time.time()}
        self._rt._gcs.call("kv_put", _JOB_PREFIX + job_id, json.dumps(rec).encode())
        sup_cls = api.remote(num_cpus=0.1, max_concurrency=2)(_JobSupervisor)
        sup = sup_cls.remote(job_id, entrypoint, _session_dir(self._rt), env_vars)
        self._supervisors[job_id] = sup
        self._result_refs[job_id] = sup.run.remote()
        return job_id

    def get_job_info(self, job_id: str) -> Dict[str, Any]:
        raw = self._rt._gcs.call("kv_get", _JOB_PREFIX + job_id)
        if raw is None:
            raise KeyError(f"no such job {job_id!r}")
        return json.loads(raw)

    def get_job_status(self, job_id: str) -> str:
        return self.get_job_info(job_id)["status"]

    def list_jobs(self) -> List[Dict[str, Any]]:
        return list_job_records(self._rt._gcs)

    def get_job_logs(self, job_id: str) -> str:
        path = os.path.join(_session_dir(self._rt), "logs", f"job_{job_id}.log")
        try:
            with open(path) as f:
                return f.read()
        except OSError:
            return ""

    def stop_job(self, job_id: str) -> bool:
        sup = self._supervisors.get(job_id)
        if sup is None:
            return False
        return api.get(sup.stop.remote(), timeout=30)

    def wait_until_finished(self, job_id: str, timeout: float = 300.0) -> str:
        from . import exceptions as exc

        ref = self._result_refs.get(job_id)
        if ref is not None:
            try:
                api.get(ref, timeout=timeout)
            except exc.GetTimeoutError:
                pass  # still running: report the status as it stands
            return self.get_job_status(job_id)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            st = self.get_job_status(job_id)
            if st in TERMINAL:
                return st
            time.sleep(0.5)
        return self.get_job_status(job_id)


class HttpJobSubmissionClient(JobSubmissionClient):
    """The REST transport, against the dashboard's job endpoints
    (reference: dashboard/modules/job/sdk.py speaking to job_head.py)."""

    def __init__(self, address: str):
        self._base = address.rstrip("/")

    def _request(self, method: str, path: str, payload: Optional[dict] = None):
        import urllib.request

        data = json.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(self._base + path, data=data, method=method,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read() or b"{}")

    def submit_job(self, *, entrypoint: str, runtime_env: Optional[dict] = None,
                   job_id: Optional[str] = None) -> str:
        return self._request("POST", "/api/jobs", {"entrypoint": entrypoint,
                                                   "runtime_env": runtime_env,
                                                   "job_id": job_id})["job_id"]

    def get_job_info(self, job_id: str) -> Dict[str, Any]:
        import urllib.error

        try:
            return self._request("GET", f"/api/jobs/{job_id}")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise KeyError(f"no such job {job_id!r}") from e
            raise

    def list_jobs(self) -> List[Dict[str, Any]]:
        return self._request("GET", "/api/jobs")

    def get_job_logs(self, job_id: str) -> str:
        return self._request("GET", f"/api/jobs/{job_id}/logs")["logs"]

    def stop_job(self, job_id: str) -> bool:
        return bool(self._request("POST", f"/api/jobs/{job_id}/stop")["stopped"])

    def wait_until_finished(self, job_id: str, timeout: float = 300.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            st = self.get_job_status(job_id)
            if st in TERMINAL:
                return st
            time.sleep(0.5)
        return self.get_job_status(job_id)
