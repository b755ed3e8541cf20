"""Job submission: run driver scripts on the cluster with tracked status.

Ref parity: ray job submission (python/ray/dashboard/modules/job/
job_manager.py:517 JobManager.submit_job — entrypoint subprocess with
RAY_ADDRESS injected, status machine PENDING -> RUNNING -> SUCCEEDED/
FAILED/STOPPED, logs captured per job; python/ray/job_submission/
JobSubmissionClient). Re-design: the manager is a named detached actor on
the cluster (so remote clients reach it through the normal actor path and
job state survives the submitting client), spawning entrypoint
subprocesses next to the head with RAY_TPU_ADDRESS injected.
"""

from __future__ import annotations

import os
import subprocess
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch

JOB_MANAGER_NAME = "_ray_tpu_job_manager"

PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"


class _JobManager:
    """Named actor owning job subprocesses + their status table."""

    def __init__(self, head_addr: str, log_dir: str):
        self._head_addr = head_addr
        self._log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jobs: Dict[str, dict] = {}
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def submit(self, entrypoint: str, submission_id: Optional[str],
               env_vars: Optional[Dict[str, str]],
               metadata: Optional[Dict[str, str]]) -> str:
        job_id = submission_id or f"raytpu-job-{uuid.uuid4().hex[:10]}"
        with self._lock:
            if job_id in self._jobs:
                raise ValueError(f"job {job_id!r} already exists")
            self._jobs[job_id] = {
                "job_id": job_id, "entrypoint": entrypoint,
                "status": PENDING, "submitted_at": time.time(),
                "started_at": None, "ended_at": None,
                "metadata": metadata or {}, "message": "",
            }
        env = dict(os.environ)
        env.update(env_vars or {})
        # the entrypoint attaches to THIS cluster (ref: RAY_ADDRESS)
        env["RAY_TPU_ADDRESS"] = self._head_addr
        log_path = os.path.join(self._log_dir, f"{job_id}.log")
        try:
            with open(log_path, "ab") as logf:
                proc = subprocess.Popen(
                    entrypoint, shell=True, env=env, stdout=logf,
                    stderr=subprocess.STDOUT, start_new_session=True)
        except OSError as e:
            with self._lock:
                self._jobs[job_id].update(status=FAILED, message=repr(e),
                                          ended_at=time.time())
            self._emit_event("ERROR", "job_finished",
                             f"job {job_id} failed to launch: {e!r}",
                             job_id)
            return job_id
        with self._lock:
            self._procs[job_id] = proc
            self._jobs[job_id].update(status=RUNNING,
                                      started_at=time.time())
        self._emit_event("INFO", "job_started",
                         f"job {job_id} started: {entrypoint}", job_id)
        threading.Thread(target=self._wait, args=(job_id, proc),
                         daemon=True).start()
        return job_id

    @staticmethod
    def _emit_event(severity: str, event_type: str, message: str,
                    job_id: str):
        """Job transitions land in the cluster event log (reference: the
        GCS job table feeding `ray list cluster-events`)."""
        from ray_tpu_torch.core import events as _ev

        _ev.emit_cluster_event(severity, "jobs", event_type, message,
                               entity_id=job_id)

    def _wait(self, job_id: str, proc: subprocess.Popen):
        rc = proc.wait()
        with self._lock:
            info = self._jobs.get(job_id)
            if info is None or info["status"] == STOPPED:
                return
            info["status"] = SUCCEEDED if rc == 0 else FAILED
            info["message"] = f"exit code {rc}"
            info["ended_at"] = time.time()
        self._emit_event("INFO" if rc == 0 else "ERROR", "job_finished",
                         f"job {job_id} finished: exit code {rc}", job_id)

    def status(self, job_id: str) -> dict:
        with self._lock:
            info = self._jobs.get(job_id)
            if info is None:
                raise ValueError(f"no such job: {job_id}")
            return dict(info)

    def list(self) -> List[dict]:
        with self._lock:
            return [dict(v) for v in self._jobs.values()]

    def logs(self, job_id: str, offset: int = 0) -> str:
        """Log text from BYTE ``offset`` (tailing clients track bytes so
        a chatty multi-hour job is not re-read every poll)."""
        return self.logs_from(job_id, offset)[0]

    def logs_from(self, job_id: str, offset: int = 0):
        """-> (text, next_byte_offset) for exact tailing. Reads binary (a
        text-mode seek would land mid-character) and holds back an
        incomplete trailing UTF-8 sequence so a multi-byte character
        split across a poll boundary is never emitted as U+FFFD."""
        self.status(job_id)  # raises on unknown id
        path = os.path.join(self._log_dir, f"{job_id}.log")
        try:
            with open(path, "rb") as f:
                if offset:
                    f.seek(offset)
                blob = f.read()
        except OSError:
            return "", offset
        # trim an incomplete trailing multi-byte sequence (<= 3 bytes)
        keep = len(blob)
        for back in range(1, min(4, keep + 1)):
            b = blob[keep - back]
            if b < 0x80:          # ASCII: sequence complete
                break
            if b >= 0xC0:         # start byte: complete iff its length fits
                need = 2 + (b >= 0xE0) + (b >= 0xF0)
                if back < need:
                    keep -= back  # truncated sequence: hold it back
                break
        blob = blob[:keep]
        return blob.decode("utf-8", errors="replace"), offset + keep

    def stop(self, job_id: str) -> bool:
        with self._lock:
            info = self._jobs.get(job_id)
            proc = self._procs.get(job_id)
            if info is None:
                raise ValueError(f"no such job: {job_id}")
            if info["status"] != RUNNING or proc is None:
                return False
            info["status"] = STOPPED
            info["ended_at"] = time.time()
        try:
            os.killpg(os.getpgid(proc.pid), 15)  # the job's process group
        except (ProcessLookupError, PermissionError):
            pass
        return True

    def delete(self, job_id: str) -> bool:
        with self._lock:
            info = self._jobs.get(job_id)
            if info is None:
                return False
            if info["status"] == RUNNING:
                raise RuntimeError("stop the job before deleting it")
            self._jobs.pop(job_id, None)
            self._procs.pop(job_id, None)
        return True


class JobSubmissionClient:
    """Ref parity: ray.job_submission.JobSubmissionClient (HTTP in the
    reference; the named-actor path here serves the same surface)."""

    def __init__(self, address: Optional[str] = None):
        if address and not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address, log_to_driver=False)
        elif not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self._manager = _get_or_create_manager()

    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   runtime_env: Optional[dict] = None,
                   metadata: Optional[Dict[str, str]] = None) -> str:
        env_vars = (runtime_env or {}).get("env_vars")
        return ray_tpu_torch.get(self._manager.submit.remote(
            entrypoint, submission_id, env_vars, metadata), timeout=60)

    def get_job_status(self, job_id: str) -> str:
        return ray_tpu_torch.get(self._manager.status.remote(job_id),
                           timeout=60)["status"]

    def get_job_info(self, job_id: str) -> dict:
        return ray_tpu_torch.get(self._manager.status.remote(job_id), timeout=60)

    def get_job_logs(self, job_id: str, offset: int = 0) -> str:
        return ray_tpu_torch.get(self._manager.logs.remote(job_id, offset),
                           timeout=60)

    def list_jobs(self) -> List[dict]:
        return ray_tpu_torch.get(self._manager.list.remote(), timeout=60)

    def stop_job(self, job_id: str) -> bool:
        return ray_tpu_torch.get(self._manager.stop.remote(job_id), timeout=60)

    def delete_job(self, job_id: str) -> bool:
        return ray_tpu_torch.get(self._manager.delete.remote(job_id), timeout=60)

    def tail_job_logs(self, job_id: str, poll_s: float = 0.5):
        """Generator of new log text until the job finishes. Each poll
        ships only the unseen suffix; offsets are BYTES (len(str) would
        drift behind on multi-byte UTF-8 and re-yield garbled text)."""
        seen = 0
        while True:
            new, seen = ray_tpu_torch.get(
                self._manager.logs_from.remote(job_id, seen), timeout=60)
            if new:
                yield new
            if self.get_job_status(job_id) not in (PENDING, RUNNING):
                new, seen = ray_tpu_torch.get(
                    self._manager.logs_from.remote(job_id, seen),
                    timeout=60)
                if new:
                    yield new
                return
            time.sleep(poll_s)


def _get_or_create_manager():
    from ray_tpu_torch.core.context import get_context

    try:
        return ray_tpu_torch.get_actor(JOB_MANAGER_NAME)
    except Exception:  # noqa: BLE001 — not created yet
        ctx = get_context()
        cls = ray_tpu_torch.remote(_JobManager)
        try:
            return cls.options(name=JOB_MANAGER_NAME).remote(
                ctx.head_addr, os.path.join(ctx.session_dir, "job_logs"))
        except Exception:  # noqa: BLE001 — lost the creation race
            return ray_tpu_torch.get_actor(JOB_MANAGER_NAME)
