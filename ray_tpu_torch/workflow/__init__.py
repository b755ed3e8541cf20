"""Durable workflows: run a task DAG with per-step checkpoints + resume.

Ref parity: ray.workflow (python/ray/workflow/api.py run/run_async/resume/
get_status/get_output/list_all; workflow_executor.py:32 executes the DAG
step-by-step, checkpointing every step result to storage so a crashed or
cancelled workflow resumes from its last completed step rather than
rerunning from scratch).
"""

from ray_tpu_torch.workflow.execution import (WorkflowStatus, delete,
                                              get_output, get_status, init,
                                              list_all, resume, run,
                                              run_async)

__all__ = ["run", "run_async", "resume", "get_status", "get_output",
           "list_all", "delete", "init", "WorkflowStatus"]

from ray_tpu_torch.usage_stats import record_library_usage as _rlu
_rlu("workflow")
del _rlu
