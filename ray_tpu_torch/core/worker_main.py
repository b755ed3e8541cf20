"""Worker process entrypoint.

Analog of python/ray/_private/workers/default_worker.py in the reference:
spawned by the head's worker pool, registers back over the head socket, then
runs the executor loop (the reference's run_task_loop, _raylet.pyx:2984).
"""

from __future__ import annotations

import os
import sys


def main():
    head_addr = os.environ["RAY_TPU_HEAD_ADDR"]
    session_dir = os.environ["RAY_TPU_SESSION_DIR"]
    node_idx = int(os.environ["RAY_TPU_NODE_IDX"])
    worker_id = os.environ["RAY_TPU_WORKER_ID"]

    from ray_tpu_torch.profiling import install_profile_handler

    # SIGUSR1 -> on-demand stack sampling (ref analog: the dashboard's
    # py-spy-on-PID profiling; profiling.py)
    install_profile_handler(session_dir, worker_id)

    from .context import CoreContext, set_context

    ctx = CoreContext(head_addr=head_addr, session_dir=session_dir,
                      node_idx=node_idx, worker_id=worker_id,
                      is_driver=False)
    set_context(ctx)
    try:
        ctx.run_executor()
    except KeyboardInterrupt:
        pass
    sys.exit(0)


if __name__ == "__main__":
    main()
