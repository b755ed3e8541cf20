"""The harness's span around each ``next()`` of the worker's
``iter_torch_batches(device=...)`` iterator in the window; mean per step."""


def read(ctx, res):
    steps = res.get("steps") if res.get("kind") == "train" else None
    if not steps:
        return None
    return 1e3 * sum(s["wait_s"] for s in steps) / len(steps)
