"""Device time of prefill per admitted request, in ms: the engine's
``prefill_device_s`` (CUDA timing events around each prefill group) over
its ``prefills``, as the replica reports them once the load is done, so
over its whole serving life (warm-up arrivals, window and drain)."""


def read(ctx, res):
    eng = res.get("extra", {}).get("replica", {}).get("engine", {})
    if "prefill_device_s" not in eng or not eng.get("prefills"):
        return None
    return 1e3 * eng["prefill_device_s"] / eng["prefills"]
