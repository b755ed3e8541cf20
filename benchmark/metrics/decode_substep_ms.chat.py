"""Device time of one decode substep over every slot, in ms: the engine's
``decode_device_s`` (CUDA timing events around each decode chunk) over
its ``decode_steps``, as the replica reports them once the load is done,
so over its whole serving life (warm-up arrivals, window and drain)."""


def read(ctx, res):
    eng = res.get("extra", {}).get("replica", {}).get("engine", {})
    if "decode_device_s" not in eng or not eng.get("decode_steps"):
        return None
    return 1e3 * eng["decode_device_s"] / eng["decode_steps"]
