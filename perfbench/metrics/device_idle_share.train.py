"""device_idle_share.train: the share of the profiler slice (the mix's
optimizer steps) in which no operation ran on the device, in %."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["window_s"] or "steps" not in rec:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
