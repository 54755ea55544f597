"""device_idle_share.serve: the share of the profiler slice (steady
decode steps and admits) in which no operation ran on the device, in %."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["window_s"] or "requests" not in rec:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
