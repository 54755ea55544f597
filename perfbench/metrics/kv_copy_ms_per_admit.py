"""kv_copy_ms_per_admit: the engine's ``kv_route_us`` (an admit's KV
route from ``kv_to_bytes`` to ``install`` returned, after the prefill's
device work is done) over the window's installed admits (``prefills``),
from ``engine.stats()`` at the window's ends, in ms; None where the
program has no such counter."""

KEY, COUNT = "kv_route_us", "prefills"


def read(rec):
    s0, s1 = rec.get("stats0", {}), rec.get("stats1", {})
    if KEY not in s1 or s1[COUNT] <= s0[COUNT]:
        return None
    return (s1[KEY] - s0[KEY]) / (s1[COUNT] - s0[COUNT]) / 1e3
