"""kv_host_mb_per_admit: the KV plane's ``kv_host_bytes`` (the bytes its
blocks took from or gave to the host: uploads into them, fetches back
from them, the host rail) over the window's installed admits
(``prefills``), from ``engine.stats()`` at the window's ends, in MB (1e6
bytes); 0 where the route stays on the device, None where the program
has no such counter."""

KEY, COUNT = "kv_host_bytes", "prefills"


def read(rec):
    s0, s1 = rec.get("stats0", {}), rec.get("stats1", {})
    if KEY not in s1 or s1[COUNT] <= s0[COUNT]:
        return None
    return (s1[KEY] - s0[KEY]) / (s1[COUNT] - s0[COUNT]) / 1e6
