"""kv_route_mb_per_admit: the engine's ``kv_route_bytes`` (the bytes of
an admit's four host-device crossings: the K/V to the host, into the
plane's blocks, back from them, into the decode cache) over the window's
installed admits (``prefills``), from ``engine.stats()`` at the window's
ends, in MB (1e6 bytes); None where the program has no such counter."""

KEY, COUNT = "kv_route_bytes", "prefills"


def read(rec):
    s0, s1 = rec.get("stats0", {}), rec.get("stats1", {})
    if KEY not in s1 or s1[COUNT] <= s0[COUNT]:
        return None
    return (s1[KEY] - s0[KEY]) / (s1[COUNT] - s0[COUNT]) / 1e6
