"""kv_route_ms_per_admit: host spans around the six calls of an admit's
KV route (``kv_to_bytes``, which also waits for the prefill's device
work, the plane's ``seq_alloc``, ``seq_migrate`` and ``seq_fetch``,
``kv_from_bytes`` and the cache's ``install``), summed over the window
and divided by its admits, in ms."""

ROUTE = ("kv_to_bytes", "seq_alloc", "seq_migrate", "seq_fetch",
         "kv_from_bytes", "install")


def read(rec):
    spans = rec.get("spans", {})
    admits = len(spans.get("kv_to_bytes", ()))
    if not admits:
        return None
    return sum(sum(spans.get(n, ())) for n in ROUTE) / admits * 1e3
