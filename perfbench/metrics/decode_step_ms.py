"""decode_step_ms: the host span around each ``engine.dev.step`` (host
issue of every layer, then the ``.cpu()`` of the greedy tokens), total
over the window divided by the steps in it, in ms."""


def read(rec):
    steps = rec.get("spans", {}).get("step")
    if not steps:
        return None
    return sum(steps) / len(steps) * 1e3
