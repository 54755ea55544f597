"""decode_emit_ms: the engine's ``emit_us`` (after a decode step, the
loop over its batch: every token written to its stream, every KV block
grown and every retirement) over the window's steps, from
``engine.stats()`` at the window's ends, in ms; None where the program
has no such counter."""

KEY, COUNT = "emit_us", "steps"


def read(rec):
    s0, s1 = rec.get("stats0", {}), rec.get("stats1", {})
    if KEY not in s1 or s1[COUNT] <= s0[COUNT]:
        return None
    return (s1[KEY] - s0[KEY]) / (s1[COUNT] - s0[COUNT]) / 1e3
