"""decode_sync_ms: the engine's ``step_sync_us`` (a decode step's
``.cpu()`` of the greedy tokens: the wait for the step's device work,
and the copy) over the window's steps, from ``engine.stats()`` at the
window's ends, in ms; None where the program has no such counter."""

KEY, COUNT = "step_sync_us", "steps"


def read(rec):
    s0, s1 = rec.get("stats0", {}), rec.get("stats1", {})
    if KEY not in s1 or s1[COUNT] <= s0[COUNT]:
        return None
    return (s1[KEY] - s0[KEY]) / (s1[COUNT] - s0[COUNT]) / 1e3
