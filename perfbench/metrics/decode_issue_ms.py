"""decode_issue_ms: the engine's ``step_issue_us`` (a decode step's host
issue, from ``Lockstep.step``'s entry to its last launch returned) over
the window's steps, from ``engine.stats()`` at the window's ends, in ms;
None where the program has no such counter."""

KEY, COUNT = "step_issue_us", "steps"


def read(rec):
    s0, s1 = rec.get("stats0", {}), rec.get("stats1", {})
    if KEY not in s1 or s1[COUNT] <= s0[COUNT]:
        return None
    return (s1[KEY] - s0[KEY]) / (s1[COUNT] - s0[COUNT]) / 1e3
