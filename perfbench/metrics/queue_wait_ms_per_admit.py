"""queue_wait_ms_per_admit: the engine's ``queue_wait_us`` (each admitted
request's wait from submit to admit in the scheduler's waiting room,
summed where the scheduler admits it) over the window's admits, from
``engine.stats()`` at the window's ends, in ms; None where the program
has no such counter."""

KEY, COUNT = "queue_wait_us", "admitted"


def read(rec):
    s0, s1 = rec.get("stats0", {}), rec.get("stats1", {})
    if KEY not in s1 or s1[COUNT] <= s0[COUNT]:
        return None
    return (s1[KEY] - s0[KEY]) / (s1[COUNT] - s0[COUNT]) / 1e3
