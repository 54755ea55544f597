"""decode_graph_share: the engine's ``step_graphed`` (decode steps whose
work between the attention launches replayed captured CUDA graphs) over
the window's ``steps``, from ``engine.stats()`` at the window's ends, in
%; None where the program has no such counter or no step ran."""

KEY, COUNT = "step_graphed", "steps"


def read(rec):
    s0, s1 = rec.get("stats0", {}), rec.get("stats1", {})
    if KEY not in s1 or s1[COUNT] <= s0[COUNT]:
        return None
    return 100.0 * (s1[KEY] - s0[KEY]) / (s1[COUNT] - s0[COUNT])
