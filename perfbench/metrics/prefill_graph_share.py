"""prefill_graph_share: the engine's ``prefill_graphed`` (installed
admits whose prefill replayed captured CUDA graphs between its causal
attention launches) over the window's ``prefills``, from
``engine.stats()`` at the window's ends, in %; None where the program
has no such counter or no admit ran."""

KEY, COUNT = "prefill_graphed", "prefills"


def read(rec):
    s0, s1 = rec.get("stats0", {}), rec.get("stats1", {})
    if KEY not in s1 or s1[COUNT] <= s0[COUNT]:
        return None
    return 100.0 * (s1[KEY] - s0[KEY]) / (s1[COUNT] - s0[COUNT])
