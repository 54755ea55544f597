"""batch_occupancy: tokens the decode steps produced in the window over
steps x slots, in % (engine.stats(): tokens_out less the admits' first
tokens, over the steps' slots)."""


def read(rec):
    if "stats0" not in rec:
        return None
    s0, s1 = rec["stats0"], rec["stats1"]
    steps = s1["steps"] - s0["steps"]
    if steps <= 0:
        return None
    decoded = (s1["tokens_out"] - s0["tokens_out"]) - (s1["prefills"]
                                                       - s0["prefills"])
    return 100.0 * decoded / (steps * rec["n_slots"])
