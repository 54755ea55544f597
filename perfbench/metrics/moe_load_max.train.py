"""moe_load_max.train: over the window, the most-loaded held expert's
assignments over the held experts' mean, at the worst MoE layer (1 is
an even load), from the held experts' counters; None without them."""

from perfbench import roofline_moe


def read(rec):
    win = rec.get("moe", {}).get("window")
    if not win or not any(sum(c) for c in win["assignments"]):
        return None
    return roofline_moe.load_max(win["assignments"])
