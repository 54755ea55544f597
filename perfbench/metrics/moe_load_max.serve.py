"""moe_load_max.serve: over the window, the most-loaded expert's
assignments over the experts' mean, at the worst MoE layer (1 is an even
load), from the engine's ``moe_assignments`` at the window's ends (steps
and prefills; padded rows and inactive slots are not counted); None
where the program has no such counter or counted nothing."""

from perfbench import roofline_moe


def read(rec):
    a = rec.get("stats0", {}).get("moe_assignments")
    b = rec.get("stats1", {}).get("moe_assignments")
    if not b:
        return None
    a = a or [[0] * len(row) for row in b]
    grown = [[y - x for x, y in zip(ra, rb)] for ra, rb in zip(a, b)]
    if not any(sum(row) for row in grown):
        return None
    return roofline_moe.load_max(grown)
