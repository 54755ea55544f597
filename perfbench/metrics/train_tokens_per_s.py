"""train_tokens_per_s: target tokens of the optimizer steps taken in the
window, over the window's seconds (the window ends in a device sync)."""


def read(rec):
    if "steps" not in rec:
        return None
    return rec["steps"] * rec["batch"] * (rec["seq"] - 1) / rec["window_s"]
