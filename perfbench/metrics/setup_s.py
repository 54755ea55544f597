"""setup_s: seconds from the run's start (before torch is imported) to
the window's opening: imports, the kernels' build on a checkout's first
run, the weights, the state, warm-up and, for a served model, the ramp
that fills the batch."""


def read(rec):
    return rec.get("setup_s")
