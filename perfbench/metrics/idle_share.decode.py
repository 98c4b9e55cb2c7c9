"""The card's idle share over the traced decode waves, in %: 1 less the
union of device-op intervals over the traced wall time."""


def read(run):
    if run.trace is None or not run.trace.ops or run.traced.kind != "lm_decode":
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.wall_s)
