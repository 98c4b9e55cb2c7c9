"""K3's share of its roofline over the traced prefill calls, in %: the
least time of its launches (``counts.k3_bound_s``) over its device time in
the trace (kernels named ``flash_attention``)."""


def read(run):
    if run.trace is None or run.traced.kind != "lm_prefill":
        return None
    spent = run.trace.seconds_of("flash_attention")
    if spent <= 0:
        return None
    least = sum(run.counts.k3_bound_s(run.m, it.rows, it.length, run.peak)
                for it in run.traced.items)
    return 100.0 * least / spent
