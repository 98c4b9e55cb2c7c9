"""The prefill window's model flops (``counts.prefill_flops`` of each
call) over its seconds, as a share of the card's bf16 peak, in %."""


def read(run):
    w = run.window
    if w.kind != "lm_prefill" or run.peak is None:
        return None
    flops = sum(run.counts.prefill_flops(run.m, it.rows, it.length)
                for it in w.items)
    return 100.0 * flops / w.seconds / run.peak["bf16_flops"]
