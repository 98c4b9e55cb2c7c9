"""Prompt tokens prefilled in the window over the window's seconds."""


def read(run):
    w = run.window
    if w.kind != "lm_prefill":
        return None
    return sum(it.rows * it.length for it in w.items) / w.seconds
