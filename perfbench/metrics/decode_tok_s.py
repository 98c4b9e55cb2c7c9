"""Tokens decoded in the window (a wave decodes one for every session)
over the window's seconds."""


def read(run):
    w = run.window
    if w.kind != "lm_decode":
        return None
    return sum(it.rows for it in w.items) / w.seconds
