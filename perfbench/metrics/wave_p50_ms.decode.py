"""The median wave time of the window, in ms (host clock)."""
import numpy as np


def read(run):
    w = run.window
    if w.kind != "lm_decode":
        return None
    return float(np.median([it.seconds for it in w.items])) * 1e3
