"""The 90th percentile of every wave's time in the window, in ms: the gap
between two tokens of a session, as a tail over all waves."""
import numpy as np


def read(run):
    w = run.window
    if w.kind != "lm_decode":
        return None
    return float(np.percentile([it.seconds for it in w.items], 90)) * 1e3
