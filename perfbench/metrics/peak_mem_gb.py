"""The card's peak allocated memory over the window, in GB
(``torch.cuda.max_memory_allocated`` reset after warm-up)."""


def read(run):
    return run.window_peak / 1e9
