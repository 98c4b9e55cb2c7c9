"""The decode window's roofline share, in %: each wave's least time (the
larger of its model flops at the bf16 peak and its bytes at the memory
peak, ``counts.decode_wave_flops`` / ``decode_wave_bytes``; bytes bound
every wave of these cells) summed over the window, over its seconds."""


def read(run):
    w = run.window
    if w.kind != "lm_decode" or run.peak is None:
        return None
    m, c = run.m, run.counts
    least = 0.0
    for it in w.items:
        valid = it.pos + 1 if not m.get("window") else min(m["window"], it.pos + 1)
        least += c.roofline_s(c.decode_wave_flops(m, it.rows, valid),
                              c.decode_wave_bytes(m, it.rows, valid), run.peak)[0]
    return 100.0 * least / w.seconds
