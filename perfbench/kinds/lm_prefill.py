"""Kind ``lm_prefill``: one client in a closed loop sends prompt batches to
the port's ``transformer.prefill``, which returns each row's last-position
logits; the token served is their argmax.

Set-up makes the weights on the device from the seed, the schedule of call
shapes and the prompt pool (``harness/traffic.py``), and warms up each
shape ``mix["warmup"]`` times.  The check holds a sample of the window's
rows (one of the longest among them) to the plain reference: reading
``err``, each row's largest logit gap over the reference's largest
|logit|.  ``control`` gives the same reading for the reference in float8
put in the program's place, ``witness`` for the reference in bf16.
"""
from __future__ import annotations

from time import perf_counter as now

from torch.profiler import record_function

from perfbench.harness import check, drive, model, traffic

KIND = "lm_prefill"


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, reference,
                 marks: dict):
        from repro_torch.models import transformer    # the system under test

        self.t, self.mix, self.seed = transformer, mix, seed
        self.m, self.device, self.reference = cfg["model"], device, reference
        self.port = model.port_config(cfg)
        self.params = model.make_params(cfg, seed, device)
        drive.sync(device)
        marks["weights"] = now()
        self.shapes = traffic.schedule(mix, seed, mix["max_calls"])
        self.pool = traffic.prompt_pool(mix, self.m["vocab"], seed, device)
        drive.sync(device)
        marks["inputs"] = now()
        self.next, self.logits = 0, None
        self.warm = []
        for shape in sorted(set(self.shapes)):     # the mix's shapes, warmup calls each
            for _ in range(mix["warmup"]):
                t = now()
                drive.answer(self.t.prefill(self.port, self.params,
                                            traffic.call_tokens(self.pool, 0, shape)))
                self.warm.append(round(now() - t, 3))
        drive.sync(device)

    def measure(self, seconds: float | None, count: int | None = None):
        """Calls from the next of the schedule on; the first window's
        logits stay on the device for the check."""
        first, kept = self.next, []

        def step(j):
            i = first + j
            rows, length = self.shapes[i]
            tokens = traffic.call_tokens(self.pool, i, (rows, length))
            with record_function("perfbench.prefill"):
                out = self.t.prefill(self.port, self.params, tokens)
            with record_function("perfbench.read"):
                _, ok = drive.answer(out)
            kept.append(out)
            return rows, length, 0, ok

        w = drive.timed(KIND, step, seconds, count, self.device)
        self.next += len(w.items)
        if self.logits is None:
            self.window, self.logits = w, kept
        return w

    def check(self, traced_items: int):
        return Check(self)


class Check:
    """The sampled rows' tokens and logits, taken from the cell, so that
    the cell can be freed before the reference runs."""

    def __init__(self, cell: Cell):
        w = cell.window
        self.sample = check.sample_rows(w.items, cell.mix["check_rows"], cell.seed)
        self.tokens = [traffic.call_tokens(cell.pool, c, (w.items[c].rows,
                                                          w.items[c].length))[r]
                       for c, r in self.sample]
        self.got = [cell.logits[c][r].float() for c, r in self.sample]
        self.m, self.params, self.ref = cell.m, cell.params, cell.reference
        cell.logits = None
        self.rows = None

    def reference(self) -> None:
        dec = self.ref.Decoder(self.m, self.params)
        with self.ref.fp32_exact():
            self.rows = [dec.forward_row(t, compare="last") for t in self.tokens]

    def items(self, got=None) -> dict:
        got = self.got if got is None else got
        return {"err": [float((g.float() - r.logits[0]).abs().max()
                              / r.logits[0].abs().max())
                        for r, g in zip(self.rows, got)]}

    def _lower(self, precision: str) -> dict:
        dec = self.ref.Decoder(self.m, self.params, precision=precision)
        with self.ref.fp32_exact():
            got = [dec.forward_row(t, compare="last").logits[0] for t in self.tokens]
        return self.items(got)

    def control(self) -> dict:
        return self._lower("fp8")

    def witness(self) -> dict:
        return self._lower("bf16")
