"""mfu.train, in %: the frozen ``model_flops`` (6 × parameters × tokens) of
the steps completed in the window over the window's span, over the
card's bf16 peak (989e12).  Layer: train step."""

from types import SimpleNamespace

from bench.frozen.roofline import HW, model_flops


def read(rec: dict) -> float | None:
    if rec["kind"] != "train" or not rec["steps"]:
        return None
    shape = SimpleNamespace(global_batch=1, seq_len=rec["tokens"])
    return 100.0 * model_flops(rec["dims"], shape, "train") \
        / rec["span_s"] / HW.PEAK_FLOPS
