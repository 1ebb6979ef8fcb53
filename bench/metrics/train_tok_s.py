"""train_tok_s: tokens of every train step completed in the window over
the wall time from the first step's start to the last completed step's
end (its loss read from the device).  Host clock."""


def read(rec: dict) -> float | None:
    if rec["kind"] != "train" or rec["steps"] == 0:
        return None
    return rec["tokens"] / rec["span_s"]
