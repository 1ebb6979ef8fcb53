"""device.idle.train, in %: 1 − the union of device-kernel time over the
traced window's wall time.  Layer: device."""


def read(rec: dict) -> float | None:
    tr = rec.get("trace")
    if rec["kind"] != "train" or tr is None or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
