"""train.optimizer_share, in %: device time of the kernels inside the
harness's ``bench.update`` ranges (``apply_update``: the clip, the
schedule and AdamW) over the device time inside ``bench.grads`` and
``bench.update``, in the traced window.  Layer: optimizer."""


def _device(tr, name):
    return sum(b - a for _, x, y in tr.named_ranges(name)
               for _, a, b in tr.kernels_within(x, y))


def read(rec: dict) -> float | None:
    tr = rec.get("trace")
    if rec["kind"] != "train" or tr is None:
        return None
    update = _device(tr, "bench.update")
    total = update + _device(tr, "bench.grads")
    return 100.0 * update / total if total else None
