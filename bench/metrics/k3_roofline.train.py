"""k3_roofline.train, in %: Σ of the frozen ``wkv_bound`` over the traced
train steps' calls of K3's operator (the forward and its recomputation),
over Σ device time of K3's kernels.  Layer: kernel K3."""

from bench.readers import roofline

#: the CUDA functions that do K3's work
KERNELS = ("wkv6_kernel",)


def read(rec: dict) -> float | None:
    if rec["kind"] != "train":
        return None
    return roofline(rec, "wkv6", KERNELS)
