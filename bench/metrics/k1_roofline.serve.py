"""k1_roofline.serve, in %: Σ of the frozen ``attention_bound`` over the
traced window's calls of K1's operator, from each call's shapes, over Σ
device time of K1's kernels.  Layer: kernel K1."""

from bench.readers import roofline

#: the CUDA functions that do K1's work
KERNELS = ("flash_attention_tc", "flash_attention_f32")


def read(rec: dict) -> float | None:
    return roofline(rec, "flash_attention", KERNELS)
