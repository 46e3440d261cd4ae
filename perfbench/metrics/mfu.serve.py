"""The window's share of the chip's peak: the larger of the served
batches' operations over the float32 rate and their bytes over the memory
rate (``work.serve``), over the traced window."""
from perfbench.work import peaks


def read(rec):
    if "flops" not in rec.work or not rec.device_ops or not rec.window_s:
        return None
    return 100.0 * peaks.bound_s(rec.work["flops"],
                                 rec.work["bytes"])[0] / rec.window_s
