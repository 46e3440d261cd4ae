"""The IVF scan kernel's share of its roofline: the least bytes the
window's scans must move (``work.serve.scan_bytes``) over the chip's
memory rate, over the summed time of the kernel's launches."""
from perfbench.work import peaks

KERNEL = "ivf_adc_kernel"


def read(rec):
    t = rec.device_s(KERNEL)
    need = rec.work.get("scan_bytes")
    if not t or not need:
        return None
    return 100.0 * need / peaks.HBM_BYTES_PER_S / t
