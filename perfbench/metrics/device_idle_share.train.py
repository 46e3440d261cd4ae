"""The share of the traced window in which no activity ran on the device:
1 − the union of the device's activity intervals over the window."""


def read(rec):
    if not rec.device_ops or not rec.window_s:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
