"""Device time of one served batch: the summed duration of every device
activity in the traced window over the batches completed in it."""


def read(rec):
    n = rec.host.get("batches")
    return 1e3 * rec.device_s() / n if n and rec.device_ops else None
