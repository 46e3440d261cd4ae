"""Mean host time of one ``Engine.submit`` call over the window (the
benchmark's host clock around each call): the serving front end's
bucketing, LUT cache and host copy, and the launches it makes."""


def read(rec):
    sub = rec.host.get("submit_s")
    return 1e3 * sum(sub) / len(sub) if sub else None
