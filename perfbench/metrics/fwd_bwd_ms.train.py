"""Mean device time of the forward and backward passes of a window step:
the program's step marks from the step's start to "backward"."""


def read(rec):
    f, b = rec.marks.get("forward"), rec.marks.get("backward")
    if not f or not b:
        return None
    return sum(x + y for x, y in zip(f, b)) / len(b)
