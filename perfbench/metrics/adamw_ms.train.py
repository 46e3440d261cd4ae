"""Mean device time of AdamW in a window step: the program's step marks
from "backward" to "adamw"."""


def read(rec):
    x = rec.marks.get("adamw")
    return sum(x) / len(x) if x else None
