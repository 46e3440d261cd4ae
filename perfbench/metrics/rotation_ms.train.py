"""Mean time of the rotation learner's update in a window step (gcd_score,
the matching, givens_rotate): the program's step marks from "adamw" to
"rotation"."""


def read(rec):
    x = rec.marks.get("rotation")
    return sum(x) / len(x) if x else None
