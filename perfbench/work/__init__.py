"""Frozen counts of the work each kind of traffic needs, from its shapes:
the floating-point operations and the bytes the algorithm must move,
whatever implements it."""
