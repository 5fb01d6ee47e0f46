"""Seconds per transport problem solved to the cell's KKT tolerance: the
whole measured window over the problems solved in it (each a call of the
public `solver()`, assembly, captures, loop and recovery included)."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(rec):
    return rec["window_s"] / len(rec["problems"]) if rec["problems"] else None
