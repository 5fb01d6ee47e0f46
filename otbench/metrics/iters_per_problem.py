"""iALM iterations to the tolerance, the mean over the window's problems
(`history.kkt_iteration`'s last entry + 1)."""

UNIT, BETTER, SOURCE = "it/problem", "lower", "program_counter"
LAYER, MOVES = "adaptive segment and sigma schedule", "solve_s"


def read(rec):
    probs = rec["problems"]
    return sum(p["iterations"] for p in probs) / len(probs) if probs else None
