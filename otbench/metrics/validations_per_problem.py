"""KKT validations recorded per problem (`len(history.kkt_iteration)`, the
final table included), the mean over the window's problems."""

UNIT, BETTER, SOURCE = "val/problem", "lower", "program_counter"
LAYER, MOVES = "adaptive segment and sigma schedule", "solve_s"


def read(rec):
    probs = rec["problems"]
    return sum(p["validations"] for p in probs) / len(probs) if probs else None
