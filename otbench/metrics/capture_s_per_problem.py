"""Host seconds per problem spent capturing CUDA graphs (warm-up, capture
and instantiation; `ops.graphs.STATS.capture_seconds`), the mean over the
window's problems: every solve captures its segments anew."""

UNIT, BETTER, SOURCE = "s", "lower", "program_counter"
LAYER, MOVES = "CUDA graphs", "solve_s"


def read(rec):
    probs = rec["problems"]
    return sum(p["capture_s"] for p in probs) / len(probs) if probs else None
