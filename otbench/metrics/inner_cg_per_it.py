"""Live inner CG iterations per iALM iteration over the window
(`ops.laplacian.CG_COUNTERS.iterations`, every refinement pass; the
latched blocks' no-op iterations are not counted). Nothing on the spectral
path."""

UNIT, BETTER, SOURCE = "inner/it", "lower", "program_counter"
LAYER, MOVES = "phi solve, CG", "solve_s"


def read(rec):
    probs = rec["problems"]
    if not probs or not sum(p["cg.solves"] for p in probs):
        return None
    return sum(p["cg.iterations"] for p in probs) / sum(p["iterations"] for p in probs)
