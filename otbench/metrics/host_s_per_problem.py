"""Host seconds per problem outside the iALM loop: the harness's clock
around each `solver()` call less that call's `history.running_time`
(problem assembly in `solver/problem.py::build_problem` and
`solver/socp.py`'s set-up, the final KKT table, the solution's recovery in
`solver/socp.py` and `solver/decorators.py`), the mean over the window."""

UNIT, BETTER, SOURCE = "s", "lower", "program_span"
LAYER, MOVES = "problem assembly and recovery", "solve_s"


def read(rec):
    probs = rec["problems"]
    return sum(p["call_s"] - p["running_time"] for p in probs) / len(probs) if probs else None
