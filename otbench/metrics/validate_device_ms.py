"""Device milliseconds per KKT validation of the profiled problem: the
device seconds of the program's `validate` segment runs that replayed a
CUDA graph (each between two CUDA events, `dots_socp_torch.utils.trace`),
over their count. None where none was timed."""

from otbench.program_spans import profiled_problem, replays

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "adaptive segment and sigma schedule", "solve_s"


def read(rec):
    problem = profiled_problem(rec)
    if problem is None:
        return None
    timed = replays(problem, "validate")
    return 1e3 * sum(timed) / len(timed) if timed else None
