"""Host seconds of the profiled problem after its last segment: the
program's `finish` span (`dots_socp_torch.utils.trace`), the final KKT
table and objective (`final_kkt`, to `history.end()`) and the solution's
recovery to the public call's return (`recover`). None where the program
keeps no such span."""

from otbench.program_spans import profiled_problem

UNIT, BETTER, SOURCE = "s", "lower", "program_span"
LAYER, MOVES = "problem assembly and recovery", "solve_s"


def read(rec):
    problem = profiled_problem(rec)
    if problem is None or "finish" not in problem["totals"]:
        return None
    return problem["totals"]["finish"]["host_s"]
