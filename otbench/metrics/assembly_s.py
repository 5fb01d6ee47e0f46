"""Host seconds of the profiled problem's assembly: the program's
`assembly` span (`dots_socp_torch.utils.trace`), from the public call's
entry to the start of its iALM loop (`build_problem`, `initial_state`,
their move to the device). None where the program keeps no such span."""

from otbench.program_spans import profiled_problem

UNIT, BETTER, SOURCE = "s", "lower", "program_span"
LAYER, MOVES = "problem assembly and recovery", "solve_s"


def read(rec):
    problem = profiled_problem(rec)
    if problem is None or "assembly" not in problem["totals"]:
        return None
    return problem["totals"]["assembly"]["host_s"]
